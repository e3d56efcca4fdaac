"""Depth losses of MVSNet, CasMVSNet, CVP / AACVP-MVSNet and Point-MVSNet
(counterpart of mvs_tpu.train.losses: smooth_l1, masked_smooth_l1,
ohem_smooth_l1, cascade_loss, pyramid_loss, masked_mae,
point_mvsnet_loss).

Pure functions of tensors with a {0, 1} float mask, safe under an
all-masked batch (0 / 0 guarded).

Under a current mesh with more than one data rank (parallel.use_mesh) each
rank holds some rows of the global batch, and a masked mean returns this
rank's share of the global batch's: its own masked sum over the mask count
all-reduced over the 'data' group, as mvs_tpu divides a global masked sum
by a global count under GSPMD. The shares of the data ranks sum to the
global loss (the train step sums them, parallel.psum_metrics), and each
rank differentiates its own. OHEM ranks the whole global batch.

Where a model splits its volumes over 'depth' and 'space' ranks
(parallel.sharding), a map is the rows a rank holds (its layout under
"shard" in the outputs; the task makes it current, parallel.use_map, and
takes the same rows of the ground truth): counts are summed over the ranks
whose rows make the global batch's maps, and a rank's share is divided by
the number of ranks that hold the same rows (a family that does not split
its volumes: every 'depth' x 'space' rank holds whole maps).
"""

from __future__ import annotations

import torch

from mvs_tpu_torch.geometry.resize import resize_nearest
from mvs_tpu_torch.parallel.collectives import gather_map, global_count
from mvs_tpu_torch.parallel.sharding import current_map, use_map

__all__ = ["smooth_l1", "masked_smooth_l1", "ohem_smooth_l1",
           "cascade_loss", "pyramid_loss", "masked_mae", "point_mvsnet_loss",
           "map_of", "take_rows"]


def smooth_l1(err: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber: 0.5 e^2 / beta for |e| < beta, else |e| - beta/2."""
    abs_err = err.abs()
    return torch.where(abs_err < beta, 0.5 * err * err / beta,
                       abs_err - 0.5 * beta)


def _copies() -> int:
    shard = current_map()
    return 1 if shard is None else shard.copies


def masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of `values` where `valid` (bool), 0 when nothing is valid;
    under a mesh this rank's share of the global mean."""
    mask = valid.to(values.dtype)
    share = torch.sum(values * mask) / torch.clamp(
        global_count(torch.sum(mask)), min=1.0)
    copies = _copies()
    return share if copies == 1 else share / copies


def masked_smooth_l1(depth_est, depth_gt, mask, beta: float = 1.0):
    return masked_mean(smooth_l1(depth_est - depth_gt, beta), mask > 0.5)


def ohem_smooth_l1(depth_est, depth_gt, mask, topk_frac: float = 0.6):
    """Online hard-example mining: the mean smooth-L1 over the hardest
    k = max(floor(topk_frac * n_valid), 1) of the n_valid masked-in
    pixels. k depends on the data, so the errors are sorted in descending
    order with the masked-out pixels at -inf (past every valid one) and the
    finite entries of rank < k are averaged, on the device. The gradient
    reaches the selected pixels only. 0 for an all-masked batch.

    Under a mesh k comes from the global n_valid and the ranking is the
    global batch's: every rank sorts the global batch's errors (each
    rank's part in its place, parallel.gather_map) with a stable sort, so
    that all agree on which pixels are taken, and returns the sum of its
    own taken errors over the global count taken."""
    err = smooth_l1(depth_est - depth_gt)
    keyed = torch.where(mask > 0.5, err, -torch.inf)
    everyone, mine = gather_map(keyed)
    everyone, mine, err = everyone.reshape(-1), mine.reshape(-1), \
        err.reshape(-1)
    order = torch.sort(everyone, descending=True, stable=True).indices
    k = torch.clamp(torch.floor(topk_frac * torch.isfinite(everyone).sum(
        dtype=torch.float32)), min=1.0)
    ranks = torch.arange(order.shape[0], device=order.device)
    take = torch.zeros_like(everyone, dtype=torch.bool)
    take[order] = (ranks < k) & torch.isfinite(everyone[order])
    mine = take[mine]
    return (torch.sum(torch.where(mine, err, 0.0))
            / torch.clamp(take.sum(dtype=torch.float32), min=1.0)
            / _copies())


def cascade_loss(stage_outputs: dict, depth_gt_stages: dict,
                 mask_stages: dict, stage_weights=(0.5, 1.0, 2.0)):
    """sum_k w_k * masked smooth-L1 of stage k ('stage1'..'stageN' keys in
    every dict; a stage's "shard", where its volume was split, is the
    layout of its maps). Returns (total, last_stage_loss)."""
    total = last = 0.0
    for i, w in enumerate(stage_weights):
        key = f"stage{i + 1}"
        if key not in stage_outputs:
            continue
        out = stage_outputs[key]
        with map_of(out) as shard:
            last = masked_smooth_l1(out["depth"],
                                    take_rows(shard, depth_gt_stages[key]),
                                    take_rows(shard, mask_stages[key]))
        total = total + w * last
    return total, last


def map_of(outputs: dict):
    """use_map of the layout of a model's maps ("shard" in its outputs),
    or of the default layout."""
    return use_map(outputs.get("shard"))


def take_rows(shard, x):
    """The rows of a (B, H, W) map that `shard` (a MapShard or None) holds."""
    return x if shard is None else shard.take(x)


def pyramid_loss(depth_est_levels, depth_gt_levels, mask_levels):
    """sum over the zipped levels of the masked smooth-L1, equal weights:
    the levels past the shortest list are not supervised."""
    total = 0.0
    for est, gt, mask in zip(depth_est_levels, depth_gt_levels, mask_levels):
        total = total + masked_smooth_l1(est, gt, mask)
    return total


def masked_mae(est, gt, mask, scale=1.0):
    """Mean |est - gt| / scale over the mask (PointFlow's interval-normalised
    MAE)."""
    return masked_mean((est - gt).abs() / scale, mask > 0.5)


def point_mvsnet_loss(preds: dict, gt_depth, depth_interval,
                      inter_scales=(0.75, 0.375)):
    """The mean over its terms of the coarse and each flow's
    interval-normalised MAE. gt_depth (B, H, W) at the images' resolution,
    0 = invalid, is picked (jax.image.resize "nearest": source pixel
    floor((i + 0.5) * in / out)) at each prediction's resolution; a term's
    interval is depth_interval (B,) x its stage's factor (1 for the coarse
    depth). Returns (total, {"coarse_loss", "flow<i>_loss"})."""
    def term(est, scale):
        gt = resize_nearest(gt_depth, *est.shape[1:])
        return masked_mae(est, gt, (gt > 0).to(est.dtype),
                          depth_interval[:, None, None] * scale)

    losses = {"coarse_loss": term(preds["coarse_depth"], 1.0)}
    for i, s in enumerate(inter_scales):
        key = f"flow{i + 1}"
        if key in preds:
            losses[f"{key}_loss"] = term(preds[key], s)
    return sum(losses.values()) / len(losses), losses
