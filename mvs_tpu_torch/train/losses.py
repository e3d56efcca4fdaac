"""Depth losses of MVSNet, CasMVSNet and CVP / AACVP-MVSNet (counterpart
of mvs_tpu.train.losses: smooth_l1, masked_smooth_l1, ohem_smooth_l1,
cascade_loss, pyramid_loss).

Pure functions of tensors with a {0, 1} float mask, safe under an
all-masked batch (0 / 0 guarded). The point loss waits for its model
family (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import torch

__all__ = ["smooth_l1", "masked_smooth_l1", "ohem_smooth_l1",
           "cascade_loss", "pyramid_loss"]


def smooth_l1(err: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber: 0.5 e^2 / beta for |e| < beta, else |e| - beta/2."""
    abs_err = err.abs()
    return torch.where(abs_err < beta, 0.5 * err * err / beta,
                       abs_err - 0.5 * beta)


def masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of `values` where `valid` (bool), 0 when nothing is valid."""
    mask = valid.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def masked_smooth_l1(depth_est, depth_gt, mask, beta: float = 1.0):
    return masked_mean(smooth_l1(depth_est - depth_gt, beta), mask > 0.5)


def ohem_smooth_l1(depth_est, depth_gt, mask, topk_frac: float = 0.6):
    """Online hard-example mining: the mean smooth-L1 over the hardest
    k = max(floor(topk_frac * n_valid), 1) of the n_valid masked-in
    pixels. k depends on the data, so the errors are sorted in descending
    order with the masked-out pixels at -inf (past every valid one) and the
    finite entries of rank < k are averaged, on the device. The gradient
    reaches the selected pixels only. 0 for an all-masked batch."""
    err = smooth_l1(depth_est - depth_gt).reshape(-1)
    valid = (mask > 0.5).reshape(-1)
    ranked = torch.sort(torch.where(valid, err, -torch.inf),
                        descending=True).values
    n_valid = valid.sum(dtype=torch.float32)
    k = torch.clamp(torch.floor(topk_frac * n_valid), min=1.0)
    ranks = torch.arange(ranked.shape[0], dtype=torch.float32,
                         device=ranked.device)
    take = (ranks < k) & torch.isfinite(ranked)
    return (torch.sum(torch.where(take, ranked, 0.0))
            / torch.clamp(take.sum(dtype=torch.float32), min=1.0))


def cascade_loss(stage_outputs: dict, depth_gt_stages: dict,
                 mask_stages: dict, stage_weights=(0.5, 1.0, 2.0)):
    """sum_k w_k * masked smooth-L1 of stage k ('stage1'..'stageN' keys in
    every dict). Returns (total, last_stage_loss)."""
    total = last = 0.0
    for i, w in enumerate(stage_weights):
        key = f"stage{i + 1}"
        if key not in stage_outputs:
            continue
        last = masked_smooth_l1(stage_outputs[key]["depth"],
                                depth_gt_stages[key], mask_stages[key])
        total = total + w * last
    return total, last


def pyramid_loss(depth_est_levels, depth_gt_levels, mask_levels):
    """sum over the zipped levels of the masked smooth-L1, equal weights:
    the levels past the shortest list are not supervised."""
    total = 0.0
    for est, gt, mask in zip(depth_est_levels, depth_gt_levels, mask_levels):
        total = total + masked_smooth_l1(est, gt, mask)
    return total
