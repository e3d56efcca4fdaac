"""Collectives of the global-batch train step (counterpart of
mvs_tpu.parallel.collectives).

  * ``all_reduce``: a sum over a process group whose backward is the same
    all-reduce of the cotangents, so that a collective in the forward
    (BatchNorm's global moments, the view shards' partial sums) passes
    every rank's share of the gradient back to every rank.
  * ``make_view_variance`` / ``view_sharded_variance_volume``: the variance
    volume with the source views split over the mesh 'view' axis. Each rank
    sums its own views' warped features and their squares in f32 on the
    warp kernel's partial-moment variant (ops.warp_variance
    .fused_variance_partials), the reference view a term on view rank 0
    only, one all-reduce over the 'view' group finishes the sums, then
    variance_from_partials over V_local * |view| + 1 views. This is the
    form that fixed mvs_tpu's 2x kernel-gradient error under GSPMD
    (mvs_tpu/models/cas_mvsnet.py:57-65). The features enter through
    ``shared`` over the 'view' group, as mvs_tpu's replicated features
    enter its shard_map (mvs_tpu/parallel/collectives.py:87-94).
  * ``psum_metrics``: a dict of scalars reduced with one all-reduce.
  * ``global_count``, ``global_moments``, ``gather_map``: the reductions
    that the masked losses, BatchNorm and OHEM take (identities without a
    current mesh): counts and OHEM's ranking over the ranks whose maps
    make the global batch's (sharding.current_map: 'data', and the axes
    that split a regressed map's rows); BatchNorm's moments over 'data',
    or inside a split volume (sharding.current_volume) over 'data' x
    'depth' x 'space', each rank's moments weighted by its share of the
    elements.
  * ``regress_sharded``: softmax, soft-argmin and the 4-tap confidence
    over a depth axis split over ranks: the max of the scores over the
    line as a shift (no gradient), then one all-reduce of the sums
    sum(exp), sum(exp * depth) and sum(exp * index), and one of the
    window's taps, each rank adding the taps it holds at the global index.
  * ``shared``: the features, which every rank of a view group or of a
    split volume's sample group computes alike, entering the volume: their
    cotangent is summed over the group (f32) before the feature net's
    backward, so that each rank runs it on the whole cotangent (GSPMD's
    all-reduce where a replicated tensor meets sharded consumers, the
    transpose of shard_map's replicated in_specs) and rounds it as one
    process does.
  * ``gather_rows``: a map's parts over the ranks that split its rows
    (CasMVSNet's next stage upsamples the whole map).
  * ``sum_gradients``: the parameter gradients summed over every rank in
    one flat bucket per dtype.

Only ``all_reduce`` and ``broadcast`` move tensors (and the halo's sends
under NCCL, parallel.halo): gloo has no CUDA all_gather, so a gather
all-reduces each rank's part into its place in a zero buffer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mvs_tpu_torch.ops.cost_volume import variance_from_partials
from mvs_tpu_torch.ops.regression import regress_depth_and_confidence
from mvs_tpu_torch.ops.warp_variance import fused_variance_partials
from mvs_tpu_torch.parallel.mesh import Mesh, current_mesh
from mvs_tpu_torch.parallel.sharding import (MapShard, VolumeShard,
                                             current_map, current_volume)

__all__ = ["all_reduce", "make_view_variance", "view_sharded_variance_volume",
           "psum_metrics", "global_count", "global_moments", "gather_map",
           "gather_rows", "regress_sharded", "shared", "sum_gradients",
           "data_group", "metrics_group"]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, n, *xs):
        ctx.group, ctx.n = group, n
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        total = torch.cat([g.float().reshape(-1) for g in grads])
        dist.all_reduce(total, group=ctx.group)
        total /= ctx.n
        parts = total.split([g.numel() for g in grads])
        return (None, None) + tuple(p.view_as(g).to(g.dtype)
                                    for p, g in zip(parts, grads))


def shared(x, group):
    """`x` (a tensor or a tuple of tensors), held alike by every rank of
    `group` (None: x itself), whose consumers on those ranks each take a
    part of it: the identity, whose backward sums the ranks' cotangents in
    f32 over the group (one all-reduce for the tuple) and divides by its
    size. Every rank then runs the backward of x's producer on the whole
    cotangent, as one process does, and sum_gradients' sum over the group
    counts it once. Two nested calls over orthogonal groups (no two ranks
    of one lie in the other) give each rank the mean over the groups'
    product: the inner call's means, averaged by the outer one."""
    if group is None:
        return x
    xs = x if isinstance(x, tuple) else (x,)
    out = _Shared.apply(group, dist.get_world_size(group), *xs)
    return out if isinstance(x, tuple) else out[0]


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group` (None: x itself), differentiable: its
    backward all-reduces the cotangents over the same group."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def data_group(mesh: Mesh | None = None):
    """The 'data' group of `mesh` (default: the current mesh), None when
    there is no mesh or one data rank."""
    mesh = mesh or current_mesh()
    return None if mesh is None else mesh.group("data")


def metrics_group(mesh: Mesh):
    """The ranks whose metric shares sum to the global batch's: 'data' x
    'depth' x 'space' (a view group's ranks hold the same shares)."""
    return mesh.group_of(("data", "depth", "space"))


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the ranks whose maps make the
    global batch's (the current map's group)."""
    shard = current_map()
    group = None if shard is None else shard.group
    if group is None:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return count


def global_moments(y: torch.Tensor):
    """(E[y], E[y^2]) per channel of channels-last `y` over the global
    batch, from a rank's own part: the ranks' moments weighted by their
    shares n / N of the elements (N the all-reduced count, in f64) and
    summed with one differentiable all-reduce, over the current mesh's
    data group, or inside a split volume, whose slabs may differ, over the
    volume's moments group. Over k equal parts, k a power of 2, the
    weights are exactly 1 / k."""
    dims = tuple(range(y.ndim - 1))
    shard = current_volume()
    group = data_group() if shard is None else shard.moments_group
    if group is None:
        return y.mean(dims), (y * y).mean(dims)
    n = float(y[..., 0].numel())
    total = torch.full((), n, dtype=torch.float64, device=y.device)
    dist.all_reduce(total, group=group)
    share = (n / total).to(y.dtype)
    both = all_reduce(torch.stack([y.mean(dims), (y * y).mean(dims)])
                      * share, group)
    return both[0], both[1]


@torch.no_grad()
def gather_map(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the global batch's (B, H, W) map made of every rank's part `x` of
    the current map, a bool map of this rank's part in it): each rank's
    part all-reduced into its place in a zero buffer over the current
    map's group; (x, all True) without one."""
    shard = current_map()
    if shard is None or shard.group is None:
        return x, torch.ones_like(x, dtype=torch.bool)
    mesh = shard.mesh
    n, r, b = mesh.size("data"), mesh.coord("data"), x.shape[0]
    part = shard.place(x)
    buf = x.new_zeros((n * b,) + tuple(part.shape[1:]))
    buf[r * b:(r + 1) * b] = part
    mine = torch.zeros_like(buf, dtype=torch.bool)
    mine[r * b:(r + 1) * b] = shard.place(torch.ones_like(x)) > 0
    dist.all_reduce(buf, group=shard.group)
    return buf, mine


def gather_rows(x: torch.Tensor, shard: MapShard) -> torch.Tensor:
    """The whole (B, H, W) map of the data rank's samples from each rank's
    part `x` (differentiable: the all-reduce's backward hands each part its
    cotangent); x itself when no axis splits the map."""
    group = shard.part_group
    return x if group is None else all_reduce(shard.place(x), group)


def regress_sharded(cost: torch.Tensor, depth_values: torch.Tensor,
                    shard: VolumeShard | None):
    """ops.regression.regress_depth_and_confidence on this rank's slab of
    the score volume (B, D_l, h, w), depth_values its (B, D_l) ladder or
    (B, D_l, h, w) hypotheses, when `shard` splits D over a line of ranks:
    (depth, confidence) of the rows it holds, equal on every rank of the
    line, and its slab of the probability volume."""
    split = None if shard is None else shard.split(1)
    if split is None:
        return regress_depth_and_confidence(cost, depth_values)
    group = split.group
    shift = cost.detach().amax(dim=1, keepdim=True)
    dist.all_reduce(shift, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(cost - shift)
    if depth_values.ndim == 2:
        depth_values = depth_values[:, :, None, None]
    steps = torch.arange(split.start, split.stop, dtype=e.dtype,
                         device=e.device)[None, :, None, None]
    sums = all_reduce(torch.stack([e.sum(1), (e * depth_values).sum(1),
                                   (e.detach() * steps).sum(1)]), group)
    prob = e / sums[0][:, None]
    depth = sums[1] / sums[0]
    # The 4-tap window {i-1 .. i+2} around the truncated global index i may
    # span two slabs: each rank adds the taps it holds.
    fixed = prob.detach()
    index = (sums[2] / sums[0]).detach()
    idx = index.clamp(0, split.extent - 1).to(torch.int64)[:, None]
    window = (steps >= idx - 1) & (steps <= idx + 2)
    conf = torch.sum(fixed * window.to(fixed.dtype), dim=1)
    dist.all_reduce(conf, group=group)
    return depth, conf, prob


def psum_metrics(metrics: dict, group) -> dict:
    """The sums over `group` of a dict of scalar tensors, with one
    all-reduce; detached, and unchanged when `group` is None. The train
    step's metrics are each rank's shares of global means, so their sum is
    the global value (mvs_tpu's psum_metrics means per-shard values, which
    under GSPMD are already global)."""
    if group is None or not metrics:
        return {k: v.detach() for k, v in metrics.items()}
    keys = list(metrics)
    flat = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                        .reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))


def sum_gradients(grads, params, group=None) -> list:
    """The gradients summed over `group` (default: every rank), once, in one
    flat bucket per dtype; a missing gradient counts as zero."""
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


def make_view_variance(mesh: Mesh):
    """fn(ref_feat (B, H, W, C), src_feats (B, V, H, W, C), rel_projs
    (B, V, 4, 4), depth_values (B, D, H, W), row0=0) -> the variance volume
    (B, D, H, W, C) in ref_feat's dtype over all V + 1 views, this rank
    warping only its own V / |view| source views (view rank i: views
    [i V / |view|, (i + 1) V / |view|)). V must divide by |view|. With a
    split volume (row0, fused_variance_volume's row window) the rank
    builds its slab only, as mvs_tpu's in_specs P('data', 'depth') do.

    Every view rank holds ref_feat and src_feats whole, and their cotangent
    is summed over the 'view' group before the feature net's backward
    (shared), so that each rank runs that backward on the whole cotangent
    and rounds it as one process does: mvs_tpu feeds replicated features
    into its shard_map, whose transpose sums their cotangent over 'view'
    (a psum) before the feature net's backward runs once. The sum sits
    here, not in the models, so that every caller of the view split takes
    it; with a split volume the models' own shared over its sample group
    (depth x space, orthogonal to 'view') wraps this one, and each rank's
    features take the mean over view x depth x space."""
    n, idx, group = mesh.size("view"), mesh.coord("view"), mesh.group("view")

    def view_variance(ref_feat, src_feats, rel_projs, depth_values, row0=0):
        num_src = src_feats.shape[1]
        if num_src % n:
            raise ValueError(f"{num_src} source views do not split over a "
                             f"view axis of {n}")
        per = num_src // n
        ref_feat, src_feats = shared((ref_feat, src_feats), group)
        local = slice(idx * per, (idx + 1) * per)
        sums = fused_variance_partials(
            ref_feat, src_feats[:, local].contiguous(),
            rel_projs[:, local].contiguous(), depth_values, with_ref=idx == 0,
            row0=row0)
        sum_f, sum_sq = all_reduce(torch.stack(sums), group).unbind()
        return variance_from_partials(sum_f, sum_sq,
                                      per * n + 1).to(ref_feat.dtype)

    return view_variance


def view_sharded_variance_volume(mesh: Mesh, ref_feat, src_feats, rel_projs,
                                 depth_values) -> torch.Tensor:
    """make_view_variance for one sample: ref_feat (H, W, C), src_feats
    (V, H, W, C), rel_projs (V, 4, 4), depth_values (D,) or (D, H, W) ->
    (D, H, W, C)."""
    h, w = ref_feat.shape[:2]
    if depth_values.ndim == 1:
        depth_values = depth_values[:, None, None].expand(-1, h, w)
    return make_view_variance(mesh)(
        ref_feat[None], src_feats[None], rel_projs[None],
        depth_values[None].float().contiguous())[0]
