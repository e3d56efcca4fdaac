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
    (mvs_tpu/models/cas_mvsnet.py:57-65).
  * ``psum_metrics``: a dict of scalars reduced with one all-reduce.
  * ``global_count``, ``global_moments``, ``gather_slots``: the reductions
    over the current mesh's 'data' group that the masked losses, BatchNorm
    and OHEM take (identities without a current mesh, or with one data
    rank).
  * ``sum_gradients``: the parameter gradients summed over every rank in
    one flat bucket per dtype.

Only ``all_reduce`` and ``broadcast`` move tensors: gloo has no CUDA
all_gather, so ``gather_slots`` all-reduces each rank's rows into its slot
of a zero buffer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mvs_tpu_torch.ops.cost_volume import variance_from_partials
from mvs_tpu_torch.ops.warp_variance import fused_variance_partials
from mvs_tpu_torch.parallel.mesh import Mesh, current_mesh

__all__ = ["all_reduce", "make_view_variance", "view_sharded_variance_volume",
           "psum_metrics", "global_count", "global_moments", "gather_slots",
           "sum_gradients", "data_group"]


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


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the current mesh's data ranks."""
    group = data_group()
    if group is None:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return count


def global_moments(mean: torch.Tensor, mean_sq: torch.Tensor):
    """(E[y], E[y^2]) over the global batch from a rank's own, with one
    differentiable all-reduce over the current mesh's data group: the ranks
    hold equal row counts, so the ranks' moments average."""
    group = data_group()
    if group is None:
        return mean, mean_sq
    n = current_mesh().size("data")
    both = all_reduce(torch.stack([mean, mean_sq]), group) / n
    return both[0], both[1]


def gather_slots(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(the current mesh's data ranks' 1-D `x` concatenated in data-rank
    order, this rank's offset in it), with no gradient: each rank's x
    all-reduced into its slot of a zero buffer; (x, 0) without a data
    group."""
    if data_group() is None:
        return x.detach(), 0
    mesh = current_mesh()
    n, r = mesh.size("data"), mesh.coord("data")
    buf = x.new_zeros((n, x.shape[0]))
    buf[r] = x.detach()
    dist.all_reduce(buf, group=mesh.group("data"))
    return buf.reshape(-1), r * x.shape[0]


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
    (B, V, 4, 4), depth_values (B, D, H, W)) -> the variance volume
    (B, D, H, W, C) in ref_feat's dtype over all V + 1 views, this rank
    warping only its own V / |view| source views (view rank i: views
    [i V / |view|, (i + 1) V / |view|)). V must divide by |view|."""
    n, idx, group = mesh.size("view"), mesh.coord("view"), mesh.group("view")

    def view_variance(ref_feat, src_feats, rel_projs, depth_values):
        num_src = src_feats.shape[1]
        if num_src % n:
            raise ValueError(f"{num_src} source views do not split over a "
                             f"view axis of {n}")
        per = num_src // n
        local = slice(idx * per, (idx + 1) * per)
        sums = fused_variance_partials(
            ref_feat, src_feats[:, local].contiguous(),
            rel_projs[:, local].contiguous(), depth_values, with_ref=idx == 0)
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
