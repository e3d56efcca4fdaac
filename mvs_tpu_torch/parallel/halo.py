"""The halo exchange of a volume whose dims are split over ranks
(parallel.sharding.VolumeShard), and the 3x3x3 convolutions of the U-Net
on such slabs: what GSPMD inserted around mvs_tpu's sharded convs.

``exchange`` extends a slab by one plane on each side of a split dim: the
neighbour's boundary plane, zeros past the first and the last slab (the
SAME padding). Its backward sends the halo's cotangent back to its owner,
which adds it to its boundary plane. ``extend`` exchanges along every
split dim in dim order (D, then H, then W), so the later exchanges carry
the earlier halos and a corner tap gets the diagonal neighbour's plane.

Transport, chosen by the group's backend and never mixed:
  * NCCL: batch_isend_irecv of the two planes to and from each neighbour;
  * gloo: each rank writes its two planes into its slot of a zero buffer
    and one all-reduce over the line gives every rank all of them (gloo
    moves CUDA tensors for all_reduce only, parallel.distributed), in f32
    for a bf16 slab.
A failed exchange raises from torch.distributed.

On a slab extended by the halo (conv sizes below are per split dim, L the
slab's planes):
  * a stride-1 SAME conv is a conv without padding on the split dims
    (``same_conv_padding``), or the kernel's SAME conv cropped by one plane
    (``crop``);
  * flax's stride-2 SAME conv pads (0, 1) for an even extent, so output o
    reads planes 2o .. 2o + 2: a slab starting at an even plane drops the
    lower halo and convolves L + 1 planes without padding (L / 2 out);
  * flax's stride-2 transposed conv (the dilated-input form, torch's
    conv_transpose over the flipped kernel cropped to 2 N) gives output 2o
    from inputs o and o - 1: the extended slab's 2 (L + 2) + 1 outputs
    cropped to [2, 2 L + 2).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mvs_tpu_torch.parallel.sharding import Split, VolumeShard

__all__ = ["exchange", "extend", "split_dims", "crop", "same_conv_padding",
           "stride2_input", "transposed_crop", "P2P_BACKENDS"]

# Backends whose halos move by point-to-point sends.
P2P_BACKENDS = ("nccl",)


def _trade(a: torch.Tensor, b: torch.Tensor, split: Split):
    """Send `a` to the slab before and `b` to the slab after; return (the
    `b` of the slab before, the `a` of the slab after), zeros at the
    ends."""
    a, b = a.contiguous(), b.contiguous()
    if dist.get_backend(split.group) in P2P_BACKENDS:
        lower, upper = torch.zeros_like(b), torch.zeros_like(a)
        ops = []
        if split.lower is not None:
            ops += [dist.P2POp(dist.isend, a, split.lower),
                    dist.P2POp(dist.irecv, lower, split.lower)]
        if split.upper is not None:
            ops += [dist.P2POp(dist.isend, b, split.upper),
                    dist.P2POp(dist.irecv, upper, split.upper)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return lower, upper
    wide = torch.float32 if a.dtype in (torch.bfloat16, torch.float16) \
        else a.dtype
    slots = a.new_zeros((split.count, 2) + tuple(a.shape), dtype=wide)
    slots[split.index, 0] = a
    slots[split.index, 1] = b
    dist.all_reduce(slots, group=split.group)
    zero = torch.zeros_like(a)
    lower = slots[split.index - 1, 1].to(a.dtype) if split.lower is not None \
        else zero
    upper = slots[split.index + 1, 0].to(a.dtype) if split.upper is not None \
        else zero
    return lower, upper


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        d, n = split.dim, x.shape[split.dim]
        lower, upper = _trade(x.narrow(d, 0, 1), x.narrow(d, n - 1, 1), split)
        return torch.cat([lower, x, upper], d)

    @staticmethod
    def backward(ctx, grad):
        split = ctx.split
        d, n = split.dim, grad.shape[split.dim] - 2
        # The halos' cotangents go back to their owners' boundary planes.
        lower, upper = _trade(grad.narrow(d, 0, 1),
                              grad.narrow(d, n + 1, 1), split)
        gx = grad.narrow(d, 1, n).clone()
        gx.narrow(d, 0, 1).add_(lower)
        gx.narrow(d, n - 1, 1).add_(upper)
        return gx, None


def exchange(x: torch.Tensor, split: Split) -> torch.Tensor:
    """x with one halo plane on each side of split.dim (differentiable)."""
    return _Exchange.apply(x, split)


def extend(x: torch.Tensor, shard: VolumeShard) -> torch.Tensor:
    """A channels-last (B, D, H, W, C) slab with its halo along every split
    dim, D first."""
    for split in shard.splits:
        x = exchange(x, split)
    return x


def split_dims(shard: VolumeShard | None) -> set:
    """The volume dims (1-3) that `shard` splits; none without one."""
    return set() if shard is None else {s.dim for s in shard.splits}


def crop(y: torch.Tensor, shard: VolumeShard) -> torch.Tensor:
    """Channels-last y without the first and last plane of each split
    dim."""
    for d in sorted(split_dims(shard)):
        y = y.narrow(d, 1, y.shape[d] - 2)
    return y


def same_conv_padding(shard: VolumeShard) -> list[int]:
    """The (D, H, W) padding of a 3x3x3 stride-1 SAME conv of an extended
    slab: 0 on the split dims, whose halo is there."""
    dims = split_dims(shard)
    return [0 if d in dims else 1 for d in (1, 2, 3)]


def stride2_input(x_ext: torch.Tensor, shard: VolumeShard) -> torch.Tensor:
    """An extended channels-last slab without its lower halo planes: a
    flax stride-2 SAME conv reads the next slab's first plane only."""
    for d in sorted(split_dims(shard)):
        x_ext = x_ext.narrow(d, 1, x_ext.shape[d] - 1)
    return x_ext


def transposed_crop(y: torch.Tensor, shard: VolumeShard, sizes) -> torch.Tensor:
    """The (B, C, D, H, W) stride-2 transposed conv of an extended slab
    cropped to this slab's 2 L planes on the split dims, and to 2 N on the
    others (`sizes`: the slab's (D, H, W) before the halo)."""
    dims = split_dims(shard)
    for i, (d, n) in enumerate(zip((1, 2, 3), sizes)):
        y = y.narrow(i + 2, 2 if d in dims else 0, 2 * n)
    return y
