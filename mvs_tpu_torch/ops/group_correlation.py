"""Fused warp + group-wise correlation volume (AACVP-MVSNet's cost): wrapper
of the CUDA kernel in ``csrc/group_correlation.cu`` (counterpart of
mvs_tpu.ops.hat_warp's fused mode="group_correlation" and of
mvs_tpu.ops.cost_volume.group_correlation_cost_volume).

``group_correlation_volume`` launches the kernel for CUDA tensors and runs
the plain PyTorch version (``group_correlation_volume_plain``, the exact
gather path of ops.cost_volume) only for CPU tensors; it never falls back
from one to the other. The forward runs its lane kernel, which reads 16-byte
chunks of channels, when C % 8 == 0, C is at most 32 chunks (128 f32 or 256
bf16 channels) and every feature pointer is 16-byte aligned (the vector
variant); otherwise it runs with masked scalar accesses. The backward's
vector variant needs only C % 8 == 0 and the alignment.

When the features or the hypotheses require a gradient, the CUDA path is an
autograd Function that saves only its inputs and whose backward is the
backward kernel (``group_correlation_volume_grad``: dref, dsrc and, only
when ``depth_values`` requires one, the hypotheses' gradient); on the CPU
autograd runs through the plain version, whose gradients
``group_correlation_volume_grad_plain`` gives. Both paths raise if
``rel_projs`` requires a gradient: no model differentiates the cameras.

Counters: ``group_correlation_volume.launches`` (launches),
``group_correlation_volume.vector_launches`` (of the vector variant),
``group_correlation_volume_grad.launches`` (backward launches) and
``group_correlation_volume_grad.depth_launches`` (of those, with the
hypotheses' gradient).
"""

from __future__ import annotations

import ctypes

import torch

from mvs_tpu_torch.ops import _build
from mvs_tpu_torch.ops._volume_common import (DTYPES, check_cuda_inputs,
                                              check_geometry_grad, check_grad,
                                              geometry, vector, vjp_plain)
from mvs_tpu_torch.ops.cost_volume import group_correlation_cost_volume

__all__ = ["group_correlation_volume", "group_correlation_volume_plain",
           "group_correlation_volume_grad",
           "group_correlation_volume_grad_plain"]

_SIGNATURES = {
    "mvs_group_correlation": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                              + [ctypes.c_void_p], ctypes.c_int),
    "mvs_group_correlation_grad": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                                   + [ctypes.c_void_p], ctypes.c_int),
}

group_correlation_volume_plain = group_correlation_cost_volume


def group_correlation_volume_grad_plain(grad, ref_feat, src_feats,
                                        rel_projs, depth_values, num_groups,
                                        depth_grad: bool = True):
    """(dref, dsrc, ddepth) by autograd through the plain version (ddepth
    None unless `depth_grad`)."""
    return vjp_plain(group_correlation_volume_plain, grad, ref_feat,
                     src_feats, rel_projs, depth_values, num_groups,
                     depth_grad=depth_grad)


def _check_groups(c, num_groups):
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")


def _launch_forward(ref_feat, src_feats, rel_projs, depth_values, num_groups):
    b, nv, d, h, w, c = check_cuda_inputs(ref_feat, src_feats, rel_projs,
                                          depth_values)
    _check_groups(c, num_groups)
    geom = geometry(rel_projs)
    out = torch.empty((b, d, h, w, num_groups), dtype=ref_feat.dtype,
                      device=ref_feat.device)
    vec = (vector(c, ref_feat, src_feats)
           and c * ref_feat.element_size() <= 32 * 16)
    lib = _build.load("group_correlation", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_group_correlation(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), out.data_ptr(), b, nv, d, h, w, c,
            num_groups, DTYPES[ref_feat.dtype], int(vec), stream)
    _build.check(status, "group_correlation")
    group_correlation_volume.launches += 1
    group_correlation_volume.vector_launches += int(vec)
    return out


def group_correlation_volume_grad(grad, ref_feat, src_feats, rel_projs,
                                  depth_values, num_groups: int,
                                  depth_grad: bool = False):
    """(dref (B, H, W, C), dsrc (B, V, H, W, C), ddepth (B, D, H, W) or
    None) given grad = dL/dout (B, D, H, W, G) and the forward's inputs:
    the features' gradients in their dtype, the hypotheses' in f32 when
    `depth_grad`, else None.

    Launches the backward kernel for CUDA tensors (sums in f32, dsrc
    scattered into an f32 buffer and cast once); CPU tensors run autograd
    through the plain version.
    """
    if ref_feat.device.type == "cpu":
        return group_correlation_volume_grad_plain(
            grad, ref_feat, src_feats, rel_projs, depth_values, num_groups,
            depth_grad)
    b, nv, d, h, w, c = check_cuda_inputs(ref_feat, src_feats, rel_projs,
                                          depth_values)
    _check_groups(c, num_groups)
    grad = check_grad(grad, (b, d, h, w, num_groups), ref_feat)
    geom = geometry(rel_projs)
    dref = torch.empty_like(ref_feat)
    dsrc = torch.zeros(src_feats.shape, dtype=torch.float32,
                       device=src_feats.device)
    ddepth = (torch.empty(depth_values.shape, dtype=torch.float32,
                          device=depth_values.device) if depth_grad else None)
    vec = vector(c, ref_feat, src_feats)
    lib = _build.load("group_correlation", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_group_correlation_grad(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), grad.data_ptr(), dref.data_ptr(),
            dsrc.data_ptr(), None if ddepth is None else ddepth.data_ptr(),
            b, nv, d, h, w, c, num_groups, DTYPES[ref_feat.dtype], int(vec),
            stream)
    _build.check(status, "group_correlation_grad")
    group_correlation_volume_grad.launches += 1
    group_correlation_volume_grad.depth_launches += int(depth_grad)
    return dref, dsrc.to(src_feats.dtype), ddepth


group_correlation_volume_grad.launches = 0
group_correlation_volume_grad.depth_launches = 0


class _GroupCorrelation(torch.autograd.Function):
    """The forward kernel, saving only its inputs; the backward kernel."""

    @staticmethod
    def forward(ctx, ref_feat, src_feats, rel_projs, depth_values,
                num_groups):
        ctx.save_for_backward(ref_feat, src_feats, rel_projs, depth_values)
        ctx.num_groups = num_groups
        return _launch_forward(ref_feat, src_feats, rel_projs, depth_values,
                               num_groups)

    @staticmethod
    def backward(ctx, grad):
        dref, dsrc, ddepth = group_correlation_volume_grad(
            grad, *ctx.saved_tensors, ctx.num_groups,
            depth_grad=ctx.needs_input_grad[3])
        return dref, dsrc, None, ddepth, None


def group_correlation_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                             rel_projs: torch.Tensor,
                             depth_values: torch.Tensor,
                             num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume (B, D, H, W, G), exact bilinear.

    ref_feat (B, H, W, C) and src_feats (B, V, H, W, C), f32 or bf16,
    contiguous, C divisible by G = num_groups; rel_projs (B, V, 4, 4) src @
    ref^-1; depth_values (B, D, H, W) f32 contiguous per-pixel hypotheses.
    Output in the features' dtype, sums in f32; differentiable in the
    features and the hypotheses.
    """
    check_geometry_grad(rel_projs, "the group correlation")
    if ref_feat.device.type == "cpu":
        return group_correlation_volume_plain(ref_feat, src_feats, rel_projs,
                                              depth_values, num_groups)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ref_feat, src_feats, depth_values)):
        return _GroupCorrelation.apply(ref_feat, src_feats, rel_projs,
                                       depth_values, num_groups)
    return _launch_forward(ref_feat, src_feats, rel_projs, depth_values,
                           num_groups)


group_correlation_volume.launches = 0
group_correlation_volume.vector_launches = 0
