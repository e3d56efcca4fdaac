"""Fused warp + variance volume and its gradient: wrappers of the CUDA
kernels in ``csrc/warp_variance.cu`` (counterpart of
mvs_tpu.ops.warp_pallas, and of the gather path the JAX package trains
through).

``fused_variance_volume`` launches the forward kernel for CUDA tensors and
runs the plain PyTorch version (``fused_variance_volume_plain``, the exact
gather path of ops.cost_volume) only for CPU tensors; it never falls back
from one to the other. The kernel reads and writes 8 channels as one
16-byte access when C % 8 == 0 and every feature pointer is 16-byte aligned
(the vector variant, every launch of the main path); otherwise the same
kernel runs with masked scalar accesses.

When the features or the hypotheses require a gradient, the CUDA path is an
autograd Function that saves only its inputs (as the JAX model's
jax.checkpoint does) and whose backward is the backward kernel
(``fused_variance_volume_grad``), with the hypotheses' gradient computed
only when ``depth_values`` requires one; on the CPU autograd runs through
the plain version. No model differentiates the cameras: both paths raise if
``rel_projs`` requires a gradient.

Every entry takes ``row0``: the reference features and the hypotheses
hold rows row0 .. row0 + H - 1 of source views with more rows (the
kernels' row window, for a volume whose rows are split over processes,
parallel.sharding); the output holds those rows of the whole volume.

``fused_variance_partials`` is the kernels' partial-moment variant, for a
volume whose source views are split over processes (parallel.collectives):
the f32 sums of the local views' warped features and of their squares, the
reference view a term only where asked, and their backward; its plain
version is ``fused_variance_partials_plain`` (ops.cost_volume's
variance_partials), and it never falls back either.

Counters: ``fused_variance_volume.launches`` (forward launches),
``fused_variance_volume.vector_launches`` (of the vector variant),
``fused_variance_volume_grad.launches`` (backward launches) and
``fused_variance_volume_grad.depth_launches`` (of those, with the
hypotheses' gradient); likewise ``fused_variance_partials.launches``,
``.vector_launches``, ``fused_variance_partials_grad.launches`` and
``.depth_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from mvs_tpu_torch.ops import _build
from mvs_tpu_torch.ops._volume_common import (DTYPES, check_cuda_inputs,
                                              check_geometry_grad, check_grad,
                                              geometry, vector, vjp_plain)
from mvs_tpu_torch.ops.cost_volume import (variance_cost_volume,
                                           variance_partials)

__all__ = ["fused_variance_volume", "fused_variance_volume_plain",
           "fused_variance_volume_grad", "fused_variance_volume_grad_plain",
           "fused_variance_partials", "fused_variance_partials_plain",
           "fused_variance_partials_grad",
           "fused_variance_partials_grad_plain"]

_SIGNATURES = {
    "mvs_warp_variance": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                          + [ctypes.c_void_p], ctypes.c_int),
    "mvs_warp_variance_grad": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                               + [ctypes.c_void_p], ctypes.c_int),
    "mvs_warp_partials": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                          + [ctypes.c_void_p], ctypes.c_int),
    "mvs_warp_partials_grad": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                               + [ctypes.c_void_p], ctypes.c_int),
}

fused_variance_volume_plain = variance_cost_volume


def fused_variance_volume_grad_plain(grad, ref_feat, src_feats, rel_projs,
                                     depth_values, depth_grad: bool = True,
                                     row0: int = 0):
    """(dref, dsrc, ddepth) by autograd through the plain version (ddepth
    None unless `depth_grad`)."""
    return vjp_plain(fused_variance_volume_plain, grad, ref_feat, src_feats,
                     rel_projs, depth_values, row0, depth_grad=depth_grad)


def _launch_forward(ref_feat, src_feats, rel_projs, depth_values, row0):
    b, nv, d, h, w, c = check_cuda_inputs(ref_feat, src_feats, rel_projs,
                                          depth_values, row0)
    geom = geometry(rel_projs)
    out = torch.empty((b, d, h, w, c), dtype=ref_feat.dtype,
                      device=ref_feat.device)
    vec = vector(c, ref_feat, src_feats, out)
    lib = _build.load("warp_variance", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_warp_variance(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), out.data_ptr(), b, nv, d, h, w, c,
            src_feats.shape[2], row0, DTYPES[ref_feat.dtype], int(vec),
            stream)
    _build.check(status, "warp_variance")
    fused_variance_volume.launches += 1
    fused_variance_volume.vector_launches += int(vec)
    return out


def fused_variance_volume_grad(grad, ref_feat, src_feats, rel_projs,
                               depth_values, depth_grad: bool = False,
                               row0: int = 0):
    """(dref (B, H, W, C), dsrc (B, V, H, W, C), ddepth (B, D, H, W) or None)
    given grad = dL/dvar (B, D, H, W, C) and the forward's inputs: the
    features' gradients in their dtype, the hypotheses' in f32 when
    `depth_grad`, else None.

    Launches the backward kernel for CUDA tensors (sums in f32, dsrc
    scattered into an f32 buffer and cast once; the hypotheses' gradient by
    the kernel's depth variant); CPU tensors run autograd through the plain
    version.
    """
    if ref_feat.device.type == "cpu":
        return fused_variance_volume_grad_plain(
            grad, ref_feat, src_feats, rel_projs, depth_values, depth_grad,
            row0)
    b, nv, d, h, w, c = check_cuda_inputs(ref_feat, src_feats, rel_projs,
                                          depth_values, row0)
    grad = check_grad(grad, (b, d, h, w, c), ref_feat)
    geom = geometry(rel_projs)
    dref = torch.empty_like(ref_feat)
    dsrc = torch.zeros(src_feats.shape, dtype=torch.float32,
                       device=src_feats.device)
    ddepth = (torch.empty(depth_values.shape, dtype=torch.float32,
                          device=depth_values.device) if depth_grad else None)
    vec = vector(c, ref_feat, src_feats, grad, dref)
    lib = _build.load("warp_variance", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_warp_variance_grad(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), grad.data_ptr(), dref.data_ptr(),
            dsrc.data_ptr(), None if ddepth is None else ddepth.data_ptr(),
            b, nv, d, h, w, c, src_feats.shape[2], row0,
            DTYPES[ref_feat.dtype], int(vec), stream)
    _build.check(status, "warp_variance_grad")
    fused_variance_volume_grad.launches += 1
    fused_variance_volume_grad.depth_launches += int(depth_grad)
    return dref, dsrc.to(src_feats.dtype), ddepth


fused_variance_volume_grad.launches = 0
fused_variance_volume_grad.depth_launches = 0


class _WarpVariance(torch.autograd.Function):
    """The forward kernel, saving only its inputs; the backward kernel."""

    @staticmethod
    def forward(ctx, ref_feat, src_feats, rel_projs, depth_values, row0):
        ctx.save_for_backward(ref_feat, src_feats, rel_projs, depth_values)
        ctx.row0 = row0
        return _launch_forward(ref_feat, src_feats, rel_projs, depth_values,
                               row0)

    @staticmethod
    def backward(ctx, grad):
        dref, dsrc, ddepth = fused_variance_volume_grad(
            grad, *ctx.saved_tensors, depth_grad=ctx.needs_input_grad[3],
            row0=ctx.row0)
        return dref, dsrc, None, ddepth, None


def fused_variance_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                          rel_projs: torch.Tensor,
                          depth_values: torch.Tensor,
                          row0: int = 0) -> torch.Tensor:
    """Variance volume (B, D, H, W, C) over ref + V views, exact bilinear.

    ref_feat (B, H, W, C) and src_feats (B, V, H, W, C), f32 or bf16,
    contiguous; rel_projs (B, V, 4, 4) src @ ref^-1; depth_values
    (B, D, H, W) f32 contiguous per-pixel hypotheses. Output in the
    features' dtype; differentiable in the features and the hypotheses.
    With `row0`, ref_feat and depth_values hold rows row0 .. row0 + H - 1
    of the source views' rows, and the output those rows of the volume.
    """
    check_geometry_grad(rel_projs, "the warp")
    if ref_feat.device.type == "cpu":
        return fused_variance_volume_plain(ref_feat, src_feats, rel_projs,
                                           depth_values, row0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ref_feat, src_feats, depth_values)):
        return _WarpVariance.apply(ref_feat, src_feats, rel_projs,
                                   depth_values, row0)
    return _launch_forward(ref_feat, src_feats, rel_projs, depth_values,
                           row0)


fused_variance_volume.launches = 0
fused_variance_volume.vector_launches = 0


fused_variance_partials_plain = variance_partials


def fused_variance_partials_grad_plain(g1, g2, ref_feat, src_feats,
                                       rel_projs, depth_values,
                                       with_ref: bool = True,
                                       depth_grad: bool = True,
                                       row0: int = 0):
    """(dref, dsrc, ddepth) by autograd through the plain partials for the
    cotangents g1 of sum_f and g2 of sum_sq: dref None unless `with_ref`,
    ddepth None unless `depth_grad`."""
    with torch.enable_grad():
        ref, src, depth = (t.detach().requires_grad_(need) for t, need in (
            (ref_feat, with_ref), (src_feats, True),
            (depth_values, depth_grad)))
        wrt = [t for t in (ref, src, depth) if t.requires_grad]
        grads = iter(torch.autograd.grad(
            variance_partials(ref, src, rel_projs, depth, with_ref, row0),
            wrt,
            (g1, g2)))
    return tuple(next(grads) if t.requires_grad else None
                 for t in (ref, src, depth))


def _partial_inputs(ref_feat, src_feats, rel_projs, depth_values, row0):
    dims = check_cuda_inputs(ref_feat, src_feats, rel_projs, depth_values,
                             row0)
    if dims[1] == 0:
        raise ValueError("the partial sums need at least one source view")
    return dims


def _launch_partials(ref_feat, src_feats, rel_projs, depth_values,
                     with_ref: bool, row0: int):
    b, nv, d, h, w, c = _partial_inputs(ref_feat, src_feats, rel_projs,
                                        depth_values, row0)
    geom = geometry(rel_projs)
    sum_f, sum_sq = torch.empty((2, b, d, h, w, c), dtype=torch.float32,
                                device=ref_feat.device)
    vec = vector(c, ref_feat, src_feats, sum_f, sum_sq)
    lib = _build.load("warp_variance", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_warp_partials(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), sum_f.data_ptr(), sum_sq.data_ptr(), b,
            nv, d, h, w, c, src_feats.shape[2], row0, int(with_ref),
            DTYPES[ref_feat.dtype], int(vec), stream)
    _build.check(status, "warp_partials")
    fused_variance_partials.launches += 1
    fused_variance_partials.vector_launches += int(vec)
    return sum_f, sum_sq


def fused_variance_partials_grad(g1, g2, ref_feat, src_feats, rel_projs,
                                 depth_values, with_ref: bool = True,
                                 depth_grad: bool = False, row0: int = 0):
    """(dref (B, H, W, C) or None, dsrc (B, V, H, W, C), ddepth (B, D, H, W)
    or None) given g1 = dL/dsum_f and g2 = dL/dsum_sq (B, D, H, W, C) and
    the forward's inputs: dref None unless `with_ref` (the reference view
    was a term), the features' gradients in their dtype, the hypotheses' in
    f32 when `depth_grad`.

    Launches the backward kernel's partial variant for CUDA tensors; CPU
    tensors run autograd through the plain version.
    """
    if ref_feat.device.type == "cpu":
        return fused_variance_partials_grad_plain(
            g1, g2, ref_feat, src_feats, rel_projs, depth_values, with_ref,
            depth_grad, row0)
    b, nv, d, h, w, c = _partial_inputs(ref_feat, src_feats, rel_projs,
                                        depth_values, row0)
    g1, g2 = (g.float().contiguous() for g in (g1, g2))
    for g in (g1, g2):
        if g.shape != (b, d, h, w, c) or g.device != ref_feat.device:
            raise ValueError(f"cotangent {tuple(g.shape)} on {g.device}, "
                             f"want {(b, d, h, w, c)} on {ref_feat.device}")
    geom = geometry(rel_projs)
    dref = torch.empty_like(ref_feat) if with_ref else None
    dsrc = torch.zeros(src_feats.shape, dtype=torch.float32,
                       device=src_feats.device)
    ddepth = (torch.empty(depth_values.shape, dtype=torch.float32,
                          device=depth_values.device) if depth_grad else None)
    vec = vector(c, ref_feat, src_feats, g1, g2,
                 *(() if dref is None else (dref,)))
    lib = _build.load("warp_variance", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_warp_partials_grad(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), g1.data_ptr(), g2.data_ptr(),
            None if dref is None else dref.data_ptr(), dsrc.data_ptr(),
            None if ddepth is None else ddepth.data_ptr(), b, nv, d, h, w, c,
            src_feats.shape[2], row0, int(with_ref), DTYPES[ref_feat.dtype],
            int(vec), stream)
    _build.check(status, "warp_partials_grad")
    fused_variance_partials_grad.launches += 1
    fused_variance_partials_grad.depth_launches += int(depth_grad)
    return dref, dsrc.to(src_feats.dtype), ddepth


fused_variance_partials_grad.launches = 0
fused_variance_partials_grad.depth_launches = 0


class _WarpPartials(torch.autograd.Function):
    """The partial-moment forward kernel, saving only its inputs; its
    backward kernel."""

    @staticmethod
    def forward(ctx, ref_feat, src_feats, rel_projs, depth_values, with_ref,
                row0):
        ctx.save_for_backward(ref_feat, src_feats, rel_projs, depth_values)
        ctx.with_ref, ctx.row0 = with_ref, row0
        return _launch_partials(ref_feat, src_feats, rel_projs, depth_values,
                                with_ref, row0)

    @staticmethod
    def backward(ctx, g1, g2):
        ref_feat = ctx.saved_tensors[0]
        shape = ref_feat.shape[:1] + ctx.saved_tensors[3].shape[1:2] + \
            ref_feat.shape[1:]
        g1, g2 = (torch.zeros(shape, dtype=torch.float32,
                              device=ref_feat.device) if g is None else g
                  for g in (g1, g2))
        dref, dsrc, ddepth = fused_variance_partials_grad(
            g1, g2, *ctx.saved_tensors, with_ref=ctx.with_ref,
            depth_grad=ctx.needs_input_grad[3], row0=ctx.row0)
        if dref is None and ctx.needs_input_grad[0]:
            dref = torch.zeros_like(ref_feat)
        return dref, dsrc, None, ddepth, None, None


def fused_variance_partials(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                            rel_projs: torch.Tensor,
                            depth_values: torch.Tensor,
                            with_ref: bool = True, row0: int = 0):
    """(sum_f, sum_sq), each (B, D, H, W, C) f32: the sums over the V >= 1
    source views in src_feats, and over the reference view when
    `with_ref`, of the exact bilinear warps and of their squares; inputs as
    fused_variance_volume. Differentiable in the features and the
    hypotheses."""
    check_geometry_grad(rel_projs, "the warp")
    if ref_feat.device.type == "cpu":
        return fused_variance_partials_plain(ref_feat, src_feats, rel_projs,
                                             depth_values, with_ref, row0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ref_feat, src_feats, depth_values)):
        return _WarpPartials.apply(ref_feat, src_feats, rel_projs,
                                   depth_values, with_ref, row0)
    return _launch_partials(ref_feat, src_feats, rel_projs, depth_values,
                            with_ref, row0)


fused_variance_partials.launches = 0
fused_variance_partials.vector_launches = 0
