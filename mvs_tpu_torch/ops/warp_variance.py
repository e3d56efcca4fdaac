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

When the features require a gradient, the CUDA path is an autograd Function
that saves only its inputs (as the JAX model's jax.checkpoint does) and
whose backward is the backward kernel (``fused_variance_volume_grad``); on
the CPU autograd runs through the plain version. The kernel gives no
gradient to the geometry: both paths raise if ``rel_projs`` or
``depth_values`` requires one (the JAX model detaches the depth between
stages).

Counters: ``fused_variance_volume.launches`` (forward launches),
``fused_variance_volume.vector_launches`` (of the vector variant) and
``fused_variance_volume_grad.launches`` (backward launches).
"""

from __future__ import annotations

import ctypes

import torch

from mvs_tpu_torch.ops import _build
from mvs_tpu_torch.ops.cost_volume import variance_cost_volume

__all__ = ["fused_variance_volume", "fused_variance_volume_plain",
           "fused_variance_volume_grad", "fused_variance_volume_grad_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "mvs_warp_variance": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p], ctypes.c_int),
    "mvs_warp_variance_grad": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                               + [ctypes.c_void_p], ctypes.c_int),
}

fused_variance_volume_plain = variance_cost_volume


def fused_variance_volume_grad_plain(grad, ref_feat, src_feats, rel_projs,
                                     depth_values):
    """(dref, dsrc) by autograd through the plain version."""
    with torch.enable_grad():
        ref = ref_feat.detach().requires_grad_()
        src = src_feats.detach().requires_grad_()
        out = fused_variance_volume_plain(ref, src, rel_projs, depth_values)
        return torch.autograd.grad(out, (ref, src), grad)


def _check_cuda_inputs(ref_feat, src_feats, rel_projs, depth_values):
    """Raise on what the kernels do not take; return (B, V, D, H, W, C)."""
    if ref_feat.device.type != "cuda":
        raise ValueError(f"unsupported device {ref_feat.device}")
    b, h, w, c = ref_feat.shape
    if src_feats.ndim != 5 or src_feats.shape[0] != b or \
            src_feats.shape[2:] != ref_feat.shape[1:]:
        raise ValueError(f"src_feats {tuple(src_feats.shape)} does not match "
                         f"ref_feat {tuple(ref_feat.shape)}")
    nv = src_feats.shape[1]
    if rel_projs.shape != (b, nv, 4, 4):
        raise ValueError(f"rel_projs {tuple(rel_projs.shape)}, want "
                         f"{(b, nv, 4, 4)}")
    if depth_values.ndim != 4 or depth_values.shape[0] != b or \
            depth_values.shape[2:] != (h, w):
        raise ValueError(f"depth_values {tuple(depth_values.shape)}, want "
                         f"(B, D, {h}, {w})")
    if ref_feat.dtype not in _DTYPES or src_feats.dtype != ref_feat.dtype:
        raise TypeError(f"features must share dtype float32 or bfloat16, got "
                        f"{ref_feat.dtype} and {src_feats.dtype}")
    if depth_values.dtype != torch.float32:
        raise TypeError(f"depth_values must be float32, got "
                        f"{depth_values.dtype}")
    for name, t in (("ref_feat", ref_feat), ("src_feats", src_feats),
                    ("depth_values", depth_values), ("rel_projs", rel_projs)):
        if t.device != ref_feat.device:
            raise ValueError(f"{name} on {t.device}, ref_feat on "
                             f"{ref_feat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, nv, depth_values.shape[1], h, w, c


def _geometry(rel_projs):
    """(B, V, 12) f32: rows of R, then t, of src @ ref^-1."""
    b, nv = rel_projs.shape[:2]
    return torch.cat([rel_projs[..., :3, :3].reshape(b, nv, 9),
                      rel_projs[..., :3, 3]], dim=-1).float().contiguous()


def _launch_forward(ref_feat, src_feats, rel_projs, depth_values):
    b, nv, d, h, w, c = _check_cuda_inputs(ref_feat, src_feats, rel_projs,
                                           depth_values)
    geom = _geometry(rel_projs)
    out = torch.empty((b, d, h, w, c), dtype=ref_feat.dtype,
                      device=ref_feat.device)
    vec = c % 8 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (ref_feat, src_feats, out))
    lib = _build.load("warp_variance", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_warp_variance(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), out.data_ptr(), b, nv, d, h, w, c,
            _DTYPES[ref_feat.dtype], int(vec), stream)
    _build.check(status, "warp_variance")
    fused_variance_volume.launches += 1
    fused_variance_volume.vector_launches += int(vec)
    return out


def fused_variance_volume_grad(grad, ref_feat, src_feats, rel_projs,
                               depth_values):
    """(dref (B, H, W, C), dsrc (B, V, H, W, C)) in the features' dtype,
    given grad = dL/dvar (B, D, H, W, C) and the forward's inputs.

    Launches the backward kernel for CUDA tensors (sums in f32, dsrc
    scattered into an f32 buffer and cast once); CPU tensors run autograd
    through the plain version.
    """
    if ref_feat.device.type == "cpu":
        return fused_variance_volume_grad_plain(grad, ref_feat, src_feats,
                                                rel_projs, depth_values)
    b, nv, d, h, w, c = _check_cuda_inputs(ref_feat, src_feats, rel_projs,
                                           depth_values)
    grad = grad.contiguous()
    if grad.shape != (b, d, h, w, c) or grad.dtype != ref_feat.dtype or \
            grad.device != ref_feat.device:
        raise ValueError(f"grad {tuple(grad.shape)} {grad.dtype} on "
                         f"{grad.device}, want {(b, d, h, w, c)} "
                         f"{ref_feat.dtype} on {ref_feat.device}")
    geom = _geometry(rel_projs)
    dref = torch.empty_like(ref_feat)
    dsrc = torch.zeros(src_feats.shape, dtype=torch.float32,
                       device=src_feats.device)
    vec = c % 8 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (ref_feat, src_feats, grad, dref))
    lib = _build.load("warp_variance", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_warp_variance_grad(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), grad.data_ptr(), dref.data_ptr(),
            dsrc.data_ptr(), b, nv, d, h, w, c, _DTYPES[ref_feat.dtype],
            int(vec), stream)
    _build.check(status, "warp_variance_grad")
    fused_variance_volume_grad.launches += 1
    return dref, dsrc.to(src_feats.dtype)


fused_variance_volume_grad.launches = 0


class _WarpVariance(torch.autograd.Function):
    """The forward kernel, saving only its inputs; the backward kernel."""

    @staticmethod
    def forward(ctx, ref_feat, src_feats, rel_projs, depth_values):
        ctx.save_for_backward(ref_feat, src_feats, rel_projs, depth_values)
        return _launch_forward(ref_feat, src_feats, rel_projs, depth_values)

    @staticmethod
    def backward(ctx, grad):
        dref, dsrc = fused_variance_volume_grad(grad, *ctx.saved_tensors)
        return dref, dsrc, None, None


def fused_variance_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                          rel_projs: torch.Tensor,
                          depth_values: torch.Tensor) -> torch.Tensor:
    """Variance volume (B, D, H, W, C) over ref + V views, exact bilinear.

    ref_feat (B, H, W, C) and src_feats (B, V, H, W, C), f32 or bf16,
    contiguous; rel_projs (B, V, 4, 4) src @ ref^-1; depth_values
    (B, D, H, W) f32 contiguous per-pixel hypotheses. Output in the
    features' dtype; differentiable in the features.
    """
    for name, t in (("rel_projs", rel_projs), ("depth_values", depth_values)):
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the warp gives no "
                             "gradient to the geometry; detach it")
    if ref_feat.device.type == "cpu":
        return fused_variance_volume_plain(ref_feat, src_feats, rel_projs,
                                           depth_values)
    if torch.is_grad_enabled() and (ref_feat.requires_grad
                                    or src_feats.requires_grad):
        return _WarpVariance.apply(ref_feat, src_feats, rel_projs,
                                   depth_values)
    return _launch_forward(ref_feat, src_feats, rel_projs, depth_values)


fused_variance_volume.launches = 0
fused_variance_volume.vector_launches = 0
