"""Fused warp + group-wise correlation volume (AACVP-MVSNet's cost): wrapper
of the CUDA kernel in ``csrc/group_correlation.cu`` (counterpart of
mvs_tpu.ops.hat_warp's fused mode="group_correlation" and of
mvs_tpu.ops.cost_volume.group_correlation_cost_volume).

``group_correlation_volume`` launches the kernel for CUDA tensors and runs
the plain PyTorch version (``group_correlation_volume_plain``, the exact
gather path of ops.cost_volume) only for CPU tensors; it never falls back
from one to the other. The kernel reads 8 channels as one 16-byte access
when C % 8 == 0 and every feature pointer is 16-byte aligned (the vector
variant); otherwise it runs with masked scalar accesses.

The kernel has no backward yet (it comes with AACVP training): on the card
the wrapper raises if a feature requires a gradient, and on both paths if
the geometry (``rel_projs``, ``depth_values``) does.

Counters: ``group_correlation_volume.launches`` (launches) and
``group_correlation_volume.vector_launches`` (of the vector variant).
"""

from __future__ import annotations

import ctypes

import torch

from mvs_tpu_torch.ops import _build
from mvs_tpu_torch.ops.cost_volume import group_correlation_cost_volume
from mvs_tpu_torch.ops.warp_variance import _check_cuda_inputs, _geometry

__all__ = ["group_correlation_volume", "group_correlation_volume_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "mvs_group_correlation": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                              + [ctypes.c_void_p], ctypes.c_int),
}

group_correlation_volume_plain = group_correlation_cost_volume


def group_correlation_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                             rel_projs: torch.Tensor,
                             depth_values: torch.Tensor,
                             num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume (B, D, H, W, G), exact bilinear.

    ref_feat (B, H, W, C) and src_feats (B, V, H, W, C), f32 or bf16,
    contiguous, C divisible by G = num_groups; rel_projs (B, V, 4, 4) src @
    ref^-1; depth_values (B, D, H, W) f32 contiguous per-pixel hypotheses.
    Output in the features' dtype, sums in f32.
    """
    for name, t in (("rel_projs", rel_projs), ("depth_values", depth_values)):
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the group correlation "
                             "gives no gradient to the geometry; detach it")
    if ref_feat.device.type == "cpu":
        return group_correlation_volume_plain(ref_feat, src_feats, rel_projs,
                                              depth_values, num_groups)
    if torch.is_grad_enabled() and (ref_feat.requires_grad
                                    or src_feats.requires_grad):
        raise NotImplementedError(
            "the group-correlation kernel has no backward yet (it comes with "
            "AACVP training, ROADMAP.md queue 1, item 11)")
    b, nv, d, h, w, c = _check_cuda_inputs(ref_feat, src_feats, rel_projs,
                                           depth_values)
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    geom = _geometry(rel_projs)
    out = torch.empty((b, d, h, w, num_groups), dtype=ref_feat.dtype,
                      device=ref_feat.device)
    vec = c % 8 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (ref_feat, src_feats))
    lib = _build.load("group_correlation", _SIGNATURES)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mvs_group_correlation(
            ref_feat.data_ptr(), src_feats.data_ptr(), geom.data_ptr(),
            depth_values.data_ptr(), out.data_ptr(), b, nv, d, h, w, c,
            num_groups, _DTYPES[ref_feat.dtype], int(vec), stream)
    _build.check(status, "group_correlation")
    group_correlation_volume.launches += 1
    group_correlation_volume.vector_launches += int(vec)
    return out


group_correlation_volume.launches = 0
group_correlation_volume.vector_launches = 0
