"""Plane-sweep cost volumes, exact 'gather' sampler (counterpart of
mvs_tpu.ops.cost_volume with sampler='gather', batch written out).

These are the plain PyTorch forms of the fused kernels: the variance over
ref + V views and its additive partial sums (ops.warp_variance), and
AACVP's group-wise correlation (ops.group_correlation). Each materializes one warped volume per source
view. Sums are taken in f32 whatever the input dtype, as the kernels (and
the TPU kernel) do; the JAX gather path sums in the input dtype, which only
differs in bf16.
"""

from __future__ import annotations

import torch

from mvs_tpu_torch.geometry.homography import warp_src_feature

__all__ = ["variance_cost_volume", "variance_partials",
           "variance_from_partials", "group_correlation_cost_volume"]


def variance_cost_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                         rel_projs: torch.Tensor, depth_values: torch.Tensor,
                         row0: int = 0) -> torch.Tensor:
    """(B, D, H, W, C) variance over ref + V source views.

    ref_feat (B, H, W, C); src_feats (B, V, H, W, C); rel_projs (B, V, 4, 4)
    src @ ref^-1; depth_values (B, D) shared ladder or (B, D, H, W).
    Returns the volume in ref_feat's dtype. With `row0`, ref_feat (and
    per-pixel depth_values) hold rows row0 .. row0 + H - 1 of source views
    with more rows, and the volume those rows.
    """
    b, h, w, c = ref_feat.shape
    d = depth_values.shape[1]
    num_views = src_feats.shape[1] + 1
    sum_f = ref_feat.float()[:, None].expand(b, d, h, w, c)
    sum_sq = sum_f * sum_f
    for v in range(num_views - 1):
        warped = warp_src_feature(src_feats[:, v].float(), rel_projs[:, v],
                                  depth_values, row0=row0, rows=h)
        sum_f = sum_f + warped
        sum_sq = sum_sq + warped * warped
    return variance_from_partials(sum_f, sum_sq, num_views).to(ref_feat.dtype)


def variance_partials(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                      rel_projs: torch.Tensor, depth_values: torch.Tensor,
                      with_ref: bool = True, row0: int = 0):
    """(sum_f, sum_sq), each (B, D, H, W, C) f32: the sums of the warped
    source views' features and of their squares, with the reference view a
    term when `with_ref`; inputs as variance_cost_volume. The sums are
    additive over views, so a view shard's partials are summed over the
    shards before variance_from_partials (parallel.collectives)."""
    b, h, w, c = ref_feat.shape
    d = depth_values.shape[1]
    sum_f = ref_feat.new_zeros((b, d, h, w, c), dtype=torch.float32)
    if with_ref:
        sum_f = sum_f + ref_feat.float()[:, None]
    sum_sq = sum_f * sum_f
    for v in range(src_feats.shape[1]):
        warped = warp_src_feature(src_feats[:, v].float(), rel_projs[:, v],
                                  depth_values, row0=row0, rows=h)
        sum_f = sum_f + warped
        sum_sq = sum_sq + warped * warped
    return sum_f, sum_sq


def variance_from_partials(sum_f: torch.Tensor, sum_sq: torch.Tensor,
                           num_views) -> torch.Tensor:
    """variance = E[f^2] - E[f]^2 given additive partial sums."""
    mean = sum_f / num_views
    return sum_sq / num_views - mean * mean


def group_correlation_cost_volume(ref_feat: torch.Tensor,
                                  src_feats: torch.Tensor,
                                  rel_projs: torch.Tensor,
                                  depth_values: torch.Tensor,
                                  num_groups: int) -> torch.Tensor:
    """(B, D, H, W, G) group-wise correlation, G = num_groups.

    For each group g of C / G channels: the mean over the group's channels
    of warped_v * ref, averaged over the V source views (the reference view
    is not a term). Inputs as variance_cost_volume; C must divide by G.
    Sums in f32; the result in ref_feat's dtype.
    """
    b, h, w, c = ref_feat.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    d = depth_values.shape[1]
    num_src = src_feats.shape[1]
    ref_g = ref_feat.float().reshape(b, 1, h, w, num_groups, c // num_groups)
    corr = ref_feat.new_zeros((b, d, h, w, num_groups), dtype=torch.float32)
    for v in range(num_src):
        warped = warp_src_feature(src_feats[:, v].float(), rel_projs[:, v],
                                  depth_values)
        warped = warped.reshape(b, d, h, w, num_groups, c // num_groups)
        corr = corr + torch.mean(warped * ref_g, dim=-1)
    return (corr / num_src).to(ref_feat.dtype)
