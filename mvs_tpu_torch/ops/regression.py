"""Soft-argmin depth regression and photometric confidence (counterpart of
mvs_tpu.ops.regression, batch written out).

depth = sum_d p(d) * depth(d); confidence = the probability mass over the
4-tap window {i-1, i, i+1, i+2} around i = the truncated regressed index.
Confidence takes no gradient (the JAX package stops it at prob).
"""

from __future__ import annotations

import torch

__all__ = ["depth_regression", "photometric_confidence",
           "regress_depth_and_confidence"]


def depth_regression(prob: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """Expected depth under prob (B, D, H, W); depth_values (B, D) or
    (B, D, H, W) -> (B, H, W)."""
    if depth_values.ndim == 2:
        depth_values = depth_values[:, :, None, None]
    return torch.sum(prob * depth_values, dim=1)


def photometric_confidence(prob: torch.Tensor,
                           depth_index: torch.Tensor) -> torch.Tensor:
    """4-tap sum of prob (B, D, H, W) around the float index (B, H, W)."""
    d = prob.shape[1]
    idx = depth_index.clamp(0, d - 1).to(torch.int64)[:, None]
    iota = torch.arange(d, device=prob.device)[None, :, None, None]
    window = (iota >= idx - 1) & (iota <= idx + 2)
    return torch.sum(prob * window.to(prob.dtype), dim=1)


def regress_depth_and_confidence(cost: torch.Tensor,
                                 depth_values: torch.Tensor):
    """softmax(cost over D) -> (depth (B,H,W), confidence (B,H,W),
    prob (B,D,H,W)). `cost` is the score volume (B, D, H, W), higher = more
    likely."""
    prob = torch.softmax(cost, dim=1)
    depth = depth_regression(prob, depth_values)
    steps = torch.arange(cost.shape[1], dtype=prob.dtype,
                         device=prob.device)[None].expand(cost.shape[0], -1)
    fixed = prob.detach()
    conf = photometric_confidence(fixed, depth_regression(fixed, steps))
    return depth, conf, prob
