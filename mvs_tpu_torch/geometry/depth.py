"""Cascade depth hypotheses (counterpart of
mvs_tpu.geometry.depth.cascade_depth_samples, with the batch written out)."""

from __future__ import annotations

import torch

__all__ = ["cascade_depth_samples"]


def cascade_depth_samples(cur_depth: torch.Tensor, ndepth: int,
                          depth_interval: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """Per-pixel hypothesis windows for a cascade stage, (B, ndepth, H, W).

    cur_depth: (B, D0) global ladder (only its first and last entries are
    used: `ndepth` even steps across the range) or (B, H, W) previous-stage
    depth at this stage's resolution (window [d - n/2*i, d + n/2*i] of
    `ndepth` steps). depth_interval: (B,) spacing for the windowed case.
    """
    steps = torch.arange(ndepth, dtype=torch.float32, device=cur_depth.device)
    if cur_depth.ndim == 2:
        dmin = cur_depth[:, :1]
        dmax = cur_depth[:, -1:]
        ladder = dmin + steps * ((dmax - dmin) / (ndepth - 1))  # (B, n)
        return ladder[:, :, None, None].expand(-1, -1, height, width)
    iv = depth_interval[:, None, None]
    lo = cur_depth - (ndepth / 2.0) * iv
    hi = cur_depth + (ndepth / 2.0) * iv
    interval = (hi - lo) / (ndepth - 1)
    return lo[:, None] + steps[None, :, None, None] * interval[:, None]
