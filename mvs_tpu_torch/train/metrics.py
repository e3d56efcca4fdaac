"""Depth-map quality metrics (counterpart of mvs_tpu.train.metrics): the
masked absolute depth error, the outlier rates at 2 / 4 / 8 mm, and
Point-MVSNet's shares of pixels within 1x / 3x the hypothesis interval.
Metrics take no gradient. Each is a masked mean (train.losses.masked_mean):
under a data-parallel mesh, this rank's share of the global batch's.
"""

from __future__ import annotations

import torch

from mvs_tpu_torch.train.losses import masked_mean

__all__ = ["abs_depth_error", "threshold_error_rate", "interval_metrics",
           "standard_metrics"]


@torch.no_grad()
def abs_depth_error(depth_est, depth_gt, mask):
    """Mean |est - gt| over valid pixels."""
    return masked_mean((depth_est - depth_gt).abs(), mask > 0.5)


@torch.no_grad()
def threshold_error_rate(depth_est, depth_gt, mask, thresh):
    """Share of valid pixels with |est - gt| > thresh (mm)."""
    err = (depth_est - depth_gt).abs()
    return masked_mean((err > thresh).float(), mask > 0.5)


@torch.no_grad()
def interval_metrics(depth_est, depth_gt, mask, depth_interval,
                     prefix: str = "") -> dict:
    """Shares of valid pixels with |est - gt| under 1x and 3x the
    per-sample hypothesis interval depth_interval (B,)."""
    err = (depth_est - depth_gt).abs()
    iv = depth_interval.reshape((-1,) + (1,) * (err.ndim - 1))
    valid = mask > 0.5
    return {f"{prefix}lt1_interval": masked_mean((err < iv).float(), valid),
            f"{prefix}lt3_interval": masked_mean((err < 3 * iv).float(),
                                                 valid)}


def standard_metrics(depth_est, depth_gt, mask, prefix: str = "") -> dict:
    """The validation metric dict: abs error and the 2 / 4 / 8 mm rates."""
    return {
        f"{prefix}abs_depth_error": abs_depth_error(depth_est, depth_gt, mask),
        **{f"{prefix}thres{t}mm_error": threshold_error_rate(
            depth_est, depth_gt, mask, float(t)) for t in (2, 4, 8)},
    }
