"""Depth and error colour maps (counterpart of mvs_tpu.utils.vis), numpy
only: a turbo-like colour map of depth, a clipped absolute-error heat map,
a depth map saved as PNG through io.png, and the est | gt | error panel
that training logs for its first validation batch. The uint8 arrays are
mvs_tpu's."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mvs_tpu_torch.io.png import write_png

__all__ = ["colorize_depth", "colorize_error", "save_depth_png",
           "depth_image_summary"]


def _turbo(x: np.ndarray) -> np.ndarray:
    """Polynomial fit of the turbo colour map: x in [0, 1] -> (..., 3)
    uint8."""
    r = 0.1357 + x * (4.5974 - x * (42.3277 - x * (130.5887 - x * (150.5666 - x * 58.1375))))
    g = 0.0914 + x * (2.1856 + x * (4.8052 - x * (14.0195 - x * (4.2109 + x * 2.7747))))
    b = 0.1067 + x * (12.5925 - x * (60.1097 - x * (109.0745 - x * (88.5066 - x * 26.8183))))
    rgb = np.stack([r, g, b], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def colorize_depth(depth: np.ndarray, mask: np.ndarray | None = None,
                   d_min: float | None = None,
                   d_max: float | None = None) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8; pixels outside the mask (or of
    depth <= 0 without one) are black. The range defaults to the valid
    depths'."""
    depth = np.asarray(depth, np.float32)
    valid = (depth > 0) if mask is None else (np.asarray(mask) > 0.5)
    if d_min is None:
        d_min = float(depth[valid].min()) if valid.any() else 0.0
    if d_max is None:
        d_max = float(depth[valid].max()) if valid.any() else 1.0
    x = np.clip((depth - d_min) / max(d_max - d_min, 1e-6), 0, 1)
    img = _turbo(x)
    img[~valid] = 0
    return img


def colorize_error(depth_est: np.ndarray, depth_gt: np.ndarray,
                   mask: np.ndarray | None = None,
                   max_err: float = 8.0) -> np.ndarray:
    """|est - gt| clipped at max_err, as (H, W, 3) uint8; invalid pixels
    black."""
    err = np.abs(np.asarray(depth_est) - np.asarray(depth_gt))
    valid = (np.asarray(depth_gt) > 0) if mask is None \
        else (np.asarray(mask) > 0.5)
    img = _turbo(np.clip(err / max_err, 0, 1))
    img[~valid] = 0
    return img


def save_depth_png(path, depth: np.ndarray, **kwargs) -> None:
    """colorize_depth(depth, **kwargs) written as an RGB PNG."""
    write_png(Path(path), colorize_depth(depth, **kwargs))


def depth_image_summary(depth_est, depth_gt, mask) -> np.ndarray:
    """est | gt | error side by side, (H, 3W, 3) uint8, est and gt on the
    GT's range under the mask."""
    inside = np.asarray(depth_gt)[np.asarray(mask) > 0.5]
    d_min, d_max = float(inside.min()), float(inside.max())
    return np.concatenate([
        colorize_depth(depth_est, mask, d_min, d_max),
        colorize_depth(depth_gt, mask, d_min, d_max),
        colorize_error(depth_est, depth_gt, mask),
    ], axis=1)
