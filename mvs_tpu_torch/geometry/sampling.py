"""Bilinear sampling in pixel coordinates (counterpart of
mvs_tpu.geometry.sampling).

Features are channels-last (..., H, W, C); a sample gathers whole C-vectors
at its four corners. Out-of-image corners contribute zero, each on its own,
so a sample half in the image keeps the weight of its valid corners
(grid_sample(padding_mode='zeros', align_corners=True) semantics).
"""

from __future__ import annotations

import torch

__all__ = ["bilinear_sample"]


def bilinear_sample(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample `feat` (*lead, H, W, C) at `coords` (*lead, ..., 2) = (x, y).

    Returns (*lead, ..., C) in feat's dtype; `lead` batch dims are shared by
    both arguments.
    """
    *lead, h, w, c = feat.shape
    nb = 1
    for n in lead:
        nb *= n
    pts = coords.shape[len(lead):-1]
    xy = coords.reshape(nb, -1, 2)
    x = xy[..., 0]
    y = xy[..., 1]

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(feat.dtype)[..., None]
    wy = (y - y0).to(feat.dtype)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat_feat = feat.reshape(nb * h * w, c)
    base = (torch.arange(nb, device=feat.device) * (h * w))[:, None]

    def corner(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat_feat[idx.reshape(-1)].reshape(nb, -1, c)
        return vals * valid[..., None].to(feat.dtype)

    v00 = corner(y0i, x0i)
    v01 = corner(y0i, x0i + 1)
    v10 = corner(y0i + 1, x0i)
    v11 = corner(y0i + 1, x0i + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    out = top * (1.0 - wy) + bot * wy
    return out.reshape(*lead, *pts, c)
