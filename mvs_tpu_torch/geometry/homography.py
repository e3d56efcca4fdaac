"""Plane-sweep homography coordinates (counterpart of
mvs_tpu.geometry.homography).

For a reference pixel p = (x, y, 1) and depth d the source pixel is the
perspective division of q = R p d + t, with (R, t) = P_src @ P_ref^{-1}.
Depths are a shared ladder (D,) or per-pixel hypotheses (D, H, W).
"""

from __future__ import annotations

import torch

from mvs_tpu_torch.geometry.sampling import bilinear_sample

__all__ = ["pixel_grid", "plane_sweep_coords", "warp_src_feature"]


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None, row0: int = 0) -> torch.Tensor:
    """Homogeneous pixel coordinates (3, H, W) = [x; y; 1], rows row0 ..
    row0 + H - 1."""
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=0)


def plane_sweep_coords(rel_proj: torch.Tensor, depth_values: torch.Tensor,
                       height: int, width: int, row0: int = 0,
                       rows: int | None = None) -> torch.Tensor:
    """Source-view sampling coords for every (depth, pixel).

    rel_proj (*lead, 4, 4); depth_values (*lead, D) or (*lead, D, H, W).
    Returns (*lead, D, H, W, 2) (x, y). Points with z <= 1e-3 (behind the
    source camera) go to (-2W, -2H), where zero-padded sampling drops them.
    With `rows`, the reference pixels are rows row0 .. row0 + rows - 1 of
    an image of `height` rows (depth_values per pixel then has `rows`).
    """
    lead = rel_proj.shape[:-2]
    nl = len(lead)
    rot = rel_proj[..., :3, :3]
    trans = rel_proj[..., :3, 3]
    grid = pixel_grid(height if rows is None else rows, width,
                      depth_values.dtype, depth_values.device, row0)
    # Same order as the reference: rotate (x term, y term, then the constant
    # column), then multiply-add depth and translation, then divide. Written
    # elementwise so every step rounds once, in the order the CUDA kernel
    # (csrc/warp_variance.cu) rounds it.
    rx, ry, r1 = (rot[..., :, j, None, None] for j in range(3))
    rot_xyz = rx * grid[0] + ry * grid[1] + r1  # (*lead, 3, H, W)
    if depth_values.ndim == nl + 1:
        depth = depth_values[..., None, None]  # (*lead, D, 1, 1)
    else:
        depth = depth_values  # (*lead, D, H, W)
    q = (rot_xyz.unsqueeze(-3) * depth.unsqueeze(-4)
         + trans[..., None, None, None])  # (*lead, 3, D, H, W)
    x, y, z = q.unbind(-4)
    valid = z > 1e-3
    safe_z = torch.where(valid, z, torch.ones_like(z))
    x = torch.where(valid, x / safe_z, torch.full_like(x, -2.0 * width))
    y = torch.where(valid, y / safe_z, torch.full_like(y, -2.0 * height))
    return torch.stack([x, y], dim=-1)


def warp_src_feature(src_feat: torch.Tensor, rel_proj: torch.Tensor,
                     depth_values: torch.Tensor, row0: int = 0,
                     rows: int | None = None) -> torch.Tensor:
    """Warp source features (*lead, H, W, C) over all hypotheses.

    Returns the plane-sweep volume (*lead, D, H, W, C), or with `rows` its
    rows row0 .. row0 + rows - 1."""
    h, w = src_feat.shape[-3:-1]
    coords = plane_sweep_coords(rel_proj, depth_values, h, w, row0, rows)
    return bilinear_sample(src_feat, coords)
