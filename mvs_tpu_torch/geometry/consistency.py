"""Cross-view geometric consistency, the core of depth-map fusion
(counterpart of mvs_tpu.geometry.consistency).

For every ref pixel with depth d: unproject to 3D, project into a source
view, read the source's depth there, unproject that and project back into
the reference. The pixel is consistent with the source if the round trip
lands within `pixel_thresh` pixels and its depth within `depth_thresh`
(relative or absolute) of d.

The source side may carry leading batch dims (S sources of one ref view at
once); the ref side is one view and broadcasts against them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvs_tpu_torch.geometry.homography import pixel_grid
from mvs_tpu_torch.geometry.projection import invert_rigid
from mvs_tpu_torch.geometry.sampling import bilinear_sample

__all__ = ["ReprojectionResult", "reproject_with_depth",
           "geometric_consistency"]


class ReprojectionResult(NamedTuple):
    depth_reprojected: torch.Tensor  # (..., H, W) ref depth after round trip
    coords_reprojected: torch.Tensor  # (..., H, W, 2) ref pixel after it
    coords_src: torch.Tensor  # (..., H, W, 2) where each ref pixel lands


def _unproject(depth, intrinsics, extrinsics, pix):
    """Pixels (..., 3, N) at depths (..., N) -> world points (..., 3, N)."""
    cam = torch.linalg.inv(intrinsics) @ (pix * depth[..., None, :])
    cam_h = torch.cat([cam, torch.ones_like(cam[..., :1, :])], dim=-2)
    return (invert_rigid(extrinsics) @ cam_h)[..., :3, :]


def _project(world, intrinsics, extrinsics):
    """World points (..., 3, N) -> (pixels (..., 2, N), camera z (..., N)).

    |z| <= 1e-6 is replaced by +1e-6, so a tiny negative z turns positive,
    as in the reference."""
    world_h = torch.cat([world, torch.ones_like(world[..., :1, :])], dim=-2)
    cam = (extrinsics @ world_h)[..., :3, :]
    img = intrinsics @ cam
    z = img[..., 2:3, :]
    safe_z = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    return img[..., :2, :] / safe_z, cam[..., 2, :]


def reproject_with_depth(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                         extr_src) -> ReprojectionResult:
    """depth_ref (H, W), intr_ref (3, 3), extr_ref (4, 4); depth_src
    (*S, H, W), intr_src (*S, 3, 3), extr_src (*S, 4, 4)."""
    h, w = depth_ref.shape
    lead = depth_src.shape[:-2]
    pix = pixel_grid(h, w, depth_ref.dtype, depth_ref.device).reshape(3, -1)

    world = _unproject(depth_ref.reshape(-1), intr_ref, extr_ref, pix)
    src_xy, _ = _project(world, intr_src, extr_src)  # (*S, 2, N)
    coords_src = src_xy.transpose(-1, -2).reshape(*lead, h, w, 2)

    # The source's depth where the ref pixel landed, zero-padded bilinear.
    sampled = bilinear_sample(depth_src[..., None], coords_src)[..., 0]

    src_pix = torch.cat([src_xy, torch.ones_like(src_xy[..., :1, :])], dim=-2)
    world_rt = _unproject(sampled.reshape(*lead, -1), intr_src, extr_src,
                          src_pix)
    ref_xy, ref_z = _project(world_rt, intr_ref, extr_ref)
    return ReprojectionResult(
        depth_reprojected=ref_z.reshape(*lead, h, w),
        coords_reprojected=ref_xy.transpose(-1, -2).reshape(*lead, h, w, 2),
        coords_src=coords_src,
    )


def geometric_consistency(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                          extr_src, pixel_thresh: float = 1.0,
                          depth_thresh: float = 0.01,
                          depth_mode: str = "relative"):
    """Returns (mask (*S, H, W) bool, round-trip depth zeroed where
    inconsistent).

    depth_mode 'relative': |dd| / max(d_ref, 1e-6) < depth_thresh;
    'absolute': |dd| < depth_thresh.
    """
    h, w = depth_ref.shape
    res = reproject_with_depth(depth_ref, intr_ref, extr_ref, depth_src,
                               intr_src, extr_src)
    grid = pixel_grid(h, w, depth_ref.dtype, depth_ref.device)[:2]
    dist = torch.linalg.norm(res.coords_reprojected - grid.permute(1, 2, 0),
                             dim=-1)
    depth_err = (res.depth_reprojected - depth_ref).abs()
    if depth_mode == "relative":
        depth_err = depth_err / depth_ref.clamp_min(1e-6)
    mask = (dist < pixel_thresh) & (depth_err < depth_thresh) & (depth_ref > 0)
    return mask, torch.where(mask, res.depth_reprojected,
                             torch.zeros_like(res.depth_reprojected))
