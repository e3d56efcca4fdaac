"""Depth-map fusion into a point cloud (counterpart of mvs_tpu.fusion.fuse).

For each reference view:
  * photometric mask: confidence > conf_thresh;
  * geometric mask: the pixel is consistent (geometry.consistency) with at
    least num_consistent of its source views;
  * fused depth: the mean of the ref depth and every consistent round-trip
    depth;
  * accepted pixels are unprojected to world points (with the ref colour).

Whole-scene fusion runs on the card, one reference view at a time over an
(S, H, W) stack of its sources: the JAX package's lax.map over refs of a
vmap over sources, so peak memory stays at one ref view's stack. Masks and
points of every view stay on the device until one readback per scene; only
the variable-size compaction of accepted points runs on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mvs_tpu_torch.geometry.consistency import geometric_consistency
from mvs_tpu_torch.geometry.homography import pixel_grid
from mvs_tpu_torch.geometry.projection import invert_rigid
from mvs_tpu_torch.utils.platform import resolve_device

__all__ = ["FusionConfig", "pad_pairs", "fuse_scene", "fuse_view",
           "fuse_depth_maps", "compact_points"]


@dataclasses.dataclass
class FusionConfig:
    """Fusion thresholds.

    depth_mode 'relative': the round-trip depth lies within depth_thresh of
    the ref depth as a fraction of it (the reference python fuser);
    'absolute': within depth_thresh distance units (fusibile's disp_thresh
    semantics).
    """

    conf_thresh: float = 0.8
    num_consistent: int = 3
    pixel_thresh: float = 1.0
    depth_thresh: float = 0.01
    depth_mode: str = "relative"

    def __post_init__(self):
        if self.depth_mode not in ("relative", "absolute"):
            raise ValueError(f"depth_mode {self.depth_mode!r}: want "
                             "'relative' or 'absolute'")


def pad_pairs(pairs, num_views: int):
    """Pair list -> fixed (V, S) src-index matrix + {0,1} validity mask, S
    the longest source list (at least 1)."""
    max_s = max((len(s) for _, s in pairs), default=1) or 1
    src_idx = np.zeros((num_views, max_s), np.int32)
    src_valid = np.zeros((num_views, max_s), np.float32)
    for ref_view, src_views in pairs:
        k = len(src_views)
        src_idx[ref_view, :k] = src_views
        src_valid[ref_view, :k] = 1.0
    return src_idx, src_valid


def _unproject_view(depth, intr, extr):
    """(H, W) depth -> (H*W, 3) world points."""
    h, w = depth.shape
    pix = pixel_grid(h, w, depth.dtype, depth.device).reshape(3, -1)
    cam = torch.linalg.inv(intr) @ (pix * depth.reshape(1, -1))
    cam_h = torch.cat([cam, torch.ones_like(cam[:1])], dim=0)
    return (invert_rigid(extr) @ cam_h)[:3].T


def _consistency(ref, srcs, depths, intrinsics, extrinsics, config):
    """(masks (S, H, W) bool, round-trip depths (S, H, W)) of view `ref`
    against the views `srcs` (S,) of the device stacks."""
    return geometric_consistency(
        depths[ref], intrinsics[ref], extrinsics[ref], depths[srcs],
        intrinsics[srcs], extrinsics[srcs], pixel_thresh=config.pixel_thresh,
        depth_thresh=config.depth_thresh, depth_mode=config.depth_mode)


def _to_device(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


@torch.inference_mode()
def fuse_scene(depths, confs, intrinsics, extrinsics, pairs,
               config: FusionConfig | None = None, device=None):
    """Whole-scene fusion masks and world points on `device` (the CUDA card
    unless the caller names another), one readback at the end.

    depths, confs (V, H, W); intrinsics (V, 3, 3); extrinsics (V, 4, 4);
    pairs [(ref_view, [src_view, ...]), ...]. Returns numpy (mask (V, H, W)
    bool, world (V, H, W, 3) float32). Views absent from `pairs`, or with no
    sources, have no consistent source, so they pass only if
    num_consistent <= 0.
    """
    config = config or FusionConfig()
    device = resolve_device(device)
    src_idx, src_valid = pad_pairs(pairs, len(depths))
    depths = _to_device(depths, device)
    confs = _to_device(confs, device)
    intrinsics = _to_device(intrinsics, device)
    extrinsics = _to_device(extrinsics, device)
    src_idx = _to_device(src_idx, device, torch.long)
    src_valid = _to_device(src_valid, device)
    v, h, w = depths.shape
    mask = torch.empty((v, h, w), dtype=torch.bool, device=device)
    world = torch.empty((v, h, w, 3), dtype=torch.float32, device=device)
    for ref in range(v):
        rd = depths[ref]
        masks, depths_rt = _consistency(ref, src_idx[ref], depths,
                                        intrinsics, extrinsics, config)
        valid = src_valid[ref][:, None, None]
        geo_count = (masks.to(depths.dtype) * valid).sum(dim=0)
        depth_sum = (depths_rt * valid).sum(dim=0)
        avg_depth = (depth_sum + rd) / (geo_count + 1)
        mask[ref] = ((geo_count >= config.num_consistent)
                     & (confs[ref] > config.conf_thresh) & (rd > 0))
        world[ref] = _unproject_view(avg_depth, intrinsics[ref],
                                     extrinsics[ref]).reshape(h, w, 3)
    return mask.cpu().numpy(), world.cpu().numpy()


@torch.inference_mode()
def fuse_view(ref_idx: int, src_idxs, depths, confs, intrinsics, extrinsics,
              config: FusionConfig, device=None):
    """Fuse one reference view. Returns (xyz (M, 3), mask (H, W) bool) on
    the host."""
    device = resolve_device(device)
    srcs = _to_device(np.asarray(src_idxs, np.int64), device, torch.long)
    d = _to_device(depths, device)
    k = _to_device(intrinsics, device)
    e = _to_device(extrinsics, device)
    masks, depths_rt = _consistency(ref_idx, srcs, d, k, e, config)
    geo_count = masks.sum(dim=0).cpu().numpy()
    depth_sum = depths_rt.sum(dim=0).cpu().numpy()
    ref_depth = np.asarray(depths[ref_idx])
    mask = ((geo_count >= config.num_consistent)
            & (np.asarray(confs[ref_idx]) > config.conf_thresh)
            & (ref_depth > 0))
    avg_depth = (depth_sum + ref_depth) / (geo_count + 1)
    world = _unproject_view(_to_device(avg_depth, device), k[ref_idx],
                            e[ref_idx]).cpu().numpy()
    return world.reshape(*mask.shape, 3)[mask], mask


def compact_points(mask, world, images, pairs):
    """Accepted points of every ref view that has sources, in pair order:
    (xyz (N, 3) float32, rgb (N, 3) uint8 or None)."""
    all_xyz, all_rgb = [], []
    for ref_view, src_views in pairs:
        if not src_views:
            continue
        m = mask[ref_view]
        all_xyz.append(world[ref_view][m])
        if images is not None:
            img = np.asarray(images[ref_view])
            all_rgb.append((np.clip(img[m], 0, 1) * 255).astype(np.uint8))
    xyz = (np.concatenate(all_xyz, axis=0) if all_xyz
           else np.zeros((0, 3), np.float32))
    rgb = np.concatenate(all_rgb, axis=0) if all_rgb else None
    return xyz.astype(np.float32), rgb


def fuse_depth_maps(depths, confs, images, intrinsics, extrinsics, pairs,
                    config: FusionConfig | None = None, device=None):
    """Fuse a whole scene.

    depths (V, H, W) float32; confs (V, H, W); images (V, H, W, 3) in [0, 1]
    or None; intrinsics (V, 3, 3); extrinsics (V, 4, 4); pairs as
    io.read_pair_file returns them. Returns (xyz (N, 3) float32, rgb (N, 3)
    uint8 or None).
    """
    mask, world = fuse_scene(depths, confs, intrinsics, extrinsics, pairs,
                             config, device)
    return compact_points(mask, world, images, pairs)
