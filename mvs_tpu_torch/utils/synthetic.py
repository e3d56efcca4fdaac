"""Synthetic multi-view scenes with analytic ground truth.

A textured plane z = z0 (world frame == reference camera frame) imaged by a
rig of pinhole cameras. Every quantity (images, per-view depth maps) is
computed in closed form, giving exact fixtures for warp / cost-volume /
regression / consistency / fusion tests — the test strategy the reference
implies but never automated (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticScene", "make_plane_scene", "texture"]


def texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth, non-periodic-ish texture over world coords; range ~[0, 1]."""
    return (
        0.5
        + 0.25 * np.sin(0.9 * x + 0.3 * y)
        + 0.15 * np.cos(1.7 * y - 0.5 * x)
        + 0.10 * np.sin(0.37 * x * y)
    )


@dataclasses.dataclass
class SyntheticScene:
    images: np.ndarray  # (V, H, W, 3) float32 in [0, 1]
    depths: np.ndarray  # (V, H, W) float32 ground-truth depth per view
    intrinsics: np.ndarray  # (V, 3, 3)
    extrinsics: np.ndarray  # (V, 4, 4) world-to-camera
    depth_min: float
    depth_max: float

    @property
    def projections(self) -> np.ndarray:
        """(V, 4, 4) packed K@E projections."""
        proj = self.extrinsics.copy()
        proj[:, :3, :4] = self.intrinsics @ self.extrinsics[:, :3, :4]
        return proj


def _camera_rig(num_views, height, width, baseline, focal, jitter_angle, seed):
    rng = np.random.default_rng(seed)
    k = np.array(
        [[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1.0]], dtype=np.float64
    )
    intrinsics = np.stack([k] * num_views).astype(np.float64)
    extrinsics = np.stack([np.eye(4)] * num_views).astype(np.float64)
    for v in range(1, num_views):
        # Camera center at x = ±baseline steps; small rotation about y.
        cx = baseline * ((v + 1) // 2) * (1 if v % 2 == 1 else -1)
        ang = jitter_angle * rng.standard_normal()
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        center = np.array([cx, 0.0, 0.0])
        extrinsics[v, :3, :3] = r
        extrinsics[v, :3, 3] = -r @ center
    return intrinsics, extrinsics


def _render_planes(intrinsics, extrinsics, height, width, planes):
    """Render a scene of planes z = z0 + tx·x + ty·y, each valid over a world-x
    interval [x_lo, x_hi). `planes` is a list of (z0, tx, ty, x_lo, x_hi).
    Per ray, the nearest valid intersection wins (correct occlusion for step
    scenes seen from off-axis cameras). Returns (images, depths)."""
    num_views = len(intrinsics)
    images = np.zeros((num_views, height, width, 3), dtype=np.float32)
    depths = np.zeros((num_views, height, width), dtype=np.float32)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1).astype(np.float64)

    for v in range(num_views):
        r = extrinsics[v][:3, :3]
        t = extrinsics[v][:3, 3]
        center = -r.T @ t
        dirs = r.T @ (np.linalg.inv(intrinsics[v]) @ pix)  # (3, N) world rays
        best_s = np.full(pix.shape[1], np.inf)
        best_world = np.zeros((3, pix.shape[1]))
        for z0, tx, ty, x_lo, x_hi in planes:
            # Plane n·p = z0 with n = (-tx, -ty, 1):  z - tx·x - ty·y = z0.
            n = np.array([-tx, -ty, 1.0])
            denom = n @ dirs
            s = (z0 - n @ center) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            hit = center[:, None] + s[None] * dirs
            ok = (s > 0) & (hit[0] >= x_lo) & (hit[0] < x_hi) & (s < best_s)
            best_s = np.where(ok, s, best_s)
            best_world = np.where(ok[None], hit, best_world)
        tex = texture(best_world[0], best_world[1]).reshape(height, width)
        images[v] = np.repeat(tex[..., None], 3, axis=-1).astype(np.float32)
        cam_z = (r @ best_world + t[:, None])[2]
        cam_z = np.where(np.isfinite(best_s), cam_z, 0.0)
        depths[v] = cam_z.reshape(height, width).astype(np.float32)
    return images, depths


def make_plane_scene(
    num_views: int = 3,
    height: int = 64,
    width: int = 80,
    z0: float = 10.0,
    baseline: float = 0.6,
    focal: float = 100.0,
    jitter_angle: float = 0.02,
    seed: int = 0,
    tilt: tuple = (0.0, 0.0),
) -> SyntheticScene:
    """Cameras spread along x (and slightly rotated) looking at the plane
    z = z0 + tilt[0]·x + tilt[1]·y. View 0 is the reference with identity
    extrinsics. A nonzero tilt makes the depth map vary across the image —
    essential for tests that must reject a model biased toward the
    mid-range-constant prediction (the soft-argmin prior at init)."""
    intrinsics, extrinsics = _camera_rig(
        num_views, height, width, baseline, focal, jitter_angle, seed
    )
    images, depths = _render_planes(
        intrinsics, extrinsics, height, width,
        [(z0, tilt[0], tilt[1], -np.inf, np.inf)],
    )
    return SyntheticScene(
        images=images,
        depths=depths,
        intrinsics=intrinsics.astype(np.float32),
        extrinsics=extrinsics.astype(np.float32),
        depth_min=z0 * 0.75,
        depth_max=z0 * 1.25,
    )

