"""Synthetic multi-view scenes with analytic ground truth.

A textured plane z = z0 (world frame == reference camera frame), two planes
with a depth step, or a tilted backdrop with spheres in front of it, imaged
by a rig of pinhole cameras. Every quantity (images, per-view depth maps) is
computed in closed form, giving exact fixtures for warp / cost-volume /
regression / consistency / fusion tests — the test strategy the reference
implies but never automated (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticScene", "make_objects_scene", "make_plane_scene",
           "make_step_scene", "texture"]


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


def _ray_cast(intrinsics, extrinsics, height, width, planes, spheres, shade):
    """Ray-cast every view of a scene of planes and opaque spheres.

    planes: (z0, tx, ty, x_lo, x_hi) for the plane z = z0 + tx·x + ty·y over
    world x in [x_lo, x_hi); spheres: (cx, cy, cz, radius). Per ray, the
    nearest valid hit wins (correct occlusion seen from off-axis cameras).
    shade maps the (3, N) world hits to their grey level. Returns (images,
    depths); a ray that hits nothing has depth 0."""
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
        for cx, cy, cz, rad in spheres:
            oc = center - np.array([cx, cy, cz])
            d2 = (dirs * dirs).sum(0)
            b = 2.0 * (oc[:, None] * dirs).sum(0)
            cc = oc @ oc - rad * rad
            disc = b * b - 4 * d2 * cc
            root = np.sqrt(np.maximum(disc, 0.0))
            s = (-b - root) / (2 * d2)  # near intersection
            hit = center[:, None] + s[None] * dirs
            ok = (disc > 0) & (s > 0) & (s < best_s)
            best_s = np.where(ok, s, best_s)
            best_world = np.where(ok[None], hit, best_world)
        tex = shade(best_world).reshape(height, width)
        images[v] = np.repeat(tex[..., None], 3, axis=-1).astype(np.float32)
        cam_z = (r @ best_world + t[:, None])[2]
        cam_z = np.where(np.isfinite(best_s), cam_z, 0.0)
        depths[v] = cam_z.reshape(height, width).astype(np.float32)
    return images, depths


def _render_planes(intrinsics, extrinsics, height, width, planes):
    """Render a scene of planes (see _ray_cast), textured by their world x
    and y. Returns (images, depths)."""
    return _ray_cast(intrinsics, extrinsics, height, width, planes, (),
                     lambda w: texture(w[0], w[1]))


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


def make_step_scene(
    num_views: int = 3,
    height: int = 64,
    width: int = 80,
    z_near: float = 9.0,
    z_far: float = 11.5,
    x_edge: float = 0.0,
    baseline: float = 0.6,
    focal: float = 100.0,
    jitter_angle: float = 0.02,
    seed: int = 0,
    tilt_far: tuple = (0.0, 0.0),
) -> SyntheticScene:
    """Two textured planes with a depth discontinuity at world x = x_edge:
    the near plane z=z_near for x < x_edge, a (optionally slanted) far plane
    for x >= x_edge. Exercises occlusion and abrupt disparity jumps — the
    hostile geometry for banded/tiled warp coverage (the failure mode a
    fronto-parallel plane can never expose)."""
    intrinsics, extrinsics = _camera_rig(
        num_views, height, width, baseline, focal, jitter_angle, seed
    )
    images, depths = _render_planes(
        intrinsics, extrinsics, height, width,
        [
            (z_near, 0.0, 0.0, -np.inf, x_edge),
            (z_far, tilt_far[0], tilt_far[1], x_edge, np.inf),
        ],
    )
    zmin = min(z_near, z_far)
    zmax = max(z_near, z_far)
    return SyntheticScene(
        images=images,
        depths=depths,
        intrinsics=intrinsics.astype(np.float32),
        extrinsics=extrinsics.astype(np.float32),
        depth_min=zmin * 0.9,
        depth_max=zmax * 1.1,
    )


def _render_objects(intrinsics, extrinsics, height, width, planes, spheres,
                    freq: float = 1.0):
    """Ray-cast planes (see _render_planes) PLUS opaque textured spheres.

    spheres: list of (cx, cy, cz, radius). Nearest hit wins, so spheres
    occlude the backdrop and each other — curved surfaces, occlusion
    boundaries, and per-view visibility differences that a plane fixture can
    never produce. Returns (images, depths)."""
    return _ray_cast(intrinsics, extrinsics, height, width, planes, spheres,
                     lambda w: texture(freq * w[0],
                                       freq * w[1] + 0.5 * freq * w[2]))


def make_objects_scene(
    num_views: int = 5,
    height: int = 64,
    width: int = 96,
    z0: float = 10.0,
    baseline: float = 0.6,
    focal: float = 100.0,
    jitter_angle: float = 0.02,
    seed: int = 0,
    tilt: tuple = (0.08, 0.05),
    texture_freq: float = 2.0,
) -> SyntheticScene:
    """Textured multi-object scene: a tilted backdrop plane plus spheres in
    front of it — occlusion boundaries, curved depth, view-dependent
    visibility. The sphere layout varies with `seed` so multiple scans are
    genuinely different scenes. Depth spans roughly [0.75 z0, 1.25 z0]."""
    rng = np.random.default_rng(seed + 101)
    intrinsics, extrinsics = _camera_rig(
        num_views, height, width, baseline, focal, jitter_angle, seed
    )
    spheres = []
    for i in range(3):
        cx = rng.uniform(-2.2, 2.2)
        cy = rng.uniform(-1.6, 1.6)
        cz = z0 - rng.uniform(1.0, 2.2)
        rad = rng.uniform(0.55, 1.0)
        spheres.append((cx, cy, cz, rad))
    images, depths = _render_objects(
        intrinsics, extrinsics, height, width,
        [(z0, tilt[0], tilt[1], -np.inf, np.inf)], spheres,
        freq=texture_freq,
    )
    return SyntheticScene(
        images=images,
        depths=depths,
        intrinsics=intrinsics.astype(np.float32),
        extrinsics=extrinsics.astype(np.float32),
        depth_min=z0 * 0.72,
        depth_max=z0 * 1.28,
    )
