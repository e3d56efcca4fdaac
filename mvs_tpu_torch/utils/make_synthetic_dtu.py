"""Generate a synthetic dataset in the DTU on-disk layouts (counterpart of
mvs_tpu.utils.make_synthetic_dtu).

    python -m mvs_tpu_torch.utils.make_synthetic_dtu --root /tmp/dtu --scans 2 \
        [--scene plane|objects]

Writes the preprocessed-DTU *training* layout (Rectified/, Depths/,
Cameras/ with 1/4-res intrinsics), the *eval* layout ({scan}/images,
{scan}/cams, {scan}/pair.txt), a GT point cloud per scan under Points/stl/
for the DTU evaluation, and lists/{train,val,test}.txt. Scenes are textured
planes, or a tilted backdrop with spheres in front of it, with analytic
depth (utils.synthetic). Images are PNG, written by
io.png, so neither PIL nor cv2 is needed; the JAX generator writes the eval
images as JPEG.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from mvs_tpu_torch.io.cams import CameraParams, write_cam_file
from mvs_tpu_torch.io.pairs import write_pair_file
from mvs_tpu_torch.io.pfm import write_pfm
from mvs_tpu_torch.io.ply import write_ply
from mvs_tpu_torch.io.png import write_png
from mvs_tpu_torch.utils.synthetic import make_objects_scene, make_plane_scene

__all__ = ["generate", "main", "write_eval_scan"]


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _visible_plane_points(scene, z0, tilt, height, width) -> np.ndarray:
    """GT cloud: a grid on the plane, restricted to points some view sees
    (the role of DTU's ObsMask)."""
    ys, xs = np.meshgrid(np.linspace(-4, 4, 160), np.linspace(-5, 5, 200),
                         indexing="ij")
    zs = z0 + tilt[0] * xs + tilt[1] * ys
    stl = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1)
    visible = np.zeros(len(stl), bool)
    for k, rt in zip(scene.intrinsics, scene.extrinsics):
        uvw = (stl @ rt[:3, :3].T + rt[:3, 3]) @ k.T
        with np.errstate(divide="ignore", invalid="ignore"):
            u = uvw[:, 0] / uvw[:, 2]
            v = uvw[:, 1] / uvw[:, 2]
        visible |= ((uvw[:, 2] > 0) & (u >= 0) & (u < width) & (v >= 0)
                    & (v < height))
    return stl[visible]


def _unprojected_depth_points(scene, height, width) -> np.ndarray:
    """GT cloud of any geometry: every view's analytic depth unprojected
    (perfect fusion, observed by construction), every (N // 60000)-th
    point kept to keep the evaluation's KD-trees small."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], 0).reshape(3, -1).astype(
        np.float64)
    pts = []
    for k, rt, depth in zip(scene.intrinsics, scene.extrinsics, scene.depths):
        d = depth.reshape(-1)
        cam = np.linalg.inv(k) @ (pix * d[None])
        world = rt[:3, :3].T @ (cam - rt[:3, 3:4])
        pts.append(world[:, d > 0].T)
    stl = np.concatenate(pts, axis=0)
    return stl[:: max(1, len(stl) // 60000)]


def _write_train_scan(root: Path, scan: str, scene, num_lights: int):
    """One scan's training layout: Rectified/ images per light, Depths/ at
    1/4 resolution with their visual masks."""
    for light in range(num_lights):
        for v, img in enumerate(scene.images):
            write_png(root / "Rectified" / f"{scan}_train"
                      / f"rect_{v + 1:03d}_{light}_r5000.png", _to_u8(img))
    for v, depth in enumerate(scene.depths):
        depth_q = depth[::4, ::4].astype(np.float32)
        depths_dir = root / "Depths" / f"{scan}_train"
        write_pfm(depths_dir / f"depth_map_{v:04d}.pfm", depth_q)
        vis = (depth_q > 0).astype(np.uint8) * 255
        write_png(depths_dir / f"depth_visual_{v:04d}.png",
                  np.stack([vis] * 3, -1))


def write_eval_scan(root, scan: str, scene, num_depth: int,
                    z0: float = 10.0) -> None:
    """One scan's eval layout: {scan}/images as PNG, {scan}/cams with the
    ladder [0.72 z0, 1.28 z0] in `num_depth` hypotheses, and {scan}/pair.txt
    with every other view as a source, ranked by index distance."""
    root = Path(root)
    num_views = len(scene.images)
    depth_min, depth_max = z0 * 0.72, z0 * 1.28
    interval = (depth_max - depth_min) / (num_depth - 1)
    for v in range(num_views):
        write_png(root / scan / "images" / f"{v:08d}.png",
                  _to_u8(scene.images[v]))
        write_cam_file(root / scan / "cams" / f"{v:08d}_cam.txt",
                       CameraParams(
                           intrinsics=scene.intrinsics[v],
                           extrinsics=scene.extrinsics[v],
                           depth_min=depth_min, depth_interval=interval,
                           num_depth=num_depth, depth_max=depth_max))
    write_pair_file(root / scan / "pair.txt", _pairs(num_views))


def _pairs(num_views: int):
    return [(r, [(v, float(num_views - abs(v - r)))
                 for v in range(num_views) if v != r])
            for r in range(num_views)]


def generate(root, num_scans=2, num_views=5, height=64, width=96,
             num_depth=16, num_lights=2, z0=10.0, tilt=(0.0, 0.0),
             scene_type="plane", train_layout=True):
    """tilt: plane slope (dz/dx, dz/dy). A nonzero tilt makes GT depth vary
    across the image, so an end-to-end quality number cannot be faked by the
    soft-argmin mid-range prior (the plane z=z0 sits at the ladder centre).
    scene_type "objects" renders a tilted backdrop with textured spheres in
    front of it (make_objects_scene): occlusion boundaries and curved
    surfaces; its GT cloud is every view's analytic depth unprojected.
    Every ref view gets every other view as a source, ranked by index
    distance. train_layout=False writes only the eval layout, the GT clouds
    and the lists. Returns `root` as a Path."""
    root = Path(root)
    depth_min, depth_max = z0 * 0.72, z0 * 1.28
    interval = (depth_max - depth_min) / (num_depth - 1)

    make_scene = (make_objects_scene if scene_type == "objects"
                  else make_plane_scene)
    scenes = {}
    for s in range(num_scans):
        scene = make_scene(num_views=num_views, height=height, width=width,
                           z0=z0, seed=s, tilt=tilt)
        scan = f"scan{s + 1}"
        scenes[scan] = scene

        if train_layout:
            _write_train_scan(root, scan, scene, num_lights)

        write_eval_scan(root, scan, scene, num_depth, z0)
        stl = (_unprojected_depth_points(scene, height, width)
               if scene_type == "objects"
               else _visible_plane_points(scene, z0, tilt, height, width))
        write_ply(root / "Points" / "stl" / f"stl{s + 1:03d}_total.ply",
                  stl.astype(np.float32))

    # shared training cams at 1/4 resolution
    if train_layout:
        for v in range(num_views):
            k = scenes["scan1"].intrinsics[v].copy()
            k[:2] /= 4.0
            write_cam_file(root / "Cameras" / f"{v:08d}_cam.txt",
                           CameraParams(
                               intrinsics=k,
                               extrinsics=scenes["scan1"].extrinsics[v],
                               depth_min=depth_min, depth_interval=interval,
                               num_depth=num_depth, depth_max=depth_max))
        write_pair_file(root / "Cameras" / "pair.txt", _pairs(num_views))

    (root / "lists").mkdir(parents=True, exist_ok=True)
    for split, scans in (("train", list(scenes)[:max(1, num_scans - 1)]),
                         ("val", list(scenes)[-1:]),
                         ("test", list(scenes))):
        (root / "lists" / f"{split}.txt").write_text("\n".join(scans) + "\n")
    return root


def main(argv=None):
    p = argparse.ArgumentParser(prog="mvs_tpu_torch make_synthetic_dtu")
    p.add_argument("--root", required=True)
    p.add_argument("--scans", type=int, default=2)
    p.add_argument("--views", type=int, default=5)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--depths", type=int, default=16)
    p.add_argument("--tilt", type=float, nargs=2, default=(0.0, 0.0),
                   metavar=("DZDX", "DZDY"))
    p.add_argument("--scene", default="plane", choices=("plane", "objects"))
    args = p.parse_args(argv)
    generate(args.root, args.scans, args.views, args.height, args.width,
             args.depths, tilt=tuple(args.tilt), scene_type=args.scene)
    print(f"synthetic DTU layout written to {args.root}")


if __name__ == "__main__":
    main()
