"""DTU readers (counterpart of mvs_tpu.io.dtu's read_image, _scale_to_fit,
DTUTrainDataset, DTUEvalDataset, collate_mvsnet, collate_cascade,
collate_pyramid and collate_point).

Training layout (preprocessed DTU): Rectified/{scan}_train/
rect_{v+1:03d}_{light}_r5000.png, Depths/{scan}_train/depth_map_{v:04d}.pfm
with depth_visual_{v:04d}.png masks, Cameras/{v:08d}_cam.txt with the
intrinsics at the depth maps' (1/4) resolution, and Cameras/pair.txt.

Eval layout: {scan}/images/{v:08d}.jpg (or .png), {scan}/cams/{v:08d}_cam.txt
with full-resolution intrinsics, and {scan}/pair.txt (or a shared
<root>/pair.txt). Images are rescaled so they fit (max_h, max_w) with H and
W multiples of `align`, and the intrinsics with them.

PNG is decoded by io.png; JPEG by cv2, else PIL, as the JAX reader does,
each imported only when a JPEG is read.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mvs_tpu_torch.io.cams import read_cam_file
from mvs_tpu_torch.io.pairs import read_pair_file
from mvs_tpu_torch.io.pfm import read_pfm
from mvs_tpu_torch.io.png import PNG_SIGNATURE, read_png

__all__ = ["read_image", "resize_bilinear", "image_path", "DTUTrainDataset",
           "DTUEvalDataset", "collate_mvsnet", "collate_cascade",
           "collate_pyramid", "collate_point"]


def _decode_jpeg(path) -> np.ndarray:
    """uint8 (H, W, 3) RGB through cv2, else PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: decoding a JPEG needs cv2 or PIL and neither is "
            "installed (PNG images need neither)") from None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def read_image(path) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]; alpha is dropped, gray repeated."""
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if not is_png:
        return _decode_jpeg(path).astype(np.float32) / 255.0
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :3] if img.shape[2] >= 3 else img[..., :1]
    return np.broadcast_to(img, (*img.shape[:2], 3)).astype(
        np.float32) / 255.0


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), INTER_LINEAR) for float32 (H, W) or
    (H, W, C) images: half-pixel centres, edge clamping, no antialiasing."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)[0]
    y = y[0] if img.ndim == 2 else y.permute(1, 2, 0)
    return y.contiguous().numpy()


def _scale_to_fit(img: np.ndarray, intrinsics: np.ndarray, max_h: int,
                  max_w: int, align: int):
    """Rescale so the image fits (max_h, max_w) with sides that are
    multiples of `align`; the intrinsics follow."""
    h, w = img.shape[:2]
    scale = min(max_h / h, max_w / w, 1.0)
    new_h = (int(h * scale) // align) * align
    new_w = (int(w * scale) // align) * align
    k = intrinsics.copy()
    k[0] *= new_w / w
    k[1] *= new_h / h
    return resize_bilinear(img, new_h, new_w), k


def image_path(scan_dir: Path, vid: int) -> Path:
    """{scan_dir}/images/{vid:08d}.jpg, else .png (the first that exists)."""
    for ext in (".jpg", ".png"):
        p = scan_dir / "images" / f"{vid:08d}{ext}"
        if p.exists():
            return p
    raise FileNotFoundError(f"no {vid:08d}.jpg or .png under "
                            f"{scan_dir / 'images'}")


@dataclasses.dataclass
class DTUTrainDataset:
    """Preprocessed-DTU training split: one item = one (scan, light, ref
    view)."""

    root: str
    scans: list
    num_views: int = 3
    num_depth: int = 192
    interval_scale: float = 1.06
    lights: tuple = tuple(range(7))

    def __post_init__(self):
        self.root = Path(self.root)
        pairs = read_pair_file(self.root / "Cameras" / "pair.txt")
        # Only the lights on disk (the official set has 7; a synthetic one
        # may have fewer).
        if self.scans:
            probe = self.root / "Rectified" / f"{self.scans[0]}_train"
            available = sorted(int(p.stem.split("_")[2])
                               for p in probe.glob("rect_001_*_r5000.png"))
            if available:
                requested = [i for i in self.lights if i in available]
                self.lights = tuple(requested or available)
        self.metas = [(scan, light, ref, srcs)
                      for scan in self.scans
                      for light in self.lights
                      for ref, srcs in pairs
                      if len(srcs) >= self.num_views - 1]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict:
        scan, light, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + list(src_views[: self.num_views - 1])
        depths_dir = self.root / "Depths" / f"{scan}_train"

        imgs, intr, extr = [], [], []
        for vid in view_ids:
            imgs.append(read_image(self.root / "Rectified" / f"{scan}_train"
                                   / f"rect_{vid + 1:03d}_{light}_r5000.png"))
            cam = read_cam_file(self.root / "Cameras" / f"{vid:08d}_cam.txt",
                                self.interval_scale)
            intr.append(cam.intrinsics)
            extr.append(cam.extrinsics)
            if vid == ref_view:
                depth_min, depth_interval = cam.depth_min, cam.depth_interval
        depth = np.asarray(read_pfm(
            depths_dir / f"depth_map_{ref_view:04d}.pfm")[0], np.float32)
        vis_path = depths_dir / f"depth_visual_{ref_view:04d}.png"
        if vis_path.exists():
            mask = (read_image(vis_path)[..., 0] > 0.5).astype(np.float32)
        else:
            mask = (depth > depth_min).astype(np.float32)

        return {
            "scan": scan, "light": light, "view_ids": view_ids,
            "imgs": np.stack(imgs),  # (V, H, W, 3)
            # Depth-resolution intrinsics as stored; collate scales them.
            "intrinsics": np.stack(intr), "extrinsics": np.stack(extr),
            "depth_values": (depth_min + np.arange(self.num_depth,
                                                   dtype=np.float32)
                             * depth_interval),
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_min + (self.num_depth - 1)
                                    * depth_interval),
            "depth_interval": np.float32(depth_interval),
            "depth_gt": depth, "mask": mask,  # at depth (1/4) resolution
        }


@dataclasses.dataclass
class DTUEvalDataset:
    """Eval layout: one item = one reference view of one scan."""

    root: str
    scans: list
    num_views: int = 5
    num_depth: int = 192
    interval_scale: float = 1.06
    max_h: int = 864
    max_w: int = 1152
    align: int = 32

    def __post_init__(self):
        self.root = Path(self.root)
        self.metas = []
        for scan in self.scans:
            pair_path = self.root / scan / "pair.txt"
            if not pair_path.exists():
                pair_path = self.root / "pair.txt"
            for ref, srcs in read_pair_file(pair_path):
                if len(srcs) >= self.num_views - 1:
                    self.metas.append((scan, ref, srcs))

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict:
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + list(src_views[: self.num_views - 1])
        scan_dir = self.root / scan

        imgs, intr, extr = [], [], []
        depth_min = depth_interval = None
        for i, vid in enumerate(view_ids):
            img = read_image(image_path(scan_dir, vid))
            cam = read_cam_file(scan_dir / "cams" / f"{vid:08d}_cam.txt",
                                self.interval_scale)
            img, k = _scale_to_fit(img, cam.intrinsics, self.max_h,
                                   self.max_w, self.align)
            imgs.append(img)
            intr.append(k)
            extr.append(cam.extrinsics)
            if i == 0:
                depth_min, depth_interval = cam.depth_min, cam.depth_interval

        return {
            "scan": scan, "ref_view": ref_view, "view_ids": view_ids,
            "imgs": np.stack(imgs),
            "intrinsics": np.stack(intr),  # at the rescaled image size
            "extrinsics": np.stack(extr),
            "depth_values": (depth_min + np.arange(self.num_depth,
                                                   dtype=np.float32)
                             * depth_interval),
            "depth_min": np.float32(depth_min),
            "depth_max": np.float32(depth_min + (self.num_depth - 1)
                                    * depth_interval),
            "depth_interval": np.float32(depth_interval),
        }


def _compose(intr: np.ndarray, extr: np.ndarray) -> np.ndarray:
    proj = extr.copy()
    proj[..., :3, :4] = intr @ extr[..., :3, :4]
    return proj


def _stack(samples: list[dict], key: str) -> np.ndarray:
    return np.stack([s[key] for s in samples])


def collate_mvsnet(samples: list[dict]) -> dict:
    """Train batch of the MVSNet task: the projections of the stored
    (1/4-resolution) intrinsics as they are, and the GT depth and mask at
    that resolution."""
    return {"imgs": _stack(samples, "imgs"),
            "proj_matrices": _compose(_stack(samples, "intrinsics"),
                                      _stack(samples, "extrinsics")),
            **{k: _stack(samples, k)
               for k in ("depth_values", "depth_gt", "mask")}}


def collate_cascade(samples: list[dict]) -> dict:
    """Train batch of the cascade task: stage projections at 1x / 2x / 4x
    the stored (1/4-resolution) intrinsics, and the GT depth and mask at
    each stage's resolution. The nearest x2 / x4 upsample of the GT is
    np.repeat along both axes, which is what cv2.resize(INTER_NEAREST)
    computes at an integer factor."""
    intr, extr = _stack(samples, "intrinsics"), _stack(samples, "extrinsics")
    gt, mask = _stack(samples, "depth_gt"), _stack(samples, "mask")
    proj, gt_ms, mask_ms = {}, {}, {}
    for i, s in enumerate((1, 2, 4)):
        stage = f"stage{i + 1}"
        k = intr.copy()
        k[..., :2, :] *= s
        proj[stage] = _compose(k, extr)
        gt_ms[stage] = gt.repeat(s, axis=1).repeat(s, axis=2)
        mask_ms[stage] = mask.repeat(s, axis=1).repeat(s, axis=2)
    return {"imgs": _stack(samples, "imgs"), "proj_matrices": proj,
            "depth_values": _stack(samples, "depth_values"),
            "depth_gt": gt_ms, "mask": mask_ms}


def collate_pyramid(samples: list[dict], num_levels: int = 2) -> dict:
    """Train batch of the pyramid task (CVP / AACVP): the intrinsics at the
    images' resolution (the stored 1/4-resolution ones x4), and the GT
    pyramid finest first: the GT upsampled x4 to the images (np.repeat, as
    collate_cascade), each coarser level its every other row and column,
    each level's mask gt > depth_min of its sample."""
    intr = _stack(samples, "intrinsics").copy()
    intr[..., :2, :] *= 4.0
    gt = _stack(samples, "depth_gt")
    levels = [gt.repeat(4, axis=1).repeat(4, axis=2)]
    for _ in range(num_levels - 1):
        levels.append(levels[-1][:, ::2, ::2])
    dmin = _stack(samples, "depth_min")
    return {"imgs": _stack(samples, "imgs"), "intrinsics": intr,
            "extrinsics": _stack(samples, "extrinsics"), "depth_min": dmin,
            "depth_max": _stack(samples, "depth_max"),
            "depth_gt_levels": levels,
            "mask_levels": [(g > dmin[:, None, None]).astype(np.float32)
                            for g in levels]}


def collate_point(samples: list[dict]) -> dict:
    """Train batch of the point task (Point-MVSNet): the intrinsics at the
    images' resolution (the stored 1/4-resolution ones x4), the GT
    upsampled x4 to the images (np.repeat, as collate_cascade; 0 =
    invalid), depth_start the samples' depth_min."""
    intr = _stack(samples, "intrinsics").copy()
    intr[..., :2, :] *= 4.0
    gt = _stack(samples, "depth_gt")
    return {"imgs": _stack(samples, "imgs"), "intrinsics": intr,
            "extrinsics": _stack(samples, "extrinsics"),
            "depth_start": _stack(samples, "depth_min"),
            "depth_interval": _stack(samples, "depth_interval"),
            "depth_gt": gt.repeat(4, axis=1).repeat(4, axis=2)}
