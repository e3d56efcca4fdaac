"""DTU eval-layout reader (counterpart of mvs_tpu.io.dtu's read_image,
_scale_to_fit and DTUEvalDataset).

Eval layout: {scan}/images/{v:08d}.jpg (or .png), {scan}/cams/{v:08d}_cam.txt
with full-resolution intrinsics, and {scan}/pair.txt (or a shared
<root>/pair.txt). Images are rescaled so they fit (max_h, max_w) with H and
W multiples of `align`, and the intrinsics with them.

PNG is decoded by io.png; JPEG by cv2, else PIL, as the JAX reader does,
each imported only when a JPEG is read. The training split waits for
training.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mvs_tpu_torch.io.cams import read_cam_file
from mvs_tpu_torch.io.pairs import read_pair_file
from mvs_tpu_torch.io.png import PNG_SIGNATURE, read_png

__all__ = ["read_image", "resize_bilinear", "image_path", "DTUEvalDataset"]


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
