"""Gipuma .dmb (binary depth / normal map) codec (counterpart of
mvs_tpu.io.dmb).

Format (fusibile's fileIoUtils.h): four little-endian int32 header fields
(type 1 = float, height, width, channels), then the row-major float32
data.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["read_dmb", "write_dmb"]


def read_dmb(path) -> np.ndarray:
    """(H, W) or (H, W, C) float32."""
    with open(path, "rb") as f:
        dtype_tag, h, w, c = np.fromfile(f, dtype="<i4", count=4)
        if dtype_tag != 1:
            raise ValueError(f"{path}: unsupported dmb type {dtype_tag}")
        data = np.fromfile(f, dtype="<f4", count=h * w * c)
    data = data.reshape(h, w, c)
    return data[..., 0] if c == 1 else data


def write_dmb(path, image: np.ndarray) -> None:
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.array([1, h, w, c], dtype="<i4").tofile(f)
        image.astype("<f4").tofile(f)
