"""PFM (portable float map) codec.

Semantics match the reference readers/writers (e.g. reference
MVSNet/datasets/data_io.py:6-71, PointMVSNet/pointmvsnet/utils/io.py:78-145):
header 'Pf' (grayscale) / 'PF' (3-channel), ASCII "W H" dims line, scale line
whose sign encodes endianness (negative = little-endian), raster stored
bottom-to-top (flipud on read and write).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

__all__ = ["read_pfm", "write_pfm"]


def read_pfm(path) -> tuple[np.ndarray, float]:
    """Read a PFM file. Returns (array, scale); array is (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dim_line = f.readline().decode("utf-8")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dim_line)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims line {dim_line!r}")
        width, height = map(int, m.groups())

        scale = float(f.readline().decode("utf-8").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f4", count=width * height * channels)

    shape = (height, width, 3) if channels == 3 else (height, width)
    data = np.reshape(data, shape)
    # PFM stores rows bottom-to-top.
    return np.ascontiguousarray(np.flipud(data)), scale


def write_pfm(path, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 (H, W[, 1|3]) array as PFM (little-endian)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        image = image.astype(np.float32)

    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"PFM image must be (H,W), (H,W,1) or (H,W,3); got {image.shape}")

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("utf-8"))
        # Negative scale marks little-endian, which we always emit.
        f.write(f"{-abs(scale):f}\n".encode("utf-8"))
        np.flipud(image).astype("<f4").tofile(f)
