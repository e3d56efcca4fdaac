"""PNG codec on numpy and the standard library's zlib.

Reads and writes 8-bit gray, gray + alpha, RGB and RGBA images without
interlacing: the images this package writes and the DTU layouts use. It
decodes all five row filters (None, Sub, Up, Average, Paeth) and raises on
what it does not support (other bit depths, palettes, interlacing). The
writer uses filter None on every row. PIL and cv2 are not needed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["PNG_SIGNATURE", "read_png", "write_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the 8-bit types this codec takes.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# The writer's zlib level: 1, the fastest, since each depth map's image is
# written on the thread that drives the card (level 1 against level 6 is in
# chip_smoke.py phase 6b and PERF.md).
ZLIB_LEVEL = 1


def _chunks(data: bytes, path):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before IEND")


def _paeth_or_average_row(kind: int, row: bytearray, prev: bytes, bpp: int):
    """Undo filter 3 (Average) or 4 (Paeth) in place, byte by byte: each
    byte depends on the already decoded byte to its left."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def read_png(path) -> np.ndarray:
    """Decode a PNG into uint8 (H, W) for gray or (H, W, C) with C = 2, 3
    or 4."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}); want 8-bit gray/RGB/RGBA")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG not supported")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, "
                         f"want {height * (stride + 1)}")
    raw = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, row = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = row + prev
        elif kind in (3, 4):
            buf = bytearray(row.tobytes())
            _paeth_or_average_row(kind, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has filter {kind}")
        out[y] = cur
        prev = out[y]
    return out.reshape(height, width) if bpp == 1 else out.reshape(
        height, width, bpp)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, image: np.ndarray) -> None:
    """Write uint8 (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4) as
    an 8-bit PNG, filter None on every row."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png wants uint8, got {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    channels = 1 if image.ndim == 2 else image.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(channels)
    if image.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"write_png: unsupported shape {image.shape}")
    height, width = image.shape[:2]
    rows = np.zeros((height, width * channels + 1), np.uint8)
    rows[:, 1:] = image.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL))
                + _chunk(b"IEND", b""))
