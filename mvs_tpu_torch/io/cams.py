"""MVSNet camera-file codec.

Format (pinned by reference MVSNet/datasets/dtu_yao.py:47-58 and
CasMVSNet/datasets/general_eval.py:59-79):

    extrinsic
    <4x4 world-to-camera matrix, rows on lines 1-4>
    <blank>
    intrinsic
    <3x3 K, rows on lines 7-9>
    <blank>
    depth_min depth_interval [num_depth depth_max]

The last line may carry 2, 3 or 4 fields; missing fields are derived
(depth_max = depth_min + num_depth * depth_interval).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

__all__ = ["CameraParams", "read_cam_file", "write_cam_file"]


@dataclasses.dataclass
class CameraParams:
    """One view's calibration: K (3,3), world-to-camera extrinsic (4,4), depth range."""

    intrinsics: np.ndarray  # (3, 3) float32
    extrinsics: np.ndarray  # (4, 4) float32
    depth_min: float
    depth_interval: float
    num_depth: int | None = None
    depth_max: float | None = None

    def scaled(self, factor: float) -> "CameraParams":
        """Return a copy with the intrinsics scaled by `factor` (image resize)."""
        k = self.intrinsics.copy()
        k[:2, :] *= factor
        return dataclasses.replace(self, intrinsics=k)

    @property
    def projection(self) -> np.ndarray:
        """4x4 projection: K (embedded top-left) @ extrinsic."""
        proj = self.extrinsics.copy()
        proj[:3, :4] = self.intrinsics @ self.extrinsics[:3, :4]
        return proj


def read_cam_file(path, interval_scale: float = 1.0) -> CameraParams:
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    fields = lines[11].split()
    depth_min = float(fields[0])
    depth_interval = float(fields[1]) * interval_scale
    num_depth = int(float(fields[2])) if len(fields) > 2 else None
    depth_max = float(fields[3]) if len(fields) > 3 else None
    return CameraParams(
        intrinsics=intrinsics,
        extrinsics=extrinsics,
        depth_min=depth_min,
        depth_interval=depth_interval,
        num_depth=num_depth,
        depth_max=depth_max,
    )


def write_cam_file(path, cam: CameraParams) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(cam.extrinsics, dtype=np.float64):
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(cam.intrinsics, dtype=np.float64):
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
        f.write("\n")
        fields = [cam.depth_min, cam.depth_interval]
        if cam.num_depth is not None:
            fields.append(cam.num_depth)
            if cam.depth_max is not None:
                fields.append(cam.depth_max)
        f.write(" ".join(repr(float(v)) for v in fields) + "\n")
