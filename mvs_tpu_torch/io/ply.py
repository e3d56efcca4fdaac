"""Binary PLY point-cloud writer/reader.

Covers the output/input formats the pipeline needs: fused point clouds with
position + color (+ optional normal), matching what the reference emits via
plyfile (MVSNet/eval.py:303-326) and fusibile's binary writer
(fusibile/displayUtils.h:80), and what the DTU evaluation reads back
(Evaluation/dtu/plyread.m).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["write_ply", "read_ply"]


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray | None = None,
              normals: np.ndarray | None = None) -> None:
    """Write a binary little-endian PLY. xyz (N,3) float; rgb (N,3) uint8; normals (N,3)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header_props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header_props += ["property float nx", "property float ny", "property float nz"]
    if rgb is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header_props += ["property uchar red", "property uchar green", "property uchar blue"]

    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]

    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + header_props
        + ["end_header", ""]
    )
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read a PLY vertex element (binary LE/BE or ascii).

    Returns {'xyz': (N,3) f32} plus 'rgb' (N,3 u8) and 'normals' (N,3 f32) when present.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties on vertex element unsupported")
                props.append((parts[2], _PLY_TYPES[parts[1]]))
            elif line == "end_header":
                break
            elif line.startswith("comment") or line.startswith("obj_info"):
                continue
        if n_vertex is None:
            raise ValueError(f"{path}: no vertex element")

        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex)
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            swap = fmt == "binary_big_endian"
            dtype = [(name, t.replace("<", ">") if swap else t) for name, t in props]
            raw = np.fromfile(f, dtype=dtype, count=n_vertex)
            rec = {name: raw[name] for name, _ in props}

    out = {"xyz": np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)}
    if all(k in rec for k in ("red", "green", "blue")):
        out["rgb"] = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1).astype(np.uint8)
    if all(k in rec for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1).astype(np.float32)
    return out
