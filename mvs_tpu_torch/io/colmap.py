"""COLMAP sparse model -> MVSNet input layout (counterpart of
mvs_tpu.io.colmap, numpy only).

    python -m mvs_tpu_torch.io.colmap --dense_folder D --save_folder S \
        [--max_d 192] [--interval_scale 1.0] [--theta0 5] [--sigma1 1] \
        [--sigma2 10]

D holds sparse/ (cameras, images and points3D, as .txt or .bin) and
images/; S receives cams/{i:08d}_cam.txt, pair.txt and images/, i being
the view's rank among the image ids. The numbers are mvs_tpu's:

  * each view's depth range is the mean of the nearest 1% (at least one)
    and of the farthest 10% (at least five) of its track points' depths;
  * with --max_d 0 the hypothesis count is the inverse-depth rule (adjacent
    planes move the principal point about one pixel), else --max_d;
  * a pair's score sums exp(-(theta - theta0)^2 / (2 sigma^2)) over the
    points both views see, theta the baseline angle at the point and sigma
    sigma1 up to theta0, sigma2 beyond; each view keeps its ten best.

Images: a .jpg / .jpeg source is copied byte for byte as {i:08d}.jpg, as
mvs_tpu does. mvs_tpu converts any other source to JPEG through PIL; the port
writes a PNG source as RGB through its own codec (io.png) as {i:08d}.png,
which its eval loader reads when no .jpg is there, and refuses other
formats. PIL and cv2 are not needed.

write_colmap_model writes a PINHOLE model in either form, for scenes made
here (tests, chip_smoke.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import struct
from pathlib import Path

import numpy as np

from mvs_tpu_torch.io.cams import CameraParams, write_cam_file
from mvs_tpu_torch.io.pairs import write_pair_file
from mvs_tpu_torch.io.png import PNG_SIGNATURE, read_png, write_png

__all__ = ["ColmapImage", "read_colmap_model", "convert_colmap",
           "write_colmap_model", "main"]


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    point3d_ids: np.ndarray  # -1: no track


def _qvec_to_rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def _rotmat_to_qvec(r):
    """Unit quaternion (w, x, y, z) of a rotation, w >= 0."""
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
        [r[1, 0] + r[0, 1], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
        [r[2, 0] + r[0, 2], r[2, 1] + r[1, 2], r[2, 2] - r[0, 0] - r[1, 1], 0],
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1],
         r[0, 0] + r[1, 1] + r[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    x, y, z, w = vecs[:, np.argmax(vals)]
    q = np.array([w, x, y, z])
    return -q if q[0] < 0 else q


def _camera_k(model: str, params) -> np.ndarray:
    p = list(params)
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        f, cx, cy = p[0], p[1], p[2]
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    if model in ("PINHOLE", "OPENCV", "FULL_OPENCV"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    raise ValueError(f"unsupported COLMAP camera model {model}")


_CAM_MODEL_IDS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _text_lines(path):
    return [ln for ln in open(path) if not ln.startswith("#") and ln.strip()]


def _read_cameras_text(path):
    cams = {}
    for line in _text_lines(path):
        parts = line.split()
        cams[int(parts[0])] = _camera_k(parts[1],
                                        [float(x) for x in parts[4:]])
    return cams


def _read_cameras_bin(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, _, _ = struct.unpack("<iiQQ", f.read(24))
            name, num_params = _CAM_MODEL_IDS[model_id]
            params = struct.unpack(f"<{num_params}d", f.read(8 * num_params))
            cams[cam_id] = _camera_k(name, params)
    return cams


def _read_images_text(path):
    images = {}
    lines = _text_lines(path)
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        pts = lines[i + 1].split()
        images[int(parts[0])] = ColmapImage(
            image_id=int(parts[0]),
            qvec=np.array([float(x) for x in parts[1:5]]),
            tvec=np.array([float(x) for x in parts[5:8]]),
            camera_id=int(parts[8]),
            name=parts[9],
            point3d_ids=np.array([int(x) for x in pts[2::3]], dtype=np.int64),
        )
    return images


def _read_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (image_id,) = struct.unpack("<i", f.read(4))
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            (camera_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (num_pts,) = struct.unpack("<Q", f.read(8))
            raw = np.frombuffer(
                f.read(24 * num_pts),
                dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            images[image_id] = ColmapImage(
                image_id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name.decode(), point3d_ids=raw["id"].astype(np.int64))
    return images


def _read_points_text(path):
    ids, xyz = [], []
    for line in _text_lines(path):
        parts = line.split()
        ids.append(int(parts[0]))
        xyz.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.array(ids, np.int64), np.array(xyz)


def _read_points_bin(path):
    ids, xyz = [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (pid,) = struct.unpack("<Q", f.read(8))
            p = struct.unpack("<3d", f.read(24))
            f.read(3 + 8)  # rgb, error
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.read(8 * track_len)
            ids.append(pid)
            xyz.append(p)
    return np.array(ids, np.int64), np.array(xyz)


def read_colmap_model(model_dir):
    """(cams {id: K}, images {id: ColmapImage}, point_ids, point_xyz) from
    the text model in `model_dir`, else the binary one."""
    model_dir = Path(model_dir)
    if (model_dir / "cameras.txt").exists():
        return (_read_cameras_text(model_dir / "cameras.txt"),
                _read_images_text(model_dir / "images.txt"),
                *_read_points_text(model_dir / "points3D.txt"))
    if (model_dir / "cameras.bin").exists():
        return (_read_cameras_bin(model_dir / "cameras.bin"),
                _read_images_bin(model_dir / "images.bin"),
                *_read_points_bin(model_dir / "points3D.bin"))
    raise FileNotFoundError(f"no COLMAP model in {model_dir}")


def write_colmap_model(model_dir, intrinsics, extrinsics, image_size,
                       points, tracks, names, binary: bool = False) -> None:
    """A PINHOLE model: camera and image i + 1 for view i (intrinsics (V,
    3, 3), world-to-camera extrinsics (V, 4, 4), image_size (H, W), names
    the image files), point 100 + j at points[j] seen by the views in
    tracks[j]; each image lists its points with pixel (0, 0)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    h, w = image_size
    seen = [[] for _ in names]
    for j, t in enumerate(tracks):
        for i in t:
            seen[i].append(j)
    # slot[i][j]: the index of point j among image i's 2D points.
    slot = [{j: k for k, j in enumerate(s)} for s in seen]
    if binary:
        with open(model_dir / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", len(names)))
            for i, k in enumerate(intrinsics):
                f.write(struct.pack("<iiQQ4d", i + 1, 1, w, h, k[0, 0],
                                    k[1, 1], k[0, 2], k[1, 2]))
        with open(model_dir / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", len(names)))
            for i, (e, name) in enumerate(zip(extrinsics, names)):
                f.write(struct.pack("<i4d3di", i + 1,
                                    *_rotmat_to_qvec(e[:3, :3]), *e[:3, 3],
                                    i + 1))
                f.write(name.encode() + b"\x00")
                f.write(struct.pack("<Q", len(seen[i])))
                for j in seen[i]:
                    f.write(struct.pack("<2dq", 0.0, 0.0, 100 + j))
        with open(model_dir / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(points)))
            for j, (p, t) in enumerate(zip(points, tracks)):
                f.write(struct.pack("<Q3d3BdQ", 100 + j, *p, 128, 128, 128,
                                    0.5, len(t)))
                for i in t:
                    f.write(struct.pack("<ii", i + 1, slot[i][j]))
        return
    with open(model_dir / "cameras.txt", "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i, k in enumerate(intrinsics):
            f.write(f"{i + 1} PINHOLE {w} {h} " + " ".join(
                repr(float(x)) for x in (k[0, 0], k[1, 1], k[0, 2], k[1, 2]))
                + "\n")
    with open(model_dir / "images.txt", "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for i, (e, name) in enumerate(zip(extrinsics, names)):
            q, t = _rotmat_to_qvec(e[:3, :3]), e[:3, 3]
            f.write(f"{i + 1} " + " ".join(repr(float(x)) for x in (*q, *t))
                    + f" {i + 1} {name}\n")
            f.write(" ".join(f"0 0 {100 + j}" for j in seen[i]) + "\n")
    with open(model_dir / "points3D.txt", "w") as f:
        f.write("# POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        for j, (p, t) in enumerate(zip(points, tracks)):
            track = " ".join(f"{i + 1} {slot[i][j]}" for i in t)
            f.write(f"{100 + j} " + " ".join(repr(float(x)) for x in p)
                    + f" 128 128 128 0.5 {track}\n")


def _view_scores(images_sorted, centers, pid_to_xyz, theta0, sigma1, sigma2):
    """(V, V) symmetric view-selection scores over the shared points."""
    n = len(images_sorted)
    point_sets = [
        {int(p) for p in im.point3d_ids if p != -1 and int(p) in pid_to_xyz}
        for im in images_sorted
    ]
    score = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            shared = point_sets[i] & point_sets[j]
            if not shared:
                continue
            pts = np.array([pid_to_xyz[p] for p in shared])  # (S, 3)
            vi = centers[i] - pts
            vj = centers[j] - pts
            cos = np.einsum("sk,sk->s", vi, vj) / (
                np.linalg.norm(vi, axis=1) * np.linalg.norm(vj, axis=1) + 1e-12
            )
            theta = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            s = np.exp(-((theta - theta0) ** 2) / (2 * sigma**2)).sum()
            score[i, j] = score[j, i] = s
    return score


def _copy_image(src: Path, save: Path, i: int) -> Path:
    if src.suffix.lower() in (".jpg", ".jpeg"):
        dst = save / "images" / f"{i:08d}.jpg"
        shutil.copyfile(src, dst)
        return dst
    with open(src, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head != PNG_SIGNATURE:
        raise ValueError(f"{src}: only JPEG and PNG images are converted "
                         f"(mvs_tpu converts other formats through PIL)")
    img = read_png(src)
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :3] if img.shape[2] >= 3 else img[..., :1]
    dst = save / "images" / f"{i:08d}.png"
    write_png(dst, np.ascontiguousarray(
        np.broadcast_to(img, (*img.shape[:2], 3))))
    return dst


def convert_colmap(dense_folder, save_folder, max_d: int = 192,
                   interval_scale: float = 1.0, theta0: float = 5.0,
                   sigma1: float = 1.0, sigma2: float = 10.0,
                   min_ratio: float = 0.01, max_ratio: float = 0.1,
                   num_src: int = 10, copy_images: bool = True):
    """Writes the MVSNet layout; returns ([(depth_min, interval,
    num_depth, depth_max)] per view, the (V, V) score matrix)."""
    dense = Path(dense_folder)
    save = Path(save_folder)
    cams_k, images, point_ids, point_xyz = read_colmap_model(dense / "sparse")
    pid_to_xyz = {int(pid): point_xyz[k] for k, pid in enumerate(point_ids)}

    images_sorted = [images[k] for k in sorted(images)]
    n = len(images_sorted)
    extr = np.stack([
        np.block([[_qvec_to_rotmat(im.qvec), im.tvec[:, None]],
                  [np.zeros((1, 3)), np.ones((1, 1))]])
        for im in images_sorted
    ])
    centers = np.stack([-extr[i, :3, :3].T @ extr[i, :3, 3] for i in range(n)])

    ranges = []
    for i, im in enumerate(images_sorted):
        pts = np.array([
            pid_to_xyz[int(p)] for p in im.point3d_ids
            if p != -1 and int(p) in pid_to_xyz
        ])
        if len(pts) == 0:
            ranges.append((1.0, 1.0, max_d or 192, float(max_d or 192)))
            continue
        zs = np.sort((extr[i, :3, :3] @ pts.T + extr[i, :3, 3:4])[2])
        num_min = max(1, int(len(zs) * min_ratio))
        num_max = max(5, int(len(zs) * max_ratio))
        depth_min = float(zs[:num_min].mean())
        depth_max = float(zs[-num_max:].mean())
        if max_d == 0:
            # Hypotheses spaced so that adjacent planes move the principal
            # point about one pixel.
            k = cams_k[im.camera_id]
            p1 = np.linalg.inv(k) @ [k[0, 2], k[1, 2], 1.0] * depth_min
            p2 = np.linalg.inv(k) @ [k[0, 2] + 1.0, k[1, 2], 1.0] * depth_min
            step = np.linalg.norm(p2 - p1)
            depth_num = int(
                (1 / depth_min - 1 / depth_max)
                / (1 / depth_min - 1 / (depth_min + step))
            )
        else:
            depth_num = max_d
        interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
        ranges.append((depth_min, interval, depth_num, depth_max))

    score = _view_scores(images_sorted, centers, pid_to_xyz, theta0, sigma1,
                         sigma2)

    (save / "cams").mkdir(parents=True, exist_ok=True)
    pairs = []
    for i, im in enumerate(images_sorted):
        dmin, interval, dnum, dmax = ranges[i]
        write_cam_file(save / "cams" / f"{i:08d}_cam.txt", CameraParams(
            intrinsics=cams_k[im.camera_id].astype(np.float32),
            extrinsics=extr[i].astype(np.float32),
            depth_min=dmin, depth_interval=interval,
            num_depth=dnum, depth_max=dmax,
        ))
        order = np.argsort(score[i])[::-1][:num_src]
        pairs.append((i, [(int(k), float(score[i, k])) for k in order
                          if score[i, k] > 0]))
    write_pair_file(save / "pair.txt", pairs)

    if copy_images:
        (save / "images").mkdir(parents=True, exist_ok=True)
        for i, im in enumerate(images_sorted):
            src = dense / "images" / im.name
            if src.exists():
                _copy_image(src, save, i)
    return ranges, score


def main(argv=None):
    p = argparse.ArgumentParser(prog="mvs_tpu_torch colmap2mvsnet")
    p.add_argument("--dense_folder", required=True,
                   help="COLMAP workspace with sparse/ and images/")
    p.add_argument("--save_folder", required=True)
    p.add_argument("--max_d", type=int, default=192,
                   help="0 = derive from the inverse-depth pixel rule")
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--theta0", type=float, default=5.0)
    p.add_argument("--sigma1", type=float, default=1.0)
    p.add_argument("--sigma2", type=float, default=10.0)
    args = p.parse_args(argv)
    convert_colmap(args.dense_folder, args.save_folder, max_d=args.max_d,
                   interval_scale=args.interval_scale, theta0=args.theta0,
                   sigma1=args.sigma1, sigma2=args.sigma2)
    print(f"wrote MVSNet inputs to {args.save_folder}")


if __name__ == "__main__":
    main()
