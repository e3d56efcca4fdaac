"""Fuse per-view depth maps into one PLY per scan (counterpart of
mvs_tpu.cli.fuse).

    python -m mvs_tpu_torch.cli fuse --out outputs/ [--scan scanX] \\
        [--device cpu] [section.key=value ...]

Reads the layout cli.infer writes (depth_est/, confidence/, cams/, images/)
and the scan's pair.txt, runs the photometric + geometric consistency fuser
(fusion.fuse_scene, on the card) and writes <scan>/fused.ply.

Scans are streamed: one scan is on the card at a time, while one host
thread first writes the previous scan's cloud (compaction + PLY) and then
loads the next scan, so at most two scans are held on the host per card.
Without --device every visible card fuses (fuse_scans: scan i on card
i mod n, one such stream per card; the counterpart of mvs_tpu's
scan-parallel fuse_scans_parallel over jax.devices(), which loads every scan
first); with one card it is the single stream.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mvs_tpu_torch.fusion import FusionConfig, compact_points, fuse_scene
from mvs_tpu_torch.io.cams import read_cam_file
from mvs_tpu_torch.io.dtu import image_path, read_image, resize_bilinear
from mvs_tpu_torch.io.pairs import read_pair_file
from mvs_tpu_torch.io.pfm import read_pfm
from mvs_tpu_torch.io.ply import write_ply
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.platform import resolve_device

__all__ = ["main", "fuse_scan_dir", "fuse_scans", "load_scan_arrays",
           "write_scan_cloud", "visible_cards"]


def _load_image(scan_dir: Path, vid: int):
    try:
        path = image_path(scan_dir, vid)
    except FileNotFoundError:  # fusion runs without colours
        return None
    return read_image(path)


def load_scan_arrays(scan_dir: Path, pair_path: Path) -> dict:
    """Read one scan's fusion inputs from the cli.infer layout; pairs are
    remapped to indices into the scan's sorted view ids."""
    scan_dir = Path(scan_dir)
    pairs = read_pair_file(pair_path)
    view_ids = sorted(int(p.stem)
                      for p in (scan_dir / "depth_est").glob("*.pfm"))
    id_map = {vid: i for i, vid in enumerate(view_ids)}

    depths, confs, images, intr, extr = [], [], [], [], []
    for vid in view_ids:
        depths.append(read_pfm(scan_dir / "depth_est" / f"{vid:08d}.pfm")[0])
        confs.append(read_pfm(scan_dir / "confidence" / f"{vid:08d}.pfm")[0])
        cam = read_cam_file(scan_dir / "cams" / f"{vid:08d}_cam.txt")
        images.append(_load_image(scan_dir, vid))
        intr.append(cam.intrinsics)
        extr.append(cam.extrinsics)

    depths = np.stack(depths)
    h, w = depths.shape[1:]
    confs = np.stack([c if c.shape == (h, w) else resize_bilinear(c, h, w)
                      for c in confs])
    have_imgs = all(im is not None for im in images)
    if have_imgs:
        images = np.stack([im if im.shape[:2] == (h, w)
                           else resize_bilinear(im, h, w) for im in images])
    # cli.infer writes the cams at depth-map resolution, so each (depth, K)
    # pair is consistent here by contract.
    remapped = [(id_map[r], [id_map[s] for s in srcs if s in id_map])
                for r, srcs in pairs if r in id_map]
    return {
        "name": scan_dir.name,
        "dir": scan_dir,
        "depths": depths,
        "confs": confs,
        "images": images if have_imgs else None,
        "intr": np.stack(intr),
        "extr": np.stack(extr),
        "pairs": remapped,
    }


def _fuse(scan: dict, fcfg: FusionConfig, device):
    return fuse_scene(scan["depths"], scan["confs"], scan["intr"],
                      scan["extr"], scan["pairs"], fcfg, device)


def write_scan_cloud(scan: dict, mask, world, out_path=None) -> Path:
    """Host compaction of one scan's accepted points + PLY write."""
    xyz, rgb = compact_points(mask, world, scan["images"], scan["pairs"])
    out_path = Path(out_path or (scan["dir"] / "fused.ply"))
    write_ply(out_path, xyz, rgb=rgb)
    print(f"{scan['name']}: {len(xyz)} points -> {out_path}")
    return out_path


def fuse_scan_dir(scan_dir: Path, pair_path: Path, fusion_cfg: FusionConfig,
                  out_path: Path | None = None, device=None) -> Path:
    """Fuse one scan directory into its PLY."""
    scan = load_scan_arrays(scan_dir, pair_path)
    return write_scan_cloud(scan, *_fuse(scan, fusion_cfg, device), out_path)


def _stream(jobs, fcfg: FusionConfig, device) -> list[Path]:
    """Fuse `jobs` in order on one device: the device fuses scan i while one
    host thread writes scan i-1's cloud and then loads scan i+1."""
    writes = []
    if not jobs:
        return writes
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(load_scan_arrays, *jobs[0])
        for i in range(len(jobs)):
            scan = pending.result()
            if i + 1 < len(jobs):
                pending = pool.submit(load_scan_arrays, *jobs[i + 1])
            writes.append(pool.submit(write_scan_cloud, scan,
                                      *_fuse(scan, fcfg, device)))
            del scan  # the queued write holds it until it is written

        return [w.result() for w in writes]


def visible_cards() -> list:
    """Every visible CUDA card (raises when there is none)."""
    resolve_device(None)
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def fuse_scans(jobs, fcfg: FusionConfig, devices=None) -> list[Path]:
    """Fuse many scans, jobs = [(scan_dir, pair_path), ...], scan-parallel:
    scan i goes to devices[i mod n] (default: every visible card; one
    device or a list), and each device runs its own stream of scans
    (_stream), on a thread of its own. Returns the PLY paths in job order."""
    if devices is None:
        devices = visible_cards()
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if n == 1:
        return _stream(jobs, fcfg, devices[0])
    with ThreadPoolExecutor(max_workers=n) as pool:
        parts = [pool.submit(_stream, jobs[k::n], fcfg, devices[k])
                 for k in range(n)]
        paths = [None] * len(jobs)
        for k, part in enumerate(parts):
            paths[k::n] = part.result()
    return paths


def main(argv=None) -> list[Path]:
    """Run the CLI; returns the PLY paths written."""
    p = argparse.ArgumentParser(prog="mvs_tpu_torch fuse")
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="outputs")
    p.add_argument("--scan", default=None)
    p.add_argument("--pair", default=None, help="pair.txt (defaults per scan)")
    p.add_argument("--device", default=None,
                   help="torch device (default: every visible CUDA card)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    devices = visible_cards() if args.device is None else [args.device]
    fcfg = FusionConfig(
        conf_thresh=cfg.fusion.conf_thresh,
        num_consistent=cfg.fusion.num_consistent,
        pixel_thresh=cfg.fusion.pixel_thresh,
        depth_thresh=cfg.fusion.depth_thresh,
        depth_mode=cfg.fusion.depth_mode,
    )

    out_root = Path(args.out)
    scans = [args.scan] if args.scan else sorted(
        d.name for d in out_root.iterdir() if (d / "depth_est").is_dir())

    def pair_for(scan):
        if args.pair:
            return Path(args.pair)
        for cand in (out_root / scan / "pair.txt",
                     Path(cfg.data.eval_root) / scan / "pair.txt",
                     Path(cfg.data.eval_root) / "pair.txt"):
            if cand.exists():
                return cand
        raise FileNotFoundError(f"no pair.txt found for {scan}")

    return fuse_scans([(out_root / s, pair_for(s)) for s in scans], fcfg,
                      devices)


if __name__ == "__main__":
    main()
