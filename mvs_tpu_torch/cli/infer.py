"""Depth-map inference over a DTU eval split (counterpart of
mvs_tpu.cli.infer).

    python -m mvs_tpu_torch.cli infer --ckpt weights.pt --out outputs/ \
        [--step latest|best|N] [--config cfg.yaml] [--device cpu] \
        [section.key=value ...]

`--ckpt` is the port's state_dict (.pt), the JAX variables exported to .npz
(convert.load_weights), or a checkpoint directory of `train`
(train.checkpoint), from which `--step` picks the latest step, the best by
validation abs_depth_error (the latest when no step is ranked) or step N.
Besides the depth outputs, each reference image is written as
``<scan>/images/<ref>.png`` (lossless, no PIL needed; the JAX CLI writes
JPEG).

Samples are grouped into shape buckets and run ``batch_size`` reference
views per call; a ragged tail is padded by repeating its last sample and the
padded outputs are dropped. Outputs go to disk in the layout the fusion stage
reads: ``<scan>/depth_est/<ref>.pfm``, ``<scan>/confidence/<ref>.pfm`` and
``<scan>/cams/<ref>_cam.txt`` with the intrinsics at depth-map resolution.

A sample is a dict as the JAX eval dataset yields it: imgs (V, H, W, 3),
intrinsics (V, 3, 3), extrinsics (V, 4, 4), depth_values (D,), depth_min,
depth_max (CVP-MVSNet's range), and scan, ref_view, depth_interval for the
writer. The model (`model.name`: mvsnet, cas_mvsnet, cvp_mvsnet,
aacvp_mvsnet or point_mvsnet) picks which of them it takes. Point-MVSNet
also takes ``model.num_depth_coarse`` (model_static_kwargs), writes its
depth at half the images' resolution and, as its confidence, the coarse
2-tap probability map at 1/8 (`fuse` resizes it to the depth map).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from mvs_tpu_torch.convert import load_weights
from mvs_tpu_torch.geometry.projection import (compose_projection,
                                               scale_intrinsics)
from mvs_tpu_torch.io.cams import CameraParams, write_cam_file
from mvs_tpu_torch.io.dtu import DTUEvalDataset
from mvs_tpu_torch.io.pfm import write_pfm
from mvs_tpu_torch.io.png import write_png
from mvs_tpu_torch.models.registry import build_model
from mvs_tpu_torch.train.checkpoint import CheckpointManager
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.platform import full_f32, resolve_device

__all__ = ["main", "make_apply_fn", "model_static_kwargs",
           "stack_model_inputs", "run_batched_inference",
           "write_depth_outputs"]


def stack_model_inputs(samples, device, family: str = "cascade") -> tuple:
    """Stack same-shaped samples into a model family's inputs (the model's
    ``family``): MVSNet's (imgs, proj at 1/4 resolution, depth_values) for
    "single", CasMVSNet's (imgs, {stageK: proj}, depth_values) for
    "cascade", CVP-MVSNet's (imgs, intrinsics, extrinsics, depth_min,
    depth_max) for "pyramid", Point-MVSNet's (imgs, intrinsics,
    extrinsics, depth_min, depth_interval) for "point"."""
    def stack(key):
        return torch.from_numpy(
            np.stack([np.asarray(s[key], np.float32) for s in samples])
        ).to(device)

    intr, extr = stack("intrinsics"), stack("extrinsics")
    if family == "pyramid":
        return (stack("imgs"), intr, extr, stack("depth_min"),
                stack("depth_max"))
    if family == "point":
        return (stack("imgs"), intr, extr, stack("depth_min"),
                stack("depth_interval"))
    if family == "single":
        return (stack("imgs"),
                compose_projection(scale_intrinsics(intr, 0.25), extr),
                stack("depth_values"))
    if family != "cascade":
        raise ValueError(f"unknown model family {family!r}")
    proj = {f"stage{i + 1}": compose_projection(scale_intrinsics(intr, f), extr)
            for i, f in enumerate((0.25, 0.5, 1.0))}
    return stack("imgs"), proj, stack("depth_values")


def model_static_kwargs(cfg) -> dict:
    """The keyword arguments of a model's forward beyond the inputs
    stack_model_inputs builds: Point-MVSNet's coarse ladder length."""
    if cfg.model.name == "point_mvsnet":
        return {"num_depth": cfg.model.num_depth_coarse}
    return {}


def make_apply_fn(model, device=None, **static_kwargs):
    """The inference program: the model's inputs (stack_model_inputs) ->
    (depth, conf), conf the model's photometric_confidence or else its
    coarse_prob_map (Point-MVSNet's). `static_kwargs` go to every forward
    (model_static_kwargs).

    Moves `model` to `device` (the CUDA card unless the caller passes
    device='cpu') and runs it in eval mode without autograd. Its float32
    convolutions run in float32, not TF32 (utils.platform.full_f32).
    """
    device = resolve_device(device)
    model.to(device).eval()

    def to_device(x):
        if isinstance(x, dict):
            return {k: v.to(device) for k, v in x.items()}
        return x.to(device)

    @torch.inference_mode()
    def apply(*inputs):
        with full_f32():
            out = model(*map(to_device, inputs), **static_kwargs)
        return out["depth"], out.get("photometric_confidence",
                                     out.get("coarse_prob_map"))

    return apply


def run_batched_inference(model, samples_iter, batch_size: int, device=None,
                          **static_kwargs):
    """Yield (sample, depth (H, W), conf) numpy maps per sample (conf at
    the depth's resolution, Point-MVSNet's at 1/8 of the images)."""
    device = resolve_device(device)
    apply_fn = make_apply_fn(model, device, **static_kwargs)
    pending: dict[tuple, list] = {}

    def flush(bucket):
        batch = pending.pop(bucket)
        padded = batch + [batch[-1]] * (batch_size - len(batch))
        depth, conf = apply_fn(*stack_model_inputs(padded, device,
                                                   model.family))
        depth = depth.float().cpu().numpy()
        conf = conf.float().cpu().numpy()
        for j, s in enumerate(batch):
            yield s, depth[j], conf[j]

    for sample in samples_iter:
        key = np.asarray(sample["imgs"]).shape
        pending.setdefault(key, []).append(sample)
        if len(pending[key]) == batch_size:
            yield from flush(key)
    for key in list(pending):
        yield from flush(key)


def write_depth_outputs(out_root, sample, depth: np.ndarray, conf: np.ndarray,
                        num_depth: int) -> None:
    """Write one sample's depth/confidence PFMs and its cam file, with the
    reference intrinsics rescaled to the depth map's resolution."""
    scan_dir = Path(out_root) / sample["scan"]
    ref = sample["ref_view"]
    write_pfm(scan_dir / "depth_est" / f"{ref:08d}.pfm", depth)
    write_pfm(scan_dir / "confidence" / f"{ref:08d}.pfm", conf)
    img_h, img_w = np.asarray(sample["imgs"][0]).shape[:2]
    k = np.array(sample["intrinsics"][0], np.float64).copy()
    k[0] *= depth.shape[1] / img_w
    k[1] *= depth.shape[0] / img_h
    cam = CameraParams(
        intrinsics=k.astype(np.float32),
        extrinsics=np.asarray(sample["extrinsics"][0], np.float32),
        depth_min=float(sample["depth_min"]),
        depth_interval=float(sample["depth_interval"]),
        num_depth=num_depth, depth_max=float(sample["depth_max"]),
    )
    write_cam_file(scan_dir / "cams" / f"{ref:08d}_cam.txt", cam)


def _eval_scans(cfg) -> list[str]:
    """The scans of data.eval_list, else every directory of data.eval_root."""
    if cfg.data.eval_list:
        with open(cfg.data.eval_list) as f:
            return [line.strip() for line in f if line.strip()]
    return sorted(p.name for p in Path(cfg.data.eval_root).iterdir()
                  if p.is_dir())


def load_checkpoint_weights(path, step="latest"):
    """(state_dict, step): a checkpoint directory's `step` (latest | best |
    N), or a .pt / .npz file (step None)."""
    if not Path(path).is_dir():
        return load_weights(path), None
    ckpt = CheckpointManager(path, best_metric="abs_depth_error")
    which = ckpt.resolve(step)
    if which is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return ckpt.restore(which)["model"], which


def main(argv=None) -> dict:
    """Run the CLI; returns {"maps": n, "seconds": s, "step": the
    checkpoint step loaded or None}, with the count and the host time of
    the inference loop (disk reads and writes included)."""
    p = argparse.ArgumentParser(prog="mvs_tpu_torch infer")
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt", required=True,
                   help="state_dict .pt, JAX variables exported to .npz, or "
                        "a checkpoint directory of `train`")
    p.add_argument("--step", default="latest",
                   help="with a checkpoint directory: latest | best (lowest "
                        "val abs_depth_error) | <int>")
    p.add_argument("--out", default="outputs")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    device = resolve_device(args.device)

    model = build_model(cfg)
    weights, step = load_checkpoint_weights(args.ckpt, args.step)
    model.load_state_dict(weights)
    if step is not None:
        print(f"using checkpoint step {step} ({args.step})")
    ds = DTUEvalDataset(
        cfg.data.eval_root, _eval_scans(cfg), num_views=cfg.data.num_views,
        num_depth=cfg.data.num_depth, interval_scale=cfg.data.interval_scale,
        max_h=cfg.data.max_h, max_w=cfg.data.max_w, align=cfg.data.align)

    out_root = Path(args.out)
    total = len(ds)
    batch_size = max(1, cfg.data.batch_size)
    t0 = time.perf_counter()
    done = 0
    for sample, depth, conf in run_batched_inference(
            model, (ds[i] for i in range(total)), batch_size, device,
            **model_static_kwargs(cfg)):
        write_depth_outputs(out_root, sample, depth, conf, cfg.data.num_depth)
        img8 = (np.clip(sample["imgs"][0], 0, 1) * 255).astype(np.uint8)
        ref = sample["ref_view"]
        write_png(out_root / sample["scan"] / "images" / f"{ref:08d}.png",
                  img8)
        done += 1
        print(f"[{done}/{total}] {sample['scan']} view {ref}: "
              f"depth {depth.shape} conf mean {conf.mean():.3f}")
    dt = time.perf_counter() - t0
    print(f"inference: {total} depth maps in {dt:.1f}s "
          f"({total / dt:.2f} maps/s, batch {batch_size})")
    return {"maps": total, "seconds": dt, "step": step}


if __name__ == "__main__":
    main()
