"""Profiling: warm-up, then traced steps under torch.profiler (counterpart
of mvs_tpu.cli.profile).

    python -m mvs_tpu_torch.cli profile [--logdir runs/profile] [--steps 5]
        [--warmup 3] [--train] [--device cpu]

The work is mvs_tpu's __graft_entry__.entry(): CasMVSNet with 8/8/8
hypotheses, a 64x64 three-view plane scene, batch 1, the Flax modules'
initial weights drawn from seed 0; the forward as `cli infer` runs it
(cli.infer.make_apply_fn: eval mode, no autograd, f32 convolutions
without TF32), or with --train one CasMVSNet train step (Adam, the
cascade loss) on the one device; under torchrun with more than one rank,
--train traces parallel.dryrun's step (CasMVSNet 48 / 32 / 8 over every
rank, the ranks split over view, space, depth and data as mvs_tpu's
dry run splits devices), each rank writing its own trace. The traced
loop writes a Chrome trace, <logdir>/trace.json (trace_rank<r>.json under
ranks; open it in ui.perfetto.dev or chrome://tracing),
prints "N steps traced ... ms/step (... depth-maps/s)" (host clock,
synchronised), then the traced steps' top device kernels by device ms and
the port's hand-written kernels among all of them (on the CPU: the top
operators by CPU ms).
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from mvs_tpu_torch.cli.infer import make_apply_fn
from mvs_tpu_torch.geometry import compose_projection, scale_intrinsics
from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.parallel import dryrun
from mvs_tpu_torch.parallel.distributed import (maybe_initialize_distributed,
                                                shutdown)
from mvs_tpu_torch.train.optim import OptaxChain
from mvs_tpu_torch.train.state import make_train_step
from mvs_tpu_torch.train.tasks import CascadeTask
from mvs_tpu_torch.utils.platform import resolve_device
from mvs_tpu_torch.utils.synthetic import make_plane_scene

__all__ = ["main", "example_batch"]


def example_batch(device, batch_size: int = 1, height: int = 64,
                  width: int = 64, num_views: int = 3,
                  num_depth: int = 32) -> dict:
    """__graft_entry__._example_batch's CasMVSNet batch on `device`: plane
    scenes of seeds 0.., per-stage projections at 1/4, 1/2 and 1, the
    8..12 ladder, the reference depth per stage as GT, mask gt > 0."""
    scenes = [make_plane_scene(num_views=num_views, height=height,
                               width=width, z0=10.0, seed=s)
              for s in range(batch_size)]
    intr = torch.from_numpy(np.stack([s.intrinsics for s in scenes]))
    extr = torch.from_numpy(np.stack([s.extrinsics for s in scenes]))
    stages = ("stage1", "stage2", "stage3")
    gt = {k: torch.from_numpy(np.stack([s.depths[0][::f, ::f]
                                        for s in scenes]).astype(np.float32))
          for k, f in zip(stages, (4, 2, 1))}
    batch = {
        "imgs": torch.from_numpy(np.stack([s.images for s in scenes])),
        "proj_matrices": {k: compose_projection(scale_intrinsics(intr, f),
                                                extr)
                          for k, f in zip(stages, (0.25, 0.5, 1.0))},
        "depth_values": torch.linspace(8.0, 12.0, num_depth).expand(
            batch_size, num_depth).contiguous(),
        "depth_gt": gt,
        "mask": {k: (v > 0).float() for k, v in gt.items()},
    }

    def move(x):
        return {k: move(v) for k, v in x.items()} if isinstance(x, dict) \
            else x.to(device)

    return move(batch)


# Name stems of the port's hand-written kernels (mvs_tpu_torch/csrc).
_PORT_KERNELS = ("warp_variance", "conv3d_", "group_correlation")


def _top_table(prof, on_card: bool, rows: int = 20) -> list[str]:
    """The traced steps' top device kernels by device ms (CUPTI), then the
    port's hand-written kernels among them, or on the CPU the top operators
    by self CPU ms."""
    if on_card:
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3
        kind = "device kernels by device ms"
    else:
        by_name = {e.key: e.self_cpu_time_total / 1e3
                   for e in prof.key_averages()}
        kind = "operators by self CPU ms"
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    table = [f"top {kind}:"] + [f"  {ms:10.4f} ms  {name[:120]}"
                                for name, ms in ranked[:rows]]
    if on_card:
        table += ["hand-written kernels (mvs_tpu_torch/csrc):"] + [
            f"  {ms:10.4f} ms  {name[:120]}" for name, ms in ranked
            if any(stem in name for stem in _PORT_KERNELS)]
    return table


def main(argv=None) -> dict:
    """Run the CLI. Returns {"ms_per_step", "trace", "table"}."""
    p = argparse.ArgumentParser(prog="mvs_tpu_torch profile")
    p.add_argument("--logdir", default="runs/profile")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--train", action="store_true",
                   help="profile a CasMVSNet train step instead of the "
                        "forward: on the one device, or under torchrun "
                        "with more than one rank parallel.dryrun's step "
                        "over every rank")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)
    if args.train and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return _profile_dryrun(args)
    device = resolve_device(args.device)
    return _profile(args, device)


def _profile_dryrun(args) -> dict:
    """--train over ranks: parallel.dryrun's step, traced on every rank."""
    proc = maybe_initialize_distributed(args.device)
    try:
        dry = dryrun.build_step(proc.device, proc.world_size)
        return _profile(args, proc.device, dry, proc.rank)
    finally:
        shutdown()


def _profile(args, device, dry=None, rank=None) -> dict:
    """Warm up, then trace args.steps of: dry's step (a (step, mesh shape)
    pair from parallel.dryrun), else the forward or with --train one
    CasMVSNet train step on `device`."""
    on_card = device.type == "cuda"
    lead = rank in (None, 0)
    if dry is not None:
        step = dry[0]
    else:
        model = CasMVSNet(ndepths=(8, 8, 8),
                          generator=torch.Generator().manual_seed(0),
                          trained=False).to(device)
        batch = example_batch(device)
        if args.train:
            run = make_train_step(CascadeTask(model), OptaxChain(
                model.parameters(), "adam", lambda step: 1e-3))
            step = lambda: run(batch)  # noqa: E731
        else:
            apply_fn = make_apply_fn(model, device)

            def step():
                return apply_fn(batch["imgs"], batch["proj_matrices"],
                                batch["depth_values"])

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    for _ in range(args.warmup):
        step()
    sync()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        sync()
        dt = (time.perf_counter() - t0) / args.steps
    logdir = Path(args.logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    trace = logdir / ("trace.json" if rank is None else
                      f"trace_rank{rank}.json")
    prof.export_chrome_trace(str(trace))
    what = "train steps" if args.train else "steps"
    table = _top_table(prof, on_card)
    # Every rank takes the last step: its collectives need them all.
    last = None if dry is None else dryrun.describe(
        dry[1], float(step()["loss"]))
    if lead:
        if last is not None:
            print(last)
        print(f"{args.steps} {what} traced to {logdir}; {dt * 1e3:.2f} "
              f"ms/step ({1.0 / dt:.2f} depth-maps/s)")
        print("\n".join(table))
    return {"ms_per_step": dt * 1e3, "trace": str(trace), "table": table}


if __name__ == "__main__":
    main()
