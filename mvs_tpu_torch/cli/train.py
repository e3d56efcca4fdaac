"""Training of MVSNet, CasMVSNet, CVP-MVSNet, AACVP-MVSNet and
Point-MVSNet (counterpart of mvs_tpu.cli.train, one card).

    python -m mvs_tpu_torch.cli train --config configs/cas_train_dtu.yaml \
        [--resume] [--device cpu] [section.key=value ...]
    python -m mvs_tpu_torch.cli train --config configs/cvp_train_dtu.yaml \
        [model.name=aacvp_mvsnet] ...

`model.name` picks the task and the collate as mvs_tpu's
build_model_and_task does: mvsnet trains MVSNetTask (``train.loss``
smooth_l1 or ohem) on collate_mvsnet's batches, cas_mvsnet CascadeTask on
collate_cascade's, cvp_mvsnet and aacvp_mvsnet PyramidTask on
collate_pyramid's (with its default 2 levels, as mvs_tpu takes it by name:
a model with more levels is supervised on its two finest), point_mvsnet
PointTask (``model.num_depth_coarse`` hypotheses) on collate_point's. One
loop: the
preprocessed-DTU training split
(io.dtu.DTUTrainDataset through the threaded io.pipeline.DataLoader), the
train step (forward in train mode, the task's loss, backward, the
optimizer chain of train.optim with the schedule of train.schedule),
JSONL/TensorBoard scalars every ``train.summary_every_steps``, then per
epoch: optional BatchNorm
recalibration (``train.bn_recal_batches``), a validation pass in eval mode
over ``data.val_list`` (lights (3,), as the JAX CLI), and every
``train.ckpt_every_epochs`` a checkpoint under <log_dir>/ckpt ranked by the
validation abs_depth_error (train.checkpoint). The est | gt | error panel
of sample 0 of the first validation batch, taken from that batch's
forward, goes to <log_dir>/images/ (utils.vis; never fatal). ``--resume`` restores the latest checkpoint.
The run is on the card unless --device names another; the model starts
from the Flax modules' initial state drawn from ``train.seed``. With
MVS_TPU_DEBUG_NANS=1 in the environment, autograd's anomaly detection is
on for the run, and a non-finite loss at a summary, or a backward that
yields NaN, raises FloatingPointError naming the step.

Several cards (or CPU processes) train one global batch of
``data.batch_size`` samples per step, as mvs_tpu does on its mesh:

    torchrun --nproc_per_node=N -m mvs_tpu_torch.cli train \
        --config configs/cas_train_dtu.yaml train.mesh_data=N ...

Each process initialises torch.distributed from torchrun's variables
(parallel.distributed: its card is cuda:LOCAL_RANK, NCCL; with --device
naming one card for every rank, or the CPU, gloo) and takes its point of
the mesh data x view x depth x space (train.mesh_data = 0: the world size
over the other axes). A data rank loads its rows of each global batch
(io.pipeline), and the train step is the global batch's
(train.state.make_train_step: global BatchNorm moments, global masked
losses and metrics, gradients summed over the ranks). With
train.mesh_view > 1, MVSNet and CasMVSNet split their source views over
the 'view' ranks (parallel.make_view_variance); with train.mesh_depth or
train.mesh_space > 1 they split each cost volume into depth slabs and
row tiles as mvs_tpu's volume_sharded_plan and its small-extent guard lay
them out (parallel.sharding: halo exchanges, BatchNorm moments and the
softmax over the split volume, rank 0 saying each volume's layout with
the guard's folds and drops). The other families compute the same rows on
every rank of a view, depth and space group. Validation runs on the same
layout in eval mode. Rank 0 writes the checkpoints, their index and the
scalars; every rank restores.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np

import torch

from mvs_tpu_torch.io.dtu import (DTUTrainDataset, collate_cascade,
                                  collate_mvsnet, collate_point,
                                  collate_pyramid)
from mvs_tpu_torch.io.pipeline import DataLoader
from mvs_tpu_torch.models.registry import build_model
from mvs_tpu_torch.nn.blocks import BatchStats
from mvs_tpu_torch.parallel import (make_mesh, make_view_variance,
                                    maybe_initialize_distributed, replicate,
                                    shutdown, use_mesh, volume_sharded_plan)
from mvs_tpu_torch.geometry.resize import resize_nearest
from mvs_tpu_torch.parallel.mesh import mesh_shape_from_config
from mvs_tpu_torch.train.checkpoint import CheckpointManager
from mvs_tpu_torch.train.optim import OptaxChain
from mvs_tpu_torch.train.schedule import build_schedule
from mvs_tpu_torch.train.state import make_eval_step, make_train_step
from mvs_tpu_torch.train.tasks import (CascadeTask, MVSNetTask, PointTask,
                                      PyramidTask, batch_to_device)
from mvs_tpu_torch.utils.config import load_config
from mvs_tpu_torch.utils.meters import DictAverageMeter, ScalarLogger
from mvs_tpu_torch.utils.platform import full_f32
from mvs_tpu_torch.utils.vis import depth_image_summary

__all__ = ["main", "build_optimizer", "build_task", "read_scan_list",
           "recalibrate_bn"]


def read_scan_list(path) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def build_optimizer(cfg, params, steps_per_epoch: int) -> OptaxChain:
    """The chain mvs_tpu.cli.train.build_optimizer builds from cfg.train."""
    t = cfg.train
    return OptaxChain(params, t.optimizer, build_schedule(t, steps_per_epoch),
                      grad_clip=t.grad_clip, weight_decay=t.weight_decay)


@torch.no_grad()
def recalibrate_bn(task, batches, device) -> int:
    """Replace every BatchNorm's statistics by the equal-weight mean of the
    batch moments of train-mode forwards over `batches`, under the current
    parameters; count becomes 1 (the JAX CLI's recalibration from zero
    statistics). Under a current data-parallel mesh (parallel.use_mesh)
    each batch's moments are the global batch's. Returns the number of
    batches used."""
    norms = [m for m in task.model.modules() if isinstance(m, BatchStats)]
    sums = [[torch.zeros_like(m.mean), torch.zeros_like(m.var)]
            for m in norms]
    n = 0
    task.model.train()
    for batch in batches:
        for m in norms:
            m.count.zero_()  # the next update takes the batch's moments
        with full_f32():
            task.forward(batch_to_device(batch, device))
        for s, m in zip(sums, norms):
            s[0] += m.mean
            s[1] += m.var
        n += 1
    if n:
        for (mean, var), m in zip(sums, norms):
            m.mean.copy_(mean / n)
            m.var.copy_(var / n)
            m.count.fill_(1.0)
    return n


def build_task(cfg, model):
    """(task, collate) for `model`, chosen by model.name as mvs_tpu's
    build_model_and_task chooses them."""
    if cfg.model.name == "mvsnet":
        return (MVSNetTask(model, loss_name=cfg.train.loss,
                           ohem_topk=cfg.train.ohem_topk), collate_mvsnet)
    if cfg.model.name in ("cvp_mvsnet", "aacvp_mvsnet"):
        return PyramidTask(model), collate_pyramid
    if cfg.model.name == "point_mvsnet":
        return (PointTask(model, num_depth=cfg.model.num_depth_coarse),
                collate_point)
    return CascadeTask(model), collate_cascade


def main(argv=None) -> dict:
    """Run the CLI. Returns {"step", "losses" (every step's loss, host
    floats), "val" (the last validation metrics or None), "ckpt_dir",
    "seconds" (host time of the train steps)}."""
    p = argparse.ArgumentParser(prog="mvs_tpu_torch train")
    p.add_argument("--config", default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; under "
                        "torchrun cuda:LOCAL_RANK)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    started = not torch.distributed.is_initialized()
    proc = maybe_initialize_distributed(args.device)
    try:
        with _numerics_guard() as debug_nans:
            return _train(cfg, args, proc, debug_nans)
    finally:
        if started:
            shutdown()


@contextlib.contextmanager
def _numerics_guard():
    """MVS_TPU_DEBUG_NANS=1: autograd's anomaly detection for the run (in
    place of jax_debug_nans; the reference pins np.seterr(all='raise')).
    Yields whether it is on."""
    on = os.environ.get("MVS_TPU_DEBUG_NANS", "0") == "1"
    if not on:
        yield False
        return
    with torch.autograd.detect_anomaly(check_nan=True):
        yield True


def _summary_triplet(task, out: dict, batch: dict):
    """(depth_est, depth_gt, mask) of sample 0 at the estimate's
    resolution, as mvs_tpu's _summary_triplet picks them."""
    depth = out["depth"]
    rows = out["shard"].take if "shard" in out else (lambda x: x)
    if isinstance(task, MVSNetTask):
        return (depth[0], rows(batch["depth_gt"])[0],
                rows(batch["mask"])[0])
    if isinstance(task, CascadeTask):
        last = f"stage{len(task.stage_weights)}"
        return (depth[0], rows(batch["depth_gt"][last])[0],
                rows(batch["mask"][last])[0])
    if isinstance(task, PyramidTask):
        return (depth[0], batch["depth_gt_levels"][0][0],
                batch["mask_levels"][0][0])
    if isinstance(task, PointTask):
        gt = resize_nearest(batch["depth_gt"], *depth.shape[1:])
        return depth[0], gt[0], (gt[0] > 0).to(depth.dtype)
    raise TypeError(type(task))


def _log_val_images(task, out: dict, batch: dict, logger, step: int):
    """The est | gt | error panel of sample 0 of a validation batch, from
    the outputs of its eval-mode forward (rank 0's logger writes). Never
    fatal."""
    try:
        est, gt, mask = (np.asarray(x.float().cpu(), np.float32)
                         for x in _summary_triplet(task, out, batch))
        if (mask > 0.5).sum() == 0:
            return
        logger.log_image(step, "val/depth",
                         depth_image_summary(est, gt, mask))
    except Exception as e:  # noqa: BLE001 - a summary must not end a run
        print(f"val image summary skipped: {e}")


def describe_layout(layout) -> str:
    """The guard's decision on a volume (sharding.Guarded): its spec, with
    the axes it folded into another dim and those it dropped."""
    notes = [f"{axis!r} folded into dim {dim}" for axis, dim in layout.folded]
    notes += [f"{axis!r} dropped" for axis in layout.dropped]
    return f"spec {layout.spec}" + (f" ({', '.join(notes)})" if notes
                                    else "")


def volume_hook(plan, say):
    """plan.constrain_volume, saying each new volume shape's layout once."""
    seen = set()

    def constrain(shape):
        if tuple(shape[1:4]) not in seen:
            seen.add(tuple(shape[1:4]))
            say(f"volumes (B, {shape[1]}, {shape[2]}, {shape[3]}, C): "
                + describe_layout(plan.volume_layout(shape)))
        return plan.constrain_volume(shape)

    return constrain


def _train(cfg, args, proc, debug_nans: bool = False) -> dict:
    device, lead = proc.device, proc.rank == 0
    mesh = make_mesh(**mesh_shape_from_config(cfg.train, proc.world_size))
    d = cfg.data
    train_ds = DTUTrainDataset(d.root, read_scan_list(d.train_list),
                               num_views=d.num_views, num_depth=d.num_depth,
                               interval_scale=d.interval_scale)
    val_ds = DTUTrainDataset(
        d.root, read_scan_list(d.val_list), num_views=d.num_views,
        num_depth=d.num_depth, interval_scale=d.interval_scale,
        lights=(3,)) if d.val_list else None
    model = build_model(cfg, torch.Generator().manual_seed(cfg.train.seed),
                        trained=False).to(device)
    constrained = cfg.model.name in ("mvsnet", "cas_mvsnet")
    if mesh.size("view") > 1 and constrained:
        model.view_variance = make_view_variance(mesh)
    split = mesh.size("depth") * mesh.size("space") > 1
    say = print if lead else (lambda *a, **k: None)
    if split and constrained:
        model.volume_constraint = volume_hook(volume_sharded_plan(mesh), say)
    task, collate = build_task(cfg, model)
    shard = (mesh.coord("data"), mesh.size("data"))
    loader = DataLoader(train_ds, d.batch_size, collate,
                        num_threads=d.num_threads, seed=cfg.train.seed,
                        shard=shard)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(f"{len(train_ds)} training samples make no batch of "
                         f"{d.batch_size}")

    optimizer = build_optimizer(cfg, model.parameters(), steps_per_epoch)
    ckpt = CheckpointManager(
        f"{cfg.train.log_dir}/ckpt",
        best_metric="abs_depth_error" if val_ds is not None else None,
        writer=lead)
    logger = ScalarLogger(cfg.train.log_dir, enabled=lead)
    if mesh.world_size > 1:
        say(f"mesh {mesh.shape}: "
            + ("the source views split over the 'view' ranks"
               if getattr(model, "view_variance", None) is not None else
               "every source view on every rank")
            + ("" if not split else
               "; the volumes split over the 'depth' and 'space' ranks"
               if constrained else
               "; every 'depth' x 'space' rank computes the same rows"))

    start_epoch = 0
    if args.resume:
        restored = ckpt.restore("latest")
        if restored is not None:
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            start_epoch = optimizer.count // steps_per_epoch
            say(f"resumed at step {optimizer.count} (epoch {start_epoch})")
    replicate(model, optimizer)

    step_fn = make_train_step(task, optimizer, mesh=mesh)
    eval_fn = make_eval_step(task, mesh=mesh)
    losses, val_metrics, seconds = [], None, 0.0
    for epoch in range(start_epoch, cfg.train.epochs):
        meter = DictAverageMeter()
        t0 = time.perf_counter()
        for i, batch in enumerate(loader):
            try:
                metrics = step_fn(batch_to_device(batch, device))
            except RuntimeError as e:
                if debug_nans and "nan" in str(e).lower():
                    raise FloatingPointError(
                        f"NaN in the backward of step {optimizer.count + 1} "
                        f"(MVS_TPU_DEBUG_NANS=1): {e}") from e
                raise
            losses.append(metrics["loss"])
            if (i + 1) % cfg.train.summary_every_steps == 0:
                host = {k: float(v) for k, v in metrics.items()}
                if debug_nans and not np.isfinite(host["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {host['loss']} at step "
                        f"{optimizer.count} (MVS_TPU_DEBUG_NANS=1)")
                meter.update(host)
                rate = (i + 1) * d.batch_size / (time.perf_counter() - t0)
                logger.log(optimizer.count, host, prefix="train/")
                say(f"epoch {epoch} step {i + 1}/{steps_per_epoch} loss "
                    f"{host['loss']:.4f} ({rate:.2f} samples/s, global batch "
                    f"{d.batch_size} over {proc.world_size} process(es))")
        seconds += time.perf_counter() - t0
        logger.log(optimizer.count, meter.mean(), prefix="train_epoch/")

        if cfg.train.bn_recal_batches > 0:
            batches = (b for i, b in zip(range(cfg.train.bn_recal_batches),
                                         loader))
            with use_mesh(mesh):
                recalibrate_bn(task, batches, device)

        val_metrics = None
        if val_ds is not None:
            vmeter = DictAverageMeter()
            for bi, batch in enumerate(DataLoader(
                    val_ds, d.batch_size, collate, shuffle=False,
                    num_threads=d.num_threads, shard=shard)):
                batch = batch_to_device(batch, device)
                outs = []
                hook = task.model.register_forward_hook(
                    lambda m, a, out: outs.append(out)) if bi == 0 else None
                try:
                    metrics = eval_fn(batch)
                finally:
                    if hook is not None:
                        hook.remove()
                vmeter.update({k: float(v) for k, v in metrics.items()})
                if outs:
                    _log_val_images(task, outs[0], batch, logger,
                                    optimizer.count)
            val_metrics = vmeter.mean()
            logger.log(optimizer.count, val_metrics, prefix="val/")
            say(f"epoch {epoch} val: {val_metrics}")

        if (epoch + 1) % cfg.train.ckpt_every_epochs == 0:
            ckpt.save(optimizer.count, {"model": model.state_dict(),
                                        "optimizer": optimizer.state_dict()},
                      metrics=val_metrics)
    logger.close()
    return {"step": optimizer.count, "losses": [float(x) for x in losses],
            "val": val_metrics,
            "ckpt_dir": str(ckpt.dir), "seconds": seconds}


if __name__ == "__main__":
    main()
