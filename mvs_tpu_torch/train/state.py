"""The train step (counterpart of mvs_tpu.train.state.make_train_step): the
forward in train mode, the task's loss, the backward pass and one update of
the optimizer chain, with the schedule read at the update count.

The model and the chain's state live on one explicit device; the step runs
there. float32 convolutions and matrix products run at float32 precision
(utils.platform.full_f32), as on the CPU.

Under a mesh (parallel.make_mesh) the step is one step of the global batch,
as mvs_tpu's is under GSPMD: each rank holds its data rank's rows of the
batch, BatchNorm takes the global batch's moments, the masked losses and
metrics divide by global counts and OHEM ranks the global batch
(train.losses). The gradient rule:
  * each rank differentiates its share of the global loss (its masked sums
    over the global counts), divided by the size of its 'view' group: the
    ranks of a view group hold the same rows and compute the same share,
    and the all-reduce of the view shards' partial sums in the forward sums
    their cotangents in the backward;
  * every collective in the forward is autograd-aware
    (parallel.collectives.all_reduce);
  * the parameter gradients are then summed over all ranks, once, in one
    flat bucket (parallel.collectives.sum_gradients), before the optimizer
    step, so that every rank applies the same update.
With 'depth' and 'space' above 1, MVSNet and CasMVSNet split their
volumes (parallel.sharding): a rank builds, regularizes and regresses its
slab of each volume, and its maps are the rows it holds. Then:
  * a rank's share of a masked mean is its rows' masked sum over the count
    summed over the ranks whose rows make the global batch's maps, divided
    by the number of ranks that hold the same rows (train.losses): on a
    stage whose D is split that is |depth| (after the softmax's
    all-reduce the depth ranks hold the same rows), on CasMVSNet's stage
    3, where 'depth' is folded into H, 1, and for a family that does not
    split its volumes |depth| x |space|;
  * the halo exchanges, BatchNorm's moments and the softmax's sums are
    autograd-aware collectives too (parallel.halo, parallel.collectives);
  * the features, which the ranks of a sample's volume compute alike,
    enter the volume through parallel.collectives.shared: their cotangent
    is summed over those ranks in f32 and divided by their number, so that
    each rank runs the feature net's backward on the whole cotangent, as
    one process does (a backward on the rank's own slab's share, rounded
    in bf16 on its own, put a bf16 MVSNet step's update norm at 0.94 of
    one process's on an H100; with the sum it is within 0.4%). The view
    ranks' features enter the variance the same way, over the 'view'
    group (collectives.make_view_variance);
  * the parameter gradients are still summed over every rank, once; the
    metrics' shares sum over 'data' x 'depth' x 'space'.
It has four wrong forms, each held up by tests/test_torch_parallel.py or
tests/test_torch_volume_sharding.py: averaged gradients (DDP's rule: 1 /
world of the gradient), a loss without the 1 / |view| (|view| times the
gradient, the V-fold error mvs_tpu hit, mvs_tpu/models/cas_mvsnet.py:57-65),
a mean of the ranks' own means (a different loss wherever the ranks' mask
counts differ), and a share without the 1 / |depth| on the depth-split
stages (|depth| times those stages' gradient). torch.autograd.grad keeps
DDP's averaging reducer out of the way.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from mvs_tpu_torch.parallel.collectives import (metrics_group, psum_metrics,
                                                sum_gradients)
from mvs_tpu_torch.parallel.mesh import Mesh, use_mesh
from mvs_tpu_torch.train.optim import OptaxChain
from mvs_tpu_torch.utils.platform import full_f32

__all__ = ["make_train_step", "make_eval_step"]


def make_train_step(task, optimizer: OptaxChain,
                    mark: Callable[[str], None] | None = None,
                    mesh: Mesh | None = None) -> Callable[[dict], dict]:
    """step(batch) -> metrics (0-d tensors on the device: the loss and the
    task's metrics), after one update of task.model's parameters and
    BatchNorm statistics. With `mesh`, `batch` is this rank's rows of the
    global batch and the metrics are the global batch's.

    `mark`, when given, is called with "start", "forward", "backward" and
    "optimizer" as the step reaches the end of each part on the host (a
    caller records CUDA events there to split the step's device time)."""
    params = optimizer.params
    mark = mark or (lambda name: None)
    views = 1 if mesh is None else mesh.size("view")

    def step(batch: dict) -> dict:
        task.model.train()
        mark("start")
        with full_f32(), use_mesh(mesh):
            loss, metrics = task.loss_and_metrics(batch)
            mark("forward")
            grads = torch.autograd.grad(loss / views if views > 1 else loss,
                                        params, allow_unused=True)
        if mesh is not None and mesh.world_size > 1:
            grads = sum_gradients(grads, params)
        mark("backward")
        optimizer.step(grads)
        mark("optimizer")
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        return metrics if mesh is None else psum_metrics(
            metrics, metrics_group(mesh))

    return step


def make_eval_step(task, mesh: Mesh | None = None
                   ) -> Callable[[dict], dict]:
    """step(batch) -> metrics with 'loss', in eval mode without autograd
    (the validation pass); with `mesh`, the global batch's."""
    def step(batch: dict) -> dict:
        task.model.eval()
        with torch.no_grad(), full_f32(), use_mesh(mesh):
            loss, metrics = task.loss_and_metrics(batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics if mesh is None else psum_metrics(
            metrics, metrics_group(mesh))

    return step
