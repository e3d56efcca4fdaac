"""The train step (counterpart of mvs_tpu.train.state.make_train_step): the
forward in train mode, the task's loss, the backward pass and one update of
the optimizer chain, with the schedule read at the update count.

The model and the chain's state live on one explicit device; the step runs
there. float32 convolutions and matrix products run at float32 precision
(utils.platform.full_f32), as on the CPU.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from mvs_tpu_torch.train.optim import OptaxChain
from mvs_tpu_torch.utils.platform import full_f32

__all__ = ["make_train_step", "make_eval_step"]


def make_train_step(task, optimizer: OptaxChain,
                    mark: Callable[[str], None] | None = None
                    ) -> Callable[[dict], dict]:
    """step(batch) -> metrics (0-d tensors on the device: the loss and the
    task's metrics), after one update of task.model's parameters and
    BatchNorm statistics.

    `mark`, when given, is called with "start", "forward", "backward" and
    "optimizer" as the step reaches the end of each part on the host (a
    caller records CUDA events there to split the step's device time)."""
    params = optimizer.params
    mark = mark or (lambda name: None)

    def step(batch: dict) -> dict:
        task.model.train()
        mark("start")
        with full_f32():
            loss, metrics = task.loss_and_metrics(batch)
            mark("forward")
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        mark("backward")
        optimizer.step(grads)
        mark("optimizer")
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        return metrics

    return step


def make_eval_step(task) -> Callable[[dict], dict]:
    """step(batch) -> metrics with 'loss', in eval mode without autograd
    (the validation pass)."""
    def step(batch: dict) -> dict:
        task.model.eval()
        with torch.no_grad(), full_f32():
            loss, metrics = task.loss_and_metrics(batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step
