"""The MVSNet, cascade and pyramid tasks (counterparts of
mvs_tpu.train.tasks' MVSNetTask, CascadeTask and PyramidTask): the batch
layout each model trains on, its loss and its metrics. A collated batch
(io.dtu.collate_mvsnet, collate_cascade or collate_pyramid) goes to the
device through batch_to_device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from mvs_tpu_torch.train.losses import (cascade_loss, masked_smooth_l1,
                                        ohem_smooth_l1, pyramid_loss)
from mvs_tpu_torch.train.metrics import standard_metrics

__all__ = ["MVSNetTask", "CascadeTask", "PyramidTask", "batch_to_device"]

_BATCH_KEYS = ("imgs", "proj_matrices", "depth_values", "depth_gt", "mask",
               "intrinsics", "extrinsics", "depth_min", "depth_max",
               "depth_gt_levels", "mask_levels")


def batch_to_device(batch: dict, device) -> dict:
    """The model's keys of a collated batch as float32 tensors on `device`
    (nested stage dicts and level lists kept)."""
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, list):
            return [move(v) for v in x]
        return torch.as_tensor(np.asarray(x, np.float32)).to(device)

    return {k: move(batch[k]) for k in _BATCH_KEYS if k in batch}


@dataclasses.dataclass
class MVSNetTask:
    """batch: imgs (B, V, H, W, 3), proj_matrices (B, V, 4, 4) at 1/4
    resolution, depth_values (B, D), depth_gt and mask (B, H/4, W/4).

    loss_name: 'smooth_l1' (masked) or 'ohem' (ohem_smooth_l1 over the
    hardest ohem_topk of the valid pixels); the loss reads refined_depth
    when the model refines, the metrics read depth."""

    model: nn.Module
    loss_name: str = "smooth_l1"
    ohem_topk: float = 0.6

    def __post_init__(self):
        if self.loss_name not in ("smooth_l1", "ohem"):
            raise ValueError(f"unknown loss {self.loss_name!r}")

    def forward(self, batch: dict) -> dict:
        """Model outputs for the batch, in the model's current mode."""
        return self.model(batch["imgs"], batch["proj_matrices"],
                          batch["depth_values"])

    def loss_and_metrics(self, batch: dict):
        """(loss, the standard metrics of the unrefined depth)."""
        out = self.forward(batch)
        est = out.get("refined_depth", out["depth"])
        if self.loss_name == "ohem":
            loss = ohem_smooth_l1(est, batch["depth_gt"], batch["mask"],
                                  self.ohem_topk)
        else:
            loss = masked_smooth_l1(est, batch["depth_gt"], batch["mask"])
        return loss, standard_metrics(out["depth"], batch["depth_gt"],
                                      batch["mask"])


@dataclasses.dataclass
class CascadeTask:
    """batch: imgs (B, V, H, W, 3), proj_matrices {stageK: (B, V, 4, 4)},
    depth_values (B, D), depth_gt and mask {stageK: (B, h_k, w_k)}."""

    model: nn.Module
    stage_weights: Any = (0.5, 1.0, 2.0)

    def forward(self, batch: dict) -> dict:
        """Model outputs for the batch, in the model's current mode."""
        return self.model(batch["imgs"], batch["proj_matrices"],
                          batch["depth_values"])

    def loss_and_metrics(self, batch: dict):
        """(loss, metrics): the stage-weighted cascade loss, and the last
        stage's standard metrics with its loss as 'last_stage_loss'."""
        out = self.forward(batch)
        loss, last = cascade_loss(out, batch["depth_gt"], batch["mask"],
                                  self.stage_weights)
        last_stage = f"stage{len(self.stage_weights)}"
        metrics = standard_metrics(out["depth"],
                                   batch["depth_gt"][last_stage],
                                   batch["mask"][last_stage])
        metrics["last_stage_loss"] = last.detach()
        return loss, metrics


@dataclasses.dataclass
class PyramidTask:
    """CVP / AACVP. batch: imgs (B, V, H, W, 3), intrinsics (B, V, 3, 3) at
    the images' resolution, extrinsics (B, V, 4, 4), depth_min and
    depth_max (B,), depth_gt_levels and mask_levels (finest first)."""

    model: nn.Module

    def forward(self, batch: dict) -> dict:
        """Model outputs for the batch, in the model's current mode."""
        return self.model(batch["imgs"], batch["intrinsics"],
                          batch["extrinsics"], batch["depth_min"],
                          batch["depth_max"])

    def loss_and_metrics(self, batch: dict):
        """(loss, metrics): the pyramid loss over the model's levels that
        the GT pyramid has (zipped, as mvs_tpu's: a model with more levels
        than the collate made leaves its coarsest ones unsupervised), and
        the finest level's standard metrics."""
        out = self.forward(batch)
        n = len(out["depth_levels"])
        loss = pyramid_loss(out["depth_levels"],
                            batch["depth_gt_levels"][:n],
                            batch["mask_levels"][:n])
        return loss, standard_metrics(out["depth"],
                                      batch["depth_gt_levels"][0],
                                      batch["mask_levels"][0])
