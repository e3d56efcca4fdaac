"""The MVSNet, cascade, pyramid and point tasks (counterparts of
mvs_tpu.train.tasks' MVSNetTask, CascadeTask, PyramidTask and PointTask):
the batch layout each model trains on, its loss and its metrics. A
collated batch (io.dtu.collate_mvsnet, collate_cascade, collate_pyramid or
collate_point) goes to the device through batch_to_device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from mvs_tpu_torch.geometry.resize import resize_nearest
from mvs_tpu_torch.train.losses import (cascade_loss, map_of,
                                        masked_smooth_l1, ohem_smooth_l1,
                                        point_mvsnet_loss, pyramid_loss,
                                        take_rows)
from mvs_tpu_torch.train.metrics import interval_metrics, standard_metrics

__all__ = ["MVSNetTask", "CascadeTask", "PyramidTask", "PointTask",
           "batch_to_device"]

_BATCH_KEYS = ("imgs", "proj_matrices", "depth_values", "depth_gt", "mask",
               "intrinsics", "extrinsics", "depth_min", "depth_max",
               "depth_gt_levels", "mask_levels", "depth_start",
               "depth_interval", "xyz_mean", "xyz_std")


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
        """(loss, the standard metrics of the unrefined depth), over the
        rows the model's outputs hold (losses.map_of)."""
        out = self.forward(batch)
        est = out.get("refined_depth", out["depth"])
        with map_of(out) as shard:
            gt, mask = (take_rows(shard, batch[k])
                        for k in ("depth_gt", "mask"))
            if self.loss_name == "ohem":
                loss = ohem_smooth_l1(est, gt, mask, self.ohem_topk)
            else:
                loss = masked_smooth_l1(est, gt, mask)
            return loss, standard_metrics(out["depth"], gt, mask)


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
        with map_of(out) as shard:
            metrics = standard_metrics(
                out["depth"], take_rows(shard, batch["depth_gt"][last_stage]),
                take_rows(shard, batch["mask"][last_stage]))
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


@dataclasses.dataclass
class PointTask:
    """Point-MVSNet. batch: imgs (B, V, H, W, 3), intrinsics (B, V, 3, 3)
    at the images' resolution, extrinsics (B, V, 4, 4), depth_start and
    depth_interval (B,), depth_gt (B, H, W) at the images' resolution (0 =
    invalid), optionally xyz_mean / xyz_std (B, 3).

    num_depth: the coarse ladder's length; use_flow=False trains the coarse
    stage alone (the reference's first epochs)."""

    model: nn.Module
    num_depth: int = 48
    use_flow: bool = True

    def forward(self, batch: dict) -> dict:
        """Model outputs for the batch, in the model's current mode."""
        return self.model(batch["imgs"], batch["intrinsics"],
                          batch["extrinsics"], batch["depth_start"],
                          batch["depth_interval"], num_depth=self.num_depth,
                          xyz_mean=batch.get("xyz_mean"),
                          xyz_std=batch.get("xyz_std"),
                          use_flow=self.use_flow)

    def loss_and_metrics(self, batch: dict):
        """(loss, metrics): point_mvsnet_loss; the standard and interval
        metrics of the depth, and the coarse depth's interval metrics
        (prefix coarse_), each against the GT picked at its resolution
        (nearest, as the loss), mask gt > 0; and the loss's terms."""
        out = self.forward(batch)
        loss, parts = point_mvsnet_loss(out, batch["depth_gt"],
                                        batch["depth_interval"])
        iv = batch["depth_interval"]
        gt = resize_nearest(batch["depth_gt"], *out["depth"].shape[1:])
        mask = (gt > 0).float()
        metrics = standard_metrics(out["depth"], gt, mask)
        metrics.update(interval_metrics(out["depth"], gt, mask, iv))
        cgt = resize_nearest(batch["depth_gt"], *out["coarse_depth"].shape[1:])
        metrics.update(interval_metrics(out["coarse_depth"], cgt,
                                        (cgt > 0).float(), iv,
                                        prefix="coarse_"))
        metrics.update({k: v.detach() for k, v in parts.items()})
        return loss, metrics
