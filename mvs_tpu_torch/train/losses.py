"""Depth losses of the cascade (counterpart of mvs_tpu.train.losses:
smooth_l1, masked_smooth_l1, cascade_loss).

Pure functions of tensors with a {0, 1} float mask, safe under an
all-masked batch (0 / 0 guarded). The OHEM, pyramid and point losses wait
for their model families (ROADMAP.md queue 1, items 10-12).
"""

from __future__ import annotations

import torch

__all__ = ["smooth_l1", "masked_smooth_l1", "cascade_loss"]


def smooth_l1(err: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber: 0.5 e^2 / beta for |e| < beta, else |e| - beta/2."""
    abs_err = err.abs()
    return torch.where(abs_err < beta, 0.5 * err * err / beta,
                       abs_err - 0.5 * beta)


def masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean of `values` where `valid` (bool), 0 when nothing is valid."""
    mask = valid.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def masked_smooth_l1(depth_est, depth_gt, mask, beta: float = 1.0):
    return masked_mean(smooth_l1(depth_est - depth_gt, beta), mask > 0.5)


def cascade_loss(stage_outputs: dict, depth_gt_stages: dict,
                 mask_stages: dict, stage_weights=(0.5, 1.0, 2.0)):
    """sum_k w_k * masked smooth-L1 of stage k ('stage1'..'stageN' keys in
    every dict). Returns (total, last_stage_loss)."""
    total = last = 0.0
    for i, w in enumerate(stage_weights):
        key = f"stage{i + 1}"
        if key not in stage_outputs:
            continue
        last = masked_smooth_l1(stage_outputs[key]["depth"],
                                depth_gt_stages[key], mask_stages[key])
        total = total + w * last
    return total, last
