"""Learning-rate schedules (counterpart of mvs_tpu.train.schedule): plain
functions from the update count to the learning rate, each the value of the
optax schedule the JAX package builds.

As optax does, the optimizer evaluates its schedule at the count before the
update, so the first update uses schedule(0).
"""

from __future__ import annotations

import math
from collections.abc import Callable

__all__ = ["parse_milestones", "multistep_lr", "warmup_multistep_lr",
           "warmup_cosine_lr", "poly_lr", "build_schedule"]

Schedule = Callable[[int], float]


def parse_milestones(spec: str) -> tuple[list[int], float]:
    """'10,12,14:2' -> ([10, 12, 14], 0.5). The divisor defaults to 2."""
    if ":" in spec:
        steps, divisor = spec.split(":")
        gamma = 1.0 / float(divisor)
    else:
        steps, gamma = spec, 0.5
    return [int(s) for s in steps.split(",") if s], gamma


def _piecewise(base_lr: float, boundaries: list[int], gamma: float):
    """optax.piecewise_constant_schedule: x gamma from each boundary on."""
    def schedule(step: int) -> float:
        lr = base_lr
        for b in sorted(boundaries):
            if step >= b:
                lr *= gamma
        return lr

    return schedule


def multistep_lr(base_lr: float, milestones: list[int], gamma: float,
                 steps_per_epoch: int = 1) -> Schedule:
    """Piecewise-constant decay at epoch milestones."""
    return _piecewise(base_lr, [m * steps_per_epoch for m in milestones],
                      gamma)


def warmup_multistep_lr(base_lr: float, milestones: list[int], gamma: float,
                        warmup_steps: int = 500,
                        warmup_factor: float = 1.0 / 3.0) -> Schedule:
    """Linear warmup from base_lr * factor over warmup_steps, then the
    multistep decay at `milestones` (in steps)."""
    decay = _piecewise(base_lr, milestones, gamma)

    def schedule(step: int) -> float:
        if step >= warmup_steps:
            return decay(step)
        alpha = min(step / max(warmup_steps, 1), 1.0)
        return decay(step) * (warmup_factor * (1 - alpha) + alpha)

    return schedule


def warmup_cosine_lr(base_lr: float, total_steps: int,
                     warmup_steps: int = 500) -> Schedule:
    """optax.warmup_cosine_decay_schedule(base_lr / 3, base_lr,
    warmup_steps, total_steps): linear warmup, then cosine decay to 0."""
    init, decay_steps = base_lr / 3.0, total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (init - base_lr) * frac + base_lr
        count = min(step - warmup_steps, decay_steps)
        return base_lr * 0.5 * (1 + math.cos(math.pi * count / decay_steps))

    return schedule


def poly_lr(base_lr: float, total_steps: int, poly_exp: float = 0.9,
            warmup_steps: int = 0) -> Schedule:
    """base_lr * (1 - step / total)^poly_exp, with an optional linear warmup
    from a third of it."""
    def schedule(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        lr = base_lr * (1.0 - frac) ** poly_exp
        if warmup_steps > 0:
            alpha = min(step / warmup_steps, 1.0)
            lr *= (1.0 / 3.0) * (1 - alpha) + alpha
        return lr

    return schedule


def build_schedule(train_cfg, steps_per_epoch: int) -> Schedule:
    """The schedule the train CLI picks from ``train.lr_schedule``: "poly"
    or "poly:<exp>", "cosine", else multistep epoch milestones
    ("10,12,14:2") with ``train.warmup_steps`` of warmup
    (mvs_tpu.cli.train.build_optimizer)."""
    spec = train_cfg.lr_schedule
    total = train_cfg.epochs * steps_per_epoch
    if spec.startswith("poly"):
        exp = float(spec.split(":")[1]) if ":" in spec else 0.9
        return poly_lr(train_cfg.lr, total, poly_exp=exp,
                       warmup_steps=train_cfg.warmup_steps)
    if spec.startswith("cosine"):
        warmup = min(train_cfg.warmup_steps, max(total // 10, 1))
        return warmup_cosine_lr(train_cfg.lr, total, warmup_steps=warmup)
    milestones, gamma = parse_milestones(spec)
    return warmup_multistep_lr(train_cfg.lr,
                               [m * steps_per_epoch for m in milestones],
                               gamma, warmup_steps=train_cfg.warmup_steps)
