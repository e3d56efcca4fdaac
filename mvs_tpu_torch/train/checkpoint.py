"""Checkpoints of a training run over torch.save (counterpart of
mvs_tpu.train.checkpoint, which uses orbax: the card's machine has none).

A checkpoint is ``<dir>/step_<N>.pt``, a dict with the model's state_dict,
the optimizer chain's state (its update count is the schedule's step), the
step and the metrics saved with it; ``<dir>/metrics.json`` indexes every
kept step's metrics. Files are written to a temporary name and renamed, so
a crash never leaves a half-written checkpoint under a real name.

Retention, after every save: the MAX_TO_KEEP best ranked steps (lowest
`best_metric`), the MAX_TO_KEEP newest unranked steps, and always the
latest step. A step is ranked when it was saved with
`best_metric` among its metrics; a save without metrics stays unranked and
`best_step` returns None while nothing is ranked. Unlike the JAX manager,
retention never deletes the latest checkpoint (ADVICE.md), so --resume
never rewinds past a val plateau.

In a multi-process run every rank calls ``save``: each waits at a barrier
(the ranks have finished the step being saved), then only the manager made
with ``writer=True`` (rank 0) writes, and the ranks wait again so that none
reads the directory before the checkpoint is there. Every rank restores.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from mvs_tpu_torch.parallel.distributed import barrier

__all__ = ["CheckpointManager", "MAX_TO_KEEP"]

MAX_TO_KEEP = 5


class CheckpointManager:
    def __init__(self, directory, best_metric: str | None = None,
                 writer: bool = True):
        self.dir = Path(directory).absolute()
        self.best_metric = best_metric
        self.writer = writer

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.pt"

    def _index(self) -> dict[int, dict | None]:
        path = self.dir / "metrics.json"
        if not path.exists():
            return {}
        return {int(k): v for k, v in json.loads(path.read_text()).items()}

    def _write_index(self, index: dict) -> None:
        tmp = self.dir / f"metrics.json.{os.getpid()}.tmp"
        tmp.write_text(json.dumps({str(k): v for k, v in sorted(
            index.items())}, indent=1))
        os.replace(tmp, self.dir / "metrics.json")

    def steps(self) -> list[int]:
        """Every kept step, oldest first."""
        return sorted(self._index())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _ranked(self, index: dict) -> list[int]:
        """Ranked steps, best first (ties: the newer first)."""
        if self.best_metric is None:
            return []
        ranked = [s for s, m in index.items()
                  if m is not None and self.best_metric in m]
        return sorted(ranked, key=lambda s: (index[s][self.best_metric], -s))

    def best_step(self) -> int | None:
        """The best ranked step, None when no step is ranked."""
        ranked = self._ranked(self._index())
        return ranked[0] if ranked else None

    def save(self, step: int, state: dict, metrics: dict | None = None):
        """Write `state` (tensors anywhere; saved as they are) with
        `metrics` (floats) as step `step`, then apply retention; between
        two barriers, and on the writer only."""
        barrier()
        if self.writer:
            self._save(step, state, metrics)
        barrier()

    def _save(self, step: int, state: dict, metrics: dict | None):
        self.dir.mkdir(parents=True, exist_ok=True)
        metrics = None if metrics is None else {
            k: float(v) for k, v in metrics.items()}
        tmp = self.dir / f"step_{step:08d}.pt.{os.getpid()}.tmp"
        torch.save({**state, "step": step, "metrics": metrics}, tmp)
        os.replace(tmp, self._path(step))
        index = self._index()
        index[step] = metrics
        ranked = self._ranked(index)
        unranked = sorted(set(index) - set(ranked), reverse=True)
        keep = set(ranked[:MAX_TO_KEEP]) | set(
            unranked[:MAX_TO_KEEP]) | {max(index)}
        for s in set(index) - keep:
            self._path(s).unlink(missing_ok=True)
            del index[s]
        self._write_index(index)

    def resolve(self, which) -> int | None:
        """'latest', 'best' (the latest when nothing is ranked) or a step
        number -> a kept step; None when nothing is saved."""
        if which == "latest":
            return self.latest_step()
        if which == "best":
            best = self.best_step()
            return self.latest_step() if best is None else best
        step = int(which)
        if step not in self._index():
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.dir}; kept: {self.steps()}")
        return step

    def restore(self, which="latest") -> dict | None:
        """The saved dict of `which` (see resolve), tensors on the CPU; None
        when nothing is saved."""
        step = self.resolve(which)
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
