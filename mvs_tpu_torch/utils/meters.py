"""Metric aggregation and scalar logging (counterpart of
mvs_tpu.utils.meters).

DictAverageMeter averages dicts of scalars over updates; ScalarLogger
appends one JSON line per log call to <log_dir>/scalars.jsonl and, when
torch.utils.tensorboard imports, writes the same scalars to TensorBoard.
In a multi-process run only rank 0's logger writes (``enabled``).
log_image writes an (H, W, 3) uint8 image as <log_dir>/images/
<tag>_<step>.png through io.png, and to TensorBoard when it is there.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from mvs_tpu_torch.io.png import write_png

__all__ = ["DictAverageMeter", "ScalarLogger"]


class DictAverageMeter:
    def __init__(self):
        self.sums: dict[str, float] = {}
        self.count = 0

    def update(self, values: dict, n: int = 1):
        for k, v in values.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * n
        self.count += n

    def mean(self) -> dict:
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}


class ScalarLogger:
    def __init__(self, log_dir, use_tensorboard: bool = True,
                 enabled: bool = True):
        self.dir = Path(log_dir)
        self.enabled = enabled
        if not enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "scalars.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.dir))
            except Exception:
                self._tb = None

    def log(self, step: int, values: dict, prefix: str = ""):
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            key = f"{prefix}{k}"
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_image(self, step: int, tag: str, image, save_png: bool = True):
        """An (H, W, 3) uint8 image: TensorBoard when available, and a PNG
        under <log_dir>/images/ ('/' in the tag becomes '_')."""
        if not self.enabled:
            return
        image = np.asarray(image)
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")
        if save_png:
            safe = tag.replace("/", "_")
            write_png(self.dir / "images" / f"{safe}_{step:08d}.png", image)

    def close(self):
        if not self.enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
