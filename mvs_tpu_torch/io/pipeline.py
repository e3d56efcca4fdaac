"""Host-side data pipeline: shuffling and thread prefetch (counterpart of
mvs_tpu.io.pipeline.DataLoader, one host).

Batches are collated numpy dicts, decoded by background threads and yielded
in order; the caller moves them to the card (train.tasks.batch_to_device).
Epoch e visits the samples in np.random.default_rng(seed + e).permutation
order, drops a ragged last batch, and replaces a sample that fails to load
by a random other one, at most MAX_SAMPLE_RETRIES times.

``batch_size`` is the global batch. With ``shard=(r, n)`` (data rank r of
n, parallel.mesh) every rank draws the same permutation and loads only
its rows of each global batch (parallel.sharding.row_slice: [r B / n,
(r + 1) B / n)), so the n ranks' batches concatenated are the single
process's; a batch that does not split evenly raises. (mvs_tpu's multi-host loader gives each process a
contiguous slice of the permutation instead, which makes other batches:
a deliberate delta, ROADMAP.md section 3.)
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterator

import numpy as np

from mvs_tpu_torch.parallel.sharding import row_slice

__all__ = ["DataLoader"]

_PREFETCH = 2  # collated batches held ready ahead of the consumer
MAX_SAMPLE_RETRIES = 3


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = True, seed: int = 0, num_threads: int = 2,
                 shard: tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = row_slice(batch_size, shard)
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.epoch = 0

    def _get_sample(self, idx: int, rng: np.random.Generator):
        """One sample; a random other index when it fails to load."""
        for attempt in range(MAX_SAMPLE_RETRIES + 1):
            try:
                return self.dataset[int(idx)]
            except Exception:
                if attempt == MAX_SAMPLE_RETRIES:
                    raise
                idx = rng.integers(0, len(self.dataset))

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        self.epoch += 1
        nb = len(self)
        in_q: queue.Queue = queue.Queue()
        for bi in range(nb):
            in_q.put((bi, indices[bi * self.batch_size:
                                  (bi + 1) * self.batch_size][self.rows]))
        out_q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """A bounded put that gives up once the consumer has stopped, so
            no worker stays blocked holding a collated batch."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            rng = np.random.default_rng(self.seed + self.epoch * 7919)
            while not stop.is_set():
                try:
                    bi, idx = in_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = (bi, self.collate_fn(
                        [self._get_sample(i, rng) for i in idx]))
                except Exception as e:  # surfaced to the consumer
                    item = (bi, e)
                if not put_or_stop(item):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            results: dict[int, dict] = {}
            next_bi = 0
            for _ in range(nb):
                bi, batch = out_q.get()
                if isinstance(batch, Exception):
                    raise batch
                results[bi] = batch
                while next_bi in results:
                    yield results.pop(next_bi)
                    next_bi += 1
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=2.0)
