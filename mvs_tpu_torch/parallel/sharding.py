"""How the global batch, the parameters and the optimizer state lie on the
ranks (counterpart of mvs_tpu.parallel.sharding, the parts that carry over
to torch.distributed).

  * ``replicate``: rank 0's parameters, buffers and optimizer state
    broadcast to every rank;
  * ``row_slice``: the rows of a global batch that data rank r of n takes,
    [r B / n, (r + 1) B / n) (the loader's rule too, io.pipeline);
  * ``shard_batch``: a data rank's rows of a collated global batch.

mvs_tpu's ShardingPlan, with its data_parallel_plan and its constrain_*
hooks (volume, scores and view-stack sharding constraints, with the
small-extent guard), serves depth and space sharding, which waits with
them (ROADMAP.md queue 1, item 20): under pure data parallelism a rank's
rows are the whole plan.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mvs_tpu_torch.parallel.mesh import Mesh

__all__ = ["replicate", "shard_batch", "row_slice"]


def row_slice(batch_size: int, shard: tuple[int, int]) -> slice:
    """Data rank r's rows of a global batch of `batch_size`, shard = (r, n);
    raises unless the n data ranks take equal rows."""
    r, n = shard
    if batch_size % n or not 0 <= r < n:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{n} data ranks (rank {r})")
    per = batch_size // n
    return slice(r * per, (r + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """This data rank's rows of every array or tensor in a (nested) collated
    batch; non-array leaves are kept."""
    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, list):
            return [rows(v) for v in x]
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
            return x[row_slice(x.shape[0], (mesh.coord("data"),
                                              mesh.size("data")))]
        return x

    return rows(batch)


@torch.no_grad()
def replicate(model: torch.nn.Module, optimizer=None, src: int = 0) -> None:
    """Broadcast rank `src`'s parameters, buffers and (an OptaxChain's)
    optimizer state to every rank, in place; a no-op in a single
    process."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        tensors += [s for slot in optimizer.slots for s in slot]
        count = torch.tensor([optimizer.count], dtype=torch.float64,
                             device=tensors[0].device)
        dist.broadcast(count, src)
        optimizer.count = int(count.item())
    for t in tensors:
        dist.broadcast(t.data, src)
