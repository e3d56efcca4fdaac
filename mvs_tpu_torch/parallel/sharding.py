"""How the global batch, the parameters, the optimizer state and the cost
volumes lie on the ranks (counterpart of mvs_tpu.parallel.sharding).

  * ``replicate``: rank 0's parameters, buffers and optimizer state
    broadcast to every rank;
  * ``row_slice``: the rows of a global batch that data rank r of n takes,
    [r B / n, (r + 1) B / n) (the loader's rule too, io.pipeline);
  * ``shard_batch``: a data rank's rows of a collated global batch;
  * ``guarded``: mvs_tpu's small-extent guard (ShardingPlan._guarded) as a
    pure function of axis names, with its one-time warnings; it returns
    the folds and drops it decided beside the spec;
  * ``ShardingPlan`` / ``volume_sharded_plan``: the plan's specs, and
    ``constrain_volume``, the models' hook: for a stage's (B, D, H, W, C)
    volume, the VolumeShard this rank holds under the guarded spec.

mvs_tpu pins a spec on the volume and lets GSPMD split it; here a rank
builds only its slab of each volume, and the reductions GSPMD inserted are
written out (parallel.halo, parallel.collectives). A dim split over n ranks
is split in units of 2^UNET_LEVELS planes, as even as they go (the first
ranks take one unit more), so that every slab stays aligned through the
U-Net's stride-2 levels; the guard keeps at least max(3, n) units.

The current volume (``use_volume``) tells the U-Net's blocks which slab
they convolve; the current map (``use_map``) tells the masked losses which
rows of a regressed (B, H, W) map this rank holds, over which ranks their
counts are summed, and by how many ranks the same rows are held.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mvs_tpu_torch.parallel.mesh import Mesh, current_mesh

logger = logging.getLogger(__name__)

# Axes already warned about, and axes folded into another dim's split
# (mvs_tpu.parallel.sharding's sets): the first drop and the first fold of
# each axis are said once.
_warned_axes: set[str] = set()
_folded_axes: set[str] = set()

UNET_LEVELS = 3  # stride-2 levels of UNetCostRegNet
_GUARDED = ("depth", "space")

__all__ = ["replicate", "shard_batch", "row_slice", "guarded", "Guarded",
           "ShardingPlan", "volume_sharded_plan",
           "Split", "VolumeShard", "MapShard", "slab_bounds", "use_volume",
           "current_volume", "use_map", "current_map", "default_map"]


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


# ---- the small-extent guard ---------------------------------------------------

class Guarded(NamedTuple):
    """The guard's decision: the guarded spec, the (axis, dim) pairs it
    folded an evicted axis into, and the axes it dropped."""
    spec: tuple
    folded: tuple
    dropped: tuple


def guarded(spec: tuple, shape: tuple, mesh_shape: dict,
            levels: int = UNET_LEVELS) -> Guarded:
    """mvs_tpu's ShardingPlan._guarded on a spec of axis names (each entry
    None, a name or a tuple of names) for a tensor of `shape` on a mesh of
    `mesh_shape` ({axis: size}): the same spec, in the same form, with the
    folds and drops that made it.

    A 'depth' or 'space' axis stays on its dim only while the dim's extent
    at the deepest stride-2 level, extent >> levels, is at least max(3, n)
    for the n ranks over the dim's axes ('depth' is evicted before 'space').
    An evicted axis is folded into an interior dim without 'data' or 'view'
    that can absorb it, the most-sharded first (logged once per axis), or
    dropped with a one-time warning."""
    def mesh_n(names):
        return int(np.prod([mesh_shape.get(a, 1) for a in names]))

    def fits(i, names):
        n = mesh_n(names)
        return n <= 1 or (shape[i] >> levels) >= max(3, n)

    entries: list[list] = []
    for axis in spec:
        if axis is None:
            entries.append([])
        elif isinstance(axis, (tuple, list)):
            entries.append([a for a in axis if mesh_shape.get(a, 1) > 1])
        else:
            entries.append([axis] if mesh_shape.get(axis, 1) > 1 else [])

    homeless: list[str] = []
    folded: list[tuple] = []
    for i, names in enumerate(entries):
        while any(a in _GUARDED for a in names) and not fits(i, names):
            victim = "depth" if "depth" in names else "space"
            names.remove(victim)
            homeless.append(victim)

    for victim in list(homeless):
        cands = [i for i in range(1, max(1, len(entries) - 1))
                 if not any(a in ("data", "view") for a in entries[i])]
        cands.sort(key=lambda i: -len(entries[i]))
        for i in cands:
            if fits(i, entries[i] + [victim]):
                entries[i] = entries[i] + [victim]
                homeless.remove(victim)
                folded.append((victim, i))
                if victim not in _folded_axes:
                    _folded_axes.add(victim)
                    logger.info(
                        "ShardingPlan: mesh axis %r folded into dim %d's "
                        "sharding (own dim too small at the deepest U-Net "
                        "level).", victim, i)
                break

    for victim in homeless:
        if victim not in _warned_axes:
            _warned_axes.add(victim)
            logger.warning(
                "ShardingPlan: dropping requested mesh axis %r for a tensor "
                "of shape %s: no dim can absorb it (deepest U-Net level "
                "extents all < max(3, n)); the tensor stays unsharded on "
                "this axis.", victim, tuple(shape))

    return Guarded(tuple(None if not names else names[0] if len(names) == 1
                         else tuple(names) for names in entries),
                   tuple(folded), tuple(homeless))


def slab_bounds(extent: int, n: int, index: int,
                unit: int = 2 ** UNET_LEVELS) -> tuple[int, int]:
    """[start, stop) of slab `index` of n along a dim of `extent` planes:
    whole units of `unit` planes, the first extent / unit % n slabs one
    unit more."""
    if extent % unit or extent // unit < n:
        raise ValueError(f"a dim of {extent} planes does not split into {n} "
                         f"slabs of whole {unit}-plane units")
    units, extra = divmod(extent // unit, n)
    start = index * units + min(index, extra)
    return start * unit, (start + units + (index < extra)) * unit


@dataclasses.dataclass(frozen=True)
class Split:
    """One dim of a volume split over the ranks along `axes` (the first
    major): this rank's slab `index` of `count`, planes [start, stop) of
    the dim's `extent`, the process group of the line and the global ranks
    of the slabs before and after (None at an end)."""
    dim: int
    axes: tuple
    count: int
    index: int
    start: int
    stop: int
    extent: int
    group: object
    lower: int | None
    upper: int | None


@dataclasses.dataclass(frozen=True)
class MapShard:
    """The part of a regressed (B, H, W) map that this rank holds: rows and
    cols of the data rank's samples; `group` the ranks whose parts make the
    global batch's map ('data' and the axes that split H and W), `copies`
    the number of ranks that hold these same rows (the axes that split D
    or that no dim took). A masked mean divides by the count over `group`
    and by `copies`, so that the ranks' shares sum to the global mean."""
    mesh: Mesh
    rows: slice
    cols: slice
    height: int
    width: int
    row_axes: tuple
    col_axes: tuple
    copies: int

    @property
    def group(self):
        return self.mesh.group_of(("data",) + self.row_axes + self.col_axes)

    @property
    def part_group(self):
        """The ranks that hold the other rows and cols of the same
        samples."""
        return self.mesh.group_of(self.row_axes + self.col_axes)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows and cols of a (B, H, W) map."""
        if self.rows == slice(None) and self.cols == slice(None):
            return x
        return x[:, self.rows, self.cols]

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part (B, h, w) in a zero (B, H, W) map
        (differentiable)."""
        if self.rows == slice(None) and self.cols == slice(None):
            return x
        r0, r1, _ = self.rows.indices(self.height)
        c0, c1, _ = self.cols.indices(self.width)
        return torch.nn.functional.pad(
            x, (c0, self.width - c1, r0, self.height - r1))


@dataclasses.dataclass(frozen=True)
class VolumeShard:
    """The slab of a (B, D, H, W, C) volume that this rank holds: `splits`
    are the dims split over the ranks, in dim order; `spec` the guarded
    spec it came from."""
    mesh: Mesh
    shape: tuple
    spec: tuple
    splits: tuple

    def split(self, dim: int) -> Split | None:
        for s in self.splits:
            if s.dim == dim:
                return s
        return None

    def slices(self, dims: dict) -> tuple:
        """Index of this rank's slab in a tensor whose dim dims[v] is the
        volume's dim v (v in 1..3)."""
        index = [slice(None)] * (max(dims.values()) + 1)
        for s in self.splits:
            if s.dim in dims:
                index[dims[s.dim]] = slice(s.start, s.stop)
        return tuple(index)

    def take(self, x: torch.Tensor, dims: dict | None = None):
        """This rank's slab of `x`, whose dim dims[v] is the volume's dim v
        (default: x is laid out as the volume)."""
        return x[self.slices(dims or {1: 1, 2: 2, 3: 3})]

    @property
    def moments_group(self):
        """The ranks whose slabs make the global batch's volume: BatchNorm
        takes its moments over them, weighted by element counts."""
        return self.mesh.group_of(("data",) + _GUARDED)

    @property
    def sample_group(self):
        """The ranks whose slabs make one sample's volume (GroupNorm)."""
        return self.mesh.group_of(_GUARDED)

    def map_shard(self) -> MapShard:
        rows, cols = self.split(2), self.split(3)
        row_axes = rows.axes if rows else ()
        col_axes = cols.axes if cols else ()
        return MapShard(
            self.mesh,
            slice(rows.start, rows.stop) if rows else slice(None),
            slice(cols.start, cols.stop) if cols else slice(None),
            self.shape[2], self.shape[3], row_axes, col_axes,
            self.mesh.sizes(_GUARDED) // self.mesh.sizes(row_axes + col_axes))


def _volume_shard(mesh: Mesh, spec: tuple, shape: tuple) -> VolumeShard:
    splits = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if dim not in (1, 2, 3) or any(a not in _GUARDED for a in axes):
            continue  # the batch's 'data' rows are the data rank's already
        n, i = mesh.sizes(axes), mesh.index_along(axes)
        start, stop = slab_bounds(shape[dim], n, i)
        splits.append(Split(
            dim, axes, n, i, start, stop, shape[dim], mesh.group_of(axes),
            mesh.rank_along(axes, i - 1) if i > 0 else None,
            mesh.rank_along(axes, i + 1) if i < n - 1 else None))
    return VolumeShard(mesh, tuple(shape), tuple(spec), tuple(splits))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """mvs_tpu's ShardingPlan on a process mesh: its cost-volume spec (a
    tuple of axis names) under the guard. Only the volume's layout is
    needed: the batch's is the data ranks' rows, and the split volume's
    scores follow it."""
    mesh: Mesh
    volume_spec: tuple

    def volume_layout(self, shape) -> Guarded:
        """The guard's decision on the volume spec for a (B, D, H, W, C)
        `shape`."""
        return guarded(self.volume_spec, tuple(shape), self.mesh.shape)

    def constrain_volume(self, shape) -> VolumeShard | None:
        """The slab of a (B, D, H, W, C) volume of the global `shape` that
        this rank builds and regularizes, or None when no dim is split
        (the whole volume on every rank)."""
        shard = _volume_shard(self.mesh, self.volume_layout(shape).spec,
                              tuple(shape))
        return shard if shard.splits else None


def volume_sharded_plan(mesh: Mesh) -> ShardingPlan:
    """Data parallelism and, inside each volume, depth slabs over 'depth'
    and rows over 'space' (the source views over 'view' are
    collectives.make_view_variance's)."""
    return ShardingPlan(mesh, ("data", "depth", "space", None, None))


# ---- the current volume and map ---------------------------------------------

_volume: VolumeShard | None = None
_map: MapShard | None = None


@contextlib.contextmanager
def use_volume(shard: VolumeShard | None):
    """Make `shard` the volume the U-Net's blocks convolve a slab of (None:
    whole volumes) inside the block."""
    global _volume
    saved, _volume = _volume, shard
    try:
        yield shard
    finally:
        _volume = saved


def current_volume() -> VolumeShard | None:
    return _volume


@contextlib.contextmanager
def use_map(shard: MapShard | None):
    """Make `shard` the layout of the maps the masked losses read inside
    the block (None: default_map's)."""
    global _map
    saved, _map = _map, shard
    try:
        yield shard
    finally:
        _map = saved


def default_map(mesh: Mesh) -> MapShard:
    """Whole maps of the data rank's samples, held by every rank along
    'depth' and 'space' alike (a family whose volumes are not split)."""
    return MapShard(mesh, slice(None), slice(None), 0, 0, (), (),
                    mesh.sizes(_GUARDED))


def current_map() -> MapShard | None:
    """The current map's layout: use_map's, else default_map of the
    current mesh, else None (one process)."""
    if _map is not None:
        return _map
    mesh = current_mesh()
    return None if mesh is None else default_map(mesh)

