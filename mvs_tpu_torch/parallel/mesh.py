"""The process mesh with the MVS axes (counterpart of mvs_tpu.parallel.mesh).

mvs_tpu lays devices out on a GSPMD mesh with the axes ('data', 'view',
'depth', 'space'); here each rank of torch.distributed is one point of the
same grid, 'space' innermost and 'view' inside 'data': rank = ((d * view +
v) * depth + z) * space + s. A rank gets its coordinates and the process
groups of its 'data' line (the ranks that hold other rows of the global
batch, same view shard), its 'view' line (the ranks that hold the same
rows, other source views), its 'depth' and 'space' lines, and its line
over every set of more than one of the axes that the volume sharding
reduces over (parallel.sharding): the ('depth', 'space') product a folded
dim splits over, the 'data' x 'depth' x 'space' ranks whose slabs make a
batch's volume.

The train loop makes its mesh current (use_mesh): while it is, the batch
moments of BatchNorm, the masked losses and metrics and OHEM's ranking
reduce over the 'data' group (nn.blocks, train.losses), as they do over
the sharded batch axis under GSPMD.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "layout", "lines", "make_mesh",
           "mesh_shape_from_config", "use_mesh", "current_mesh"]

AXES = ("data", "view", "depth", "space")


def lines(shape: tuple, axes: tuple) -> list:
    """The ranks of each line of the grid `shape` (sizes in AXES order)
    along `axes` (the others fixed), each line in the order of its ranks'
    mixed-radix index over `axes` (the first axis major)."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    idx = [AXES.index(a) for a in axes]
    rest = [i for i in range(len(AXES)) if i not in idx]
    moved = np.transpose(grid, rest + idx)
    n = int(np.prod([shape[i] for i in idx]))
    return [[int(r) for r in line] for line in moved.reshape(-1, n)]


def layout(data: int = 1, view: int = 1, depth: int = 1,
           space: int = 1) -> dict:
    """{axis: [ranks of each line along the axis]}: the process groups of
    the grid data x view x depth x space, in the order every rank creates
    them."""
    shape = (data, view, depth, space)
    return {axis: lines(shape, (axis,)) for axis in AXES}


def _subsets(live: list) -> list:
    """The subsets of more than one of the `live` axes, in a fixed order."""
    out = []
    for mask in range(1, 2 ** len(live)):
        sub = tuple(a for i, a in enumerate(live) if mask >> i & 1)
        if len(sub) > 1:
            out.append(sub)
    return out


@dataclasses.dataclass
class Mesh:
    shape: dict  # {axis: size}
    rank: int
    coords: dict  # {axis: this rank's index}
    groups: dict  # {axis: ProcessGroup, or None for an axis of size 1}
    # {frozenset of more than one axis of size > 1: ProcessGroup}
    product_groups: dict = dataclasses.field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def sizes(self, axes) -> int:
        """The product of the sizes of `axes`."""
        return int(np.prod([self.shape[a] for a in axes]))

    def group_of(self, axes):
        """The ranks that differ from this one only along `axes` (any
        order): None when those axes have one rank, the axis's own group
        for one axis of size > 1."""
        live = [a for a in AXES if a in axes and self.shape[a] > 1]
        if not live:
            return None
        if len(live) == 1:
            return self.groups[live[0]]
        return self.product_groups[frozenset(live)]

    def index_along(self, axes: tuple) -> int:
        """This rank's mixed-radix index over `axes` (the first major)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def rank_along(self, axes: tuple, index: int) -> int:
        """The rank with mixed-radix index `index` over `axes` and this
        rank's coordinates on the other axes."""
        coords = dict(self.coords)
        for a in reversed(axes):
            index, coords[a] = divmod(index, self.shape[a])
        return int(np.ravel_multi_index(tuple(coords[a] for a in AXES),
                                        tuple(self.shape[a] for a in AXES)))

    @property
    def world_size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))


def make_mesh(data: int = 1, view: int = 1, depth: int = 1, space: int = 1,
              world_size: int | None = None, rank: int | None = None
              ) -> Mesh:
    """This rank's point of the grid. The product of the axes must equal
    the world size (torch.distributed's, 1 in a single process); every
    rank must call this with the same shape, in the same order as its other
    group creations."""
    shape = dict(zip(AXES, (data, view, depth, space)))
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    if int(np.prod(list(shape.values()))) != world_size:
        raise ValueError(
            f"mesh shape {tuple(shape.values())} needs "
            f"{int(np.prod(list(shape.values())))} processes, have "
            f"{world_size}")
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
        rank, tuple(shape.values())))))
    def create(axes):
        mine = None
        for line in lines(tuple(shape.values()), axes):
            g = dist.new_group(line)  # every rank creates every group
            if rank in line:
                mine = g
        return mine

    groups = {axis: create((axis,)) if shape[axis] > 1 else None
              for axis in AXES}
    live = [a for a in AXES if shape[a] > 1]
    product = {frozenset(sub): create(sub) for sub in _subsets(live)}
    return Mesh(shape, rank, coords, groups, product)


def mesh_shape_from_config(train_cfg, world_size: int) -> dict:
    """{axis: size} from train.mesh_*: mesh_data = 0 means world //
    (view * depth * space), as mvs_tpu.cli.train's _build_mesh reads it."""
    model_axes = (train_cfg.mesh_view * train_cfg.mesh_depth
                  * train_cfg.mesh_space)
    data = train_cfg.mesh_data or max(1, world_size // model_axes)
    return dict(data=data, view=train_cfg.mesh_view,
                depth=train_cfg.mesh_depth, space=train_cfg.mesh_space)


_current: Mesh | None = None


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make `mesh` the current one (None: none) inside the block."""
    global _current
    saved, _current = _current, mesh
    try:
        yield mesh
    finally:
        _current = saved


def current_mesh() -> Mesh | None:
    return _current
