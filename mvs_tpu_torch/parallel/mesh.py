"""The process mesh with the MVS axes (counterpart of mvs_tpu.parallel.mesh).

mvs_tpu lays devices out on a GSPMD mesh with the axes ('data', 'view',
'depth', 'space'); here each rank of torch.distributed is one point of the
same grid, 'space' innermost and 'view' inside 'data': rank = ((d * view +
v) * depth + z) * space + s. A rank gets its coordinates and the process
groups of its 'data' line (the ranks that hold other rows of the global
batch, same view shard) and its 'view' line (the ranks that hold the same
rows, other source views).

'depth' and 'space' above 1 raise: GSPMD's conv-halo sharding of the
volumes (mvs_tpu.parallel.sharding.volume_sharded_plan and its extent
guard) has no counterpart yet (ROADMAP.md queue 1, item 20).

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

__all__ = ["AXES", "Mesh", "layout", "make_mesh", "mesh_shape_from_config",
           "use_mesh", "current_mesh"]

AXES = ("data", "view", "depth", "space")
_ITEM = "ROADMAP.md queue 1, item 20"


def layout(data: int = 1, view: int = 1, depth: int = 1,
           space: int = 1) -> dict:
    """{axis: [ranks of each line along the axis]}: the process groups of
    the grid data x view x depth x space, in the order every rank creates
    them."""
    grid = np.arange(data * view * depth * space).reshape(data, view, depth,
                                                          space)
    out = {}
    for i, axis in enumerate(AXES):
        lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        out[axis] = [[int(r) for r in line] for line in lines]
    return out


@dataclasses.dataclass
class Mesh:
    shape: dict  # {axis: size}
    rank: int
    coords: dict  # {axis: this rank's index}
    groups: dict  # {axis: ProcessGroup, or None for an axis of size 1}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

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
    if depth > 1 or space > 1:
        raise NotImplementedError(
            f"mesh depth={depth} space={space}: sharding the volumes over "
            f"depth slabs or spatial tiles is not ported ({_ITEM})")
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
    groups = {}
    for axis, lines in layout(data, view, depth, space).items():
        groups[axis] = None
        if shape[axis] == 1:
            continue
        for line in lines:  # every rank creates every group, in order
            g = dist.new_group(line)
            if rank in line:
                groups[axis] = g
    return Mesh(shape, rank, coords, groups)


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
