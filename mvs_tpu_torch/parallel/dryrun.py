"""One CasMVSNet train step over every rank, every mesh axis in use
(counterpart of mvs_tpu's __graft_entry__._factor_mesh and
dryrun_multichip).

    torchrun --nproc_per_node=N -m mvs_tpu_torch.parallel.dryrun [--device cpu]

The ranks are split as _factor_mesh splits devices: 'view' 2 where the
count is even (the example batch has two source views), then 'space' 2,
then 'depth' 2, the rest 'data', so that at 8 ranks every mechanism runs:
the view ranks' partial sums, the halo exchange of row tiles and depth
slabs. The step: CasMVSNet (48 / 32 / 8 hypotheses) from the Flax modules'
initial state drawn from seed 0, Adam, the cascade loss, on
cli.profile.example_batch's plane scenes at 96x64 (the stage-1 volume's
24 rows keep 'space' under the small-extent guard), global batch max(2,
data). Rank 0 prints the mesh, the loss and the guard's dropped and
folded axes.
"""

from __future__ import annotations

import argparse
from collections.abc import Callable

import torch

from mvs_tpu_torch.models.cas_mvsnet import CasMVSNet
from mvs_tpu_torch.parallel import sharding
from mvs_tpu_torch.parallel.collectives import make_view_variance
from mvs_tpu_torch.parallel.distributed import (maybe_initialize_distributed,
                                                shutdown)
from mvs_tpu_torch.parallel.mesh import make_mesh
from mvs_tpu_torch.parallel.sharding import (replicate, shard_batch,
                                             volume_sharded_plan)
from mvs_tpu_torch.train.optim import OptaxChain
from mvs_tpu_torch.train.state import make_train_step
from mvs_tpu_torch.train.tasks import CascadeTask

__all__ = ["factor_mesh", "build_step", "describe", "main"]


def factor_mesh(n: int) -> dict:
    """{axis: size} for n ranks: view, space, depth each 2 while the rest
    is even, the rest data."""
    shape = dict(data=1, view=1, depth=1, space=1)
    remaining = n
    for axis in ("view", "space", "depth"):
        if remaining % 2 == 0 and remaining > 1:
            shape[axis] = 2
            remaining //= 2
    shape["data"] = remaining
    return shape


def build_step(device, world_size: int) -> tuple[Callable[[], dict], dict]:
    """(step() -> the global batch's metrics after one train step, the
    mesh's shape) for this rank of `world_size`."""
    from mvs_tpu_torch.cli.profile import example_batch

    shape = factor_mesh(world_size)
    mesh = make_mesh(**shape)
    model = CasMVSNet(ndepths=(48, 32, 8),
                      generator=torch.Generator().manual_seed(0),
                      trained=False).to(device)
    model.volume_constraint = volume_sharded_plan(mesh).constrain_volume
    if shape["view"] > 1:
        model.view_variance = make_view_variance(mesh)
    batch = shard_batch(example_batch(device, batch_size=max(2, shape["data"]),
                                      height=96, width=64, num_depth=48),
                        mesh)
    opt = OptaxChain(model.parameters(), "adam", lambda count: 1e-3)
    replicate(model, opt)
    run = make_train_step(CascadeTask(model), opt, mesh=mesh)
    return (lambda: run(batch)), shape


def describe(shape: dict, loss: float) -> str:
    stripped = sorted(sharding._warned_axes) or ["none"]
    folded = sorted(sharding._folded_axes) or ["none"]
    return (f"dryrun: mesh=(data={shape['data']},view={shape['view']},"
            f"depth={shape['depth']},space={shape['space']}) "
            f"loss={loss:.4f} guard-stripped-axes={','.join(stripped)} "
            f"folded-axes={','.join(folded)} ok")


def main(argv=None) -> float:
    """Run the dry run on this rank; returns the loss."""
    p = argparse.ArgumentParser(prog="mvs_tpu_torch.parallel.dryrun")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:LOCAL_RANK)")
    args = p.parse_args(argv)
    proc = maybe_initialize_distributed(args.device)
    try:
        step, shape = build_step(proc.device, proc.world_size)
        loss = float(step()["loss"])
        if not torch.isfinite(torch.tensor(loss)):
            raise FloatingPointError(f"dryrun loss not finite: {loss}")
        if proc.rank == 0:
            print(describe(shape, loss), flush=True)
        return loss
    finally:
        shutdown()


if __name__ == "__main__":
    main()
