"""Data-parallel, view-sharded and volume-sharded training over
torch.distributed (counterpart of mvs_tpu.parallel): the process mesh,
start-up from torchrun's variables, the batch, state and volume layout,
the halo exchange, and the collectives of the global-batch train step."""

from mvs_tpu_torch.parallel.collectives import (all_reduce, make_view_variance,
                                                psum_metrics, sum_gradients,
                                                view_sharded_variance_volume)
from mvs_tpu_torch.parallel.distributed import (barrier, launch_local,
                                                maybe_initialize_distributed,
                                                shutdown)
from mvs_tpu_torch.parallel.mesh import (AXES, Mesh, current_mesh, make_mesh,
                                         use_mesh)
from mvs_tpu_torch.parallel.sharding import (ShardingPlan, replicate,
                                             shard_batch, volume_sharded_plan)

__all__ = ["AXES", "Mesh", "make_mesh", "use_mesh", "current_mesh",
           "maybe_initialize_distributed", "barrier", "shutdown",
           "launch_local", "replicate", "shard_batch", "ShardingPlan",
           "volume_sharded_plan", "all_reduce",
           "make_view_variance", "view_sharded_variance_volume",
           "psum_metrics", "sum_gradients"]
