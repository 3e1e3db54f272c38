"""Data and model parallelism over ``torch.distributed``: the process group
and ``(dp, mp)`` mesh, the replicated and sharded state, the parallel train
and eval steps."""

from tacotron2_tpu_torch.parallel.mesh import (Mesh, create_mesh,
                                               initialize_distributed,
                                               local_device, local_rows,
                                               shard_batch)
from tacotron2_tpu_torch.parallel.sharding import (ShardPlan, gather_state,
                                                   replicate_state,
                                                   shard_dim, shard_plan,
                                                   shard_state)
from tacotron2_tpu_torch.parallel.step import (all_reduce_mean,
                                               make_eval_step,
                                               make_train_step)

__all__ = [
    "Mesh", "create_mesh",
    "initialize_distributed", "local_device", "local_rows", "shard_batch",
    "ShardPlan", "shard_dim", "shard_plan", "shard_state", "gather_state",
    "replicate_state", "all_reduce_mean", "make_eval_step",
    "make_train_step",
]
