"""Where the train state lives across ranks (the JAX package's
``parallel/sharding.py`` and ``step.py:create_sharded_state``).

The JAX rule shards a leaf over ``mp`` when its last dimension divides by
it and replicates everything else; at mp = 1 (the only layout the port
runs, ``mesh.create_mesh``) it replicates every leaf: parameters, batchnorm
statistics, Adam moments and the scalars. JAX gets the replicas by
construction (one jitted init with replicated out-shardings, the reference's
rank-0 broadcast at init, distributed.py:132-135); the port's processes each
build a state, so rank 0's is broadcast to the others.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tacotron2_tpu_torch.parallel.mesh import Mesh


def replicate_state(state, mesh: Mesh):
    """Make every rank's ``TrainState`` equal to rank 0's, in place: the
    parameters, the batchnorm statistics, both Adam moments, the Adam
    count, the step and the learning rate. A single process is left as it
    is. Returns the state."""
    if mesh.group is None:
        return state
    tensors = [p.data for p in state.model.parameters()]
    for group in (state.stats, state.exp_avg, state.exp_avg_sq):
        tensors += [group[k] for k in sorted(group)]
    tensors += [state.adam_count, state.step, state.learning_rate]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)
    return state
