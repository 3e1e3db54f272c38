"""Where the train state lives across ranks (the JAX package's
``parallel/sharding.py`` and ``step.py:create_sharded_state``).

The JAX rule (``tacotron2_tpu/parallel/sharding.py:_leaf_pspec``) is one of
placement: a leaf of two or more dimensions whose last dimension divides
by mp is sharded over ``mp`` along that dimension, every other leaf
(biases, batchnorm parameters and statistics, the scalars) is replicated,
and the rule is applied alike to the parameters and to both Adam moments.
The port's parameters are in the reference's torch layout, which the JAX
package stores transposed (``tacotron2_tpu/convert.py``: a Linear's
``(out, in)`` as ``(in, out)``, a Conv1d's ``(out, in, k)`` as
``(k, in, out)``, an LSTM's ``(4H, in)`` as ``(in, 4H)``), so the JAX last
axis is torch dim 0, except for ``embedding.weight``, stored as it is
(dim 1). ``shard_dim`` gives that dim.

The math does not change and the kernels take whole weights, so every rank
keeps whole parameters in its module; what is sharded is the optimizer:
a rank stores, and updates, only its slice of each sharded leaf's Adam
moments (1/mp of their memory) and gathers the other ranks' updated slices
(``ShardPlan.gather_parts``). A checkpoint holds whole moments whatever the
mesh, as the JAX package's does (``gather_state``; ``shard_state`` slices a
whole state).

JAX gets replicas by construction (one jitted init with replicated
out-shardings, the reference's rank-0 broadcast at init,
distributed.py:132-135); the port's processes each build a state, so rank
0's is broadcast to the others (``replicate_state``), before it is sliced.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tacotron2_tpu_torch.parallel.mesh import Mesh


def shard_dim(name: str, shape: Sequence[int], mp: int) -> Optional[int]:
    """The torch dim along which parameter ``name`` of ``shape`` is sharded
    over ``mp`` ranks (the JAX leaf's last axis), or None: replicated."""
    if mp <= 1 or len(shape) < 2:
        return None
    dim = 1 if name == "embedding.weight" else 0
    return dim if shape[dim] % mp == 0 else None


class ShardPlan(NamedTuple):
    """One rank's place in the optimizer's sharding: ``dims`` maps each
    sharded parameter to its dim; the rank holds part ``index`` of
    ``count`` of each; ``group`` is the mp group, whose ranks hold the
    other parts."""
    dims: Dict[str, int]
    index: int
    count: int
    group: Optional[dist.ProcessGroup]

    def part(self, name: str, t: torch.Tensor, index: Optional[int] = None
             ) -> torch.Tensor:
        """A view of part ``index`` (this rank's by default) of the whole
        tensor ``t`` of parameter ``name``; ``t`` itself if replicated."""
        dim = self.dims.get(name)
        if dim is None:
            return t
        size = t.shape[dim] // self.count
        at = self.index if index is None else index
        return t.narrow(dim, at * size, size)

    def gather_parts(self, wholes: Sequence[Tuple[str, torch.Tensor]]
                     ) -> None:
        """Fill, in place, every other rank's part of each whole tensor
        ``(name, t)`` (sharded parameters only) from that rank's own part:
        one all-gather of one flat buffer over the mp group."""
        if not wholes:
            return
        own = torch.cat([self.part(n, t).reshape(-1) for n, t in wholes])
        device = own.device
        if own.is_cuda and dist.get_backend(self.group) == "gloo":
            own = own.cpu()  # gloo gathers host memory (ranks on one card)
        parts = [torch.empty_like(own) for _ in range(self.count)]
        dist.all_gather(parts, own, group=self.group)
        for j, flat in enumerate(parts):
            if j == self.index:
                continue
            flat, at = flat.to(device), 0
            for n, t in wholes:
                view = self.part(n, t, j)
                view.copy_(flat[at:at + view.numel()].view(view.shape))
                at += view.numel()


def shard_plan(model: torch.nn.Module, mesh: Mesh) -> Optional[ShardPlan]:
    """This rank's plan for ``model``'s parameters on ``mesh``; None at
    mp = 1 (everything replicated)."""
    if mesh.mp == 1:
        return None
    dims = {}
    for name, p in model.named_parameters():
        dim = shard_dim(name, p.shape, mesh.mp)
        if dim is not None:
            dims[name] = dim
    return ShardPlan(dims, mesh.mp_index, mesh.mp, mesh.mp_group)


def shard_state(state, plan: Optional[ShardPlan]):
    """A whole ``TrainState`` with each sharded leaf's Adam moments cut to
    this rank's part (contiguous copies) and the plan recorded in it.
    ``plan`` None returns the state as it is."""
    if plan is None:
        return state
    if state.shard is not None:
        raise ValueError("the state is already sharded")
    cut = lambda group: {n: plan.part(n, v).contiguous()
                         for n, v in group.items()}
    return state._replace(exp_avg=cut(state.exp_avg),
                          exp_avg_sq=cut(state.exp_avg_sq), shard=plan)


def gather_state(state):
    """A sharded ``TrainState`` with whole Adam moments gathered from the
    mp group's ranks (a collective: every rank of the group calls it), the
    plan dropped. A whole state is returned as it is."""
    plan = state.shard
    if plan is None:
        return state
    params = dict(state.model.named_parameters())
    moments: List[Dict[str, torch.Tensor]] = []
    wholes = []
    for group in (state.exp_avg, state.exp_avg_sq):
        whole = {}
        for n, v in group.items():
            if n in plan.dims:
                t = torch.empty(params[n].shape, dtype=v.dtype,
                                device=v.device)
                plan.part(n, t).copy_(v)
                wholes.append((n, t))
                v = t
            whole[n] = v
        moments.append(whole)
    plan.gather_parts(wholes)
    return state._replace(exp_avg=moments[0], exp_avg_sq=moments[1],
                          shard=None)


def replicate_state(state, mesh: Mesh):
    """Make every rank's whole ``TrainState`` equal to rank 0's, in place:
    the parameters, the batchnorm statistics, both Adam moments, the Adam
    count, the step and the learning rate. A single process is left as it
    is. Returns the state."""
    if mesh.group is None:
        return state
    if state.shard is not None:
        raise ValueError("replicate a whole state, then shard it")
    tensors = [p.data for p in state.model.parameters()]
    for group in (state.stats, state.exp_avg, state.exp_avg_sq):
        tensors += [group[k] for k in sorted(group)]
    tensors += [state.adam_count, state.step, state.learning_rate]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)
    return state
