"""Data- and model-parallel train and eval steps (the JAX package's
``parallel/step.py``).

JAX jits one step with the batch sharded on ``dp`` and the state sharded
by its shape rules (``parallel/sharding.py``); GSPMD then computes the
batch statistics over the global batch and derives the gradient psum and
the gathers of sharded weights. The port does this by hand over the mesh's
process groups: each rank runs the forward and backward on its rows
(``mesh.local_rows``) with whole weights and the batchnorm statistics
all-reduced over its dp group (``ops/layers.batchnorm_train``), then one
all-reduce over the dp group averages the flattened gradients together
with the loss breakdown, and every rank applies ``guarded_update`` to the
same numbers. At mp > 1 the ranks of one dp index hold the same rows and
draw the same dropout, so they compute equal gradients, and after the dp
all-reduce every rank holds the global mean: no reduce-scatter over mp is
needed. ``guarded_update`` then updates each sharded parameter on the
rank's part, with its part of the Adam moments, and all-gathers the parts
over the mp group into the whole weights the kernels read. The model is
not wrapped in ``DistributedDataParallel``: the step takes its gradients
with ``torch.autograd.grad`` and never fills ``.grad``, where DDP's reducer
hooks in.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.parallel.mesh import Mesh
from tacotron2_tpu_torch.training.accumulate import micro_batch_grads
from tacotron2_tpu_torch.training.loss import LossBreakdown
from tacotron2_tpu_torch.training.state import (Batch, StepMetrics, Tensors,
                                                TrainState, eval_step,
                                                guarded_update)

Generators = Optional[Sequence[Optional[torch.Generator]]]


def all_reduce_mean(grads: Tensors, scalars: List[torch.Tensor], group
                    ) -> Tuple[Tensors, List[torch.Tensor]]:
    """The mean over the group's ranks of every gradient and of each
    scalar, in one all-reduce of one flat fp32 buffer. ``group`` None (one
    process) returns them as they are."""
    if group is None:
        return grads, scalars
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1).float() for n in names]
                     + [s.reshape(1).float() for s in scalars])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, at = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[at:at + g.numel()].view(g.shape)
        at += g.numel()
    return out, list(flat[at:])


def make_train_step(cfg: Tacotron2Config, mesh: Mesh) -> Callable:
    """``step(state, local_batch, generators) -> (state, StepMetrics)``:
    the rank's rows of the global batch, and one dropout generator for each
    of ``cfg.grad_accum_steps`` micro-batches (None: no dropout). With more
    than one micro-batch the step is ``training/accumulate.py``'s, with the
    all-reduce once after the micro loop. With one process and one
    micro-batch it computes what ``train_step`` does, bit for bit. The
    state is sharded as ``parallel.sharding.shard_state`` leaves it (or
    whole at mp = 1)."""
    n_micro = cfg.grad_accum_steps

    def step(state: TrainState, local_batch: Batch, generators: Generators
             ) -> Tuple[TrainState, StepMetrics]:
        grads, new_stats, parts = micro_batch_grads(
            state, local_batch, cfg, n_micro, generators,
            group=mesh.dp_group)
        grads, parts = all_reduce_mean(grads, list(parts), mesh.dp_group)
        new_state, grad_norm, applied = guarded_update(
            state, grads, new_stats, parts[0], cfg)
        return new_state, StepMetrics(*parts, grad_norm, applied)

    return step


def make_eval_step(cfg: Tacotron2Config, mesh: Mesh) -> Callable:
    """``eval(state, local_batch, generator) -> (LossBreakdown, output)``:
    each rank evaluates its rows; the ``row_valid``-weighted losses are
    combined across the dp group by their weights, so the breakdown equals
    ``eval_step`` on the whole batch. The output is the rank's own rows."""

    def step(state: TrainState, local_batch: Batch,
             generator: Optional[torch.Generator] = None):
        breakdown, output = eval_step(state, local_batch, cfg, generator)
        if mesh.dp_group is None:
            return breakdown, output
        rows = local_batch.row_valid
        weight = (rows.sum() if rows is not None else torch.tensor(
            float(local_batch.text.shape[0]), device=breakdown.total.device))
        # each part is sum(w * row loss) / max(sum(w), 1): undo the local
        # division, add over ranks, divide by the global weight
        local = torch.stack([*(p * torch.clamp(weight, min=1.0)
                               for p in breakdown), weight])
        dist.all_reduce(local, group=mesh.dp_group)
        parts = local[:-1] / torch.clamp(local[-1], min=1.0)
        return LossBreakdown(*parts), output

    return step
