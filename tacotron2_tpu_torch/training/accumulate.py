"""Gradient accumulation: a large effective batch in the memory of a small
one (the JAX package's ``training/accumulate.py``).

No reference equivalent (it trains whatever fits). The batch is split along
its rows into ``n_micro`` micro-batches; each runs its forward and backward
in turn (only one micro-batch's activations are alive at a time), the
gradients are summed and divided by ``n_micro``, and one optimizer update
applies them: the effective batch is the full batch.

As in the JAX package, batchnorm uses each micro-batch's own statistics in
its forward (what running the micro-batches as separate steps would do),
every micro-batch starts from the state's running statistics, and the new
running statistics are the micro-batches' mean.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.training.loss import LossBreakdown
from tacotron2_tpu_torch.training.state import (Batch, StepMetrics, Tensors,
                                                TrainState, guarded_update,
                                                loss_and_grads)


def micro_batch_grads(state: TrainState, batch: Batch, cfg: Tacotron2Config,
                      n_micro: int,
                      generators: Optional[Sequence[
                          Optional[torch.Generator]]] = None,
                      group=None) -> Tuple[Tensors, Tensors, LossBreakdown]:
    """(mean gradient, mean new batchnorm statistics, mean loss breakdown)
    over ``n_micro`` contiguous micro-batches of ``batch``; micro-batch i
    draws its dropout from ``generators[i]`` (None: no dropout). ``group``
    syncs the batch statistics across data-parallel ranks
    (``parallel/step.py``). With one micro-batch these are
    ``loss_and_grads``'s values themselves."""
    B = batch.text.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} is not divisible into {n_micro} "
                         f"micro-batches")
    if generators is None:
        generators = [None] * n_micro
    if len(generators) != n_micro:
        raise ValueError(f"{len(generators)} generators for {n_micro} "
                         f"micro-batches")
    b = B // n_micro
    grad_sum = stats_sum = parts_sum = None
    for i in range(n_micro):
        micro = batch if n_micro == 1 else Batch(
            *(None if t is None else t[i * b:(i + 1) * b] for t in batch))
        loss, grads, new_stats, _ = loss_and_grads(
            state, micro, cfg, generators[i], group=group)
        if n_micro == 1:
            return grads, new_stats, loss
        if grad_sum is None:
            grad_sum = {k: torch.zeros_like(g, dtype=torch.float32)
                        for k, g in grads.items()}
            stats_sum = {k: torch.zeros_like(v)
                         for k, v in new_stats.items()}
            parts_sum = [torch.zeros_like(p) for p in loss]
        for k, g in grads.items():
            grad_sum[k] += g
        for k, v in new_stats.items():
            stats_sum[k] += v
        for acc, p in zip(parts_sum, loss):
            acc += p
    return ({k: g / n_micro for k, g in grad_sum.items()},
            {k: v / n_micro for k, v in stats_sum.items()},
            LossBreakdown(*(p / n_micro for p in parts_sum)))


def accum_train_step(state: TrainState, batch: Batch, cfg: Tacotron2Config,
                     n_micro: int,
                     generators: Optional[Sequence[
                         Optional[torch.Generator]]] = None
                     ) -> Tuple[TrainState, StepMetrics]:
    """One optimisation step over ``n_micro`` micro-batches of ``batch``
    (its rows divisible by ``n_micro``): the mean gradient, one
    ``guarded_update``. The loss and its parts are the micro-batches'
    means."""
    grads, new_stats, loss = micro_batch_grads(state, batch, cfg, n_micro,
                                               generators)
    new_state, grad_norm, applied = guarded_update(state, grads, new_stats,
                                                   loss.total, cfg)
    return new_state, StepMetrics(*loss, grad_norm, applied)
