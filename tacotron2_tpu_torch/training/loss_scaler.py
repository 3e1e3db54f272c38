"""Dynamic loss scaling (the JAX package's ``training/loss_scaler.py``).

The reference's overflow-skip semantics (reference loss_scaler.py:31-80,
run by Apex AMP, train.py:222-231): the scale starts at 2**32, halves on a
non-finite gradient (the step is skipped) and doubles after
``scale_window`` good steps in a row. bf16 needs no loss scaling, and
nothing in the training path calls this; it is here for an fp16 step.

The state is a pair of tensors on the device and every function is
arithmetic on them: nothing is read back to the host, so a step that uses
it keeps running ahead of the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from tacotron2_tpu_torch.models.tacotron2 import resolve_device

Tensors = Dict[str, torch.Tensor]


class LossScalerState(NamedTuple):
    scale: torch.Tensor        # () fp32
    good_steps: torch.Tensor   # () int32, consecutive finite steps


def init_loss_scaler(init_scale: float = 2.0 ** 32,
                     device: Union[str, torch.device] = "cuda"
                     ) -> LossScalerState:
    """A fresh scaler on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    return LossScalerState(
        torch.tensor(init_scale, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def scale_loss(state: LossScalerState, loss: torch.Tensor) -> torch.Tensor:
    return loss * state.scale


def unscale_and_check(state: LossScalerState, grads: Tensors,
                      scale_factor: float = 2.0, scale_window: int = 1000
                      ) -> Tuple[Tensors, torch.Tensor, LossScalerState]:
    """Unscale the gradients, find an overflow, update the scale. Returns
    (unscaled grads, ok, new state): ``ok`` is a () bool tensor, False when
    a gradient is not finite and the optimizer step should be skipped (the
    reference's ``is_overflow`` path, train.py:228-236)."""
    inv = 1.0 / state.scale
    grads = {k: g * inv for k, g in grads.items()}
    finite = torch.stack([torch.isfinite(g).all()
                          for g in grads.values()]).all()
    window_done = state.good_steps + 1 >= scale_window
    new_scale = torch.where(
        finite,
        torch.where(window_done, state.scale * scale_factor, state.scale),
        state.scale / scale_factor)
    new_good = torch.where(
        finite & ~window_done, state.good_steps + 1,
        torch.zeros_like(state.good_steps))
    return grads, finite, LossScalerState(new_scale, new_good)


def apply_or_skip(updates: Tensors, ok: torch.Tensor) -> Tensors:
    """The updates where ``ok``, zeros where not: the skip without a
    branch. (The JAX package multiplies by ``ok``, which leaves a NaN
    update NaN; ``torch.where`` zeroes it, as the docstring there
    intends.)"""
    return {k: torch.where(ok, u, torch.zeros_like(u))
            for k, u in updates.items()}
