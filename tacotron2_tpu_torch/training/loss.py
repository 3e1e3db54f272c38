"""Tacotron 2 training loss (the JAX package's ``training/loss.py``).

Reference semantics (reference loss_function.py:8-19): MSE(mel, target) +
MSE(mel_postnet, target) + BCE-with-logits(gate, gate_target), each a mean
over the full padded tensor. Padded positions add nothing to the sums
(outputs are masked: mel 0 where targets are 0-padded, gate 1e3 where the
target is 1) but count in the denominators, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    mel_postnet: torch.Tensor
    gate: torch.Tensor


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise, numerically stable binary cross-entropy on logits:
    max(x, 0) - x*y + log(1 + exp(-|x|))."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def tacotron2_loss(output, mel_target: torch.Tensor,
                   gate_target: torch.Tensor,
                   row_weights: Optional[torch.Tensor] = None
                   ) -> LossBreakdown:
    """output: ``models.tacotron2.ForwardOutput``; mel_target (B, T, n_mels);
    gate_target (B, T), 1.0 from each row's last real frame on.
    ``row_weights`` (B,) weights rows (the validity mask of a batch padded
    with repeated rows drops them from the mean); None is the plain mean
    over the full tensor."""
    mel_target, gate_target = mel_target.detach(), gate_target.detach()
    mel_sq = (output.mel - mel_target).square()
    post_sq = (output.mel_postnet - mel_target).square()
    gate_bce = bce_with_logits(output.gate_energies, gate_target)
    if row_weights is None:
        mel, post, gate = mel_sq.mean(), post_sq.mean(), gate_bce.mean()
    else:
        w = row_weights / torch.clamp(row_weights.sum(), min=1.0)
        mel = (w * mel_sq.mean(dim=(1, 2))).sum()
        post = (w * post_sq.mean(dim=(1, 2))).sum()
        gate = (w * gate_bce.mean(dim=1)).sum()
    return LossBreakdown(mel + post + gate, mel, post, gate)
