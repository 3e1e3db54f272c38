"""The reference's optimiser (train.py with hparams.py): clip the global
gradient norm to ``clip``, add ``weight_decay`` times the parameter (Adam's
L2 form), Adam (0.9, 0.999, eps 1e-8 after the square root,
bias-corrected), times the learning rate."""

from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, clip: float):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def resume(self, m, v, count: int) -> None:
        """Start from moments ``m``, ``v`` (by name) after ``count``
        steps."""
        self.m = {k: m[k].detach().float().clone() for k in self.m}
        self.v = {k: v[k].detach().float().clone() for k in self.v}
        self.count = int(count)

    def effective_grads(self, grads, params):
        """The gradient as the moments take it: clipped, plus the L2
        term."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        return {k: grads[k] * scale + self.wd * params[k] for k in grads}

    @torch.no_grad()
    def step(self, params, grads) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the effective gradients."""
        self.count += 1
        c1 = 1 - B1 ** self.count
        c2 = 1 - B2 ** self.count
        eff = self.effective_grads(grads, params)
        for k, g in eff.items():
            self.m[k] = B1 * self.m[k] + (1 - B1) * g
            self.v[k] = B2 * self.v[k] + (1 - B2) * g * g
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + EPS)
            params[k].sub_(self.lr * upd)
        return eff
