"""Operand rounding for the references: none (fp32), or the lower
precision of the controls of ``correct`` (fp8 e4m3 with one scale a
tensor). Rounding is applied to both operands of every product, and in
training to the gradient that flows back through each operand, so that the
backward's products are rounded too."""

from __future__ import annotations

from typing import Callable, Optional

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


_ROUND = {"fp8": _fp8}


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _ROUND[kind](x)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[ctx.kind](g), None


def rounding(kind: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding of ``kind`` (None or "fp8")."""
    if kind is None:
        return lambda t: t
    if kind not in _ROUND:
        raise ValueError(f"unknown precision {kind!r}")
    return lambda t: _Rounded.apply(t, kind)
