"""Parameter initializers driven by a ``torch.Generator``.

The reference's init scheme (Xavier-uniform with per-layer nonlinearity
gains, reference layers.py:13-15,34-35; the scaled-uniform embedding init,
reference model.py:466-468; torch's LSTM default U(-1/sqrt(H), 1/sqrt(H))).
Shapes are torch's own: dense (out, in), conv (out, in, k).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# torch.nn.init.calculate_gain values for the nonlinearities used here.
GAINS = {
    "linear": 1.0,
    "sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
}


def uniform(shape: Sequence[int], bound: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) in fp32 on the CPU."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound


def xavier_uniform(shape: Sequence[int], fan_in: int, fan_out: int,
                   gain_for: str = "linear",
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot-uniform: U(-a, a) with a = gain * sqrt(6 / (fan_in + fan_out))."""
    bound = GAINS[gain_for] * math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(shape, bound, generator)


def dense_init(in_dim: int, out_dim: int, gain_for: str = "linear",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(out, in) weight of a linear layer."""
    return xavier_uniform((out_dim, in_dim), in_dim, out_dim, gain_for,
                          generator)


def conv1d_init(kernel_size: int, in_ch: int, out_ch: int,
                gain_for: str = "linear",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(out, in, k) weight; torch fan counts include the kernel width."""
    return xavier_uniform((out_ch, in_ch, kernel_size), in_ch * kernel_size,
                          out_ch * kernel_size, gain_for, generator)


def embedding_init(n_symbols: int, dim: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-v, v) with v = sqrt(3) * sqrt(2 / (n_symbols + dim))."""
    val = math.sqrt(3.0) * math.sqrt(2.0 / (n_symbols + dim))
    return uniform((n_symbols, dim), val, generator)


def lstm_uniform(shape: Sequence[int], hidden_dim: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch LSTM/LSTMCell default: U(-1/sqrt(H), 1/sqrt(H))."""
    return uniform(shape, 1.0 / math.sqrt(hidden_dim), generator)
