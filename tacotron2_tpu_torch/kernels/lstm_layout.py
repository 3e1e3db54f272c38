"""Block-major layout of packed LSTM weights, as the CUDA kernels read them.

A packed LSTM weight ``[wi ; wh]`` is a (K, 4H) row-major matrix with the
gate blocks i, f, g, o side by side. A kernel block owns ``units`` hidden
units and needs all four gates' columns of them; in the row-major matrix
those are four runs of ``units`` values per row, each half of a 32-byte
sector whose other half belongs to the next block. The block-major layout
stores each block's (K, 4*units) slab contiguously, column
``g*units + u`` holding gate g of the block's unit u, so every load a
block makes is whole sectors of its own.
"""

from __future__ import annotations

import torch


def to_blocks(w: torch.Tensor, units: int) -> torch.Tensor:
    """(K, 4H) row-major -> (H // units, K, 4 * units) block-major."""
    K, G = w.shape
    nb = G // 4 // units
    return (w.reshape(K, 4, nb, units).permute(2, 0, 1, 3)
            .reshape(nb, K, 4 * units).contiguous())


def from_blocks(wb: torch.Tensor) -> torch.Tensor:
    """(H // units, K, 4 * units) block-major -> (K, 4H) row-major."""
    nb, K, C = wb.shape
    units = C // 4
    return wb.reshape(nb, K, 4, units).permute(1, 2, 0, 3).reshape(K, 4 * nb * units)
