"""Block-major layout of packed LSTM weights, as the CUDA kernels read them.

A packed LSTM weight ``[wi ; wh]`` is a (K, 4H) row-major matrix with the
gate blocks i, f, g, o side by side. A kernel block owns ``units`` hidden
units and needs all four gates' columns of them; in the row-major matrix
those are four runs of ``units`` values per row, each half of a 32-byte
sector whose other half belongs to the next block. The block-major layout
stores each block's (K, 4*units) slab contiguously, column
``g*units + u`` holding gate g of the block's unit u, so every load a
block makes is whole sectors of its own. The backward kernels' products
(rows @ a transposed weight) read plain column tiles the same way
(``to_col_tiles``): the CUDA-core tile product a tile per block, the
tensor-core product (``csrc/tc_product.cuh``) two tiles per block.
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


TILE_COLS = 32  # TP_COLS of csrc/lstm_cell.cuh


def to_col_tiles(w: torch.Tensor, cols: int = TILE_COLS) -> torch.Tensor:
    """(K, N) row-major -> (ceil(N / cols), K, cols): each tile's columns
    contiguous, zero columns past N. The backward kernels' products
    (``tile_product_kernel``) read a block's tile as whole sectors."""
    K, N = w.shape
    nt = -(-N // cols)
    w = torch.nn.functional.pad(w, (0, nt * cols - N))
    return w.reshape(K, nt, cols).permute(1, 0, 2).contiguous()


def from_col_tiles(wt: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(N / cols), K, cols) -> (K, n) row-major: ``to_col_tiles``
    undone, the zero columns past n dropped."""
    nt, K, cols = wt.shape
    return wt.permute(1, 0, 2).reshape(K, nt * cols)[:, :n]

