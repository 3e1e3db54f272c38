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
tensor-core product (``csrc/tc_product.cuh``) two tiles per block; the
forward scan's tensor-core product reads the block-major slabs of 8 units
as such column tiles of 32. The persistent decoder chunk
(``csrc/persistent_chunk.cuh``, batched and single-utterance) reads
``[wi ; wh]^T`` as the A operand of ``mma.sync.m16n8k16`` in the
instruction's fragment order (``to_mma_tiles``); the encoder's cluster
kernel (``csrc/encoder_lstm.cu``) stages its block's rows of the
block-major slabs of 4 units in shared memory.
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



MMA_UNITS = 4  # PC_UG of csrc/persistent_chunk.cuh: 4 units x 4 gates


def _mma_lanes():
    """(row, k) of the 8 bf16 values each of the 32 lanes holds in the A
    fragment of ``mma.sync.m16n8k16`` (a0..a3, two values each, lower k
    first): lane l has g = l // 4, t = l % 4; a0 (g, 2t..2t+1), a1 (g+8,
    2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)."""
    lane = torch.arange(32)
    g, t = (lane // 4)[:, None], (lane % 4)[:, None]
    v = torch.arange(8)[None, :]
    reg, half = v // 2, v % 2
    return g + 8 * (reg % 2), 2 * t + half + 8 * (reg // 2)


def to_mma_tiles(w: torch.Tensor, units: int = MMA_UNITS) -> torch.Tensor:
    """(K, 4H) row-major ``[wi ; wh]`` -> (H // units, K // 16, 32, 8): the
    transposed weight in groups of ``units`` hidden units, each group's 16
    gate columns (gate-major: row q * units + u is gate q of unit u) cut
    into k16 steps, each step in the A-fragment order of one warp (lane,
    value). K must be a multiple of 16."""
    K, G = w.shape
    H = G // 4
    wt = w.t().reshape(4, H // units, units, K).permute(1, 0, 2, 3)
    wt = wt.reshape(H // units, 4 * units, K // 16, 16).permute(0, 2, 1, 3)
    row, kk = _mma_lanes()
    return wt[:, :, row, kk].contiguous()


def from_mma_tiles(wm: torch.Tensor) -> torch.Tensor:
    """(H // units, K // 16, 32, 8) -> (K, 4H) row-major: ``to_mma_tiles``
    undone."""
    ng, nk, _, _ = wm.shape
    units = 4
    row, kk = _mma_lanes()
    wt = wm.new_zeros(ng, nk, 16, 16)
    wt[:, :, row, kk] = wm
    wt = wt.permute(0, 2, 1, 3).reshape(ng, 4, units, nk * 16)
    return wt.permute(1, 0, 2, 3).reshape(4 * ng * units, nk * 16).t()
