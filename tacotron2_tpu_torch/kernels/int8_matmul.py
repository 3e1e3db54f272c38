"""int8 weight-only matmul for serving: hand-written CUDA kernel and its
plain version.

Replaces the TPU kernel ``tacotron2_tpu/kernels/int8_matmul.py`` ``_kernel``
(via ``int8_matmul``): ``out = (bf16(x) @ bf16(w_q)) * scale`` with fp32
sums, the int8 weights widened inside the kernel so that the dequantised
matrix never exists in device memory. Quantisation is symmetric per output
channel (``scale = absmax / 127``, round half to even), host code. x is
rounded to bf16 inside the product whatever the model's compute dtype; the
bias is the caller's, added in fp32.

``int8_matmul`` takes the kernel (``csrc/int8_matmul.cu``) for CUDA tensors
and the plain version for CPU tensors; nothing else picks between them. The
kernel reads the weights in the order ``pack_int8`` lays them out, packed
once per model (``ops.lstm.QuantizedLSTMCell`` keeps the packed copy); any
K and N are taken (the packing pads them with zeros), and up to 32 rows a
launch at the decoder cells' depths.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from tacotron2_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_matmul": [_P, _I, _P, _P, _P, _I, _I, _I, _P]}
TILE_N = 16   # columns per packed tile: the m16 side of the products
CHUNK_K = 32  # rows of K per packed chunk: two k16 products


def quantize_int8(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float weights -> (w_q int8 (K, N), scale fp32 (N,)), symmetric
    per output channel: w ~= w_q * scale[None, :]."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.ascontiguousarray(w, np.float32)
    absmax = np.abs(w).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return torch.from_numpy(w_q), torch.from_numpy(scale)


def pack_int8(w_q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> (ceil(N/16), ceil(K/32), 32, 16) uint8 on w_q's
    device: the kernel's lane order. Tile j, chunk c holds columns
    16j .. 16j+15 and rows 32c .. 32c+31 (zeros past N and K); lane
    l = 4g + q holds 16 bytes, byte 8h + 2r + e being the element
    (k = 32c + 16h + 8(r >> 1) + 2q + e, n = 16j + g + 8(r & 1)): register
    r of the A fragment of the chunk's k16 product h (PTX's m16n8k16 A
    layout with the weight columns as its rows). Each byte is biased by 128
    (v ^ 0x80), as the kernel's widening takes it."""
    K, N = w_q.shape
    kc, nt = -(-K // CHUNK_K), -(-N // TILE_N)
    w = torch.zeros(kc * CHUNK_K, nt * TILE_N, dtype=torch.int8,
                    device=w_q.device)
    w[:K, :N] = w_q
    # k = (c, h, kh, q, e), n = (j, mh, g) -> [j, c, g, q, h, kh, mh, e]
    w = w.view(kc, 2, 2, 4, 2, nt, 2, 8).permute(5, 0, 7, 3, 1, 2, 6, 4)
    return (w.reshape(nt, kc, 32, 16).view(torch.uint8) ^ 0x80).contiguous()


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: x (B, K) float, w_q (K, N) int8, scale
    (N,) fp32 -> (B, N) fp32. x rounded to bf16, int8 exact, fp32 sums."""
    int8_matmul_plain.calls += 1
    xr = x.to(torch.bfloat16).float()
    return (xr @ w_q.float()) * scale


int8_matmul_plain.calls = 0

_LIB = None  # the loaded library, resolved once


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = _build.load("int8_matmul", _SIGNATURES)
    return _LIB


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
                packed: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, K) float @ dequant(w_q (K, N) int8, scale (N,)) -> (B, N)
    fp32. CUDA tensors launch the kernel (or raise): x in fp32 or bf16 is
    read as it is, ``packed`` is ``pack_int8(w_q)`` (required: the caller
    packs once and keeps it), ``out`` an optional (B, N) fp32 tensor to
    write. CPU tensors take the plain version."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not multiply w_q "
                         f"{tuple(w_q.shape)}")
    K, N = w_q.shape
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (N,) or not x.is_floating_point():
        raise TypeError(f"expected float x, int8 w_q and fp32 scale ({N},), "
                        f"got {x.dtype}, {w_q.dtype}, {scale.dtype} "
                        f"{tuple(scale.shape)}")
    B = x.shape[0]
    if not x.is_cuda:
        if out is not None and (out.shape != (B, N) or out.is_cuda):
            raise ValueError(f"out must be a ({B}, {N}) tensor on the CPU")
        y = int8_matmul_plain(x, w_q, scale)
        return y if out is None else out.copy_(y)
    dev = x.get_device()
    if w_q.get_device() != dev or scale.get_device() != dev:
        raise ValueError("x, w_q and scale must lie on one CUDA device")
    if not (w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("w_q and scale must be contiguous")
    if (packed is None or packed.dtype != torch.uint8
            or packed.get_device() != dev
            or packed.shape != (-(-N // TILE_N), -(-K // CHUNK_K), 32, 16)
            or not packed.is_contiguous()):
        raise ValueError(f"packed is not pack_int8 of a ({K}, {N}) w_q on "
                         f"cuda:{dev}")
    if out is None:
        out = scale.new_empty((B, N))
    elif (out.shape != (B, N) or out.dtype != torch.float32
          or out.get_device() != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({B}, {N}) fp32 tensor "
                         f"on cuda:{dev}")
    if x.dtype != torch.float32 and x.dtype != torch.bfloat16:
        x = x.float()
    if not x.is_contiguous():
        x = x.contiguous()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return int8_matmul(x, w_q, scale, packed=packed, out=out)
    lib = _LIB or _lib()
    status = lib.int8_matmul(
        x.data_ptr(), x.dtype == torch.bfloat16, packed.data_ptr(),
        scale.data_ptr(), out.data_ptr(), B, K, N,
        torch._C._cuda_getCurrentRawStream(dev))
    if status:
        _build.check(lib, status, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
