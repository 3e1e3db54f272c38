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
and the plain version for CPU tensors; nothing else picks between them. Any
K and N are taken (ragged edges are masked in the kernel); rows beyond 8 are
taken 8 at a time by the kernel's entry point.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from tacotron2_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"int8_matmul": [_P] * 4 + [_I] * 3 + [_P]}


def quantize_int8(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float weights -> (w_q int8 (K, N), scale fp32 (N,)), symmetric
    per output channel: w ~= w_q * scale[None, :]."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.ascontiguousarray(w, np.float32)  # row-major, as the kernel reads
    absmax = np.abs(w).max(axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return torch.from_numpy(w_q), torch.from_numpy(scale)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: x (B, K) float, w_q (K, N) int8, scale
    (N,) fp32 -> (B, N) fp32. x rounded to bf16, int8 exact, fp32 sums."""
    int8_matmul_plain.calls += 1
    xr = x.to(torch.bfloat16).float()
    return (xr @ w_q.float()) * scale


int8_matmul_plain.calls = 0


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) float @ dequant(w_q (K, N) int8, scale (N,)) -> (B, N)
    fp32. CUDA tensors launch the kernel (or raise); CPU tensors take the
    plain version."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not multiply w_q "
                         f"{tuple(w_q.shape)}")
    K, N = w_q.shape
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or tuple(scale.shape) != (N,) or not x.is_floating_point():
        raise TypeError(f"expected float x, int8 w_q and fp32 scale ({N},), "
                        f"got {x.dtype}, {w_q.dtype}, {scale.dtype} "
                        f"{tuple(scale.shape)}")
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, scale)
    if w_q.device != x.device or scale.device != x.device:
        raise ValueError("x, w_q and scale must lie on one CUDA device")
    if not (w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("w_q and scale must be contiguous")
    B = x.shape[0]
    xf = x.float().contiguous()
    out = torch.empty(B, N, device=x.device)
    lib = _build.load("int8_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        status = lib.int8_matmul(
            xf.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, K, N, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, status, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
