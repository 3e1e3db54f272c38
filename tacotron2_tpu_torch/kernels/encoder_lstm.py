"""Encoder BiLSTM forward: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``tacotron2_tpu/kernels/encoder_lstm.py``
``_make_fwd_kernel`` (via ``_fwd_call`` and ``bilstm_scans``). Both
directions scan together: the forward direction over ``xs``, the backward
one over ``xs_rev``, the caller's per-row length-reversed copy. Each step
computes ``g = [x_t ; h_{t-1}] @ [wi ; wh] + b`` and the LSTM cell, with the
TPU kernel's cast points: operands in the compute dtype, fp32 sums and fp32
cell state; the gate and h stacks come back in the compute dtype.

``bilstm_forward`` takes the kernel (``csrc/encoder_lstm.cu``) for CUDA
tensors and the plain version for CPU tensors; nothing else picks between
them. The CUDA source's header note says what bounds the kernel on the H100
and how its design answers it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels.lstm_layout import from_blocks, to_blocks

_ENC_UNITS = 4  # hidden units per block in csrc/encoder_lstm.cu

Stacks = Tuple[torch.Tensor, ...]


class PackedBiLSTM(NamedTuple):
    """Both directions' weights as the kernel takes them
    (``pack_direction``); packed once per model and dtype."""
    wf: torch.Tensor
    bf: torch.Tensor
    wb: torch.Tensor
    bb: torch.Tensor


def pack_direction(p, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction's weights as the kernel takes them: ``[wi ; wh]`` in
    ``dtype``, block-major for blocks of 4 units (``lstm_layout``), shape
    (H // 4, N + H, 16), and the summed fp32 bias."""
    w = torch.cat([p.w_ih, p.w_hh], dim=1).t().to(dtype)
    bias = (p.b_ih + p.b_hh).float().contiguous()
    return to_blocks(w, _ENC_UNITS), bias


def pack_bilstm(fwd, bwd, dtype: torch.dtype) -> PackedBiLSTM:
    """``fwd``/``bwd`` carry ``w_ih, w_hh, b_ih, b_hh``
    (``ops.lstm.LSTMWeights``)."""
    return PackedBiLSTM(*pack_direction(fwd, dtype),
                        *pack_direction(bwd, dtype))


def bilstm_forward_plain(wf: torch.Tensor, bf: torch.Tensor,
                         wb: torch.Tensor, bb: torch.Tensor,
                         xs: torch.Tensor, xsr: torch.Tensor) -> Stacks:
    """The plain PyTorch version: same inputs, outputs and cast points as
    the kernel. Weights as ``pack_direction`` gives them; xs/xsr: (B, T, N)
    in the weights' dtype. Returns
    (gf, gb, hf, hb, cf, cb): gates (T, B, 4H) and h (T, B, H) in that
    dtype, c (T, B, H) fp32."""
    bilstm_forward_plain.calls += 1
    dtype = wf.dtype
    B, T, N = xs.shape
    H = wf.shape[0] * _ENC_UNITS
    out = []
    for x, w, bias in ((xs, wf, bf), (xsr, wb, bb)):
        w32 = from_blocks(w).float()
        h = torch.zeros(B, H, dtype=dtype, device=xs.device)
        c = torch.zeros(B, H, device=xs.device)
        gs, hs, cs = [], [], []
        for t in range(T):
            g = torch.cat([x[:, t], h], dim=1).float() @ w32 + bias
            i, f, gg, o = g.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
            gs.append(g.to(dtype))
            hs.append(h)
            cs.append(c)
        out.append((torch.stack(gs), torch.stack(hs), torch.stack(cs)))
    (gf, hf, cf), (gb, hb, cb) = out
    return gf, gb, hf, hb, cf, cb


bilstm_forward_plain.calls = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"encoder_lstm_fwd": [_I] + [_P] * 12 + [_I] * 4 + [_P]}


def _check_kernel_inputs(wf, bf, wb, bb, xs, xsr) -> None:
    dtype = wf.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"encoder kernel takes fp32 or bf16, got {dtype}")
    B, T, N = xs.shape
    nb, K, C = wf.shape
    H = nb * _ENC_UNITS
    G = 4 * H
    if K != N + H or C != 4 * _ENC_UNITS:
        raise ValueError(f"weights {tuple(wf.shape)} do not fit x width {N} "
                         f"(need (H/{_ENC_UNITS}, N+H, {4 * _ENC_UNITS}))")
    for name, t, shape, dt in (("wb", wb, wf.shape, dtype),
                               ("bf", bf, (G,), torch.float32),
                               ("bb", bb, (G,), torch.float32),
                               ("xsr", xsr, xs.shape, dtype),
                               ("xs", xs, xs.shape, dtype)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise ValueError(f"{name}: expected {tuple(shape)} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (wf, bf, wb, bb, xs, xsr):
        if not t.is_cuda or t.device != xs.device or not t.is_contiguous():
            raise ValueError("encoder kernel inputs must be contiguous "
                             "tensors on one CUDA device")


def bilstm_forward(wf: torch.Tensor, bf: torch.Tensor, wb: torch.Tensor,
                   bb: torch.Tensor, xs: torch.Tensor,
                   xsr: torch.Tensor) -> Stacks:
    """Both directions' scans; same contract as ``bilstm_forward_plain``.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if not xs.is_cuda:
        return bilstm_forward_plain(wf, bf, wb, bb, xs, xsr)
    _check_kernel_inputs(wf, bf, wb, bb, xs, xsr)
    B, T, N = xs.shape
    H = wf.shape[0] * _ENC_UNITS
    dtype = wf.dtype
    dev = xs.device
    gf = torch.empty(T, B, 4 * H, dtype=dtype, device=dev)
    gb = torch.empty_like(gf)
    hf = torch.empty(T, B, H, dtype=dtype, device=dev)
    hb = torch.empty_like(hf)
    cf = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    cb = torch.empty_like(cf)
    lib = _build.load("encoder_lstm", _SIGNATURES)
    status = lib.encoder_lstm_fwd(
        int(dtype == torch.bfloat16), xs.data_ptr(), xsr.data_ptr(),
        wf.data_ptr(), bf.data_ptr(), wb.data_ptr(), bb.data_ptr(),
        gf.data_ptr(), gb.data_ptr(), hf.data_ptr(), hb.data_ptr(),
        cf.data_ptr(), cb.data_ptr(), B, T, N, H,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "encoder_lstm_fwd")
    bilstm_forward.launches += 1
    return gf, gb, hf, hb, cf, cb


bilstm_forward.launches = 0


def bilstm_scans(packed: PackedBiLSTM, xs: torch.Tensor, xsr: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions' LSTM outputs: (hf, hb_scan), each (B, T, H) fp32,
    hb_scan in xsr's (reversed) time order; the products in the packed
    weights' dtype."""
    dtype = packed.wf.dtype
    stacks = bilstm_forward(*packed, xs.to(dtype).contiguous(),
                            xsr.to(dtype).contiguous())
    hf, hb = stacks[2], stacks[3]
    return (hf.transpose(0, 1).float(), hb.transpose(0, 1).float())
