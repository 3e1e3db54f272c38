"""Encoder BiLSTM: hand-written CUDA kernels and their plain versions.

The forward replaces the TPU kernel ``tacotron2_tpu/kernels/encoder_lstm.py``
``_make_fwd_kernel`` (via ``_fwd_call`` and ``bilstm_scans``), the backward
its ``_make_bwd_kernel`` (via ``_bwd_call``). Both
directions scan together: the forward direction over ``xs``, the backward
one over ``xs_rev``, the caller's per-row length-reversed copy. Each step
computes ``g = [x_t ; h_{t-1}] @ [wi ; wh] + b`` and the LSTM cell, with the
TPU kernel's cast points: operands in the compute dtype, fp32 sums and fp32
cell state; the gate and h stacks come back in the compute dtype.

``bilstm_forward`` and ``bilstm_backward`` take the kernels
(``csrc/encoder_lstm.cu``) for CUDA tensors and the plain versions for CPU
tensors; nothing else picks between them. At bf16 (H 128 or 256, N in
16s) the forward is one launch on thread-block clusters that keep the
weights in shared memory for the whole scan (``forward_plan`` says whether
a shape takes it); at bf16, H = 256 and N in 32s the backward chain is one
such launch too, its dx then one tensor-core product per direction
(``backward_plan``); fp32 and other shapes take one launch (the backward
two) a step.
``BiLSTMScans`` is the autograd Function around the two: its backward runs
the data-gradient chain through ``bilstm_backward`` and takes the weight
gradients outside it, as single products over T*B (the TPU package's
``_scan_bwd``). The CUDA source's header note says what bounds the kernels
on the H100 and how their design answers it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels.lstm_layout import (from_blocks, to_blocks,
                                                     to_col_tiles)

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
_SIGNATURES = {"encoder_lstm_fwd": [_I] + [_P] * 12 + [_I] * 4 + [_P],
               "encoder_lstm_bwd": [_I] + [_P] * 16 + [_I] * 4 + [_P],
               "encoder_lstm_fwd_plan": [_I] * 4 + [ctypes.POINTER(_I)] * 2,
               "encoder_lstm_bwd_plan": [_I] * 4 + [ctypes.POINTER(_I)] * 2}


def _plan(entry: str, B: int, N: int, H: int, dtype: torch.dtype,
          device: torch.device) -> Tuple[str, int, int]:
    lib = _build.load("encoder_lstm", _SIGNATURES)
    needed, active = _I(0), _I(0)
    with torch.cuda.device(device):
        code = getattr(lib, entry)(int(dtype == torch.bfloat16), B, N, H,
                                   ctypes.byref(needed),
                                   ctypes.byref(active))
    if code < 0:
        _build.check(lib, -code, entry)
    if code == 0:
        return "per-step", 0, 0
    return "cluster", needed.value, active.value


def forward_plan(B: int, N: int, H: int, dtype: torch.dtype,
                 device: torch.device) -> Tuple[str, int, int]:
    """The forward kernel's design at these shapes, as its C entry point
    picks it: ("cluster", clusters the launch needs, clusters the device
    holds at once) or ("per-step", 0, 0). Builds the kernel if needed."""
    return _plan("encoder_lstm_fwd_plan", B, N, H, dtype, device)


def backward_plan(B: int, N: int, H: int, dtype: torch.dtype,
                  device: torch.device) -> Tuple[str, int, int]:
    """The backward chain's design at these shapes, as ``forward_plan``:
    ("cluster", needed, active) for the one-launch chain (bf16, H = 256, N
    in 32s), ("per-step", 0, 0) for two launches a step."""
    return _plan("encoder_lstm_bwd_plan", B, N, H, dtype, device)


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


def bilstm_scans(packed: PackedBiLSTM, xs: torch.Tensor, xsr: torch.Tensor,
                 weights: Tuple[torch.Tensor, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions' LSTM outputs: (hf, hb_scan), each (B, T, H) fp32,
    hb_scan in xsr's (reversed) time order; the products in the packed
    weights' dtype. Differentiable through ``BiLSTMScans``: ``weights``
    holds the eight tensors ``packed`` was made from (each direction's
    ``w_ih, w_hh, b_ih, b_hh``)."""
    return BiLSTMScans.apply(xs, xsr, packed, *weights)


# ------------------------------------------------------------------ backward

def cell_backward(g: torch.Tensor, c_prev: torch.Tensor, c_new: torch.Tensor,
                  dh: torch.Tensor, dc_in: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM cell's backward (the TPU kernels' ``lstm_gates_bwd``): from
    the stored gate pre-activations g (B, 4H), c_{t-1}, c_t, the cotangent
    of h_t and the carried cotangent of c_t, the fp32 gate cotangents
    (B, 4H) and the cotangent of c_{t-1}."""
    i, f, gg, o = g.float().chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    gg = torch.tanh(gg)
    tc = torch.tanh(c_new)
    do = dh * tc
    dc = dc_in + dh * o * (1.0 - tc * tc)
    dg = torch.cat([dc * gg * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                    dc * i * (1.0 - gg * gg), do * o * (1.0 - o)], dim=-1)
    return dg, dc * f


def shift(stack: torch.Tensor) -> torch.Tensor:
    """stack[t] -> the value at t-1, zeros at t=0 (the initial state)."""
    return torch.cat([torch.zeros_like(stack[:1]), stack[:-1]])


def lstm_weight_grads(x: torch.Tensor, h: torch.Tensor, dg: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d weight_ih (4H, in), d weight_hh (4H, H), d bias (4H,)) fp32 from
    time-major stacks x (T, B, in), h (T, B, H) and dg (T, B, 4H): each one
    product over T*B of the operands as stored, with fp32 sums. h_{t-1} is h
    shifted by one step. Both of torch's biases receive the same d bias."""
    dg2 = dg.reshape(-1, dg.shape[-1]).float()
    flat = lambda s: s.reshape(-1, s.shape[-1]).float()
    return (dg2.t() @ flat(x), dg2.t() @ flat(shift(h)), dg2.sum(0))


def bilstm_backward_plain(wtf: torch.Tensor, wtb: torch.Tensor,
                          gf: torch.Tensor, gb: torch.Tensor,
                          cf: torch.Tensor, cb: torch.Tensor,
                          dhf: torch.Tensor, dhb: torch.Tensor) -> Stacks:
    """The plain PyTorch version of the backward chain, with the kernel's
    inputs, outputs and cast points. wt*: [wi ; wh]^T (4H, N + H) in the
    operand dtype; g*: (T, B, 4H) as the forward stored them; c*, dh*:
    (T, B, H) fp32. Returns (dgf, dgb, dxf, dxb): gate cotangents
    (T, B, 4H) rounded to the operand dtype and dx (T, B, N) fp32."""
    bilstm_backward_plain.calls += 1
    dtype = wtf.dtype
    T, B, G = gf.shape
    H = G // 4
    out = []
    for wt, g, c, dh in ((wtf, gf, cf, dhf), (wtb, gb, cb, dhb)):
        w32 = wt.float()
        N = w32.shape[1] - H
        dh_carry = torch.zeros(B, H, device=g.device)
        dc = torch.zeros(B, H, device=g.device)
        dgs, dxs = [None] * T, [None] * T
        for t in reversed(range(T)):
            c_prev = c[t - 1] if t else torch.zeros_like(dc)
            dgt, dc = cell_backward(g[t], c_prev, c[t], dh_carry + dh[t], dc)
            dgs[t] = dgt.to(dtype)
            dx = dgs[t].float() @ w32
            dxs[t], dh_carry = dx[:, :N], dx[:, N:]
        out.append((torch.stack(dgs), torch.stack(dxs)))
    (dgf, dxf), (dgb, dxb) = out
    return dgf, dgb, dxf, dxb


bilstm_backward_plain.calls = 0


def bilstm_backward(wtf: torch.Tensor, wtb: torch.Tensor, gf: torch.Tensor,
                    gb: torch.Tensor, cf: torch.Tensor, cb: torch.Tensor,
                    dhf: torch.Tensor, dhb: torch.Tensor) -> Stacks:
    """Both directions' backward chains; same contract as
    ``bilstm_backward_plain``. CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    if not gf.is_cuda:
        return bilstm_backward_plain(wtf, wtb, gf, gb, cf, cb, dhf, dhb)
    dtype = wtf.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"encoder backward kernel takes fp32 or bf16, got "
                        f"{dtype}")
    T, B, G = gf.shape
    H = G // 4
    K = wtf.shape[1]
    N = K - H
    f32 = torch.float32
    for name, t, shape, dt in (("wtf", wtf, (G, K), dtype),
                               ("wtb", wtb, (G, K), dtype),
                               ("gf", gf, (T, B, G), dtype),
                               ("gb", gb, (T, B, G), dtype),
                               ("cf", cf, (T, B, H), f32),
                               ("cb", cb, (T, B, H), f32),
                               ("dhf", dhf, (T, B, H), f32),
                               ("dhb", dhb, (T, B, H), f32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: expected {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_cuda or t.device != gf.device or not t.is_contiguous():
            raise ValueError("encoder backward kernel inputs must be "
                             "contiguous tensors on one CUDA device")
    dev = gf.device
    tf, tb = to_col_tiles(wtf), to_col_tiles(wtb)
    dgf, dgb = torch.empty_like(gf), torch.empty_like(gb)
    dxf = torch.empty(T, B, N, device=dev)
    dxb = torch.empty_like(dxf)
    dcf = torch.zeros(B, H, device=dev)
    dcb = torch.zeros_like(dcf)
    scrf = torch.empty(B, K, device=dev)
    scrb = torch.empty_like(scrf)
    lib = _build.load("encoder_lstm", _SIGNATURES)
    status = lib.encoder_lstm_bwd(
        int(dtype == torch.bfloat16),
        *(x.data_ptr() for x in (tf, tb, gf, gb, cf, cb, dhf, dhb, dgf, dgb,
                                 dxf, dxb, dcf, dcb, scrf, scrb)),
        B, T, N, H, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "encoder_lstm_bwd")
    bilstm_backward.launches += 1
    return dgf, dgb, dxf, dxb


bilstm_backward.launches = 0


class BiLSTMScans(torch.autograd.Function):
    """Both directions' scans, differentiable: the forward kernel
    (``bilstm_forward``), and a backward that runs ``bilstm_backward`` and
    takes the weight gradients outside it (``lstm_weight_grads``), as the
    TPU package's ``_scan_fwd``/``_scan_bwd``.

    ``apply(xs, xsr, packed, *fwd, *bwd)``: xs, xsr (B, T, N), xsr the
    per-row length-reversed copy; ``packed`` the ``PackedBiLSTM`` of the
    weights that follow, each direction's ``w_ih, w_hh, b_ih, b_hh``.
    Returns (hf, hb_scan) (B, T, H) fp32, hb_scan in xsr's time order. The
    stacks are saved in the operand dtype (x and h) and fp32 (c)."""

    @staticmethod
    def forward(ctx, xs, xsr, packed, *weights):
        dtype = packed.wf.dtype
        x, xr = xs.to(dtype).contiguous(), xsr.to(dtype).contiguous()
        gf, gb, hf, hb, cf, cb = bilstm_forward(*packed, x, xr)
        ctx.save_for_backward(x, xr, gf, gb, hf, hb, cf, cb, *weights)
        ctx.in_dtypes = (xs.dtype, xsr.dtype)
        return hf.transpose(0, 1).float(), hb.transpose(0, 1).float()

    @staticmethod
    def backward(ctx, dhf, dhb):
        x, xr, gf, gb, hf, hb, cf, cb, *w = ctx.saved_tensors
        dtype = x.dtype

        def cot(d, h):
            if d is None:
                return torch.zeros(h.shape, device=h.device)
            return d.transpose(0, 1).float().contiguous()

        wt = [torch.cat([w_ih, w_hh], dim=1).to(dtype).contiguous()
              for w_ih, w_hh in ((w[0], w[1]), (w[4], w[5]))]
        dgf, dgb, dxf, dxb = bilstm_backward(wt[0], wt[1], gf, gb, cf, cb,
                                             cot(dhf, hf), cot(dhb, hb))
        grads = []
        for xx, h, dg in ((x, hf, dgf), (xr, hb, dgb)):
            d_ih, d_hh, db = lstm_weight_grads(xx.transpose(0, 1), h, dg)
            grads += [d_ih, d_hh, db, db]
        return (dxf.transpose(0, 1).to(ctx.in_dtypes[0]),
                dxb.transpose(0, 1).to(ctx.in_dtypes[1]), None, *grads)
