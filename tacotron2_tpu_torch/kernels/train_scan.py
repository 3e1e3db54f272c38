"""Teacher-forced decoder scan of the training step: hand-written CUDA
kernels and their plain versions.

``forward_residuals`` replaces the TPU kernel
``tacotron2_tpu/kernels/train_scan.py`` ``_make_kernel`` (via ``_scan_call``
and ``forward_residuals``): the whole forward over T steps, emitting the
eight residual stacks of ``models/decoder_vjp.py`` (``Residuals``).
At bf16 the forward's two LSTM products run on the tensor cores with the
cell in their epilogue, and its energies as a tensor-core location
product; at fp32, and at bf16 shapes outside that range
(``csrc/train_scan.cu`` ``fwd_tc_ok``), on the CUDA cores.
``backward_chain`` replaces its ``_make_bwd_kernel`` (via
``_bwd_scan_call`` and ``backward_chain``) in the rematerialising form: the
reverse-time data-gradient chain, with d_processed, d_K2 and d_v
accumulated in fp32 in the kernel. At bf16 its products run on the tensor
cores; at fp32, and at bf16 shapes the tensor-core chain does not take
(``csrc/train_scan.cu`` ``tc_shapes_ok``), on the CUDA cores.

The math is the TPU kernels', not their layout. The TPU kernels evaluate
the location conv as a windowed banded-Toeplitz product for the matrix
unit (``band``/``selv``/``rep1``/``d_band``); here it is the conv itself,
with ``K2 = location_conv ⊛ location_dense`` folded at pack time (as the
serving chunk, ``kernels/decoder_batch.py``), and the backward returns
d_K2 (ks, 2, datt) and d_v, which ``models/decoder_vjp.py`` turns into the
location conv/dense, v and query gradients by the chain rule of the TPU
package's ``attention_param_grads``. No encoder position is padded: masked
positions come out with w = 0 and receive zero gradient. The cast points
are the TPU kernels' (see ``csrc/train_scan.cu``); the plain versions here
share them, which is what makes the comparison on the card tight.

``forward_residuals`` and ``backward_chain`` take the kernels for CUDA
tensors and the plain versions for CPU tensors; nothing else picks between
them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels.decoder_batch import _cell
from tacotron2_tpu_torch.kernels.encoder_lstm import cell_backward
from tacotron2_tpu_torch.kernels.lstm_layout import (from_blocks,
                                                     from_col_tiles, to_blocks,
                                                     to_col_tiles)

_UNITS = 8          # hidden units per scan_lstm_kernel block (TS_UNITS)
_AB_THREADS = 512   # attn_bwd_kernel threads: datt must divide it

Keep = Tuple[torch.Tensor, torch.Tensor]


class ScanWeights(NamedTuple):
    """The decoder core's weights as the scan kernels take them
    (``pack_scan_weights``), in the operand dtype unless noted."""
    # block-major at 8 units: the CUDA-core forward's slabs, and the column
    # tiles of 32 (4 gates x 8 units) of the tensor-core forward's product
    w1: torch.Tensor    # (A/8, P+E+A, 32) attention LSTM [wi ; wh], block-major
    b1: torch.Tensor    # (4A,) fp32 summed bias
    w2: torch.Tensor    # (D/8, A+E+D, 32) decoder LSTM, block-major
    b2: torch.Tensor    # (4D,) fp32
    wq: torch.Tensor    # (A, datt) query, (in, out)
    k2: torch.Tensor    # (ks, 2, datt) location conv folded through dense
    v: torch.Tensor     # (datt,)
    vf: torch.Tensor    # (datt,) fp32 v, as the backward's d_feat takes it
    # the backward's products read their weights column-tiled
    # (lstm_layout.to_col_tiles), made here once
    wta: torch.Tensor   # (ceil(K1/32), 4A, 32) attention LSTM [wi ; wh]^T
    wtd: torch.Tensor   # (ceil(K2/32), 4D, 32) decoder LSTM [wi ; wh]^T
    wqt: torch.Tensor   # (A/32, datt, 32) query (out, in) = wq^T
    wqc: torch.Tensor   # (datt/32, A, 32) query (in, out) = wq, the
    #                     forward's and the backward's query product


class Residuals(NamedTuple):
    """The forward's per-step stacks, time-major (T, B, ...), as
    ``decoder_vjp._Residuals`` of the JAX package."""
    ga: torch.Tensor      # (T, B, 4A) attention-LSTM gates, operand dtype
    gd: torch.Tensor      # (T, B, 4D) decoder-LSTM gates, operand dtype
    att_h: torch.Tensor   # (T, B, A) post-dropout attention h, operand dtype
    dec_h: torch.Tensor   # (T, B, D) post-dropout decoder h, operand dtype
    att_c: torch.Tensor   # (T, B, A) fp32
    dec_c: torch.Tensor   # (T, B, D) fp32
    ctx: torch.Tensor     # (T, B, E) fp32
    w: torch.Tensor       # (T, B, Ti) fp32 attention weights


class ChainGrads(NamedTuple):
    """What the backward chain returns."""
    dga: torch.Tensor     # (T, B, 4A) operand dtype
    dgd: torch.Tensor     # (T, B, 4D) operand dtype
    d_prenet: torch.Tensor  # (T, B, P) fp32
    d_ctx: torch.Tensor   # (T, B, E) operand dtype: each step's ctx cotangent
    d_q: torch.Tensor     # (T, B, datt) fp32
    d_processed: torch.Tensor  # (B, Ti, datt) fp32, accumulated in fp32
    d_k2: torch.Tensor    # (ks, 2, datt) fp32
    d_v: torch.Tensor     # (datt,) fp32


def pack_scan_weights(att_rnn, query_w: torch.Tensor, v_w: torch.Tensor,
                      conv_w: torch.Tensor, dense_w: torch.Tensor, dec_rnn,
                      dtype: torch.dtype) -> ScanWeights:
    """Pack the decoder core for the scan kernels. ``att_rnn``/``dec_rnn``
    carry ``w_ih, w_hh, b_ih, b_hh`` (``ops.lstm.LSTMWeights``); query_w
    (datt, A), v_w (1, datt), conv_w (F, 2, ks) and dense_w (datt, F) are
    the torch modules' weights. Not differentiated: the Function's backward
    forms the parameter gradients itself."""
    with torch.no_grad():
        def lstm(p):
            wt = torch.cat([p.w_ih, p.w_hh], dim=1).to(dtype)   # (4H, K)
            return (to_blocks(wt.t(), _UNITS), (p.b_ih + p.b_hh).float(),
                    to_col_tiles(wt))
        w1, b1, wta = lstm(att_rnn)
        w2, b2, wtd = lstm(dec_rnn)
        k2 = torch.einsum("fck,Df->kcD", conv_w.float(), dense_w.float())
        as_w = lambda x: x.to(dtype).contiguous()
        wq = as_w(query_w.t())
        return ScanWeights(w1=w1, b1=b1.contiguous(), w2=w2,
                           b2=b2.contiguous(), wq=wq, k2=as_w(k2),
                           v=as_w(v_w[0]), vf=v_w[0].float().contiguous(),
                           wta=wta, wtd=wtd,
                           wqt=to_col_tiles(query_w.to(dtype)),
                           wqc=to_col_tiles(wq))


def keep_masks(generator: Optional[torch.Generator], T: int, B: int, a: int,
               d: int, p_att: float, p_dec: float) -> Keep:
    """(T, B, a) and (T, B, d) bool dropout keep masks of the two LSTM
    outputs, drawn from ``generator`` on its device; the forward and the
    backward use the same pair. The JAX package draws its own with
    ``train_scan.keep_masks``; its tests hand those in instead."""
    dev = generator.device if generator is not None else None
    return tuple(torch.rand(T, B, n, generator=generator, device=dev)
                 < 1.0 - p for n, p in ((a, p_att), (d, p_dec)))


def _scale(p: float) -> float:
    """The dropout's fp32 scale 1/(1-p) (1 when p = 0)."""
    return 1.0 / (1.0 - p) if p > 0 else 1.0


def _dims(sw: ScanWeights, mem: torch.Tensor):
    """(A, D, P, E, datt, ks) of packed weights and memory."""
    A = sw.wq.shape[0]
    D = sw.b2.shape[0] // 4
    E = mem.shape[2]
    P = sw.w1.shape[1] - E - A
    ks, _, datt = sw.k2.shape
    return A, D, P, E, datt, ks


# ------------------------------------------------------------------ plain

def forward_residuals_plain(sw: ScanWeights, prenet: torch.Tensor,
                            mem: torch.Tensor, proc: torch.Tensor,
                            emask: torch.Tensor, *,
                            keep: Optional[Keep] = None, p_att: float = 0.0,
                            p_dec: float = 0.0) -> Residuals:
    """The plain PyTorch version of the forward scan, with the kernel's
    inputs, outputs and cast points. prenet (T, B, P), mem (B, Ti, E) and
    proc (B, Ti, datt) in the operand dtype, emask (B, Ti) additive fp32
    (``decoder_batch.attention_inputs``); ``keep`` the two bool keep-mask
    stacks, applied with the scales 1/(1-p)."""
    forward_residuals_plain.calls += 1
    W = sw.wq.dtype
    r = lambda x: x.to(W).float()
    T, B, _ = prenet.shape
    A, D, P, E, datt, ks = _dims(sw, mem)
    Ti = mem.shape[1]
    w1, w2 = from_blocks(sw.w1).float(), from_blocks(sw.w2).float()
    wq, v = sw.wq.float(), sw.v.float()
    k2 = sw.k2.float().permute(2, 1, 0)        # (datt, 2, ks) conv weight
    memf, procf = mem.float(), proc.float()
    s_att, s_dec = _scale(p_att), _scale(p_dec)
    z = lambda *s: torch.zeros(*s, device=mem.device)
    h1, c1, h2, c2 = z(B, A), z(B, A), z(B, D), z(B, D)
    w, wc, ctx = z(B, Ti), z(B, Ti), z(B, E)
    out = []
    for t in range(T):
        g1 = torch.cat([r(prenet[t]), r(ctx), r(h1)], 1) @ w1 + sw.b1
        h1, c1 = _cell(g1, c1)
        if keep is not None:
            h1 = h1 * (keep[0][t].float() * s_att)
        q = r(r(h1) @ wq)
        win = r(torch.stack([w, wc], dim=1))
        loc = F.conv1d(win, k2, padding=(ks - 1) // 2)
        feat = torch.tanh(q[:, None, :] + loc.transpose(1, 2) + procf)
        w = torch.softmax(r(feat) @ v + emask, dim=1)
        wc = wc + w
        ctx = torch.einsum("bt,bte->be", w, memf)
        g2 = torch.cat([r(h1), r(ctx), r(h2)], 1) @ w2 + sw.b2
        h2, c2 = _cell(g2, c2)
        if keep is not None:
            h2 = h2 * (keep[1][t].float() * s_dec)
        out.append((g1.to(W), g2.to(W), h1.to(W), h2.to(W), c1, c2, ctx, w))
    return Residuals(*(torch.stack(x) for x in zip(*out)))


forward_residuals_plain.calls = 0


def backward_chain_plain(sw: ScanWeights, res: Residuals, mem: torch.Tensor,
                         proc: torch.Tensor, d_dec_h: torch.Tensor,
                         d_ctx: torch.Tensor, d_align: torch.Tensor, *,
                         keep: Optional[Keep] = None, p_att: float = 0.0,
                         p_dec: float = 0.0) -> ChainGrads:
    """The plain PyTorch version of the backward chain, with the kernel's
    inputs, outputs and cast points. ``res`` from the forward, the
    cotangents of its outputs (dec_h, ctx, w) time-major fp32, and the
    forward's keep masks."""
    backward_chain_plain.calls += 1
    W = sw.wq.dtype
    r = lambda x: x.to(W).float()
    T, B, _ = res.ga.shape
    A, D, P, E, datt, ks = _dims(sw, mem)
    Ti = mem.shape[1]
    pad = (ks - 1) // 2
    wta = from_col_tiles(sw.wta, P + E + A).float()
    wtd = from_col_tiles(sw.wtd, A + E + D).float()
    wq, wqt = sw.wq.float(), from_col_tiles(sw.wqt, A).float()
    k2 = sw.k2.float().permute(2, 1, 0)        # (datt, 2, ks)
    memf, procf = mem.float(), proc.float()
    s_att, s_dec = _scale(p_att), _scale(p_dec)
    wcp = torch.cumsum(res.w, dim=0) - res.w   # w_cum before each step
    z = lambda *s: torch.zeros(*s, device=mem.device)
    dah, dac, ddh, ddc = z(B, A), z(B, A), z(B, D), z(B, D)
    dw, dwc, dctx = z(B, Ti), z(B, Ti), z(B, E)
    dproc, dk2, dv = z(B, Ti, datt), z(ks, 2, datt), z(datt)
    outs = [None] * T
    for t in reversed(range(T)):
        prev = lambda s: s[t - 1] if t else torch.zeros_like(s[0])
        dh2 = ddh + d_dec_h[t]
        if keep is not None:
            dh2 = dh2 * (keep[1][t].float() * s_dec)
        dgd, ddc = cell_backward(res.gd[t], prev(res.dec_c), res.dec_c[t],
                                 dh2, ddc)
        dgd = dgd.to(W)
        dxd = dgd.float() @ wtd
        dctx_t = dctx + d_ctx[t] + dxd[:, A:A + E]
        dw_t = (dw + dwc + d_align[t]
                + torch.einsum("be,bte->bt", dctx_t, memf))
        w_t = res.w[t]
        de = w_t * (dw_t - (w_t * dw_t).sum(1, keepdim=True))
        q = r(r(res.att_h[t]) @ wq)
        win = r(torch.stack([prev(res.w), wcp[t] if t else z(B, Ti)], dim=1))
        loc = F.conv1d(win, k2, padding=pad)
        feat = torch.tanh(q[:, None, :] + loc.transpose(1, 2) + procf)
        de_r = r(de)[:, :, None]
        dm = de_r * sw.vf * (1.0 - feat * feat)
        dv = dv + (feat * de_r).sum(dim=(0, 1))
        dproc = dproc + dm
        dmc = r(dm)
        dq = dmc.sum(1)
        g_out = dmc.transpose(1, 2)
        dk2 = dk2 + torch.nn.grad.conv1d_weight(
            win, k2.shape, g_out, padding=pad).permute(2, 1, 0)
        dwin = torch.nn.grad.conv1d_input(win.shape, k2, g_out, padding=pad)
        dh1 = dah + dxd[:, :A] + r(dq) @ wqt
        if keep is not None:
            dh1 = dh1 * (keep[0][t].float() * s_att)
        dga, dac = cell_backward(res.ga[t], prev(res.att_c), res.att_c[t],
                                 dh1, dac)
        dga = dga.to(W)
        dxa = dga.float() @ wta
        dctx, dah, ddh = dxa[:, P:P + E], dxa[:, P + E:], dxd[:, A + E:]
        dw, dwc = dwin[:, 0], dwc + dwin[:, 1]
        outs[t] = (dga, dgd, dxa[:, :P], dctx_t.to(W), dq)
    stacks = (torch.stack(x) for x in zip(*outs))
    return ChainGrads(*stacks, dproc, dk2, dv)


backward_chain_plain.calls = 0


# ----------------------------------------------------------------- kernel

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "train_scan_fwd": [_I] + [_P] * 14 + [_F, _F] + [_P] * 14 + [_I] * 9
    + [_P],
    "train_scan_fwd_scratch": [_I] * 9 + [ctypes.POINTER(ctypes.c_size_t)],
    "train_scan_bwd": [_I] + [_P] * 21 + [_F, _F] + [_P] * 9 + [_I] * 9
    + [_P],
    "train_scan_bwd_scratch": [_I] * 10 + [ctypes.POINTER(ctypes.c_size_t)],
}


def _check(name: str, t: Optional[torch.Tensor], shape, dtype,
           device: torch.device) -> None:
    if t is None:
        return
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_cuda or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: scan kernel inputs must be contiguous "
                         f"tensors on one CUDA device")


def _check_weights(sw: ScanWeights, mem: torch.Tensor) -> None:
    W = sw.wq.dtype
    if W not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scan kernels take fp32 or bf16, got {W}")
    A, D, P, E, datt, ks = _dims(sw, mem)
    if A % _UNITS or D % _UNITS or ks % 2 == 0:
        raise ValueError(f"scan kernels need LSTM widths that are multiples "
                         f"of {_UNITS} and an odd location kernel size")
    if datt > _AB_THREADS or _AB_THREADS % datt:
        raise ValueError(f"scan backward kernel needs an attention width "
                         f"dividing {_AB_THREADS}, got {datt}")
    f32, c = torch.float32, 4 * _UNITS
    K1, K2 = P + E + A, A + E + D
    tiles = lambda n, k: (-(-n // 32), k, 32)
    for name, t, shape, dt in (
            ("w1", sw.w1, (A // _UNITS, K1, c), W),
            ("b1", sw.b1, (4 * A,), f32),
            ("w2", sw.w2, (D // _UNITS, K2, c), W),
            ("b2", sw.b2, (4 * D,), f32),
            ("wq", sw.wq, (A, datt), W), ("k2", sw.k2, (ks, 2, datt), W),
            ("v", sw.v, (datt,), W), ("vf", sw.vf, (datt,), f32),
            ("wta", sw.wta, tiles(K1, 4 * A), W),
            ("wtd", sw.wtd, tiles(K2, 4 * D), W),
            ("wqt", sw.wqt, tiles(A, datt), W),
            ("wqc", sw.wqc, tiles(datt, A), W)):
        _check(name, t, shape, dt, mem.device)


def _keep_ptrs(keep: Optional[Keep], T, B, A, D, device):
    if keep is None:
        return None, None
    _check("keep_att", keep[0], (T, B, A), torch.bool, device)
    _check("keep_dec", keep[1], (T, B, D), torch.bool, device)
    return keep[0].data_ptr(), keep[1].data_ptr()


def forward_residuals(sw: ScanWeights, prenet: torch.Tensor,
                      mem: torch.Tensor, proc: torch.Tensor,
                      emask: torch.Tensor, *, keep: Optional[Keep] = None,
                      p_att: float = 0.0, p_dec: float = 0.0) -> Residuals:
    """The forward scan; same contract as ``forward_residuals_plain``. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if not mem.is_cuda:
        return forward_residuals_plain(sw, prenet, mem, proc, emask,
                                       keep=keep, p_att=p_att, p_dec=p_dec)
    _check_weights(sw, mem)
    W, dev = sw.wq.dtype, mem.device
    T, B, _ = prenet.shape
    A, D, P, E, datt, ks = _dims(sw, mem)
    Ti = mem.shape[1]
    f32 = torch.float32
    for name, t, shape, dt in (("prenet", prenet, (T, B, P), W),
                               ("mem", mem, (B, Ti, E), W),
                               ("proc", proc, (B, Ti, datt), W),
                               ("emask", emask, (B, Ti), f32)):
        _check(name, t, shape, dt, dev)
    ka, kd = _keep_ptrs(keep, T, B, A, D, dev)
    e = lambda *s, dt=W: torch.empty(*s, dtype=dt, device=dev)
    res = Residuals(e(T, B, 4 * A), e(T, B, 4 * D), e(T, B, A), e(T, B, D),
                    e(T, B, A, dt=f32), e(T, B, D, dt=f32),
                    e(T, B, E, dt=f32), e(T, B, Ti, dt=f32))
    q, en = e(B, datt, dt=f32), e(B, Ti, dt=f32)
    w = torch.zeros(B, Ti, device=dev)
    wc = torch.zeros_like(w)
    fin = torch.zeros(B, dtype=torch.int32, device=dev)
    bf16 = int(W == torch.bfloat16)
    lib = _build.load("train_scan", _SIGNATURES)
    nbytes = ctypes.c_size_t(0)
    with torch.cuda.device(dev):
        _build.check(lib, lib.train_scan_fwd_scratch(
            bf16, B, Ti, P, E, A, D, datt, ks, ctypes.byref(nbytes)),
            "train_scan_fwd_scratch")
    scratch = torch.empty(max(nbytes.value, 1), dtype=torch.uint8,
                          device=dev)
    status = lib.train_scan_fwd(
        bf16,
        *(x.data_ptr() for x in (sw.w1, sw.b1, sw.w2, sw.b2, sw.wq, sw.wqc,
                                 sw.k2, sw.v, prenet, mem, proc, emask)),
        ka, kd, _scale(p_att), _scale(p_dec),
        *(x.data_ptr() for x in (*res, q, en, w, wc, fin, scratch)),
        B, T, Ti, P, E, A, D, datt, ks,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "train_scan_fwd")
    forward_residuals.launches += 1
    return res


forward_residuals.launches = 0


def backward_chain(sw: ScanWeights, res: Residuals, mem: torch.Tensor,
                   proc: torch.Tensor, d_dec_h: torch.Tensor,
                   d_ctx: torch.Tensor, d_align: torch.Tensor, *,
                   keep: Optional[Keep] = None, p_att: float = 0.0,
                   p_dec: float = 0.0) -> ChainGrads:
    """The backward chain; same contract as ``backward_chain_plain``. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if not mem.is_cuda:
        return backward_chain_plain(sw, res, mem, proc, d_dec_h, d_ctx,
                                    d_align, keep=keep, p_att=p_att,
                                    p_dec=p_dec)
    _check_weights(sw, mem)
    W, dev = sw.wq.dtype, mem.device
    T, B, _ = res.ga.shape
    A, D, P, E, datt, ks = _dims(sw, mem)
    Ti = mem.shape[1]
    f32 = torch.float32
    shapes = Residuals((T, B, 4 * A), (T, B, 4 * D), (T, B, A), (T, B, D),
                       (T, B, A), (T, B, D), (T, B, E), (T, B, Ti))
    for name, t, shape in zip(Residuals._fields, res, shapes):
        _check(name, t, shape, W if name in ("ga", "gd", "att_h", "dec_h")
               else f32, dev)
    for name, t, shape, dt in (("mem", mem, (B, Ti, E), W),
                               ("proc", proc, (B, Ti, datt), W),
                               ("d_dec_h", d_dec_h, (T, B, D), f32),
                               ("d_ctx", d_ctx, (T, B, E), f32),
                               ("d_align", d_align, (T, B, Ti), f32)):
        _check(name, t, shape, dt, dev)
    ka, kd = _keep_ptrs(keep, T, B, A, D, dev)
    e = lambda *s, dt=f32: torch.empty(*s, dtype=dt, device=dev)
    z = lambda *s: torch.zeros(*s, device=dev)
    wcp = (torch.cumsum(res.w, dim=0) - res.w).contiguous()
    out = ChainGrads(e(T, B, 4 * A, dt=W), e(T, B, 4 * D, dt=W), e(T, B, P),
                     e(T, B, E, dt=W), e(T, B, datt), z(B, Ti, datt),
                     z(ks, 2, datt), z(datt))
    dims = (B, T, Ti, P, E, A, D, datt, ks)
    bf16 = int(W == torch.bfloat16)
    lib = _build.load("train_scan", _SIGNATURES)
    nbytes = ctypes.c_size_t(0)
    with torch.cuda.device(dev):
        _build.check(lib, lib.train_scan_bwd_scratch(bf16, *dims,
                                                     ctypes.byref(nbytes)),
                     "train_scan_bwd_scratch")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    status = lib.train_scan_bwd(
        bf16,
        *(x.data_ptr() for x in (sw.wta, sw.wtd, sw.wq, sw.wqc, sw.wqt,
                                 sw.k2, sw.vf, mem, proc, res.ga, res.gd,
                                 res.att_h, res.att_c, res.dec_c, res.w, wcp,
                                 d_dec_h, d_ctx, d_align)),
        ka, kd, _scale(p_att), _scale(p_dec),
        *(x.data_ptr() for x in (out.dga, out.dgd, out.d_prenet, out.d_ctx,
                                 out.d_q, out.d_processed, out.d_k2, out.d_v,
                                 scratch)),
        *dims, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, status, "train_scan_bwd")
    backward_chain.launches += 1
    return out


backward_chain.launches = 0
