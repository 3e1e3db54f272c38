"""Batched decoder chunk: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``tacotron2_tpu/kernels/decoder_batch.py``
``_make_kernel`` (via ``_batch_chunk_call``, ``decode_chunk_batch`` and
``decode_autoregressive_batch``): ``chunk_steps`` autoregressive decoder
steps for every row of a serving batch, with the per-row gate latch,
lengths, r-frame groups and optional prenet keep masks.

The math is the TPU kernel's, not its layout. The TPU kernel evaluates the
location conv as a windowed banded-Toeplitz matrix for its matrix unit; here
the location term is the conv itself,
``loc[t, :] = sum_k sum_c K2[k, c, :] * [w ; w_cum][c, t + k - pad]``, with
``K2`` the location conv folded through the location dense at pack time.
The cast points are the TPU kernel's: operands rounded to the compute dtype
before each product, fp32 sums, fp32 h, c, w, w_cum and ctx; memory and
processed memory in the compute dtype; the attention mask is an additive
``NEG = -1e30`` (so an all-masked row stays finite where ``-inf`` would give
NaN).

``decoder_chunk`` takes the kernel (``csrc/decoder_batch.cu``) for CUDA
tensors and the plain version for CPU tensors; nothing else picks between
them. A bf16 chunk of up to 32 rows runs as one persistent cooperative
launch whose LSTM products are tensor-core products (weights packed once
in ``pack_batch_decoder_params``); fp32 and other shapes take per-step
launches. The CUDA source's header note gives the kernel's design and what
bounds it on the H100.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels.lstm_layout import (MMA_UNITS, from_blocks,
                                                     pad_cols,
                                                     pad_core_weights,
                                                     padded_width, to_blocks,
                                                     to_mma_tiles)
from tacotron2_tpu_torch.utils.profiling import span

NEG = -1e30       # additive attention mask (the TPU kernels' -inf stand-in)
GATE_MASK = 1e3   # gate value of finished rows (reference model.py:495)
_DEC_UNITS = 8    # hidden units per LSTM block in csrc/decoder_batch.cu
# PC_NPH of csrc/persistent_chunk.cuh: the persistent chunk's phases of
# items (prenet, query, energies, softmax and context, projection)
N_ITEM_PHASES = 5
# csrc/decoder_batch.cu's kernels, in the order of its chunk_smem
_KERNELS = ("prenet_kernel", "lstm_kernel", "query_kernel", "energy_kernel",
            "softmax_ctx_kernel", "proj_kernel")


def gate_logit_threshold(cfg: Tacotron2Config) -> float:
    """``sigmoid(gate) > threshold`` as a comparison on the logit, with the
    TPU kernels' edge semantics: thr <= 0 always latches, thr >= 1 never."""
    thr = cfg.gate_threshold
    if thr <= 0.0:
        return -1e30
    if thr >= 1.0:
        return 1e30
    return math.log(thr) - math.log1p(-thr)


class BatchDecoderParams(NamedTuple):
    """Packed decoder weights (``pack_batch_decoder_params``), row-major
    (in, out) and in the compute dtype unless noted."""
    pre1: torch.Tensor  # (n, p)
    pre2: torch.Tensor  # (p, p)
    w1: torch.Tensor    # (a/8, p + e + a, 32) attention LSTM [wi ; wh],
    #                     block-major (kernels/lstm_layout.py)
    b1: torch.Tensor    # (4a,) fp32
    w2: torch.Tensor    # (d/8, a + e + d, 32) decoder LSTM, block-major
    b2: torch.Tensor    # (4d,) fp32
    wq: torch.Tensor    # (a, datt)
    k2: torch.Tensor    # (ks, 2, datt) location conv folded through dense
    v: torch.Tensor     # (datt,)
    wpe: torch.Tensor   # (d + e, n + 1): mel columns 0:n, gate column n
    bpe: torch.Tensor   # (n + 1,) fp32
    # the two LSTMs' [wi ; wh] again, in mma fragment order
    # (lstm_layout.to_mma_tiles), for the persistent bf16 kernel; None at
    # fp32 or where the widths are no whole unit groups and k16 steps
    w1f: Optional[torch.Tensor] = None  # (a/4, (p+e+a)/16, 32, 8)
    w2f: Optional[torch.Tensor] = None  # (d/4, (a+e+d)/16, 32, 8)


class ChunkCarry(NamedTuple):
    """The decoder state a chunk reads and returns (fp32 unless noted)."""
    h1: torch.Tensor    # (B, a)
    c1: torch.Tensor    # (B, a)
    h2: torch.Tensor    # (B, d)
    c2: torch.Tensor    # (B, d)
    w: torch.Tensor     # (B, T) attention weights
    wc: torch.Tensor    # (B, T) cumulative attention weights
    ctx: torch.Tensor   # (B, e)
    prev: torch.Tensor  # (B, n) last raw frame group
    fin: torch.Tensor   # (B,) int32 gate latch
    lens: torch.Tensor  # (B,) int32 decoder steps per row


class ChunkOut(NamedTuple):
    mel: torch.Tensor    # (cs, B, n) fp32, 0 for finished rows
    gate: torch.Tensor   # (cs, B) fp32, GATE_MASK for finished rows
    align: torch.Tensor  # (cs, B, T) fp32, 0 for finished rows
    carry: ChunkCarry


def pack_batch_decoder_params(model, dtype: torch.dtype) -> BatchDecoderParams:
    """Pack a ``models.tacotron2.Tacotron2``'s decoder for the chunk. LSTM
    widths that are not whole blocks of ``_DEC_UNITS`` are padded with zero
    units (``lstm_layout.pad_core_weights``; ``_decode_chunk`` pads the
    carry to match and slices it back)."""
    dec = model.decoder
    att = dec.attention_layer
    if not hasattr(dec.attention_rnn, "weight_ih"):
        raise ValueError("the decoder kernels need unquantized LSTM weights "
                         "(a quantized model decodes through infer)")
    with torch.no_grad():
        ar, dr = dec.attention_rnn, dec.decoder_rnn
        a, d = ar.weight_hh.shape[1], dr.weight_hh.shape[1]
        conv = att.location_layer.location_conv.conv.weight     # (F, 2, ks)
        dense = att.location_layer.location_dense.linear_layer.weight  # (D, F)
        (wia, wha, bia, bha, wq, _, _, _, wid, whd, bid, bhd) = \
            pad_core_weights((ar.weight_ih, ar.weight_hh, ar.bias_ih,
                              ar.bias_hh, att.query_layer.linear_layer.weight,
                              None, None, None, dr.weight_ih, dr.weight_hh,
                              dr.bias_ih, dr.bias_hh), a, d, _DEC_UNITS)

        def lstm(w_ih, w_hh, b_ih, b_hh):
            w = torch.cat([w_ih, w_hh], dim=1).t()
            wf = None
            if (dtype == torch.bfloat16 and w.shape[0] % 16 == 0
                    and w.shape[1] % (4 * MMA_UNITS) == 0):
                wf = to_mma_tiles(w.to(dtype))
            return (to_blocks(w.to(dtype), _DEC_UNITS),
                    (b_ih + b_hh).float().contiguous(), wf)
        w1, b1, w1f = lstm(wia, wha, bia, bha)
        w2, b2, w2f = lstm(wid, whd, bid, bhd)
        k2 = torch.einsum("fck,Df->kcD", conv.float(), dense.float())
        proj = dec.linear_projection.linear_layer
        gate = dec.gate_layer.linear_layer
        # the projection and gate read [dec_h ; ctx]: zero rows for the
        # decoder LSTM's added units
        wpe = pad_cols(torch.cat([proj.weight, gate.weight], dim=0), d,
                       padded_width(d, _DEC_UNITS) - d).t()
        bpe = torch.cat([proj.bias, gate.bias]).float()
        as_w = lambda x: x.to(dtype).contiguous()
        return BatchDecoderParams(
            pre1=as_w(dec.prenet.layers[0].linear_layer.weight.t()),
            pre2=as_w(dec.prenet.layers[1].linear_layer.weight.t()),
            w1=w1, b1=b1, w2=w2, b2=b2, wq=as_w(wq.t()),
            k2=as_w(k2), v=as_w(att.v.linear_layer.weight[0]),
            wpe=as_w(wpe), bpe=bpe.contiguous(), w1f=w1f, w2f=w2f)


def attention_inputs(memory: torch.Tensor, processed: torch.Tensor,
                     mask: Optional[torch.Tensor], dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mem, proc) in the compute dtype and the additive fp32 mask."""
    if mask is None:
        mask = torch.ones(memory.shape[:2], dtype=torch.bool,
                          device=memory.device)
    emask = torch.where(mask, 0.0, NEG).float().contiguous()
    return (memory.to(dtype).contiguous(), processed.to(dtype).contiguous(),
            emask)


def kernel_limits(cfg: Tacotron2Config, t_in: int,
                  device: Union[str, torch.device]) -> Optional[str]:
    """Why the CUDA chunk cannot run this config at encoder length
    ``t_in`` on ``device``, or None when it can. The kernel's source
    answers (``decoder_chunk_limits``), so this builds it if needed."""
    return _limits(torch.device(device), t_in,
                   cfg.n_mel_channels * cfg.n_frames_per_step,
                   cfg.prenet_dim, cfg.encoder_embedding_dim,
                   padded_width(cfg.attention_rnn_dim, _DEC_UNITS),
                   padded_width(cfg.decoder_rnn_dim, _DEC_UNITS),
                   cfg.attention_dim, cfg.attention_location_kernel_size)


def _limits(device: torch.device, T: int, n: int, p: int, e: int, a: int,
            d: int, datt: int, ks: int) -> Optional[str]:
    lib = _build.load("decoder_batch", _SIGNATURES)
    need, have = ctypes.c_size_t(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.decoder_chunk_limits(T, n, p, e, a, d, datt, ks,
                                        ctypes.byref(need), ctypes.byref(have))
    if code == 0:
        return None
    if code == 1:
        return f"LSTM widths must be multiples of {_DEC_UNITS}"
    if code == 2:
        return "location kernel size must be odd"
    if code < 0:
        raise RuntimeError("decoder kernel: the device's shared-memory limit "
                           "could not be read")
    return (f"{_KERNELS[code - 3]} needs {need.value} bytes of shared memory "
            f"at encoder length {T}; a block may use {have.value}")


# ------------------------------------------------------------------ plain

def decoder_chunk_plain(fp: BatchDecoderParams, carry: ChunkCarry,
                        mem: torch.Tensor, proc: torch.Tensor,
                        emask: torch.Tensor, *, t0: int, chunk_steps: int,
                        gate_logit: float,
                        kp1: Optional[torch.Tensor] = None,
                        kp2: Optional[torch.Tensor] = None) -> ChunkOut:
    """The plain PyTorch version of the chunk, with the kernel's inputs,
    outputs and cast points. mem (B, T, e) / proc (B, T, datt) in the
    compute dtype, emask (B, T) additive fp32, kp1/kp2 (cs, B, p) 0/1."""
    decoder_chunk_plain.calls += 1
    W = fp.w1.dtype
    r = lambda x: x.to(W).float()
    f32 = lambda x: x.float()
    n = fp.pre1.shape[0]
    ks = fp.k2.shape[0]
    k2 = f32(fp.k2).permute(2, 1, 0)          # (datt, 2, ks) conv weight
    memf, procf = f32(mem), f32(proc)
    w1, w2 = f32(from_blocks(fp.w1)), f32(from_blocks(fp.w2))
    h1, c1, h2, c2, w, wc, ctx, prev, fin, lens = carry
    fin = fin.bool()
    mels, gates, aligns = [], [], []
    for s in range(chunk_steps):
        a1 = torch.relu(r(prev) @ f32(fp.pre1))
        if kp1 is not None:
            a1 = a1 * (kp1[s] * 2.0)
        a2 = torch.relu(r(a1) @ f32(fp.pre2))
        if kp2 is not None:
            a2 = a2 * (kp2[s] * 2.0)
        g1 = torch.cat([r(a2), r(ctx), r(h1)], 1) @ w1 + fp.b1
        h1, c1 = _cell(g1, c1)
        q = r(r(h1) @ f32(fp.wq))
        win = r(torch.stack([w, wc], dim=1))   # (B, 2, T)
        loc = torch.nn.functional.conv1d(win, k2, padding=(ks - 1) // 2)
        feat = torch.tanh(q[:, None, :] + loc.transpose(1, 2) + procf)
        energies = r(feat) @ f32(fp.v)         # (B, T)
        w = torch.softmax(energies + emask, dim=1)
        wc = wc + w
        ctx = torch.einsum("bt,bte->be", w, memf)
        g2 = torch.cat([r(h1), r(ctx), r(h2)], 1) @ w2 + fp.b2
        h2, c2 = _cell(g2, c2)
        out = torch.cat([r(h2), r(ctx)], 1) @ f32(fp.wpe) + fp.bpe
        gate = out[:, n]
        mels.append(torch.where(fin[:, None], 0.0, out[:, :n]))
        gates.append(torch.where(fin, GATE_MASK, gate))
        aligns.append(torch.where(fin[:, None], 0.0, w))
        lens = torch.where(fin, lens, torch.full_like(lens, t0 + s + 1))
        fin = fin | (gate > gate_logit)
        prev = out[:, :n]
    new = ChunkCarry(h1, c1, h2, c2, w, wc, ctx, prev, fin.int(), lens)
    return ChunkOut(torch.stack(mels), torch.stack(gates), torch.stack(aligns),
                    new)


decoder_chunk_plain.calls = 0


def _cell(g: torch.Tensor, c: torch.Tensor):
    i, f, gg, o = g.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


# ----------------------------------------------------------------- kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decoder_chunk": [_I] + [_P] * 35 + [_I] * 11
               + [ctypes.c_float, _P, _P],
               "decoder_chunk_scratch": [_I] * 5 + [
                   ctypes.POINTER(ctypes.c_size_t)],
               "decoder_chunk_limits": [_I] * 8 + [
                   ctypes.POINTER(ctypes.c_size_t),
                   ctypes.POINTER(ctypes.c_int)]}


def _check_kernel_inputs(fp, carry, mem, proc, emask, kp1, kp2,
                         chunk_steps, limits=_limits, att_dtype=None) -> None:
    """Shapes, types, device and contiguity of a chunk's tensors, then the
    kernel's own limits. ``att_dtype`` is the type of K2, memory and
    processed memory (the weights' type unless given); ``limits`` the
    function that asks the kernel's source."""
    W = fp.w1.dtype
    if W not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decoder kernel takes fp32 or bf16, got {W}")
    L = att_dtype or W
    B, T, e = mem.shape
    n, p = fp.pre1.shape
    a, d = fp.w1.shape[0] * _DEC_UNITS, fp.w2.shape[0] * _DEC_UNITS
    ks, _, datt = fp.k2.shape
    f32, i32 = torch.float32, torch.int32
    c = 4 * _DEC_UNITS
    expect = {
        "pre2": (fp.pre2, (p, p), W),
        "w1": (fp.w1, (a // _DEC_UNITS, p + e + a, c), W),
        "b1": (fp.b1, (4 * a,), f32),
        "w2": (fp.w2, (d // _DEC_UNITS, a + e + d, c), W),
        "b2": (fp.b2, (4 * d,), f32), "wq": (fp.wq, (a, datt), W),
        "k2": (fp.k2, (ks, 2, datt), L), "v": (fp.v, (datt,), W),
        "wpe": (fp.wpe, (d + e, n + 1), W), "bpe": (fp.bpe, (n + 1,), f32),
        "mem": (mem, (B, T, e), L), "proc": (proc, (B, T, datt), L),
        "emask": (emask, (B, T), f32),
        "h1": (carry.h1, (B, a), f32), "c1": (carry.c1, (B, a), f32),
        "h2": (carry.h2, (B, d), f32), "c2": (carry.c2, (B, d), f32),
        "w": (carry.w, (B, T), f32), "wc": (carry.wc, (B, T), f32),
        "ctx": (carry.ctx, (B, e), f32), "prev": (carry.prev, (B, n), f32),
        "fin": (carry.fin, (B,), i32), "lens": (carry.lens, (B,), i32),
    }
    for name, t, k, h in (("w1f", fp.w1f, p + e + a, a),
                          ("w2f", fp.w2f, a + e + d, d)):
        if t is not None:
            expect[name] = (t, (h // MMA_UNITS, k // 16, 32, 8), W)
    if kp1 is not None:
        expect["kp1"] = (kp1, (chunk_steps, B, p), f32)
        expect["kp2"] = (kp2, (chunk_steps, B, p), f32)
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise ValueError(f"{name}: expected {tuple(shape)} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_cuda or t.device != mem.device or not t.is_contiguous():
            raise ValueError(f"{name}: decoder kernel inputs must be "
                             f"contiguous tensors on one CUDA device")
    reason = limits(mem.device, T, n, p, e, a, d, datt, ks)
    if reason is not None:
        raise ValueError(f"decoder kernel: {reason}")


def decoder_chunk(fp: BatchDecoderParams, carry: ChunkCarry,
                  mem: torch.Tensor, proc: torch.Tensor, emask: torch.Tensor,
                  *, t0: int, chunk_steps: int, gate_logit: float,
                  kp1: Optional[torch.Tensor] = None,
                  kp2: Optional[torch.Tensor] = None) -> ChunkOut:
    """``chunk_steps`` decoder steps; same contract as
    ``decoder_chunk_plain``. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version. The input carry is not modified."""
    if not mem.is_cuda:
        return decoder_chunk_plain(fp, carry, mem, proc, emask, t0=t0,
                                   chunk_steps=chunk_steps,
                                   gate_logit=gate_logit, kp1=kp1, kp2=kp2)
    if (kp1 is None) != (kp2 is None):
        raise ValueError("pass both prenet keep masks or neither")
    _check_kernel_inputs(fp, carry, mem, proc, emask, kp1, kp2, chunk_steps)
    B, T, e = mem.shape
    n, p = fp.pre1.shape
    a, d = carry.h1.shape[1], carry.h2.shape[1]
    ks, _, datt = fp.k2.shape
    dev = mem.device
    cs = chunk_steps
    h1 = torch.empty(2, B, a, device=dev)
    h1[0].copy_(carry.h1)
    h2 = torch.empty(2, B, d, device=dev)
    h2[0].copy_(carry.h2)
    fin = torch.empty(2, B, dtype=torch.int32, device=dev)
    fin[0].copy_(carry.fin)
    c1, c2, w, wc, ctx, prev, lens = (
        x.clone() for x in (carry.c1, carry.c2, carry.w, carry.wc,
                            carry.ctx, carry.prev, carry.lens))
    a2 = torch.empty(B, p, device=dev)
    q = torch.empty(B, datt, device=dev)
    energies = torch.empty(B, T, device=dev)
    mel = torch.empty(cs, B, n, device=dev)
    gate = torch.empty(cs, B, device=dev)
    align = torch.empty(cs, B, T, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _build.load("decoder_batch", _SIGNATURES)
    nbytes = ctypes.c_size_t(0)
    lib.decoder_chunk_scratch(B, p, e, a, d, ctypes.byref(nbytes))
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    rounds = (ctypes.c_int * N_ITEM_PHASES)()
    status = lib.decoder_chunk(
        int(fp.w1.dtype == torch.bfloat16),
        *(x.data_ptr() for x in (fp.pre1, fp.pre2, fp.w1, fp.b1, fp.w2,
                                 fp.b2, fp.wq, fp.k2, fp.v, fp.wpe, fp.bpe)),
        ptr(fp.w1f), ptr(fp.w2f),
        *(x.data_ptr() for x in (mem, proc, emask)),
        ptr(kp1), ptr(kp2),
        *(x.data_ptr() for x in (h1, c1, h2, c2, w, wc, ctx, prev, fin,
                                 lens, a2, q, energies, mel, gate, align,
                                 scratch)),
        B, T, n, p, e, a, d, datt, ks, cs, int(t0), float(gate_logit),
        torch.cuda.current_stream(dev).cuda_stream, rounds)
    _build.check(lib, status, "decoder_chunk")
    decoder_chunk.launches += 1
    count_rounds(decoder_chunk, rounds)
    new = ChunkCarry(h1[cs % 2], c1, h2[cs % 2], c2, w, wc, ctx, prev,
                     fin[cs % 2], lens)
    return ChunkOut(mel, gate, align, new)


decoder_chunk.launches = 0
decoder_chunk.phase_rounds = (0,) * N_ITEM_PHASES
decoder_chunk.rounds = 0


def count_rounds(fn, rounds) -> None:
    """Keep a chunk's rounds of items by phase (the persistent plan's:
    prenet, query, energies, softmax and context, projection) on its
    wrapper ``fn``, and the largest as ``fn.rounds``; 0 after a chunk that
    took the per-step launches."""
    fn.phase_rounds = tuple(rounds)
    fn.rounds = max(fn.phase_rounds)


# ------------------------------------------------- carry-level entry points

def decode_chunk_batch(fp: BatchDecoderParams, carry, memory: torch.Tensor,
                       processed_memory: torch.Tensor,
                       mask: Optional[torch.Tensor], cfg: Tacotron2Config, *,
                       chunk_steps: int,
                       keep_masks: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None):
    """Batched drop-in for ``models.tacotron2.decode_chunk``: same
    ``StreamCarry`` in and out, and per-frame outputs mel (B, cs*r, n_mels),
    gate (B, cs*r), align (B, cs*r, T_in). ``keep_masks`` are the two
    (cs, B, p) 0/1 prenet keep masks of the chunk (none: deterministic)."""
    inputs = attention_inputs(memory, processed_memory, mask, fp.w1.dtype)
    return _decode_chunk(fp, carry, inputs, cfg, chunk_steps, keep_masks)


def _decode_chunk(fp, carry, inputs, cfg, chunk_steps, keep_masks,
                  chunk=decoder_chunk):
    """``decode_chunk_batch`` on attention inputs already prepared by
    ``attention_inputs``, through the chunk function ``chunk``."""
    mem, proc, emask = inputs
    B = mem.shape[0]
    r = cfg.n_frames_per_step
    s = carry.state
    f32 = lambda x: x.float().contiguous()
    a, d = s.att_h.shape[1], s.dec_h.shape[1]
    # the pack's added zero units (pack_batch_decoder_params) carry zeros
    pa = lambda x: F.pad(f32(x), (0, fp.w1.shape[0] * _DEC_UNITS - a))
    pd = lambda x: F.pad(f32(x), (0, fp.w2.shape[0] * _DEC_UNITS - d))
    cc = ChunkCarry(pa(s.att_h), pa(s.att_c), pd(s.dec_h), pd(s.dec_c),
                    f32(s.att_weights), f32(s.att_weights_cum),
                    f32(s.att_context), f32(carry.prev_mel),
                    carry.finished.int().contiguous(),
                    carry.lengths.int().contiguous())
    kp1, kp2 = (None, None) if keep_masks is None else (
        f32(keep_masks[0]), f32(keep_masks[1]))
    out = chunk(fp, cc, mem, proc, emask, t0=int(carry.t),
                chunk_steps=chunk_steps, gate_logit=gate_logit_threshold(cfg),
                kp1=kp1, kp2=kp2)
    mel = (out.mel.transpose(0, 1)
           .reshape(B, chunk_steps * r, cfg.n_mel_channels))
    gate = out.gate.t().repeat_interleave(r, dim=1)
    align = out.align.transpose(0, 1).repeat_interleave(r, dim=1)
    c = out.carry
    new_carry = carry._replace(
        t=int(carry.t) + chunk_steps,
        state=s._replace(att_h=c.h1[:, :a], att_c=c.c1[:, :a],
                         dec_h=c.h2[:, :d], dec_c=c.c2[:, :d],
                         att_weights=c.w, att_weights_cum=c.wc,
                         att_context=c.ctx),
        prev_mel=c.prev, finished=c.fin.bool(), lengths=c.lens)
    return new_carry, (mel, gate, align)


def decode_autoregressive_batch(fp: BatchDecoderParams, memory: torch.Tensor,
                                processed_memory: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                cfg: Tacotron2Config, *,
                                max_steps: Optional[int] = None,
                                chunk_steps: int = 64,
                                generator: Optional[torch.Generator] = None):
    """Full-utterance batched decode: a host loop over chunks that stops
    once every row's gate has latched. The latch is read one chunk behind
    the launches, so the card never waits on the host between chunks; a
    chunk launched past the stop is dropped, and the result is the
    chunk-by-chunk loop's. The last chunk runs only the steps left before
    ``max_steps``. Same return contract as
    ``models.tacotron2.decode_autoregressive``: mel (B, t_max*r, n_mels),
    gate (B, t_max*r), align (B, t_max*r, T_in), lengths (B,) in frames.
    ``generator`` (on the memory's device) draws the prenet keep masks of
    the reference's inference-time dropout."""
    inputs = attention_inputs(memory, processed_memory, mask, fp.w1.dtype)
    return _autoregressive(fp, inputs, memory, cfg, max_steps, chunk_steps,
                           generator)


class _Latch:
    """Reads of every row's gate latch, one chunk behind the launches. On a
    card each chunk's ``finished`` flags are copied behind the chunk into
    one of two pinned host slots, and an event marks the copy: a read waits
    for that chunk alone, not for the chunk launched after it. On the CPU
    the flags are already computed and a read is ``all()``."""

    def __init__(self, finished: torch.Tensor):
        self.device = finished.device
        self.cuda = finished.is_cuda
        if self.cuda:
            self.slots = torch.empty((2, *finished.shape), dtype=torch.bool,
                                     pin_memory=True)
            self.events = (torch.cuda.Event(), torch.cuda.Event())
        self.posted = 0

    def post(self, finished: torch.Tensor):
        """Queue the read of one chunk's flags; the handle ``read`` takes."""
        if not self.cuda:
            return finished
        i = self.posted % 2
        self.posted += 1
        self.slots[i].copy_(finished, non_blocking=True)
        self.events[i].record(torch.cuda.current_stream(self.device))
        return i

    def read(self, handle) -> bool:
        """Whether every row of the posted chunk has latched."""
        if not self.cuda:
            return bool(handle.all())
        self.events[handle].synchronize()
        return bool(self.slots[handle].all())


def _autoregressive(fp, inputs, memory, cfg, max_steps, chunk_steps,
                    generator, chunk=decoder_chunk):
    """The host loop of ``decode_autoregressive_batch`` on prepared
    attention inputs, through the chunk function ``chunk``. Chunk k+1 is
    launched from chunk k's carry before chunk k's latch is read; if every
    row latched in chunk k, chunk k+1 ran past the stop and is dropped
    (``_autoregressive.discarded``), and the generator is put back to its
    state before chunk k+1's keep masks."""
    from tacotron2_tpu_torch.models.tacotron2 import init_stream_carry

    B, t_in, _ = memory.shape
    r = cfg.n_frames_per_step
    t_max = max_steps or cfg.max_decoder_steps
    carry = init_stream_carry(memory, cfg)   # no row has latched
    latch = _Latch(carry.finished)
    behind = None   # the posted latch of the chunk before the next one
    mels, gates, aligns = [], [], []
    while carry.t < t_max:
        cs = min(chunk_steps, t_max - carry.t)
        # one span a chunk: its launch, then the read of the chunk
        # before's latch, which waits for that chunk alone
        with span("decoder.chunk", cs, int(behind is not None)):
            keep = state = None
            if generator is not None:
                state = generator.get_state()
                shape = (cs, B, cfg.prenet_dim)
                keep = tuple(torch.rand(shape, generator=generator,
                                        device=memory.device) < 0.5
                             for _ in range(2))
            nxt, (mel, gate, align) = _decode_chunk(fp, carry, inputs, cfg,
                                                    cs, keep, chunk)
            posted = latch.post(nxt.finished) if nxt.t < t_max else None
            if behind is not None and latch.read(behind):
                _autoregressive.discarded += 1
                if generator is not None:
                    generator.set_state(state)
                break
        carry, behind = nxt, posted
        mels.append(mel)
        gates.append(gate)
        aligns.append(align)
    frames = t_max * r
    dev = memory.device
    mel = torch.zeros(B, frames, cfg.n_mel_channels, device=dev)
    gate = torch.full((B, frames), GATE_MASK, device=dev)
    align = torch.zeros(B, frames, t_in, device=dev)
    done = carry.t * r
    if mels:
        mel[:, :done] = torch.cat(mels, dim=1)
        gate[:, :done] = torch.cat(gates, dim=1)
        align[:, :done] = torch.cat(aligns, dim=1)
    return mel, gate, align, carry.lengths * r


_autoregressive.discarded = 0
