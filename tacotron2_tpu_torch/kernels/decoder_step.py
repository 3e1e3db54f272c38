"""Single-utterance decoder chunk: hand-written CUDA kernel and its plain
version.

Replaces the TPU kernel ``tacotron2_tpu/kernels/decoder_step.py``
``_make_kernel`` (via ``_fused_chunk_call``, ``decode_chunk_fused`` and
``decode_autoregressive_fused``): ``chunk_steps`` autoregressive decoder
steps at B=1, with the gate latch, the length, r-frame groups and optional
prenet keep masks. It is what one utterance decodes through, offline
(``models.tacotron2.infer_fused``) and streamed
(``streaming.StreamingSynthesizer.stream``).

The math is the TPU kernel's, not its layout: none of its sublane, lane and
gate-block padding is carried over, and the location term is the conv with
``K2`` (the location conv folded through the location dense), as in
``kernels/decoder_batch.py``. The cast points are this TPU kernel's, which
differ from the batched one's: the query, ``K2``, w, w_cum, the location
term and the processed memory stay in fp32, only tanh's output is rounded
to the compute dtype before the v-product, and memory is fp32 in the
context sum. After the gate latches the state keeps stepping (h, c,
attention and the previous frame all advance); only mel, gate, align and
the length are masked.

``decoder_step_chunk`` takes the kernel (``csrc/decoder_step.cu``) for CUDA
tensors and the plain version for CPU tensors; nothing else picks between
them. A bf16 chunk runs as one persistent cooperative launch, the batched
chunk's persistent kernel at B=1 with this TPU kernel's cast points
(``csrc/persistent_chunk.cuh``), from the LSTM weights packed once in
fragment order; fp32 and other shapes take per-step launches. The CUDA
source's header note gives the kernel's design and what bounds it on the
H100.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels.decoder_batch import (
    GATE_MASK, BatchDecoderParams, ChunkCarry, ChunkOut)
from tacotron2_tpu_torch.kernels.lstm_layout import from_blocks

# The packed weights are the batched chunk's (``BatchDecoderParams``:
# row-major (in, out), LSTM weights block-major, compute dtype, at bf16 the
# LSTMs again in fragment order) except that ``k2`` stays fp32.
FusedDecoderParams = BatchDecoderParams

_KERNELS = ("prenet_kernel", "lstm_row_kernel", "query_kernel",
            "energy_kernel", "softmax_ctx_kernel", "proj_kernel")


def pack_decoder_params(model, dtype: torch.dtype) -> FusedDecoderParams:
    """Pack a ``models.tacotron2.Tacotron2``'s decoder for the chunk."""
    base = db.pack_batch_decoder_params(model, dtype)
    att = model.decoder.attention_layer
    with torch.no_grad():
        conv = att.location_layer.location_conv.conv.weight     # (F, 2, ks)
        dense = att.location_layer.location_dense.linear_layer.weight
        k2 = torch.einsum("fck,Df->kcD", conv.float(), dense.float())
    return base._replace(k2=k2.contiguous())


def attention_inputs(memory: torch.Tensor, processed: torch.Tensor,
                     mask: Optional[torch.Tensor]):
    """(mem, proc) in fp32, as the TPU kernel takes them, and the additive
    fp32 mask."""
    return db.attention_inputs(memory, processed, mask, torch.float32)


def _limits(device: torch.device, T: int, n: int, p: int, e: int, a: int,
            d: int, datt: int, ks: int) -> Optional[str]:
    lib = _build.load("decoder_step", _SIGNATURES)
    need, have = ctypes.c_size_t(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.decoder_step_limits(T, n, p, e, a, d, datt, ks,
                                       ctypes.byref(need), ctypes.byref(have))
    if code == 0:
        return None
    if code == 1:
        return "LSTM widths must be multiples of 8"
    if code == 2:
        return "location kernel size must be odd"
    if code < 0:
        raise RuntimeError("decoder kernel: the device's shared-memory limit "
                           "could not be read")
    return (f"{_KERNELS[code - 3]} needs {need.value} bytes of shared memory "
            f"at encoder length {T}; a block may use {have.value}")


# ------------------------------------------------------------------ plain

def decoder_step_chunk_plain(fp: FusedDecoderParams, carry: ChunkCarry,
                             mem: torch.Tensor, proc: torch.Tensor,
                             emask: torch.Tensor, *, t0: int,
                             chunk_steps: int, gate_logit: float,
                             kp1: Optional[torch.Tensor] = None,
                             kp2: Optional[torch.Tensor] = None) -> ChunkOut:
    """The plain PyTorch version of the chunk, with the kernel's inputs,
    outputs and cast points. mem (1, T, e) / proc (1, T, datt) fp32, emask
    (1, T) additive fp32, kp1/kp2 (cs, 1, p) 0/1."""
    decoder_step_chunk_plain.calls += 1
    W = fp.w1.dtype
    r = lambda x: x.to(W).float()
    f32 = lambda x: x.float()
    n = fp.pre1.shape[0]
    ks = fp.k2.shape[0]
    k2 = fp.k2.permute(2, 1, 0)               # (datt, 2, ks) conv weight
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
        h1, c1 = db._cell(g1, c1)
        q = r(h1) @ f32(fp.wq)                 # fp32, not rounded
        win = torch.stack([w, wc], dim=1)      # (1, 2, T) fp32
        loc = torch.nn.functional.conv1d(win, k2, padding=(ks - 1) // 2)
        feat = torch.tanh(q[:, None, :] + loc.transpose(1, 2) + proc)
        energies = r(feat) @ f32(fp.v)         # (1, T)
        w = torch.softmax(energies + emask, dim=1)
        wc = wc + w
        ctx = torch.einsum("bt,bte->be", w, mem)
        g2 = torch.cat([r(h1), r(ctx), r(h2)], 1) @ w2 + fp.b2
        h2, c2 = db._cell(g2, c2)
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


decoder_step_chunk_plain.calls = 0


# ----------------------------------------------------------------- kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decoder_step_chunk": [_I] + [_P] * 35 + [_I] * 10
               + [ctypes.c_float, _P, _P],
               "decoder_step_scratch": [_I] * 4 + [
                   ctypes.POINTER(ctypes.c_size_t)],
               "decoder_step_limits": [_I] * 8 + [
                   ctypes.POINTER(ctypes.c_size_t),
                   ctypes.POINTER(ctypes.c_int)]}


def decoder_step_chunk(fp: FusedDecoderParams, carry: ChunkCarry,
                       mem: torch.Tensor, proc: torch.Tensor,
                       emask: torch.Tensor, *, t0: int, chunk_steps: int,
                       gate_logit: float, kp1: Optional[torch.Tensor] = None,
                       kp2: Optional[torch.Tensor] = None) -> ChunkOut:
    """``chunk_steps`` decoder steps of one row; same contract as
    ``decoder_step_chunk_plain``. CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version. The input carry is not
    modified."""
    if mem.shape[0] != 1:
        raise ValueError(f"the single-utterance chunk takes one row, got "
                         f"{mem.shape[0]}")
    if (kp1 is None) != (kp2 is None):
        raise ValueError("pass both prenet keep masks or neither")
    if not mem.is_cuda:
        return decoder_step_chunk_plain(fp, carry, mem, proc, emask, t0=t0,
                                        chunk_steps=chunk_steps,
                                        gate_logit=gate_logit, kp1=kp1,
                                        kp2=kp2)
    db._check_kernel_inputs(fp, carry, mem, proc, emask, kp1, kp2,
                            chunk_steps, limits=_limits,
                            att_dtype=torch.float32)
    _, T, e = mem.shape
    n, p = fp.pre1.shape
    a, d = carry.h1.shape[1], carry.h2.shape[1]
    ks, _, datt = fp.k2.shape
    dev = mem.device
    cs = chunk_steps
    h1 = torch.empty(2, 1, a, device=dev)
    h1[0].copy_(carry.h1)
    h2 = torch.empty(2, 1, d, device=dev)
    h2[0].copy_(carry.h2)
    fin = torch.empty(2, 1, dtype=torch.int32, device=dev)
    fin[0].copy_(carry.fin)
    c1, c2, w, wc, ctx, prev, lens = (
        x.clone() for x in (carry.c1, carry.c2, carry.w, carry.wc,
                            carry.ctx, carry.prev, carry.lens))
    a2 = torch.empty(1, p, device=dev)
    q = torch.empty(1, datt, device=dev)
    energies = torch.empty(1, T, device=dev)
    mel = torch.empty(cs, 1, n, device=dev)
    gate = torch.empty(cs, 1, device=dev)
    align = torch.empty(cs, 1, T, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = _build.load("decoder_step", _SIGNATURES)
    nbytes = ctypes.c_size_t(0)
    lib.decoder_step_scratch(p, e, a, d, ctypes.byref(nbytes))
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    rounds = (ctypes.c_int * db.N_ITEM_PHASES)()
    with torch.cuda.device(dev):
        status = lib.decoder_step_chunk(
            int(fp.w1.dtype == torch.bfloat16),
            *(x.data_ptr() for x in (fp.pre1, fp.pre2, fp.w1, fp.b1, fp.w2,
                                     fp.b2, fp.wq, fp.k2, fp.v, fp.wpe,
                                     fp.bpe)),
            ptr(fp.w1f), ptr(fp.w2f),
            *(x.data_ptr() for x in (mem, proc, emask)),
            ptr(kp1), ptr(kp2),
            *(x.data_ptr() for x in (h1, c1, h2, c2, w, wc, ctx, prev, fin,
                                     lens, a2, q, energies, mel, gate,
                                     align, scratch)),
            T, n, p, e, a, d, datt, ks, cs, int(t0), float(gate_logit),
            torch.cuda.current_stream(dev).cuda_stream, rounds)
    _build.check(lib, status, "decoder_step_chunk")
    decoder_step_chunk.launches += 1
    db.count_rounds(decoder_step_chunk, rounds)
    new = ChunkCarry(h1[cs % 2], c1, h2[cs % 2], c2, w, wc, ctx, prev,
                     fin[cs % 2], lens)
    return ChunkOut(mel, gate, align, new)


decoder_step_chunk.launches = 0
decoder_step_chunk.phase_rounds = (0,) * db.N_ITEM_PHASES
decoder_step_chunk.rounds = 0


# ------------------------------------------------- carry-level entry points

def decode_chunk_fused(fp: FusedDecoderParams, carry, memory: torch.Tensor,
                       processed_memory: torch.Tensor,
                       mask: Optional[torch.Tensor], cfg: Tacotron2Config, *,
                       chunk_steps: int,
                       keep_masks: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None):
    """B=1 drop-in for ``models.tacotron2.decode_chunk``: same
    ``StreamCarry`` in and out, and per-frame outputs mel (1, cs*r, n_mels),
    gate (1, cs*r), align (1, cs*r, T_in). ``keep_masks`` are the two
    (cs, 1, p) 0/1 prenet keep masks of the chunk (none: deterministic)."""
    inputs = attention_inputs(memory, processed_memory, mask)
    return db._decode_chunk(fp, carry, inputs, cfg, chunk_steps, keep_masks,
                            decoder_step_chunk)


def decode_autoregressive_fused(fp: FusedDecoderParams, memory: torch.Tensor,
                                processed_memory: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                cfg: Tacotron2Config, *,
                                max_steps: Optional[int] = None,
                                chunk_steps: int = 64,
                                generator: Optional[torch.Generator] = None):
    """Full-utterance decode of one row: a host loop over chunks that stops
    once the gate has latched. The latch is read one chunk behind the
    launches (``decoder_batch._autoregressive``); a chunk launched past the
    stop is dropped. Same return contract as
    ``models.tacotron2.decode_autoregressive``: mel (1, t_max*r, n_mels),
    gate (1, t_max*r), align (1, t_max*r, T_in), lengths (1,) in frames. The
    last chunk runs only the steps left before ``max_steps``, which gives
    what the JAX package's whole last chunk gives once it is cut to
    ``max_steps`` and its length clamped. ``generator`` (on the memory's
    device) draws the prenet keep masks of the reference's inference-time
    dropout."""
    inputs = attention_inputs(memory, processed_memory, mask)
    return db._autoregressive(fp, inputs, memory, cfg, max_steps,
                              chunk_steps, generator, decoder_step_chunk)
