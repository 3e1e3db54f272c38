#!/usr/bin/env python3
"""Drive the port's serving paths, its training step, its trainer (on one
rank and on two), its vocoders and its front doors (the infer CLI, the HTTP
server) on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, without
them or outside a checkout of the repository. Phases, each of which raises
on failure:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel source of ``tacotron2_tpu_torch/kernels/csrc``;
3. encoder BiLSTM kernel against its plain version at full width (N=512,
   H=256, bf16; B=8 and B=1 at T 128, 48 and 32), timed beside cuDNN's
   bidirectional LSTM, one launch a call (torch.profiler);
4. decoder chunk kernel against its plain version at full width (one
   64-step bf16 chunk at T_in=128: B=8, again with prenet keep masks; B=1;
   B=13 with keep masks; and at the row tiles serving decodes, B=16, 24
   and 32 at T_in 64, 128 and 192, some with keep masks), every output and
   carry field within its own limit (DEC_REL), and the same comparison
   must reject the kernel's output with its attention perturbed; a chunk
   must be one launch of the persistent kernel (torch.profiler);
5. serving: ``BatchingSynthesizer(max_batch=8)`` at the default config with
   seeded random weights answers 16 requests in the 64 and 128 text
   buckets (bf16, max_steps=200); both kernels' launch counts must rise
   and the plain versions must not run. A second one at ``max_batch=32``
   must have decoded every (row tile, text bucket) shape before its first
   request, and decode batches of 5, 13, 20 and 27 requests at 8, 16, 24
   and 32 rows, with no plain version run. Then fp32: the encoder kernel
   over eight of those texts against its plain version on the CPU, and
   ``BatchingSynthesizer``, ``StreamingSynthesizer`` and ``infer_fused``
   refusing an fp32 config on the card (the decoder kernels take bf16
   alone) with no launch and no plain version run;
6. the three kernels of one utterance against their plain versions at full
   width: the single-utterance decoder chunk (B=1, bf16; T_in 64, 128,
   192; with and without keep masks; chunks of 32 and 64) field by field
   (STEP_REL) with perturbed attention rejected, timed beside the
   batched chunk's entry called at B=1, a bf16 chunk one launch of the
   persistent kernel (torch.profiler); the int8 product at the two decoder
   cells' shapes (B=1 and 8, 13 rows, and ragged shapes; x in fp32 and
   bf16, the same bits twice), the C entry point timed in a CUDA graph and
   back to back beside ``torch.matmul`` on a bf16 copy dequantised ahead of
   time, and a wrapper call; the fused mel
   kernel (its DFT as three TF32 tensor-core products) on 16 waveforms of
   6 s (and ragged lengths), timed beside the two ``torch.matmul`` form;
7. one utterance to audio: ``infer.synthesize([text], fused=True)`` with the
   full V1 HiFi-GAN generator and with Griffin-Lim (max_steps=200), the same
   text on ``quantize_for_serving`` weights through the step-by-step decoder
   (captured chunks: the int8 kernel's executions counted on the device,
   the output held equal to the same chunks run step by step),
   ``StreamingSynthesizer(chunk_steps=32).stream(text)`` held against the
   offline result, ``stream_batch`` on four texts against the offline
   batch, and the front end on 16 waveforms of 6 s; each path's
   launch counts must show its kernel and no plain version may run on the
   card; a breakdown by stage and a profile;
8. the training kernels at bench.py's shape (B=128, T_in=128, bf16): the
   decoder forward scan and backward chain against their plain versions
   over 64 steps (also at T_in 64 and 192) and 512 steps, and at the
   quality gate's B=32 x T_in 32 and 48 over 128 steps and T_in 48 over
   256, the backward's accumulators bit-identical between two runs, perturbed
   outputs rejected, the encoder BiLSTM forward
   at B=128 and its backward (one cluster launch for the chain) at B=128 x
   T 128 and 192 and B=32 x T 32 and 48, each field within its limit,
   perturbed outputs rejected, the backward bit-identical in two runs; the
   forward also timed at B=128 and B=32 at T 48 and 32;
9. training: ``train_step`` at B=128, T_in=128, T_out=512, bf16 (one warm
   step, three timed): every training kernel must launch and no plain
   version run; a breakdown by stage and a profile of one step; then the
   step's loss and encoder gradients with the kernels against the same step
   with row 3's plain version swapped in, and with row 4's
   (SWAP_REL_BF16);
10. training from a filelist: a 128-utterance tone corpus, ``Trainer.fit``
    for 3 epochs at full width (bf16, dropout on, text buckets 32 and 48)
    with checkpoints and validation; every training kernel must launch, no
    plain version run, and both text buckets be met; a Trainer resumed
    from the last checkpoint holds the same state bit for bit and two more
    steps of it equal two more of the first (a gap must stay within twice
    that of the same two steps run twice from the checkpoint);
    ``synthesize`` from the restored model through both decoders; rows 3
    and 6 on the restored weights at the gate's input ("we like jax", B=1,
    T_in 11) against their plain versions, row 6 with a latching gate;
    the fit's step time beside
    ``train_step`` on a resident batch, its wait on prefetch and a profile;
11. one fp32 training step on the card against the CPU plain versions, then
    with cuDNN's convolutions, and each convolution against fp64;
12. WaveGlow at the published widths (~88M parameters, fp32, seeded, WN.end
    perturbed): the card against the CPU at 16 frames on the same weights
    and z (WG_CPU_REL), the flow's round trip on the card at 16 and 200
    frames (WG_ROUND_TRIP_REL), ``synthesize(vocoder="waveglow")`` on the
    200-step utterance with and without the ``Denoiser`` (times, peak
    memory), the vocoder alone with cuDNN's TF32 off (this script's
    setting) and on (PyTorch's default, which the CLI and the server run
    with); perturbed outputs rejected;
13. vocoder training on a 32-utterance tone corpus at full width: 3 WaveGlow
    steps (B=8, 64-mel segments) and 3 HiFi-GAN V1 steps (B=16, 32-mel
    segments), each with finite losses and every network updated, each
    trainer writing a checkpoint;
14. the front doors: ``python -m tacotron2_tpu_torch.infer`` in processes of
    its own on a full-width checkpoint (Griffin-Lim; HiFi-GAN with --fused;
    WaveGlow with --int8; the vocoders from phase 13's checkpoints), every
    WAV checked; ``http_server.make_server`` in a thread, driven by urllib
    (/healthz, 8 concurrent /synthesize mels against its
    ``BatchingSynthesizer``, WAVs, /stream as NDJSON and, from a HiFi-GAN
    server, as PCM), rows 3, 5 and 6 counted by their wrappers and by
    torch.profiler;
15. raw-audio batches at the tone demo's shape (B=32, T_in 32, T_out 256,
    bf16): the targets through the mel kernel (row 8) against the
    ``torch.matmul`` form, then 3 ``train_step_from_audio`` steps (row 8
    once a step, rows 1-4, no plain version);
16. data parallelism on the one card (``dp_phase``; the processes run this
    file with ``--dp-probe`` or ``--dp-worker``): an NCCL all-reduce from
    two ranks on the card (NCCL refuses two ranks on one device; the
    phase then runs gloo on CUDA tensors, and says which ran); two ranks
    of ``parallel.make_train_step`` at bench.py's shape (2 x B=64, bf16, no
    dropout) against one process's ``train_step`` at B=128 (DP_REL), the
    same with each rank's batch statistics its own rejected, both ranks'
    states equal bit for bit, rows 1-4 in each rank's torch.profiler
    window and no plain version; the same two ranks on a ``(1, 2)`` mesh
    (the model-parallel axis: each holds half of every sharded leaf's Adam
    moments and all-gathers the updated halves) against one process at
    B=128, bit for bit when two runs of one process are (else within
    MP_SPREAD_X times their gap), the step without its all-gather
    rejected; then ``Trainer.fit`` on two ranks (the
    tone demo's config over ``use_native=True`` after ``native/build.sh``):
    checkpoints from rank 0 only, a resume equal bit for bit,
    ``grad_accum_steps=2`` launching rows 1-4 twice a step,
    ``profile_trace`` around a step holding rows 1-4's kernels; and
    ``python -m tacotron2_tpu_torch.train`` under a one-rank torchrun
    environment over NCCL.

Between phases 11 and 12 the benchmarks: ``python -m
tacotron2_tpu_torch.bench`` in a process of its own (root bench.py's JSON
line, its step within BENCH_STEP_REL of phase 9's, rows 1-4 once a step),
then ``bench_buckets``, ``bench_default`` and every ``bench_details`` stage
in process, briefly. After phase 15: ``tools/cache_mels`` on the card over
phase 13's tone filelist (row 8 once an utterance, each mel against row 8's
plain version and the numpy path, read back by ``TextMelDataset``), and
the inference demo on a native checkpoint and a reference-format
state_dict (a WAV, the line on its plots, row 3).

``python3 chip_smoke.py --dp-cards N`` runs phase 16 alone on a machine
with N cards: one rank a card over NCCL, N x B=128/N against one process,
and a ``(N / 2, 2)`` mesh against it within DP_REL.

The second-to-last line is the ``kernels`` JSON object (times, bounds,
launches, errors; ``launches_http_server``, ``launches_audio_batch``,
``launches_infer_cli``, ``launches_data_parallel``, ``launches_bench``,
``launches_bench_scripts``, ``launches_model_parallel``,
``launches_cache_mels`` and ``launches_inference_demo`` count the other
paths); the last is the device line.
"""

from __future__ import annotations

import functools
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tacotron2_tpu_torch import infer as tinfer
from tacotron2_tpu_torch.audio import mel as tmel
from tacotron2_tpu_torch.config import create_config
from tacotron2_tpu_torch.data.bucketing import text_bucket
from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import decoder_step as ds
from tacotron2_tpu_torch.kernels import encoder_lstm as el
from tacotron2_tpu_torch.kernels import mel_kernel as mk
from tacotron2_tpu_torch.kernels import train_scan as ts
from tacotron2_tpu_torch.kernels.int8_probe import graph_ms
from tacotron2_tpu_torch.kernels.lstm_layout import from_blocks
from tacotron2_tpu_torch.models import decoder_vjp as dv
from tacotron2_tpu_torch.models import hifigan
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.ops.lstm import _reverse_by_length, lstm_weights
from tacotron2_tpu_torch.serve import BatchingSynthesizer
from tacotron2_tpu_torch.streaming import StreamingSynthesizer
from tacotron2_tpu_torch.text import text_to_sequence
from tacotron2_tpu_torch.training import state as tstate

# the package exports a function ``int8_matmul`` that hides the module
i8 = importlib.import_module("tacotron2_tpu_torch.kernels.int8_matmul")

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is max(bytes / HBM rate, FLOPs / peak for its operand type). "tf32x3" is
# an fp32 product taken as three TF32 products (the mel kernel's DFT): the
# TF32 rate over three.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}

ENC_TOL = (3e-2, 5e-2)     # (atol, rtol): bf16 operand rounding flips
# Decoder chunk, kernel against its plain version: the largest |err| of
# each output and carry field, as a share of the field's largest |value|.
# The two share every cast point and differ only in the order of fp32 sums,
# which now and then flips the rounding of a bf16 operand. Each limit is
# about ten times the worst reading of its field on the card, over this
# script's chunks and those of tests/test_torch_kernels_gpu.py, whose
# table's bf16 row this is.
DEC_FIELDS = ("mel", "gate", "align", "h1", "c1", "h2", "c2", "w", "wc",
              "ctx", "prev")
DEC_REL = {
    torch.bfloat16: dict(mel=2e-2, gate=9e-2, align=2e-2, h1=2e-2, c1=2e-2,
                         h2=8e-3, c2=9e-3, w=2e-2, wc=3e-3, ctx=5e-3,
                         prev=2e-2),
}
SERVE_TOL_FP32 = (1e-3, 1e-3)  # fp32 encoder, card against CPU plain path

SHORT_TEXTS = [  # 64-symbol bucket
    "Hello world.",
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are concerned.",
    "It was a bright cold day in April.",
    "She sells sea shells by the sea shore.",
    "Dr. Smith paid $12.50 for two books.",
    "Time flies like an arrow.",
    "A {HH AH0 L OW1} from the phoneme side.",
]
LONG_TEXTS = [  # 128-symbol bucket
    "The Industrial Revolution began in Great Britain and spread to other "
    "parts of the world over several decades.",
    "Speech synthesis is the artificial production of human speech, and a "
    "computer system used for this purpose is a synthesizer.",
    "On the morning of the third day the travellers reached the river, "
    "where a ferry waited to carry them across.",
    "In 1969, two astronauts walked on the surface of the Moon while a "
    "third orbited above them in the command module.",
    "Each request in a batch is padded to the same text bucket, so the "
    "decoder always sees a fixed shape of input.",
    "Most of the time in autoregressive decoding goes to reading the "
    "weights of the two recurrent layers at every step.",
    "The committee met on Tuesday to review the budget, and the chairman "
    "asked for a report by the end of the month.",
    "A gentle breeze moved through the tall grass as the sun sank slowly "
    "behind the hills to the west of town.",
]


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def worst(got, want, tol):
    """(max |got - want|, whether |got - want| <= atol + rtol |want|)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok


def field_err(got, want):
    """(max |got - want|, that as a share of max |want|)."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return diff, diff / scale if scale > 0 else diff


def bound(nbytes: float, flops, dtype: str = ""):
    """(bound ms, "bytes" or "operations"); flops is a count at the rate of
    ``dtype``, or {rate: count} for work at several rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if not isinstance(flops, dict):
        flops = {dtype: flops}
    t_ops = sum(f / PEAK_FLOPS[k] for k, f in flops.items())
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


# ------------------------------------------------------------------ phases

def _encoder_inputs(lstm, dev, B, T, seed):
    """Seeded encoder outputs (B, T, N) after the relu, in bf16, and their
    per-row length-reversed copy (ragged lengths, row 0 full)."""
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.relu(torch.randn(B, T, lstm.input_size, generator=g,
                                device=dev))
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)
    lengths[0] = T
    xsr = _reverse_by_length(xs, lengths).to(bf16).contiguous()
    return xs.to(bf16).contiguous(), xsr


def _cudnn_bilstm(lstm, dev):
    """The same weights in ``torch.nn.LSTM`` (bidirectional, bf16): cuDNN,
    the yardstick ``library_ms`` times."""
    ref = torch.nn.LSTM(lstm.input_size, lstm.hidden_size, batch_first=True,
                        bidirectional=True).to(dev)
    ref.load_state_dict(lstm.state_dict())
    ref = ref.to(torch.bfloat16)
    ref.flatten_parameters()
    return ref


def _encoder_work(B, T, N, H, wsz=2):
    """Bytes one forward call must move (each input read once, each output
    written once), its FLOPs, and the bytes each step must touch whatever
    the kernel keeps (both directions' weights and the step's inputs and
    outputs, read or written once a step)."""
    K = N + H
    weights = 2 * (K * 4 * H * wsz + 4 * H * 4)
    io = 2 * B * T * N * wsz + 2 * T * B * (4 * H * wsz + H * wsz + H * 4)
    return weights + io, 2 * 2 * T * B * K * 4 * H, weights + io / T


def encoder_shapes(packed, lstm, ref, dev, card, shapes, seed):
    """Row 3 at each (B, T) of ``shapes`` against its plain version
    (ENC_TOL), timed beside cuDNN, with its bound and per-step byte floor;
    returns {"B=.. T=..": numbers}."""
    N, H = lstm.input_size, lstm.hidden_size
    out = {}
    for B, T in shapes:
        xs, xsr = _encoder_inputs(lstm, dev, B, T, seed + B + T)
        got = el.bilstm_forward(*packed, xs, xsr)
        want = el.bilstm_forward_plain(*packed, xs, xsr)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, b in zip(("gf", "gb", "hf", "hb", "cf", "cb"), got,
                              want):
            e, ok = worst(a, b, ENC_TOL)
            err = max(err, e)
            if not ok:
                fail(f"encoder kernel (B={B} T={T}) disagrees with its plain"
                     f" version on {name}: max |err| {e} beyond atol/rtol "
                     f"{ENC_TOL}")
        ms = cuda_ms(lambda: el.bilstm_forward(*packed, xs, xsr), iters=20)
        with torch.no_grad():
            library_ms = cuda_ms(lambda: ref(xs), iters=20)
        nbytes, flops, step_b = _encoder_work(B, T, N, H)
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        floor_ms = T * step_b / HBM_BYTES_PER_S * 1e3
        design, need, active = el.forward_plan(B, N, H, torch.bfloat16, dev)
        print(f"encoder [{card}] B={B} T={T} N={N} H={H} bf16 ({design}: "
              f"{need} clusters of 16, the card holds {active} at once): "
              f"max |err| {err:.3e} (atol {ENC_TOL[0]}, rtol {ENC_TOL[1]});"
              f" kernel {ms:.4f} ms ({ms / T * 1e3:.2f} us a step), cuDNN "
              f"bidirectional LSTM {library_ms:.4f} ms, bound {bound_ms:.5f}"
              f" ms ({bound_by}), per-step floor {step_b / 1e6:.2f} MB, "
              f"{floor_ms:.4f} ms at the HBM rate")
        out[f"B={B} T={T}"] = dict(max_abs_err=err, ms=ms,
                                   library_ms=library_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, floor_ms=floor_ms)
    return out


def encoder_phase(model, dev, card):
    """Row 3 at the serving shapes: B=8 and B=1 at T 32, 48 and 128, each
    against its plain version and timed beside cuDNN; the kernel line's
    numbers at B=8, T=128; one launch a call (torch.profiler)."""
    lstm = model.encoder.lstm
    packed = el.pack_bilstm(lstm_weights(lstm, "_l0"),
                            lstm_weights(lstm, "_l0_reverse"), torch.bfloat16)
    ref = _cudnn_bilstm(lstm, dev)
    shapes = encoder_shapes(packed, lstm, ref, dev, card,
                            [(B, T) for B in (8, 1) for T in (128, 48, 32)],
                            11)
    xs, xsr = _encoder_inputs(lstm, dev, 8, 128, 11 + 8 + 128)
    # a bf16 forward must be one launch of the cluster kernel
    names = [k for k in profiled_kernels(
        lambda: el.bilstm_forward(*packed, xs, xsr))
        if k in ("encoder_cluster_kernel", "encoder_step")]
    if names != ["encoder_cluster_kernel"]:
        fail(f"a bf16 encoder forward launched {len(names)} kernels "
             f"({sorted(set(names))}), not one cluster kernel")
    print(f"encoder [{card}] B=8 T=128 under torch.profiler: one launch of "
          f"encoder_cluster_kernel (the first design launched encoder_step "
          f"once a step)")
    plain_ms = cuda_ms(lambda: el.bilstm_forward_plain(*packed, xs, xsr),
                       iters=3, warmup=1)
    r = shapes["B=8 T=128"]
    print(f"encoder [{card}] B=8 T=128: plain {plain_ms:.4f} ms")
    return {"name": "encoder_lstm_fwd", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/encoder_lstm.cu",
            "replaces": "tacotron2_tpu/kernels/encoder_lstm.py:71",
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            "tolerance": {"atol": ENC_TOL[0], "rtol": ENC_TOL[1]},
            "ms": r["ms"], "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "floor_ms": r["floor_ms"],
            "library_ms": r["library_ms"], "launches_per_call": len(names),
            "shapes": shapes}


def _chunk_inputs(model, cfg, dev, dtype, B, T):
    g = torch.Generator(device=dev).manual_seed(12)
    text = torch.randint(1, cfg.n_symbols, (B, T), generator=g, device=dev)
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)
    lengths[0] = T
    cd = None if dtype == torch.float32 else dtype
    memory = tm.encode(model, text, lengths, cfg, compute_dtype=cd)
    processed = tm.processed_memory_of(model, memory, cd)
    mask = torch.arange(T, device=dev)[None] < lengths[:, None]
    mem, proc, emask = db.attention_inputs(memory, processed, mask, dtype)
    n = cfg.n_mel_channels * cfg.n_frames_per_step
    z = lambda *s: torch.zeros(*s, device=dev)
    i32 = lambda: torch.zeros(B, dtype=torch.int32, device=dev)
    a, d, e = cfg.attention_rnn_dim, cfg.decoder_rnn_dim, memory.shape[2]
    carry = db.ChunkCarry(z(B, a), z(B, a), z(B, d), z(B, d), z(B, T),
                          z(B, T), z(B, e), z(B, n), i32(), i32())
    return mem, proc, emask, carry, g


# csrc/decoder_batch.cu's kernel
CHUNK_KERNELS = ("persistent_chunk_kernel",)


def decoder_phase(model, cfg, dev, card):
    """Row 5 at full width against its plain version, bf16, one 64-step
    chunk each: at T_in 128, B=8 (and with keep masks), B=1 and B=13 with
    keep masks; at the row tiles a served batch takes beyond 8 (B 16, 24,
    32: one n8 tile more each) by every text bucket (T_in 64, 128, 192);
    the kernel line's time at B=8, beside the per-step byte floor; the
    chunk's CUDA kernels counted by torch.profiler."""
    cs = 64
    dtype = torch.bfloat16
    limits = DEC_REL[dtype]
    fp = db.pack_batch_decoder_params(model, dtype)
    results, row_tiles = {}, []
    # (B, T_in, keep masks): keep masks once at each B and at each T_in
    tiles = [(16, 64, False), (16, 128, True), (16, 192, False),
             (24, 64, False), (24, 128, False), (24, 192, True),
             (32, 64, True), (32, 128, False), (32, 192, False)]
    for B, T, keep in ([(8, 128, False), (8, 128, True), (1, 128, False),
                        (13, 128, True)] + tiles):
        label = f"bf16{'+keep' if keep else ''} B={B} T_in={T}"
        if (B, T, keep) in tiles:
            row_tiles.append(label)
        mem, proc, emask, carry, g = _chunk_inputs(model, cfg, dev,
                                                   dtype, B, T)
        kp = (None, None)
        if keep:
            kp = tuple((torch.rand(cs, B, cfg.prenet_dim, generator=g,
                                   device=dev) < 0.5).float()
                       for _ in range(2))
        kw = dict(t0=0, chunk_steps=cs, gate_logit=db.gate_logit_threshold(
            cfg), kp1=kp[0], kp2=kp[1])
        args = (fp, carry, mem, proc, emask)
        got = db.decoder_chunk(*args, **kw)
        want = db.decoder_chunk_plain(*args, **kw)
        torch.cuda.synchronize()
        fields = {name: field_err(a, b)
                  for name, a, b in _chunk_fields(got, want)}
        err = max(e for e, _ in fields.values())
        print(f"decoder [{card}] {label}: max |err| by field, as a share of "
              f"the field's largest |value| (limit): " + ", ".join(
                  f"{k} {r:.2e} ({limits[k]})" for k, (_, r) in fields.items()))
        for name, (e, r) in fields.items():
            if r > limits[name]:
                fail(f"decoder kernel ({label}) disagrees with its plain "
                     f"version on {name}: max |err| {e}, {r:.3e} of the "
                     f"field's largest value, beyond {limits[name]}")
        for name in ("fin", "lens"):
            if not torch.equal(getattr(got.carry, name),
                               getattr(want.carry, name)):
                fail(f"decoder kernel ({label}): {name} differs from the "
                     f"plain version")
        if label == "bf16 B=8 T_in=128":
            _check_catches(got, want, limits)
            names = profiled_kernels(lambda: db.decoder_chunk(*args, **kw))
            chunk = [k for k in names if k in CHUNK_KERNELS]
            setup = [k for k in names if k not in CHUNK_KERNELS]
            if chunk != ["persistent_chunk_kernel"]:
                fail(f"a bf16 chunk launched {chunk}, not one persistent "
                     f"kernel")
            per_chunk = {"kernels": len(chunk), "set_up": len(setup)}
            print(f"decoder [{card}] bf16 B={B} one {cs}-step chunk under "
                  f"torch.profiler: {len(chunk)} launch of {chunk[0]} (the "
                  f"first design launched 7 x {cs} = {7 * cs}); set-up: "
                  f"{len(setup)} ({', '.join(sorted(set(setup)))})")
        ms = cuda_ms(lambda: db.decoder_chunk(*args, **kw), iters=5)
        plain_ms = cuda_ms(lambda: db.decoder_chunk_plain(*args, **kw),
                           iters=2, warmup=1)
        nbytes, flops = _decoder_work(fp, B, T, cs, kp[0] is not None,
                                      cfg.attention_location_n_filters)
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        # what each step must touch whatever the kernel keeps: both LSTMs'
        # weights, memory and processed memory, read once a step
        step_b = (fp.w1.numel() * fp.w1.element_size()
                  + fp.w2.numel() * fp.w2.element_size()
                  + mem.numel() * mem.element_size()
                  + proc.numel() * proc.element_size())
        floor_ms = cs * step_b / HBM_BYTES_PER_S * 1e3
        print(f"decoder [{card}] {label} chunk={cs}: max |err|"
              f" {err:.3e}; finished "
              f"{int(got.carry.fin.sum())}/{B}; kernel {ms:.4f} ms "
              f"({ms / cs * 1e3:.2f} us a step), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}); per-step floor "
              f"{step_b / 1e6:.1f} MB, {floor_ms:.4f} ms at the HBM rate")
        results[label] = dict(max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, floor_ms=floor_ms)
    r = results["bf16 B=8 T_in=128"]
    return {"name": "decoder_chunk", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/decoder_batch.cu",
            "replaces": "tacotron2_tpu/kernels/decoder_batch.py:107",
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "tolerance": {"share_of_field_max": DEC_REL[torch.bfloat16]},
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "floor_ms": r["floor_ms"], "library_ms": None,
            "launches_per_chunk": per_chunk,
            "B1": {k: results["bf16 B=1 T_in=128"][k] for k in
                   ("max_abs_err", "ms", "bound_ms", "floor_ms")},
            "B13_keep": {k: results["bf16+keep B=13 T_in=128"][k] for k in
                         ("max_abs_err", "ms", "bound_ms", "floor_ms")},
            "row_tiles": {label: {k: results[label][k] for k in
                                  ("max_abs_err", "ms")}
                          for label in row_tiles}}


def _chunk_fields(got, want):
    """(name, kernel's, plain version's) for every output and carry field
    compared within a tolerance."""
    out = [(f, getattr(got, f), getattr(want, f))
           for f in ("mel", "gate", "align")]
    return out + [(f, getattr(got.carry, f), getattr(want.carry, f))
                  for f in DEC_FIELDS[3:]]


def _check_catches(got, want, limits):
    """The decoder comparison must reject attention that is off: align
    scaled by 1.05, and w shifted by one encoder position."""
    bad = {"align x 1.05": got._replace(align=got.align * 1.05),
           "w shifted one position": got._replace(carry=got.carry._replace(
               w=torch.roll(got.carry.w, 1, dims=1)))}
    for what, out in bad.items():
        if all(field_err(a, b)[1] <= limits[name]
               for name, a, b in _chunk_fields(out, want)):
            fail(f"the decoder comparison passes a perturbed output "
                 f"({what})")


def _decoder_work(fp, B, T, cs, keep, n_filters, att_size=None):
    """Bytes one chunk call must move (each input read once, each output
    written once) and the FLOPs of its products (2 per multiply-add).
    ``att_size`` is the element size of memory and processed memory (the
    weights' unless given)."""
    n, p = fp.pre1.shape
    nb1, k1, cols = fp.w1.shape            # block-major LSTM weights
    nb2, k2, _ = fp.w2.shape
    a4, d4 = nb1 * cols, nb2 * cols
    a, d = a4 // 4, d4 // 4
    ks, _, datt = fp.k2.shape
    e = k2 - a - d
    size = lambda x: x.numel() * x.element_size()
    # each weight once: not the fragment-order copies of the LSTMs
    nbytes = sum(size(x) for x in fp._replace(w1f=None, w2f=None)
                 if x is not None)
    wsz = att_size or fp.w1.element_size()
    nbytes += B * T * (e + datt) * wsz + B * T * 4          # mem, proc, mask
    nbytes += 2 * 4 * B * (2 * a + 2 * d + e + n + 2 * T + 2)  # carry in+out
    nbytes += 4 * cs * B * (n + 1 + T)                     # mel, gate, align
    if keep:
        nbytes += 2 * 4 * cs * B * p
    # the location term as the model states it, conv then dense (fewer
    # operations than the folded K2 form the kernel evaluates)
    loc = T * n_filters * 2 * ks + T * n_filters * datt
    macs = (n * p + p * p + k1 * a4 + a * datt + loc
            + T * datt + T * e + k2 * d4 + (d + e) * (n + 1))
    return nbytes, 2.0 * cs * B * macs


# 192-symbol bucket
MIDDLE_TEXTS = [f"{a} {b}" for a, b in zip(LONG_TEXTS[1:], SHORT_TEXTS[1:])]


def serving_phase(cfg, dev, card, seed):
    for texts, bucket in ((SHORT_TEXTS, 64), (LONG_TEXTS, 128),
                          (MIDDLE_TEXTS, 192)):
        for t in texts:
            got = text_bucket(len(text_to_sequence(t, cfg.text_cleaners)),
                              cfg.text_buckets)
            if got != bucket:
                fail(f"text {t!r} falls in bucket {got}, not {bucket}")
    max_steps = 200
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(seed))
    synth = BatchingSynthesizer(model, cfg, max_batch=8, max_steps=max_steps,
                                max_wait_ms=50.0, device=dev)
    try:
        synth.synthesize(SHORT_TEXTS[:2])  # warm-up: cuBLAS/cuDNN set-up
        el.bilstm_forward.launches = 0
        db.decoder_chunk.launches = 0
        el.bilstm_forward_plain.calls = 0
        db.decoder_chunk_plain.calls = 0
        lat, results = [], []
        for texts in (SHORT_TEXTS, LONG_TEXTS):
            t0 = time.perf_counter()
            results += synth.synthesize(texts)
            lat.append(time.perf_counter() - t0)
        counts = {"encoder_lstm_fwd": el.bilstm_forward.launches,
                  "decoder_chunk": db.decoder_chunk.launches}
        plain_calls = (el.bilstm_forward_plain.calls
                       + db.decoder_chunk_plain.calls)
    finally:
        synth.close()
    r = cfg.n_frames_per_step
    texts = SHORT_TEXTS + LONG_TEXTS
    frames = 0
    for text, (mel, align, n) in zip(texts, results):
        n_ids = len(text_to_sequence(text, cfg.text_cleaners))
        if not (0 < n <= max_steps * r):
            fail(f"{text!r}: {n} frames, outside 1..{max_steps * r}")
        if mel.shape != (n, cfg.n_mel_channels) or align.shape != (n, n_ids):
            fail(f"{text!r}: mel {mel.shape}, align {align.shape}")
        if not (torch.isfinite(torch.from_numpy(mel)).all()
                and torch.isfinite(torch.from_numpy(align)).all()):
            fail(f"{text!r}: non-finite output")
        frames += n
    for name, c in counts.items():
        if c == 0:
            fail(f"serving never launched the {name} kernel")
    if plain_calls:
        fail(f"serving ran a plain version {plain_calls} times on the card")
    print(f"serving [{card}] bf16 max_batch=8 max_steps={max_steps}: "
          f"{len(results)} requests in 2 batches (buckets 64, 128); batch "
          f"latency {lat[0] * 1e3:.1f} ms, {lat[1] * 1e3:.1f} ms; "
          f"{frames / sum(lat):.1f} mel frames/s; launches {counts}")
    served_tiles_check(model, cfg, dev, card, max_steps)
    return counts, model


def served_tiles_check(model, cfg, dev, card, max_steps):
    """``BatchingSynthesizer(max_batch=32)``: the constructor returns with
    every (row tile, text bucket) shape decoded once; batches of 5, 13, 20
    and 27 requests (buckets 64, 128, 192, 128) launch at 8, 16, 24 and 32
    rows (``_rows``); every request's output is well formed; no plain
    version runs."""
    r = cfg.n_frames_per_step
    t0 = time.perf_counter()
    synth = BatchingSynthesizer(model, cfg, max_batch=32, max_steps=max_steps,
                                max_wait_ms=200.0, device=dev)
    built_s = time.perf_counter() - t0
    shapes = []
    infer = synth._infer

    def recorded(text, lengths):
        shapes.append(tuple(text.shape))
        return infer(text, lengths)

    synth._infer = recorded
    el.bilstm_forward_plain.calls = 0
    db.decoder_chunk_plain.calls = 0
    batches = ((5, SHORT_TEXTS), (13, LONG_TEXTS), (20, MIDDLE_TEXTS),
               (27, LONG_TEXTS))
    try:
        want_warm = [(rows, t) for rows in (8, 16, 24, 32)
                     for t in cfg.text_buckets]
        if synth.tiles != [8, 16, 24, 32] or synth.warmed != want_warm:
            fail(f"max_batch=32: tiles {synth.tiles}, warmed "
                 f"{synth.warmed}, not {want_warm}")
        for n, pool in batches:
            texts = [pool[i % len(pool)] for i in range(n)]
            for text, (mel, align, frames) in zip(texts,
                                                  synth.synthesize(texts)):
                n_ids = len(text_to_sequence(text, cfg.text_cleaners))
                if not (0 < frames <= max_steps * r
                        and mel.shape == (frames, cfg.n_mel_channels)
                        and align.shape == (frames, n_ids)
                        and np.isfinite(mel).all()
                        and np.isfinite(align).all()):
                    fail(f"max_batch=32, a batch of {n}: {text!r} gave "
                         f"{frames} frames, mel {mel.shape}, align "
                         f"{align.shape}, or a value not finite")
        plain_calls = (el.bilstm_forward_plain.calls
                       + db.decoder_chunk_plain.calls)
    finally:
        synth.close()
    want = [(synth._rows(n), text_bucket(max(
        len(text_to_sequence(t, cfg.text_cleaners)) for t in pool[:n]),
        cfg.text_buckets)) for n, pool in batches]
    if shapes != want or [b for b, _ in want] != [8, 16, 24, 32]:
        fail(f"max_batch=32: batches of {[n for n, _ in batches]} launched "
             f"at {shapes}, not {want}")
    if plain_calls:
        fail(f"max_batch=32: a plain version ran {plain_calls} times on "
             f"the card")
    print(f"serving [{card}] bf16 max_batch=32 max_steps={max_steps}: built "
          f"in {built_s:.3f} s with {len(synth.warmed)} shapes warmed; "
          f"batches of {[n for n, _ in batches]} launched at {shapes}")


def breakdown_phase(model, cfg, dev, card):
    """Where one warm 8-row batch (bucket 128, 200 steps, bf16) spends its
    time: host-clock stages, each ended by a synchronize; then
    torch.profiler over a 64-step batch for device time by kernel and the
    device's idle share of the profiled window."""
    g = torch.Generator(device=dev).manual_seed(13)
    B, T = 8, 128
    text = torch.randint(1, cfg.n_symbols, (B, T), generator=g, device=dev)
    lengths = torch.full((B,), T, device=dev)
    cd = cfg.torch_compute_dtype
    packed = db.pack_batch_decoder_params(model, cd)
    packed_lstm = tm.pack_encoder_lstm(model, cd)
    mask = torch.arange(T, device=dev)[None] < lengths[:, None]
    marks = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        marks[name] = (time.perf_counter() - t0) * 1e3
        return out

    for _ in range(2):  # the first pass warms cuDNN on this thread
        stage("encode, LSTM packed per call", lambda: tm.encode(
            model, text, lengths, cfg, compute_dtype=cd))
        memory = stage("encode", lambda: tm.encode(
            model, text, lengths, cfg, compute_dtype=cd,
            packed_lstm=packed_lstm))
        processed = stage("processed memory",
                          lambda: tm.processed_memory_of(model, memory, cd))
        mel = stage("decode (4 chunks)", lambda: db.decode_autoregressive_batch(
            packed, memory, processed, mask, cfg, max_steps=200))[0]
        stage("postnet", lambda: tm.postnet_apply(model, mel, cfg,
                                                  compute_dtype=cd))
    print(f"breakdown [{card}] bf16 B=8 T_in=128 200 steps, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in marks.items()))

    run = lambda: tm.infer_batch_fused(model, text, lengths, cfg,
                                       packed=packed,
                                       packed_lstm=packed_lstm, max_steps=64,
                                       device=dev)
    run()
    torch.cuda.synchronize()
    print(f"profile [{card}] bf16 B=8 T_in=128 64 steps: "
          + profile_kernels(run, top=10))


def _device_events(run, activities, tries=3):
    """torch.profiler's device events of one run(). Now and then a short
    session on the card's machine records no device event at all, so the
    session is widened by 50 ms of idle time on each side of run(), and a
    session that still records none is taken again, up to ``tries``
    times."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(0.05)
            run()
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    fail("the profiler saw no device activity")


def profiled_kernels(run):
    """The names of the CUDA kernels (and memsets, copies) one run()
    launches, in launch order, by torch.profiler."""
    events = sorted(_device_events(run, [ProfilerActivity.CUDA]),
                    key=lambda e: e.time_range.start)
    return [e.name.split("(")[0].split("<")[0].replace("void ", "")
            for e in events]


def profile_kernels(run, top: int) -> str:
    """torch.profiler over one run(): the device window, the kernels' busy
    time, the idle share and the ``top`` kernels by total time."""
    return summarize_kernels(_device_events(
        run, [ProfilerActivity.CPU, ProfilerActivity.CUDA]), top)


def summarize_kernels(kernels, top: int) -> str:
    """The device window of a profiler's device events, their busy time,
    the idle share and the ``top`` kernels by total time."""
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.end - e.time_range.start for e in kernels)
    by_name = {}
    for e in kernels:
        name = e.name.split("(")[0].split("<")[0].replace("void ", "")
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + e.time_range.end - e.time_range.start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return (f"device window {end - start:.1f} us, kernels {busy:.1f} us, "
            f"idle share {1 - busy / (end - start):.3f}; by kernel (calls, "
            f"us per call, ms in all): " + "; ".join(
                f"{k} {n} x {t / n:.2f} = {t / 1e3:.2f}"
                for k, (n, t) in ranked))


def fp32_phase(cfg, dev, card, seed):
    """fp32 on the card, where only the encoder has a kernel: the encoder
    (its fp32 path) over eight serving texts against its plain version on
    the CPU, same seeded weights; then the serving, streaming and
    single-utterance entry points must refuse an fp32 config on the card
    (the decoder kernels take bf16 alone) before any launch, and no plain
    decoder may run there."""
    cfg32 = cfg.replace(compute_dtype="float32")
    texts = SHORT_TEXTS[:4] + LONG_TEXTS[:4]
    ids, lengths = tinfer.encode_texts(texts, cfg32)
    memory = {}
    launches = el.bilstm_forward.launches
    for device in (dev, torch.device("cpu")):
        model = tm.Tacotron2(cfg32, torch.Generator().manual_seed(seed)
                             ).to(device).eval()
        with torch.no_grad():
            memory[device.type] = tm.encode(model, ids.to(device),
                                            lengths.to(device), cfg32).cpu()
    if el.bilstm_forward.launches != launches + 1:
        fail(f"fp32 encoder: {el.bilstm_forward.launches - launches} "
             f"launches of the encoder kernel, not 1")
    err, ok = worst(memory["cuda"], memory["cpu"], SERVE_TOL_FP32)
    if not ok:
        fail(f"fp32 encoder: card and CPU plain path differ by {err}")
    model = tm.Tacotron2(cfg32, torch.Generator().manual_seed(seed)).to(dev)
    counted = (db.decoder_chunk, ds.decoder_step_chunk, el.bilstm_forward)
    plain = (db.decoder_chunk_plain, ds.decoder_step_chunk_plain)
    before = ([f.launches for f in counted], [f.calls for f in plain])
    entries = {
        "BatchingSynthesizer": lambda: BatchingSynthesizer(
            model, cfg32, max_batch=8, device=dev).close(),
        "StreamingSynthesizer": lambda: StreamingSynthesizer(
            model, cfg32, device=dev),
        "infer_fused": lambda: tm.infer_fused(model, ids[:1], lengths[:1],
                                              cfg32, max_steps=32,
                                              device=dev)}
    for name, entry in entries.items():
        try:
            entry()
        except ValueError as e:
            if "take bf16" not in str(e):
                fail(f"fp32 {name} on the card: {e}")
        else:
            fail(f"fp32 {name} ran on the card")
    after = ([f.launches for f in counted], [f.calls for f in plain])
    if after != before:
        fail(f"fp32 refusals: launches and plain calls {before} -> {after}")
    print(f"fp32 [{card}] encoder over 8 texts: the card against the plain "
          f"path on the CPU, max |err| {err:.3e} (atol {SERVE_TOL_FP32[0]}, "
          f"rtol {SERVE_TOL_FP32[1]}); {', '.join(entries)} refuse fp32 on "
          f"the card, no launch, no plain decoder")


# ------------------------------------------------- one utterance to audio

# Single-utterance decoder chunk, kernel against its plain version: as
# DEC_REL, each field's largest |err| as a share of its largest |value|,
# limits about ten times the worst reading on the card over this script's
# chunks and those of tests/test_torch_kernels_gpu.py (its table's bf16
# row).
STEP_REL = {
    torch.bfloat16: dict(mel=1e-2, gate=3e-1, align=2e-2, h1=1e-2, c1=1e-2,
                         h2=5e-3, c2=5e-3, w=2e-2, wc=2e-3, ctx=3e-3,
                         prev=1e-2),
}
# int8 product: bf16 x int8 products are exact in fp32, the sums run in
# another order: largest |err| as a share of the output's largest |value|
# (worst reading on an NVIDIA H100 80GB HBM3 at 700 W: 2.2e-7).
INT8_REL = 1e-5
# Mel kernel against its plain version, in the log domain: the sums of 1024
# and 513 fp32 terms run in another order, and the log turns the relative
# error of a value near the 1e-5 floor into an absolute one (worst reading
# on an NVIDIA H100 80GB HBM3 at 700 W: 9.5e-7).
MEL_LOG_ATOL = 1e-4
# Streamed against offline, bf16: the same function of the same inputs
# through windows; a conv's sum that differs in its last bit can round a
# bf16 operand the other way (2^-8 of it). Share of the largest |value|.
STREAM_REL_BF16 = 2e-2
UTTERANCE = LONG_TEXTS[1]   # 128-symbol bucket
UTTERANCE_STEPS = 200


# csrc/decoder_step.cu's kernel
STEP_KERNELS = ("persistent_chunk_kernel",)


def step_phase(model, cfg, dev, card):
    """Row 6 at full width, B=1, bf16: every shape class against the plain
    version; timed at T_in=128, one 64-step chunk, beside the batched
    chunk's entry (row 5) called at B=1 on the same inputs, with its
    per-step byte floor; a chunk must be one launch of the persistent
    kernel (torch.profiler)."""
    n = cfg.n_mel_channels * cfg.n_frames_per_step
    a, d, e = (cfg.attention_rnn_dim, cfg.decoder_rnn_dim,
               cfg.encoder_embedding_dim)
    dtype = cd = torch.bfloat16
    limits = STEP_REL[dtype]
    fp = ds.pack_decoder_params(model, dtype)
    fpb = db.pack_batch_decoder_params(model, dtype)
    cases = [(T, cs, keep) for T in (64, 128, 192) for cs in (32, 64)
             for keep in (False, True)]
    worst = {}
    for T, cs, keep in cases:
        label = f"bf16 T_in={T} chunk={cs}{' keep' if keep else ''}"
        g = torch.Generator(device=dev).manual_seed(31 + T + cs)
        text = torch.randint(1, cfg.n_symbols, (1, T), generator=g,
                             device=dev)
        lengths = torch.tensor([T - 9], device=dev)
        memory = tm.encode(model, text, lengths, cfg, compute_dtype=cd)
        processed = tm.processed_memory_of(model, memory, cd)
        mask = torch.arange(T, device=dev)[None] < lengths[:, None]
        inputs = ds.attention_inputs(memory, processed, mask)
        z = lambda *s: torch.zeros(*s, device=dev)
        i32 = lambda: torch.zeros(1, dtype=torch.int32, device=dev)
        carry = db.ChunkCarry(z(1, a), z(1, a), z(1, d), z(1, d), z(1, T),
                              z(1, T), z(1, e), z(1, n), i32(), i32())
        kp = (None, None)
        if keep:
            kp = tuple((torch.rand(cs, 1, cfg.prenet_dim, generator=g,
                                   device=dev) < 0.5).float()
                       for _ in range(2))
        kw = dict(t0=0, chunk_steps=cs, gate_logit=db.gate_logit_threshold(
            cfg), kp1=kp[0], kp2=kp[1])
        args = (fp, carry, *inputs)
        got = ds.decoder_step_chunk(*args, **kw)
        want = ds.decoder_step_chunk_plain(*args, **kw)
        torch.cuda.synchronize()
        fields = {name: field_err(x, y)
                  for name, x, y in _chunk_fields(got, want)}
        for name, (err, r) in fields.items():
            if r > limits[name]:
                fail(f"single-utterance decoder kernel ({label}) disagrees "
                     f"with its plain version on {name}: max |err| {err}, "
                     f"{r:.3e} of the field's largest value, beyond "
                     f"{limits[name]}")
            worst[name] = max(worst.get(name, (0.0, 0.0)), (r, err))
        for name in ("fin", "lens"):
            if not torch.equal(getattr(got.carry, name),
                               getattr(want.carry, name)):
                fail(f"single-utterance decoder kernel ({label}): {name} "
                     f"differs from the plain version")
        if (T, cs, keep) == (128, 64, False):
            _check_catches(got, want, limits)
            names = profiled_kernels(lambda: ds.decoder_step_chunk(
                *args, **kw))
            chunk = [k for k in names if k in STEP_KERNELS]
            if chunk != ["persistent_chunk_kernel"]:
                fail(f"a bf16 single-utterance chunk launched {chunk}, "
                     f"not one persistent kernel")
            per_chunk = {"kernels": len(chunk),
                         "set_up": len(names) - len(chunk)}
            print(f"decoder step [{card}] {label} under torch.profiler: "
                  f"{len(chunk)} launch of {chunk[0]} (the first design "
                  f"launched 7 x {cs} = {7 * cs}); set-up: "
                  f"{len(names) - len(chunk)} ("
                  f"{', '.join(sorted(set(names) - set(chunk)))})")
            ms = cuda_ms(lambda: ds.decoder_step_chunk(*args, **kw), iters=5)
            plain_ms = cuda_ms(lambda: ds.decoder_step_chunk_plain(
                *args, **kw), iters=2, warmup=1)
            inb = db.attention_inputs(memory, processed, mask, dtype)
            batched_ms = cuda_ms(lambda: db.decoder_chunk(
                fpb, carry, *inb, **kw), iters=5)
            nbytes, flops = _decoder_work(
                fp, 1, T, cs, False, cfg.attention_location_n_filters,
                att_size=4)
            bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
            # what each step must touch whatever the kernel keeps: both
            # LSTMs' weights, memory and processed memory, once a step
            size = lambda x: x.numel() * x.element_size()
            step_b = (size(fp.w1) + size(fp.w2) + size(inputs[0])
                      + size(inputs[1]))
            floor_ms = cs * step_b / HBM_BYTES_PER_S * 1e3
            timed = dict(ms=ms, plain_ms=plain_ms,
                         batched_entry_at_b1_ms=batched_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         floor_ms=floor_ms)
            print(f"decoder step [{card}] {label} B=1: kernel {ms:.4f} ms "
                  f"({ms / cs * 1e3:.2f} us a step), plain {plain_ms:.4f} ms,"
                  f" the batched chunk's entry at B=1 {batched_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_by}); per-step floor "
                  f"{step_b / 1e6:.1f} MB, {floor_ms:.4f} ms at the HBM rate")
    print(f"decoder step [{card}] bf16, worst over {len(cases)} shape "
          f"classes: max |err| by field, as a share of the field's largest "
          f"|value| (limit): " + ", ".join(
              f"{k} {worst[k][0]:.2e} ({limits[k]})" for k in DEC_FIELDS))
    return {"name": "decoder_step_chunk", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/decoder_step.cu",
            "replaces": "tacotron2_tpu/kernels/decoder_step.py:198",
            "max_abs_err": max(v[1] for v in worst.values()),
            "tolerance": {"share_of_field_max": limits},
            **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "floor_ms")},
            "library_ms": None,
            "batched_entry_at_b1_ms": timed["batched_entry_at_b1_ms"],
            "launches_per_chunk": per_chunk}


def int8_phase(dev, card):
    """Row 7 at the two decoder cells' shapes (attention LSTM K=1792,
    decoder LSTM K=2560; N=4096) at B=1 and B=8, and ragged shapes; x in
    fp32 and bf16. Times: the C entry point and torch.matmul on a bf16 copy
    dequantised ahead of time, each as device time in a CUDA graph of 100
    calls and back to back from the host (CUDA events), and a wrapper
    call; the weights stay in the 50 MB L2 between calls in both, as they
    do between the decoder's steps."""
    g = torch.Generator(device=dev).manual_seed(41)
    out = {}
    for B, K, N in ((1, 1792, 4096), (1, 2560, 4096), (8, 1792, 4096),
                    (8, 2560, 4096), (3, 100, 83), (19, 257, 40), (2, 33, 7),
                    (13, 2560, 4096)):
        x = torch.randn(B, K, generator=g, device=dev)
        w = torch.randn(K, N, generator=g, device=dev) * 0.05
        w_q, scale = (t.to(dev) for t in i8.quantize_int8(w))
        packed = i8.pack_int8(w_q)
        want = i8.int8_matmul_plain(x, w_q, scale)
        errs = []
        for xx in (x, x.to(torch.bfloat16)):
            got = i8.int8_matmul(xx, w_q, scale, packed=packed)
            again = i8.int8_matmul(xx, w_q, scale, packed=packed)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"int8 kernel B={B} K={K} N={N}: two runs differ")
            err, rel = field_err(got, want)
            if rel > INT8_REL:
                fail(f"int8 kernel B={B} K={K} N={N} x {xx.dtype}: max "
                     f"|err| {err}, {rel:.3e} of the largest value, beyond "
                     f"{INT8_REL}")
            errs.append((err, rel))
        bad = got.clone()
        bad[:, N // 2] *= 1.05
        if field_err(bad, want)[1] <= INT8_REL:
            fail("the int8 comparison passes a column scaled by 1.05")
        err, rel = max(errs)
        if N != 4096 or B > 8:
            print(f"int8 [{card}] B={B} K={K} N={N}: max |err| {err:.3e} "
                  f"({rel:.2e} of the largest value, limit {INT8_REL}; x in "
                  f"fp32 and bf16, the same bits twice)")
            continue
        plain_ms = cuda_ms(lambda: i8.int8_matmul_plain(x, w_q, scale),
                           iters=20)
        # one library call on the same inputs: a bf16 matmul against a copy
        # dequantised ahead of time (twice the weight bytes; the scale
        # folded into the copy, so not the kernel's rounding). A call of
        # either from Python is the host's time: the two are timed in turns,
        # five rounds, and the medians kept
        xb = x.to(torch.bfloat16)
        wb = (w_q.float() * scale).to(torch.bfloat16)
        rounds = [(cuda_ms(lambda: i8.int8_matmul(x, w_q, scale,
                                                  packed=packed), iters=100),
                   cuda_ms(lambda: torch.matmul(xb, wb), iters=100))
                  for _ in range(5)]
        ms = sorted(r[0] for r in rounds)[2]
        lib_b2b = sorted(r[1] for r in rounds)[2]
        lib_graph = graph_ms(lambda: torch.matmul(xb, wb))
        # the C entry point alone, on the wrapper's own arguments
        lib = i8._lib()
        res = torch.empty(B, N, device=dev)
        entry = lambda: lib.int8_matmul(
            x.data_ptr(), 0, packed.data_ptr(), scale.data_ptr(),
            res.data_ptr(), B, K, N,
            torch.cuda.current_stream(dev).cuda_stream)
        entry_b2b = cuda_ms(entry, iters=200)
        entry_graph = graph_ms(entry)
        nbytes = K * N + 4 * (B * K + N + B * N)
        bound_ms, bound_by = bound(nbytes, 2.0 * B * K * N, "bfloat16")
        print(f"int8 [{card}] B={B} K={K} N={N}: max |err| {err:.3e} "
              f"({rel:.2e} of the largest value, limit {INT8_REL}); the C "
              f"entry point {entry_graph * 1e3:.2f} us in a graph "
              f"({bound_ms / entry_graph * 100:.0f}% of the bound), "
              f"{entry_b2b * 1e3:.2f} us back to back; torch.matmul on a "
              f"dequantised bf16 copy {lib_graph * 1e3:.2f} us in a graph, "
              f"{lib_b2b * 1e3:.2f} us back to back; a wrapper call "
              f"{ms * 1e3:.2f} us (medians of 5 rounds in turns with the "
              f"library's); plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.5f} ms ({bound_by})")
        out[(B, K)] = dict(max_abs_err=err, ms=entry_graph,
                           entry_back_to_back_ms=entry_b2b, wrapper_ms=ms,
                           plain_ms=plain_ms, library_ms=lib_graph,
                           library_back_to_back_ms=lib_b2b,
                           bound_ms=bound_ms, bound_by=bound_by)
    r = out[(1, 2560)]
    shapes = {f"B={B} K={K} N=4096": v for (B, K), v in out.items()}
    return {"name": "int8_matmul", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/int8_matmul.cu",
            "replaces": "tacotron2_tpu/kernels/int8_matmul.py:45",
            "max_abs_err": max(v["max_abs_err"] for v in out.values()),
            "tolerance": {"share_of_largest_value": INT8_REL},
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": "torch.matmul on a bf16 copy dequantised ahead of "
                       "time", "timed_at": "B=1 K=2560 N=4096",
            "timed_as": "device time per call in a CUDA graph of 100 calls "
                        "(the C entry point; the library call likewise)",
            "wrapper_ms": r["wrapper_ms"],
            "entry_back_to_back_ms": r["entry_back_to_back_ms"],
            "shapes": shapes}


def _waveforms(dev, B, S, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    y = (torch.rand(B, S, generator=g, device=dev) * 2 - 1) * 0.3
    y[0] *= 1e-4   # a quiet row: most of its mels near the 1e-5 floor
    return y


def mel_phase(cfg, dev, card):
    """Row 8: 16 waveforms of 6 s at the default front end (n_fft 1024, hop
    256, 80 mels), and ragged lengths, against the plain version."""
    mc = tmel.MelConfig.from_config(cfg)
    res = None
    for B, S in ((16, 6 * cfg.sampling_rate), (3, 10000), (1, 700)):
        y = _waveforms(dev, B, S, 51)
        got = mk.mel_spectrogram_fused(y, mc)
        want = mk.mel_spectrogram_fused_plain(y, mc)
        torch.cuda.synchronize()
        T = 1 + S // mc.hop_length
        if tuple(got.shape) != (B, mc.n_mel_channels, T):
            fail(f"mel kernel: shape {tuple(got.shape)}")
        err = float((got - want).abs().max())
        if err > MEL_LOG_ATOL:
            fail(f"mel kernel B={B} samples={S}: max |err| {err} in the log "
                 f"domain, beyond {MEL_LOG_ATOL}")
        if float((torch.roll(got, 1, dims=2) - want).abs().max()) \
                <= MEL_LOG_ATOL:
            fail("the mel comparison passes frames shifted by one")
        if B != 16:
            print(f"mel [{card}] B={B} samples={S} ({T} frames): max |err| "
                  f"{err:.3e} in the log domain (limit {MEL_LOG_ATOL})")
            continue
        ms = cuda_ms(lambda: mk.mel_spectrogram_fused(y, mc), iters=10)
        plain_ms = cuda_ms(lambda: mk.mel_spectrogram_fused_plain(y, mc),
                           iters=10)
        library_ms = cuda_ms(lambda: tmel.mel_spectrogram(y, mc), iters=10)
        n_fft, n_bins, n_mels = (mc.filter_length, mc.stft.n_bins,
                                 mc.n_mel_channels)
        nbytes = 4 * (B * S + 2 * n_fft * n_bins + n_bins * n_mels
                      + B * n_mels * T)
        # the DFT at the 3xTF32 rate, at the depth the kernel's fold needs
        # (rows k <= n_fft / 2 of [cos | sin], once per part of the folded
        # bases), the mel product at the fp32 rate
        parts = mk.packed_bases(mc, dev)[0].shape[1]
        depth = parts * (n_fft // 2 + 1)
        rates = {"tf32x3": 2.0 * B * T * 2 * depth * n_bins,
                 "float32": 2.0 * B * T * n_bins * n_mels}
        bound_ms, bound_by = bound(nbytes, rates)
        print(f"mel [{card}] B={B} samples={S} ({T} frames) fp32: max |err| "
              f"{err:.3e} in the log domain (limit {MEL_LOG_ATOL}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, audio.mel."
              f"mel_spectrogram (two torch.matmul) {library_ms:.4f} ms, bound"
              f" {bound_ms:.5f} ms ({bound_by}: the folded DFT, depth "
              f"{depth}, at tf32x3, {PEAK_FLOPS['tf32x3'] / 1e12:.0f} "
              f"TFLOP/s, the mel product at float32); share of the bound "
              f"{bound_ms / ms:.1%}")
        if ms > library_ms:
            print(f"mel [{card}] note: the kernel ({ms:.4f} ms) is slower "
                  f"than the library call ({library_ms:.4f} ms)")
        res = {"name": "mel_spectrogram_fused", "route": "cuda",
               "source": "tacotron2_tpu_torch/kernels/csrc/mel_kernel.cu",
               "replaces": "tacotron2_tpu/kernels/mel_kernel.py:34",
               "max_abs_err": err,
               "tolerance": {"log_domain_atol": MEL_LOG_ATOL},
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "bound_rates": f"DFT folded to depth {depth} at tf32x3 "
                              f"(495/3 TFLOP/s), mel product at float32",
               "library_ms": library_ms,
               "library": "audio.mel.mel_spectrogram (two torch.matmul)"}
    return res


UTTERANCE_KERNELS = {"encoder_lstm_fwd": el.bilstm_forward,
                     "decoder_step_chunk": ds.decoder_step_chunk,
                     "int8_matmul": i8.int8_matmul,
                     "mel_spectrogram_fused": mk.mel_spectrogram_fused,
                     "decoder_chunk": db.decoder_chunk}
UTTERANCE_PLAIN = (el.bilstm_forward_plain, db.decoder_chunk_plain,
                   ds.decoder_step_chunk_plain, i8.int8_matmul_plain,
                   mk.mel_spectrogram_fused_plain)


def _counted(what, run, must_launch):
    """run() with every launch count of the path set to 0 just before and
    read just after: the kernels in ``must_launch`` must have launched, and
    no plain version may have run. Returns (run's result, the counts)."""
    for fn in UTTERANCE_KERNELS.values():
        fn.launches = 0
    plain0 = sum(f.calls for f in UTTERANCE_PLAIN)
    out = run()
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in UTTERANCE_KERNELS.items()}
    plain = sum(f.calls for f in UTTERANCE_PLAIN) - plain0
    for name in must_launch:
        if counts[name] == 0:
            fail(f"{what} never launched the {name} kernel")
    if plain:
        fail(f"{what} ran a plain version {plain} times on the card")
    return out, counts


def _timed(run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _check_result(what, res, cfg, steps, audio=True):
    n = res.mel.shape[0]
    if not 0 < n <= steps * cfg.n_frames_per_step \
            or res.mel.shape[1] != cfg.n_mel_channels:
        fail(f"{what}: mel {res.mel.shape}")
    arrays = [res.mel, res.alignment, res.gate]
    if audio:
        if res.audio is None or not (n - 1) * cfg.hop_length \
                <= res.audio.shape[0] <= n * cfg.hop_length:
            fail(f"{what}: {n} frames but audio "
                 f"{None if res.audio is None else res.audio.shape}")
        arrays.append(res.audio)
    for a in arrays:
        if not torch.isfinite(torch.from_numpy(a)).all():
            fail(f"{what}: non-finite output")


def utterance_phase(cfg, dev, card, seed):
    """One utterance to audio at the default config (bf16, seeded random
    weights, full V1 HiFi-GAN generator): offline through the fused
    decoder with HiFi-GAN and with Griffin-Lim, the int8 weights through
    the step-by-step decoder, streamed with HiFi-GAN, and the front end.
    Random weights never fire the gate: every decode runs to the cap."""
    steps = UTTERANCE_STEPS
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(seed)).to(dev)
    hg = hifigan.HiFiGANConfig(n_mel_channels=cfg.n_mel_channels)
    voc = hifigan.Generator(hg, torch.Generator().manual_seed(seed + 1)
                            ).to(dev)
    counts = {}
    synth = lambda m, **kw: tinfer.synthesize(
        m, [UTTERANCE], cfg, max_steps=steps, vocoder_model=voc,
        vocoder_cfg=hg, device=dev, **kw)[0]
    for voc_kind in ("hifigan", "griffin_lim"):  # warm-up: cuDNN, cuFFT plans
        synth(model, fused=True, vocoder=voc_kind)
    lat = {}
    for voc_kind in ("hifigan", "griffin_lim"):
        (res, lat[voc_kind]), c = _counted(
            f"offline ({voc_kind})",
            lambda: _timed(lambda: synth(model, fused=True,
                                         vocoder=voc_kind)),
            ("encoder_lstm_fwd", "decoder_step_chunk"))
        _check_result(f"offline ({voc_kind})", res, cfg, steps)
        counts[f"offline_{voc_kind}"] = c
    frames = res.mel.shape[0]
    print(f"offline [{card}] bf16 B=1 bucket 128 max_steps={steps}: "
          f"synthesize(fused=True) {frames} frames; latency with HiFi-GAN V1 "
          f"{lat['hifigan']:.1f} ms ({frames / lat['hifigan'] * 1e3:.1f} mel "
          f"frames/s), with Griffin-Lim (30 iterations) "
          f"{lat['griffin_lim']:.1f} ms; launches {counts}")

    qmodel = tm.quantize_for_serving(model)
    synth(qmodel, vocoder="none")      # warm-up: packs, captures the graphs
    (qres, q_ms), c = _counted(
        "the quantized path",
        lambda: _timed(lambda: synth(qmodel, vocoder="none")),
        ("encoder_lstm_fwd",))
    _check_result("the quantized path", qres, cfg, steps, audio=False)
    # the decoder's chunks are graph replays, which the wrapper's count does
    # not see: the int8 kernel's executions are counted on the device
    names = profiled_kernels(lambda: synth(qmodel, vocoder="none"))
    c["int8_matmul"] = sum(n == "int8_matmul_kernel" for n in names)
    if c["int8_matmul"] != 2 * steps:
        fail(f"the quantized path ran the int8 kernel {c['int8_matmul']} "
             f"times on the device, not {2 * steps}")
    # the captured chunks against the same chunks run step by step
    q_ids, q_len = (t.to(dev) for t in tinfer.encode_texts([UTTERANCE], cfg))
    q_mem = tm.encode(qmodel, q_ids, q_len, cfg,
                      compute_dtype=cfg.torch_compute_dtype)
    q_run = lambda capture: tm.decode_autoregressive(
        qmodel, q_mem, q_len, cfg, max_steps=steps,
        compute_dtype=cfg.torch_compute_dtype, capture=capture)
    captured, eager = q_run(True), q_run(False)
    q_eager_ms = _timed(lambda: q_run(False))[1]
    for f, a, b in zip(("mel", "gate", "align", "lengths"), captured, eager):
        if not torch.equal(a, b):
            fail(f"the quantized path's captured chunks differ from the "
                 f"eager loop in {f} by {field_err(a, b)[0]} (tolerance 0: "
                 f"the same kernels in the same order)")
    synth(model, vocoder="none")       # warm-up: captures the bf16 graphs
    (pres, p_ms), _ = _counted(
        "the step-by-step path",
        lambda: _timed(lambda: synth(model, vocoder="none")),
        ("encoder_lstm_fwd",))
    qgap = field_err(torch.from_numpy(qres.mel), torch.from_numpy(pres.mel))
    counts["quantized"] = c
    print(f"quantized [{card}] bf16 B=1 max_steps={steps}: infer on "
          f"quantize_for_serving weights {q_ms:.1f} ms "
          f"({frames / q_ms * 1e3:.1f} mel frames/s) as captured chunks of "
          f"64 steps; its decode {q_eager_ms:.1f} ms step by step (the same "
          f"outputs, bit for bit); the same captured decoder on bf16 weights "
          f"{p_ms:.1f} ms; "
          f"int8 against bf16 weights, mel max |diff| {qgap[0]:.3e} "
          f"({qgap[1]:.2e} of the largest value; quantisation, not held); "
          f"launches {c} (int8_matmul: executions on the device)")
    print(f"quantized profile [{card}] bf16 B=1 {steps} steps: "
          + profile_kernels(lambda: synth(qmodel, vocoder="none"), top=8))

    # streamed, against the offline pass on the text padded to its bucket
    # as the streamer pads it
    ids = text_to_sequence(UTTERANCE, cfg.text_cleaners)
    bucket = text_bucket(len(ids), cfg.text_buckets)
    text = torch.zeros(1, bucket, dtype=torch.long)
    text[0, :len(ids)] = torch.tensor(ids)
    lengths = torch.tensor([len(ids)], dtype=torch.int32)
    off = tm.infer_fused(model, text, lengths, cfg, max_steps=steps,
                         device=dev)
    n = int(off.mel_lengths[0])
    off_audio = hifigan.generator(voc, off.mel_postnet, hg)[0, :n * hg.hop_length]
    streamer = StreamingSynthesizer(model, cfg, vocoder=voc, vocoder_cfg=hg,
                                    chunk_steps=32, max_steps=steps,
                                    device=dev)
    list(streamer.stream(UTTERANCE))                  # warm-up

    def stream():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, mels, audio = None, [], []
        for ev in streamer.stream(UTTERANCE):
            if ev.mel is not None:
                mels.append(torch.from_numpy(ev.mel))
            if ev.audio is not None:
                if first is None:
                    first = (time.perf_counter() - t0) * 1e3
                audio.append(torch.from_numpy(ev.audio))
        total = (time.perf_counter() - t0) * 1e3
        return torch.cat(mels), torch.cat(audio), first, total

    (s_mel, s_audio, first_ms, total_ms), c = _counted(
        "streaming", stream, ("encoder_lstm_fwd", "decoder_step_chunk"))
    counts["streamed"] = c
    if s_mel.shape != (n, cfg.n_mel_channels) \
            or s_audio.shape != off_audio.shape:
        fail(f"streamed {tuple(s_mel.shape)} mel, {tuple(s_audio.shape)} "
             f"audio; offline {n} frames, {tuple(off_audio.shape)} audio")
    gaps = {"mel": field_err(s_mel, off.mel_postnet[0, :n].cpu()),
            "audio": field_err(s_audio, off_audio.cpu())}
    for name, (err, rel) in gaps.items():
        if rel > STREAM_REL_BF16:
            fail(f"streamed {name} departs from the offline pass by {err}, "
                 f"{rel:.3e} of its largest value, beyond {STREAM_REL_BF16}")
    print(f"streamed [{card}] bf16 B=1 chunk_steps=32 max_steps={steps} with "
          f"HiFi-GAN V1: first audio after {first_ms:.1f} ms, all {n} frames "
          f"after {total_ms:.1f} ms; against the offline pass, max |diff| as "
          f"a share of the largest value (limit {STREAM_REL_BF16}): "
          + ", ".join(f"{k} {r:.2e}" for k, (_, r) in gaps.items())
          + f"; launches {c}")

    counts["stream_batch"] = stream_batch_check(model, voc, hg, streamer,
                                                cfg, dev, card, steps)

    mc = tmel.MelConfig.from_config(cfg)
    y = _waveforms(dev, 16, 6 * cfg.sampling_rate, 52)
    (mels, fe_ms), c = _counted(
        "the front end",
        lambda: _timed(lambda: tmel.mel_spectrogram_backend(y, mc, "cuda")),
        ("mel_spectrogram_fused",))
    counts["front_end"] = c
    if tuple(mels.shape) != (16, 80, 1 + y.shape[1] // 256) \
            or not torch.isfinite(mels).all():
        fail(f"front end: mel {tuple(mels.shape)}")
    gap = float((mels - tmel.mel_spectrogram(y, mc)).abs().max())
    if gap > MEL_LOG_ATOL:
        fail(f"front end: the kernel backend departs from the torch backend "
             f"by {gap} in the log domain")
    print(f"front end [{card}] 16 waveforms of 6 s through "
          f"mel_spectrogram_backend(..., 'cuda'): {fe_ms:.2f} ms by the host"
          f" clock, {mels.shape[2]} frames each, against the torch backend "
          f"max |diff| {gap:.3e} in the log domain; launches {c}")
    utterance_breakdown(model, voc, hg, cfg, dev, card, text, lengths)
    return counts


def stream_batch_check(model, voc, hg, streamer, cfg, dev, card, steps):
    """``StreamingSynthesizer.stream_batch`` on four texts (bucket 128),
    row 5's other caller, against the offline batch (``infer_batch_fused``
    and HiFi-GAN on the same bucket-padded texts) within the streaming
    tolerance; returns the launch counts of the streamed run."""
    texts = LONG_TEXTS[:4]
    ids = [text_to_sequence(t, cfg.text_cleaners) for t in texts]
    bucket = max(text_bucket(len(i), cfg.text_buckets) for i in ids)
    text = torch.zeros(len(ids), bucket, dtype=torch.long)
    for i, x in enumerate(ids):
        text[i, :len(x)] = torch.tensor(x)
    lengths = torch.tensor([len(x) for x in ids], dtype=torch.int32)
    off = tm.infer_batch_fused(model, text, lengths, cfg, max_steps=steps,
                               device=dev)
    off_audio = hifigan.generator(voc, off.mel_postnet, hg)
    list(streamer.stream_batch(texts))                # warm-up

    def stream():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = None
        mels = [[] for _ in texts]
        audio = [[] for _ in texts]
        for row, ev in streamer.stream_batch(texts):
            if ev.mel is not None:
                mels[row].append(torch.from_numpy(ev.mel))
            if ev.audio is not None:
                if first is None:
                    first = (time.perf_counter() - t0) * 1e3
                audio[row].append(torch.from_numpy(ev.audio))
        total = (time.perf_counter() - t0) * 1e3
        return ([torch.cat(m) for m in mels], [torch.cat(a) for a in audio],
                first, total)

    (mels, audio, first_ms, total_ms), c = _counted(
        "stream_batch", stream, ("encoder_lstm_fwd", "decoder_chunk"))
    worst = {"mel": 0.0, "audio": 0.0}
    for row in range(len(texts)):
        n = int(off.mel_lengths[row])
        want = {"mel": off.mel_postnet[row, :n].cpu(),
                "audio": off_audio[row, :n * hg.hop_length].cpu()}
        for name, got in (("mel", mels[row]), ("audio", audio[row])):
            if got.shape != want[name].shape:
                fail(f"stream_batch row {row}: {name} {tuple(got.shape)}, "
                     f"offline {tuple(want[name].shape)}")
            err, rel = field_err(got, want[name])
            if rel > STREAM_REL_BF16:
                fail(f"stream_batch row {row}: {name} departs from the "
                     f"offline batch by {err}, {rel:.3e} of its largest "
                     f"value, beyond {STREAM_REL_BF16}")
            worst[name] = max(worst[name], rel)
    print(f"stream_batch [{card}] bf16 B={len(texts)} bucket {bucket} "
          f"chunk_steps={streamer.chunk_steps} max_steps={steps} with "
          f"HiFi-GAN V1: first audio after {first_ms:.1f} ms, all after "
          f"{total_ms:.1f} ms; against the offline batch, worst max |diff| "
          f"as a share of the largest value (limit {STREAM_REL_BF16}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; launches {c}")
    return c


def utterance_breakdown(model, voc, hg, cfg, dev, card, text, lengths):
    """Where one warm utterance (bucket 128, 200 steps, bf16, HiFi-GAN V1)
    spends its time: host-clock stages, each ended by a synchronize; then
    torch.profiler over a 64-step ``infer_fused``."""
    cd = cfg.torch_compute_dtype
    packed = ds.pack_decoder_params(model, cd)
    packed_lstm = tm.pack_encoder_lstm(model, cd)
    text, lengths = text.to(dev), lengths.to(dev)
    mask = torch.arange(text.shape[1], device=dev)[None] < lengths[:, None]
    marks = {}
    for _ in range(2):
        memory, marks["encode"] = _timed(lambda: tm.encode(
            model, text, lengths, cfg, compute_dtype=cd,
            packed_lstm=packed_lstm))
        processed, marks["processed memory"] = _timed(
            lambda: tm.processed_memory_of(model, memory, cd))
        dec, marks["decode (4 chunk calls)"] = _timed(
            lambda: ds.decode_autoregressive_fused(
                packed, memory, processed, mask, cfg,
                max_steps=UTTERANCE_STEPS))
        post, marks["postnet"] = _timed(lambda: dec[0] + tm.postnet_apply(
            model, dec[0], cfg, compute_dtype=cd))
        _, marks["HiFi-GAN V1 (fp32)"] = _timed(
            lambda: hifigan.generator(voc, post, hg))
    print(f"utterance breakdown [{card}] bf16 B=1 T_in=128 "
          f"{UTTERANCE_STEPS} steps, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in marks.items()))
    run = lambda: tm.infer_fused(model, text, lengths, cfg, packed=packed,
                                 packed_lstm=packed_lstm, max_steps=64,
                                 device=dev)
    run()
    torch.cuda.synchronize()
    print(f"utterance profile [{card}] bf16 B=1 T_in=128 64 steps: "
          + profile_kernels(run, top=10))


# ------------------------------------------------------------ training

# Training kernels against their plain versions on the same inputs: the
# largest |err| of each field as a share of the field's largest |value|.
# The two share every cast point and differ only in the order of fp32
# sums, which now and then flips the rounding of a bf16 operand. Each limit
# is about ten times the worst reading of its field on the H100 over the
# 64- and 512-step runs below (d_processed: 1.0e-3 of its largest value).
SCAN_FWD_REL = dict(ga=5e-2, gd=5e-2, att_h=6e-2, dec_h=5e-2, att_c=7e-3,
                    dec_c=2e-2, ctx=5e-2, w=5e-2)
SCAN_BWD_REL = dict(dga=7e-2, dgd=4e-2, d_prenet=3e-2, d_ctx=5e-2, d_q=5e-2,
                    d_processed=1e-2, d_k2=2e-2, d_v=7e-3)
ENC_BWD_REL = dict(dgf=5e-2, dgb=3e-2, dxf=9e-3, dxb=2e-2)
ENC_FWD_REL = dict(gf=5e-2, gb=5e-2, hf=6e-2, hb=5e-2, cf=2e-3, cb=2e-3)
# fp32 training step on the card against the same step on the CPU (plain
# versions): the loss, and each gradient's largest |err| as a share of its
# largest |value| (of 1e-3 where that is smaller: a conv bias before a
# batchnorm has a gradient that is zero up to rounding)
STEP_REL_FP32 = (1e-5, 1e-4)
# The same step with cuDNN's convolutions. cuDNN's fp32 conv output lies
# within 2.6e-6 of an fp64 witness where the CPU's lies within 3.5e-7, so
# now and then a relu input within rounding of zero takes the other sign:
# that position then passes its whole gradient on one side and none on the
# other. The gradients upstream of the encoder's relus are held by their
# root-sum-square gap as a share of their root-sum-square (of 1e-3 where
# that is smaller; worst reading 2.2e-3); every other gradient as the step
# above (worst reading 1.5e-5). Each conv's output and weight gradient, on
# the CPU step's operands, against fp64: limits ~10x the worst readings
# (2.5e-6, 4.4e-6).
KINKED = ("embedding.", "encoder.convolutions.")
STEP_RSS_FP32 = 2e-2
CONV_FP64 = {"fwd": 3e-5, "wgrad": 5e-5}
TRAIN_SHAPE = dict(B=128, T_in=128, T_out=512)  # bench.py's training shape


def check_fields(what, got, want, names, limits):
    """Every field within its limit; returns {field: (|err|, share)}."""
    errs = {n: field_err(a, b) for n, a, b in zip(names, got, want)}
    for name, (e, r) in errs.items():
        if r > limits[name]:
            fail(f"{what}: {name} max |err| {e}, {r:.3e} of the field's "
                 f"largest value, beyond {limits[name]}")
    return errs


def must_reject(what, got, want, names, limits):
    if all(field_err(a, b)[1] <= limits[n]
           for n, a, b in zip(names, got, want)):
        fail(f"the comparison passes a perturbed output ({what})")


def _scan_inputs(model, cfg, dev, B, T_in, steps, seed):
    """Packed bf16 weights of the model's decoder core, a seeded batch of
    attention inputs (ragged lengths), prenet outputs, keep masks and
    cotangents of the three outputs."""
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    sw = dv._pack(dv.core_weights(model), bf16)
    lengths = torch.randint(T_in // 2, T_in + 1, (B,), generator=g,
                            device=dev)
    lengths[0] = T_in
    mask = torch.arange(T_in, device=dev)[None] < lengths[:, None]
    memory = torch.randn(B, T_in, cfg.encoder_embedding_dim, generator=g,
                         device=dev) * 0.3
    processed = tm.processed_memory_of(model, memory, bf16)
    mem, proc, emask = db.attention_inputs(memory, processed, mask, bf16)
    prenet = (torch.rand(steps, B, cfg.prenet_dim, generator=g, device=dev)
              * 0.5).to(bf16)
    keep = ts.keep_masks(g, steps, B, cfg.attention_rnn_dim,
                         cfg.decoder_rnn_dim, cfg.p_attention_dropout,
                         cfg.p_decoder_dropout)
    kw = dict(keep=keep, p_att=cfg.p_attention_dropout,
              p_dec=cfg.p_decoder_dropout)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.01
    cots = (rnd(steps, B, cfg.decoder_rnn_dim),
            rnd(steps, B, cfg.encoder_embedding_dim),
            rnd(steps, B, T_in) * mask)
    return sw, (prenet, mem, proc, emask), kw, cots


def _scan_work(sw, B, T_in, steps, n_filters, keep):
    """(bytes, FLOPs) of the forward scan and of the backward chain: each
    input read once and each output written once, the products' FLOPs (2
    per multiply-add) with the location term as the model states it, conv
    then dense. The backward counts the two transposed LSTM products, the
    rebuilt query and energies, the query, context and location backward."""
    A, D = sw.wq.shape[0], sw.b2.shape[0] // 4
    K1, K2 = sw.w1.shape[1], sw.w2.shape[1]
    E = K2 - A - D
    P = K1 - E - A
    ks, _, datt = sw.k2.shape
    w = sw.wq.element_size()
    size = lambda *xs: sum(x.numel() * x.element_size() for x in xs)
    loc = T_in * (n_filters * 2 * ks + n_filters * datt)
    sb = steps * B
    per_batch = B * T_in * (E + datt) * w
    keep_b = sb * (A + D) if keep else 0
    res_b = sb * ((5 * A + 5 * D) * w + (A + D + E + T_in) * 4)
    fwd_b = (size(sw.w1, sw.b1, sw.w2, sw.b2, sw.wq, sw.k2, sw.v)
             + sb * P * w + per_batch + B * T_in * 4 + keep_b + res_b)
    fwd_macs = (K1 * 4 * A + K2 * 4 * D + A * datt + loc + T_in * datt
                + T_in * E)
    bwd_b = ((4 * A * K1 + 4 * D * K2 + 2 * A * datt) * w
             + size(sw.k2, sw.vf) + per_batch
             + res_b + sb * (D + E + T_in) * 4 + keep_b
             + sb * ((4 * A + 4 * D + E) * w + (P + datt) * 4)
             + B * T_in * datt * 4 + (ks * 2 * datt + datt) * 4)
    bwd_macs = (4 * D * K2 + 4 * A * K1 + 2 * A * datt + T_in * E
                + T_in * datt + 3 * loc)
    return (fwd_b, 2.0 * sb * fwd_macs), (bwd_b, 2.0 * sb * bwd_macs)


# The quality gate's shapes (B=32, text buckets 32 and 48, mel buckets of
# 128 and 256 frames): T_in 48 is no multiple of the 32-position attention
# tiles, so the backward's attn_tiles_kernel and the forward's energy grid
# take a ragged last tile.
GATE_SCAN_SHAPES = ((32, 32, 128, 25), (32, 48, 128, 26), (32, 48, 256, 27))


def scan_phase(model, cfg, dev, card):
    """Rows 1 and 2 at full width (bf16, dropout on): at B=128 field by
    field over 64 steps at T_in 128 (with perturbed outputs rejected), 64
    and 192; at the quality gate's B=32 x T_in 32 and 48 over 128 steps
    and at T_in 48 over 256 (each with perturbed outputs rejected and the
    backward bit-identical in two runs); then both at B=128 over the full
    512 steps at T_in 128, held and timed, the backward from the plain
    forward's residuals."""
    B0 = TRAIN_SHAPE["B"]
    fwd_names, bwd_names = ts.Residuals._fields, ts.ChainGrads._fields
    out = {}
    for B, T_in, steps, seed in (
            (B0, TRAIN_SHAPE["T_in"], 64, 21), (B0, 64, 64, 23),
            (B0, 192, 64, 24), *GATE_SCAN_SHAPES,
            (B0, TRAIN_SHAPE["T_in"], TRAIN_SHAPE["T_out"], 22)):
        sw, inp, kw, cots = _scan_inputs(model, cfg, dev, B, T_in, steps,
                                         seed)
        got = ts.forward_residuals(sw, *inp, **kw)
        want = ts.forward_residuals_plain(sw, *inp, **kw)
        torch.cuda.synchronize()
        what = f"B={B} T_in {T_in}, {steps} steps"
        ferr = check_fields(f"scan forward, {what}", got, want, fwd_names,
                            SCAN_FWD_REL)
        args = (sw, want, inp[1], inp[2], *cots)
        gk = ts.backward_chain(*args, **kw)
        gp = ts.backward_chain_plain(*args, **kw)
        torch.cuda.synchronize()
        berr = check_fields(f"scan backward, {what}", gk, gp, bwd_names,
                            SCAN_BWD_REL)
        for label, errs in (("forward", ferr), ("backward", berr)):
            print(f"train scan [{card}] {label} B={B} T_in={T_in} {steps} "
                  f"steps bf16: max |err| by field, as a share of the "
                  f"field's largest |value| (limit): " + ", ".join(
                      f"{k} {r:.2e} ({lim[k]})" for k, (_, r) in errs.items()
                      for lim in [SCAN_FWD_REL if label == "forward"
                                  else SCAN_BWD_REL]))
        if seed == 21 or B != B0:
            must_reject("attention w shifted one position",
                        got._replace(w=torch.roll(got.w, 1, dims=2)), want,
                        fwd_names, SCAN_FWD_REL)
            must_reject("d_processed x 1.05",
                        gk._replace(d_processed=gk.d_processed * 1.05), gp,
                        bwd_names, SCAN_BWD_REL)
            again = ts.backward_chain(*args, **kw)
            for name in ("d_k2", "d_v", "d_processed", "dga", "d_q"):
                if not torch.equal(getattr(again, name), getattr(gk, name)):
                    fail(f"scan backward: {name} differs between two runs")
            print(f"train scan [{card}] backward B={B} T_in={T_in} {steps} "
                  f"steps: d_k2, d_v, d_processed, dga and d_q bit-identical "
                  f"in two runs")
        if steps != TRAIN_SHAPE["T_out"]:
            continue
        fwd_ms = cuda_ms(lambda: ts.forward_residuals(sw, *inp, **kw),
                         iters=2, warmup=0)
        fwd_plain = cuda_ms(lambda: ts.forward_residuals_plain(sw, *inp, **kw),
                            iters=1, warmup=0)
        bwd_ms = cuda_ms(lambda: ts.backward_chain(*args, **kw), iters=2,
                         warmup=0)
        bwd_plain = cuda_ms(lambda: ts.backward_chain_plain(*args, **kw),
                            iters=1, warmup=0)
        (fb, ff), (bb, bf) = _scan_work(sw, B, T_in, steps,
                                        cfg.attention_location_n_filters,
                                        True)
        # what the backward must touch every step, whatever it keeps: both
        # LSTMs' weights, mem and proc read, d_processed read and written
        A, D = sw.wq.shape[0], sw.b2.shape[0] // 4
        E, datt = inp[1].shape[2], sw.k2.shape[2]
        step_b = (2 * (4 * A * sw.w1.shape[1] + 4 * D * sw.w2.shape[1])
                  + B * T_in * (2 * E + 2 * datt + 8 * datt))
        floor_ms = steps * step_b / HBM_BYTES_PER_S * 1e3
        # the forward's: both LSTMs' weights, mem and proc read, the step's
        # residual stacks written
        fwd_step_b = (2 * (4 * A * sw.w1.shape[1] + 4 * D * sw.w2.shape[1])
                      + B * T_in * (E + datt) * 2
                      + B * ((5 * A + 5 * D) * 2 + (A + D + E + T_in) * 4))
        floors = {"train_scan_fwd": (fwd_step_b, steps * fwd_step_b
                                     / HBM_BYTES_PER_S * 1e3),
                  "train_scan_bwd": (step_b, floor_ms)}
        for name, line, errs, ms, plain, (nb, nf) in (
                ("train_scan_fwd", 354, ferr, fwd_ms, fwd_plain, (fb, ff)),
                ("train_scan_bwd", 619, berr, bwd_ms, bwd_plain, (bb, bf))):
            bound_ms, bound_by = bound(nb, nf, "bfloat16")
            sb, fl = floors[name]
            extra = (f"; per-step floor {sb / 1e6:.1f} MB touched a step, "
                     f"{fl:.4f} ms at the HBM rate")
            print(f"train scan [{card}] {name} B={B} T_in={T_in} {steps} "
                  f"steps bf16 with dropout: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})"
                  + extra)
            out[name] = {
                "name": name, "route": "cuda",
                "source": "tacotron2_tpu_torch/kernels/csrc/train_scan.cu",
                "replaces": f"tacotron2_tpu/kernels/train_scan.py:{line}",
                "max_abs_err": max(e for e, _ in errs.values()),
                "tolerance": {"share_of_field_max": SCAN_FWD_REL
                              if name.endswith("fwd") else SCAN_BWD_REL},
                "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
        for name, (_, fl) in floors.items():
            out[name]["floor_ms"] = fl
        del got, want, gk, gp, args
    return out["train_scan_fwd"], out["train_scan_bwd"]


def encoder_train_phase(model, dev, card, enc):
    """Row 4 (bf16) at B=128 x T 128 and 192 and the quality gate's B=32 x
    T 32 and 48 against its plain version field by field (ENC_BWD_REL), one
    cluster launch for the chain, the same bits in two runs; timed at B=128,
    T=128 beside cuDNN's bidirectional LSTM backward. Row 3 at B=128 field
    by field (ENC_FWD_REL), re-timed beside cuDNN at T 128, 48 and 32, and
    at the quality gate's B=32 at T 48 and 32."""
    B, T = TRAIN_SHAPE["B"], TRAIN_SHAPE["T_in"]
    lstm = model.encoder.lstm
    N, H = lstm.input_size, lstm.hidden_size
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(23)
    xs = torch.relu(torch.randn(B, T, N, generator=g, device=dev))
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)
    lengths[0] = T
    xsr = _reverse_by_length(xs, lengths).to(bf16).contiguous()
    xs = xs.to(bf16).contiguous()
    packed = el.pack_bilstm(lstm_weights(lstm, "_l0"),
                            lstm_weights(lstm, "_l0_reverse"), bf16)
    fwd = el.bilstm_forward(*packed, xs, xsr)
    fwd_want = el.bilstm_forward_plain(*packed, xs, xsr)
    torch.cuda.synchronize()
    fwd_names = ("gf", "gb", "hf", "hb", "cf", "cb")
    fwd_errs = check_fields("encoder forward at B=128", fwd, fwd_want,
                            fwd_names, ENC_FWD_REL)
    must_reject("encoder forward c x 1.05",
                (*fwd[:4], fwd[4] * 1.05, fwd[5]), fwd_want, fwd_names,
                ENC_FWD_REL)
    del fwd_want
    fwd_ms = cuda_ms(lambda: el.bilstm_forward(*packed, xs, xsr), iters=5)
    fwd_plain = cuda_ms(lambda: el.bilstm_forward_plain(*packed, xs, xsr),
                        iters=1, warmup=0)
    wtf, wtb = (from_blocks(w).t().contiguous() for w in (packed.wf,
                                                          packed.wb))
    names = ("dgf", "dgb", "dxf", "dxb")

    def backward_case(Bc, Tc):
        """Row 4's inputs at (Bc, Tc): the forward kernel's stacks of
        seeded inputs, seeded cotangents of h."""
        gc = torch.Generator(device=dev).manual_seed(Bc * 1000 + Tc)
        x = torch.relu(torch.randn(Bc, Tc, N, generator=gc, device=dev))
        lc = torch.randint(Tc // 2, Tc + 1, (Bc,), generator=gc, device=dev)
        lc[0] = Tc
        xr = _reverse_by_length(x, lc).to(bf16).contiguous()
        gf, gb, _, _, cf, cb = el.bilstm_forward(
            *packed, x.to(bf16).contiguous(), xr)
        dhf, dhb = (torch.randn(Tc, Bc, H, generator=gc, device=dev) * 0.1
                    for _ in range(2))
        return (wtf, wtb, gf, gb, cf, cb, dhf, dhb)

    # row 4 at bench.py's shape, the longest bucket and the quality gate's
    # B=32 x T_in 32 and 48: one cluster launch for the chain, every field
    # within ENC_BWD_REL, the same bits in two runs, a perturbed dx rejected
    held = {}
    for Bc, Tc in ((B, T), (B, 192), (32, 32), (32, 48)):
        case = backward_case(Bc, Tc)
        plan = el.backward_plan(Bc, N, H, bf16, dev)
        launched = profiled_kernels(lambda: el.bilstm_backward(*case))
        if plan[0] != "cluster" or launched.count(
                "encoder_bwd_cluster_kernel") != 1 or \
                "lstm_gates_bwd_kernel" in launched:
            fail(f"encoder backward B={Bc} T={Tc}: plan {plan}, kernels "
                 f"{sorted(set(launched))}")
        got = el.bilstm_backward(*case)
        again = el.bilstm_backward(*case)
        want = el.bilstm_backward_plain(*case)
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, again):
            if not torch.equal(a, b):
                fail(f"encoder backward B={Bc} T={Tc}: {name} differs "
                     f"between two runs")
        errs_c = check_fields(f"encoder backward B={Bc} T={Tc}", got, want,
                              names, ENC_BWD_REL)
        must_reject("encoder backward dx x 1.05",
                    (*got[:2], got[2] * 1.05, got[3]), want, names,
                    ENC_BWD_REL)
        held[f"B={Bc} T={Tc}"] = dict(
            {k: r for k, (_, r) in errs_c.items()},
            ms=cuda_ms(lambda: el.bilstm_backward(*case), iters=5),
            clusters=plan[1], clusters_at_once=plan[2])
        if (Bc, Tc) == (B, T):
            args, errs = case, errs_c
            ms = held[f"B={Bc} T={Tc}"]["ms"]
        del case, got, again, want
    plain_ms = cuda_ms(lambda: el.bilstm_backward_plain(*args), iters=1,
                       warmup=0)
    print(f"encoder backward [{card}] bf16, one cluster launch for the "
          f"chain and one tensor-core dx product a direction, the same bits "
          f"in two runs; largest |err| by field as a share of its largest "
          f"|value| (limits {ENC_BWD_REL}) and ms: " + "; ".join(
              f"{k}: " + ", ".join(f"{n} {v:.2e}" if n in names else
                                   f"{n} {v}" if n != "ms" else
                                   f"{v:.4f} ms" for n, v in r.items())
              for k, r in held.items()))
    ref = _cudnn_bilstm(lstm, dev)
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: ref(xs), iters=10)
    xg = xs.detach().requires_grad_(True)
    out, _ = ref(xg)
    gout = torch.randn(out.shape, generator=g, device=dev).to(bf16)
    leaves = [xg, *ref.parameters()]
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                  retain_graph=True),
                      iters=10)
    if ms >= lib_bwd:
        print(f"encoder backward [{card}]: row 4 {ms:.4f} ms is not below "
              f"cuDNN's {lib_bwd:.4f} ms at B={B} T={T}")
    K = N + H
    wsz = 2
    nbytes = (2 * 4 * H * K * wsz + 2 * T * B * (4 * H * wsz + 2 * H * 4)
              + 2 * T * B * (4 * H * wsz + N * 4))
    flops = 2 * T * 2 * B * 4 * H * K
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    f_bytes, _, f_step = _encoder_work(B, T, N, H, wsz)
    f_bound, f_by = bound(f_bytes, flops, "bfloat16")
    f_floor = T * f_step / HBM_BYTES_PER_S * 1e3
    print(f"encoder backward [{card}] B={B} T={T} N={N} H={H} bf16: max |err|"
          f" by field as a share of its largest |value| (limit): " + ", ".join(
              f"{k} {r:.2e} ({ENC_BWD_REL[k]})" for k, (_, r) in errs.items())
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN "
          f"bidirectional LSTM backward (data and weights) {lib_bwd:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by})")
    print(f"encoder forward [{card}] B={B} T={T} bf16: max |err| by field as "
          f"a share of its largest |value| (limit): " + ", ".join(
              f"{k} {r:.2e} ({ENC_FWD_REL[k]})"
              for k, (_, r) in fwd_errs.items())
          + f"; kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, cuDNN "
          f"forward {lib_fwd:.4f} ms, bound {f_bound:.5f} ms ({f_by}), "
          f"per-step floor {f_floor:.4f} ms")
    shapes = encoder_shapes(packed, lstm, ref, dev, card,
                            [(128, 48), (128, 32), (32, 48), (32, 32)], 23)
    enc["at_training_shape"] = {
        "B": B, "T": T, "max_abs_err": max(e for e, _ in fwd_errs.values()),
        "tolerance": {"share_of_field_max": ENC_FWD_REL}, "ms": fwd_ms,
        "plain_ms": fwd_plain, "bound_ms": f_bound, "bound_by": f_by,
        "floor_ms": f_floor, "library_ms": lib_fwd, "shapes": shapes}
    return {"name": "encoder_lstm_bwd", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/encoder_lstm.cu",
            "replaces": "tacotron2_tpu/kernels/encoder_lstm.py:156",
            "max_abs_err": max(e for e, _ in errs.values()),
            "tolerance": {"share_of_field_max": ENC_BWD_REL},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_bwd, "shapes": held}


TRAIN_KERNELS = {"encoder_lstm_fwd": el.bilstm_forward,
                 "encoder_lstm_bwd": el.bilstm_backward,
                 "train_scan_fwd": ts.forward_residuals,
                 "train_scan_bwd": ts.backward_chain}
PLAIN_VERSIONS = (el.bilstm_forward_plain, el.bilstm_backward_plain,
                  ts.forward_residuals_plain, ts.backward_chain_plain,
                  db.decoder_chunk_plain)


class StageTimer:
    """CUDA events around calls of the named functions (module attributes
    or autograd Function backwards, patched for the duration): device
    stream time by stage of one training step."""

    def __init__(self, stages):
        self.stages, self.marks, self.saved = stages, {}, []

    def __enter__(self):
        for label, owner, attr in self.stages:
            orig = getattr(owner, attr)
            self.saved.append((owner, attr, owner.__dict__[attr]))

            @functools.wraps(orig)  # carries the launch count over
            def wrapper(*a, _orig=orig, _label=label, **k):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = _orig(*a, **k)
                e.record()
                self.marks.setdefault(_label, []).append((s, e))
                return out
            setattr(owner, attr, staticmethod(wrapper)
                    if isinstance(owner, type) else wrapper)
        return self

    def __exit__(self, *exc):
        for owner, attr, value in self.saved:
            setattr(owner, attr, value)

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.marks.items()}


def train_phase(cfg, dev, card, seed):
    """The training step at bench.py's shape (B=128, T_in=128, T_out=512,
    bf16, dropout on): ``create_train_state`` with seeded weights, one warm
    step, three timed steps through ``train_step``; every kernel of the
    path must launch and no plain version may run. Then one step timed by
    stage. Returns (the launch counts, ms a timed step)."""
    B, T_in, T_out = (TRAIN_SHAPE[k] for k in ("B", "T_in", "T_out"))
    state = tstate.create_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    batch = tstate.make_batch(cfg, B, T_in, T_out, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, m, _ = tstate.train_step(state, batch, cfg, gen)  # warm-up
    torch.cuda.synchronize()
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    plain0 = sum(f.calls for f in PLAIN_VERSIONS)
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    t0 = time.perf_counter()
    for _ in range(3):
        state, m, _ = tstate.train_step(state, batch, cfg, gen)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
    plain = sum(f.calls for f in PLAIN_VERSIONS) - plain0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, c in counts.items():
        if c == 0:
            fail(f"the training step never launched the {name} kernel")
    if plain:
        fail(f"the training step ran a plain version {plain} times")
    rows = [(float(m.loss), float(m.grad_norm), float(m.applied))
            for m in metrics]
    for loss, norm, applied in rows:
        if not (torch.isfinite(torch.tensor(loss)) and applied == 1.0):
            fail(f"training step: loss {loss}, applied {applied}")
    frames = B * T_out * 3 / wall
    print(f"training [{card}] bf16 B={B} T_in={T_in} T_out={T_out}, 3 steps "
          f"in {wall:.3f} s ({wall / 3 * 1e3:.1f} ms per step): {frames:.1f} "
          f"mel frames/s; loss, grad_norm, applied by step: "
          + "; ".join(f"{l:.5f}, {n:.4f}, {a:.0f}" for l, n, a in rows)
          + f"; peak memory {peak_gb:.2f} GB; launches {counts}")

    stages = [("step", tstate, "train_step"),
              ("encoder forward (convs, BN, row 3)", tm, "encode"),
              ("decoder forward kernel (row 1)", ts, "forward_residuals"),
              ("postnet forward", tm, "postnet_apply"),
              ("decoder backward (CoreScan.backward)", dv.CoreScan,
               "backward"),
              ("decoder backward chain kernel (row 2)", ts, "backward_chain"),
              ("encoder BiLSTM backward (BiLSTMScans.backward)",
               el.BiLSTMScans, "backward"),
              ("encoder backward chain kernel (row 4)", el,
               "bilstm_backward"),
              ("optimizer (guarded_update)", tstate, "guarded_update")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageTimer(stages) as timer:
        state, m, _ = tstate.train_step(state, batch, cfg, gen)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ms = timer.ms()
    dec_bwd, enc_bwd = ms[stages[4][0]], ms[stages[6][0]]
    parts = {
        "encoder forward": ms[stages[1][0]],
        "decoder forward kernel (row 1)": ms[stages[2][0]],
        "postnet forward": ms[stages[3][0]],
        "decoder backward chain (row 2)": ms[stages[5][0]],
        "decoder dW and d_memory products": dec_bwd - ms[stages[5][0]],
        "encoder backward chain (row 4)": ms[stages[7][0]],
        "encoder BiLSTM dW products": enc_bwd - ms[stages[7][0]],
        "optimizer": ms[stages[8][0]],
    }
    parts["rest (prenet, heads, loss, autograd of convs and dense)"] = (
        ms["step"] - sum(v for k, v in parts.items()
                         if k not in ("decoder backward chain (row 2)",
                                      "encoder backward chain (row 4)"))
        - ms[stages[5][0]] - ms[stages[7][0]])
    print(f"training breakdown [{card}] one step, stream ms by stage "
          f"(CUDA events; host clock {host_ms:.1f} ms, events {ms['step']:.1f}"
          f" ms): " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(f"training profile [{card}] one step: " + profile_kernels(
        lambda: tstate.train_step(state, batch, cfg, gen), top=16))
    return counts, wall / 3 * 1e3


# The bf16 training step with row 3 against the same step with row 3's plain
# version swapped in (same state, batch and dropout draws; the rest of the
# step unchanged): the loss's gap as a share of the loss, and each encoder
# gradient's largest |gap| as a share of its largest |value| (_grad_gaps).
# The two share every cast point and differ only in the order of row 3's
# fp32 sums, which now and then flips the bf16 rounding of a gate or an h.
# Limits: the fp32 step check's (STEP_REL_FP32) scaled by 2^8 for bf16, the
# share by which one rounding step moves a bf16 value.
SWAP_REL_BF16 = tuple(x * 2 ** 8 for x in STEP_REL_FP32)
ENCODER_PARAMS = ("embedding.", "encoder.")


def encoder_swap_phase(cfg, dev, card, seed):
    """``loss_and_grads`` at bench.py's shape (bf16) four times on one
    state and batch, each with its own generator of the same seed: twice
    with the kernels (their gap is the rest of the step's run-to-run
    noise), once with ``bilstm_forward_plain`` in row 3's place and once
    with ``bilstm_backward_plain`` in row 4's. Each swapped step against
    the kernels' step within SWAP_REL_BF16, limits set before the run.
    Returns {"row 3": ..., "row 4": ...}."""
    B, T_in, T_out = (TRAIN_SHAPE[k] for k in ("B", "T_in", "T_out"))
    state = tstate.create_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    batch = tstate.make_batch(cfg, B, T_in, T_out, seed=seed, device=dev)

    def step():
        gen = torch.Generator(device=dev).manual_seed(seed)
        loss, grads, _, _ = tstate.loss_and_grads(state, batch, cfg, gen)
        torch.cuda.synchronize()
        return float(loss.total), {k: g.cpu() for k, g in grads.items()
                                   if k.startswith(ENCODER_PARAMS)}

    launches = (el.bilstm_forward.launches, el.bilstm_backward.launches)
    l_kernel, g_kernel = step()
    l_again, g_again = step()
    if (el.bilstm_forward.launches, el.bilstm_backward.launches) != \
            (launches[0] + 2, launches[1] + 2):
        fail("the training step did not launch rows 3 and 4's kernels")
    noise = _grad_gaps(g_again, g_kernel)
    nname, worst_noise = next(iter(noise.items()))
    out, bad = {}, []
    for row, attr in (("row 3", "bilstm_forward"),
                      ("row 4", "bilstm_backward")):
        kernel, plain = getattr(el, attr), getattr(el, attr + "_plain")
        calls = plain.calls
        setattr(el, attr, plain)
        try:
            l_plain, g_plain = step()
        finally:
            setattr(el, attr, kernel)
        if plain.calls != calls + 1:
            fail(f"the swapped step did not run {row}'s plain version")
        loss_gap = abs(l_kernel - l_plain) / abs(l_plain)
        gaps = _grad_gaps(g_kernel, g_plain)
        name, worst_gap = next(iter(gaps.items()))
        rss = float((g_kernel[name] - g_plain[name]).norm()
                    / g_plain[name].norm())
        print(f"{row} in the training step [{card}] bf16 B={B} T_in={T_in} "
              f"T_out={T_out}: loss {l_kernel:.6f} with the kernels, "
              f"{l_plain:.6f} with {attr}_plain (share {loss_gap:.2e}, "
              f"limit {SWAP_REL_BF16[0]:.2e}); {len(gaps)} encoder "
              f"gradients, worst {name} {worst_gap:.2e} of its largest value "
              f"(limit {SWAP_REL_BF16[1]:.2e}; its root-sum-square share "
              f"{rss:.2e}, not held); the kernels' step run twice: loss "
              f"share {abs(l_again - l_kernel) / abs(l_kernel):.2e}, worst "
              f"gradient {nname} {worst_noise:.2e}")
        out[row] = {"loss_share": loss_gap, "worst_gradient": name,
                    "worst_gradient_share": worst_gap, "its_rss_share": rss,
                    "limits": list(SWAP_REL_BF16)}
        if loss_gap > SWAP_REL_BF16[0]:
            bad.append(f"loss {l_kernel} with {row}'s kernel, {l_plain} "
                       f"with its plain version")
        if worst_gap > SWAP_REL_BF16[1]:
            bad.append(f"gradient of {name} with {row}'s kernel off by "
                       f"{worst_gap:.3e} of its largest value from the "
                       f"plain version's")
    out["kernels_twice"] = {"loss_share": abs(l_again - l_kernel)
                            / abs(l_kernel), "worst_gradient_share":
                            worst_noise}
    if bad:
        fail("training step: " + "; ".join(bad))
    return out


def _grad_gaps(got, want):
    """{parameter: its gradient's largest |err| as a share of the largest
    |value|, or of 1e-3 where that is smaller}, largest first."""
    gaps = {k: float((got[k].cpu() - want[k]).abs().max())
            / max(float(want[k].abs().max()), 1e-3) for k in want}
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


class ConvTaps:
    """While active, keeps the input, weight, output (before the bias) and
    output's gradient of every encoder and postnet convolution
    (``models.tacotron2.conv1d``) by its weight's parameter name."""

    def __init__(self, model):
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.x, self.w, self.y, self.dy = {}, {}, {}, {}

    def __enter__(self):
        self.orig = tm.conv1d

        def conv(x, weight, bias=None, compute_dtype=None):
            y = self.orig(x, weight, None, compute_dtype)
            name = self.names.get(id(weight))
            if name is not None and y.requires_grad:
                self.x[name], self.w[name] = x.detach(), weight.detach()
                self.y[name] = y.detach()
                y.register_hook(lambda g, n=name: self.dy.__setitem__(
                    n, g.detach()))
            return y if bias is None else y + bias
        tm.conv1d = conv
        return self

    def __exit__(self, *exc):
        tm.conv1d = self.orig


def conv_out(x, w):
    """A SAME conv of x (B, T, C_in) with w (C_out, C_in, k) in x's dtype."""
    return torch.nn.functional.conv1d(
        x.transpose(1, 2), w, padding=(w.shape[2] - 1) // 2).transpose(1, 2)


def conv_weight_grad(x, dy, k):
    """The gradient of a SAME conv's weight (C_out, C_in, k) from its input
    x (B, T, C_in) and its output's gradient dy (B, T, C_out)."""
    return torch.nn.grad.conv1d_weight(
        x.transpose(1, 2), (dy.shape[2], x.shape[2], k), dy.transpose(1, 2),
        padding=(k - 1) // 2)


def step_check_phase(cfg, dev, card, seed):
    """One fp32 training step at full width (B=16, T_in=128, T_out=64):
    the kernels on the card against the plain versions on the CPU, the loss
    and every parameter gradient, with the card's convolutions in
    PyTorch's own CUDA convolution. Then the same step with cuDNN's
    convolutions (``cudnn_step_check``), and every encoder and postnet
    convolution against an fp64 witness (``conv_witness``)."""
    cfg32 = cfg.replace(compute_dtype="float32")

    def step(device):
        state = tstate.create_train_state(
            cfg32, generator=torch.Generator().manual_seed(seed),
            device=device)
        batch = tstate.make_batch(cfg32, 16, 128, 64, seed=seed,
                                  device=device)
        with ConvTaps(state.model) as taps:
            loss, grads, _, _ = tstate.loss_and_grads(state, batch, cfg32)
        return float(loss.total), grads, taps

    lc, gc, taps_c = step(torch.device("cpu"))
    _, gd, taps_d = step(dev)
    with torch.backends.cudnn.flags(enabled=False):
        lg, gg, _ = step(dev)
    loss_err = abs(lg - lc) / abs(lc)
    worst_name, worst_rel = next(iter(_grad_gaps(gg, gc).items()))
    if loss_err > STEP_REL_FP32[0]:
        fail(f"fp32 training step: loss {lg} on the card, {lc} on the CPU")
    if worst_rel > STEP_REL_FP32[1]:
        fail(f"fp32 training step: gradient of {worst_name} off by "
             f"{worst_rel:.3e} of its largest value")
    print(f"fp32 training step [{card}] B=16 T_in=128 T_out=64, PyTorch's "
          f"CUDA convolutions: card against the CPU plain versions, loss "
          f"{lg:.6f} (share {loss_err:.2e}, limit {STEP_REL_FP32[0]}), "
          f"{len(gc)} gradients, worst {worst_name} {worst_rel:.2e} of its "
          f"largest value (limit {STEP_REL_FP32[1]})")
    cudnn_step_check(card, gc, gd)
    conv_witness(card, dev, gc, gd, taps_c, taps_d)


def cudnn_step_check(card, gc, gd):
    """The fp32 step with cuDNN's convolutions against the CPU step: the
    gradients upstream of the encoder's relus (KINKED) by root-sum-square
    share, every other one by largest |err| share."""
    rss = {k: float((gd[k].cpu() - gc[k]).norm())
           / max(float(gc[k].norm()), 1e-3)
           for k in gc if k.startswith(KINKED)}
    rest = {k: v for k, v in _grad_gaps(gd, gc).items()
            if not k.startswith(KINKED)}
    worst_rss = max(rss, key=rss.get)
    worst_rest = next(iter(rest))
    if rss[worst_rss] > STEP_RSS_FP32:
        fail(f"fp32 training step with cuDNN: gradient of {worst_rss} off by "
             f"{rss[worst_rss]:.3e} of its root-sum-square")
    if rest[worst_rest] > STEP_REL_FP32[1]:
        fail(f"fp32 training step with cuDNN: gradient of {worst_rest} off "
             f"by {rest[worst_rest]:.3e} of its largest value")
    worst_max = next(iter(_grad_gaps(gd, gc).items()))
    print(f"fp32 training step [{card}] with cuDNN's convolutions: against "
          f"the CPU step, upstream of the encoder's relus the worst "
          f"root-sum-square share is {worst_rss} {rss[worst_rss]:.2e} (limit "
          f"{STEP_RSS_FP32}; the worst largest |err| share there, "
          f"{worst_max[0]} {worst_max[1]:.2e}, is not held), the other "
          f"{len(rest)} gradients' worst largest |err| share {worst_rest} "
          f"{rest[worst_rest]:.2e} (limit {STEP_REL_FP32[1]})")


def conv_witness(card, dev, gc, gd, taps_c, taps_d):
    """The convolutions of the fp32 step against an fp64 witness on the CPU
    step's own operands, each gap as a share of the witness's largest
    |value|: the output (``fwd``) and the weight gradient (``wgrad``) of
    the CPU step, and of cuDNN and PyTorch's own CUDA convolution on the
    same operands, each within CONV_FP64 (cuDNN with TF32 on is printed for
    scale, not held). Then how the cuDNN step departs from the CPU step:
    encoder relu inputs whose sign differs (a fresh state's batchnorm is
    the identity affine, so the sign is that of the output less its batch
    mean), the output gradient's largest gap and the weight gradient's
    largest and root-sum-square gaps."""
    for name, x in taps_c.x.items():
        w, y, dy = taps_c.w[name], taps_c.y[name], taps_c.dy[name]
        k = w.shape[2]
        fwd64 = conv_out(x.double(), w.double())
        wgrad64 = conv_weight_grad(x.double(), dy.double(), k)
        gap = lambda a, ref: float((a.double().cpu() - ref).abs().max()
                                   / ref.abs().max())
        r = {"fwd cpu": gap(y, fwd64), "wgrad cpu": gap(gc[name], wgrad64)}
        xd, wd, dyd = x.to(dev), w.to(dev), dy.to(dev)
        # cudnn.flags sets every flag it has: allow_tf32 is always given
        for label, kw in (("cudnn", dict(enabled=True)),
                          ("native", dict(enabled=False)),
                          ("cudnn tf32", dict(enabled=True, allow_tf32=True))):
            with torch.backends.cudnn.flags(**{"allow_tf32": False, **kw}):
                r[f"fwd {label}"] = gap(conv_out(xd, wd), fwd64)
                r[f"wgrad {label}"] = gap(conv_weight_grad(xd, dyd, k),
                                          wgrad64)
        for key, v in r.items():
            if "tf32" not in key and v > CONV_FP64[key.split()[0]]:
                fail(f"{name}: {key} is {v:.3e} from the fp64 witness, "
                     f"beyond {CONV_FP64[key.split()[0]]}")
        s = {"dy": gap(taps_d.dy[name], dy.double()),
             "wgrad": gap(gd[name], gc[name].double()),
             "wgrad root-sum-square": float((gd[name].cpu() - gc[name])
                                            .norm() / gc[name].norm())}
        if name.startswith("encoder."):
            centred = lambda t: (t - t.mean(dim=(0, 1))).cpu() > 0
            s["relu signs that differ"] = int(
                (centred(taps_d.y[name]) != centred(y)).sum())
        print(f"conv witness [{card}] fp32 {name}: gap to fp64 on the CPU "
              f"step's operands (limits {CONV_FP64}): " + ", ".join(
                  f"{k} {v:.2e}" for k, v in r.items())
              + "; cuDNN step against CPU step: " + ", ".join(
                  f"{k} {v}" if isinstance(v, int) else f"{k} {v:.2e}"
                  for k, v in s.items()))


BUILD = Path(__file__).resolve().parent / "build"


def _state_tensors(state):
    """Copies of every tensor of a train state by name: parameters,
    batchnorm statistics, Adam moments, the step, the Adam count and the
    learning rate."""
    out = {f"param/{k}": v.detach().clone()
           for k, v in state.model.named_parameters()}
    for group in ("stats", "exp_avg", "exp_avg_sq"):
        out.update({f"{group}/{k}": v.clone()
                    for k, v in getattr(state, group).items()})
    out.update(step=state.step.clone(), adam_count=state.adam_count.clone(),
               learning_rate=state.learning_rate.clone())
    return out


def _largest_gap(a, b):
    """(name, largest |a - b|) over two states' tensors; (None, 0.0) when
    they are equal bit for bit."""
    worst = (None, 0.0)
    for k in a:
        if not torch.equal(a[k], b[k]):
            gap = float((a[k].double() - b[k].double()).abs().max())
            if worst[0] is None or gap > worst[1]:
                worst = (k, gap)
    return worst


def gate_input_check(model, cfg, dev, card, text):
    """Rows 3 and 6 on a trained model's weights at the quality gate's
    input (B=1, T_in = len(text), shorter than the location conv), each
    against its plain version on the same inputs with a perturbed output
    rejected: row 3 field by field (ENC_FWD_REL); row 6 over three 64-step
    chunks field by field (STEP_REL) with a gate that never latches, then
    one chunk again with a threshold between the two versions' logits at a
    step where both exceed every logit before it in the chunk, so that the
    chunk latches there in both."""
    bf16 = torch.bfloat16
    seq = torch.tensor([text_to_sequence(text, cfg.text_cleaners)],
                       device=dev)
    T = seq.shape[1]
    lengths = torch.tensor([T], device=dev)
    with torch.no_grad():
        x = model.embedding.weight[seq.long()]
        for i, conv in enumerate(model.encoder.convolutions):
            x = torch.relu(tm._conv_bn_apply(
                conv, f"encoder.convolutions.{i}.1", x, None, {}, False,
                bf16))
    lstm = model.encoder.lstm
    packed = el.pack_bilstm(lstm_weights(lstm, "_l0"),
                            lstm_weights(lstm, "_l0_reverse"), bf16)
    xs = x.to(bf16).contiguous()
    xsr = _reverse_by_length(x, lengths).to(bf16).contiguous()
    fwd = el.bilstm_forward(*packed, xs, xsr)
    fwd_want = el.bilstm_forward_plain(*packed, xs, xsr)
    torch.cuda.synchronize()
    fwd_names = ("gf", "gb", "hf", "hb", "cf", "cb")
    enc_errs = check_fields(f"encoder forward at B=1, T={T}, trained", fwd,
                            fwd_want, fwd_names, ENC_FWD_REL)
    must_reject(f"encoder forward at T={T}, c x 1.05",
                (*fwd[:4], fwd[4] * 1.05, fwd[5]), fwd_want, fwd_names,
                ENC_FWD_REL)

    limits = STEP_REL[bf16]
    cs = 64
    memory = tm.encode(model, seq, lengths, cfg, compute_dtype=bf16)
    processed = tm.processed_memory_of(model, memory, bf16)
    mask = torch.ones(1, T, dtype=torch.bool, device=dev)
    fp = ds.pack_decoder_params(model, bf16)
    inputs = ds.attention_inputs(memory, processed, mask)
    carry = db.ChunkCarry(*(torch.zeros(1, k, device=dev) for k in (
        cfg.attention_rnn_dim, cfg.attention_rnn_dim, cfg.decoder_rnn_dim,
        cfg.decoder_rnn_dim, T, T, cfg.encoder_embedding_dim,
        cfg.n_mel_channels * cfg.n_frames_per_step)),
        *(torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)))

    def both(carry, t0, gate_logit):
        kw = dict(t0=t0, chunk_steps=cs, gate_logit=gate_logit)
        got = ds.decoder_step_chunk(fp, carry, *inputs, **kw)
        want = ds.decoder_step_chunk_plain(fp, carry, *inputs, **kw)
        torch.cuda.synchronize()
        return got, want

    def held(what, got, want, upto):
        """Every field within STEP_REL, the gate over steps [0, upto); the
        latch and the length equal."""
        fields = {}
        for name, a, b in _chunk_fields(got, want):
            if name == "gate":
                if not torch.equal(a[upto:], b[upto:]):
                    fail(f"row 6 {what}: the masked gate differs after "
                         f"step {upto}")
                a, b = a[:upto], b[:upto]
            fields[name] = field_err(a, b)
            if fields[name][1] > limits[name]:
                fail(f"row 6 {what} disagrees with its plain version on "
                     f"{name}: max |err| {fields[name][0]}, "
                     f"{fields[name][1]:.3e} of the field's largest value, "
                     f"beyond {limits[name]}")
        for name in ("fin", "lens"):
            if not torch.equal(getattr(got.carry, name),
                               getattr(want.carry, name)):
                fail(f"row 6 {what}: {name} differs from the plain version")
        _check_catches(got, want, limits)
        return fields

    # Three chunks with a gate that never latches, each from the plain
    # version's carry, held field by field. The latch goes where both
    # versions' logits clear every earlier logit of either in the chunk,
    # at the widest margin, in the first chunk that has such a step s >= 1
    # (a trained gate's logits may fall from step 0 on); none: step 0.
    free, chunks = {}, []
    for c in range(3):
        got, want = both(carry, c * cs, 1e30)
        for k, v in held(f"T_in={T}, trained, chunk {c}, gate never "
                         f"latching", got, want, cs).items():
            free[k] = max(free.get(k, v), v, key=lambda x: x[1])
        chunks.append((carry, got.gate[:, 0].double().cpu(),
                       want.gate[:, 0].double().cpu()))
        carry = want.carry
    pick = None
    for c, (carry, gk, gp) in enumerate(chunks):
        for t in range(1, cs):
            below = float(max(gk[:t].max(), gp[:t].max()))
            above = float(min(gk[t], gp[t]))
            if above > below and (pick is None or above - below > pick[2]):
                pick = (c, t, above - below, (above + below) / 2)
        if pick is not None:
            break
    if pick is None:
        gk, gp = chunks[0][1:]
        pick = (0, 0, None, float(min(gk[0], gp[0])) - 1.0)
    c, s, margin, thr = pick
    got, want = both(chunks[c][0], c * cs, thr)
    if int(got.carry.fin) != 1 or int(got.carry.lens) != c * cs + s + 1:
        fail(f"row 6 at T_in={T} with the gate logit {thr}: latched "
             f"{int(got.carry.fin)} at length {int(got.carry.lens)}, "
             f"expected at step {c * cs + s}")
    latched = held(f"T_in={T}, trained, latching at step {c * cs + s}", got,
                   want, s + 1)
    print(f"trainer [{card}] rows 3 and 6 on the trained weights at "
          f"{text!r} (B=1, T_in={T}) against their plain versions, max "
          f"|err| as a share of the field's largest |value| (limit): row 3 "
          + ", ".join(f"{k} {r:.2e} ({ENC_FWD_REL[k]})"
                      for k, (_, r) in enc_errs.items())
          + f"; row 6, {3 * cs} steps in chunks of {cs}, gate never "
          "latching: " + ", ".join(f"{k} {r:.2e} ({limits[k]})"
                                   for k, (_, r) in free.items())
          + f"; the chunk from step {c * cs} latching at step {c * cs + s} "
          f"(logit threshold {thr:.4f}, margin "
          f"{margin if margin is None else f'{margin:.4f}'}): "
          + ", ".join(f"{k} {r:.2e}" for k, (_, r) in latched.items())
          + "; latch and length equal, perturbed outputs rejected")


def _resident_ms(state, batch, cfg, gen, steps=5):
    """Host ms a step of ``train_step`` on a batch already on the card:
    one warm step, then ``steps`` ending in a synchronise."""
    state, _, _ = tstate.train_step(state, batch, cfg, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _, _ = tstate.train_step(state, batch, cfg, gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, state


def trainer_phase(dev, card, seed):
    """Training from a filelist through the user's entry points, at full
    width (the tone demo's config: bf16, every dropout on, text buckets 32
    and 48): a 128-utterance tone corpus, ``Trainer.fit`` for 3 epochs with
    a checkpoint and a validation every 8 steps. The train pipeline keeps
    partial buckets (drop_last=False) so that the 48 bucket, 2 of the 128
    utterances, trains too. Rows 1-4 must launch and no plain version run;
    both text buckets must be met. A new Trainer resumed from the last
    checkpoint holds the same state bit for bit, and two more steps of it
    equal two more steps of the first. ``synthesize`` from the restored
    model through both decoders (row 6 for fused=True). Times: the fit's
    host interval a step beside ``train_step`` on a resident batch of each
    shape, the step loop's wait on prefetch, the idle share of a profiled
    window of ``fit``."""
    from tacotron2_tpu_torch.data import DataPipeline, TextMelDataset
    from tacotron2_tpu_torch.tools import train_demo
    from tacotron2_tpu_torch.training.trainer import Trainer

    BUILD.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="trainer_phase_", dir=BUILD))
    try:
        cfg = train_demo.demo_config(
            hparams=f"seed={seed},iters_per_checkpoint=8,log_interval=4")
        filelist = train_demo.build_corpus(str(root / "corpus"), 128)
        common = dict(process_index=0, process_count=1)
        train = DataPipeline(TextMelDataset(filelist, cfg), cfg,
                             drop_last=False, **common)
        val = DataPipeline(TextMelDataset(filelist, cfg, shuffle=False), cfg,
                           drop_last=False, **common)
        out = str(root / "run")
        trainer = Trainer(cfg, out, device=dev)
        for fn in TRAIN_KERNELS.values():
            fn.launches = 0
        plain0 = sum(f.calls for f in PLAIN_VERSIONS)
        trainer.fit(train, val, epochs=3)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
        plain = sum(f.calls for f in PLAIN_VERSIONS) - plain0
        fit = trainer.last_fit
        steps = int(trainer.state.step)
        for name, c in counts.items():
            if c == 0:
                fail(f"Trainer.fit never launched the {name} kernel")
        if plain:
            fail(f"Trainer.fit ran a plain version {plain} times")
        if steps != 3 * train.steps_per_epoch() or fit.steps != steps:
            fail(f"Trainer.fit ran {steps} steps, not 3 epochs of "
                 f"{train.steps_per_epoch()}")
        met = sorted(trainer.shapes_met)
        if {t for k, t, _ in met if k == "train"} != set(cfg.text_buckets):
            fail(f"Trainer.fit met the shapes {met}: not both text buckets")
        with open(Path(out) / "logs" / "metrics.jsonl") as f:
            logged = [json.loads(line) for line in f]
        val_losses = [r["validation/loss"] for r in logged
                      if "validation/loss" in r]
        ckpts = trainer.checkpointer.all_checkpoints()
        if not val_losses or len(ckpts) < 2:
            fail(f"Trainer.fit: {len(val_losses)} validations, checkpoints "
                 f"{ckpts}")
        losses = [r["training/loss"] for r in logged if "training/loss" in r]
        if not all(math.isfinite(x) for x in losses + val_losses):
            fail(f"Trainer.fit: losses {losses}, validation {val_losses}")
        print(f"trainer [{card}] Trainer.fit 3 epochs, {steps} steps, bf16 "
              f"B=32 full width, dropout on: shapes (kind, T_in, T_out) "
              f"{met}; launches {counts}; training losses {losses}; "
              f"validation losses {val_losses}; checkpoints "
              f"{[Path(p).name for p in ckpts]}")

        # resume: the same state, and two more steps the same
        last = trainer.checkpointer.latest()
        before = _state_tensors(trainer.state)
        resumed = Trainer(cfg, out, checkpoint_path=last, device=dev)
        name, gap = _largest_gap(_state_tensors(resumed.state), before)
        if name is not None:
            fail(f"resumed state differs from the saved one: {name} by {gap}")
        trainer.fit(train, None, epochs=1 << 30, max_steps=steps + 2)
        resumed.fit(train, None, epochs=1 << 30, max_steps=steps + 2)
        name, gap = _largest_gap(_state_tensors(resumed.state),
                                 _state_tensors(trainer.state))
        if name is None:
            verdict = "equal bit for bit"
        else:
            again = Trainer(cfg, str(root / "again"), checkpoint_path=last,
                            device=dev)
            again.fit(train, None, epochs=1 << 30, max_steps=steps + 2)
            n2, noise = _largest_gap(_state_tensors(again.state),
                                     _state_tensors(resumed.state))
            verdict = (f"NOT equal bit for bit: largest gap {gap} at {name}; "
                       f"the same two steps from the same checkpoint twice "
                       f"differ by {noise} at {n2}")
            # a resume fault (other dropout draws or batches, moments not
            # restored) moves the state by far more than the card's own
            # run-to-run noise
            if n2 is None or gap > 2 * noise:
                fail(f"resume: two more steps {verdict} (limit: twice the "
                     f"same-checkpoint gap)")
        print(f"trainer [{card}] resumed from {Path(last).name}: state equal "
              f"bit for bit; two more steps of the resumed Trainer against "
              f"two more of the first: {verdict}")

        # synthesis from the restored model, through both decoders
        inf_cfg = cfg.replace(prenet_dropout_at_inference=False)
        for fused, must in ((False, ("encoder_lstm_fwd",)),
                            (True, ("encoder_lstm_fwd",
                                    "decoder_step_chunk"))):
            (res,), n = _counted(
                f"synthesize(fused={fused}) from the restored model",
                lambda fused=fused: tinfer.synthesize(
                    resumed.state.model, ["we like jax"], inf_cfg,
                    vocoder="none", fused=fused, max_steps=256, device=dev),
                must)
            if (res.mel.ndim != 2 or res.mel.shape[1] != cfg.n_mel_channels
                    or not res.mel.shape[0] or not np.isfinite(res.mel).all()):
                fail(f"synthesize(fused={fused}): mel {res.mel.shape}")
            print(f"trainer [{card}] synthesize(fused={fused}) from the "
                  f"restored model: mel {tuple(res.mel.shape)}, finite; "
                  f"launches {n}")
        gate_input_check(resumed.state.model, inf_cfg, dev, card,
                         "we like jax")

        # where the fit's time goes
        by_shape = {}
        for dt, shape in zip(fit.step_intervals_s, fit.interval_shapes):
            by_shape.setdefault(shape, []).append(dt * 1e3)
        resident = {}
        state = trainer.state  # done with: its steps time the shapes
        for shape in sorted(by_shape):
            batch = next(b for b in train.epoch(0)
                         if (b.text.shape[1], b.mel.shape[1]) == shape)
            batch = tstate.Batch(*(t.to(dev) for t in batch))
            resident[shape], state = _resident_ms(
                state, batch, cfg, torch.Generator(device=dev).manual_seed(1))
        print(f"trainer [{card}] fit: wall {fit.wall_s:.3f} s for {fit.steps} "
              f"steps (validation and checkpoints included); the step loop "
              f"waited {fit.prefetch_wait_s * 1e3:.1f} ms on prefetch; median "
              f"host interval a step {np.median(fit.step_intervals_s) * 1e3:.2f}"
              f" ms; by shape (T_in, T_out): median fit interval / "
              f"train_step on a resident batch, ms: " + "; ".join(
                  f"{s} {np.median(v):.2f} / {resident[s]:.2f} ({len(v)} "
                  f"intervals)" for s, v in sorted(by_shape.items())))
        # a window of fit's steps between checkpoints: the profiler starts
        # as the first step returns and stops as the seventh does
        n0 = cfg.iters_per_checkpoint * (int(resumed.state.step)
                                         // cfg.iters_per_checkpoint + 1)
        resumed.fit(train, None, epochs=1 << 30, max_steps=n0)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

        def window(step, _):
            if step == n0 + 1:
                prof.start()
            elif step == n0 + 7:
                torch.cuda.synchronize()
                prof.stop()
        resumed.fit(train, None, epochs=1 << 30, max_steps=n0 + 7,
                    on_step=window)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            fail("the profiler saw no device activity in Trainer.fit")
        print(f"trainer profile [{card}] Trainer.fit, 6 steps between "
              f"checkpoints: " + summarize_kernels(events, top=8))
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------- vocoders and the front doors

REPO = Path(__file__).resolve().parent
# WaveGlow: WN.end starts at zero (every coupling the identity), so the
# phase perturbs it (perturb_waveglow). Limits: each field's largest |err|
# as a share of its largest |value|.
WG_END_STD = 1e-2
WG_CPU_REL = dict(z=8e-6, log_s=2e-6, log_det=1e-6, audio=6e-6)
WG_ROUND_TRIP_REL = 4e-5
# The server's mels against its BatchingSynthesizer called directly: a row
# batched with other rows, or padded to another bucket, may take the
# kernel's rounding otherwise (DEC_REL's mel at bf16).
SERVE_MEL_REL = DEC_REL[torch.bfloat16]["mel"]


def perturb_waveglow(model, g):
    """WN.end from N(0, WG_END_STD^2), so that the couplings act, and each
    row of every 1x1 weight scaled by U(0.8, 1.25), so that log |det W| is
    not 0 (the init's rotations give 0 up to rounding, against which a
    share of the largest value means nothing)."""
    with torch.no_grad():
        for w in model.WN:
            w.end.weight.normal_(0, WG_END_STD, generator=g)
        for inv in model.convinv:
            w = inv.conv.weight
            w.mul_(torch.empty(w.shape[0], 1, 1).uniform_(0.8, 1.25,
                                                          generator=g))


def _waveglow_flops(wcfg, B, t_mel):
    """Multiply-adds x 2 of one WaveGlow pass over B x t_mel frames: the
    transposed conv, and per flow the 1x1 weight, start, the fused cond
    conv, every in and res/skip layer and end."""
    from tacotron2_tpu_torch.models import waveglow
    t_g = t_mel * wcfg.upsample_stride // wcfg.n_group
    n, L, k = wcfg.wn_channels, wcfg.wn_layers, wcfg.wn_kernel_size
    mel = wcfg.n_mel_channels
    macs = B * t_mel * wcfg.upsample_stride * mel * mel * (
        wcfg.upsample_kernel // wcfg.upsample_stride)
    for i in range(wcfg.n_flows):
        c = waveglow.remaining_channels(wcfg, i)
        half = c // 2
        per_group = (c * c + half * n + mel * wcfg.n_group * 2 * n * L
                     + L * n * 2 * n * k + (L - 1) * n * 2 * n + n * n
                     + n * 2 * (c - half))
        macs += B * t_g * per_group
    return 2 * macs


def _tone(n_samples, freq=220.0, sr=22050):
    t = torch.arange(n_samples) / sr
    return 0.3 * torch.sin(2 * math.pi * freq * t)[None]


def _wg_fields(out, audio):
    return (out.z, out.log_s_total, out.log_det_total, audio)


def waveglow_phase(cfg, dev, card, seed):
    """WaveGlow at the published widths (12 flows, 8 WN layers of 256
    channels, ~88M parameters), seeded weights perturbed
    (``perturb_waveglow``), fp32: the card against the CPU at 16 frames (the
    same weights and z), the flow's round trip on the card, then
    ``synthesize(vocoder="waveglow")`` on the 200-step utterance with and
    without the ``Denoiser``; times, peak memory, and the vocoder alone
    with cuDNN's TF32 off (this script's setting) and on (PyTorch's
    default, which the CLI and the server run with). Returns the model."""
    from tacotron2_tpu_torch.models import waveglow
    wcfg = waveglow.WaveGlowConfig(n_mel_channels=cfg.n_mel_channels,
                                   upsample_stride=cfg.hop_length)
    model = waveglow.WaveGlow(wcfg, torch.Generator().manual_seed(seed + 2))
    perturb_waveglow(model, torch.Generator().manual_seed(seed + 3))
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator().manual_seed(seed + 4)
    mel = torch.randn(1, 16, wcfg.n_mel_channels, generator=g) * 2 - 5
    audio = _tone(16 * wcfg.hop_length)
    z = torch.randn(1, wcfg.n_group, 16 * wcfg.hop_length // wcfg.n_group,
                    generator=g) * 0.666
    names = ("z", "log_s", "log_det", "audio")
    runs = {}
    for key, where in (("cpu", "cpu"), ("card", dev)):
        model = model.to(where)
        with torch.no_grad():
            out = waveglow.forward(model, audio.to(where), mel.to(where),
                                   wcfg)
        back = waveglow.infer(model, mel.to(where), wcfg, z=z.to(where))
        runs[key] = [t.cpu() for t in _wg_fields(out, back)]
    errs = check_fields("WaveGlow card against CPU", runs["card"],
                        runs["cpu"], names, WG_CPU_REL)
    bad = list(runs["card"])
    bad[0] = bad[0] + 10 * WG_CPU_REL["z"] * bad[0].abs().max()
    must_reject("WaveGlow z", bad, runs["cpu"], names, WG_CPU_REL)

    # the round trip: forward, then the inverse with that z, on the card
    trips = {}
    for frames in (16, UTTERANCE_STEPS):
        a = _tone(frames * wcfg.hop_length, 330.0).to(dev)
        m = torch.randn(1, frames, wcfg.n_mel_channels, generator=g
                        ).to(dev) * 2 - 5
        with torch.no_grad():
            zz = waveglow.forward(model, a, m, wcfg).z
        back = waveglow.infer(model, m, wcfg, z=zz)
        trips[frames] = field_err(back, a)[1]
        if trips[frames] > WG_ROUND_TRIP_REL:
            fail(f"WaveGlow round trip at {frames} frames: {trips[frames]} "
                 f"of the audio's largest value, beyond {WG_ROUND_TRIP_REL}")
        bad = back.clone()
        bad[0, 100] += 10 * WG_ROUND_TRIP_REL
        if field_err(bad, a)[1] <= WG_ROUND_TRIP_REL:
            fail("the round trip's comparison passes a perturbed output")
    print(f"waveglow [{card}] {n_params / 1e6:.1f}M parameters, fp32, "
          f"cuDNN TF32 off: card against the CPU at 16 frames, max |err| as "
          f"a share of the largest value (limits {WG_CPU_REL}): " + ", ".join(
              f"{k} {e[1]:.2e}" for k, e in errs.items())
          + "; round trip on the card (limit " f"{WG_ROUND_TRIP_REL}): "
          + ", ".join(f"{k} frames {v:.2e}" for k, v in trips.items())
          + "; perturbed outputs rejected")

    # synthesize on the 200-step utterance, with and without the Denoiser
    tts = tm.Tacotron2(cfg, torch.Generator().manual_seed(seed)).to(dev)
    denoiser = tinfer.Denoiser(model, wcfg)
    synth = lambda **kw: tinfer.synthesize(
        tts, [UTTERANCE], cfg, vocoder="waveglow", vocoder_model=model,
        vocoder_cfg=wcfg, max_steps=UTTERANCE_STEPS, fused=True, device=dev,
        **kw)[0]
    lat, peak, res = {}, {}, {}
    for name, kw in (("waveglow", {}), ("waveglow+denoiser",
                                        {"denoiser": denoiser})):
        synth(**kw)  # warm-up: cuDNN's algorithm search
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(3):
            res[name], ms = _timed(lambda: synth(**kw))
            times.append(ms)
        lat[name] = times
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        _check_result(f"synthesize({name})", res[name], cfg,
                      UTTERANCE_STEPS)
        n = res[name].mel.shape[0]
        if res[name].audio.shape[0] != n * cfg.hop_length or \
                float(np.sqrt(np.mean(res[name].audio ** 2))) <= 0:
            fail(f"synthesize({name}): {n} frames, audio "
                 f"{res[name].audio.shape}")
        bad = res[name]._replace(audio=res[name].audio.copy())
        bad.audio[7] = np.nan
        try:
            _check_result("perturbed", bad, cfg, UTTERANCE_STEPS)
        except RuntimeError:
            pass
        else:
            fail(f"synthesize({name})'s check passes a non-finite sample")
    if np.array_equal(res["waveglow"].audio, res["waveglow+denoiser"].audio):
        fail("the Denoiser changed nothing")

    # the vocoder alone on the utterance's mel: TF32 off and on
    mel200 = torch.from_numpy(res["waveglow"].mel)[None].to(dev)
    alone = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            out = waveglow.infer(model, mel200, wcfg)
            alone[tf32] = (cuda_ms(lambda: waveglow.infer(model, mel200,
                                                          wcfg), 5), out)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    tf32_gap = field_err(alone[True][1], alone[False][1])[1]
    flops = _waveglow_flops(wcfg, 1, mel200.shape[1])
    print(f"waveglow [{card}] synthesize(fused=True, bf16 Tacotron 2, "
          f"max_steps={UTTERANCE_STEPS}, {res['waveglow'].mel.shape[0]} "
          f"frames) with WaveGlow at sigma 0.666, host ms per call (3 warm "
          f"calls): " + "; ".join(
              f"{k} {', '.join(f'{t:.1f}' for t in v)} (peak "
              f"{peak[k]:.2f} GiB)" for k, v in lat.items())
          + f". WaveGlow alone on those frames ({flops / 1e12:.3f} TFLOP): "
          f"cuDNN TF32 off {alone[False][0]:.2f} ms "
          f"({flops / alone[False][0] / 1e9:.1f} TFLOP/s), on "
          f"{alone[True][0]:.2f} ms ({flops / alone[True][0] / 1e9:.1f} "
          f"TFLOP/s); the TF32 audio departs from the fp32 audio by "
          f"{tf32_gap:.2e} of its largest value")
    return model


def _changed(before, module):
    """Parameters of ``module`` that differ from ``before`` (a dict of
    copies), and their count."""
    return sum(not torch.equal(before[k], p)
               for k, p in module.named_parameters())


def _copies(module):
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def vocoder_train_phase(cfg, dev, card, seed, root):
    """Both vocoder trainers at full width on a 32-utterance tone corpus
    (the trainer phase's kind), with the JAX tools' defaults: 3 WaveGlow
    steps at B=8 on 64-mel segments, 3 HiFi-GAN V1 steps at B=16 on 32-mel
    segments. Every step gives finite losses and changes every network
    (HiFi-GAN: the generator and both discriminators); each trainer
    writes a checkpoint. Returns (filelist, waveglow path, hifigan path)."""
    from tacotron2_tpu_torch.audio.mel import MelConfig
    from tacotron2_tpu_torch.data import TextMelDataset
    from tacotron2_tpu_torch.models import waveglow
    from tacotron2_tpu_torch.tools import train_demo
    from tacotron2_tpu_torch.training import hifigan_trainer as ht
    from tacotron2_tpu_torch.training import vocoder_trainer as vt
    from tacotron2_tpu_torch.training.checkpoint import Checkpointer

    filelist = train_demo.build_corpus(str(root / "corpus"), 32, seed=seed)
    ds = TextMelDataset(filelist, cfg)
    mel_cfg = MelConfig.from_config(cfg)
    put = lambda b: vt.VocoderBatch(*(t.to(dev) for t in b))
    paths = {}

    wcfg = waveglow.WaveGlowConfig(n_mel_channels=cfg.n_mel_channels,
                                   upsample_stride=cfg.hop_length)
    state = vt.create_vocoder_state(
        wcfg, generator=torch.Generator().manual_seed(seed), device=dev)
    batches = vt.segment_sampler(ds, mel_cfg, 64, 8, seed)
    torch.cuda.reset_peak_memory_stats(dev)
    wg_log = []
    start = _copies(state.model)
    for _ in range(3):
        batch = put(next(batches))
        before = _copies(state.model)
        (state, loss), ms = _timed(lambda: vt.vocoder_train_step(
            state, batch, wcfg))
        n = _changed(before, state.model)
        if not math.isfinite(float(loss)) or not n:
            fail(f"WaveGlow step {state.step}: loss {float(loss)}, "
                 f"{n} parameters changed")
        wg_log.append((float(loss), ms, n))
    # the first step moves only WN.end and the 1x1 weights (WN.end starts
    # at zero, so nothing before it has a gradient yet); three move all
    n_all = _changed(start, state.model)
    if n_all != len(start):
        fail(f"3 WaveGlow steps changed {n_all} of {len(start)} parameters")
    wg_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    paths["waveglow"] = Checkpointer(str(root / "waveglow")).save(
        state, wait=True)
    flops = 3 * _waveglow_flops(wcfg, 8, 64)
    del state

    hcfg = hifigan.HiFiGANConfig(n_mel_channels=cfg.n_mel_channels)
    state = ht.create_hifigan_state(
        hcfg, generator=torch.Generator().manual_seed(seed), device=dev)
    batches = vt.segment_sampler(ds, mel_cfg, 32, 16, seed)
    torch.cuda.reset_peak_memory_stats(dev)
    hg_log = []
    for _ in range(3):
        batch = put(next(batches))
        before = [_copies(m) for m in (state.generator, state.mpd,
                                       state.msd)]
        (state, losses), ms = _timed(lambda: ht.hifigan_train_step(
            state, batch, hcfg, mel_cfg))
        changed = [_changed(b, m) for b, m in zip(
            before, (state.generator, state.mpd, state.msd))]
        if not all(math.isfinite(float(x)) for x in losses) or \
                not all(changed):  # the generator and both discriminators
            fail(f"HiFi-GAN step {state.step}: losses {losses}, parameters "
                 f"changed (generator, MPD, MSD) {changed}")
        hg_log.append(([round(float(x), 4) for x in losses], ms))
    hg_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    paths["hifigan"] = Checkpointer(str(root / "hifigan")).save(
        state, wait=True)
    del state
    print(f"vocoder training [{card}] fp32, cuDNN TF32 off. WaveGlow B=8 x "
          f"64 mels ({flops / 1e12:.2f} TFLOP a step by the forward count "
          f"x 3): (nll, host ms, parameters changed of {len(start)}) "
          + ", ".join(f"({x:.4f}, {t:.1f}, {n})" for x, t, n in wg_log)
          + f", all changed after 3; peak {wg_peak:.2f} GiB. HiFi-GAN V1 "
          f"B=16 x 32 mels: ((disc, "
          f"adv, feature, mel L1), host ms) "
          + ", ".join(f"({x}, {t:.1f})" for x, t in hg_log)
          + f", peak {hg_peak:.2f} GiB; every step changed each network; "
          f"checkpoints {[Path(p).name for p in paths.values()]}")
    return filelist, paths["waveglow"], paths["hifigan"]


CLI_COUNTED = ("import json, runpy, sys\n"
               "from tacotron2_tpu_torch.kernels import decoder_step, "
               "encoder_lstm, int8_matmul\n"
               "runpy.run_module('tacotron2_tpu_torch.infer', "
               "run_name='__main__', alter_sys=True)\n"
               "i8 = sys.modules['tacotron2_tpu_torch.kernels.int8_matmul']\n"
               "print('LAUNCHES ' + json.dumps({\n"
               "    'encoder_lstm_fwd': encoder_lstm.bilstm_forward.launches,"
               "\n    'decoder_step_chunk': "
               "decoder_step.decoder_step_chunk.launches,\n"
               "    'int8_matmul': i8.int8_matmul.launches}))\n")


def _run_cli(argv, counted, timeout=300):
    """``python -m tacotron2_tpu_torch.infer argv`` in a process of its own
    from the repository's root; ``counted`` runs the module the same way
    (runpy, as -m does) behind a line that prints its launch counts."""
    if counted:
        _, launches, wall = _run_counted(CLI_COUNTED, argv, "the infer CLI",
                                         timeout)
        return wall, launches
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tacotron2_tpu_torch.infer",
                          *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"the infer CLI exited {out.returncode}: {out.stderr[-3000:]}")
    return wall, None


def _check_cli_outputs(prefix, n_texts, cfg, vocoder):
    """Each text's mel (n_mels, T) and WAV: the rate, T hops of samples
    (Griffin-Lim: T - 1 for the batch's longest row, whose inverse STFT
    drops the centring pad, as the JAX package's does), finite, RMS above
    0. Returns the frame counts."""
    import scipy.io.wavfile
    frames = []
    for i in range(n_texts):
        mel = np.load(f"{prefix}_{i}_mel.npy")
        if mel.shape[0] != cfg.n_mel_channels or not np.isfinite(mel).all():
            fail(f"{prefix}_{i}_mel.npy: {mel.shape}")
        n = mel.shape[1]
        sr, wav = scipy.io.wavfile.read(f"{prefix}_{i}.wav")
        hops = (n - 1, n) if vocoder == "griffin_lim" else (n,)
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
        if sr != cfg.sampling_rate or wav.ndim != 1 or not rms > 0 or \
                wav.shape[0] not in [h * cfg.hop_length for h in hops]:
            fail(f"{prefix}_{i}.wav: rate {sr}, {wav.shape} samples for {n} "
                 f"frames, rms {rms}")
        frames.append(n)
    return frames


HTTP_KERNELS = ("encoder_cluster_kernel", "persistent_chunk_kernel")


def _post(url, payload, timeout=300):
    """The response of a JSON POST; a server error fails with its body."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        fail(f"{url} {payload}: HTTP {e.code} {e.read()[:2000]!r}")


def _post_json(url, payload):
    with _post(url, payload) as r:
        return json.load(r)


def _serve(srv):
    import threading
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{srv.server_address[1]}", thread


def _shutdown(srv, thread):
    srv.shutdown()
    srv.server_close()
    srv.RequestHandlerClass.synthesizer.close()
    thread.join(timeout=60)


def entry_points_phase(cfg, dev, card, seed, root, wg_path, hg_path):
    """The front doors at full width: a checkpoint of a seeded model, the
    infer CLI in processes of its own (Griffin-Lim on two texts by
    ``python -m``; HiFi-GAN with --fused and WaveGlow with --int8 from the
    vocoder trainers' checkpoints, run as -m runs it behind a launch-count
    line), every WAV checked; then ``make_server`` on 127.0.0.1, port 0,
    driven by urllib: /healthz, 8 concurrent /synthesize mels (held
    against the server's ``BatchingSynthesizer`` called directly), a WAV
    for Griffin-Lim and WaveGlow, /stream as NDJSON, and from a HiFi-GAN
    server a WAV and /stream as PCM. Rows 3, 5 and 6 counted by their
    wrappers and by torch.profiler while the servers serve. Returns the
    (CLI, server) launch counts."""
    import concurrent.futures
    import urllib.request
    from tacotron2_tpu_torch import http_server
    from tacotron2_tpu_torch.training.checkpoint import Checkpointer

    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(seed),
                         trainable=True).to(dev)
    ckpt = Checkpointer(str(root / "tacotron2")).save(
        tstate.state_for(model, cfg), wait=True)
    out = root / "cli"
    out.mkdir()
    common = ["-c", ckpt, "--hparams", f"max_decoder_steps="
              f"{UTTERANCE_STEPS}"]
    runs = (("griffin_lim", False, [UTTERANCE, SHORT_TEXTS[1]], []),
            ("hifigan", True, [UTTERANCE], ["--vocoder_checkpoint", hg_path,
                                            "--fused"]),
            ("waveglow", True, [UTTERANCE], ["--vocoder_checkpoint", wg_path,
                                             "--int8"]))
    cli = {}
    for vocoder, counted, texts, extra in runs:
        prefix = str(out / vocoder)
        argv = common + ["-o", prefix, "--vocoder", vocoder, *extra]
        for t in texts:
            argv += ["-t", t]
        wall, launches = _run_cli(argv, counted)
        frames = _check_cli_outputs(prefix, len(texts), cfg, vocoder)
        cli[vocoder] = (wall, frames, launches, extra[2:])
    must = {"hifigan": ("encoder_lstm_fwd", "decoder_step_chunk"),
            "waveglow": ("encoder_lstm_fwd", "int8_matmul")}
    for vocoder, names in must.items():
        for name in names:
            if not cli[vocoder][2][name]:
                fail(f"infer CLI ({vocoder}, {cli[vocoder][3]}) never "
                     f"launched the {name} kernel: {cli[vocoder][2]}")
    print(f"infer CLI [{card}] python -m tacotron2_tpu_torch.infer, default "
          f"config (bf16), max_decoder_steps={UTTERANCE_STEPS}, PyTorch's "
          f"default TF32 settings: " + "; ".join(
              f"--vocoder {v} {' '.join(f)}: {w:.1f} s wall, frames {n}, "
              f"launches {c}" for v, (w, n, c, f) in cli.items())
          + "; every WAV at the rate, frames x hop long (Griffin-Lim's "
          "longest row one hop less), finite, RMS above 0")

    serve_cfg = cfg.replace(max_decoder_steps=UTTERANCE_STEPS)
    served = tinfer.load_model(ckpt, cfg, device=dev)
    wg_model, wg_cfg = tinfer.load_vocoder("waveglow", wg_path, cfg,
                                           device=dev)
    hg_model, hg_cfg = tinfer.load_vocoder("hifigan", hg_path, cfg,
                                           device=dev)
    srv = http_server.make_server(served, serve_cfg, port=0, max_batch=8,
                                  vocoder_kind="waveglow", vocoder=wg_model,
                                  vocoder_cfg=wg_cfg, device=dev)
    url, thread = _serve(srv)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            if json.load(r) != {"status": "ok"}:
                fail("/healthz")
        with _post(url + "/synthesize", {"text": SHORT_TEXTS[0]}) as r:
            r.read()  # warm-up
        texts = SHORT_TEXTS[:8]

        def serve_all():
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                futs = [pool.submit(_post_json, url + "/synthesize",
                                    {"text": t}) for t in texts]
                bodies = [f.result() for f in futs]
            t_mel = time.perf_counter() - t0
            wavs = {}
            for v in ("waveglow", "griffin_lim"):
                t1 = time.perf_counter()
                with _post(url + "/synthesize", {"text": UTTERANCE,
                                                 "vocoder": v}) as r:
                    wavs[v] = (r.headers["Content-Type"], r.read(),
                               time.perf_counter() - t1)
            t2 = time.perf_counter()
            with _post(url + "/stream", {"text": UTTERANCE}) as r:
                kind = r.headers["Content-Type"]
                first = r.readline()
                t_first = time.perf_counter() - t2
                lines = [first] + r.read().splitlines()
            t_stream = time.perf_counter() - t2
            return bodies, t_mel, wavs, kind, lines, t_first, t_stream

        serve_all()  # warm-up: each vocoder's and the streamer's shapes
        for fn in UTTERANCE_KERNELS.values():
            fn.launches = 0
        plain0 = sum(f.calls for f in UTTERANCE_PLAIN)
        holder = []
        names = profiled_kernels(lambda: holder.append(serve_all()))
        bodies, t_mel, wavs, kind, lines, t_first, t_stream = holder[0]
        counts = {k: UTTERANCE_KERNELS[k].launches for k in
                  ("encoder_lstm_fwd", "decoder_chunk", "decoder_step_chunk")}
        if sum(f.calls for f in UTTERANCE_PLAIN) != plain0:
            fail("the server ran a plain version on the card")
        for name, c in counts.items():
            if not c:
                fail(f"the server never launched the {name} kernel")
        prof = {k: sum(n == k for n in names) for k in HTTP_KERNELS}
        if not all(prof.values()):
            fail(f"torch.profiler saw the server launch {prof}")
        direct = srv.RequestHandlerClass.synthesizer.synthesize(texts)
        worst = 0.0
        for text, body, (mel, _, n) in zip(texts, bodies, direct):
            got = torch.tensor(body["mel"])
            if body["n_frames"] != n or tuple(got.shape) != mel.shape:
                fail(f"/synthesize {text!r}: {body['n_frames']} frames, "
                     f"BatchingSynthesizer {n}")
            worst = max(worst, field_err(got, torch.from_numpy(mel))[1])
        if worst > SERVE_MEL_REL:
            fail(f"/synthesize mels depart from BatchingSynthesizer's by "
                 f"{worst} of their largest value (limit {SERVE_MEL_REL})")
        for v, (ctype, body, _) in wavs.items():
            if ctype != "audio/wav" or body[:4] != b"RIFF":
                fail(f"/synthesize {v}: {ctype}")
        events = [json.loads(x) for x in lines if x.strip()]
        n_stream = sum(e["n_frames"] for e in events)
        if kind != "application/x-ndjson" or not events[-1]["done"] or \
                not n_stream or not all(np.isfinite(e["mel"]).all()
                                        for e in events):
            fail(f"/stream NDJSON: {kind}, {len(events)} events")
    finally:
        _shutdown(srv, thread)

    srv = http_server.make_server(served, serve_cfg, port=0, max_batch=8,
                                  vocoder_kind="hifigan", vocoder=hg_model,
                                  vocoder_cfg=hg_cfg, chunk_steps=32,
                                  device=dev)
    url, thread = _serve(srv)
    try:
        with _post(url + "/synthesize", {"text": UTTERANCE}) as r:
            n_frames = json.load(r)["n_frames"]
        for path, payload in (("/synthesize", {"text": UTTERANCE,
                                               "vocoder": "hifigan"}),
                              ("/stream", {"text": UTTERANCE})):
            with _post(url + path, payload) as r:  # warm-up
                r.read()
        for fn in UTTERANCE_KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with _post(url + "/synthesize", {"text": UTTERANCE,
                                         "vocoder": "hifigan"}) as r:
            hg_wav = (r.headers["Content-Type"], r.read())
        t_hg = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _post(url + "/stream", {"text": UTTERANCE}) as r:
            pcm_kind = r.headers["Content-Type"]
            first = r.read(2 * hg_cfg.hop_length)
            t_pcm_first = time.perf_counter() - t0
            pcm = first + r.read()
        t_pcm = time.perf_counter() - t0
        counts["decoder_step_chunk"] += \
            UTTERANCE_KERNELS["decoder_step_chunk"].launches
        counts["encoder_lstm_fwd"] += \
            UTTERANCE_KERNELS["encoder_lstm_fwd"].launches
        counts["decoder_chunk"] += UTTERANCE_KERNELS["decoder_chunk"].launches
        # the same work on the server's own objects, without HTTP: the
        # batcher from this thread; HiFi-GAN on this (warm) thread and on a
        # fresh one, where PyTorch builds cuDNN's plans again; the runner
        # (its own long-lived thread) called from a fresh thread, as a
        # request's handler calls it
        import threading
        handler = srv.RequestHandlerClass
        (mel, _, _), t_submit = _timed(
            lambda: handler.synthesizer.submit(UTTERANCE).result())
        mel_t = torch.from_numpy(mel)[None].to(dev)
        vocode = lambda: hifigan.generator(hg_model, mel_t, hg_cfg).cpu()
        vocode()
        _, t_voc = _timed(vocode)

        def on_fresh_thread(fn):
            worker = threading.Thread(target=fn)
            t0 = time.perf_counter()
            worker.start()
            worker.join()
            return (time.perf_counter() - t0) * 1e3
        t_voc_thread = on_fresh_thread(vocode)
        t_runner_thread = on_fresh_thread(
            lambda: handler.vocoder_runner(mel))
    finally:
        _shutdown(srv, thread)
    mel_json = {"mel": direct[0][0].tolist()}
    t0 = time.perf_counter()
    body = json.dumps(mel_json).encode()
    t_dumps = time.perf_counter() - t0
    json.loads(body)
    t_json = (time.perf_counter() - t0) * 1e3
    samples = np.frombuffer(pcm, "<i2")
    if hg_wav[0] != "audio/wav" or hg_wav[1][:4] != b"RIFF":
        fail(f"/synthesize hifigan: {hg_wav[0]}")
    if not pcm_kind.startswith("audio/L16") or \
            samples.shape[0] != n_frames * hg_cfg.hop_length or \
            not np.abs(samples).max() > 0:
        fail(f"/stream PCM: {pcm_kind}, {samples.shape[0]} samples for "
             f"{n_frames} frames")
    print(f"http server [{card}] make_server on 127.0.0.1 (bf16, max_batch "
          f"8, max_decoder_steps {UTTERANCE_STEPS}; cuDNN TF32 off in this "
          f"process): 8 concurrent /synthesize mels in {t_mel * 1e3:.1f} ms, "
          f"against BatchingSynthesizer worst {worst:.2e} of the largest "
          f"value (limit {SERVE_MEL_REL}); WAV " + ", ".join(
              f"{v} {len(b) - 44} bytes in {t * 1e3:.1f} ms"
              for v, (_, b, t) in wavs.items())
          + f"; /stream NDJSON {len(events)} events, {n_stream} frames, "
          f"first line after {t_first * 1e3:.1f} ms, all after "
          f"{t_stream * 1e3:.1f} ms; HiFi-GAN WAV in {t_hg * 1e3:.1f} ms; "
          f"/stream PCM {samples.shape[0]} samples = {n_frames} frames x hop, "
          f"first bytes after {t_pcm_first * 1e3:.1f} ms, all after "
          f"{t_pcm * 1e3:.1f} ms (each after a warm-up request); without "
          f"HTTP: BatchingSynthesizer.submit(...).result() {t_submit:.1f} "
          f"ms; HiFi-GAN on the mel {t_voc:.1f} ms on this thread, "
          f"{t_voc_thread:.1f} ms on a fresh thread; the VocoderRunner from "
          f"a fresh thread {t_runner_thread:.1f} ms; one "
          f"{direct[0][0].shape[0]}-frame mel's JSON encoded and decoded on "
          f"the host in {t_json:.1f} ms ({t_dumps * 1e3:.1f} ms to encode); "
          f"launches (wrappers, both servers) {counts}; "
          f"torch.profiler kernels while the first served {prof}")
    cli_counts = {k: sum((c[2] or {}).get(k, 0) for c in cli.values())
                  for k in ("encoder_lstm_fwd", "decoder_step_chunk",
                            "int8_matmul")}
    return cli_counts, counts


AUDIO_BATCH_SHAPE = dict(B=32, T_in=32, T_out=256)  # the tone demo's
# Row 8's targets against the torch.matmul form, as a share of the largest
# linear mel value: tones leave bins near the 1e-5 floor, where the log
# turns the two fp32 forms' ~1e-7 of the frame's peak into ~1e-3.
AUDIO_MEL_REL = 3e-5


def _linear_share(a, b):
    """max |exp(a) - exp(b)| / max |exp(b)| of two log-mel tensors."""
    ea, eb = a.double().exp(), b.double().exp()
    return float((ea - eb).abs().max() / eb.abs().max())


def audio_batch_phase(dev, card, seed, filelist):
    """Training from raw audio at the tone demo's shape (B=32, T_in 32,
    T_out 256, bf16, dropout on): the targets with the fused mel kernel
    (row 8) against the two ``torch.matmul`` products, then 3
    ``train_step_from_audio`` steps, each with a finite loss and applied;
    row 8 launches once a step, rows 1-4 launch, and no plain version
    runs."""
    import scipy.io.wavfile
    from tacotron2_tpu_torch.data.dataset import load_filelist
    from tacotron2_tpu_torch.tools import train_demo
    from tacotron2_tpu_torch.training import audio_batch as ab

    cfg = train_demo.demo_config(hparams=f"seed={seed}")
    B, t_text, t_mel = (AUDIO_BATCH_SHAPE[k] for k in ("B", "T_in", "T_out"))
    items = []
    entries = load_filelist(filelist)
    for i in range(B):
        path, text = entries[i % len(entries)][:2]
        _, wav = scipy.io.wavfile.read(path)
        items.append((np.asarray(text_to_sequence(text, cfg.text_cleaners)),
                      wav.astype(np.float32) / 32768.0))
    batch = ab.AudioBatch(*(t.to(dev) for t in ab.pad_audio_batch(
        items, t_text, t_mel, cfg.hop_length)))
    fused = ab.mel_targets_from_audio(batch, cfg, backend="cuda")
    plain = ab.mel_targets_from_audio(batch, cfg, backend="torch")
    if not torch.equal(fused.gate_target, plain.gate_target) \
            or not torch.equal(fused.mel_lengths, plain.mel_lengths):
        fail("mel_targets_from_audio: cuda and torch give other gates or "
             "lengths")
    share = _linear_share(fused.mel, plain.mel)
    log_err = (fused.mel - plain.mel).abs()
    at = int(log_err.argmax())
    log_at = (float(log_err.flatten()[at]), float(plain.mel.flatten()[at]))
    if share > AUDIO_MEL_REL:
        fail(f"mel_targets_from_audio: cuda against torch {share} of the "
             f"largest linear mel value, beyond {AUDIO_MEL_REL}")
    bad = fused.mel.clone()
    peak = np.unravel_index(int(plain.mel.argmax()), tuple(plain.mel.shape))
    bad[peak] += math.log1p(10 * AUDIO_MEL_REL)
    if _linear_share(bad, plain.mel) <= AUDIO_MEL_REL:
        fail("the targets' comparison passes a perturbed mel")
    state = tstate.create_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, _, _ = ab.train_step_from_audio(state, batch, cfg, gen)  # warm-up
    kernels = {**TRAIN_KERNELS,
               "mel_spectrogram_fused": mk.mel_spectrogram_fused}
    plains = PLAIN_VERSIONS + (mk.mel_spectrogram_fused_plain,)
    for fn in kernels.values():
        fn.launches = 0
    plain0 = sum(f.calls for f in plains)
    log = []
    for _ in range(3):
        (state, m, _), ms = _timed(lambda: ab.train_step_from_audio(
            state, batch, cfg, gen))
        if not math.isfinite(float(m.loss)) or float(m.applied) != 1.0:
            fail(f"train_step_from_audio: loss {float(m.loss)}, applied "
                 f"{float(m.applied)}")
        log.append((float(m.loss), ms))
    counts = {k: fn.launches for k, fn in kernels.items()}
    if sum(f.calls for f in plains) != plain0:
        fail("train_step_from_audio ran a plain version on the card")
    if counts["mel_spectrogram_fused"] != 3 or not all(counts.values()):
        fail(f"train_step_from_audio launches over 3 steps: {counts}")
    print(f"audio batches [{card}] B={B} T_in {t_text} T_out {t_mel} bf16, "
          f"dropout on: targets cuda against torch {share:.2e} of the "
          f"largest linear mel value (limit {AUDIO_MEL_REL}); in the log "
          f"domain max |err| {log_at[0]:.2e}, at a log mel of "
          f"{log_at[1]:.2f}; gates and lengths equal, perturbed mel "
          f"rejected; 3 train_step_from_audio (loss, host ms): "
          + ", ".join(f"({x:.4f}, {t:.1f})" for x, t in log)
          + f"; launches {counts}")
    return counts



# ------------------------------------------------------- the scripts

def _rows_1_4_counted(module):
    """Python source that runs ``module`` as ``-m`` runs it (runpy), then
    prints a ``LAUNCHES`` line: rows 1-4's launches and the calls of their
    plain versions (``plain``)."""
    return (
        "import json, runpy\n"
        "from tacotron2_tpu_torch.kernels import encoder_lstm, train_scan\n"
        f"runpy.run_module({module!r}, run_name='__main__', "
        "alter_sys=True)\n"
        "print('LAUNCHES ' + json.dumps({\n"
        "    'encoder_lstm_fwd': encoder_lstm.bilstm_forward.launches,\n"
        "    'encoder_lstm_bwd': encoder_lstm.bilstm_backward.launches,\n"
        "    'train_scan_fwd': train_scan.forward_residuals.launches,\n"
        "    'train_scan_bwd': train_scan.backward_chain.launches,\n"
        "    'plain': sum(f.calls for f in (\n"
        "        encoder_lstm.bilstm_forward_plain,\n"
        "        encoder_lstm.bilstm_backward_plain,\n"
        "        train_scan.forward_residuals_plain,\n"
        "        train_scan.backward_chain_plain))}))\n")


CACHE_COUNTED = (
    "import json, runpy\n"
    "from tacotron2_tpu_torch.kernels import mel_kernel\n"
    "runpy.run_module('tacotron2_tpu_torch.tools.cache_mels', "
    "run_name='__main__', alter_sys=True)\n"
    "print('LAUNCHES ' + json.dumps({\n"
    "    'mel_spectrogram_fused': mel_kernel.mel_spectrogram_fused.launches,\n"
    "    'plain': mel_kernel.mel_spectrogram_fused_plain.calls}))\n")
# bench.py's protocol: one warm step, then this many timed steps
BENCH_STEPS = 10
# the in-process benches: timed training steps, and the share of the JAX
# script's timed inference calls (30 a decode, 15 a WaveGlow, 40 a HiFi-GAN)
SCRIPT_STEPS, SCRIPT_REPS = 3, 0.2
# bench.py's step time against train_phase's at the same shape, in the same
# run: the two time the same step the same way (steps queued, one
# synchronise after the last), so a gap beyond this means they measure
# different things
BENCH_STEP_REL = 0.10
SCRIPT_KERNELS = {**TRAIN_KERNELS, **UTTERANCE_KERNELS}
SCRIPT_PLAIN = tuple(set(PLAIN_VERSIONS + UTTERANCE_PLAIN))


def _run_counted(code, argv, what, timeout=300):
    """``code`` (a runpy wrapper behind a ``LAUNCHES`` line) with ``argv``
    in a process of its own from the repository's root. Returns (stdout
    without the LAUNCHES line, the launches, wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"{what} exited {out.returncode}: {out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    counted = [l for l in lines if l.startswith("LAUNCHES ")]
    if len(counted) != 1:
        fail(f"{what}: no launch-count line in {out.stdout[-2000:]}")
    launches = json.loads(counted[0][len("LAUNCHES "):])
    return ([l for l in lines if not l.startswith("LAUNCHES ")], launches,
            wall)


def _all_finite(obj):
    if isinstance(obj, dict):
        return all(_all_finite(v) for v in obj.values())
    return isinstance(obj, (int, float)) and math.isfinite(obj) and obj > 0


def bench_phase(cfg, dev, card, train_ms):
    """The port's benchmarks: ``python -m tacotron2_tpu_torch.bench`` in a
    process of its own (one JSON line with root bench.py's four keys,
    ``vs_baseline`` its value over sampling_rate / hop_length, its step time
    within BENCH_STEP_REL of ``train_phase``'s ``train_ms``, rows 1-4
    launched once a step, warm step included, no plain version); then
    ``bench_buckets``, ``bench_default`` and every ``bench_details`` stage
    in this process at SCRIPT_STEPS timed steps and SCRIPT_REPS of the
    inference repetitions, every field finite. Returns the launch counts
    (the bench process's, and the three scripts' together)."""
    from tacotron2_tpu_torch.tools import (bench_buckets, bench_default,
                                           bench_details)
    lines, launches, wall = _run_counted(
        _rows_1_4_counted("tacotron2_tpu_torch.bench"), [], "the bench")
    results = [json.loads(l) for l in lines if l.startswith("{")]
    if len(results) != 1 or list(results[0]) != [
            "metric", "value", "unit", "vs_baseline"]:
        fail(f"the bench printed {lines}")
    line = results[0]
    frames_per_audio_s = cfg.sampling_rate / cfg.hop_length
    if (line["metric"] != "train_mel_frames_per_s_per_chip"
            or line["unit"] != "mel-frames/s/chip"
            or abs(line["vs_baseline"] - line["value"] / frames_per_audio_s)
            > 0.01):
        fail(f"the bench's line: {line}")
    B, T_out = (TRAIN_SHAPE[k] for k in ("B", "T_out"))
    bench_ms = B * T_out / line["value"] * 1e3
    gap = bench_ms / train_ms - 1
    want = {k: 1 + BENCH_STEPS for k in TRAIN_KERNELS}
    if {k: launches[k] for k in TRAIN_KERNELS} != want or launches["plain"]:
        fail(f"the bench's launches {launches}, not {want} and no plain "
             f"version")
    print(f"bench [{card}] python -m tacotron2_tpu_torch.bench: {line}; a "
          f"step {bench_ms:.2f} ms against train_phase's {train_ms:.2f} ms "
          f"({gap:+.2%}, limit {BENCH_STEP_REL:.0%}); launches {launches}; "
          f"process wall {wall:.1f} s")
    if abs(gap) > BENCH_STEP_REL:
        fail(f"the bench's step ({bench_ms:.2f} ms) is {gap:+.2%} from "
             f"train_phase's ({train_ms:.2f} ms)")

    for fn in SCRIPT_KERNELS.values():
        fn.launches = 0
    plain0 = sum(f.calls for f in SCRIPT_PLAIN)
    t0 = time.perf_counter()
    buckets = bench_buckets.run(SCRIPT_STEPS, dev)
    default = bench_default.run(SCRIPT_STEPS, dev)
    details = bench_details.Bench(dev, SCRIPT_STEPS, SCRIPT_REPS).run(
        bench_details.STAGES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in SCRIPT_KERNELS.items()}
    plain = sum(f.calls for f in SCRIPT_PLAIN) - plain0
    if not all(map(_all_finite, (buckets, default, details))):
        fail(f"bench scripts: a field is not finite: {buckets}, {default}, "
             f"{details}")
    for name in SCRIPT_KERNELS:
        if name != "mel_spectrogram_fused" and counts[name] == 0:
            fail(f"the bench scripts never launched the {name} kernel")
    if plain:
        fail(f"the bench scripts ran a plain version {plain} times")
    print(f"bench scripts [{card}] bench_buckets at {SCRIPT_STEPS} timed "
          f"steps: {json.dumps(buckets)}; bench_default: "
          f"{json.dumps(default)}; bench_details (every stage, "
          f"{SCRIPT_REPS} of the repetitions): {json.dumps(details)}; "
          f"launches {counts}; {wall:.1f} s")
    return launches, counts


# The linear mel value above which a cached mel is held in the log domain
# within MEL_LOG_ATOL. Below it the log turns fp32's rounding (a linear gap
# of well under 1e-6 on the tone corpus) into more than MEL_LOG_ATOL, for
# row 8 and its plain fp32 version alike: cache_mels_phase prints both
# paths' log gaps to the numpy path above each of CACHE_LOG_FLOORS.
CACHE_LOG_FLOOR = 1e-2
CACHE_LOG_FLOORS = (1e-4, 1e-3, 1e-2)


def _loud_log_gap(a, b, floor=CACHE_LOG_FLOOR):
    """max |a - b| of two log-mel tensors over the bins where both linear
    values exceed ``floor``."""
    loud = torch.minimum(a, b).exp() > floor
    return float((a - b).abs()[loud].max())


def cache_mels_phase(cfg, dev, card, filelist, root):
    """``python -m tacotron2_tpu_torch.tools.cache_mels`` on the card in a
    process of its own over the tone filelist: row 8 once an utterance, no
    plain version; each .npy against row 8's plain version on the same wav
    and against the numpy path (``mel_spectrogram_np``, a float64 DFT), by
    linear share within AUDIO_MEL_REL, as ``audio_batch_phase`` holds row
    8's targets on this corpus, and in the log domain within MEL_LOG_ATOL
    on the bins where both linear values exceed CACHE_LOG_FLOOR; a mel
    perturbed at its peak fails the first, one perturbed at its quietest
    bin above the floor fails the second;
    ``TextMelDataset(load_mel_from_disk=True)`` over the ``--out``
    filelist returns those mels. Returns row 8's launches."""
    from tacotron2_tpu_torch.data.dataset import (TextMelDataset,
                                                  load_filelist, load_wav,
                                                  mel_spectrogram_np)
    out_list = root / "mels.txt"
    lines, launches, wall = _run_counted(
        CACHE_COUNTED, [str(filelist), "--out", str(out_list)],
        "cache_mels")
    entries = load_filelist(filelist)
    n = len(entries)
    if launches != {"mel_spectrogram_fused": n, "plain": 0}:
        fail(f"cache_mels: launches {launches} for {n} utterances")
    mc = tmel.MelConfig.from_config(cfg)
    worst = {"plain": 0.0, "numpy": 0.0}
    worst_log = {"plain": 0.0, "numpy": 0.0}
    readings = {k: dict.fromkeys(CACHE_LOG_FLOORS, 0.0)
                for k in ("row 8", "plain")}
    log_at = (0.0, 0.0)
    for path, _ in entries:
        got = torch.from_numpy(np.load(os.path.splitext(path)[0] + ".npy"))
        audio, _ = load_wav(path)
        audio = audio / cfg.max_wav_value
        want = {"plain": mk.mel_spectrogram_fused_plain(torch.from_numpy(
                    audio.astype(np.float32))[None].to(dev), mc)[0].cpu(),
                "numpy": torch.from_numpy(mel_spectrogram_np(audio, mc))}
        if got.shape != want["numpy"].shape or got.dtype != torch.float32:
            fail(f"cache_mels: {path}: {tuple(got.shape)} {got.dtype}")
        for k, w in want.items():
            share = _linear_share(got, w)
            worst[k] = max(worst[k], share)
            if share > AUDIO_MEL_REL:
                fail(f"cache_mels: {path}: {share} of the largest linear "
                     f"value against the {k} path (limit {AUDIO_MEL_REL})")
            gap = _loud_log_gap(got, w)
            worst_log[k] = max(worst_log[k], gap)
            if gap > MEL_LOG_ATOL:
                fail(f"cache_mels: {path}: {gap} in the log domain against "
                     f"the {k} path on the bins above {CACHE_LOG_FLOOR} "
                     f"(limit {MEL_LOG_ATOL})")
        for k, a in (("row 8", got), ("plain", want["plain"])):
            for f in CACHE_LOG_FLOORS:
                readings[k][f] = max(readings[k][f], _loud_log_gap(
                    a, want["numpy"], f))
        log_err = (got - want["plain"]).abs()
        at = int(log_err.argmax())
        if float(log_err.flatten()[at]) > log_at[0]:
            log_at = (float(log_err.flatten()[at]),
                      float(want["plain"].flatten()[at]))
    bad = got.clone()
    peak = np.unravel_index(int(want["numpy"].argmax()), tuple(got.shape))
    bad[peak] += math.log1p(10 * AUDIO_MEL_REL)
    if any(_linear_share(bad, w) <= AUDIO_MEL_REL for w in want.values()):
        fail("the cache_mels comparison passes a perturbed mel")
    quiet = np.unravel_index(int(want["numpy"].masked_fill(
        torch.minimum(got, want["numpy"]).exp() <= CACHE_LOG_FLOOR,
        math.inf).argmin()), tuple(got.shape))
    bad = got.clone()
    bad[quiet] += 10 * MEL_LOG_ATOL
    if any(_loud_log_gap(bad, w) <= MEL_LOG_ATOL for w in want.values()):
        fail("the cache_mels log-domain comparison passes a mel perturbed "
             "at a quiet bin")
    quiet_share = _linear_share(bad, want["numpy"])
    ds = TextMelDataset(str(out_list), cfg.replace(load_mel_from_disk=True),
                        shuffle=False)
    for i, (npy, _) in enumerate(ds.entries):
        if not np.array_equal(ds[i][1], np.load(npy)):
            fail(f"TextMelDataset read {npy} as another mel")
    print(f"cache_mels [{card}] {n} tone utterances on the card: row 8 "
          f"launched {launches['mel_spectrogram_fused']} times, no plain "
          f"version; of the largest linear value {worst['plain']:.2e} "
          f"against row 8's plain version and {worst['numpy']:.2e} against "
          f"the numpy path (limit {AUDIO_MEL_REL}); in the log domain on "
          f"the bins above {CACHE_LOG_FLOOR} {worst_log['plain']:.2e} "
          f"against the plain version and {worst_log['numpy']:.2e} against "
          f"the numpy path (limit {MEL_LOG_ATOL}), on every bin max |err| "
          f"against the plain version {log_at[0]:.2e}, at a log mel of "
          f"{log_at[1]:.2f}; log gap to the numpy path above each linear "
          f"floor " + json.dumps({k: {f"{f:g}": f"{v:.2e}" for f, v in
                                       r.items()} for k, r in readings.items()})
          + f"; mels perturbed at the peak and at a quiet bin (linear "
          f"{math.exp(float(want['numpy'][quiet])):.2e}, a linear share of "
          f"{quiet_share:.1e}) rejected; TextMelDataset("
          f"load_mel_from_disk) reads them back; {lines[-1]}; process wall "
          f"{wall:.1f} s")
    return launches["mel_spectrogram_fused"]


DEMO_STEPS = 200


def demo_phase(cfg, dev, card, seed, root):
    """The inference demo (``tools/inference_demo.main``) on a seeded
    full-width model, saved as a native checkpoint and as a reference-
    format state_dict, max_decoder_steps DEMO_STEPS: the WAV at the
    config's rate, frames x hop samples (T - 1 for Griffin-Lim's last
    frame), not silent; row 3 launched, no plain version; the line on the
    plots names what was written (none without matplotlib). Returns row
    3's launches."""
    import contextlib
    import io
    import scipy.io.wavfile
    from tacotron2_tpu_torch.tools import inference_demo
    from tacotron2_tpu_torch.training.checkpoint import Checkpointer
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(seed),
                         trainable=True)
    paths = {"native": Checkpointer(str(root / "demo_run")).save(
        tstate.state_for(model, cfg), wait=True)}
    paths["reference state_dict"] = str(root / "demo_statedict.pt")
    torch.save(model.state_dict(), paths["reference state_dict"])
    del model
    launches, report = 0, []
    for kind, path in paths.items():
        out_dir = root / f"demo_{len(report)}"
        flags = ["--torch_checkpoint"] if kind != "native" else []
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            res, counts = _counted(f"the demo ({kind})", lambda: (
                inference_demo.main(["-c", path, *flags, "-o", str(out_dir),
                                     "--hparams",
                                     f"max_decoder_steps={DEMO_STEPS}"])),
                ("encoder_lstm_fwd",))
        line = said.getvalue().strip().splitlines()[-1]
        sr, wav = scipy.io.wavfile.read(out_dir / "demo.wav")
        n = res.mel.shape[0]
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
        if (sr != cfg.sampling_rate or wav.dtype != np.int16
                or len(wav) != len(res.audio) or not rms > 0
                or not (n - 1) * cfg.hop_length <= len(wav)
                <= n * cfg.hop_length
                or not np.isfinite(res.mel).all()):
            fail(f"the demo ({kind}): rate {sr}, {wav.shape} {wav.dtype} "
                 f"for {n} frames, rms {rms}")
        pngs = sorted(p.name for p in out_dir.glob("*.png"))
        if not (("no plots written" in line and not pngs)
                or (pngs and all(p in line for p in pngs))):
            fail(f"the demo ({kind}) said {line!r} and wrote {pngs}")
        launches += counts["encoder_lstm_fwd"]
        report.append(f"{kind}: {n} frames, {len(wav)} samples at {sr} Hz, "
                      f"rms {rms:.1f}, row 3 {counts['encoder_lstm_fwd']} "
                      f"launch(es); said {line!r}")
    print(f"inference demo [{card}] " + "; ".join(report))
    return launches


# ------------------------------------------------------- data parallel

DP_RANKS = 2
DP_GROUP_TIMEOUT_S = 180   # a collective that waits longer raises
DP_SPAWN_TIMEOUT_S = 420   # every process still running then is killed
DP_STEPS = 2         # steps held against the one-process step
DP_TIMED_STEPS = 3   # steps after them, timed
# The two-rank bf16 step (two ranks of B=64 on the one card) against one
# process's train_step at B=128 on the same batch and state, both without
# dropout, after DP_STEPS steps: the loss and gradient norm of each step as
# a share of their value; each group's worst tensor by its largest |err| as
# a share of its largest |value| (field_err) for the Adam first moments
# (the clipped gradients' running mean), the running means and the running
# variances, and by its root-sum-square err as a share of its root-sum-
# square value for the first moments (exp_avg_rss: a batchnorm's offset has
# a gradient summed over B*T with much cancelling, whose largest element
# moves far more in bf16 than the tensor does); the parameters' largest
# |err| in units of DP_STEPS * lr (Adam
# moves an element about lr a step whatever its gradient's size, so an
# element whose gradient is at the rounding level, as a conv bias right
# before a batchnorm, may step either way: up to 2 of these units). The
# first moments of those biases (DP_BN_BIAS) are left out: rounding noise.
# Limits ~10x the card's readings (NVIDIA H100 80GB HBM3, 700 W:
# loss 1.31e-4, grad_norm 1.13e-3, exp_avg 0.138 and exp_avg_rss 0.108, both
# at encoder.convolutions.0.1.bias, running_mean 4.63e-2, running_var
# 2.69e-3; param 1.94, which Adam bounds near 2 whatever the gap, so its
# limit is that bound). The same two-rank step with each rank's own batch
# statistics (the group withheld inside this phase) must fail them: it
# read running_mean 1.31 and running_var 7.75e-2 (exp_avg 0.797, within
# its limit: in bf16 the gradients alone do not separate the two at 10x;
# the fp32 CPU test, tests/test_torch_parallel.py, holds them at 1e-3).
DP_REL = dict(loss=1.3e-3, grad_norm=1.1e-2, exp_avg=1.4, exp_avg_rss=1.1,
              running_mean=0.46, running_var=2.7e-2, param=2.5)
DP_BN_BIAS = ".0.conv.bias"
# The model-parallel step against one process's where two runs of one
# process differ: this many times their largest gap (the repo's ~10x).
MP_SPREAD_X = 10
# the device kernel of each training row at these shapes (bf16, full width:
# rows 1-2 on the tensor cores, rows 3-4 on clusters)
DP_ROW_KERNELS = {"train_scan_fwd": "scan_cell_kernel",
                  "train_scan_bwd": "attn_lstm_kernel",
                  "encoder_lstm_fwd": "encoder_cluster_kernel",
                  "encoder_lstm_bwd": "encoder_bwd_cluster_kernel"}
CLI_TRAIN_COUNTED = _rows_1_4_counted("tacotron2_tpu_torch.train")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(cmds, env=None):
    return [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in cmds]


def _wait(procs, timeout):
    """Wait for every process; kill each one still running at ``timeout``
    seconds, and every one on any error. Returns [(returncode, output)],
    the returncode None for a process killed at the deadline."""
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            try:
                out = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
                results.append((p.returncode, out))
            except subprocess.TimeoutExpired:
                p.kill()
                results.append((None, p.communicate()[0]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _dp_card(rank):
    """Rank r's card: card r, or with fewer cards than ranks r modulo
    their count (every rank on card 0 with one card)."""
    return torch.device("cuda", rank % torch.cuda.device_count())


def _dp_join(backend, rank, world, port):
    """Join the group of ``world`` processes, this one on its card."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(_dp_card(rank))
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))


def dp_probe_worker(rank, world, port):
    """One rank of the probe: an NCCL all-reduce over the ranks. NCCL may
    refuse ranks that share a card."""
    import torch.distributed as dist
    _dp_join("nccl", rank, world, port)
    x = torch.full((4,), float(rank + 1), device=_dp_card(rank))
    dist.all_reduce(x)
    torch.cuda.synchronize()
    if float(x[0]) != world * (world + 1) / 2:
        raise RuntimeError(f"the NCCL all-reduce gave {x.tolist()}")
    dist.destroy_process_group()


def _dp_snapshot(state, metrics):
    """The state's parameters, statistics and first moments and the steps'
    metrics, as fp32 copies on the host."""
    out = {f"param/{k}": v.detach().float().cpu()
           for k, v in state.model.named_parameters()}
    for group in ("stats", "exp_avg"):
        out.update({f"{group}/{k}": v.float().cpu()
                    for k, v in getattr(state, group).items()})
    for f in ("loss", "grad_norm", "applied"):
        out[f] = torch.stack([getattr(m, f).float() for m in metrics]).cpu()
    return out


def _same_as_rank0(tensors, group):
    """Whether this rank's fp32 tensors equal rank 0's bit for bit (rank
    0's are broadcast and compared on each rank)."""
    import torch.distributed as dist
    flat = torch.cat([t.detach().reshape(-1).view(torch.int32)
                      for t in tensors])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0, group=group)
    return bool(torch.equal(theirs, flat))


def _state_fp32(state, with_stats=True):
    return ([p.detach() for p in state.model.parameters()]
            + list(state.exp_avg.values()) + list(state.exp_avg_sq.values())
            + (list(state.stats.values()) if with_stats else []))


def _dp_steps(cfg, dev, seed, mesh, root, synced):
    """DP_STEPS then DP_TIMED_STEPS data-parallel steps on this rank's rows
    of bench.py's batch, no dropout, each step and its gradient all-reduce
    timed on the host (synchronised around each). After DP_STEPS rank 0
    saves its state; every rank checks it equals rank 0's. With ``synced``
    False the batchnorm group is withheld: each rank's own statistics."""
    from tacotron2_tpu_torch.parallel import (make_train_step,
                                              replicate_state, shard_batch)
    from tacotron2_tpu_torch.parallel import step as pstep
    B, T_in, T_out = (TRAIN_SHAPE[k] for k in ("B", "T_in", "T_out"))
    state = replicate_state(tstate.create_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device=dev), mesh)
    local = shard_batch(tstate.make_batch(cfg, B, T_in, T_out, seed=seed,
                                          device=dev), mesh)
    plain_bn, plain_reduce = tm.batchnorm_train, pstep.all_reduce_mean
    reduce_s = []

    def timed_reduce(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_reduce(*a, **k)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
        return out

    if not synced:
        tm.batchnorm_train = lambda *a, group=None, **k: plain_bn(*a, **k)
    pstep.all_reduce_mean = timed_reduce
    try:
        step = make_train_step(cfg, mesh)
        metrics, step_s = [], []
        for i in range(DP_STEPS + DP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, local, None)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            metrics.append(m)
            if i == DP_STEPS - 1:
                same = _same_as_rank0(_state_fp32(state, synced), mesh.group)
                if mesh.rank == 0:
                    torch.save(_dp_snapshot(state, metrics), root / (
                        "dp_synced.pt" if synced else "dp_unsynced.pt"))
        names = None
        if synced:  # two steps under the profiler: which kernels ran
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.05)  # see _device_events
                for _ in range(2):
                    state, _ = step(state, local, None)
                torch.cuda.synchronize()
                time.sleep(0.05)
            names = sorted({e.name.split("(")[0].split("<")[0]
                            .replace("void ", "") for e in prof.events()
                            if e.device_type
                            == torch.autograd.DeviceType.CUDA})
    finally:
        tm.batchnorm_train, pstep.all_reduce_mean = plain_bn, plain_reduce
    return dict(step_ms=[t * 1e3 for t in step_s],
                all_reduce_ms=[t * 1e3 for t in reduce_s], same=same,
                kernels=names, losses=[float(m.loss) for m in metrics])


def _mp_steps(cfg, dev, seed, root, gather=True):
    """The model-parallel steps on all ranks: a ``(ranks / 2, 2)`` mesh
    (``(1, 2)`` on the one card: both ranks take the whole batch, each
    holds half of every sharded leaf's moments), bench.py's batch, no
    dropout, DP_STEPS steps then DP_TIMED_STEPS timed ones, the parts'
    all-gather timed on the host (synchronised around it). After DP_STEPS
    each rank saves its state as it holds it (whole parameters, its parts
    of the moments) and checks that its whole parameters and statistics
    equal rank 0's. With ``gather`` False the all-gather is skipped (each
    rank updates its parts alone) for DP_STEPS steps: the negative
    control."""
    from tacotron2_tpu_torch.parallel import (ShardPlan, create_mesh,
                                              make_train_step,
                                              replicate_state, shard_batch,
                                              shard_plan, shard_state)
    import torch.distributed as dist
    world = dist.get_world_size()
    mesh = create_mesh((world // 2, 2))
    B, T_in, T_out = (TRAIN_SHAPE[k] for k in ("B", "T_in", "T_out"))
    state = replicate_state(tstate.create_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device=dev), mesh)
    plan = shard_plan(state.model, mesh)
    state = shard_state(state, plan)
    local = shard_batch(tstate.make_batch(cfg, B, T_in, T_out, seed=seed,
                                          device=dev), mesh)
    plain_gather = ShardPlan.gather_parts
    gather_s = []

    def timed_gather(self, wholes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_gather(self, wholes)
        torch.cuda.synchronize()
        gather_s.append(time.perf_counter() - t0)

    ShardPlan.gather_parts = (timed_gather if gather
                              else lambda self, wholes: None)
    try:
        step = make_train_step(cfg, mesh)
        metrics, step_s = [], []
        for i in range(DP_STEPS + (DP_TIMED_STEPS if gather else 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, local, None)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            metrics.append(m)
            if i == DP_STEPS - 1:
                same = _same_as_rank0(
                    [p.detach() for p in state.model.parameters()]
                    + list(state.stats.values()), mesh.group)
                name = "gathered" if gather else "skipped"
                torch.save(_dp_snapshot(state, metrics),
                           root / f"mp_{name}_{mesh.rank}.pt")
    finally:
        ShardPlan.gather_parts = plain_gather
    whole = sum(p.numel() for n, p in state.model.named_parameters()
                if n in plan.dims)
    held = sum(state.exp_avg[n].numel() for n in plan.dims)
    return dict(shape=[mesh.dp, mesh.mp], step_ms=[t * 1e3 for t in step_s],
                gather_ms=[t * 1e3 for t in gather_s], same=same,
                moment_share=held / whole,
                losses=[float(m.loss) for m in metrics])


def _trace_kernels(path):
    """The kernel names in a ``profile_trace`` trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"].split("(")[0].split("<")[0].replace("void ", "")
            for e in events if e.get("cat") == "kernel"}


def _dp_fit(dev, seed, mesh, root):
    """``Trainer.fit`` on the ranks, full width (the tone demo's config:
    bf16, dropout on), over a native-extracted pipeline of the tone corpus
    that every rank reads whole: 4 steps from scratch (a checkpoint and a
    validation every 2; each rank its own output directory, so that rank
    1's shows what it wrote), then a Trainer resumed from rank 0's step-2
    checkpoint for the same 2 steps, equal bit for bit; 2 steps with
    grad_accum_steps=2; one step inside ``profile_trace``."""
    import torch.distributed as dist
    from tacotron2_tpu_torch.data import DataPipeline, TextMelDataset
    from tacotron2_tpu_torch.tools import train_demo
    from tacotron2_tpu_torch.training.trainer import Trainer
    from tacotron2_tpu_torch.utils.profiling import (latest_trace,
                                                     profile_trace)
    cfg = train_demo.demo_config(
        hparams=f"seed={seed},iters_per_checkpoint=2,log_interval=1")
    whole = dict(process_index=0, process_count=1)
    data = TextMelDataset(str(root / "corpus" / "train.txt"), cfg,
                          use_native=True)
    if data._native is None:
        fail("use_native=True did not take the native extractor")
    train = DataPipeline(data, cfg, **whole)
    val = DataPipeline(TextMelDataset(str(root / "val.txt"), cfg,
                                      shuffle=False, use_native=True),
                       cfg, drop_last=False, **whole)

    def counts():
        return {k: fn.launches for k, fn in TRAIN_KERNELS.items()}

    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    first = Trainer(cfg, str(root / f"fit_{mesh.rank}"), device=dev)
    first.fit(train, val, epochs=1 << 30, max_steps=4)
    torch.cuda.synchronize()
    fit_counts = counts()
    timing = first.last_fit
    dist.barrier()  # rank 0's checkpoints are written
    resumed = Trainer(cfg, str(root / f"resumed_{mesh.rank}"),
                      checkpoint_path=str(root / "fit_0" / "checkpoint_2.pt"),
                      device=dev)
    resumed.fit(train, val, epochs=1 << 30, max_steps=4)
    gap = _largest_gap(_state_tensors(resumed.state),
                       _state_tensors(first.state))
    same = _same_as_rank0(_state_fp32(first.state), mesh.group)
    del resumed

    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    accum = Trainer(cfg.replace(grad_accum_steps=2),
                    str(root / f"accum_{mesh.rank}"), device=dev)
    seen = []
    accum.fit(train, None, epochs=1 << 30, max_steps=2,
              on_step=lambda step, m: seen.append(m))
    torch.cuda.synchronize()
    accum_counts = counts()
    accum_rows = [(float(m.loss), float(m.applied)) for m in seen]
    del accum

    trace_dir = root / f"trace_{mesh.rank}"
    with profile_trace(str(trace_dir)):
        first.fit(train, None, epochs=1 << 30,
                  max_steps=int(first.state.step) + 1)
        torch.cuda.synchronize()
    traced = _trace_kernels(latest_trace(str(trace_dir)))
    return dict(fit_launches=fit_counts, fit_steps=timing.steps,
                fit_wall_s=timing.wall_s,
                fit_intervals_ms=[t * 1e3 for t in timing.step_intervals_s],
                resume_gap=gap, same=same, accum_launches=accum_counts,
                accum_rows=accum_rows,
                traced={k: v in traced for k, v in DP_ROW_KERNELS.items()})


def dp_worker(rank, world, port, root, backend, seed):
    """One rank of the data-parallel phase on its card (``_dp_card``):
    the step synced and unsynced, the model-parallel step (and, on two
    ranks, the same without its all-gather), then ``Trainer.fit``. Writes
    its report to ``root/dp_rank<rank>.json``."""
    import torch.distributed as dist
    from tacotron2_tpu_torch.parallel import create_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _dp_join(backend, rank, world, port)
    mesh = create_mesh()
    dev = _dp_card(rank)
    root = Path(root)
    cfg = create_config()
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    plain0 = sum(f.calls for f in PLAIN_VERSIONS)
    synced = _dp_steps(cfg, dev, seed, mesh, root, synced=True)
    step_counts = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
    unsynced = _dp_steps(cfg, dev, seed, mesh, root, synced=False)
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    mp = _mp_steps(cfg, dev, seed, root)
    mp_counts = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
    mp_skipped = (_mp_steps(cfg, dev, seed, root, gather=False)
                  if world == 2 else None)
    fit = _dp_fit(dev, seed, mesh, root)
    report = dict(rank=rank, backend=dist.get_backend(), synced=synced,
                  unsynced=unsynced, mp=mp, mp_launches=mp_counts,
                  mp_skipped=mp_skipped, step_launches=step_counts,
                  step_count=DP_STEPS + DP_TIMED_STEPS + 2, fit=fit,
                  plain=sum(f.calls for f in PLAIN_VERSIONS) - plain0,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    (root / f"dp_rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def _dp_gaps(got, want, lr):
    """Each group's worst gap, (name, value), as DP_REL measures it."""
    worst = {}

    def note(group, name, value):
        if group not in worst or value > worst[group][1]:
            worst[group] = (name, value)

    for i in range(DP_STEPS):
        for f in ("loss", "grad_norm"):
            note(f, f"{f} {i}", abs(float(got[f][i]) - float(want[f][i]))
                 / abs(float(want[f][i])))
    for k in want:
        kind, _, name = k.partition("/")
        if kind == "param":
            note("param", k, float((got[k] - want[k]).abs().max())
                 / (DP_STEPS * lr))
        elif kind == "exp_avg" and not name.endswith(DP_BN_BIAS):
            note("exp_avg", k, field_err(got[k], want[k])[1])
            note("exp_avg_rss", k, float((got[k] - want[k]).norm()
                                         / want[k].norm()))
        elif kind == "stats":
            note(name.rsplit(".", 1)[1], k, field_err(got[k], want[k])[1])
    return worst


def _dp_beyond(worst):
    return {g: (n, v) for g, (n, v) in worst.items() if v > DP_REL[g]}


def _rel_gap(got, want):
    """(name, share): the largest |got - want| over the tensors that both
    snapshots hold, as a share of that tensor's largest |want|; (None, 0.0)
    when every one is equal bit for bit."""
    worst = (None, 0.0)
    for k in want:
        if k in got and not torch.equal(got[k], want[k]):
            share = float((got[k] - want[k]).abs().max()
                          / want[k].abs().max().clamp(min=1e-30))
            if worst[0] is None or share > worst[1]:
                worst = (k, share)
    return worst


def _mp_whole(snaps, mp):
    """One whole snapshot from the snapshots of the ranks of dp index 0
    (each holding part m of every sharded first moment)."""
    from tacotron2_tpu_torch.parallel import shard_dim
    whole = dict(snaps[0])
    for k, v in snaps[0].items():
        kind, _, name = k.partition("/")
        dim = shard_dim(name, snaps[0][f"param/{name}"].shape, mp) \
            if kind == "exp_avg" else None
        if dim is not None:
            whole[k] = torch.cat([s[k] for s in snaps[:mp]], dim=dim)
    return whole


def _mp_compare(cfg, card, root, reports, ref, spread):
    """The model-parallel step against one process's: on one card (1, 2),
    bit for bit when two runs of one process are (``spread``), else within
    MP_SPREAD_X times their largest gap, each rank's first moments its
    share of the process's, and the same step without its all-gather
    rejected; over four cards (2, 2), rows split, within DP_REL. Every
    rank's whole parameters equal rank 0's, and a rank holds 1/2 of each
    sharded leaf's moment elements. Returns the numbers for the record."""
    from tacotron2_tpu_torch.parallel import ShardPlan, shard_dim
    ranks = len(reports)
    dp, mp = reports[0]["mp"]["shape"]
    snaps = [torch.load(root / f"mp_gathered_{r}.pt") for r in range(ranks)]
    limit = MP_SPREAD_X * spread[1]
    for rep in reports:
        if not rep["mp"]["same"] or rep["mp"]["moment_share"] != 1 / mp:
            fail(f"rank {rep['rank']} of the ({dp}, {mp}) step: whole "
                 f"parameters equal rank 0's {rep['mp']['same']}, moment "
                 f"share {rep['mp']['moment_share']}")

    def as_rank(snap_ref, r):
        """``snap_ref`` as rank r holds it: part r % mp of each sharded
        first moment."""
        out = dict(snap_ref)
        for k, v in snap_ref.items():
            kind, _, name = k.partition("/")
            dim = shard_dim(name, ref[f"param/{name}"].shape, mp) \
                if kind == "exp_avg" else None
            if dim is not None:
                out[k] = ShardPlan({name: dim}, r % mp, mp, None).part(name, v)
        return out

    if dp == 1:
        gaps = [_rel_gap(snaps[r], as_rank(ref, r)) for r in range(ranks)]
        worst = max(gaps, key=lambda g: g[1])
        skipped = _rel_gap(torch.load(root / "mp_skipped_0.pt"),
                           as_rank(ref, 0))
        verdict = (f"each rank against one process: worst {worst} (limit "
                   f"{'bit for bit' if spread[0] is None else limit}); "
                   f"without the all-gather {skipped}")
        if any(g[0] is not None and g[1] > limit for g in gaps):
            fail(f"the (1, {mp}) step differs from one process: {gaps} "
                 f"(two runs of one process: {spread})")
        if skipped[0] is None or skipped[1] <= limit:
            fail(f"the comparison passes the (1, {mp}) step without its "
                 f"all-gather: {skipped}")
    else:
        worst = _dp_gaps(_mp_whole(snaps, mp), ref, cfg.learning_rate)
        verdict = "against one process " + ", ".join(
            f"{g} {v:.3e} ({n})" for g, (n, v) in sorted(worst.items()))
        if _dp_beyond(worst):
            fail(f"the ({dp}, {mp}) step is beyond DP_REL: "
                 f"{_dp_beyond(worst)}")
    n = DP_STEPS + DP_TIMED_STEPS
    step_ms = [float(np.median(rep["mp"]["step_ms"][DP_STEPS:]))
               for rep in reports]
    gather_ms = [float(np.median(rep["mp"]["gather_ms"][DP_STEPS:n]))
                 for rep in reports]
    r2 = lambda xs: [round(x, 2) for x in xs]
    # both fp32 Adam moments: one process's, and a rank's (1/mp of each
    # sharded leaf's)
    params = {k[6:]: v.shape for k, v in ref.items() if k.startswith("param/")}
    whole_mb = sum(8 * math.prod(sh) for sh in params.values()) / 1e6
    rank_mb = whole_mb - sum(
        8 * math.prod(sh) * (1 - 1 / mp) for n, sh in params.items()
        if shard_dim(n, sh, mp) is not None) / 1e6
    print(f"model parallel [{card}] ({dp}, {mp}) mesh over {ranks} ranks, "
          f"B={TRAIN_SHAPE['B']} global (bf16, no dropout), {DP_STEPS} "
          f"steps; two runs of one process: {spread}; {verdict}; whole "
          f"parameters equal on every rank; each rank holds 1/{mp} of the "
          f"sharded moments: Adam moments {rank_mb:.1f} MB a rank against "
          f"{whole_mb:.1f} MB in one process; step (host clock, median of "
          f"{DP_TIMED_STEPS}) "
          f"by rank {r2(step_ms)} ms, the all-gather {r2(gather_ms)} ms, "
          f"{max(gather_ms) / max(step_ms):.3f} of the step; launches a "
          f"rank over {n} steps {reports[0]['mp_launches']}")
    return dict(shape=[dp, mp], step_ms=step_ms, gather_ms=gather_ms,
                spread=spread, worst=worst)


def dp_phase(cfg, dev, card, seed, ranks=DP_RANKS):
    """Data parallelism: ``ranks`` processes of
    ``parallel.make_train_step`` (on the one card, or one a card with
    ``--dp-cards``) against one process's ``train_step``, then
    ``Trainer.fit`` on the ranks and the train CLI under a one-rank
    torchrun environment over NCCL. Returns rank 0's launch counts in the
    data-parallel steps."""
    from tacotron2_tpu_torch.tools import train_demo
    t_phase = time.perf_counter()
    BUILD.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="data_parallel_", dir=BUILD))
    lib = REPO / "native" / "libtaco_dsp.so"
    had_lib = lib.exists()
    me = str(Path(__file__).resolve())
    try:
        torch.cuda.empty_cache()
        port = _free_port()
        probe = _start([[sys.executable, me, "--dp-probe", str(r),
                         str(ranks), str(port)] for r in range(ranks)])
        # meanwhile: the one-process reference, the native library, the
        # corpus
        B, T_in, T_out = (TRAIN_SHAPE[k] for k in ("B", "T_in", "T_out"))
        state = tstate.create_train_state(
            cfg, generator=torch.Generator().manual_seed(seed), device=dev)
        batch = tstate.make_batch(cfg, B, T_in, T_out, seed=seed, device=dev)
        metrics, one_ms = [], []
        for _ in range(DP_STEPS + DP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m, _ = tstate.train_step(state, batch, cfg)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
            if len(metrics) == DP_STEPS:
                ref = _dp_snapshot(state, metrics)
        # a second run of the same steps: how far one process is from
        # itself, which sets the limit of the model-parallel comparison
        state = tstate.create_train_state(
            cfg, generator=torch.Generator().manual_seed(seed), device=dev)
        again = []
        for _ in range(DP_STEPS):
            state, m, _ = tstate.train_step(state, batch, cfg)
            again.append(m)
        spread = _rel_gap(_dp_snapshot(state, again), ref)
        del state, batch, metrics, again
        torch.cuda.empty_cache()
        subprocess.run(["sh", str(REPO / "native" / "build.sh")], check=True,
                       capture_output=True, timeout=300)
        filelist = train_demo.build_corpus(str(root / "corpus"), 128)
        lines = Path(filelist).read_text().splitlines()
        (root / "val.txt").write_text("\n".join(lines[:32]))
        probed = _wait(probe, 120)
        backend = "nccl" if all(rc == 0 for rc, _ in probed) else "gloo"
        said = [l for rc, out in probed for l in out.splitlines()
                if "Duplicate GPU" in l or "rror" in l]
        cards = min(ranks, torch.cuda.device_count())
        why = "" if backend == "nccl" else (
            f": NCCL refused {ranks} ranks on {cards} card(s) ("
            + (said or [probed[0][1].strip()[-300:]])[-1].strip()[-300:]
            + ")")
        print(f"data parallel [{card}] {ranks} ranks on {cards} card(s) "
              f"over {backend}{why}")

        port = _free_port()
        t0 = time.perf_counter()
        done = _wait(_start([[sys.executable, me, "--dp-worker", str(r),
                              str(ranks), str(port), str(root), backend,
                              str(seed)] for r in range(ranks)]),
                     DP_SPAWN_TIMEOUT_S)
        workers_s = time.perf_counter() - t0
        for r, (rc, out) in enumerate(done):
            if rc != 0:
                fail(f"data-parallel rank {r} exited {rc} (None: killed "
                     f"after {DP_SPAWN_TIMEOUT_S} s):\n{out[-4000:]}")
        reports = [json.loads((root / f"dp_rank{r}.json").read_text())
                   for r in range(ranks)]

        # the data-parallel step against the one-process step
        lr = cfg.learning_rate
        synced = _dp_gaps(torch.load(root / "dp_synced.pt"), ref, lr)
        unsynced = _dp_gaps(torch.load(root / "dp_unsynced.pt"), ref, lr)
        fmt = lambda w: ", ".join(f"{g} {s:.3e} ({n})" for g, (n, s)
                                  in sorted(w.items()))
        print(f"data parallel [{card}] {ranks} ranks x B="
              f"{B // ranks} against one process at B={B} (bf16, T_in "
              f"{T_in}, T_out {T_out}, no dropout), {DP_STEPS} steps, worst "
              f"of each group: " + fmt(synced))
        print(f"data parallel [{card}] with each rank's own batch statistics "
              f"(unsynced): " + fmt(unsynced))
        rep0 = reports[0]
        n = DP_STEPS + DP_TIMED_STEPS
        step_ms = [float(np.median(rep["synced"]["step_ms"][DP_STEPS:]))
                   for rep in reports]
        reduce_ms = [float(np.median(rep["synced"]["all_reduce_ms"][
            DP_STEPS:n])) for rep in reports]
        own_ms = [float(np.median(rep["unsynced"]["step_ms"][DP_STEPS:]))
                  for rep in reports]
        seen = [sorted(set(DP_ROW_KERNELS.values())
                       & set(rep["synced"]["kernels"])) for rep in reports]
        r2 = lambda xs: [round(x, 2) for x in xs]
        print(f"data parallel [{card}] step (host clock, median of "
              f"{DP_TIMED_STEPS} after {DP_STEPS}) by rank: {r2(step_ms)} ms; "
              f"the gradient all-reduce (one flat fp32 buffer, {backend}) "
              f"{r2(reduce_ms)} ms, {max(reduce_ms) / max(step_ms):.3f} of "
              f"the step; with unsynced batch statistics {r2(own_ms)} ms; "
              f"one process at B={B} {np.median(one_ms[DP_STEPS:]):.2f} ms; "
              f"launches a rank over {rep0['step_count']} steps "
              f"{rep0['step_launches']}; rows 1-4's device kernels in each "
              f"rank's profile {seen}; peak memory by rank "
              f"{r2(rep['peak_gb'] for rep in reports)} GB")

        beyond = _dp_beyond(synced)
        if beyond:
            fail(f"the data-parallel step is beyond DP_REL: {beyond}")
        if not _dp_beyond(unsynced):
            fail("the comparison passes the data-parallel step with unsynced "
                 "batch statistics")
        for rep in reports:
            r = rep["rank"]
            for what in ("synced", "unsynced"):
                if not rep[what]["same"]:
                    fail(f"rank {r}'s state differs from rank 0's after "
                         f"the {what} steps")
            missing = [k for k, name in DP_ROW_KERNELS.items()
                       if name not in rep["synced"]["kernels"]
                       or rep["step_launches"][k] == 0]
            if missing or rep["plain"]:
                fail(f"rank {r}: kernels {missing} did not launch, or a "
                     f"plain version ran ({rep['plain']} calls)")

        mp_report = _mp_compare(cfg, card, root, reports, ref, spread)

        # Trainer.fit on the ranks
        for rep in reports:
            fit, r = rep["fit"], rep["rank"]
            if fit["resume_gap"][0] is not None:
                fail(f"rank {r}: the resumed Trainer differs from the first "
                     f"one at {fit['resume_gap']}")
            if not fit["same"]:
                fail(f"rank {r}: Trainer.fit left a state other than rank "
                     f"0's")
            if not all(fit["traced"].values()):
                fail(f"rank {r}: profile_trace's trace lacks kernels: "
                     f"{fit['traced']}")
            per_step = {k: rep["step_launches"][k] / rep["step_count"]
                        for k in DP_ROW_KERNELS}
            want = {k: 2 * 2 * v for k, v in per_step.items()}
            if fit["accum_launches"] != want:
                fail(f"rank {r}: grad_accum_steps=2 launched "
                     f"{fit['accum_launches']} in 2 steps, not {want}")
            if not all(math.isfinite(l) and a == 1.0
                       for l, a in fit["accum_rows"]):
                fail(f"rank {r}: accumulated steps {fit['accum_rows']}")
        ckpts = sorted(p.name
                       for p in (root / "fit_0").glob("checkpoint_*.pt"))
        others = [f"{d}_{r}" for r in range(1, ranks)
                  for d in ("fit", "resumed", "accum")
                  if (root / f"{d}_{r}").exists()]
        if "checkpoint_2.pt" not in ckpts or others:
            fail(f"checkpoints: rank 0 wrote {ckpts}; other ranks' "
                 f"directories {others} exist")
        fit0 = rep0["fit"]
        print(f"data parallel [{card}] Trainer.fit on {ranks} ranks (tone "
              f"demo config, B=32 global, bf16, dropout on, native mels): "
              f"{fit0['fit_steps']} steps in {fit0['fit_wall_s']:.3f} s "
              f"(median interval "
              f"{np.median(fit0['fit_intervals_ms']):.2f} ms), launches "
              f"{fit0['fit_launches']}; rank 0 alone wrote {ckpts}; a "
              f"Trainer resumed from checkpoint_2 equal bit for bit on each "
              f"rank; all ranks equal; grad_accum_steps=2: losses "
              f"{[round(l, 5) for l, _ in fit0['accum_rows']]}, launches "
              f"{fit0['accum_launches']} in 2 steps; profile_trace holds "
              f"rows 1-4's kernels on each rank; the {ranks} workers' "
              f"wall {workers_s:.1f} s")

        # the CLI under a one-rank torchrun environment over NCCL
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        out_dir = root / "cli"
        t0 = time.perf_counter()
        (rc, out), = _wait(_start([[
            sys.executable, "-c", CLI_TRAIN_COUNTED, "-o", str(out_dir),
            "--hparams", f"training_files={filelist},validation_files="
            f"{root / 'val.txt'},epochs=1,batch_size=32,text_buckets=32+48,"
            f"max_mel_length=512,iters_per_checkpoint=2,seed={seed}"]],
            env=env), 300)
        cli_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"the train CLI exited {rc}:\n{out[-4000:]}")
        launches = json.loads(out.split("LAUNCHES ", 1)[1].splitlines()[0])
        group_line = [l for l in out.splitlines()
                      if l.startswith("Process group:")]
        ckpts = sorted(p.name for p in out_dir.glob("checkpoint_*.pt"))
        if (group_line != ["Process group: backend nccl, data parallel over "
                           "1 rank(s), mesh (dp, mp) = (1, 1)"] or not ckpts
                or not all(launches[k] for k in DP_ROW_KERNELS)
                or launches["plain"]):
            fail(f"the train CLI under torchrun: {group_line}, checkpoints "
                 f"{ckpts}, launches {launches}")
        print(f"data parallel [{card}] python -m tacotron2_tpu_torch.train "
              f"under a one-rank torchrun environment: {group_line[0]}; "
              f"checkpoints {ckpts}; launches {launches}; {cli_s:.1f} s")
        print(f"data parallel [{card}] phase wall "
              f"{time.perf_counter() - t_phase:.1f} s")
        return rep0["step_launches"], rep0["mp_launches"], mp_report
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if not had_lib:
            lib.unlink(missing_ok=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built) or 'nothing (cached)'} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")

    seed = 1234
    cfg = create_config()  # the default full-width config, bf16
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(seed)).to(dev)
    enc = encoder_phase(model, dev, card)
    dec = decoder_phase(model, cfg, dev, card)
    counts, served = serving_phase(cfg, dev, card, seed)
    breakdown_phase(served, cfg, dev, card)
    fp32_phase(cfg, dev, card, seed)
    del served
    step = step_phase(model, cfg, dev, card)
    int8 = int8_phase(dev, card)
    mel = mel_phase(cfg, dev, card)
    utt = utterance_phase(cfg, dev, card, seed)
    scan_fwd, scan_bwd = scan_phase(model, cfg, dev, card)
    enc_bwd = encoder_train_phase(model, dev, card, enc)
    del model
    train_counts, train_ms = train_phase(cfg, dev, card, seed)
    trainer_counts = trainer_phase(dev, card, seed)
    enc["training_step_with_plain_version"] = encoder_swap_phase(
        cfg, dev, card, seed)
    step_check_phase(cfg, dev, card, seed)
    bench_counts, script_counts = bench_phase(cfg, dev, card, train_ms)
    BUILD.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="vocoders_", dir=BUILD))
    try:
        waveglow_phase(cfg, dev, card, seed)
        filelist, wg_path, hg_path = vocoder_train_phase(cfg, dev, card,
                                                         seed, root)
        cli_counts, http_counts = entry_points_phase(
            cfg, dev, card, seed, root, wg_path, hg_path)
        audio_counts = audio_batch_phase(dev, card, seed, filelist)
        cache_counts = cache_mels_phase(cfg, dev, card, filelist, root)
        demo_counts = demo_phase(cfg, dev, card, seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dp_counts, mp_counts, _ = dp_phase(cfg, dev, card, seed)

    enc["launches"] = counts["encoder_lstm_fwd"]
    enc["launches_training"] = train_counts["encoder_lstm_fwd"]
    dec["launches"] = counts["decoder_chunk"]
    dec["launches_stream_batch"] = utt["stream_batch"]["decoder_chunk"]
    for k in (scan_fwd, scan_bwd, enc_bwd):
        k["launches"] = train_counts[k["name"]]
    for k in (scan_fwd, scan_bwd, enc, enc_bwd):
        k["launches_trainer_phase"] = trainer_counts[k["name"]]
    step["launches"] = sum(utt[k]["decoder_step_chunk"] for k in (
        "offline_hifigan", "offline_griffin_lim", "streamed"))
    enc["launches_one_utterance"] = utt["offline_hifigan"]["encoder_lstm_fwd"]
    int8["launches"] = utt["quantized"]["int8_matmul"]
    mel["launches"] = utt["front_end"]["mel_spectrogram_fused"]
    enc["launches_http_server"] = http_counts["encoder_lstm_fwd"]
    dec["launches_http_server"] = http_counts["decoder_chunk"]
    step["launches_http_server"] = http_counts["decoder_step_chunk"]
    for k in (scan_fwd, scan_bwd, enc, enc_bwd):
        k["launches_audio_batch"] = audio_counts[k["name"]]
    mel["launches_audio_batch"] = audio_counts["mel_spectrogram_fused"]
    for k in (scan_fwd, scan_bwd, enc, enc_bwd):
        k["launches_data_parallel"] = dp_counts[k["name"]]
    enc["launches_infer_cli"] = cli_counts["encoder_lstm_fwd"]
    step["launches_infer_cli"] = cli_counts["decoder_step_chunk"]
    int8["launches_infer_cli"] = cli_counts["int8_matmul"]
    for k in (scan_fwd, scan_bwd, enc, enc_bwd):
        k["launches_bench"] = bench_counts[k["name"]]
        k["launches_model_parallel"] = mp_counts[k["name"]]
    for k in (scan_fwd, scan_bwd, enc, enc_bwd, dec, step, int8):
        k["launches_bench_scripts"] = script_counts[k["name"]]
    mel["launches_cache_mels"] = cache_counts
    enc["launches_inference_demo"] = demo_counts
    print(json.dumps({"kernels": [scan_fwd, scan_bwd, enc, enc_bwd, dec,
                                  step, int8, mel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dp_cards_main(n: int) -> int:
    """``--dp-cards N``: the data-parallel phase alone, one rank on each of
    N cards of this machine over NCCL, against one process on card 0."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: --dp-cards {n} needs {n} CUDA devices",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built) or 'nothing (cached)'} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    counts, mp_counts, _ = dp_phase(create_config(), torch.device("cuda", 0),
                                    card, 1234, ranks=n)
    print(json.dumps({"launches_data_parallel": counts,
                      "launches_model_parallel": mp_counts}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # the data-parallel phase's processes run this file with a role;
    # --dp-cards N runs that phase alone over N cards
    if sys.argv[1:2] == ["--dp-cards"]:
        sys.exit(dp_cards_main(int(sys.argv[2])))
    elif sys.argv[1:2] == ["--dp-probe"]:
        dp_probe_worker(*map(int, sys.argv[2:5]))
    elif sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6], int(sys.argv[7]))
    else:
        sys.exit(main())
