#!/usr/bin/env python3
"""Drive the port's batched serving path and its training step on one CUDA
card and check them.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, without
them or outside a checkout of the repository. Phases, each of which raises
on failure:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel source of ``tacotron2_tpu_torch/kernels/csrc``;
3. encoder BiLSTM kernel against its plain version at full width (B=8,
   T=128, N=512, H=256, bf16), timed beside cuDNN's bidirectional LSTM;
4. decoder chunk kernel against its plain version at full width (B=8,
   T_in=128, one 64-step chunk, bf16; again with prenet keep masks; once at
   fp32), every output and carry field within its own limit (DEC_REL), and
   the same comparison must reject the kernel's output with its attention
   perturbed;
5. serving: ``BatchingSynthesizer(max_batch=8)`` at the default config with
   seeded random weights answers 16 requests in the 64 and 128 text
   buckets (bf16, max_steps=200); both kernels' launch counts must rise
   and the plain versions must not run. Then a short fp32 run
   (max_steps=32) against the plain path on the CPU;
6. the training kernels at bench.py's shape (B=128, T_in=128, bf16): the
   decoder forward scan and backward chain against their plain versions
   over 64 and 512 steps, the encoder BiLSTM forward and backward at B=128,
   each field within its limit and perturbed outputs rejected;
7. training: ``train_step`` at B=128, T_in=128, T_out=512, bf16 (one warm
   step, three timed): every training kernel must launch and no plain
   version run; a breakdown by stage and a profile of one step;
8. one fp32 training step on the card against the CPU plain versions, then
   with cuDNN's convolutions, and each convolution against fp64.

The second-to-last line is the ``kernels`` JSON object (times, bounds,
launches, errors); the last is the device line.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from tacotron2_tpu_torch.config import create_config
from tacotron2_tpu_torch.data.bucketing import text_bucket
from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import encoder_lstm as el
from tacotron2_tpu_torch.kernels import train_scan as ts
from tacotron2_tpu_torch.kernels.lstm_layout import from_blocks
from tacotron2_tpu_torch.models import decoder_vjp as dv
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.ops.lstm import _reverse_by_length, lstm_weights
from tacotron2_tpu_torch.serve import BatchingSynthesizer
from tacotron2_tpu_torch.text import text_to_sequence
from tacotron2_tpu_torch.training import state as tstate

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is max(bytes / HBM rate, FLOPs / peak for its operand type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ENC_TOL = (3e-2, 5e-2)     # (atol, rtol): bf16 operand rounding flips
# Decoder chunk, kernel against its plain version: the largest |err| of
# each output and carry field, as a share of the field's largest |value|.
# The two share every cast point and differ only in the order of fp32 sums,
# which now and then flips the rounding of a bf16 operand. Each limit is
# about ten times the worst reading of its field on the card, over this
# script's chunks and those of tests/test_torch_kernels_gpu.py, which holds
# the same table.
DEC_FIELDS = ("mel", "gate", "align", "h1", "c1", "h2", "c2", "w", "wc",
              "ctx", "prev")
DEC_REL = {
    torch.bfloat16: dict(mel=2e-2, gate=9e-2, align=2e-2, h1=2e-2, c1=2e-2,
                         h2=8e-3, c2=9e-3, w=2e-2, wc=3e-3, ctx=5e-3,
                         prev=2e-2),
    torch.float32: dict(mel=6e-6, gate=4e-5, align=4e-6, h1=3e-6, c1=3e-6,
                        h2=3e-6, c2=2e-6, w=3e-6, wc=3e-6, ctx=3e-6,
                        prev=5e-6),
}
SERVE_TOL_FP32 = (1e-3, 1e-3)  # 32 fp32 steps, card against CPU plain path

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


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


# ------------------------------------------------------------------ phases

def encoder_phase(model, dev, card):
    B, T = 8, 128
    lstm = model.encoder.lstm
    N, H = lstm.input_size, lstm.hidden_size
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    xs = torch.relu(torch.randn(B, T, N, generator=g, device=dev))
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)
    lengths[0] = T
    xsr = _reverse_by_length(xs, lengths).to(bf16).contiguous()
    xs = xs.to(bf16).contiguous()
    wf, bf = el.pack_direction(lstm_weights(lstm, "_l0"), bf16)
    wb, bb = el.pack_direction(lstm_weights(lstm, "_l0_reverse"), bf16)
    args = (wf, bf, wb, bb, xs, xsr)
    got = el.bilstm_forward(*args)
    want = el.bilstm_forward_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("gf", "gb", "hf", "hb", "cf", "cb"), got, want):
        e, ok = worst(a, b, ENC_TOL)
        err = max(err, e)
        if not ok:
            fail(f"encoder kernel disagrees with its plain version on {name}:"
                 f" max |err| {e} beyond atol/rtol {ENC_TOL}")
    ms = cuda_ms(lambda: el.bilstm_forward(*args), iters=20)
    plain_ms = cuda_ms(lambda: el.bilstm_forward_plain(*args),
                       iters=3, warmup=1)
    ref = torch.nn.LSTM(N, H, batch_first=True, bidirectional=True).to(dev)
    ref.load_state_dict(lstm.state_dict())
    ref = ref.to(bf16)
    ref.flatten_parameters()
    with torch.no_grad():
        library_ms = cuda_ms(lambda: ref(xs), iters=20)
    K = N + H
    nbytes = (2 * B * T * N * 2 + 2 * (K * 4 * H * 2 + 4 * H * 4)
              + 2 * T * B * (4 * H * 2 + H * 2 + H * 4))
    flops = 2 * 2 * T * B * K * 4 * H
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    print(f"encoder [{card}] B={B} T={T} N={N} H={H} bf16: max |err| {err:.3e}"
          f" (atol {ENC_TOL[0]}, rtol {ENC_TOL[1]}); kernel {ms:.4f} ms, plain"
          f" {plain_ms:.4f} ms, cuDNN bidirectional LSTM {library_ms:.4f} ms,"
          f" bound {bound_ms:.5f} ms ({bound_by})")
    return {"name": "encoder_lstm_fwd", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/encoder_lstm.cu",
            "replaces": "tacotron2_tpu/kernels/encoder_lstm.py:71",
            "max_abs_err": err, "tolerance": {"atol": ENC_TOL[0],
                                              "rtol": ENC_TOL[1]},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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


def decoder_phase(model, cfg, dev, card):
    B, T, cs = 8, 128, 64
    results = {}
    for dtype, label in ((torch.bfloat16, "bf16"),
                         (torch.bfloat16, "bf16+keep"),
                         (torch.float32, "fp32")):
        limits = DEC_REL[dtype]
        fp = db.pack_batch_decoder_params(model, dtype)
        mem, proc, emask, carry, g = _chunk_inputs(model, cfg, dev,
                                                   dtype, B, T)
        kp = (None, None)
        if label == "bf16+keep":
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
        if label == "bf16":
            _check_catches(got, want, limits)
        ms = cuda_ms(lambda: db.decoder_chunk(*args, **kw), iters=5)
        plain_ms = cuda_ms(lambda: db.decoder_chunk_plain(*args, **kw),
                           iters=2, warmup=1)
        nbytes, flops = _decoder_work(fp, B, T, cs, kp[0] is not None,
                                      cfg.attention_location_n_filters)
        bound_ms, bound_by = bound(nbytes, flops, "float32"
                                   if dtype == torch.float32 else "bfloat16")
        print(f"decoder [{card}] {label} B={B} T_in={T} chunk={cs}: max |err|"
              f" {err:.3e}; finished "
              f"{int(got.carry.fin.sum())}/{B}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        results[label] = dict(max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
    r = results["bf16"]
    return {"name": "decoder_chunk", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/decoder_batch.cu",
            "replaces": "tacotron2_tpu/kernels/decoder_batch.py:107",
            "max_abs_err": max(results["bf16"]["max_abs_err"],
                               results["bf16+keep"]["max_abs_err"]),
            "tolerance": {"share_of_field_max": DEC_REL[torch.bfloat16]},
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "fp32": {k: results["fp32"][k] for k in
                     ("max_abs_err", "ms", "plain_ms", "bound_ms")}}


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


def _decoder_work(fp, B, T, cs, keep, n_filters):
    """Bytes one chunk call must move (each input read once, each output
    written once) and the FLOPs of its products (2 per multiply-add)."""
    n, p = fp.pre1.shape
    nb1, k1, cols = fp.w1.shape            # block-major LSTM weights
    nb2, k2, _ = fp.w2.shape
    a4, d4 = nb1 * cols, nb2 * cols
    a, d = a4 // 4, d4 // 4
    ks, _, datt = fp.k2.shape
    e = k2 - a - d
    size = lambda x: x.numel() * x.element_size()
    nbytes = sum(size(x) for x in fp)
    wsz = fp.w1.element_size()
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


def serving_phase(cfg, dev, card, seed):
    for texts, bucket in ((SHORT_TEXTS, 64), (LONG_TEXTS, 128)):
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
    return counts, model


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


def profile_kernels(run, top: int) -> str:
    """torch.profiler over one run(): the device window, the kernels' busy
    time, the idle share and the ``top`` kernels by total time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        fail("the profiler saw no device activity")
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
    """The serving path at fp32 for 32 steps: kernels on the card against
    the plain versions on the CPU, same seeded weights and texts."""
    cfg32 = cfg.replace(compute_dtype="float32")
    texts = SHORT_TEXTS[:4] + LONG_TEXTS[:4]
    outs = {}
    for device in (dev, torch.device("cpu")):
        model = tm.Tacotron2(cfg32, torch.Generator().manual_seed(seed))
        synth = BatchingSynthesizer(model, cfg32, max_batch=8, max_steps=32,
                                    max_wait_ms=50.0, device=device)
        try:
            outs[device.type] = synth.synthesize(texts)
        finally:
            synth.close()
    err = 0.0
    for text, (mg, ag, ng), (mc, ac, nc) in zip(texts, outs["cuda"],
                                                 outs["cpu"]):
        if ng != nc:
            fail(f"fp32 {text!r}: {ng} frames on the card, {nc} on the CPU")
        for a, b in ((mg, mc), (ag, ac)):
            e, ok = worst(torch.from_numpy(a), torch.from_numpy(b),
                          SERVE_TOL_FP32)
            err = max(err, e)
            if not ok:
                fail(f"fp32 {text!r}: card and CPU plain path differ by {e}")
    print(f"fp32 serving [{card}] 8 requests, 32 steps: kernels on the card "
          f"against the plain path on the CPU, max |err| {err:.3e} (atol "
          f"{SERVE_TOL_FP32[0]}, rtol {SERVE_TOL_FP32[1]})")


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
    A, D = sw.wq.shape[0], sw.wtd.shape[0] // 4
    K1, K2 = sw.wta.shape[1], sw.wtd.shape[1]
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
    bwd_b = (size(sw.wta, sw.wtd, sw.wq, sw.wqt, sw.k2, sw.vf) + per_batch
             + res_b + sb * (D + E + T_in) * 4 + keep_b
             + sb * ((4 * A + 4 * D + E) * w + (P + datt) * 4)
             + B * T_in * datt * 4 + (ks * 2 * datt + datt) * 4)
    bwd_macs = (4 * D * K2 + 4 * A * K1 + 2 * A * datt + T_in * E
                + T_in * datt + 3 * loc)
    return (fwd_b, 2.0 * sb * fwd_macs), (bwd_b, 2.0 * sb * bwd_macs)


def scan_phase(model, cfg, dev, card):
    """Rows 1 and 2 at bench width (B=128, T_in=128, bf16, dropout on):
    field by field over 64 steps, with perturbed outputs rejected; then
    both over the full 512 steps, held and timed, the backward from the
    plain forward's residuals."""
    B, T_in = TRAIN_SHAPE["B"], TRAIN_SHAPE["T_in"]
    fwd_names, bwd_names = ts.Residuals._fields, ts.ChainGrads._fields
    out = {}
    for steps, seed in ((64, 21), (TRAIN_SHAPE["T_out"], 22)):
        sw, inp, kw, cots = _scan_inputs(model, cfg, dev, B, T_in, steps,
                                         seed)
        got = ts.forward_residuals(sw, *inp, **kw)
        want = ts.forward_residuals_plain(sw, *inp, **kw)
        torch.cuda.synchronize()
        ferr = check_fields(f"scan forward, {steps} steps", got, want,
                            fwd_names, SCAN_FWD_REL)
        args = (sw, want, inp[1], inp[2], *cots)
        gk = ts.backward_chain(*args, **kw)
        gp = ts.backward_chain_plain(*args, **kw)
        torch.cuda.synchronize()
        berr = check_fields(f"scan backward, {steps} steps", gk, gp,
                            bwd_names, SCAN_BWD_REL)
        for label, errs in (("forward", ferr), ("backward", berr)):
            print(f"train scan [{card}] {label} B={B} T_in={T_in} {steps} "
                  f"steps bf16: max |err| by field, as a share of the "
                  f"field's largest |value| (limit): " + ", ".join(
                      f"{k} {r:.2e} ({lim[k]})" for k, (_, r) in errs.items()
                      for lim in [SCAN_FWD_REL if label == "forward"
                                  else SCAN_BWD_REL]))
        if steps == 64:
            must_reject("attention w shifted one position",
                        got._replace(w=torch.roll(got.w, 1, dims=2)), want,
                        fwd_names, SCAN_FWD_REL)
            must_reject("d_processed x 1.05",
                        gk._replace(d_processed=gk.d_processed * 1.05), gp,
                        bwd_names, SCAN_BWD_REL)
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
        for name, line, errs, ms, plain, (nb, nf) in (
                ("train_scan_fwd", 354, ferr, fwd_ms, fwd_plain, (fb, ff)),
                ("train_scan_bwd", 619, berr, bwd_ms, bwd_plain, (bb, bf))):
            bound_ms, bound_by = bound(nb, nf, "bfloat16")
            print(f"train scan [{card}] {name} B={B} T_in={T_in} {steps} "
                  f"steps bf16 with dropout: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            out[name] = {
                "name": name, "route": "cuda",
                "source": "tacotron2_tpu_torch/kernels/csrc/train_scan.cu",
                "replaces": f"tacotron2_tpu/kernels/train_scan.py:{line}",
                "max_abs_err": max(e for e, _ in errs.values()),
                "tolerance": {"share_of_field_max": SCAN_FWD_REL
                              if name.endswith("fwd") else SCAN_BWD_REL},
                "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
        del got, want, gk, gp, args
    return out["train_scan_fwd"], out["train_scan_bwd"]


def encoder_train_phase(model, dev, card, enc):
    """Row 4 at B=128, T=128, bf16 against its plain version, timed beside
    cuDNN's bidirectional LSTM backward; row 3 re-timed at B=128."""
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
    gf, gb, _, _, cf, cb = fwd
    wtf, wtb = (from_blocks(w).t().contiguous() for w in (packed.wf,
                                                          packed.wb))
    dhf, dhb = (torch.randn(T, B, H, generator=g, device=dev) * 0.1
                for _ in range(2))
    args = (wtf, wtb, gf, gb, cf, cb, dhf, dhb)
    got = el.bilstm_backward(*args)
    want = el.bilstm_backward_plain(*args)
    torch.cuda.synchronize()
    names = ("dgf", "dgb", "dxf", "dxb")
    errs = check_fields("encoder backward", got, want, names, ENC_BWD_REL)
    ms = cuda_ms(lambda: el.bilstm_backward(*args), iters=5)
    plain_ms = cuda_ms(lambda: el.bilstm_backward_plain(*args), iters=1,
                       warmup=0)
    ref = torch.nn.LSTM(N, H, batch_first=True, bidirectional=True).to(dev)
    ref.load_state_dict(lstm.state_dict())
    ref = ref.to(bf16)
    ref.flatten_parameters()
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: ref(xs), iters=10)
    xg = xs.detach().requires_grad_(True)
    out, _ = ref(xg)
    gout = torch.randn(out.shape, generator=g, device=dev).to(bf16)
    leaves = [xg, *ref.parameters()]
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, gout,
                                                  retain_graph=True),
                      iters=10)
    K = N + H
    wsz = 2
    nbytes = (2 * 4 * H * K * wsz + 2 * T * B * (4 * H * wsz + 2 * H * 4)
              + 2 * T * B * (4 * H * wsz + N * 4))
    flops = 2 * T * 2 * B * 4 * H * K
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    f_bytes = (2 * B * T * N * wsz + 2 * (K * 4 * H * wsz + 4 * H * 4)
               + 2 * T * B * (4 * H * wsz + H * wsz + H * 4))
    f_bound, f_by = bound(f_bytes, flops, "bfloat16")
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
          f"forward {lib_fwd:.4f} ms, bound {f_bound:.5f} ms ({f_by})")
    enc["at_training_shape"] = {
        "B": B, "T": T, "max_abs_err": max(e for e, _ in fwd_errs.values()),
        "tolerance": {"share_of_field_max": ENC_FWD_REL}, "ms": fwd_ms,
        "plain_ms": fwd_plain, "bound_ms": f_bound, "bound_by": f_by,
        "library_ms": lib_fwd}
    return {"name": "encoder_lstm_bwd", "route": "cuda",
            "source": "tacotron2_tpu_torch/kernels/csrc/encoder_lstm.cu",
            "replaces": "tacotron2_tpu/kernels/encoder_lstm.py:156",
            "max_abs_err": max(e for e, _ in errs.values()),
            "tolerance": {"share_of_field_max": ENC_BWD_REL},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_bwd}


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
    stage."""
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
    return counts


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
    scan_fwd, scan_bwd = scan_phase(model, cfg, dev, card)
    enc_bwd = encoder_train_phase(model, dev, card, enc)
    del model
    train_counts = train_phase(cfg, dev, card, seed)
    step_check_phase(cfg, dev, card, seed)

    enc["launches"] = counts["encoder_lstm_fwd"]
    enc["launches_training"] = train_counts["encoder_lstm_fwd"]
    dec["launches"] = counts["decoder_chunk"]
    for k in (scan_fwd, scan_bwd, enc_bwd):
        k["launches"] = train_counts[k["name"]]
    print(json.dumps({"kernels": [scan_fwd, scan_bwd, enc, enc_bwd, dec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
