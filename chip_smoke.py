#!/usr/bin/env python3
"""Drive the port's batched serving path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, without
them or outside a checkout of the repository. Phases, each of which raises
on failure:

1. the card's name and power limit (nvidia-smi);
2. build both CUDA kernels from ``tacotron2_tpu_torch/kernels/csrc``;
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
   (max_steps=32) against the plain path on the CPU.

The second-to-last line is the ``kernels`` JSON object (times, bounds,
launches, errors); the last is the device line.
"""

from __future__ import annotations

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
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.ops.lstm import _reverse_by_length, lstm_weights
from tacotron2_tpu_torch.serve import BatchingSynthesizer
from tacotron2_tpu_torch.text import text_to_sequence

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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    print(f"profile [{card}] bf16 B=8 T_in=128 64 steps: device window "
          f"{end - start:.1f} us, kernels {busy:.1f} us, idle share "
          f"{1 - busy / (end - start):.3f}; by kernel (calls, us per call): "
          + "; ".join(f"{k} {n} x {t / n:.2f}" for k, (n, t) in top))


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

    enc["launches"] = counts["encoder_lstm_fwd"]
    dec["launches"] = counts["decoder_chunk"]
    print(json.dumps({"kernels": [enc, dec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
