"""Serving to audio: open-loop arrivals into one ``BatchingSynthesizer``,
each mel handed, as it resolves, to one ``VocoderRunner("hifigan")``, as
``http_server.make_server`` composes them (without the HTTP).

Arrivals, texts, the synthesizer, its warm-up and the mel check are
``serve_open``'s (imported, not changed). The mel's future resolves on
the synthesizer's worker thread; its callback hands the mel to the
runner's ``submit``, which queues it for the runner's one thread and does
not block the worker. There is no fallback to the blocking call: a
program without ``submit`` stops at once. Set-up also vocodes one mel of
``max_steps`` frames on the runner's thread (cuDNN keeps its plans per
thread).

``serve_p95_ms`` is the 95th percentile over every request sent in the
window of the time from its due time to its audio resolved; a request
that fails or never comes is missing, and makes the run incorrect.

The check: ``serve_open``'s mel check (``frames_off``, ``decoder_rms``,
``postnet_gap``) on its sample (the longest text and one request a batch
slot) and on ``spread_checked`` more requests spaced evenly over the
window from a seed-drawn offset (a batch at this rate holds a few rows,
so the slots alone would all come from its first batches). Then
``samples_off``, the requests whose audio is not ``max_steps`` x hop
samples, and, over the sampled requests, the plain reference generator
(``benchmark/reference/hifigan.py``, fp32, TF32 off) fed the served
postnet mel padded to the runner's bucket as the runner pads it:
``audio_gap``, the widest gap of the served audio from it as a share of
the request's largest |value|, and ``audio_rms``, the root-mean-square
gap over all sampled audio as a share of the reference's.

Faults for the tests of the check: ``post_slope`` builds the generator
with slope 0.1 before ``conv_post``; ``alter_window`` adds half the
request's largest |value| to one 256-sample window of every audio;
``serve_open``'s ``alter_frame`` alters a mel frame.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark import weights_hifigan
from benchmark.loops import serve_open as so
from benchmark.loops.common import (Check, Outcome, Run, free, gap_share,
                                    memory_peak, sync)
from benchmark.reference import hifigan as ref
from benchmark.span_trace import SpanTracer

MEL_CHECKS = ("frames_off", "decoder_rms", "postnet_gap")
WINDOW = 256  # samples altered by the fault ``alter_window``


def vocoder_config(v: dict, slope=None):
    """The program's ``HiFiGANConfig`` from a configuration's ``vocoder``
    block (config_v1.json's keys), at ``slope`` before ``conv_post`` when
    given."""
    from tacotron2_tpu_torch.models import hifigan
    if v["lrelu_slope"] != hifigan.LRELU_SLOPE:
        raise ValueError(f"the program's slope is {hifigan.LRELU_SLOPE}")
    cfg = hifigan.HiFiGANConfig(
        n_mel_channels=v["num_mels"],
        upsample_rates=tuple(v["upsample_rates"]),
        upsample_kernel_sizes=tuple(v["upsample_kernel_sizes"]),
        upsample_initial_channel=v["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(v["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in v["resblock_dilation_sizes"]),
        post_lrelu_slope=v["post_lrelu_slope"] if slope is None else slope)
    if cfg.hop_length != v["hop_size"]:
        raise ValueError(f"hop {cfg.hop_length} against {v['hop_size']}")
    return cfg


def build_runner(r: Run):
    """The program's generator on the seed's weights, in one
    ``VocoderRunner``; with the fault ``post_slope``, at slope 0.1 before
    ``conv_post``."""
    from tacotron2_tpu_torch.models import hifigan
    from tacotron2_tpu_torch.serve import VocoderRunner
    p, v = r.traffic, r.config["vocoder"]
    cfg = vocoder_config(v, v["lrelu_slope"] if "post_slope" in r.faults
                         else None)
    with torch.device("meta"):
        gen = hifigan.Generator(cfg)
    gen.load_state_dict(weights_hifigan.generator(v, r.seed, r.device),
                        assign=True)
    runner = VocoderRunner("hifigan", gen, cfg,
                           max_frames=p["vocoder_max_frames"],
                           bucket_step=p["vocoder_bucket_step"],
                           device=r.device)
    if "alter_window" in r.faults:
        vocode = runner._vocode
        where = np.random.RandomState((r.seed + 11) % (1 << 32)).uniform()

        def altered(mel):
            audio = vocode(mel)
            at = WINDOW * int(where * (len(audio) // WINDOW))
            audio[at:at + WINDOW] += 0.5 * np.abs(audio).max()
            return audio
        runner._vocode = altered
    return runner


def spread_sample(r: Run, rec, texts) -> List[int]:
    """``spread_checked`` requests spaced evenly over the window from a
    seed-drawn offset, each one whose text was sent once."""
    n, k = len(texts), r.traffic["spread_checked"]
    if n == 0 or k == 0:
        return []
    step = n / k
    off = np.random.RandomState((r.seed + 13) % (1 << 32)).uniform(0, step)
    out = []
    for j in range(k):
        i = int(off + j * step)
        if rec.index.get(tr.text_ids(texts[i]).tobytes()) == i:
            out.append(i)
    return out


def serve(r: Run, due, texts):
    """Build the runner and the synthesizer, warm both up, and serve the
    window: (set-up seconds, ``window``'s results, the recorder, the
    memory peak)."""
    p, dev = r.traffic, r.device
    runner = build_runner(r)
    submit = runner.submit  # no fallback: a program without it stops here
    synth = so.build(r)
    rec = so.Recorder(synth, texts, r, r.faults)
    rec.chosen.update(spread_sample(r, rec, texts))
    try:
        so.warm_up(synth, r)
        mel = np.random.RandomState((r.seed + 17) % (1 << 32)).randn(
            p["max_steps"], r.config["n_mel_channels"]).astype(np.float32)
        submit(0.1 * mel).result()
        sync(dev)
        setup_s = time.perf_counter() - r.t_start
        out = window(synth, submit, rec, r, due, texts)
    finally:
        synth.close()
        rec.close()
    peak = memory_peak(dev)
    del synth, runner, submit
    free(dev)
    return setup_s, out, rec, peak


def run(r: Run) -> Outcome:
    p = r.traffic
    due = tr.arrivals(r.seed, p["rate"], r.seconds)
    texts = tr.texts(r.seed, len(due), tr.shares_of(p))
    setup_s, out, rec, peak = serve(r, due, texts)
    (t0, mel_done, done, late, served, audio, frames, samples, trace,
     window_s) = out
    sample = sorted(rec.chosen)

    lat = np.full(len(due), np.inf)
    mel_lat = np.full(len(due), np.inf)
    failed = 0
    for i, t in enumerate(done):
        if t is None:
            failed += 1
        else:
            lat[i] = (t - t0 - due[i]) * 1e3
            mel_lat[i] = (mel_done[i] - t0 - due[i]) * 1e3
    fin = np.isfinite(lat)
    p95 = float(np.percentile(lat, 95)) if failed == 0 else float("inf")

    def stats(x):
        return (f"median {np.median(x):.3f}, p95 {np.percentile(x, 95):.3f}"
                if len(x) else "none")
    peaks = [float(np.abs(a).max()) for a in audio.values()]
    notes = [f"requests {len(due)} in {r.seconds} s at {p['rate']}/s; "
             f"finished {int(fin.sum())}, failed {failed}; to the audio "
             f"{stats(lat[fin])}, max "
             f"{lat[fin].max() if fin.any() else float('nan'):.3f} ms; to "
             f"the mel {stats(mel_lat[fin])} ms; mel to audio "
             f"{stats((lat - mel_lat)[fin])} ms; sender late by median "
             f"{np.median(late) * 1e3:.3f} ms, max "
             f"{np.max(late) * 1e3:.3f} ms"
             f"{' (all of it traced)' if r.trace else ''}",
             f"checked requests {len(sample)} (the longest text, batch slots "
             f"{sorted(rec.slot.get(k, -1) for k in sample if k in rec.slot)}"
             f", the rest spread over the window); sampled audio's largest "
             f"|value| {min(peaks, default=0):.4f}-"
             f"{max(peaks, default=0):.4f}"]
    mel_r = dataclasses.replace(r, limits={k: r.limits[k]
                                           for k in MEL_CHECKS})
    checks = so.check(mel_r, texts, sample, served, rec.raw, frames)
    checks += check_audio(r, sample, served, audio, samples)
    facts = {"window_s": window_s, "batches": rec.batches,
             "requests": len(due), "texts": [len(t) for t in texts],
             "max_steps": p["max_steps"],
             "vocoded_frames": mel_bucket(p, p["max_steps"])}
    if trace is not None:
        voc = trace.program_device_s("vocoder.vocode")
        notes.append(f"device busy {trace.busy_s():.3f} s of "
                     f"{trace.window_s:.3f} s; {voc:.3f} s of it launched "
                     f"inside vocoder.vocode "
                     f"({100 * voc / max(trace.busy_s(), 1e-9):.1f}%)")
    refused = None
    if r.trace and np.median(late) * 1e3 > so.LATE_MS:
        refused = (f"traced run refused: the sender ran late by a median "
                   f"{np.median(late) * 1e3:.3f} ms (limit {so.LATE_MS} ms),"
                   f" so its trace is not of the cell's traffic")
    return Outcome(metrics={"serve_p95_ms": p95, "setup_s": setup_s},
                   checks=checks, attempted=len(due), failed=failed,
                   memory_peak_bytes=peak, facts=facts, trace=trace,
                   notes=notes, refused=refused)


def mel_bucket(p: dict, n: int) -> int:
    """The frames the runner vocodes for a mel of ``n`` frames."""
    step = p["vocoder_bucket_step"]
    return min(step * -(-n // step), max(p["vocoder_max_frames"], n))


def window(synth, submit, rec, r: Run, due, texts):
    """Send every request at its due time; each mel goes to the runner as
    it resolves; wait for the last audio (a minute past the close at
    most). A traced run's profiler starts before the first request is
    sent and stops once the last audio has come."""
    n = len(due)
    mel_done: List = [None] * n
    done: List = [None] * n
    frames: List = [None] * n
    samples: List = [None] * n
    served: Dict[int, np.ndarray] = {}
    audio: Dict[int, np.ndarray] = {}
    late = np.zeros(n)
    left = threading.Semaphore(0)
    tracer = SpanTracer(r.scratch) if r.trace else None
    trace = None

    def on_audio(i):
        def cb(f):
            if f.exception() is None:
                done[i] = time.perf_counter()
                samples[i] = int(f.result().shape[0])
                if i in rec.chosen:
                    audio[i] = f.result()
            left.release()
        return cb

    def on_mel(i):
        def cb(f):
            mel_done[i] = time.perf_counter()
            try:
                mel, _, n_frames = f.result()
                frames[i] = int(n_frames)
                if i in rec.chosen:
                    served[i] = mel
                submit(mel).add_done_callback(on_audio(i))
            except Exception as e:  # counted missing, and said why
                print(f"request {i}: {e!r}", file=sys.stderr)
                left.release()
        return cb

    rec.on = True
    if tracer is not None:
        tracer.start()
    t0 = tracer.t0 if tracer is not None else time.perf_counter()
    for i in range(n):
        wait = due[i] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - t0 - due[i]
        synth.submit(texts[i]).add_done_callback(on_mel(i))
    deadline = t0 + r.seconds + 60.0
    got = 0
    while got < n and time.perf_counter() < deadline:
        if left.acquire(timeout=max(0.0, deadline - time.perf_counter())):
            got += 1
    if tracer is not None:
        tracer.stop()
        trace = tracer.read()
    rec.on = False
    return (t0, mel_done, done, late, served, audio, frames, samples, trace,
            r.seconds)


def check_audio(r: Run, sample, served, audio, samples) -> List[Check]:
    p = r.traffic
    hop = r.config["vocoder"]["hop_size"]
    want = p["max_steps"] * hop
    off = sum(1 for s in samples if s is not None and s != want)
    checks = [Check("samples_off", float(off), r.limits["samples_off"])]
    held = ("audio_gap", "audio_rms")
    missing = [i for i in sample if i not in served or i not in audio]
    if missing or not sample:
        return checks + [Check(k, float("inf"), r.limits[k]) for k in held]
    got = audio_gaps(r.config["vocoder"], r.seed, p,
                     [served[i] for i in sample],
                     [torch.as_tensor(audio[i]) for i in sample], r.device)
    print(f"audio_gap at (request, window) {got['audio_where']}",
          file=sys.stderr)
    return checks + [Check(k, got[k], r.limits[k]) for k in held]


@torch.no_grad()
def reference_audio(v: dict, seed: int, p: dict, mels, device, rnd=None):
    """The reference generator's audio of each served mel (n, n_mels),
    zero-padded to the runner's bucket as the runner pads it, trimmed back
    to n x hop samples; fp32, TF32 off; ``rnd`` rounds both operands of
    every convolution (the control)."""
    d = ref.Dims.of(v)
    W = weights_hifigan.generator(v, seed, device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    try:
        for mel in mels:
            n = mel.shape[0]
            x = torch.zeros(1, d.n_mels, mel_bucket(p, n), device=device)
            x[0, :, :n] = torch.as_tensor(mel, dtype=torch.float32,
                                          device=device).T
            a = ref.generator(W, x, d) if rnd is None else \
                ref.generator(W, x, d, rnd)
            out.append(a[0, :n * d.hop])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def audio_gaps(v: dict, seed: int, p: dict, mels, audio, device, rnd=None,
               against=None) -> Dict[str, object]:
    """``audio_gap``, ``audio_rms`` (and ``audio_where``: the request and
    the 256-sample window of the widest gap) of ``audio`` against the
    reference's audio of ``mels``; with ``rnd``, of the reference so
    rounded against ``against`` (the fp32 reference's audio) instead."""
    if rnd is not None:
        audio, want_all = reference_audio(v, seed, p, mels, device,
                                          rnd), against
    else:
        want_all = reference_audio(v, seed, p, mels, device)
    out: Dict[str, object] = {"audio_gap": 0.0, "audio_where": None}
    num = den = 0.0
    for k, (got, want) in enumerate(zip(audio, want_all)):
        got = got.to(want.device)
        if got.shape != want.shape:
            out.update(audio_gap=float("inf"), audio_where=[k, -1])
            num = float("inf")
            continue
        gap = gap_share(got, want)
        diff = (got.double() - want.double()).abs()
        if gap >= out["audio_gap"]:
            out["audio_gap"] = gap
            out["audio_where"] = [k, int(diff.argmax()) // WINDOW]
        num += float(diff.square().sum())
        den += float(want.double().square().sum())
    out["audio_rms"] = (num / den) ** 0.5 if den > 0 else float("inf")
    return out
