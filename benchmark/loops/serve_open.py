"""Serving: open-loop arrivals into one ``BatchingSynthesizer``.

The traffic file fixes the rate; a run sends round(rate x seconds)
requests at the due times of the seed's schedule (``traffic.arrivals``),
texts drawn by LJSpeech's bucket shares. The stop gate is made never to
fire (zero weight, a negative bias), so every request decodes exactly
``max_steps`` frames whatever the seed. Set-up builds the synthesizer and
serves one full batch of each text bucket, on its worker thread, so that
every shape the window meets is built and planned.

``serve_p95_ms`` is the 95th percentile over every request sent in the
window of the time from its due time to its mel reaching the caller (the
future resolved); a request that fails or never comes is counted
missing, and makes the run incorrect.

The check: a sample of the finished requests, the longest text and one
request in each batch slot (row of the synthesizer's fixed-shape batch),
the slots in an order drawn from the seed, each from another batch, the
batches spread over the window. The reference (fp32, TF32 off) encodes
each text
and is fed the frames the program decoded (teacher forcing on the served
frames, as a served model's tokens are checked): the widest gap of a
decoded frame from the reference's prediction, as a share of the
request's largest |value|, and likewise of the served postnet output from
the reference's postnet over those frames. The decoder's raw frames are
taken from the program's result as its batch function returns them.

A traced run starts the profiler before the first request is sent and
stops it once the last answer has come (its start and its stop take
seconds of host time), tracing every request; it gives no result when
the sender fell behind its schedule there.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark import weights
from benchmark.loops.common import (Check, Outcome, Run, free, gap_share,
                                      memory_peak, model_config, sync)
from benchmark.reference import tacotron2 as ref
from benchmark.reference.precision import rounding
from benchmark.trace import Tracer, span


def build(r: Run):
    """The program's model (the seed's weights, the gate that never
    fires) and its synthesizer."""
    from tacotron2_tpu_torch.models import tacotron2 as tm
    from tacotron2_tpu_torch.serve import BatchingSynthesizer
    p, c = r.traffic, r.config
    cfg = model_config(c)
    sd = weights.tacotron2(c, r.seed, r.device, gate_bias=p["gate_bias"])
    with torch.device("meta"):
        model = tm.Tacotron2(cfg)
    model.load_state_dict(sd, assign=True)
    synth = BatchingSynthesizer(model, cfg, max_batch=p["max_batch"],
                                max_wait_ms=p["max_wait_ms"],
                                max_steps=p["max_steps"], device=r.device)
    return synth


LATE_MS = 5.0  # a traced run's largest median lateness of the sender


class Recorder:
    """Wraps the synthesizer's batch call (host ms to the returned numpy,
    rows) and the model's batch function (a span for the device trace;
    the sample, with the raw decoded frames of its requests)."""

    def __init__(self, synth, texts: List[str], r: Run, faults=()):
        from tacotron2_tpu_torch.models import tacotron2 as tm
        p = r.traffic
        self.batches: List[tuple] = []   # (t0, t1, rows, T_in)
        self.raw: Dict[int, torch.Tensor] = {}
        self.slot: Dict[int, int] = {}   # sampled request -> its batch slot
        count: Dict[bytes, int] = {}
        self.index: Dict[bytes, int] = {}  # texts sent once -> request
        for i, t in enumerate(texts):
            k = tr.text_ids(t).tobytes()
            count[k] = count.get(k, 0) + 1
            self.index.setdefault(k, i)
        self.index = {k: i for k, i in self.index.items() if count[k] == 1}
        self.longest = int(np.argmax([len(t) for t in texts])) \
            if texts else None
        self.chosen = {self.longest} if texts else set()
        # one request a slot, in a seed-drawn order of slots, each from
        # every stride-th batch of the window, from a seed-drawn offset
        rng = np.random.RandomState((r.seed + 7) % (1 << 32))
        k = min(p["checked_requests"], p["max_batch"])
        self.slots = [int(x) for x in rng.permutation(p["max_batch"])[:k]]
        self.stride = max(1, len(texts) // p["max_batch"] // max(k, 1))
        self.offset = int(rng.randint(self.stride))
        self.n_batches = 0
        self.on = False
        infer, fused = synth._infer, tm.infer_batch_fused
        rec = self

        def _infer(text, lengths):
            t0 = time.perf_counter()
            out = infer(text, lengths)
            if rec.on:
                rows = int((text[:, 0] != 0).sum())
                rec.batches.append((t0, time.perf_counter(), rows,
                                    text.shape[1]))
            return out

        def infer_batch_fused(model, text, lengths, *a, **kw):
            rows = int((text[:, 0] != 0).sum())
            with span("serve_batch", text.shape[0], text.shape[1], rows,
                      kw.get("max_steps")):
                res = fused(model, text, lengths, *a, **kw)
            if "alter_frame" in faults:
                res.mel_postnet[:, 10, 0] += 1.0
            if rec.on:
                rec.take(text, lengths, rows, res.mel)
            return res

        synth._infer = _infer
        tm.infer_batch_fused = infer_batch_fused
        self._restore = lambda: setattr(tm, "infer_batch_fused", fused)

    def take(self, text, lengths, rows: int, mel: torch.Tensor) -> None:
        """Keep the decoded frames of the batch's sampled requests: the
        longest text, and one request in the first slot still wanted that
        the batch fills (every stride-th batch)."""
        t = text.numpy()
        req = [self.index.get(t[i, :int(lengths[i])].astype(
            np.int64).tobytes()) for i in range(rows)]
        j = self.n_batches
        self.n_batches += 1
        if j % self.stride == self.offset:
            for s in self.slots:
                if s < rows and req[s] is not None \
                        and req[s] not in self.chosen:
                    self.slots.remove(s)
                    self.chosen.add(req[s])
                    self.slot[req[s]] = s
                    break
        for i, k in enumerate(req):
            if k is not None and k in self.chosen and k not in self.raw:
                self.raw[k] = mel[i].clone()
                self.slot.setdefault(k, i)

    def close(self):
        self._restore()


def warm_up(synth, r: Run) -> None:
    """One full batch of each text bucket, on the worker thread."""
    p = r.traffic
    rng = np.random.RandomState((r.seed + 5) % (1 << 32))
    lo = 8
    for b in r.config["text_buckets"]:
        texts = [tr.make_text(rng, int(rng.randint(max(lo, b - 20), b + 1)))
                 for _ in range(p["max_batch"])]
        for f in [synth.submit(t) for t in texts]:
            f.result()
        lo = b + 1


def run(r: Run) -> Outcome:
    p, dev = r.traffic, r.device
    due = tr.arrivals(r.seed, p["rate"], r.seconds)
    texts = tr.texts(r.seed, len(due), tr.shares_of(p))
    synth = build(r)
    rec = Recorder(synth, texts, r, r.faults)
    try:
        warm_up(synth, r)
        sync(dev)
        setup_s = time.perf_counter() - r.t_start
        out = window(synth, rec, r, due, texts)
    finally:
        synth.close()
        rec.close()
    peak = memory_peak(dev)
    t0, done, late, served, frames, trace, window_s = out
    del synth
    free(dev)
    sample = sorted(rec.chosen)

    lat = np.full(len(due), np.inf)
    failed = 0
    for i, t in enumerate(done):
        if t is None:
            failed += 1
        else:
            lat[i] = (t - t0 - due[i]) * 1e3
    finite = lat[np.isfinite(lat)]
    p95 = float(np.percentile(lat, 95)) if failed == 0 else float("inf")
    notes = [f"requests {len(due)} in {r.seconds} s at {p['rate']}/s; "
             f"finished {len(finite)}, failed {failed}; latency median "
             f"{np.median(finite) if len(finite) else float('nan'):.3f} ms, "
             f"p95 {p95:.3f} ms, max "
             f"{finite.max() if len(finite) else float('nan'):.3f} ms; "
             f"generator late by median {np.median(late) * 1e3:.3f} ms, "
             f"p95 {np.percentile(late, 95) * 1e3:.3f} ms, max "
             f"{np.max(late) * 1e3:.3f} ms"
             f"{' (all of it traced)' if r.trace else ''}",
             f"checked requests {len(sample)}, the longest text among them, "
             f"in batch slots {sorted(rec.slot.get(k, -1) for k in sample)}"]
    checks = check(r, texts, sample, served, rec.raw, frames)
    facts = {"window_s": window_s, "batches": rec.batches,
             "requests": len(due), "texts": [len(t) for t in texts],
             "max_steps": p["max_steps"]}
    refused = None
    if r.trace and np.median(late) * 1e3 > LATE_MS:
        refused = (f"traced run refused: the sender ran late by a median "
                   f"{np.median(late) * 1e3:.3f} ms (limit {LATE_MS} ms), "
                   f"so its trace is not of the cell's traffic")
    return Outcome(metrics={"serve_p95_ms": p95, "setup_s": setup_s},
                   checks=checks, attempted=len(due), failed=failed,
                   memory_peak_bytes=peak, facts=facts, trace=trace,
                   notes=notes, refused=refused)


def window(synth, rec, r: Run, due, texts):
    """Send every request at its due time; wait for the last answers (a
    minute past the close at most). A traced run's profiler starts before
    the first request is sent and stops once the last answer has come,
    so that neither its start nor its stop (seconds of host time each)
    holds up a request."""
    n = len(due)
    done: List = [None] * n
    frames: List = [None] * n
    served: Dict[int, np.ndarray] = {}
    late = np.zeros(n)
    left = threading.Semaphore(0)
    tracer = Tracer(r.scratch) if r.trace else None
    trace = None

    def finish(i):
        def cb(f):
            done[i] = time.perf_counter()
            if f.exception() is None:
                res = f.result()
                frames[i] = int(res[2])
                if i in rec.chosen:
                    served[i] = res[0]
            else:
                done[i] = None
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
        synth.submit(texts[i]).add_done_callback(finish(i))
    deadline = t0 + r.seconds + 60.0
    got = 0
    while got < n and time.perf_counter() < deadline:
        if left.acquire(timeout=max(0.0, deadline - time.perf_counter())):
            got += 1
    if tracer is not None:
        tracer.stop()
        trace = tracer.read()
    rec.on = False
    return t0, done, late, served, frames, trace, r.seconds


def check(r: Run, texts, sample, served, raw, frames) -> List[Check]:
    p, c, dev = r.traffic, r.config, r.device
    steps = p["max_steps"]
    wrong_len = sum(1 for f in frames if f is not None and f != steps)
    checks = [Check("frames_off", float(wrong_len), 0.0)]
    missing = [i for i in sample if i not in served or i not in raw]
    held = [k for k in r.limits if k != "frames_off"]
    if missing:
        return checks + [Check(k, float("inf"), r.limits[k]) for k in held]
    got = reference_gaps(c, r.seed, p["gate_bias"], [texts[i] for i in sample],
                         [raw[i] for i in sample],
                         [torch.as_tensor(served[i]) for i in sample], dev)
    print("readings not held to a limit: " + ", ".join(
        f"{k} {v!r}" for k, v in got.items() if k not in held),
        file=sys.stderr)
    return checks + [Check(k, got[k], r.limits[k]) for k in held]


def reference_gaps(c: dict, seed: int, gate_bias: float, texts, raw, served,
                   device, precision=None, against=None) -> Dict[str, float]:
    """The reference fed the decoded frames ``raw`` (one (S, n_mels) a
    request): the widest gaps of the decoded frames and of the served
    postnet output ``served`` from the reference's predictions, each a
    share of the request's largest |value| (``*_gap``, with where the
    widest lies: request, frame, frames within half of it), and the
    root-mean-square gaps over every sampled frame as a share of the
    reference's (``*_rms``). ``precision`` computes the
    reference in a lower precision (the control); ``against`` then holds
    the fp32 reference's predictions to be compared with instead."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        preds = reference_predictions(c, seed, gate_bias, texts, raw, device,
                                      precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out = {"decoder_gap": 0.0, "postnet_gap": 0.0}
    sq = {"decoder": [0.0, 0.0], "postnet": [0.0, 0.0]}
    for k in range(len(texts)):
        want_dec, want_post = (against or preds)[k]
        got_dec = preds[k][0] if against else raw[k].to(device)
        got_post = preds[k][1] if against else served[k].to(device)
        for name, got, want in (("decoder", got_dec, want_dec),
                                ("postnet", got_post, want_post)):
            gap = gap_share(got, want)
            if gap > out[name + "_gap"]:
                out[name + "_gap"] = gap
                # where the widest gap lies, and how alone it is
                diff = (got.double() - want.double()).abs().amax(-1)
                out[name + "_where"] = [k, int(diff.argmax()), int(
                    (diff > 0.5 * diff.max()).sum())]
            sq[name][0] += float((got.double() - want.double()).square()
                                 .sum())
            sq[name][1] += float(want.double().square().sum())
    for name, (num, den) in sq.items():
        out[name + "_rms"] = (num / den) ** 0.5
    return out


@torch.no_grad()
def reference_predictions(c, seed, gate_bias, texts, raw, device,
                          precision=None):
    """(predicted frames, postnet output over the decoded frames) of each
    request. Requests run in one batch a text bucket, each text padded
    with symbol 0 to its bucket, as the synthesizer pads it: the encoder's
    convolutions read a few padded positions past a text's end."""
    d = ref.Dims.of(c)
    W = weights.tacotron2(c, seed, device, gate_bias=gate_bias)
    net = ref.Net(W, d, rounding(precision))
    ids = [tr.text_ids(t) for t in texts]
    buckets = [tr.bucket_of(len(a), c["text_buckets"]) for a in ids]
    out = [None] * len(texts)
    for bucket in sorted(set(buckets)):
        group = [k for k, b in enumerate(buckets) if b == bucket]
        x = torch.zeros(len(group), bucket, dtype=torch.long, device=device)
        for row, k in enumerate(group):
            x[row, :len(ids[k])] = torch.from_numpy(ids[k]).to(device)
        lens = torch.tensor([len(ids[k]) for k in group], device=device)
        frames = torch.stack([raw[k].to(device).float() for k in group])
        go = torch.zeros_like(frames[:, :1])
        memory = net.encode(x, lens)
        mel, _, _ = net.decode(memory, lens,
                               torch.cat([go, frames[:, :-1]], 1))
        post = frames + net.postnet(frames)
        for row, k in enumerate(group):
            out[k] = (mel[row], post[row])
    return out
