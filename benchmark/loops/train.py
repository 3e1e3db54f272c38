"""Training: ``Trainer.fit`` over an LJSpeech-shaped corpus of precomputed
mels (``load_mel_from_disk``), written at set-up under the run's scratch
directory.

Set-up builds one ``Trainer`` (weights from the seed), drives it through
its first three steps for the check (one ``fit`` call each for step 1 and
steps 2-3, so that the state can be read between them), then through the
rest of the corpus's first epoch, which meets every batch shape the
window will. The window is one ``fit`` call of a fixed number of steps,
as many as the warm-up's rate fits into ``--seconds``, from the call to a
synchronise after it returns; ``train_frames_per_s`` counts the unpadded
mel frames of the batches those steps took, as the pipeline handed them
over. The checkpoint the trainer writes at the end of every ``fit`` call
is not written (the window measures training, not saving; in a run of
the reference's recipe the first save falls at step 1000).

The check: the reference (``reference/tacotron2.py``, fp32, TF32 off)
follows two stretches of the program's steps on the same rows, with the
same dropout masks drawn again from the same seeds in the program's
order, and the reference's optimiser: the first three steps, from the
weights the benchmark drew from the seed (the start), and the window's
last two steps, from the program's state as it stood before them (its
parameters, Adam moments and count, copied inside the window). Compared
in each: each leaf's norm of the first effective gradient (the
program's from its Adam moments before and after the stretch's first
step) and of the parameters' change over the stretch; leaves by the
worst one, against the reference's norm of the leaf or of the median
leaf, whichever is larger. Leaves whose reference gradient is below a
thousandth of the median leaf's (the conv biases before batchnorm) are
left out of the change. The numbers without a limit (each stretch's
worst loss gap; the window's median leaf, which the control does not
read three times higher) are printed.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark import weights
from benchmark.loops.common import (Check, Outcome, Run, free, memory_peak,
                                      model_config, sync)
from benchmark.reference import optim
from benchmark.reference import tacotron2 as ref
from benchmark.reference.precision import rounding
from benchmark.trace import Tracer, span

TRAIN_STREAM = 0  # the program's stream of derived training seeds
N_CHECKED = 3     # the first steps, followed from the seed's weights
N_WINDOW = 2      # the window's last steps, followed from the program's state
WINDOW = "window_"  # the prefix of the window's numbers


def derived_seed(*parts: int) -> int:
    """A generator seed from integers, as the program's Trainer seeds each
    step's dropout (``training/trainer.py:derived_generator``)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(
        1, np.uint64)[0]) >> 1


class Corpus:
    """Texts and mel frames of the run's utterances, and the filelist of
    their ``.npy`` mels."""

    def __init__(self, run: Run, p: dict):
        c = run.config
        n = p["utterances"]
        self.lengths, self.frames = tr.corpus_lengths(
            run.seed, n, p["frames_per_char"], p["frame_jitter"],
            c["max_mel_length"], tr.shares_of(p))
        rng = np.random.RandomState((run.seed + 3) % (1 << 32))
        self.texts = [tr.make_text(rng, int(k)) for k in self.lengths]
        self.index = {tr.text_ids(t).tobytes(): i
                      for i, t in enumerate(self.texts)}
        self.offsets = np.concatenate([[0], np.cumsum(self.frames)])
        self.n_mels = c["n_mel_channels"]
        self.p = p
        self.seed = run.seed

    def mels(self, device) -> torch.Tensor:
        """Every utterance's frames, (total frames, n_mels), fp32, drawn
        on ``device`` in one call: log-mel-like values."""
        g = torch.Generator(device=device).manual_seed(
            (self.seed * 7919 + 11) % (1 << 63))
        total = int(self.offsets[-1])
        m = torch.randn(total, self.n_mels, generator=g, device=device)
        m = m * self.p["mel_std"] + self.p["mel_mean"]
        # the values as the files hold them
        return m.to(self.dtype).float()

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.p.get("mel_dtype", "float32"))

    def write(self, directory: str, device) -> str:
        os.makedirs(directory, exist_ok=True)
        mels = self.mels(device).to(self.dtype).cpu().numpy()
        lines = []
        for i, text in enumerate(self.texts):
            path = os.path.join(directory, f"u{i:05d}.npy")
            a, b = self.offsets[i], self.offsets[i + 1]
            np.save(path, np.ascontiguousarray(mels[a:b].T))
            lines.append(f"{path}|{text}")
        filelist = os.path.join(directory, "filelist.txt")
        with open(filelist, "w") as f:
            f.write("\n".join(lines) + "\n")
        return filelist


class CountingPipeline:
    """The pipeline handed to ``Trainer.fit``, counting what it hands over:
    for each batch of a ``fit`` call, its unpadded mel frames, its rows
    (as corpus indices) and its padded shape."""

    def __init__(self, pipeline, corpus: Corpus):
        self._p = pipeline
        self._corpus = corpus
        self.calls: List[List[dict]] = []

    def __getattr__(self, name):
        return getattr(self._p, name)

    def new_call(self) -> None:
        """Count the batches of a new ``fit`` call apart."""
        self.calls.append([])

    def epoch(self, *args, **kw):
        out = self.calls[-1]
        for batch in self._p.epoch(*args, **kw):
            text = batch.text.numpy()
            lens = batch.text_lengths.numpy()
            rows = [self._corpus.index.get(text[i, :lens[i]].astype(
                np.int64).tobytes(), -1) for i in range(len(lens))]
            out.append({"frames": int(batch.mel_lengths.sum()),
                        "rows": rows, "shape": tuple(batch.mel.shape[:2]),
                        "text_lengths": lens.tolist(),
                        "mel_lengths": batch.mel_lengths.numpy().tolist()})
            yield batch


class _NoSave:
    """Stands in for the trainer's checkpointer: the window measures
    training, and a checkpoint is ~340 MB written to disk."""

    def save(self, *args, **kw):
        pass


def _install_spans(c: dict) -> None:
    """Spans around rows 1 and 2 (``kernels.train_scan``), named with the
    shapes their work is counted from."""
    from tacotron2_tpu_torch.kernels import train_scan as ts
    if getattr(ts.forward_residuals, "bench_span", False):
        return
    fwd, bwd = ts.forward_residuals, ts.backward_chain

    # the program counts launches on these functions by their module names
    @functools.wraps(fwd)
    def forward_residuals(sw, pre, mem, *a, **kw):
        with span("train_scan_fwd", pre.shape[1], mem.shape[1], pre.shape[0],
                  int(kw.get("keep") is not None)):
            return fwd(sw, pre, mem, *a, **kw)

    @functools.wraps(bwd)
    def backward_chain(sw, res, mem, *a, **kw):
        steps = res.dec_h.shape[0]
        with span("train_scan_bwd", mem.shape[0], mem.shape[1], steps,
                  int(kw.get("keep") is not None)):
            return bwd(sw, res, mem, *a, **kw)

    forward_residuals.bench_span = backward_chain.bench_span = True
    ts.forward_residuals, ts.backward_chain = forward_residuals, backward_chain


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def setup(r: Run):
    """The corpus, the ``Trainer`` (weights from the seed, faults planted
    for the tests and the readings of the limits) and the counting
    pipeline."""
    from tacotron2_tpu_torch.data.dataset import TextMelDataset
    from tacotron2_tpu_torch.data.pipeline import DataPipeline
    from tacotron2_tpu_torch.training.trainer import Trainer

    p, c, dev = r.traffic, r.config, r.device
    cfg = model_config(c, seed=r.seed % (1 << 31), batch_size=p["batch"],
                       iters_per_checkpoint=1 << 30, load_mel_from_disk=True)
    corpus = Corpus(r, p)
    _install_spans(c)
    out_dir = os.path.join(r.scratch, "out")
    os.makedirs(out_dir, exist_ok=True)
    trainer = Trainer(cfg, out_dir, device=dev)
    trainer.checkpointer = _NoSave()
    filelist = corpus.write(os.path.join(r.scratch, "corpus"), dev)
    w0 = weights.tacotron2(c, r.seed, dev)
    with torch.no_grad():
        trainer.state.model.load_state_dict(w0)
    del w0
    pipeline = CountingPipeline(
        DataPipeline(TextMelDataset(filelist, cfg), cfg, process_index=0,
                     process_count=1), corpus)
    plant(trainer, [f for f in r.faults if not f.endswith("@window")])
    return corpus, trainer, pipeline


def plant(trainer, faults) -> None:
    """Break the trainer's step (the tests' and the limits' faults): a
    step that returns its state unchanged (``stale_state``), or that
    trains on the first half of its batch (``half_batch``). A fault named
    with ``@window`` is planted as the window starts."""
    step_fn = trainer.train_step_fn
    names = {f.split("@")[0] for f in faults}
    if "half_batch" in names:
        def half(state, batch, gens):
            h = batch.text.shape[0] // 2
            return step_fn(state, type(batch)(*(None if t is None else t[:h]
                                                for t in batch)), gens)
        trainer.train_step_fn = half
    if "stale_state" in names:
        def stale(state, batch, gens):
            kept = [p_.detach().clone() for p_ in state.model.parameters()]
            _, metrics = step_fn(state, batch, gens)
            with torch.no_grad():
                for p_, k in zip(state.model.parameters(), kept):
                    p_.copy_(k)
            return state, metrics
        trainer.train_step_fn = stale


class Start(NamedTuple):
    """The state a checked stretch of steps starts from: parameters and
    Adam's moments and count (zero moments: the seed's start), and the
    0-based index of its first step."""
    params: Dict[str, torch.Tensor]
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    count: int
    step: int


def snapshot(state, step: int) -> Start:
    """The program's state before step ``step`` (0-based): the parameters
    copied (the step updates them in place), the moments as they stand
    (each step makes new ones)."""
    return Start({k: p_.detach().clone()
                  for k, p_ in state.model.named_parameters()},
                 state.exp_avg, state.exp_avg_sq, state.adam_count, step)


def first_gradient(before: Dict[str, torch.Tensor],
                   after: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of the effective gradient of one step, from Adam's
    first moments before and after it."""
    return leaf_norms({k: (after[k].double() - optim.B1 * before[k].double())
                       / (1 - optim.B1) for k in after})


def checked_steps(r: Run, trainer, pipeline):
    """Drive the first three steps through ``fit``: (their rows, the
    losses, the first effective gradient's norms by leaf, the change's
    norms by leaf after three steps)."""
    losses: List[torch.Tensor] = []
    on_loss = lambda step, m: losses.append(m.loss.detach().clone())
    pipeline.new_call()
    trainer.fit(pipeline, max_steps=1, on_step=on_loss)
    g1 = leaf_norms({k: v / (1 - optim.B1)
                     for k, v in trainer.state.exp_avg.items()})
    pipeline.new_call()
    trainer.fit(pipeline, max_steps=N_CHECKED, on_step=on_loss)
    w0 = weights.tacotron2(r.config, r.seed, r.device)
    change = leaf_norms({k: p_.detach() - w0[k]
                         for k, p_ in trainer.state.model.named_parameters()})
    del w0
    rows = ([b["rows"] for b in pipeline.calls[-2][:1]]
            + [b["rows"] for b in pipeline.calls[-1][:2]])
    return rows, [float(x) for x in losses], g1, change


def warm_up(trainer, pipeline, seconds: float) -> int:
    """The rest of the first epoch, which holds every batch shape; the
    window's step count, as many as the warm-up's rate fits into
    ``seconds`` (the window's last ``N_WINDOW`` steps among them)."""
    per_epoch = pipeline.steps_per_epoch()
    pipeline.new_call()
    trainer.fit(pipeline, max_steps=max(per_epoch, N_CHECKED + 2))
    intervals = trainer.last_fit.step_intervals_s
    warm = float(np.mean(intervals[len(intervals) // 2:]))
    return max(8, int(round(seconds / warm))), warm


def window(r: Run, trainer, pipeline, n_steps: int):
    """One ``fit`` call of ``n_steps`` steps, timed from the call to a
    synchronise after it. Inside it, the state before the last
    ``N_WINDOW`` steps is kept (and the first moments after the first of
    them), and their losses; a traced run traces the window's last
    ``traced_steps`` steps. Returns (window seconds, the tracer, the start
    of the checked steps, their losses, the first moments after their
    first step)."""
    start = int(trainer.state.step)
    tracer = Tracer(r.scratch) if r.trace else None
    trace_from = max(1, n_steps - r.traffic["traced_steps"])
    first = n_steps - N_WINDOW  # window steps before the checked ones
    kept: dict = {"losses": []}

    def on_step(step, m):
        k = step - start  # steps of the window done
        if k == first:
            kept["start"] = snapshot(trainer.state, step)
        elif k > first:
            kept["losses"].append(m.loss.detach().clone())
            if k == first + 1:
                kept["after"] = trainer.state.exp_avg
        if tracer is not None and k == trace_from:
            tracer.start()
    pipeline.new_call()
    sync(r.device)
    t0 = time.perf_counter()
    trainer.fit(pipeline, max_steps=start + n_steps, on_step=on_step)
    sync(r.device)
    window_s = time.perf_counter() - t0
    return window_s, t0, tracer, trace_from, kept


def window_numbers(trainer, batches, kept):
    """The program's numbers over the window's checked steps: ((their
    rows, losses, first effective gradient norms by leaf, change norms by
    leaf), the state they started from)."""
    start = kept["start"]
    g1 = first_gradient(start.exp_avg, kept["after"])
    change = leaf_norms({k: p_.detach() - start.params[k] for k, p_
                         in trainer.state.model.named_parameters()})
    rows = [b["rows"] for b in batches[len(batches) - N_WINDOW:]]
    losses = [float(x) for x in kept["losses"]]
    return ((rows, losses, g1, change),
            start._replace(count=int(start.count)))


def run(r: Run) -> Outcome:
    dev = r.device
    corpus, trainer, pipeline = setup(r)
    checked_rows, prog_losses, g1, change = checked_steps(r, trainer,
                                                          pipeline)
    n_steps, warm = warm_up(trainer, pipeline, r.seconds)
    sync(dev)
    setup_s = time.perf_counter() - r.t_start

    plant(trainer, [f for f in r.faults if f.endswith("@window")])
    window_s, t0, tracer, trace_from, kept = window(r, trainer, pipeline,
                                                    n_steps)
    trace = None
    if tracer is not None:
        tracer.stop()
        trace = tracer.read()
    batches = pipeline.calls[-1][:n_steps]
    last, start = window_numbers(trainer, batches, kept)
    frames = sum(b["frames"] for b in batches)
    waits = trainer.last_fit.step_waits_s
    facts = {"window_s": window_s, "steps": n_steps, "batches": batches,
             "waits_s": waits[:n_steps], "traced_from": trace_from,
             "warm_step_s": warm}
    if tracer is not None:  # the steps before the profiler started
        facts["untraced_s"] = tracer.t_sync - t0
        facts["untraced_steps"] = trace_from
        facts["busy_s"] = trace.busy_s()
    peak = memory_peak(dev)
    del trainer, pipeline, kept
    free(dev)

    checks = check(r, corpus, (checked_rows, prog_losses, g1, change),
                   last, start)
    return Outcome(metrics={"train_frames_per_s": frames / window_s,
                            "setup_s": setup_s},
                   checks=checks, attempted=n_steps, failed=0,
                   memory_peak_bytes=peak, facts=facts, trace=trace,
                   notes=[f"window: {n_steps} steps, {frames} frames in "
                          f"{window_s:.3f} s (warm-up step {warm:.4f} s)"])


# ------------------------------------------------------------- the check

def reference_steps(c: dict, seed: int, corpus: Corpus, rows: List[list],
                    device, precision: Optional[str] = None,
                    chunk: Optional[int] = None,
                    start: Optional[Start] = None):
    """The reference over a stretch of checked steps: (losses, first
    effective gradient norms by leaf, parameter-change norms by leaf).
    ``start``: the program's state the stretch starts from; None: the
    seed's weights, zero moments, step 0."""
    d = ref.Dims.of(c)
    W = weights.tacotron2(c, seed, device)
    names = weights.parameter_names(W)
    if start is not None:
        W.update({k: start.params[k].detach().float() for k in names})
    params = {k: W[k].clone().requires_grad_(True) for k in names}
    origin = {k: W[k].clone() for k in names}
    adam = optim.Adam(params, c["learning_rate"], c["weight_decay"],
                      c["grad_clip_thresh"])
    if start is not None:
        adam.resume(start.exp_avg, start.exp_avg_sq, start.count)
    first = 0 if start is None else start.step
    mels = corpus.mels(device)
    buckets = tuple(c["text_buckets"])
    cfg_seed = seed % (1 << 31)
    losses, g1 = [], None
    for step, idx in enumerate(rows, first):
        if min(idx) < 0:
            raise ValueError(f"step {step}: a batch row is no corpus text")
        lens = [int(corpus.lengths[i]) for i in idx]
        frames = [int(corpus.frames[i]) for i in idx]
        T_in = tr.bucket_of(max(lens), buckets)
        T_out = tr.mel_bucket(max(frames), c["mel_bucket_step"],
                              c["max_mel_length"])
        B = len(idx)
        ids = torch.zeros(B, T_in, dtype=torch.long, device=device)
        target = torch.zeros(B, T_out, c["n_mel_channels"], device=device)
        gate_t = torch.zeros(B, T_out, device=device)
        for b, i in enumerate(idx):
            ids[b, :lens[b]] = torch.from_numpy(
                tr.text_ids(corpus.texts[i])).to(device)
            a = int(corpus.offsets[i])
            target[b, :frames[b]] = mels[a:a + frames[b]]
            gate_t[b, frames[b] - 1:] = 1.0
        gen = torch.Generator(device=device).manual_seed(
            derived_seed(cfg_seed, TRAIN_STREAM, step))
        masks = ref.draw_masks(d, B, T_in, T_out, gen)
        Wt = dict(W)
        Wt.update(params)
        net = ref.Net(Wt, d, rounding(precision))
        tl = torch.tensor(lens, device=device)
        ml = torch.tensor(frames, device=device)
        with torch.enable_grad():
            mel, post, gate = net.train_forward(ids, tl, target, ml, masks,
                                                chunk)
            loss = ref.loss(mel, post, gate, target, gate_t)
            grads = torch.autograd.grad(loss, [params[k] for k in names],
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        eff = adam.step({k: v.data for k, v in params.items()}, grads)
        if g1 is None:
            g1 = leaf_norms(eff)
        del mel, post, gate, loss, grads, net
    change = leaf_norms({k: params[k].detach() - origin[k] for k in names})
    return losses, g1, change


def leaf_gaps(prog, want) -> Dict[str, Dict[str, float]]:
    """Each leaf's gap of the gradient norm and of the change norm, as
    ``compare`` measures them (the change only over moved leaves)."""
    (_, pg, pc), (_, rg, rc) = prog, want
    med_g = float(np.median(list(rg.values())))
    moved = [k for k in rc if rg[k] >= 1e-3 * med_g]
    med_c = float(np.median([rc[k] for k in moved]))
    return {"grad": {k: abs(pg[k] - rg[k]) / max(rg[k], med_g) for k in rg},
            "change": {k: abs(pc[k] - rc[k]) / max(rc[k], med_c)
                       for k in moved}}


def compare(prog, want) -> Dict[str, float]:
    """The numbers compared, leaf by leaf against the reference's norm of
    the leaf or of the median leaf, whichever is larger: the worst leaf's
    gap of the first effective gradient's norm (``grad_gap``), the median
    leaf's (``grad_median``: steady from seed to seed, where the worst is
    set by the leaves deepest in the backward), and the worst moved leaf's
    gap of the change's norm (``change_gap``). ``loss_gap``, the worst
    step's loss gap as a share of the reference's, is read and printed but
    not held to a limit (PERF.md, section 2)."""
    (pl, _, _), (rl, _, _) = prog, want
    gaps = leaf_gaps(prog, want)
    return {"grad_gap": max(gaps["grad"].values()),
            "grad_median": float(np.median(list(gaps["grad"].values()))),
            "change_gap": max(gaps["change"].values()),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(pl, rl))}


def check(r: Run, corpus, first, last, start: Start) -> List[Check]:
    """The start's numbers and the window's (``window_`` before their
    names), each against its limit."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chunk = r.traffic.get("reference_chunk")
    try:
        got = compare(first[1:], reference_steps(
            r.config, r.seed, corpus, first[0], r.device, chunk=chunk))
        got.update({WINDOW + k: v for k, v in compare(
            last[1:], reference_steps(r.config, r.seed, corpus, last[0],
                                      r.device, chunk=chunk, start=start)
        ).items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    print("readings not held to a limit: " + ", ".join(
        f"{k} {v!r}" for k, v in got.items() if k not in r.limits),
        file=sys.stderr)
    return [Check(k, v, r.limits[k]) for k, v in got.items()
            if k in r.limits]
