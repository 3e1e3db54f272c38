"""The readings that the limits of ``correct`` are set from, for one cell,
in one process: the program's numbers on many seeds, the control's
(the reference put in the program's place, in the precision below the
configuration's), and the faults a cell can have.

    python3 benchmark/calibrate.py --workload <name> --seeds 12
        [--control-seeds 3] [--fault-seeds 3] [--seconds 3] [--window]
        [--out FILE]

Training: the program's first three steps against the reference (no
window); with ``--window``, the last two steps of a window of
``--seconds`` after the warm-up, against the reference from the
program's state before them. The control is the reference in fp8 (e4m3,
one scale a tensor, the gradients rounded too) against the reference in
fp32; the fault ``half_batch`` trains on half of each batch (planted as
the window starts, with ``--window``). Serving: a short window at the
cell's own rate per seed, then the check; the control is the reference
in fp8, fed the same decoded frames, against the reference in fp32; the
fault ``alter_frame`` changes one frame of every served mel. Each
reading is printed as a JSON line (and appended to ``--out``).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(out, **kw):
    line = json.dumps(kw)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_000)
    ap.add_argument("--seed-list", default=None,
                    help="comma-separated seeds instead of --first-seed's")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--window", action="store_true",
                    help="training: the window's checked steps")
    ap.add_argument("--leaves", action="store_true",
                    help="training: each reading's per-leaf gaps and "
                         "per-step losses too")
    args = ap.parse_args()

    import torch
    from benchmark import run as bench_run
    from benchmark.loops.common import Run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, config, _, _ = bench_run.cell_spec(bench, args.workload)
    cfg = bench_run.load_json(os.path.join(ROOT, config["file"]))
    mix = bench_run.load_json(os.path.join(ROOT, "benchmark", "traffic",
                                           cell["traffic"] + ".json"))
    limits = bench_run.load_json(os.path.join(
        ROOT, "benchmark", "limits", args.workload + ".json"))["limits"]
    dev = torch.device("cuda", 0)

    def make(seed, faults=()):
        return Run(workload=args.workload, seed=seed, seconds=args.seconds,
                   trace=False, config=cfg, traffic=mix, limits=limits,
                   device=dev, scratch=tempfile.mkdtemp(prefix="calib-"),
                   t_start=time.perf_counter(), faults=faults)

    seeds = ([int(x) for x in args.seed_list.split(",")] if args.seed_list
             else [args.first_seed + 7919 * i for i in range(args.seeds)])
    kind = mix["loop"]
    if kind == "train" and args.window:
        reading_train_window(args, make, seeds)
    elif kind == "train":
        reading_train(args, make, seeds)
    elif kind == "serve_open":
        reading_serve(args, make, seeds)
    else:
        raise SystemExit(f"no readings for loop {kind!r}")


def detail(prog, want) -> dict:
    """Per-step loss gaps, the median leaf's gaps and the five worst
    leaves (with the reference's norms) of a training reading."""
    import numpy as np
    from benchmark.loops import train
    gaps = train.leaf_gaps(prog, want)
    out = {"loss_steps": [abs(a - b) / abs(b) for a, b in zip(prog[0],
                                                                want[0])]}
    for kind, by_leaf in gaps.items():
        norms = want[1] if kind == "grad" else want[2]
        worst = sorted(by_leaf.items(), key=lambda kv: -kv[1])[:5]
        out[kind] = {"median": float(np.median(list(by_leaf.values()))),
                     "worst": [[k, v, norms[k]] for k, v in worst],
                     "median_norm": float(np.median(
                         [norms[k] for k in by_leaf]))}
    return out


def reading_train(args, make, seeds):
    import torch
    from benchmark.loops import train
    from benchmark.loops.common import free

    def program(seed, faults=()):
        r = make(seed, faults)
        try:
            corpus, trainer, pipeline = train.setup(r)
            rows, losses, g1, change = train.checked_steps(r, trainer,
                                                           pipeline)
            del trainer, pipeline
            free(r.device)
            t = time.perf_counter()
            want = reference(r, corpus, rows)
            got = train.compare((losses, g1, change), want)
            if args.leaves:
                got["detail"] = detail((losses, g1, change), want)
            return got, time.perf_counter() - t, corpus, rows, r
        finally:
            shutil.rmtree(r.scratch, ignore_errors=True)

    def reference(r, corpus, rows, precision=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return train.reference_steps(r.config, r.seed, corpus, rows,
                                     r.device, precision,
                                     chunk=r.traffic.get("reference_chunk"))

    for i, seed in enumerate(seeds):
        got, ref_s, corpus, rows, r = program(seed)
        emit(args.out, kind="program", seed=seed, reference_s=ref_s, **got)
        if i < args.control_seeds:
            want = reference(r, corpus, rows)
            low = reference(r, corpus, rows, "fp8")
            got = train.compare(low, want)
            if args.leaves:
                got["detail"] = detail(low, want)
            emit(args.out, kind="control_fp8", seed=seed, **got)
        free(r.device)
    for seed in seeds[:args.fault_seeds]:
        got, *_ = program(seed, ("half_batch",))
        emit(args.out, kind="fault_half_batch", seed=seed, **got)
        free(torch.device("cuda", 0))


def reading_train_window(args, make, seeds):
    import torch
    from benchmark.loops import train
    from benchmark.loops.common import free

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(seeds):
        for faults in ((),) + ((("half_batch@window",),)
                               if i < args.fault_seeds else ()):
            r = make(seed, faults)
            try:
                corpus, trainer, pipeline = train.setup(r)
                train.checked_steps(r, trainer, pipeline)
                n_steps, _ = train.warm_up(trainer, pipeline, r.seconds)
                train.plant(trainer, faults)
                _, _, _, _, kept = train.window(r, trainer, pipeline, n_steps)
                last, start = train.window_numbers(
                    trainer, pipeline.calls[-1][:n_steps], kept)
                del trainer, pipeline, kept
                free(r.device)
                t = time.perf_counter()
                ref = lambda precision=None: train.reference_steps(
                    r.config, seed, corpus, last[0], r.device, precision,
                    r.traffic.get("reference_chunk"), start)
                want = ref()
                got = train.compare(last[1:], want)
                if args.leaves:
                    got["detail"] = detail(last[1:], want)
                emit(args.out, kind="window_fault_half_batch" if faults
                     else "window_program", seed=seed, steps=n_steps,
                     reference_s=time.perf_counter() - t, **got)
                if not faults and i < args.control_seeds:
                    low = ref("fp8")
                    got = train.compare(low, want)
                    if args.leaves:
                        got["detail"] = detail(low, want)
                    emit(args.out, kind="window_control_fp8", seed=seed,
                         **got)
            finally:
                shutil.rmtree(r.scratch, ignore_errors=True)
            free(r.device)


def reading_serve(args, make, seeds):
    import numpy as np
    import torch
    from benchmark import traffic as tr
    from benchmark.loops import serve_open as so
    from benchmark.loops.common import free

    for i, seed in enumerate(seeds):
        for faults in ((),) + ((("alter_frame",),)
                               if i < args.fault_seeds else ()):
            r = make(seed, faults)
            p = r.traffic
            due = tr.arrivals(seed, p["rate"], r.seconds)
            texts = tr.texts(seed, len(due), tr.shares_of(p))
            synth = so.build(r)
            rec = so.Recorder(synth, texts, r, faults)
            try:
                so.warm_up(synth, r)
                t0, done, late, served, frames, _, _ = so.window(
                    synth, rec, r, due, texts)
            finally:
                synth.close()
                rec.close()
            del synth
            free(r.device)
            sample = sorted(rec.chosen)
            sel = [texts[k] for k in sample]
            raw = [rec.raw[k] for k in sample]
            served_t = [torch.as_tensor(served[k]) for k in sample]
            got = so.reference_gaps(r.config, seed, p["gate_bias"], sel, raw,
                                    served_t, r.device)
            lat = [(d - t0 - u) * 1e3 for d, u in zip(done, due)
                   if d is not None]
            emit(args.out, kind="fault_alter_frame" if faults else "program",
                 seed=seed, requests=len(due), checked=len(sample),
                 slots=len(set(rec.slot.values())), p95_ms=float(
                     np.percentile(lat, 95)), frames_off=sum(
                         1 for f in frames if f is not None
                         and f != p["max_steps"]), **got)
            if faults or i >= args.control_seeds:
                continue
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            fp32 = so.reference_predictions(r.config, seed, p["gate_bias"],
                                            sel, raw, r.device)
            low = so.reference_gaps(r.config, seed, p["gate_bias"], sel, raw,
                                    served_t, r.device, "fp8", against=fp32)
            emit(args.out, kind="control_fp8", seed=seed, **low)


if __name__ == "__main__":
    main()
