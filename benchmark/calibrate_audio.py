"""The readings that the limits of ``correct`` of a text-to-audio serving
cell (loop ``serve_audio``) are set from, in one process: the program's
numbers on many seeds, the control's (the reference generator with every
convolution's operands rounded to bf16, a precision below the
configuration's fp32, against the reference in fp32, fed the same served
mels), and the faults ``post_slope`` (the generator at slope 0.1 before
``conv_post``) and ``alter_window`` (one 256-sample window altered).

    python3 benchmark/calibrate_audio.py --workload <name> --seeds 12
        [--control-seeds 3] [--fault-seeds 3] [--seconds 3] [--rate R]
        [--out FILE]

Each seed serves a short window at the cell's own rate, then is checked
as a run is. Each reading is printed as a JSON line (and appended to
``--out``). (``calibrate.py`` reads the cells of the other loops.)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="requests a second (the traffic's by default)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from benchmark import run as bench_run
    from benchmark import traffic as tr
    from benchmark.calibrate import emit
    from benchmark.loops import serve_audio as sa
    from benchmark.loops import serve_open as so
    from benchmark.loops.common import Run
    from benchmark.reference import hifigan as ref

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, config, _, _ = bench_run.cell_spec(bench, args.workload)
    cfg = bench_run.load_json(os.path.join(ROOT, config["file"]))
    mix = bench_run.load_json(os.path.join(ROOT, "benchmark", "traffic",
                                           cell["traffic"] + ".json"))
    if args.rate is not None:
        mix["rate"] = args.rate
    dev = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    fault_kinds = ("post_slope", "alter_window")

    for i, seed in enumerate(seeds):
        for faults in [()] + ([(k,) for k in fault_kinds]
                              if i < args.fault_seeds else []):
            r = Run(workload=args.workload, seed=seed, seconds=args.seconds,
                    trace=False, config=cfg, traffic=mix, limits={},
                    device=dev, scratch=tempfile.mkdtemp(prefix="calib-"),
                    t_start=time.perf_counter(), faults=faults)
            p = r.traffic
            due = tr.arrivals(seed, p["rate"], r.seconds)
            texts = tr.texts(seed, len(due), tr.shares_of(p))
            try:
                _, out, rec, _ = sa.serve(r, due, texts)
            finally:
                shutil.rmtree(r.scratch, ignore_errors=True)
            t0, _, done, _, served, audio, frames, samples = out[:8]
            sample = sorted(rec.chosen)
            sel = [texts[k] for k in sample]
            mels = [served[k] for k in sample]
            got = so.reference_gaps(cfg, seed, p["gate_bias"], sel,
                                    [rec.raw[k] for k in sample],
                                    [torch.as_tensor(m) for m in mels], dev)
            got.update(sa.audio_gaps(cfg["vocoder"], seed, p, mels,
                                     [torch.as_tensor(audio[k])
                                      for k in sample], dev))
            lat = [(d - t0 - u) * 1e3 for d, u in zip(done, due)
                   if d is not None]
            want = p["max_steps"] * cfg["vocoder"]["hop_size"]
            emit(args.out, kind=f"fault_{faults[0]}" if faults
                 else "program", seed=seed, requests=len(due),
                 checked=len(sample), p95_ms=float(np.percentile(lat, 95)),
                 frames_off=sum(1 for f in frames if f is not None
                                and f != p["max_steps"]),
                 samples_off=sum(1 for s in samples if s is not None
                                 and s != want),
                 audio_peak=[float(np.abs(audio[k]).max()) for k in sample],
                 **got)
            if faults or i >= args.control_seeds:
                continue
            fp32 = sa.reference_audio(cfg["vocoder"], seed, p, mels, dev)
            low = sa.audio_gaps(cfg["vocoder"], seed, p, mels, None, dev,
                                ref.bf16, against=fp32)
            emit(args.out, kind="control_bf16", seed=seed, **low)


if __name__ == "__main__":
    main()
