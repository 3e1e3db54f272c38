"""The knee of a serving cell: its traffic at a list of rates, one short
window each, in one process on one synthesizer.

    python3 benchmark/sweep.py --workload <name> --rates 100,200,300
        [--seconds 8] [--seed N]

For each rate prints one JSON line: requests, p50 and p95 latency, and the
median latency of the first and of the last quarter of the requests (a
backlog that grows through the window shows as the last quarter's median
far above the first's). The knee is the highest rate whose last quarter
keeps up with its first.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1_900_000_001)
    args = ap.parse_args()

    import numpy as np
    import torch
    from benchmark import run as bench_run
    from benchmark import traffic as tr
    from benchmark.loops import serve_open as so
    from benchmark.loops.common import Run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, config, _, _ = bench_run.cell_spec(bench, args.workload)
    cfg = bench_run.load_json(os.path.join(ROOT, config["file"]))
    mix = bench_run.load_json(os.path.join(ROOT, "benchmark", "traffic",
                                           cell["traffic"] + ".json"))
    r = Run(workload=args.workload, seed=args.seed, seconds=args.seconds,
            trace=False, config=cfg, traffic=mix, limits={},
            device=torch.device("cuda", 0), scratch=tempfile.mkdtemp(),
            t_start=time.perf_counter())
    synth = so.build(r)
    rec = so.Recorder(synth, [], r)  # samples nothing
    try:
        so.warm_up(synth, r)
        for rate in [float(x) for x in args.rates.split(",")]:
            rr = dataclasses.replace(r, traffic=dict(mix, rate=rate))
            due = tr.arrivals(r.seed, rate, r.seconds)
            texts = tr.texts(r.seed, len(due), tr.shares_of(mix))
            rec.batches.clear()
            t0, done, late, _, _, _, _ = so.window(synth, rec, rr, due,
                                                   texts)
            lat = np.array([(d - t0 - u) * 1e3 if d is not None else np.inf
                            for d, u in zip(done, due)])
            q = max(1, len(lat) // 4)
            rows = [b[2] for b in rec.batches]
            print(json.dumps({
                "rate": rate, "requests": len(due),
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "first_quarter_ms": float(np.median(lat[:q])),
                "last_quarter_ms": float(np.median(lat[-q:])),
                "rows_per_batch": float(np.mean(rows)) if rows else None,
                "batch_ms": float(np.mean([b[1] - b[0]
                                           for b in rec.batches]) * 1e3)
                if rec.batches else None,
                "late_max_ms": float(np.max(late) * 1e3)}), flush=True)
    finally:
        synth.close()
        rec.close()


if __name__ == "__main__":
    main()
