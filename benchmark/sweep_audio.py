"""The knee of a text-to-audio serving cell (loop ``serve_audio``): its
traffic at a list of rates, one short window each, in one process, each
window on a synthesizer and a vocoder runner of its own.

    python3 benchmark/sweep_audio.py --workload <name> --rates 10,20,30
        [--seconds 10] [--seed N]

For each rate prints one JSON line: requests, p50 and p95 latency to the
audio, the p95 to the mel, and the median latency to the audio of the
first and of the last quarter of the requests (a backlog that grows
through the window shows as the last quarter's median far above the
first's). The knee is the highest rate whose last quarter keeps up with
its first. (``sweep.py`` drives ``serve_open`` alone.)
"""

import argparse
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
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1_900_000_001)
    args = ap.parse_args()

    import numpy as np
    import torch
    from benchmark import run as bench_run
    from benchmark import traffic as tr
    from benchmark.loops import serve_audio as sa
    from benchmark.loops.common import Run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, config, _, _ = bench_run.cell_spec(bench, args.workload)
    cfg = bench_run.load_json(os.path.join(ROOT, config["file"]))
    mix = bench_run.load_json(os.path.join(ROOT, "benchmark", "traffic",
                                           cell["traffic"] + ".json"))
    mix.update(checked_requests=0, spread_checked=0)  # samples nothing
    for rate in [float(x) for x in args.rates.split(",")]:
        r = Run(workload=args.workload, seed=args.seed, seconds=args.seconds,
                trace=False, config=cfg, traffic=dict(mix, rate=rate),
                limits={}, device=torch.device("cuda", 0),
                scratch=tempfile.mkdtemp(), t_start=time.perf_counter())
        due = tr.arrivals(r.seed, rate, r.seconds)
        texts = tr.texts(r.seed, len(due), tr.shares_of(mix))
        setup_s, out, rec, _ = sa.serve(r, due, texts)
        t0, mel_done, done = out[:3]
        lat = np.array([(d - t0 - u) * 1e3 if d is not None else np.inf
                        for d, u in zip(done, due)])
        mel = np.array([(d - t0 - u) * 1e3 if d is not None else np.inf
                        for d, u in zip(mel_done, due)])
        q = max(1, len(lat) // 4)
        rows = [b[2] for b in rec.batches]
        print(json.dumps({
            "rate": rate, "requests": len(due), "setup_s": setup_s,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "mel_p95_ms": float(np.percentile(mel, 95)),
            "first_quarter_ms": float(np.median(lat[:q])),
            "last_quarter_ms": float(np.median(lat[-q:])),
            "rows_per_batch": float(np.mean(rows)) if rows else None,
            "late_max_ms": float(np.max(out[3]) * 1e3)}), flush=True)


if __name__ == "__main__":
    main()
