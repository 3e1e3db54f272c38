"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout: the cell, its
configuration file and its traffic mix (``benchmark/traffic/<mix>.json``,
whose ``loop`` names the module of ``benchmark/loops`` that runs it),
the limits of its check (``benchmark/limits/<cell>.json``) and, with
``--trace 1``, the per-layer metrics it reports, each read by
``benchmark/metrics/<metric>.py``. The last line of standard output is
one JSON object; the numbers compared with their limits end standard
error. Exits non-zero without a result when the card(s) the cell asks
for are missing, when the program cannot be imported, when JAX or the
JAX package was loaded, or when a traced run's loop refuses its trace.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "build", "bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    """(cell, configuration entry, end-to-end metrics, per-layer metrics)
    of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return cell, config, e2e, layer


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, e2e, layer = cell_spec(bench, args.workload)
    cfg_file = load_json(os.path.join(ROOT, config["file"]))
    mix = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits",
                                    args.workload + ".json"))["limits"]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['chips']} card(s) needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from benchmark.guard import keep_out
    keep_out()
    import tacotron2_tpu_torch  # noqa: F401  (the program under test)
    kind = torch.cuda.get_device_name(0)
    return emit(execute(args, cell, e2e, layer, cfg_file, mix, limits,
                        torch.device("cuda", 0), kind))


def emit(line) -> int:
    """Print a result line (an exit code passes through)."""
    if isinstance(line, int):
        return line
    print(json.dumps(line), flush=True)
    return 0


def execute(args, cell, e2e, layer, cfg_file, mix, limits, device, kind,
            faults=()):
    """Run the cell on ``device``: the result line (a dict), or an exit
    code: 3 when JAX or the JAX package was loaded, 4 when a traced run
    did not send its requests on time. ``faults`` plants faults in the
    timed path (the tests' check that ``correct`` falls)."""
    from benchmark.loops.common import Run
    from benchmark.guard import forbidden_loaded

    loop = importlib.import_module(f"benchmark.loops.{mix['loop']}")
    scratch = tempfile.mkdtemp(prefix=f"bench-{args.workload}-")
    try:
        run = Run(workload=args.workload, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  config=cfg_file, traffic=mix, limits=limits,
                  device=device, scratch=scratch, t_start=T_START,
                  faults=tuple(faults))
        out = loop.run(run)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    if out.refused:
        print(out.refused, file=sys.stderr)
        return 4

    metrics = {}
    if args.trace:
        ctx = {"facts": out.facts, "trace": out.trace, "config": cfg_file,
               "traffic": mix}
        for m in layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    finite = all(math.isfinite(v["value"]) for v in metrics.values())
    for v in metrics.values():
        if not math.isfinite(v["value"]):
            v["value"] = 1e12
    correct = all(c.ok for c in out.checks) and out.failed == 0 and finite
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.facts.get("busy_s", out.trace.busy_s())
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                               else 1e12, "limit": c.limit}
                      for c in out.checks}
    for note in out.notes:
        print(note, file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    return line


if __name__ == "__main__":
    sys.exit(main())
