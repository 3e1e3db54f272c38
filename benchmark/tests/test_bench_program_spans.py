"""The readers built on the program's spans (``benchmark/program_spans.py``,
``benchmark/metrics/``): each on a trace built by hand, and the program's
``serve.batch`` rows against the benchmark's own ``bench:serve_batch`` span
and ``Recorder`` around the same batches."""

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from benchmark import program_spans
from benchmark import traffic as tr
from benchmark.loops import serve_open
from benchmark.tests import tiny
from benchmark.trace import Trace


def ev(cat, name, ts, dur, tid=2):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": {}}


def kernel(ts, end):
    return ev("kernel", "k", ts, end - ts, tid=7)


def note(name, ts, end):
    return ev("user_annotation", name, ts, end - ts)


def serving_events():
    """Two batches over 1000 us; device busy in [50, 160], [190, 310],
    [340, 520], [560, 610], [640, 860]."""
    return [
        note("tt2:serve.collect", 0, 100),
        note("tt2:serve.batch:30:300000", 100, 600),
        note("tt2:decoder.chunk:64", 150, 200),
        note("bench:serve_batch:32:128:30:1000", 140, 580),
        note("tt2:decoder.chunk:64", 300, 350),
        note("tt2:serve.to_host", 500, 580),
        note("tt2:serve.collect", 600, 650),
        note("tt2:serve.batch:10:100000", 650, 900),
        note("tt2:decoder.chunk:22", 700, 720),
        note("tt2:serve.to_host", 850, 890),
        note("tt2:serve.batches", 0, 1000),   # another name: not a batch
        kernel(50, 160), kernel(190, 310), kernel(340, 520),
        kernel(560, 610), kernel(640, 860),
    ]


def training_events():
    """Two steps over 1000 us; device busy in [0, 50], [150, 280],
    [320, 380], [450, 600], [650, 780], [850, 900] (430 us idle)."""
    return [
        note("tt2:train.step", 100, 400),
        note("tt2:train.grads", 110, 300),
        note("bench:train_scan_fwd:64:128:500:1", 140, 200),
        note("tt2:train.update", 310, 390),
        note("tt2:train.step", 500, 800),
        note("tt2:train.grads", 510, 700),
        note("tt2:train.update", 710, 790),
        note("tt2:train.stepping", 0, 1000),  # another name: not a step
        ev("cuda_runtime", "cudaLaunchKernel", 120, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 2),
        ev("cuda_driver", "cuLaunchKernel", 320, 2),
        ev("cuda_runtime", "cudaMemcpyAsync", 330, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 450, 2),   # between steps
        ev("cuda_runtime", "cudaLaunchKernelExC", 520, 2),
        ev("cuda_runtime", "cudaLaunchCooperativeKernel", 799, 2),
        kernel(0, 50), kernel(150, 280), kernel(320, 380), kernel(450, 600),
        kernel(650, 780), kernel(850, 900),
    ]


def reader(name):
    path = os.path.join(tiny.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name, events, want", [
    # (300000 + 100000) us over 30 + 10 rows
    ("serve.queue_wait_ms", serving_events, 10.0),
    # idle 50 in [0, 100], 30 in [600, 650]; over 2 batches
    ("serve.collect_idle_ms", serving_events, 0.040),
    # idle 30 in [150, 200], 30 in [300, 350], 0 in [700, 720]
    ("serve.chunk_loop_idle_ms", serving_events, 0.030),
    # idle 40 in [500, 580], 30 in [850, 890]
    ("serve.to_host_idle_ms", serving_events, 0.035),
    # launches at 120, 150, 320, 520 and 799; over 2 steps
    ("train.launches_per_step", training_events, 2.5),
    # idle 60 in [110, 300], 50 in [510, 700]
    ("train.grads_idle_ms", training_events, 0.055),
    # idle 20 in [310, 390], 10 in [710, 790]
    ("train.update_idle_ms", training_events, 0.015),
    # 430 idle in the window less 110 and 70 inside the steps
    ("train.loop_idle_ms", training_events, 0.125),
])
def test_reader_by_hand(name, events, want):
    read = reader(name)
    trace = Trace(events(), window_s=1000e-6)
    ctx = {"facts": {}, "trace": trace, "config": {}, "traffic": {}}
    assert read(ctx) == pytest.approx(want)
    # a program without its spans (an older commit): no reading
    bare = Trace([e for e in events() if not e["name"].startswith("tt2:")],
                 window_s=1000e-6)
    assert read({**ctx, "trace": bare}) is None
    assert read({**ctx, "trace": None}) is None


def test_serve_batch_rows_equal_the_benchmark_span(tmp_path):
    """Two batches (two requests, then one) through a small synthesizer
    with the ``Recorder`` installed, traced on every thread: the rows of
    the program's ``serve.batch`` are those of ``bench:serve_batch`` and
    of the ``Recorder``, batch for batch."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with open(os.path.join(tiny.HERE, "traffic", "serve-poisson.json")) as f:
        traffic = json.load(f)
    traffic.update(max_batch=4, max_wait_ms=50.0, max_steps=70,
                   checked_requests=2,
                   shares={"16": 0.171, "32": 0.602, "48": 0.228})
    with open(os.path.join(tiny.HERE, "limits",
                           "serve-ljspeech-poisson.json")) as f:
        limits = json.load(f)["limits"]
    r = tiny.run("serve-ljspeech-poisson", traffic, limits, tmp_path,
                 seed=2_147_483_700)
    rng = np.random.RandomState(5)
    texts = [tr.make_text(rng, k) for k in (12, 9, 14)]
    synth = serve_open.build(r)
    rec = serve_open.Recorder(synth, texts, r)
    rec.on = True
    prof = profile(acc_events=True, activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    try:
        prof.start()
        t0 = time.perf_counter()
        a, b = synth.submit(texts[0]), synth.submit(texts[1])
        a.result(), b.result()
        synth.submit(texts[2]).result()
        window_s = time.perf_counter() - t0
        prof.stop()
    finally:
        synth.close()
        rec.close()
        torch.set_num_threads(n)
    path = os.path.join(str(tmp_path), "window.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = Trace(json.load(f)["traceEvents"], window_s)
    ours = [int(f[0]) for _, _, f in program_spans.spans(trace,
                                                         "serve.batch")]
    assert ours == [int(f[2]) for f in trace.spans_named("serve_batch")]
    assert ours == [b[2] for b in rec.batches] == [2, 1]
