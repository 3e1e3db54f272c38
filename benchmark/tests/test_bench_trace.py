"""The reading of a profiler trace: operations under spans, the busy
union, the idle gaps by host activity."""

import pytest

from benchmark.trace import Trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def make():
    return Trace([
        ev("user_annotation", "bench:serve_batch:32:128:30:1000", 0, 100),
        ev("user_annotation", "other", 0, 500),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        ev("cuda_driver", "cuLaunchCooperativeKernel", 20, 2, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 200, 2, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 300, 150, corr=4),
        ev("kernel", "persistent_chunk_kernel<bf16>", 15, 40, tid=7, corr=1),
        ev("kernel", "encoder_cluster_kernel", 50, 10, tid=7, corr=2),
        ev("kernel", "elementwise", 210, 20, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH", 440, 20, tid=7, corr=4),
    ], window_s=500e-6)


def test_operations_belong_to_the_innermost_span():
    t = make()
    assert t.device_s("serve_batch") == pytest.approx(50e-6)
    assert t.device_s("serve_batch", "persistent_chunk") == \
        pytest.approx(40e-6)
    assert t.device_s() == pytest.approx(90e-6)
    assert t.spans_named("serve_batch") == [["32", "128", "30", "1000"]]


def test_busy_union_and_gaps():
    t = make()
    # [15, 60) merged, [210, 230), [440, 460)
    assert t.busy_s() == pytest.approx(85e-6)
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["cudaMemcpyAsync", pytest.approx(210e-6)]
    assert gaps[1][1] == pytest.approx(150e-6)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["persistent_chunk_kernel_bf16_"] == pytest.approx(40e-6)


def test_readers_return_nothing_without_their_inputs():
    import json
    import os

    from benchmark import run as bench_run
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        names = [m["name"] for m in json.load(f)["per_layer"]]
    empty = {"facts": {}, "trace": None, "config": {}, "traffic": {}}
    for name in names:
        assert bench_run.reader(name)(empty) is None, name


def test_rows_and_batch_time_over_the_window_batches():
    from benchmark import run as bench_run
    facts = {"batches": [(0.0, 0.1, 30, 128), (0.2, 0.5, 10, 64)]}
    ctx = {"facts": facts, "trace": None, "config": {}, "traffic": {}}
    assert bench_run.reader("serve.rows_per_batch")(ctx) == 20
    assert bench_run.reader("serve.batch_ms")(ctx) == pytest.approx(200.0)
