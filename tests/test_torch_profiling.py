"""The port's profiling utilities (``utils/profiling.py``): ``StepTimer``
against the JAX package's on the same times, ``profile_trace`` writing a
trace on the CPU, and one capture through ``start_profiler_server``."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tacotron2_tpu.utils.profiling import StepTimer as JaxStepTimer

from tacotron2_tpu_torch.utils import (StepTimer, profile_trace,
                                       start_profiler_server)
from tacotron2_tpu_torch.utils.profiling import latest_trace

TIMES = [0.9, 0.1, 0.3, 0.2, 0.25, 0.4, 0.15]


def _names(trace_path):
    with open(trace_path) as f:
        trace = json.load(f)
    return {e.get("name", "") for e in trace["traceEvents"]}


@pytest.mark.parametrize("warmup,times", [(2, TIMES), (0, TIMES[:1]),
                                          (5, TIMES[:3]), (2, [])])
def test_step_timer_summary_matches_jax(warmup, times):
    port, jax_ = StepTimer(warmup), JaxStepTimer(warmup)
    port.times, jax_.times = list(times), list(times)
    assert port.measured == jax_.measured
    assert port.summary() == jax_.summary()


def test_step_timer_times_its_block():
    timer = StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            time.sleep(0.01)
    assert len(timer.times) == 3 and min(timer.times) >= 0.01
    assert timer.summary()["steps"] == 2


def test_profile_trace_writes_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path)) as prof:
        torch.mm(x, x)
    path = latest_trace(str(tmp_path))
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    assert "aten::mm" in _names(path)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_profiler_server_answers_one_capture(tmp_path):
    """A capture of 200 ms while another thread multiplies: the trace holds
    that thread's operators; another path is 404."""
    server = start_profiler_server(0, str(tmp_path / "captures"))
    port = server.server_address[1]
    stop = threading.Event()

    def work():
        x = torch.randn(32, 32)
        while not stop.is_set():
            torch.mm(x, x)
            time.sleep(0.001)

    worker = threading.Thread(target=work)
    worker.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/capture?ms=200", timeout=60) as r:
            assert r.status == 200
            answer = json.load(r)
        assert os.path.exists(answer["trace"])
        assert "aten::mm" in _names(answer["trace"])
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other",
                                   timeout=60)
        assert err.value.code == 404
    finally:
        stop.set()
        worker.join(timeout=10)
        server.shutdown()
        server.server_close()
    assert not worker.is_alive()
