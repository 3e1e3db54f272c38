"""The port's profiling utilities (``utils/profiling.py``): ``span``
without and with a profiler, and ``profile_trace`` writing a trace on the
CPU."""

import json
import os
import threading

import pytest
import torch

from tacotron2_tpu_torch.utils import profile_trace, span
from tacotron2_tpu_torch.utils.profiling import latest_trace


def _names(trace_path):
    with open(trace_path) as f:
        trace = json.load(f)
    return {e.get("name", "") for e in trace["traceEvents"]}


def test_profile_trace_writes_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path)) as prof:
        torch.mm(x, x)
    path = latest_trace(str(tmp_path))
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    assert "aten::mm" in _names(path)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


@pytest.mark.parametrize("fields", [(), (64,), (3, 32, 128, 30, 1000)])
def test_span_without_a_profiler_never_records(monkeypatch, fields):
    """No profiler: ``span`` hands back one shared null context and never
    calls ``record_function``, whatever its fields."""
    def refuse(*args, **kw):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("serve.batch", *fields) as inside:
        assert inside is None
    assert span("x", *fields) is span("train.step")


def test_span_is_recorded_on_every_thread(tmp_path):
    """Under ``profile_trace`` (every thread's activity) a span opened on
    another thread is in the trace, named ``tt2:<name>:<fields>``, on that
    thread."""
    tid = {}

    def work():
        tid["native"] = threading.get_native_id()
        with span("decoder.chunk", 64, 1):
            torch.ones(4) + 1

    with profile_trace(str(tmp_path)):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    with open(latest_trace(str(tmp_path))) as f:
        events = json.load(f)["traceEvents"]
    got = [e for e in events if e.get("name", "").startswith("tt2:")]
    assert [(e["name"], e["cat"], e["tid"]) for e in got] == [
        ("tt2:decoder.chunk:64:1", "user_annotation", tid["native"])]
