"""``torch.profiler`` over a part of a run, read back into the numbers the
metrics take: device time by kernel, device time under each of the
benchmark's own spans, the busy union of the device, and the longest idle
gaps by what the host was doing then.

Spans are ``torch.profiler.record_function`` ranges named
``bench:<span>:<fields>`` that the loops open around calls into the
program; a device operation belongs to the innermost such range open on
the thread that launched it (matched through the launch's correlation id).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench:"


def span(name: str, *fields) -> "torch.profiler.record_function":
    """A benchmark span around a call into the program."""
    return torch.profiler.record_function(
        ":".join([SPAN_PREFIX + name] + [str(f) for f in fields]))


class Trace:
    """What one traced window holds, read from the profiler's trace."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        self.ops: List[dict] = []      # device operations
        launches: Dict[int, dict] = {}
        spans: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        self.host: List[Tuple[float, float, str, str]] = []
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                self.ops.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
                self.host.append((e["ts"], e["ts"] + e["dur"], e["name"],
                                  cat))
            elif cat == "user_annotation" and e["name"].startswith(
                    SPAN_PREFIX):
                spans[e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                        e["name"][len(SPAN_PREFIX):]))
            elif cat in ("cpu_op", "python_function", "user_annotation"):
                self.host.append((e["ts"], e["ts"] + e["dur"], e["name"],
                                  cat))
        self.spans = [s for v in spans.values() for s in v]
        starts = {tid: sorted(v) for tid, v in spans.items()}
        # the span each device operation belongs to
        self.op_span: List[Optional[str]] = []
        for op in self.ops:
            corr = op.get("args", {}).get("correlation")
            launch = launches.get(corr)
            name = None
            if launch is not None:
                ts, best = launch["ts"], None
                for s0, s1, nm in starts.get(launch["tid"], ()):
                    if s0 > ts:
                        break
                    if ts <= s1 and (best is None or s1 - s0 < best[0]):
                        best = (s1 - s0, nm)
                name = best[1] if best else None
            self.op_span.append(name)

    # ------------------------------------------------------------- readers
    def busy_intervals(self) -> List[Tuple[float, float]]:
        iv = sorted((o["ts"], o["ts"] + o["dur"]) for o in self.ops)
        merged: List[List[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_s(self, span_prefix: Optional[str] = None,
                 kernel: Optional[str] = None) -> float:
        """Device seconds of the operations under spans whose name starts
        with ``span_prefix`` (any when None) and whose name contains
        ``kernel`` (any when None)."""
        total = 0.0
        for op, sp in zip(self.ops, self.op_span):
            if span_prefix is not None and (sp is None or
                                            not sp.startswith(span_prefix)):
                continue
            if kernel is not None and kernel not in op["name"]:
                continue
            total += op["dur"]
        return total / 1e6

    def spans_named(self, prefix: str) -> List[List[str]]:
        """The fields of every complete span whose name starts with
        ``prefix``."""
        return [nm.split(":")[1:] for _, _, nm in self.spans
                if nm.split(":")[0] == prefix]

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[_clean(op["name"])] += op["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        busy = self.busy_intervals()
        host = sorted(self.host)
        host_starts = [h[0] for h in host]
        for (_, a), (b, _) in zip(busy, busy[1:]):
            if b > a:
                gaps.append((b - a, a, b))
        gaps.sort(reverse=True)
        out = []
        for dur, a, b in gaps[:top]:
            out.append([_clean(_host_during(host, host_starts, a, b)),
                        dur / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out}


def _host_during(host, starts, a, b) -> str:
    """The host activity that overlaps [a, b] most: a CUDA API call
    first, then an operator or span; "host" when none does."""
    best: Dict[str, Tuple[float, str]] = {}
    hi = bisect.bisect_right(starts, b)
    for h0, h1, name, cat in host[max(0, hi - 20000):hi]:
        ov = min(h1, b) - max(h0, a)
        if ov <= 0:
            continue
        kind = "api" if cat in LAUNCH_CATS else "op"
        # the innermost operator: the shortest one covering the most
        key = (ov, -(h1 - h0))
        if kind not in best or key > best[kind][0]:
            best[kind] = (key, name)
    for kind in ("api", "op"):
        if kind in best:
            return best[kind][1]
    return "host"


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


class Tracer:
    """Start and stop ``torch.profiler`` around a part of a window (CPU
    activity of every thread, and the card's); ``stop`` returns the
    ``Trace``. The trace file goes to ``scratch`` and is deleted once
    read."""

    def __init__(self, scratch: str):
        self.scratch = scratch
        self.prof = None
        self.t0 = self.window_s = 0.0

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.t_sync = time.perf_counter()  # all work before the trace done
        self.prof = profile(acc_events=True,
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """End the traced window (after a synchronise). Reading the trace
        waits for ``read``, outside the measured window."""
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def read(self) -> Trace:
        os.makedirs(self.scratch, exist_ok=True)
        path = os.path.join(self.scratch, "window.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(events, self.window_s)
