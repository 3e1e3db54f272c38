"""The device time of the program's own spans.

``trace.Trace`` gives each device operation to the innermost ``bench:``
span open on the thread that launched it. ``SpanTrace`` also keeps where
each operation was launched (thread and time, through the launch's
correlation id), so that a reader can sum the device time of the
operations launched inside a program span (``tt2:<name>``,
``tacotron2_tpu_torch/utils/profiling.py:span``) at any depth, with no
wrapper around the call. ``SpanTracer`` is ``trace.Tracer`` reading its
window into a ``SpanTrace``. A program without the span gives 0 s there.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.program_spans import PREFIX
from benchmark.trace import LAUNCH_CATS, Trace, Tracer


class SpanTrace(Trace):

    def __init__(self, events: List[dict], window_s: float):
        super().__init__(events, window_s)
        launches: Dict[int, Tuple[int, float]] = {}
        # (thread, span name) -> sorted (start, end)
        self._spans: Dict[Tuple[int, str], List[Tuple[float, float]]] = \
            defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e["tid"], e["ts"])
            elif cat == "user_annotation" and e["name"].startswith(PREFIX):
                name = e["name"][len(PREFIX):].split(":")[0]
                self._spans[(e["tid"], name)].append(
                    (e["ts"], e["ts"] + e["dur"]))
        for v in self._spans.values():
            v.sort()
        # where each device operation was launched: (thread, time) or None
        self.op_launch: List[Optional[Tuple[int, float]]] = [
            launches.get(op.get("args", {}).get("correlation"))
            for op in self.ops]

    def program_device_s(self, name: str,
                         kernel: Optional[str] = None) -> float:
        """Device seconds of the operations launched inside a program span
        ``name`` on their own thread (spans of one name on one thread do
        not overlap: one thread opens them one after another), whose name
        contains ``kernel`` (any when None)."""
        starts = {k: [s for s, _ in v] for k, v in self._spans.items()
                  if k[1] == name}
        total = 0.0
        for op, where in zip(self.ops, self.op_launch):
            if where is None or (kernel is not None
                                 and kernel not in op["name"]):
                continue
            tid, ts = where
            s = starts.get((tid, name))
            if not s:
                continue
            i = bisect.bisect_right(s, ts) - 1
            if i >= 0 and ts <= self._spans[(tid, name)][i][1]:
                total += op["dur"]
        return total / 1e6


class SpanTracer(Tracer):
    """``Tracer`` whose window reads into a ``SpanTrace``."""

    def read(self) -> SpanTrace:
        os.makedirs(self.scratch, exist_ok=True)
        path = os.path.join(self.scratch, "window.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return SpanTrace(events, self.window_s)
