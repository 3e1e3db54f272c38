"""The program's own spans in a traced window, and the device's idle time
inside them.

The program opens ``torch.profiler`` ranges named ``tt2:<span>:<fields>``
at its layer boundaries (``tacotron2_tpu_torch/utils/profiling.py:span``);
``Trace`` keeps them among its host activity, on the profiler's clock, as
it keeps every range not named ``bench:``. A program without them (an
older commit) gives no span, and the readers built on this file then
return None.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

PREFIX = "tt2:"


def spans(trace, name: str) -> List[Tuple[float, float, List[str]]]:
    """(start, end, fields) of every complete program span ``name`` in
    ``trace``, in us of the trace's clock, by start."""
    out = []
    for h0, h1, full, cat in trace.host:
        if cat == "user_annotation" and full.startswith(PREFIX):
            parts = full[len(PREFIX):].split(":")
            if parts[0] == name:
                out.append((h0, h1, parts[1:]))
    return sorted(out)


def idle_us(trace, intervals: Sequence[Tuple[float, float]]) -> float:
    """The time inside ``intervals`` in which no device operation ran
    (``Trace.busy_intervals``), in us. The intervals do not overlap, as
    the spans of one name do not: one thread opens them, one after the
    other."""
    busy = trace.busy_intervals()
    total = covered = 0.0
    j = 0
    for a, b in sorted(intervals):
        total += b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total - covered


def idle_ms_per(ctx, inside: str, per: str):
    """The device's idle time inside every ``inside`` span, in ms per
    complete ``per`` span; None without a trace or a ``per`` span."""
    t = ctx["trace"]
    if t is None:
        return None
    n = len(spans(t, per))
    if n == 0:
        return None
    return idle_us(t, [(a, b) for a, b, _ in spans(t, inside)]) / 1e3 / n
