"""Training step: the host's launch calls (CUDA runtime and driver calls
whose name holds ``Launch``) that start inside a training step
(``train.step``), per traced step."""

import bisect

from benchmark import program_spans
from benchmark.trace import LAUNCH_CATS


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    steps = program_spans.spans(t, "train.step")
    if not steps:
        return None
    starts = [a for a, _, _ in steps]
    n = 0
    for h0, _, name, cat in t.host:
        if cat in LAUNCH_CATS and "Launch" in name:
            i = bisect.bisect_right(starts, h0) - 1
            if i >= 0 and h0 < steps[i][1]:
                n += 1
    return n / len(steps)
