"""Vocoder serving: the median wait of a mel in the vocoder runner's
queue, from ``VocoderRunner.submit`` to its call's start, in ms (the
third field of the program's ``vocoder.vocode`` span, in us)."""

import numpy as np

from benchmark import program_spans


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    calls = program_spans.spans(t, "vocoder.vocode")
    if not calls:
        return None
    return float(np.median([int(f[2]) for _, _, f in calls])) / 1e3
