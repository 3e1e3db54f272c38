"""Vocoder serving: the median time of one call on the vocoder runner's
thread (the program's ``vocoder.vocode`` span: the padded mel to the
device, the generator, the audio to the host), in ms."""

import numpy as np

from benchmark import program_spans


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    calls = program_spans.spans(t, "vocoder.vocode")
    if not calls:
        return None
    return float(np.median([b - a for a, b, _ in calls])) / 1e3
