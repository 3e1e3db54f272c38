"""Training step: the device's idle time while the step applies its update
(``train.update``: the guarded clip and Adam over every leaf), in ms per
traced step (``train.step``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx, "train.update", "train.step")
