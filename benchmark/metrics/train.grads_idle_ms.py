"""Training step: the device's idle time while the step takes its
gradients (``train.grads``: forward and backward of every micro-batch), in
ms per traced step (``train.step``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx, "train.grads", "train.step")
