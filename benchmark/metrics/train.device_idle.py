"""Device: the share of the traced training steps in which no operation
ran on the card, in %."""

from benchmark import readers


def read(ctx):
    return readers.idle_percent(ctx)
