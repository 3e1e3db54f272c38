"""Device: the share of the serving window (traced from the first request
sent to the last audio) in which no operation ran on the card, in %."""

from benchmark import readers


def read(ctx):
    return readers.idle_percent(ctx)
