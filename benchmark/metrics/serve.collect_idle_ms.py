"""Request batching: the device's idle time while the synthesizer's worker
gathers a batch (``serve.collect``, from its first request taken to the
batch closed), in ms per batch (``serve.batch``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx, "serve.collect", "serve.batch")
