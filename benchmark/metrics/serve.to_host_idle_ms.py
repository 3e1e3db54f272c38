"""Serving model functions: the device's idle time while the synthesizer
copies a batch's mel, alignments and lengths to the host
(``serve.to_host``), in ms per batch (``serve.batch``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx, "serve.to_host", "serve.batch")
