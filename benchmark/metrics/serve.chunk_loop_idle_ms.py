"""Serving model functions: the device's idle time in the decoder's host
loop over chunks (``decoder.chunk``: the gate latch's read, which waits for
the chunk before, and the next chunk's launch), in ms per batch
(``serve.batch``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms_per(ctx, "decoder.chunk", "serve.batch")
