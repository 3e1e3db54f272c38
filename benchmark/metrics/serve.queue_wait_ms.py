"""Request batching: the mean time a request waits in the synthesizer's
queue, from ``submit`` to the close of the batch it joins, in ms: the sum
of the rows' waits over the rows of every ``serve.batch`` span (its fields:
rows, then the rows' waits summed, in us)."""

from benchmark import program_spans


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    batches = program_spans.spans(t, "serve.batch")
    rows = sum(int(f[0]) for _, _, f in batches)
    if rows == 0:
        return None
    return sum(int(f[1]) for _, _, f in batches) / rows / 1e3
