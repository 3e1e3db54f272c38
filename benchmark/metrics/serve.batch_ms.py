"""Serving model functions: the mean host time of the synthesizer's batch
call, from the call to the returned numpy arrays, in ms, over the batches
of the window."""


def read(ctx):
    b = ctx["facts"].get("batches")
    if not b:
        return None
    return 1e3 * sum(x[1] - x[0] for x in b) / len(b)
