"""Request batching: the mean number of requests in a batch the
synthesizer ran in the window (rows of real text in its fixed-shape
batch)."""


def read(ctx):
    b = ctx["facts"].get("batches")
    if not b:
        return None
    return sum(x[2] for x in b) / len(b)
