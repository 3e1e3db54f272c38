"""Data pipeline: the mean wait of the training loop on its next batch
over the window's steps (``Trainer.last_fit.step_waits_s``), in ms."""


def read(ctx):
    waits = ctx["facts"].get("waits_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
