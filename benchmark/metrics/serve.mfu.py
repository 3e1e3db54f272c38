"""Serving model, whole: the model FLOPs of every request sent in the
window (its text at its length, every decoded step, the postnet) over the
window at the bf16 peak, in %."""

from benchmark import work


def read(ctx):
    f = ctx["facts"]
    if not f.get("texts"):
        return None
    c = ctx["config"]
    flops = sum(work.tacotron2_forward_flops(c, n, f["max_steps"])
                for n in f["texts"])
    return 100.0 * flops / (f["window_s"] * work.PEAK_FLOPS["bfloat16"])
