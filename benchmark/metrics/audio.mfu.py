"""Serving model functions, text to audio: the model FLOPs of every
request sent in the window, each at its peak (Tacotron 2's as
``serve.mfu`` counts them, at the bf16 peak; the generator's over the
frames the vocoder runner vocodes, at the TF32 peak), as seconds at those
peaks over the window, in %."""

from benchmark import work, work_hifigan


def read(ctx):
    f = ctx["facts"]
    if not f.get("texts") or "vocoded_frames" not in f:
        return None
    c = ctx["config"]
    gen = work_hifigan.generator_work(c["vocoder"], f["vocoded_frames"])[1]
    busy = sum(work.tacotron2_forward_flops(c, n, f["max_steps"])
               / work.PEAK_FLOPS["bfloat16"]
               + gen / work.PEAK_FLOPS["tf32"] for n in f["texts"])
    return 100.0 * busy / f["window_s"]
