"""Training step, whole: the model FLOPs of the window's steps (forward
and backward of every row at its unpadded lengths, ``work``) over their
time at the bf16 peak, in %. In a traced run, over the steps before the
profiler started (to the synchronise that starts it), which its overhead
does not slow."""

from benchmark import work


def read(ctx):
    f = ctx["facts"]
    batches = f.get("batches")
    if not batches:
        return None
    seconds = f["window_s"]
    if f.get("untraced_steps"):
        batches = batches[:f["untraced_steps"]]
        seconds = f["untraced_s"]
    c = ctx["config"]
    flops = sum(work.tacotron2_train_flops(c, ti, to)
                for b in batches
                for ti, to in zip(b["text_lengths"], b["mel_lengths"]))
    return 100.0 * flops / (seconds * work.PEAK_FLOPS["bfloat16"])
