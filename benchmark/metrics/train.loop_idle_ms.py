"""Trainer: the device's idle time in the traced window outside every
training step (``train.step``): the wait on the next batch, the loop's own
work between steps (dropout generators, logging), the window's callback,
in ms per traced step. The window's idle time is ``train.device_idle``'s:
its host-clock length less the device's busy union."""

from benchmark import program_spans


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    steps = program_spans.spans(t, "train.step")
    if not steps:
        return None
    idle = (t.window_s - t.busy_s()) * 1e6
    inside = program_spans.idle_us(t, [(a, b) for a, b, _ in steps])
    return (idle - inside) / 1e3 / len(steps)
