"""What several per-layer readers (``benchmark/metrics/<metric>.py``)
share."""

from benchmark import work


def idle_percent(ctx):
    t = ctx["trace"]
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def roofline(ctx, span_name, kernel, work_of):
    """100 x (the bound of the work of every complete ``span_name`` span)
    / (device time of the operations under those spans whose name holds
    ``kernel``, any when None)."""
    t = ctx["trace"]
    if t is None:
        return None
    spans = t.spans_named(span_name)
    dev = t.device_s(span_name, kernel)
    if not spans or dev <= 0:
        return None
    bound_s = sum(work.bound(*work_of(ctx["config"], [int(x) for x in f]),
                             "bfloat16")[0] for f in spans)
    return 100.0 * bound_s / dev
