"""Kernels: the share of its roofline that HiFi-GAN's generator reaches
in the traced calls: the bound of every ``vocoder.vocode`` span's
generator pass at its bucket's frames (``work_hifigan.generator_work``:
the larger of its bytes at the HBM rate and its FLOPs at the TF32 peak,
``work.bound``) over the device time of the operations launched inside
those spans (``span_trace.SpanTrace``)."""

from benchmark import program_spans, work, work_hifigan


def read(ctx):
    t = ctx["trace"]
    if t is None or not hasattr(t, "program_device_s"):
        return None
    calls = program_spans.spans(t, "vocoder.vocode")
    dev = t.program_device_s("vocoder.vocode")
    if not calls or dev <= 0:
        return None
    v = ctx["config"]["vocoder"]
    bound_s = 0.0
    for _, _, f in calls:
        nbytes, flops = work_hifigan.generator_work(v, int(f[1]))
        bound_s += work.bound(nbytes, {"tf32": flops})[0]
    return 100.0 * bound_s / dev
