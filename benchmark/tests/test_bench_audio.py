"""The text-to-audio serving cell's parts on the CPU: its five readers on a
trace built by hand, the generator's count of work against a count by
hand, and a small run of the loop (``loops/serve_audio.py``) through
``run.py``, correct when sound and not correct with either planted fault
of the vocoder."""

import argparse
import importlib.util
import json
import os

import pytest
import torch

from benchmark import run as bench_run
from benchmark import work, work_hifigan
from benchmark.span_trace import SpanTrace
from benchmark.tests import tiny

torch.set_num_threads(2)

CELL = "serve-hifigan-poisson"
V = {"resblock": "1", "num_mels": 6, "upsample_rates": [4, 2],
     "upsample_kernel_sizes": [8, 4], "upsample_initial_channel": 16,
     "resblock_kernel_sizes": [3, 5],
     "resblock_dilation_sizes": [[1, 3], [1, 2, 4]], "hop_size": 8,
     "lrelu_slope": 0.1, "post_lrelu_slope": 0.01}


def reader(name):
    path = os.path.join(bench_run.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ the readers

def ev(cat, name, ts, dur, tid=3, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def vocoder_events():
    """Two calls on the runner's thread (tid 3) over 1000 us: 300 us
    (waited 100 us) and 400 us (waited 2500 us). Kernels launched inside
    them run 100 + 50 and 200 us, one launched by the synthesizer's
    thread (tid 5) meanwhile runs 300 us, one launched on tid 3 between
    the calls runs 10 us. Device busy [100, 250], [300, 600], [650, 850],
    [900, 910]: 340 of 1000 us idle."""
    def launch(ts, corr, tid=3):
        return ev("cuda_runtime", "cudaLaunchKernel", ts, 5, tid, corr)

    def kernel(ts, dur, corr):
        return ev("kernel", f"k{corr}", ts, dur, tid=7, corr=corr)
    return [
        ev("user_annotation", "tt2:vocoder.vocode:1000:1024:100", 0, 300),
        launch(10, 1), launch(20, 2),
        ev("user_annotation", "tt2:vocoder.to_host", 200, 90),
        launch(210, 3),
        ev("user_annotation", "tt2:vocoder.vocode:1000:1000:2500", 500,
           400),
        launch(510, 4),
        launch(520, 5, tid=5),
        launch(450, 6),
        kernel(100, 100, 1), kernel(200, 50, 2), kernel(300, 300, 5),
        kernel(650, 200, 4), kernel(900, 10, 6),
        ev("gpu_memcpy", "Memcpy DtoH", 240, 10, tid=7, corr=3),
    ]


@pytest.fixture()
def ctx():
    cfg = dict(tiny.config(), vocoder=V)
    return {"trace": SpanTrace(vocoder_events(), 1000e-6), "config": cfg,
            "facts": {"window_s": 2.0, "texts": [10, 40, 20],
                      "max_steps": 40, "vocoded_frames": 48},
            "traffic": {}}


def test_span_trace_gives_device_time_by_program_span(ctx):
    t = ctx["trace"]
    # 100 + 50 + the copy's 10 under the first call, 200 under the second;
    # tid 5's kernel and the one launched between the calls are not
    assert t.program_device_s("vocoder.vocode") == pytest.approx(360e-6)
    assert t.program_device_s("vocoder.vocode", "k4") == \
        pytest.approx(200e-6)
    assert t.program_device_s("vocoder.to_host") == pytest.approx(10e-6)
    assert t.program_device_s("serve.batch") == 0.0


def test_vocoder_readers(ctx):
    assert reader("audio.vocode_ms")(ctx) == pytest.approx(0.35)
    assert reader("audio.vocoder_wait_ms")(ctx) == pytest.approx(1.3)
    assert reader("audio.device_idle")(ctx) == pytest.approx(34.0)
    bound = 0.0
    for frames in (1024, 1000):  # the calls' bucket fields
        nbytes, flops = work_hifigan.generator_work(V, frames)
        bound += work.bound(nbytes, {"tf32": flops})[0]
    assert reader("audio.roofline.hifigan")(ctx) == pytest.approx(
        100.0 * bound / 360e-6)


def test_audio_mfu(ctx):
    c = ctx["config"]
    gen = work_hifigan.generator_work(V, 48)[1]
    busy = sum(work.tacotron2_forward_flops(c, n, 40) / 989e12
               + gen / 495e12 for n in (10, 40, 20))
    assert reader("audio.mfu")(ctx) == pytest.approx(100.0 * busy / 2.0)


def test_readers_without_their_spans_give_nothing(ctx):
    """A trace of a program without the vocoder's spans (or none at
    all): every reader of the trace returns None, and none raises."""
    ctx["trace"] = SpanTrace([e for e in vocoder_events()
                              if e["cat"] != "user_annotation"], 1e-3)
    for name in ("audio.vocode_ms", "audio.vocoder_wait_ms",
                 "audio.roofline.hifigan"):
        assert reader(name)(ctx) is None
    ctx["trace"] = None
    for name in ("audio.vocode_ms", "audio.vocoder_wait_ms",
                 "audio.roofline.hifigan", "audio.device_idle"):
        assert reader(name)(ctx) is None
    assert reader("audio.mfu")(dict(ctx, facts={})) is None


# ------------------------------------------------------------ the count

def test_generator_work_by_hand():
    """V: 6 mels, 16 channels, upsampling 4 (k 8) and 2 (k 4), kernels 3
    (dilations 1, 3) and 5 (dilations 1, 2, 4), over 10 frames."""
    T = 10
    macs = T * 6 * 16 * 7                          # conv_pre
    macs += T * 16 * 8 * 8                         # ups.0: 16 -> 8, k 8
    macs += 4 * T * 8 * 8 * (3 * 2 * 2 + 5 * 2 * 3)   # stage 1's fan
    macs += 4 * T * 8 * 4 * 4                      # ups.1: 8 -> 4, k 4
    macs += 8 * T * 4 * 4 * (3 * 2 * 2 + 5 * 2 * 3)   # stage 2's fan
    macs += 8 * T * 4 * 1 * 7                      # conv_post
    nbytes, flops = work_hifigan.generator_work(V, T)
    assert flops == 2 * macs
    words = (T * (6 + 16) + 16 * 6 * 7 + 16               # conv_pre
             + T * 16 + 4 * T * 8 + 16 * 8 * 8 + 8         # ups.0
             + 4 * (4 * T * 16 + 8 * 8 * 3 + 8)            # stage 1, k 3
             + 6 * (4 * T * 16 + 8 * 8 * 5 + 8)            # stage 1, k 5
             + 4 * T * 8 + 8 * T * 4 + 8 * 4 * 4 + 4       # ups.1
             + 4 * (8 * T * 8 + 4 * 4 * 3 + 4)             # stage 2, k 3
             + 6 * (8 * T * 8 + 4 * 4 * 5 + 4)             # stage 2, k 5
             + 8 * T * 5 + 4 * 7 + 1)                      # conv_post
    assert nbytes == 4 * words


def test_v1_costs_0_614_gflop_a_frame():
    """V1's widths: 0.614 GFLOP a mel frame."""
    with open(os.path.join(bench_run.HERE, "configs",
                           "tacotron2-hifigan-v1.json")) as f:
        v1 = json.load(f)["vocoder"]
    assert work_hifigan.generator_work(v1, 1000)[1] / 1000 == \
        pytest.approx(0.614e9, rel=1e-3)


# ------------------------------------------------------------ the loop

SMALL = dict(rate=20.0, max_batch=4, max_steps=40, checked_requests=3,
             spread_checked=4, vocoder_max_frames=40, vocoder_bucket_step=16,
             shares={"16": 0.171, "32": 0.602, "48": 0.228})


def result(capsys, faults=()):
    bench = bench_run.load_json(os.path.join(bench_run.ROOT,
                                             "BENCHMARK.json"))
    cell, _, e2e, layer = bench_run.cell_spec(bench, CELL)
    mix = bench_run.load_json(os.path.join(
        bench_run.HERE, "traffic", cell["traffic"] + ".json"))
    mix.update(SMALL)
    limits = bench_run.load_json(os.path.join(
        bench_run.HERE, "limits", CELL + ".json"))["limits"]
    args = argparse.Namespace(workload=CELL, seed=2_147_483_711,
                              seconds=1.0, trace=0)
    capsys.readouterr()
    line = bench_run.execute(args, cell, e2e, layer,
                             tiny.config(vocoder=V), mix, limits,
                             torch.device("cpu"), "cpu", faults)
    assert bench_run.emit(line) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault, fails", [
    (None, ()),
    ("post_slope", ("audio_gap", "audio_rms")),
    ("alter_window", ("audio_gap", "audio_rms")),
    ("alter_frame", ("postnet_gap",)),
])
def test_audio_check(fault, fails, capsys):
    """Sound, the run is correct; the generator at slope 0.1 before
    ``conv_post``, or one 256-sample window altered, fails the audio
    checks and only those; an altered mel frame fails the mel's."""
    line = result(capsys, (fault,) if fault else ())
    failed = {k for k, c in line["checks"].items()
              if c["value"] > c["limit"]}
    assert line["correct"] is (fault is None), line["checks"]
    assert failed == set(fails), line["checks"]
    assert set(line["checks"]) == {"frames_off", "decoder_rms",
                                   "postnet_gap", "samples_off",
                                   "audio_gap", "audio_rms"}
    assert line["attempted"] == 20 and line["failed"] == 0
    assert set(line["metrics"]) == {"serve_p95_ms", "setup_s"}
