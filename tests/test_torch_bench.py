"""The port's benchmarks (``tacotron2_tpu_torch/bench.py``,
``tools/bench_buckets.py``, ``tools/bench_default.py``,
``tools/bench_details.py``) on the CPU at small widths: the JSON lines they
print, the bucket blend held against the JAX scripts' own formula, and the
stage list. The times they print here are the CPU's and say nothing of the
card's."""

import json
import math
import os

import pytest
import torch

from tacotron2_tpu_torch import bench
from tacotron2_tpu_torch.config import create_config
from tacotron2_tpu_torch.tools import bench_buckets, bench_default, bench_details

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(symbols_embedding_dim=16, encoder_embedding_dim=16,
             encoder_n_convolutions=1, attention_rnn_dim=16,
             decoder_rnn_dim=16, prenet_dim=8, attention_dim=8,
             attention_location_n_filters=4, attention_location_kernel_size=7,
             postnet_embedding_dim=16, postnet_n_convolutions=2,
             n_mel_channels=16, compute_dtype="float32")
HPARAMS = ",".join(f"{k}={v}" for k, v in SMALL.items())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def test_bench_prints_one_line_with_root_bench_keys(capsys):
    """One JSON line, root bench.py's four keys, vs_baseline the real-time
    factor value / (sampling_rate / hop_length)."""
    got = bench.main(["--device", "cpu", "--hparams",
                      HPARAMS + ",batch_size=2"])
    [line] = json_lines(capsys.readouterr().out)
    assert line == got
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "train_mel_frames_per_s_per_chip"
    assert line["unit"] == "mel-frames/s/chip"
    cfg = create_config()
    assert line["value"] > 0
    assert math.isclose(line["vs_baseline"], line["value"] / (
        cfg.sampling_rate / cfg.hop_length), abs_tol=0.01)


def test_bench_config_sets_the_jax_knobs_the_port_ignores():
    cfg = bench.bench_config()
    assert (cfg.batch_size, cfg.compute_dtype) == (128, "bfloat16")
    assert (cfg.decoder_scan_unroll, cfg.prng_impl) == (8, "unsafe_rbg")
    assert bench.bench_config("batch_size=4").batch_size == 4


def test_time_steps_warms_then_times(monkeypatch):
    calls = []
    clock = iter([10.0, 13.0])
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(clock))
    dt = bench.time_steps(lambda: calls.append(1), 3, "cpu", warm=2)
    assert len(calls) == 5 and dt == 1.0


def _jax_blend(script, rows, B):
    """The blend as the JAX script computes it: its own lines, from the
    shares to the total time, run on ``rows``."""
    src = open(os.path.join(REPO, "tools", script)).read().splitlines()
    first = next(i for i, l in enumerate(src) if l.startswith("p = {"))
    last = next(i for i, l in enumerate(src) if l.startswith("tot_time ="))
    ns = {"rows": rows, "B": B}
    exec("\n".join(src[first:last + 1]), ns)
    return ns["p"], ns["tot_frames"] / ns["tot_time"]


@pytest.mark.parametrize("script,B", [("bench_buckets.py", 128),
                                      ("bench_default.py", 64)])
def test_blend_is_the_jax_scripts_formula(script, B):
    rows = {64: {"t_out": 256, "ms_per_step": 101.3, "frames_per_s": 1},
            128: {"t_out": 512, "ms_per_step": 247.9, "frames_per_s": 1},
            192: {"t_out": 768, "ms_per_step": 419.6, "frames_per_s": 1}}
    shares, want = _jax_blend(script, rows, B)
    assert shares == bench_buckets.SHARES
    assert bench_buckets.blend(rows, bench_buckets.SHARES, B) == want


def test_bench_default_prints_the_jax_scripts_keys(capsys):
    """The stock config's run at small widths (B=2, one timed step a
    bucket): the JAX script's keys, one row per bucket, its headline the
    128 bucket's row, its blend ``blend`` of the rows."""
    got = bench_default.run(1, "cpu", HPARAMS + ",batch_size=2")
    line = json_lines(capsys.readouterr().out)[-1]
    assert set(line) == {"default_headline_frames_per_s",
                         "default_blended_frames_per_s", "rows"}
    assert {int(k): v["t_out"] for k, v in line["rows"].items()} == dict(
        bench_buckets.SHAPES)
    assert line["default_headline_frames_per_s"] == (
        got["rows"][128]["frames_per_s"])
    assert line["default_blended_frames_per_s"] == round(
        bench_buckets.blend(got["rows"], bench_buckets.SHARES, 2))


def test_bench_details_refuses_an_unknown_stage(capsys):
    with pytest.raises(SystemExit) as e:
        bench_details.main(["train_bf16", "warp_drive", "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown stages: ['warp_drive']" in capsys.readouterr().err


def test_bench_details_stages_write_the_jax_fields(tmp_path):
    """Two stages at small widths, one timed call each: the JAX script's
    fields, finite, written where ``out`` says and nowhere else (never the
    JAX package's BENCH_DETAILS.json)."""
    before = os.path.getmtime(os.path.join(REPO, "BENCH_DETAILS.json"))
    out = tmp_path / "details.json"
    got = bench_details.Bench("cpu", steps=1, reps=0.01,
                              hparams=HPARAMS + ",max_decoder_steps=24").run(
        ["train_fp32", "infer1"])
    bench_details.write(got, str(out))
    assert json.loads(out.read_text()) == got
    assert set(got) == {
        "train_float32_mel_frames_per_s", "train_float32_audio_sec_per_s",
        "train_float32_step_ms", "infer_b1_rtf", "infer_b1_frames_per_s",
        "infer_b1_ms_per_frame"}
    assert all(math.isfinite(v) and v > 0 for v in got.values())
    assert os.path.getmtime(os.path.join(REPO, "BENCH_DETAILS.json")) == before
