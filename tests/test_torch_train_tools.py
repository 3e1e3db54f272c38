"""The port's training CLI, the tone-corpus demo and the quality gate's
tools on the CPU, at narrow widths: the CLI trains and resumes, the demo's
corpus is the JAX demo's byte for byte, the gate's scoring reads the
corpus's own audio right and rejects it one character off, a demo run
resumes from its checkpoints, the gate merges its runs into one file, and
the known-bad probe build's define sits where it must."""

import importlib.util
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tacotron2_tpu_torch import train as tcli
from tacotron2_tpu_torch.audio.mel import MelConfig
from tacotron2_tpu_torch.data.dataset import mel_spectrogram_np
from tacotron2_tpu_torch.kernels import _build, gate_probe
from tacotron2_tpu_torch.tools import synthesis_check as sc
from tacotron2_tpu_torch.tools import train_demo
from tacotron2_tpu_torch.training.checkpoint import Checkpointer

REPO = Path(__file__).resolve().parents[1]
NARROW = ("symbols_embedding_dim=16,encoder_embedding_dim=16,"
          "encoder_n_convolutions=1,attention_rnn_dim=16,decoder_rnn_dim=16,"
          "prenet_dim=8,attention_dim=8,attention_location_n_filters=2,"
          "attention_location_kernel_size=5,postnet_embedding_dim=8,"
          "postnet_n_convolutions=2,compute_dtype=float32,"
          "max_decoder_steps=24")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_demo():
    """The JAX package's tools/train_demo.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_demo", REPO / "tools" / "train_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_utts,seed", [(12, 0), (5, 3)])
def test_build_corpus_writes_the_jax_demos_bytes(tmp_path, n_utts, seed):
    got = train_demo.build_corpus(str(tmp_path / "port"), n_utts, seed)
    want = jax_demo().build_corpus(str(tmp_path / "jax"), n_utts, seed)
    g_lines = Path(got).read_text().split("\n")
    w_lines = Path(want).read_text().split("\n")
    assert len(g_lines) == len(w_lines) == n_utts
    for g, w in zip(g_lines, w_lines):
        (g_path, g_text), (w_path, w_text) = g.split("|"), w.split("|")
        assert g_text == w_text
        assert os.path.basename(g_path) == os.path.basename(w_path)
        assert Path(g_path).read_bytes() == Path(w_path).read_bytes()


def test_build_corpus_long_utterances(tmp_path):
    """words=(12, 22): 12 to 21 words an utterance, each character one
    80 ms tone, so 5-10 s of audio at these words' lengths."""
    filelist = train_demo.build_corpus(str(tmp_path), 16, 0, words=(12, 22))
    for line in Path(filelist).read_text().split("\n"):
        path, text = line.split("|")
        assert 12 <= len(text.split()) <= 21
        sr, audio = scipy.io.wavfile.read(path)
        assert len(audio) == len(text) * train_demo.TONE_SAMPLES
        assert 4.0 <= len(audio) / sr <= 10.5


def corpus_mel(text):
    cfg = train_demo.demo_config()
    audio = train_demo.tone_audio(text).astype(np.float32)
    mel = mel_spectrogram_np(audio / cfg.max_wav_value,
                             MelConfig.from_config(cfg))
    return mel.T, cfg  # (frames, n_mels), as synthesize returns it


def test_scoring_reads_the_corpus_audio():
    text = "we like jax"
    mel, cfg = corpus_mel(text)
    res = sc.score_mel(mel, text, cfg, 60.0)
    assert res == {"chars_matched": 11, "total": 11,
                   "frames": mel.shape[0]}


@pytest.mark.parametrize("direction", [1, -1])
def test_scoring_rejects_a_mel_one_character_off(direction):
    text = "we like jax"
    mel, cfg = corpus_mel(text)
    shift = round(train_demo.TONE_SAMPLES / cfg.hop_length)
    res = sc.score_mel(np.roll(mel, direction * shift, axis=0), text, cfg,
                       60.0)
    assert res["total"] == 11 and res["chars_matched"] < 11


def test_scoring_counts_only_whole_characters():
    mel, cfg = corpus_mel("we like")
    res = sc.score_mel(mel, "we like jax", cfg, 60.0)
    assert res["total"] == 7 and res["chars_matched"] == 7


def test_demo_trains_resumes_and_the_gate_checks_it(tmp_path):
    out = str(tmp_path / "demo")
    first = train_demo.run(2, out, batch=4, hparams=NARROW, device="cpu",
                           n_utts=12)
    assert first["steps"] == 2 and first["resumed_from"] == 0
    second = train_demo.run(3, out, batch=4, hparams=NARROW, device="cpu",
                            n_utts=12)
    assert second["steps"] == 3 and second["resumed_from"] == 2
    # one wait a step, summed by epoch: steps 2 of epoch 0 at 3 an epoch
    assert second["steps_per_epoch"] == 3
    assert len(second["prefetch_wait_by_epoch_s"]) == 1
    assert (sum(first["prefetch_wait_by_epoch_s"])
            <= first["prefetch_wait_s"] + 1e-9)
    assert np.isfinite(second["final_loss"])
    assert set(second["alignment"]) >= {"alignment/sharpness",
                                        "alignment/diagonal_deviation"}
    assert Checkpointer(out).latest().endswith("checkpoint_3.pt")
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f)["steps"] == 3
    res = sc.check_checkpoint(out, hparams=NARROW, device="cpu")
    assert res["step"] == 3
    for name in ("step_by_step", "fused"):
        assert res[name]["total"] <= 11
        assert res[name]["frames"] <= 24
    assert res["pass"] == all(res[k]["chars_matched"] == 11
                              for k in ("step_by_step", "fused"))


def test_run_gate_merges_runs_into_one_file(tmp_path):
    out = str(tmp_path / "gate.json")
    work = str(tmp_path / "work")
    kw = dict(text="we like jax", tolerance_hz=60.0, out_path=out,
              workdir=work, batch=4, n_utts=8, device="cpu")
    sc.run_gate(1, [3], hparams=NARROW, **kw)
    gate = sc.run_gate(1, [4], hparams=NARROW, **kw)
    with open(out) as f:
        assert json.load(f) == gate
    assert sorted(gate["runs"]) == [
        sc.run_label(s, 1, 4, NARROW, False) for s in (3, 4)]
    run = gate["runs"][sc.run_label(4, 1, 4, NARROW, False)]
    for key in ("date", "commit", "source_sha256", "card", "power_limit",
                "steps", "step_by_step", "fused", "final_loss", "wall_s",
                "median_step_ms", "pass"):
        assert key in run, key
    assert run["steps"] == 1 and run["hparams"] == f"seed=4,{NARROW}"
    # runs at another batch size or with overrides are outside the verdict
    assert gate["pass"] is False
    assert re.fullmatch(r"[0-9a-f]{64}", run["source_sha256"])


def test_train_cli_on_the_cpu(tmp_path):
    root = tmp_path / "corpus"
    root.mkdir()
    rng = np.random.RandomState(0)
    lines = []
    for i in range(4):
        wav = (rng.randn(4096 + 1024 * i) * 2000).astype(np.int16)
        scipy.io.wavfile.write(root / f"utt{i}.wav", 22050, wav)
        lines.append(f"{root / f'utt{i}.wav'}|utterance number {i}")
    (root / "list.txt").write_text("\n".join(lines))
    hp = (f"{NARROW},training_files={root / 'list.txt'},"
          f"validation_files={root / 'list.txt'},batch_size=2,epochs=2,"
          "iters_per_checkpoint=2,text_buckets=32;64,mel_bucket_step=32,"
          "max_mel_length=96")
    out = tmp_path / "run"
    tcli.main(["-o", str(out), "-l", "logs", "--hparams", hp,
               "--device", "cpu"])
    ckpt = Checkpointer(str(out))
    assert ckpt.latest().endswith("checkpoint_4.pt")
    assert (out / "logs" / "metrics.jsonl").stat().st_size > 0
    # warm start from it into a fresh run: step 0, weights loaded
    tcli.main(["-o", str(tmp_path / "warm"), "-c", ckpt.latest(),
               "--warm_start", "--hparams", hp.replace("epochs=2",
                                                      "epochs=1"),
               "--device", "cpu"])
    assert Checkpointer(str(tmp_path / "warm")).latest().endswith(
        "checkpoint_2.pt")


def test_train_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-o", str(tmp_path / "run"), "--hparams", NARROW])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_demo.run(1, str(tmp_path / "demo"), hparams=NARROW, n_utts=4)


def test_known_bad_define_sits_at_both_dprocessed_stores():
    """The probe build's define guards exactly the two d_processed stores;
    without it the shipped statements compile."""
    src = (_build.CSRC / "train_scan.cu").read_text()
    blocks = re.findall(r"#ifdef SCAN_DPROC_BF16[^\n]*\n(.*?)\n#else\n"
                        r"(.*?)\n#endif", src, flags=re.S)
    assert [b.strip() for _, b in blocks] == [
        "a.dproc[o] += dm;", "a.dproc[o] = dp[j][e] + dm;"]
    for bad, _ in blocks:
        assert "rnd<" in bad and "a.dproc[o] =" in bad
    assert "SCAN_DPROC_BF16" not in " ".join(_build.NVCC_FLAGS)


def test_known_bad_install_refuses_a_loaded_shipped_library():
    saved = _build._LIBS.get("train_scan")
    _build._LIBS["train_scan"] = object()
    try:
        with pytest.raises(RuntimeError, match="already loaded"):
            gate_probe.install()
    finally:
        if saved is None:
            del _build._LIBS["train_scan"]
        else:
            _build._LIBS["train_scan"] = saved
