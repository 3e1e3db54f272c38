"""The port's inference demo (``python -m
tacotron2_tpu_torch.tools.inference_demo``) on the CPU, at the widths of
tests/test_torch_infer_cli.py in fp32, on a port checkpoint and on a
reference-format state_dict of the same JAX weights: its mel within REL =
1e-4 of its largest value of the JAX package's ``infer.synthesize`` (the
deterministic prenet: ``prenet_dropout_at_inference=false``), its WAV at
the JAX demo's rate and length (Griffin-Lim's samples start from each
package's own generator), its PNGs with matplotlib, and the WAV alone
without it."""

import os
import sys

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax

from tacotron2_tpu import infer as jinfer
from tacotron2_tpu.models import tacotron2 as jm

from test_torch_infer_cli import CFG, HPARAMS, JCFG, rel_err
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.tools import inference_demo
from tacotron2_tpu_torch.training import state as tstate
from tacotron2_tpu_torch.training.checkpoint import Checkpointer

TEXT = "Waveglow is really awesome!"
REL = 1e-4
DEMO_HPARAMS = HPARAMS + ",max_decoder_steps=12,prenet_dropout_at_inference=false"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX weights, the port's checkpoint of them and the same weights as a
    bare reference-format state_dict; the JAX package's synthesis."""
    root = tmp_path_factory.mktemp("demo")
    params, stats = jm.init_params(jax.random.PRNGKey(0), JCFG)
    sd = state_dict_from_jax(params, stats, CFG)
    model = tm.Tacotron2(CFG, trainable=True)
    model.load_state_dict(sd)
    native = Checkpointer(str(root / "run")).save(
        tstate.state_for(model, CFG), wait=True)
    torch.save(sd, root / "tacotron2_statedict.pt")
    jcfg = JCFG.replace(max_decoder_steps=12,
                        prenet_dropout_at_inference=False)
    [want] = jinfer.synthesize(params, stats, [TEXT], jcfg,
                               vocoder="griffin_lim", griffin_lim_iters=1,
                               rng=jax.random.PRNGKey(0))
    return dict(root=root, native=native,
                torch=str(root / "tacotron2_statedict.pt"), want=want)


def run_demo(weights, which, outdir):
    flags = ["--torch_checkpoint"] if which == "torch" else []
    return inference_demo.main(["-c", weights[which], *flags, "-t", TEXT,
                                "-o", str(outdir), "--hparams", DEMO_HPARAMS,
                                "--device", "cpu"])


@pytest.mark.parametrize("which", ["native", "torch"])
def test_demo_matches_jax_synthesis(weights, which, tmp_path, capsys):
    want = weights["want"]
    got = run_demo(weights, which, tmp_path)
    assert got.mel.shape == want.mel.shape
    assert rel_err(got.mel, want.mel) <= REL
    sr, wav = scipy.io.wavfile.read(tmp_path / "demo.wav")
    assert sr == CFG.sampling_rate == JCFG.sampling_rate
    assert wav.dtype == np.int16
    assert len(wav) == len(want.audio) == len(got.audio)
    assert np.abs(wav).max() > 0
    for name in ("mel.png", "alignment.png", "gate.png"):
        assert (tmp_path / name).stat().st_size > 0
    assert "plots mel.png, alignment.png, gate.png" in capsys.readouterr().out


def test_demo_writes_the_wav_without_matplotlib(weights, tmp_path,
                                                monkeypatch, capsys):
    """The card's machine has no matplotlib: the WAV is written, no PNG,
    and one line says why."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = run_demo(weights, "native", tmp_path)
    sr, wav = scipy.io.wavfile.read(tmp_path / "demo.wav")
    assert len(wav) == len(got.audio) > 0
    assert not list(tmp_path.glob("*.png"))
    out = capsys.readouterr().out
    assert "no plots written" in out and "matplotlib" in out


def test_demo_needs_a_card_unless_asked_for_the_cpu(weights, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_demo.main(["-c", weights["native"], "-o", str(tmp_path),
                             "--hparams", DEMO_HPARAMS])
    assert not os.path.exists(tmp_path / "demo.wav")
