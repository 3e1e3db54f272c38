"""The port's inference command line (``python -m tacotron2_tpu_torch.infer``,
``infer.main``) run in-process on the CPU, on a port checkpoint and on
vocoder checkpoints in the trainers' format, at the JAX HTTP tests' widths
(attention_rnn_dim=20) in fp32.

Each ``<prefix>_<i>_mel.npy`` is held against the JAX package's
``infer.synthesize`` on the same weights within REL = 1e-4 of its largest
value; each WAV by its rate and length (Griffin-Lim's: that of the JAX
package's, whose start phase is drawn from its own generator), and
HiFi-GAN's samples against the JAX package's within 2 int16 steps
(ATOL_PCM). The flags it refuses exit with argparse's code 2.
"""

import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu import infer as jinfer
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.models import hifigan as jh
from tacotron2_tpu.models import tacotron2 as jm

from tacotron2_tpu_torch import infer
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import (hifigan_state_dict_from_jax,
                                         state_dict_from_jax)
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.models import waveglow as twg
from tacotron2_tpu_torch.training import state as tstate
from tacotron2_tpu_torch.training.checkpoint import Checkpointer

KW = dict(
    n_symbols=148, symbols_embedding_dim=16, encoder_embedding_dim=16,
    encoder_n_convolutions=2, attention_rnn_dim=20, decoder_rnn_dim=24,
    prenet_dim=8, attention_dim=12, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=16,
    postnet_n_convolutions=3, n_mel_channels=8, max_decoder_steps=8,
    filter_length=64, hop_length=16, win_length=64, compute_dtype="float32")
HPARAMS = ",".join(f"{k}={v}" for k, v in KW.items())
JCFG, CFG = JaxConfig(**KW), Tacotron2Config(**KW)
HG = dict(n_mel_channels=8, upsample_rates=(4, 4),
          upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
WG = twg.WaveGlowConfig(n_mel_channels=8, n_flows=4, n_early_every=2,
                        wn_layers=2, wn_channels=16, upsample_kernel=64,
                        upsample_stride=16)
TEXTS = ["hello world", "hi"]
REL, ATOL_PCM = 1e-4, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX weights; the port's checkpoint of them written by
    ``Checkpointer``; a HiFi-GAN and a WaveGlow checkpoint in the vocoder
    trainers' format (kind, config, state_dict)."""
    root = tmp_path_factory.mktemp("infer_cli")
    params, stats = jm.init_params(jax.random.PRNGKey(0), JCFG)
    model = tm.Tacotron2(CFG, trainable=True)
    model.load_state_dict(state_dict_from_jax(params, stats, CFG))
    ckpt = Checkpointer(str(root / "run")).save(
        tstate.state_for(model, CFG), wait=True)
    rng = np.random.RandomState(1)
    gparams = jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.3
                              / np.sqrt(max(p.size // p.shape[-1], 1))),
        jh.init_generator(jax.random.PRNGKey(1), jh.HiFiGANConfig(**HG)))
    hg_path, wg_path = str(root / "hifigan.pt"), str(root / "waveglow.pt")
    # the JAX package's slope before conv_post, carried by the checkpoint
    tcfg = th.HiFiGANConfig(**HG, post_lrelu_slope=jh.LRELU_SLOPE)
    torch.save({"kind": "hifigan", "config": tcfg._asdict(),
                "state_dict": hifigan_state_dict_from_jax(gparams, tcfg)},
               hg_path)
    wg = twg.WaveGlow(WG, torch.Generator().manual_seed(2))
    with torch.no_grad():
        for wn in wg.WN:
            wn.end.weight.normal_(0, 0.05)
    torch.save({"kind": "waveglow", "config": WG._asdict(),
                "state_dict": wg.state_dict()}, wg_path)
    return dict(root=root, ckpt=ckpt, params=params, stats=stats,
                gparams=gparams, hifigan=hg_path, waveglow=wg_path)


def run(world, name, *flags, texts=TEXTS):
    prefix = str(world["root"] / "out" / name)
    argv = ["-c", world["ckpt"], "-o", prefix, "--hparams", HPARAMS,
            "--device", "cpu", *flags]
    for t in texts:
        argv += ["-t", t]
    infer.main(argv)
    return prefix


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def read_wav(path):
    sr, data = scipy.io.wavfile.read(path)
    assert sr == CFG.sampling_rate and data.dtype == np.int16
    return data


@pytest.mark.parametrize("vocoder", ["none", "griffin_lim", "hifigan",
                                     "waveglow"])
def test_main_writes_mels_and_wavs(world, vocoder):
    flags = ["--vocoder", vocoder]
    if vocoder in ("hifigan", "waveglow"):
        flags += ["--vocoder_checkpoint", world[vocoder]]
    prefix = run(world, vocoder, *flags)
    want = jinfer.synthesize(
        world["params"], world["stats"], TEXTS, JCFG,
        vocoder="hifigan" if vocoder == "hifigan" else "none",
        vocoder_params=world["gparams"], vocoder_cfg=jh.HiFiGANConfig(**HG))
    if vocoder == "griffin_lim":
        gl = jinfer.synthesize(world["params"], world["stats"], TEXTS, JCFG,
                               vocoder="griffin_lim", griffin_lim_iters=1)
    for i, w in enumerate(want):
        mel = np.load(f"{prefix}_{i}_mel.npy")
        assert mel.shape == (CFG.n_mel_channels, w.mel.shape[0])
        assert rel_err(mel.T, w.mel) <= REL, i
        wav = f"{prefix}_{i}.wav"
        if vocoder == "none":
            assert not os.path.exists(wav)
            continue
        data = read_wav(wav)
        if vocoder == "griffin_lim":  # the JAX package's length for it
            assert data.shape == gl[i].audio.shape
        else:
            assert data.shape == (w.mel.shape[0] * CFG.hop_length,)
        assert np.abs(data).max() > 0
        if vocoder == "hifigan":
            pcm = (np.clip(w.audio, -1, 1) * 32767).astype(np.int16)
            assert np.abs(data.astype(int) - pcm).max() <= ATOL_PCM


@pytest.mark.parametrize("flag", ["--fused", "--int8"])
def test_main_fused_and_int8(world, flag):
    """--fused (the single-utterance chunk, its plain version here) gives
    the step-by-step decoder's mel; --int8 the JAX package's quantized
    model's."""
    prefix = run(world, flag.strip("-"), flag, "--vocoder", "none",
                 texts=TEXTS[:1])
    params = world["params"]
    if flag == "--int8":
        params = jm.quantize_for_serving(params)
    (want,) = jinfer.synthesize(params, world["stats"], TEXTS[:1], JCFG,
                                vocoder="none")
    mel = np.load(f"{prefix}_0_mel.npy")
    assert rel_err(mel.T, want.mel) <= REL


@pytest.mark.parametrize("flags", [
    ["--vocoder", "hifigan"],                   # no vocoder weights
    ["--vocoder", "waveglow"],
    ["--vocoder", "wavenet"],                   # not a vocoder
    ["--fused", "--int8"],
    ["--fused", "-t", "a second text"],
], ids=["hifigan", "waveglow", "unknown", "fused-int8", "fused-two"])
def test_main_refuses(world, flags):
    with pytest.raises(SystemExit) as exc:
        run(world, "refused", *flags)
    assert exc.value.code == 2


def test_load_vocoder_checks_the_checkpoint(world):
    """A vocoder checkpoint of another kind, or of other mel channels, is
    refused."""
    with pytest.raises(ValueError, match="not a waveglow"):
        infer.load_vocoder("waveglow", world["hifigan"], CFG, device="cpu")
    with pytest.raises(ValueError, match="mels"):
        infer.load_vocoder("hifigan", world["hifigan"],
                           CFG.replace(n_mel_channels=80), device="cpu")
    module, cfg = infer.load_vocoder("waveglow", world["waveglow"], CFG,
                                     device="cpu")
    assert cfg == WG and isinstance(module, twg.WaveGlow)
