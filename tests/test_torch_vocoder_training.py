"""Vocoder training and audio batches on the port against the JAX package,
fp32 on the CPU at small widths.

- The HiFi-GAN discriminators (models/hifigan.py; full width, they have no
  width option) and the three losses.
- One WaveGlow step (training/vocoder_trainer.py) and one HiFi-GAN step
  (training/hifigan_trainer.py) against the JAX step on the same batch:
  the losses and every parameter after the step.
- The segment sampler: the same crops as the JAX package's from the same
  corpus and seed.
- The mel targets of raw-audio batches (training/audio_batch.py), and the
  loss of ``train_step_from_audio``.
- Checkpoints of both trainers, and the loops and tools that write them.

Tolerance: each field's largest |err| as a share of its largest |value|
(REL = 1e-4; REL_LOSS = 1e-5 for the Tacotron 2 loss). Weights cross
through the port's ``convert`` functions; data from numpy seeds go to both.
"""

import functools
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax
import jax.numpy as jnp
import optax

from tacotron2_tpu.audio.mel import MelConfig as JaxMelConfig
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.data.dataset import TextMelDataset as JaxDataset
from tacotron2_tpu.kernels.mel_kernel import mel_spectrogram_pallas
from tacotron2_tpu.models import hifigan as jh
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.models import waveglow as jwg
from tacotron2_tpu.training import audio_batch as jab
from tacotron2_tpu.training import hifigan_trainer as jht
from tacotron2_tpu.training import loss as jloss
from tacotron2_tpu.training import vocoder_trainer as jvt

from tacotron2_tpu_torch import infer as tinfer
from tacotron2_tpu_torch.audio.mel import MelConfig, mel_spectrogram_backend
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import (discriminator_state_dicts_from_jax,
                                         hifigan_state_dict_from_jax,
                                         state_dict_from_jax,
                                         waveglow_state_dict_from_jax)
from tacotron2_tpu_torch.data.dataset import TextMelDataset
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.models import waveglow as twg
from tacotron2_tpu_torch.tools import train_hifigan as hifigan_tool
from tacotron2_tpu_torch.tools import train_vocoder as vocoder_tool
from tacotron2_tpu_torch.training import audio_batch as tab
from tacotron2_tpu_torch.training import hifigan_trainer as tht
from tacotron2_tpu_torch.training import state as tstate
from tacotron2_tpu_torch.training import vocoder_trainer as tvt
from tacotron2_tpu_torch.training.checkpoint import Checkpointer, load

REL, REL_LOSS = 1e-4, 1e-5
AUDIO = dict(filter_length=64, hop_length=16, win_length=64,
             n_mel_channels=8)
TACO = dict(n_symbols=148, symbols_embedding_dim=16, encoder_embedding_dim=16,
            encoder_n_convolutions=2, attention_rnn_dim=20,
            decoder_rnn_dim=24, prenet_dim=8, attention_dim=12,
            attention_location_n_filters=4,
            attention_location_kernel_size=7, postnet_embedding_dim=16,
            postnet_n_convolutions=3, compute_dtype="float32", **AUDIO)
MEL_KW = dict(AUDIO, sampling_rate=22050, mel_fmin=0.0, mel_fmax=8000.0)
HG = dict(n_mel_channels=8, upsample_rates=(4, 4),
          upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
WG = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
          n_early_size=2, wn_layers=2, wn_channels=16, upsample_kernel=64,
          upsample_stride=16)
B, SEG_MELS = 2, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_err(got, want):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_close_by_name(got, want, rel=REL):
    assert set(got) == set(want)
    bad = {k: e for k in got if (e := rel_err(got[k], want[k])) > rel}
    assert not bad, f"beyond {rel} of the largest value: {bad}"


def scaled(tree, seed, scale=0.3):
    """Weights redrawn at N(0, scale^2 / fan_in): the init's N(0, 0.01)
    leaves activations too small for a tolerance to mean much."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * scale
                              / np.sqrt(max(p.size // p.shape[-1], 1))),
        tree)


# ----------------------------------------------------------- discriminators

@pytest.fixture(scope="module")
def discriminators():
    jcfg, tcfg = jh.HiFiGANConfig(**HG), th.HiFiGANConfig(**HG)
    mpd = scaled(jh.init_mpd(jax.random.PRNGKey(1), jcfg), 1)
    msd = scaled(jh.init_msd(jax.random.PRNGKey(2), jcfg), 2)
    tmpd, tmsd = th.MultiPeriodDiscriminator(tcfg), \
        th.MultiScaleDiscriminator(tcfg)
    mpd_sd, msd_sd = discriminator_state_dicts_from_jax(mpd, msd, tcfg)
    tmpd.load_state_dict(mpd_sd, strict=True)
    tmsd.load_state_dict(msd_sd, strict=True)
    rng = np.random.RandomState(3)
    real = (rng.randn(B, 101) * 0.3).astype(np.float32)  # ragged for MPD
    fake = (rng.randn(B, 101) * 0.3).astype(np.float32)
    return jcfg, mpd, msd, tmpd, tmsd, real, fake


def _fmap_nchw(fm):
    """A JAX feature map in the port's layout: MPD NHWC -> NCHW, MSD
    (B, T, C) -> (B, C, T)."""
    fm = np.asarray(fm)
    return fm.transpose(0, 3, 1, 2) if fm.ndim == 4 else fm.transpose(0, 2, 1)


def test_discriminators_match_jax(discriminators):
    """Logits and every feature map of the five period and three scale
    discriminators."""
    jcfg, mpd, msd, tmpd, tmsd, real, _ = discriminators
    jl, jf = jh.discriminate(mpd, msd, jnp.asarray(real), jcfg)
    tl, tf = th.discriminate(tmpd, tmsd, torch.from_numpy(real))
    assert len(tl) == len(jl) == len(jcfg.mpd_periods) + jcfg.msd_scales
    for d, (g, w) in enumerate(zip(tl, jl)):
        assert rel_err(g, w) <= REL, ("logits", d)
    for d, (gs, ws) in enumerate(zip(tf, jf)):
        assert len(gs) == len(ws)
        for k, (g, w) in enumerate(zip(gs, ws)):
            assert rel_err(g, _fmap_nchw(w)) <= REL, ("fmap", d, k)


def test_losses_match_jax(discriminators):
    jcfg, mpd, msd, tmpd, tmsd, real, fake = discriminators
    jr, jrf = jh.discriminate(mpd, msd, jnp.asarray(real), jcfg)
    jg, jgf = jh.discriminate(mpd, msd, jnp.asarray(fake), jcfg)
    tr, trf = th.discriminate(tmpd, tmsd, torch.from_numpy(real))
    tg, tgf = th.discriminate(tmpd, tmsd, torch.from_numpy(fake))
    for got, want in (
            (th.discriminator_loss(tr, tg), jh.discriminator_loss(jr, jg)),
            (th.generator_adversarial_loss(tg),
             jh.generator_adversarial_loss(jg)),
            (th.feature_matching_loss(trf, tgf),
             jh.feature_matching_loss(jrf, jgf))):
        assert rel_err(got, want) <= REL


# ------------------------------------------------------------- one step

def _vocoder_batch(seed, n_mels=8, hop=16):
    rng = np.random.RandomState(seed)
    audio = (rng.randn(B, SEG_MELS * hop) * 0.3).astype(np.float32)
    mel = rng.randn(B, SEG_MELS, n_mels).astype(np.float32)
    return (jvt.VocoderBatch(jnp.asarray(audio), jnp.asarray(mel)),
            tvt.VocoderBatch(torch.from_numpy(audio), torch.from_numpy(mel)))


def test_waveglow_step_matches_jax():
    """One NLL + Adam step from perturbed weights (the JAX init's zero
    ``WN.end`` makes every coupling the identity): the loss and every
    parameter after the step."""
    jcfg, tcfg = jwg.WaveGlowConfig(**WG), twg.WaveGlowConfig(**WG)
    params = jwg.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32), params)
    js = jvt.VocoderTrainState(jnp.zeros((), jnp.int32), params,
                               optax.adam(1e-4).init(params))
    state = tvt.create_vocoder_state(tcfg, 1e-4, device="cpu")
    state.model.load_state_dict(waveglow_state_dict_from_jax(params, tcfg))
    jb, tb = _vocoder_batch(2)
    js, jl = jvt.vocoder_train_step(js, jb, jcfg, learning_rate=1e-4)
    state, loss = tvt.vocoder_train_step(state, tb, tcfg)
    assert state.step == 1
    assert rel_err(loss, jl) <= REL
    assert_close_by_name(
        {k: v for k, v in state.model.named_parameters()},
        waveglow_state_dict_from_jax(js.params, tcfg))


def test_hifigan_step_matches_jax():
    """One D-then-G step (the generator small, the discriminators at full
    width): the four losses, the generator's and both discriminators'
    parameters after the step (AdamW at betas 0.8, 0.99 and weight decay
    1e-4 on both sides). From ``scaled`` weights and biases: a bias that
    starts at zero is, after one step, the Adam step itself, whose
    elements of small gradient turn fp32 rounding into 3e-4 to 6e-4 of
    its largest value (measured on the JAX init)."""
    jcfg = jh.HiFiGANConfig(**HG)
    # the JAX package's slope before conv_post
    tcfg = th.HiFiGANConfig(**HG, post_lrelu_slope=jh.LRELU_SLOPE)
    jmel, tmel = JaxMelConfig(**MEL_KW), MelConfig(**MEL_KW)
    js = jht.create_hifigan_state(jax.random.PRNGKey(0), jcfg)
    gen, mpd, msd = (scaled(t, seed) for seed, t in enumerate(
        (js.gen_params, js.mpd_params, js.msd_params)))
    tx = jht.make_optimizer()
    js = js._replace(gen_params=gen, mpd_params=mpd, msd_params=msd,
                     gen_opt=tx.init(gen),
                     disc_opt=tx.init({"mpd": mpd, "msd": msd}))
    state = tht.create_hifigan_state(tcfg, device="cpu")
    state.generator.load_state_dict(
        hifigan_state_dict_from_jax(js.gen_params, tcfg))
    mpd_sd, msd_sd = discriminator_state_dicts_from_jax(
        js.mpd_params, js.msd_params, tcfg)
    state.mpd.load_state_dict(mpd_sd)
    state.msd.load_state_dict(msd_sd)
    jb, tb = _vocoder_batch(4)
    step = jax.jit(functools.partial(jht.hifigan_train_step, cfg=jcfg,
                                     mel_cfg=jmel))
    js, jlosses = step(js, jb)
    state, losses = tht.hifigan_train_step(state, tb, tcfg, tmel)
    assert state.step == 1
    for name, g, w in zip(tht.HiFiGANLosses._fields, losses, jlosses):
        assert rel_err(g, w) <= REL, name
    assert_close_by_name(dict(state.generator.named_parameters()),
                         hifigan_state_dict_from_jax(js.gen_params, tcfg))
    mpd_sd, msd_sd = discriminator_state_dicts_from_jax(
        js.mpd_params, js.msd_params, tcfg)
    assert_close_by_name(dict(state.mpd.named_parameters()), mpd_sd)
    assert_close_by_name(dict(state.msd.named_parameters()), msd_sd)


def test_hifigan_learning_rate_schedule():
    """optax.exponential_decay(2e-4, 1000, 0.999, staircase=True)."""
    sched = optax.exponential_decay(2e-4, 1000, 0.999, staircase=True)
    for step in (0, 999, 1000, 2500, 10_000):
        assert tht.learning_rate_at(step, 2e-4) == pytest.approx(
            float(sched(step)), rel=1e-6)


# ------------------------------------------------------------ the corpus

def write_corpus(root, seed=0):
    """Six int16 wavs at 22050 Hz of 40 to 440 samples (the shortest
    shorter than a segment and a hop, which the sampler skips) and a
    ``path|text`` filelist."""
    rng = np.random.RandomState(seed)
    lines = []
    for i, n in enumerate((40, 440, 200, 320, 90, 260)):
        path = os.path.join(root, f"utt{i}.wav")
        scipy.io.wavfile.write(path, 22050,
                               (rng.randn(n) * 3000).astype(np.int16))
        lines.append(f"{path}|utterance {i}")
    filelist = os.path.join(root, "files.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(lines) + "\n")
    return filelist


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("vocoder_corpus")))


def test_segment_sampler_matches_jax(corpus):
    """The same crops as the JAX package's sampler: the audio bit for bit,
    the mel within REL; shapes (B, SEG_MELS * hop) and (B, SEG_MELS,
    n_mels)."""
    jds = JaxDataset(corpus, JaxConfig(**TACO), shuffle=False,
                     use_native=False)
    tds = TextMelDataset(corpus, Tacotron2Config(**TACO), shuffle=False)
    jit = jvt.segment_sampler(jds, JaxMelConfig(**MEL_KW), SEG_MELS, 3,
                              seed=5)
    tit = tvt.segment_sampler(tds, MelConfig(**MEL_KW), SEG_MELS, 3, seed=5)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert tuple(tb.audio.shape) == (3, SEG_MELS * 16)
        assert tuple(tb.mel.shape) == (3, SEG_MELS, 8)
        assert tb.audio.dtype == tb.mel.dtype == torch.float32
        np.testing.assert_array_equal(tb.audio.numpy(), np.asarray(jb.audio))
        assert rel_err(tb.mel, jb.mel) <= REL


# ----------------------------------------------------- checkpoints, loops

def test_vocoder_loops_checkpoint_and_resume(corpus, tmp_path):
    """Both loops at small widths on the CPU write checkpoints (kind,
    config, state_dict, optimizer state); a fresh state restored from the
    last holds the same weights and optimizer moments; ``load_vocoder``
    builds the generator of either from its file."""
    cfg = Tacotron2Config(**TACO)
    ds = TextMelDataset(corpus, cfg)
    mel_cfg = MelConfig(**MEL_KW)
    common = dict(mel_cfg=mel_cfg, steps=2, batch_size=B,
                  segment_mels=SEG_MELS, log_every=1, checkpoint_every=1,
                  device="cpu")
    wg_cfg, hg_cfg = twg.WaveGlowConfig(**WG), th.HiFiGANConfig(**HG)
    runs = (
        ("waveglow", tvt.train_vocoder(ds, str(tmp_path / "waveglow"), wg_cfg,
                                       **common),
         lambda: tvt.create_vocoder_state(wg_cfg, device="cpu"),
         lambda s: s.model),
        ("hifigan", tht.train_hifigan(ds, str(tmp_path / "hifigan"), hg_cfg,
                                      **common),
         lambda: tht.create_hifigan_state(hg_cfg, device="cpu"),
         lambda s: s.generator))
    for kind, trained, fresh, vocoder in runs:
        ckpt = Checkpointer(str(tmp_path / kind))
        names = [os.path.basename(p) for p in ckpt.all_checkpoints()]
        assert names == ["checkpoint_1.pt", "checkpoint_2.pt"], kind
        blob = load(ckpt.latest())
        assert blob["kind"] == kind and blob["iteration"] == 2
        restored = ckpt.restore(fresh())
        assert restored.step == 2
        for a, b in zip(trained.snapshot()["state_dict"].values(),
                        restored.snapshot()["state_dict"].values()):
            assert torch.equal(a, b), kind
        opt = "optimizer" if kind == "waveglow" else "gen_optimizer"
        for a, b in zip(trained.snapshot()[opt]["state"].values(),
                        restored.snapshot()[opt]["state"].values()):
            assert all(torch.equal(a[k], b[k]) for k in a), kind
        module, vcfg = tinfer.load_vocoder(kind, ckpt.latest(), cfg,
                                           device="cpu")
        assert vcfg == vocoder(trained).cfg
        for (k, a), b in zip(module.state_dict().items(),
                             vocoder(trained).state_dict().values()):
            assert torch.equal(a, b), (kind, k)
        with pytest.raises(ValueError, match="not a"):
            tinfer.load_vocoder("waveglow" if kind == "hifigan"
                                else "hifigan", ckpt.latest(), cfg,
                                device="cpu")
        with pytest.raises(ValueError, match="vocoder"):
            ckpt.restore(
                tstate.state_for(tm.Tacotron2(cfg, trainable=True), cfg))


@pytest.mark.parametrize("tool,name", [(vocoder_tool, "train_vocoder"),
                                       (hifigan_tool, "train_hifigan")])
def test_tools_pass_their_flags_on(tool, name, corpus, monkeypatch):
    """The command lines build the vocoder's config from the Tacotron
    config's mel channels and hop, and pass every flag on."""
    seen = {}
    monkeypatch.setattr(tool, name,
                        lambda ds, out, **kw: seen.update(kw, out=out,
                                                          n=len(ds)))
    tool.main([corpus, "-o", "run", "--steps", "3", "--batch", "2",
               "--segment-mels", "5", "--lr", "1e-3", "--device", "cpu",
               "--hparams", "n_mel_channels=8,hop_length=16,"
               "filter_length=64,win_length=64,seed=9"])
    assert seen["out"] == "run" and seen["n"] == 6
    assert (seen["steps"], seen["batch_size"], seen["segment_mels"],
            seen["learning_rate"], seen["seed"], seen["device"]) == (
                3, 2, 5, 1e-3, 9, "cpu")
    assert seen["mel_cfg"].hop_length == 16
    assert seen["cfg"].n_mel_channels == 8
    assert seen["cfg"].hop_length == (16 if name == "train_vocoder"
                                      else 256)


# ---------------------------------------------------------- audio batches

@pytest.fixture(scope="module")
def audio_items():
    """The JAX audio-batch tests' two rows: 31 and 20 hops of audio."""
    rng = np.random.RandomState(0)
    items = []
    for i, n in enumerate([64 * 31, 64 * 20 + 7]):
        ids = rng.randint(1, 148, 6 + i).astype(np.int32)
        wav = (rng.randn(n) * 0.2).astype(np.float32)
        items.append((ids, wav))
    return items


AB = dict(TACO, n_mel_channels=20, filter_length=256, hop_length=64,
          win_length=256, max_decoder_steps=10)


def test_mel_targets_match_jax(audio_items):
    """Both port backends ("torch", and "cuda" through the kernel's plain
    version on the CPU) against the JAX package's "xla" targets, and the
    raw mel against its "pallas" kernel in interpret mode."""
    jcfg, tcfg = JaxConfig(**AB), Tacotron2Config(**AB)
    jb = jab.pad_audio_batch(audio_items, t_text=8, t_mel=32, hop_length=64)
    tb = tab.pad_audio_batch(audio_items, t_text=8, t_mel=32, hop_length=64)
    for name in tab.AudioBatch._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    want = jab.mel_targets_from_audio(jb, jcfg, backend="xla")
    for backend in ("torch", "cuda"):
        got = tab.mel_targets_from_audio(tb, tcfg, backend=backend)
        assert got.mel.shape == (2, 32, 20)
        assert rel_err(got.mel, want.mel) <= REL, backend
        np.testing.assert_array_equal(got.gate_target.numpy(),
                                      np.asarray(want.gate_target))
        np.testing.assert_array_equal(got.mel_lengths.numpy(),
                                      np.asarray(want.mel_lengths))
    mel_cfg = MelConfig.from_config(tcfg)
    pallas = mel_spectrogram_pallas(jb.audio, JaxMelConfig.from_config(jcfg),
                                    interpret=True)
    assert rel_err(mel_spectrogram_backend(tb.audio, mel_cfg, "cuda"),
                   pallas) <= REL


def test_train_step_from_audio_loss_matches_jax(audio_items):
    """``train_step_from_audio`` with no dropout: its loss against the JAX
    package's loss on the JAX targets of the same batch (its training
    forward with ``rng=None``), at the JAX audio-batch tests' widths
    (attention_rnn_dim=20, decoder_rnn_dim=24)."""
    jcfg, tcfg = JaxConfig(**AB), Tacotron2Config(**AB)
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    jb = jab.pad_audio_batch(audio_items, t_text=8, t_mel=32, hop_length=64)
    tgt = jab.mel_targets_from_audio(jb, jcfg, backend="xla")
    out, _ = jm.forward(params, stats, tgt.text, tgt.text_lengths, tgt.mel,
                        tgt.mel_lengths, jcfg, training=True, rng=None)
    want = jloss.tacotron2_loss(out, tgt.mel, tgt.gate_target).total
    for backend in ("torch", "cuda"):
        model = tm.Tacotron2(tcfg, trainable=True)
        model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
        state = tstate.state_for(model, tcfg)
        tb = tab.pad_audio_batch(audio_items, t_text=8, t_mel=32,
                                 hop_length=64)
        state, m, _ = tab.train_step_from_audio(state, tb, tcfg,
                                                mel_backend=backend)
        assert rel_err(m.loss, want) <= REL_LOSS, backend
        assert float(m.applied) == 1.0 and int(state.step) == 1


def test_mel_gradient_is_finite_on_silence():
    """A differentiated mel of audio with silent bins (the HiFi-GAN
    trainer's mel L1 on generated audio): the port's gradient is finite,
    and 0 at silence; the JAX package's is NaN there (sqrt's gradient at
    0), which the port does not follow. The values agree within REL."""
    from tacotron2_tpu.audio.mel import mel_spectrogram as jax_mel
    from tacotron2_tpu_torch.audio.mel import mel_spectrogram
    mel_kw = JaxMelConfig(**MEL_KW), MelConfig(**MEL_KW)
    audio = np.zeros((2, 256), np.float32)
    audio[1, 100:140] = np.random.RandomState(0).randn(40) * 0.1
    jgrad = jax.grad(lambda y: jnp.sum(jax_mel(y, mel_kw[0])))(
        jnp.asarray(audio))
    assert np.isnan(np.asarray(jgrad)).any()
    y = torch.tensor(audio, requires_grad=True)
    mel = mel_spectrogram(y, mel_kw[1])
    mel.sum().backward()
    assert torch.isfinite(y.grad).all()
    assert torch.equal(y.grad[0], torch.zeros(256))
    assert rel_err(mel, jax_mel(jnp.asarray(audio), mel_kw[0])) <= REL
