"""The port's one-utterance pipeline (tacotron2_tpu_torch/infer,
``serve.VocoderRunner``) against the JAX package's ``infer.synthesize`` and
``serve.VocoderRunner``, from the same weights.

Tolerances at fp32: mel, gate and alignment at 1e-4 (up to 20 decoder steps
and the postnet, sums in another order), HiFi-GAN audio at 1e-4 (a
generator of order-1 gain on that mel; weights drawn at N(0, 0.3) so that
the audio is of order 0.1). Griffin-Lim starts from a random phase that the
two packages draw with different generators, so its audio is held against
the port's own ``griffin_lim`` from the same seed, and its input, the
linear magnitude, against the JAX package's formula at rtol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu import infer as jinfer
from tacotron2_tpu import serve as jserve
from tacotron2_tpu.audio import filters as jfilters
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.models import hifigan as jh
from tacotron2_tpu.models import tacotron2 as jm

from tacotron2_tpu_torch import infer
from tacotron2_tpu_torch.audio.stft import STFTConfig, griffin_lim
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import (hifigan_state_dict_from_jax,
                                         state_dict_from_jax)
from tacotron2_tpu_torch.data.bucketing import mel_bucket
from tacotron2_tpu_torch.kernels import decoder_step as ds
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.models import waveglow as twg
from tacotron2_tpu_torch.serve import VocoderRunner

DIMS = dict(
    n_symbols=148, symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=2, attention_rnn_dim=40, decoder_rnn_dim=48,
    prenet_dim=16, attention_dim=24, attention_location_n_filters=8,
    attention_location_kernel_size=15, postnet_embedding_dim=32,
    postnet_n_convolutions=3, n_mel_channels=20, max_decoder_steps=20,
    gate_threshold=0.99, compute_dtype="float32", filter_length=256,
    hop_length=16, win_length=256, sampling_rate=8000, mel_fmax=4000.0)
HG = dict(n_mel_channels=20, upsample_rates=(4, 4),
          upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
TEXTS = ["Hello world.", "Hi."]


@pytest.fixture(scope="module")
def world():
    class W:
        pass
    w = W()
    w.jcfg, w.tcfg = JaxConfig(**DIMS), Tacotron2Config(**DIMS)
    w.params, w.stats = jm.init_params(jax.random.PRNGKey(0), w.jcfg)
    w.model = tm.Tacotron2(w.tcfg)
    w.model.load_state_dict(state_dict_from_jax(w.params, w.stats, w.tcfg))
    w.jhg = jh.HiFiGANConfig(**HG)
    # the JAX package's slope before conv_post
    w.thg = th.HiFiGANConfig(**HG, post_lrelu_slope=jh.LRELU_SLOPE)
    rng = np.random.RandomState(1)
    w.gparams = jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.3
                              / np.sqrt(max(p.size // p.shape[-1], 1))),
        jh.init_generator(jax.random.PRNGKey(1), w.jhg))
    w.voc = th.Generator(w.thg)
    w.voc.load_state_dict(hifigan_state_dict_from_jax(w.gparams, w.thg))
    return w


def check(got, want, audio_atol=None):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.mel.shape == w.mel.shape
        np.testing.assert_allclose(g.mel, w.mel, atol=1e-4)
        np.testing.assert_allclose(g.gate, w.gate, atol=1e-4)
        np.testing.assert_allclose(g.alignment, w.alignment, atol=1e-4)
        if audio_atol is None:
            assert g.audio is None and w.audio is None
        else:
            assert g.audio.shape == w.audio.shape
            assert np.abs(w.audio).max() > 1e-2
            np.testing.assert_allclose(g.audio, w.audio, atol=audio_atol)


def test_encode_texts_equals_jax(world):
    ids, lengths = infer.encode_texts(TEXTS, world.tcfg)
    jids, jlengths = jinfer.encode_texts(TEXTS, world.jcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("vocoder", ["none", "hifigan"])
def test_synthesize_matches_jax(world, vocoder, fused):
    texts = TEXTS[:1] if fused else TEXTS
    calls = ds.decoder_step_chunk_plain.calls
    got = infer.synthesize(world.model, texts, world.tcfg, vocoder=vocoder,
                           vocoder_model=world.voc, vocoder_cfg=world.thg,
                           fused=fused, device="cpu")
    assert (ds.decoder_step_chunk_plain.calls > calls) == fused
    want = jinfer.synthesize(world.params, world.stats, texts, world.jcfg,
                             vocoder=vocoder, vocoder_params=world.gparams,
                             vocoder_cfg=world.jhg, fused=fused)
    check(got, want, 1e-4 if vocoder == "hifigan" else None)
    assert got[0].mel.shape == (20, 20)


def test_synthesize_griffin_lim(world):
    got = infer.synthesize(world.model, TEXTS, world.tcfg,
                           vocoder="griffin_lim", griffin_lim_iters=3,
                           generator=None, device="cpu")
    want = jinfer.synthesize(world.params, world.stats, TEXTS, world.jcfg,
                             vocoder="griffin_lim", griffin_lim_iters=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.mel, w.mel, atol=1e-4)
        assert g.audio.shape == w.audio.shape
        assert np.isfinite(g.audio).all()
    # the magnitude Griffin-Lim starts from, against the JAX package's
    # formula; then the audio against the port's own griffin_lim from the
    # default seed (no latch here: every row runs to the cap)
    cfg = world.tcfg
    res = tm.infer(world.model, *infer.encode_texts(TEXTS, cfg), cfg,
                   device="cpu")
    linear = infer.mel_to_linear(res.mel_postnet, cfg)
    inv = np.linalg.pinv(jfilters.mel_filterbank(
        cfg.sampling_rate, cfg.filter_length, cfg.n_mel_channels,
        cfg.mel_fmin, cfg.mel_fmax))
    ref = np.clip(np.einsum("btm,mf->bft", np.exp(res.mel_postnet.numpy()),
                            inv.T), 0.0, None)
    np.testing.assert_allclose(linear.numpy(), ref, rtol=1e-3, atol=1e-5)
    audio = griffin_lim(linear, STFTConfig(256, 16, 256), n_iters=3)
    np.testing.assert_allclose(got[1].audio, audio[1, :20 * 16].numpy(),
                               atol=1e-6)


def test_synthesize_on_a_quantized_model(world):
    qmodel = tm.quantize_for_serving(world.model)
    got = infer.synthesize(qmodel, TEXTS, world.tcfg, vocoder="none",
                           device="cpu")
    want = jinfer.synthesize(jm.quantize_for_serving(world.params),
                             world.stats, TEXTS, world.jcfg, vocoder="none")
    check(got, want)
    with pytest.raises(ValueError, match="unquantized"):
        infer.synthesize(qmodel, TEXTS[:1], world.tcfg, vocoder="none",
                         fused=True, device="cpu")


def test_what_is_not_ported_says_so(world):
    """WaveGlow and its Denoiser were the last parts of ``infer`` and
    ``serve`` not ported (they raised NotImplementedError): they now run.
    What is still refused says why."""
    wg_cfg = twg.WaveGlowConfig(n_mel_channels=20, n_flows=2, n_early_every=4,
                                wn_layers=2, wn_channels=8,
                                upsample_kernel=64, upsample_stride=16)
    wg = twg.WaveGlow(wg_cfg, torch.Generator().manual_seed(0))
    res = infer.synthesize(world.model, TEXTS, world.tcfg,
                           vocoder="waveglow", vocoder_model=wg,
                           vocoder_cfg=wg_cfg,
                           denoiser=infer.Denoiser(
                               wg, wg_cfg, STFTConfig(64, 16, 64)),
                           device="cpu")
    for r in res:
        assert r.audio.shape == (r.mel.shape[0] * 16,)
        assert np.isfinite(r.audio).all()
    runner = VocoderRunner("waveglow", wg, wg_cfg, max_frames=64,
                           device="cpu")
    assert runner(res[0].mel).shape == res[0].audio.shape
    with pytest.raises(ValueError, match="unknown vocoder"):
        infer.synthesize(world.model, TEXTS, world.tcfg, vocoder="wavenet",
                         device="cpu")
    with pytest.raises(ValueError, match="unknown neural vocoder"):
        VocoderRunner("wavenet", world.voc, world.thg, max_frames=64,
                      device="cpu")
    with pytest.raises(ValueError, match="B=1 deterministic"):
        infer.synthesize(world.model, TEXTS, world.tcfg, fused=True,
                         device="cpu")


@pytest.mark.parametrize("n,step,max_frames,bucket", [
    (5, 8, 64, 8), (8, 8, 64, 8), (19, 8, 16, 19), (70, 32, 64, 70)])
def test_vocoder_runner_pads_to_a_bucket_and_trims(world, n, step,
                                                   max_frames, bucket):
    assert mel_bucket(n, step, max(max_frames, n)) == bucket
    mel = np.random.RandomState(n).randn(n, 20).astype(np.float32)
    run = VocoderRunner("hifigan", world.voc.state_dict(), world.thg,
                        max_frames=max_frames, bucket_step=step, device="cpu")
    got = run(mel)
    assert got.shape == (n * 16,)
    want = jserve.VocoderRunner("hifigan", world.gparams, world.jhg,
                                max_frames=max_frames, bucket_step=step)(mel)
    np.testing.assert_allclose(got, want, atol=1e-4)
    padded = np.zeros((1, bucket, 20), np.float32)
    padded[0, :n] = mel
    full = th.generator(world.voc, torch.from_numpy(padded), world.thg)
    np.testing.assert_array_equal(got, full[0, :n * 16].numpy())


def _first_latches(gates, thr):
    """Each row's first step whose sigmoid(gate) exceeds thr, or None."""
    hit = 1.0 / (1.0 + np.exp(-gates)) > thr
    return [int(np.argmax(h)) if h.any() else None for h in hit]


@pytest.mark.parametrize("weights", ["int8", "bf16"])
def test_chunked_decode_matches_jax(world, weights):
    """``decode_autoregressive`` in chunks of 4 steps, max_steps 11 (no
    multiple of 4), on the quantized model (fp32 compute) and on bf16
    compute, against the JAX package's ``decode_autoregressive`` (one
    step at a time) from the same memory, with a gate threshold at which
    one row latches inside a chunk and the loop stops inside a later one:
    the steps the chunks run past the last latch write the buffers' own
    fill values, so every output equals the JAX loop's, lengths exactly.
    Tolerance 1e-4 at fp32, the plain decode's; at bf16 1e-2, the bf16
    decoder chunk's (tests/test_torch_decoder_batch.py)."""
    B, T_in, steps, cs = 2, 7, 11, 4
    rng = np.random.RandomState(8)
    memory = rng.randn(B, T_in, 32).astype(np.float32) * 0.5
    lengths = np.array([7, 5], np.int32)
    params, model = world.params, world.model
    jcd, tcd, atol = None, None, 1e-4
    if weights == "int8":
        params = jm.quantize_for_serving(params)
        model = tm.quantize_for_serving(model)
    else:
        jcd, tcd, atol = jnp.bfloat16, torch.bfloat16, 1e-2

    def jax_decode(thr):
        return jm.decode_autoregressive(
            params, jnp.asarray(memory), jnp.asarray(lengths),
            JaxConfig(**{**DIMS, "gate_threshold": thr}), max_steps=steps,
            compute_dtype=jcd)

    free = np.asarray(jax_decode(1.0)[1])   # no row ever latches
    # a threshold at which every row latches, one of them inside a chunk,
    # the last at a step that ends no chunk and before max_steps
    probs = np.sort(1.0 / (1.0 + np.exp(-free.ravel())))
    chosen = None
    for lo, hi in zip(probs[:-1], probs[1:]):
        thr = float(lo + hi) / 2
        first = _first_latches(free, thr)
        if None in first:
            continue
        if any(f % cs != cs - 1 for f in first) and \
                max(first) % cs != cs - 1 and max(first) < steps - 2 \
                and len(set(first)) > 1:
            chosen = thr
            break
    assert chosen is not None, "no threshold latches the rows mid-chunk"
    want = jax_decode(chosen)
    tcfg = Tacotron2Config(**{**DIMS, "gate_threshold": chosen})
    got = tm.decode_autoregressive(
        model, torch.from_numpy(memory), torch.from_numpy(lengths), tcfg,
        max_steps=steps, compute_dtype=tcd, chunk_steps=cs)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3].max()) < steps
    for name, g, w in zip(("mel", "gate", "align"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   err_msg=name)
    # past the last latch, the fill values themselves
    done = int(got[3].max())
    assert (got[0][:, done:] == 0).all() and (got[2][:, done:] == 0).all()
    assert (got[1][:, done:] == tm.MASKED_GATE_ENERGY).all()
