"""The port's HiFi-GAN generator (tacotron2_tpu_torch/models/hifigan)
against the JAX package's, through ``hifigan_state_dict_from_jax``. The mel
comes from a numpy seed and goes to both. fp32 at atol 1e-5 on audio in
(-1, 1): the same convolutions, summed in another order. The weights are
drawn at N(0, 0.3), not the init's N(0, 0.01), so that the audio is of
order 0.1 and the tolerance means something.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.models import hifigan as jh
from tacotron2_tpu.ops import layers as jlayers

from tacotron2_tpu_torch.convert import hifigan_state_dict_from_jax
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.ops import layers

SMALL = dict(n_mel_channels=20, upsample_rates=(4, 4),
             upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
             resblock_kernel_sizes=(3, 5),
             resblock_dilation_sizes=((1, 3), (1, 3)))
ODD = dict(n_mel_channels=12, upsample_rates=(3, 2),
           upsample_kernel_sizes=(7, 4), upsample_initial_channel=8,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2, 3),))


def both(kw, seed, scale=0.3):
    """The JAX generator and the port's on the same weights, the port's
    at the JAX package's slope before ``conv_post``."""
    jcfg = jh.HiFiGANConfig(**kw)
    tcfg = th.HiFiGANConfig(**kw, post_lrelu_slope=jh.LRELU_SLOPE)
    params = jh.init_generator(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * scale
                              / np.sqrt(max(p.size // p.shape[-1], 1))),
        params)
    model = th.Generator(tcfg)
    model.load_state_dict(hifigan_state_dict_from_jax(params, tcfg),
                          strict=True)
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("kw,frames", [(SMALL, 9), (SMALL, 1), (ODD, 7)])
def test_generator_matches_jax(kw, frames):
    jcfg, tcfg, params, model = both(kw, seed=0)
    mel = np.random.RandomState(1).randn(2, frames, kw["n_mel_channels"]
                                         ).astype(np.float32)
    want = np.asarray(jh.generator(params, jnp.asarray(mel), jcfg))
    got = th.generator(model, torch.from_numpy(mel), tcfg)
    assert got.shape == want.shape == (2, frames * tcfg.hop_length)
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_generator_bf16_close_to_jax():
    """bf16 operands in every conv, fp32 bias adds: atol 2e-2 on audio of
    order 0.1 (some twenty convs deep, each rounding its operands)."""
    jcfg, tcfg, params, model = both(SMALL, seed=2)
    mel = np.random.RandomState(3).randn(1, 6, 20).astype(np.float32)
    want = np.asarray(jh.generator(params, jnp.asarray(mel), jcfg,
                                   compute_dtype=jnp.bfloat16))
    got = th.generator(model, torch.from_numpy(mel), tcfg,
                       compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


@pytest.mark.parametrize("k,stride", [(8, 4), (16, 8), (7, 3), (4, 2)])
def test_conv_transpose1d_matches_jax(k, stride):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 6).astype(np.float32)
    p = {"kernel": jnp.asarray(rng.randn(k, 6, 3).astype(np.float32)),
         "bias": jnp.asarray(rng.randn(3).astype(np.float32))}
    want = np.asarray(jlayers.conv_transpose1d(p, jnp.asarray(x),
                                               stride=stride))
    w = torch.from_numpy(np.ascontiguousarray(
        np.asarray(p["kernel"])[::-1].transpose(1, 2, 0)))
    got = layers.conv_transpose1d(torch.from_numpy(x), w,
                                  torch.from_numpy(np.array(p["bias"])),
                                  stride=stride)
    assert got.shape == want.shape == (2, 5 * stride, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_dilated_conv1d_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 11, 4).astype(np.float32)
    kern = rng.randn(5, 4, 3).astype(np.float32)
    want = np.asarray(jlayers.conv1d({"kernel": jnp.asarray(kern)},
                                     jnp.asarray(x), dilation=3))
    got = layers.conv1d(torch.from_numpy(x), torch.from_numpy(
        np.ascontiguousarray(kern.transpose(2, 1, 0))), dilation=3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), SMALL, ODD])
def test_receptive_field_and_hop_equal(kw):
    jcfg, tcfg = jh.HiFiGANConfig(**kw), th.HiFiGANConfig(**kw)
    assert th.receptive_field_frames(tcfg) == jh.receptive_field_frames(jcfg)
    assert tcfg.hop_length == jcfg.hop_length
    if not kw:
        assert th.receptive_field_frames(tcfg) == 15 and tcfg.hop_length == 256


def test_receptive_field_bounds_the_generator():
    """A change to the mel beyond the margin leaves a sample untouched."""
    _, tcfg, _, model = both(SMALL, seed=6)
    R, hop = th.receptive_field_frames(tcfg), tcfg.hop_length
    mel = torch.from_numpy(np.random.RandomState(7).randn(1, 3 * R + 8, 20)
                           .astype(np.float32))
    t = 2 * R
    other = mel.clone()
    other[:, :t - R] += 1.0
    other[:, t + R + 1:] -= 1.0
    a, b = (th.generator(model, m, tcfg) for m in (mel, other))
    assert torch.allclose(a[:, t * hop:(t + 1) * hop],
                          b[:, t * hop:(t + 1) * hop], atol=1e-6)
    assert not torch.allclose(a, b, atol=1e-3)


def test_seeded_init_and_keys():
    cfg = th.HiFiGANConfig(**SMALL)
    a = th.Generator(cfg, torch.Generator().manual_seed(0))
    b = th.Generator(cfg, torch.Generator().manual_seed(0))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert float(sa["conv_pre.bias"].abs().max()) == 0.0
    assert abs(float(sa["ups.0.weight"].std()) - 0.01) < 2e-3
    assert not any(p.requires_grad for p in a.parameters())
    assert {"conv_pre.weight", "ups.1.bias", "resblocks.3.convs2.1.weight",
            "conv_post.weight"} <= set(sa)


# ------------------------------------------- the published generator, plain

V1 = {}  # the defaults: V1's widths and the published slope


def vocoder_block(kw):
    """config_v1.json's keys for a generator of ``kw``'s widths."""
    cfg = th.HiFiGANConfig(**kw)
    return {"resblock": "1", "num_mels": cfg.n_mel_channels,
            "upsample_rates": list(cfg.upsample_rates),
            "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
            "upsample_initial_channel": cfg.upsample_initial_channel,
            "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
            "resblock_dilation_sizes": [list(d) for d in
                                        cfg.resblock_dilation_sizes],
            "hop_size": cfg.hop_length}


def port_and_reference(kw, seed, slope=None, frames=6):
    """The port's generator and the plain reference's
    (``benchmark/reference/hifigan.py``) on the benchmark's seeded weights
    (``benchmark/weights_hifigan.py``), fed one mel of ``frames`` frames
    at the scale of Tacotron 2's served mels; the port at ``slope`` before
    ``conv_post`` (the published 0.01 by default)."""
    from benchmark import weights_hifigan
    from benchmark.reference import hifigan as ref
    v = vocoder_block(kw)
    W = weights_hifigan.generator(v, seed, "cpu")
    cfg = th.HiFiGANConfig(**kw) if slope is None else \
        th.HiFiGANConfig(**dict(kw, post_lrelu_slope=slope))
    model = th.Generator(cfg)
    model.load_state_dict(W, strict=True)
    mel = torch.from_numpy(0.15 * np.random.RandomState(seed).randn(
        1, frames, cfg.n_mel_channels).astype(np.float32))
    got = th.generator(model, mel, cfg)
    want = ref.generator(W, mel.transpose(1, 2), ref.Dims.of(v))
    return got, want


@pytest.mark.parametrize("kw,frames", [(SMALL, 9), (ODD, 7), (V1, 4)])
def test_generator_matches_plain_reference(kw, frames):
    """The port at the published slope against jik876/hifi-gan's
    ``Generator.forward`` written plainly, fp32 on the CPU: atol 1e-5 on
    audio of order 0.1, as against the JAX generator (the same
    convolutions, channels last against channels first, summed in another
    order). The weights are the benchmark's (N(0, (1.15 / sqrt(fan_in))^2)),
    so that the audio is of order 0.1 and not the init's 1e-4."""
    got, want = port_and_reference(kw, seed=11, frames=frames)
    hop = th.HiFiGANConfig(**kw).hop_length
    assert got.shape == want.shape == (1, frames * hop)
    assert float(want.abs().max()) > 5e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_jax_slope_fails_the_audio_check():
    """The generator at the JAX package's slope before ``conv_post`` (the
    fault the published slope fixes) lies farther from the plain
    reference, as a share of its largest |value|, than the serving cell's
    ``audio_gap`` limit allows, at V1's widths. The limit, 0.006, is the
    one ``serve-hifigan-poisson`` holds the served audio to, set between
    the port's readings on the H100 (3.0e-3 at most) and the plain
    generator's in bf16 operands (1.02e-2 at least)."""
    from benchmark.loops.common import gap_share
    limit = 0.006
    got, want = port_and_reference(V1, seed=12, slope=jh.LRELU_SLOPE,
                                   frames=4)
    assert gap_share(got, want) > 3 * limit
    sound, _ = port_and_reference(V1, seed=12, frames=4)
    assert gap_share(sound, want) < limit / 100
