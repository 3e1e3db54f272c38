"""The port's WaveGlow (tacotron2_tpu_torch/models/waveglow.py), its
``Denoiser`` and ``convert_waveglow`` against the JAX package's, fp32 on
the CPU at the JAX tests' small topology (6 flows, early outputs at 2 and
4, 3 WN layers of 16 channels).

The JAX init zeroes every ``WN.end``, which makes each coupling the
identity; every weight is perturbed first (as tests/test_waveglow.py
does), so the couplings are live. Weights cross through
``waveglow_state_dict_from_jax``; mel, audio and the JAX-drawn z go to
both sides as numpy arrays.

Tolerance: each field's largest |err| as a share of its largest |value|,
1e-4 (REL) for values, the loss and gradients; the round trip through the
port's own flows within 1e-4 of the audio's largest value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu import convert_waveglow as jconv
from tacotron2_tpu import infer as jinfer
from tacotron2_tpu.audio import STFTConfig as JaxSTFTConfig
from tacotron2_tpu.models import waveglow as jwg

from tacotron2_tpu_torch import convert_waveglow as tconv
from tacotron2_tpu_torch import infer as tinfer
from tacotron2_tpu_torch.audio.stft import STFTConfig
from tacotron2_tpu_torch.convert import waveglow_state_dict_from_jax
from tacotron2_tpu_torch.models import waveglow as twg

SMALL = dict(n_mel_channels=8, n_flows=6, n_group=8, n_early_every=2,
             n_early_size=2, wn_layers=3, wn_channels=16, upsample_kernel=16,
             upsample_stride=4)
JCFG, TCFG = jwg.WaveGlowConfig(**SMALL), twg.WaveGlowConfig(**SMALL)
B, T_MEL, SIGMA = 2, 12, 0.666
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def perturbed_params(seed=0):
    params = jwg.init_params(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda x: x + 0.01 * rng.randn(*x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def setup():
    params = perturbed_params()
    model = twg.WaveGlow(TCFG)
    model.load_state_dict(waveglow_state_dict_from_jax(params, TCFG),
                          strict=True)
    rng = np.random.RandomState(0)
    mel = rng.randn(B, T_MEL, TCFG.n_mel_channels).astype(np.float32)
    audio = (rng.randn(B, T_MEL * TCFG.upsample_stride) * 0.3
             ).astype(np.float32)
    return params, model, mel, audio


def test_state_dict_covers_the_module(setup):
    params, model, _, _ = setup
    sd = waveglow_state_dict_from_jax(params, TCFG)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())


def test_fresh_couplings_are_identity():
    """A fresh port model: WN.end zero, so log s = 0, and every 1x1 weight
    a rotation, so log |det| = 0."""
    model = twg.WaveGlow(TCFG, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    out = twg.forward(model, torch.from_numpy(rng.randn(B, 48) * 0.3),
                      torch.from_numpy(rng.randn(B, T_MEL, 8)), TCFG)
    assert float(out.log_s_total.detach()) == 0.0
    assert abs(float(out.log_det_total.detach())) < 1e-3
    for inv in model.convinv:
        assert float(torch.linalg.det(inv.conv.weight[:, :, 0])) > 0


def test_forward_and_loss_match_jax(setup):
    params, model, mel, audio = setup
    want = jwg.forward(params, jnp.asarray(audio), jnp.asarray(mel), JCFG)
    got = twg.forward(model, torch.from_numpy(audio), torch.from_numpy(mel),
                      TCFG)
    assert abs(float(want.log_s_total)) > 0.1  # the couplings are live
    assert rel_err(got.z.transpose(1, 2), want.z) <= REL
    assert rel_err(got.log_s_total, want.log_s_total) <= REL
    assert rel_err(got.log_det_total, want.log_det_total) <= REL
    assert rel_err(twg.loss(got), jwg.loss(want)) <= REL


def test_gradients_match_jax_grad(setup):
    params, model, mel, audio = setup
    grads = jax.grad(lambda p: jwg.loss(jwg.forward(
        p, jnp.asarray(audio), jnp.asarray(mel), JCFG)))(params)
    want = waveglow_state_dict_from_jax(grads, TCFG)
    model.zero_grad(set_to_none=True)
    twg.loss(twg.forward(model, torch.from_numpy(audio),
                         torch.from_numpy(mel), TCFG)).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    bad = {k: e for k in got if (e := rel_err(got[k], want[k])) > REL}
    model.zero_grad(set_to_none=True)
    assert not bad, bad


def test_infer_with_the_jax_z_matches_jax(setup):
    params, model, mel, _ = setup
    key = jax.random.PRNGKey(7)
    t_groups = T_MEL * TCFG.upsample_stride // TCFG.n_group
    z = np.asarray(jax.random.normal(key, (B, t_groups, TCFG.n_group))
                   * SIGMA)
    want = jwg.infer(params, jnp.asarray(mel), JCFG, sigma=SIGMA, key=key)
    got = twg.infer(model, torch.from_numpy(mel), TCFG,
                    z=torch.tensor(z).transpose(1, 2))
    assert got.shape == (B, T_MEL * TCFG.upsample_stride)
    assert rel_err(got, want) <= REL


def test_round_trip_gives_the_audio_back(setup):
    _, model, mel, audio = setup
    mel_t = torch.from_numpy(mel)
    with torch.no_grad():
        z = twg.forward(model, torch.from_numpy(audio), mel_t, TCFG).z
    back = twg.infer(model, mel_t, TCFG, z=z)
    assert rel_err(back, audio) <= REL


def test_infer_is_seeded():
    model = twg.WaveGlow(TCFG, torch.Generator().manual_seed(1))
    mel = torch.from_numpy(np.random.RandomState(2).randn(1, 5, 8)
                           .astype(np.float32))
    a = twg.infer(model, mel, TCFG)
    b = twg.infer(model, mel, TCFG, generator=torch.Generator().manual_seed(0))
    c = twg.infer(model, mel, TCFG, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(twg.infer(model, mel, TCFG, sigma=0.0),
                       twg.infer(model, mel, TCFG, sigma=0.0))


def test_inverse_weights_follow_the_weights(setup):
    """The cached inverses are those of the current weights: a weight
    written in place is inverted again."""
    model = twg.WaveGlow(TCFG, torch.Generator().manual_seed(4))
    first = model.inverse_weights()
    assert model.inverse_weights()[0] is first[0]
    w = model.convinv[0].conv.weight
    with torch.no_grad():
        w.mul_(2.0)
    again = model.inverse_weights()
    eye = torch.eye(w.shape[0])
    torch.testing.assert_close(again[0] @ w[:, :, 0], eye, atol=1e-5,
                               rtol=0)


STFT = dict(filter_length=64, hop_length=16, win_length=64)


def test_denoiser_matches_jax(setup):
    """The zero-mel bias spectrum (WaveGlow at sigma 0 on 88 frames), and
    the denoised audio at strength 0.01 and 0.1."""
    params, model, mel, _ = setup
    jden = jinfer.Denoiser(params, JCFG, JaxSTFTConfig(**STFT))
    tden = tinfer.Denoiser(model, TCFG, STFTConfig(**STFT))
    assert rel_err(tden.bias_mag, jden.bias_mag) <= REL
    audio = np.asarray(jwg.infer(params, jnp.asarray(mel), JCFG, sigma=SIGMA,
                                 key=jax.random.PRNGKey(3)))
    for strength in (0.01, 0.1):
        want = jden(jnp.asarray(audio), strength)
        got = tden(torch.tensor(audio), strength)
        assert rel_err(got, want) <= REL, strength


# ------------------------------------------------ published checkpoints

def published_state_dict(cfg, seed, fused_cond=True):
    """A state_dict in the published WaveGlow's layout, from a numpy seed:
    weight-normalised WN convs (weight_g, weight_v), a plain WN.end, 1x1
    weights (rotations with their rows scaled, so that log |det W| is not
    0), the transposed conv (in, out, k); the cond conv fused, or per layer
    (checkpoints from before 2019)."""
    rng = np.random.RandomState(seed)
    sd = {}
    f = lambda *s: (rng.randn(*s) * 0.2).astype(np.float32)
    mel, n, k = cfg.n_mel_channels, cfg.wn_channels, cfg.wn_kernel_size

    def wn_conv(prefix, cout, cin, kk):
        sd[f"{prefix}.weight_g"] = np.abs(f(cout, 1, 1)) + 0.5
        sd[f"{prefix}.weight_v"] = f(cout, cin, kk)
        sd[f"{prefix}.bias"] = f(cout)

    sd["upsample.weight"] = f(mel, mel, cfg.upsample_kernel) * 0.1
    sd["upsample.bias"] = f(mel)
    for i in range(cfg.n_flows):
        c = twg.remaining_channels(cfg, i)
        w = np.linalg.qr(rng.randn(c, c))[0] * rng.uniform(0.8, 1.5, (c, 1))
        sd[f"convinv.{i}.conv.weight"] = w.astype(np.float32)[:, :, None]
        pre = f"WN.{i}"
        wn_conv(f"{pre}.start", n, c // 2, 1)
        sd[f"{pre}.end.weight"] = f(2 * (c - c // 2), n, 1) * 0.2
        sd[f"{pre}.end.bias"] = f(2 * (c - c // 2)) * 0.2
        if fused_cond:
            wn_conv(f"{pre}.cond_layer", 2 * n * cfg.wn_layers,
                    mel * cfg.n_group, 1)
        for j in range(cfg.wn_layers):
            wn_conv(f"{pre}.in_layers.{j}", 2 * n, n, k)
            wn_conv(f"{pre}.res_skip_layers.{j}",
                    2 * n if j < cfg.wn_layers - 1 else n, n, 1)
            if not fused_cond:
                wn_conv(f"{pre}.cond_layers.{j}", 2 * n, mel * cfg.n_group, 1)
    return {f"module.{k}" if seed % 2 else k: v for k, v in sd.items()}


@pytest.mark.parametrize("fused_cond", [True, False])
def test_convert_waveglow_matches_the_jax_converter(fused_cond, tmp_path):
    """The same published-layout state_dict through each package's
    converter: ``forward`` and ``infer`` of the two models agree, and the
    port's ``load_waveglow_checkpoint`` reads it from a file."""
    cfg = TCFG._replace(n_flows=4)
    sd = published_state_dict(cfg, seed=1 if fused_cond else 2,
                              fused_cond=fused_cond)
    jparams, _ = jconv.convert_waveglow_state_dict(
        sd, jwg.WaveGlowConfig(**cfg._asdict()))
    path = tmp_path / "waveglow.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    model = tconv.load_waveglow_checkpoint(str(path), cfg, device="cpu")
    rng = np.random.RandomState(5)
    mel = rng.randn(B, 10, cfg.n_mel_channels).astype(np.float32)
    audio = (rng.randn(B, 40) * 0.3).astype(np.float32)
    want = jwg.forward(jparams, jnp.asarray(audio), jnp.asarray(mel),
                       jwg.WaveGlowConfig(**cfg._asdict()))
    got = twg.forward(model, torch.from_numpy(audio), torch.from_numpy(mel),
                      cfg)
    assert rel_err(got.z.transpose(1, 2), want.z) <= REL
    assert rel_err(got.log_s_total, want.log_s_total) <= REL
    assert rel_err(got.log_det_total, want.log_det_total) <= REL
    z = (rng.randn(B, cfg.n_group, 5) * SIGMA).astype(np.float32)
    back = twg.infer(model, torch.from_numpy(mel), cfg,
                     z=got.z.detach())
    assert rel_err(back, audio) <= REL
    assert twg.infer(model, torch.from_numpy(mel), cfg,
                     z=torch.from_numpy(z)).shape == (B, 40)
