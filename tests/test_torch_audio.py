"""The port's audio front end (tacotron2_tpu_torch/audio, kernels/mel_kernel)
against the JAX package's (tacotron2_tpu/audio, kernels/mel_kernel in
interpret mode). Waveforms come from numpy seeds and go to both.

Tolerances: the log-mel is compared in the log domain at atol 2e-4, the JAX
package's own tolerance between its Pallas kernel and its XLA form
(tests/test_kernels.py): the products sum 1024 and 513 fp32 terms in
another order, and the log magnifies a relative error of a value near the
1e-5 floor into an absolute one of the same size. STFT magnitudes and
reconstructed audio at 1e-4 (fp32 DFT of unit-scale audio); phases are
compared only through the audio they give, since an empty bin's phase is
arbitrary.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.audio import filters as jfilters
from tacotron2_tpu.audio import mel as jmel
from tacotron2_tpu.kernels import mel_spectrogram_pallas

from tacotron2_tpu_torch.audio import filters, mel
from tacotron2_tpu_torch.kernels import mel_kernel

# the packages export a function ``stft`` that hides the module of that name
jstft = importlib.import_module("tacotron2_tpu.audio.stft")
stft = importlib.import_module("tacotron2_tpu_torch.audio.stft")

LOG_ATOL = 2e-4
SMALL = dict(filter_length=256, hop_length=64, win_length=256,
             n_mel_channels=20, sampling_rate=8000, mel_fmax=4000.0)


def audio(seed, B, S):
    return (np.random.RandomState(seed).randn(B, S) * 0.2).astype(np.float32)


@pytest.mark.parametrize("fn,args", [
    ("mel_filterbank", (22050, 1024, 80, 0.0, 8000.0)),
    ("mel_filterbank", (8000, 256, 20, 50.0, 4000.0)),
    ("periodic_hann", (800,)),
    ("padded_window", (800, 1024)),
    ("dft_basis", (256, 200)),
    ("window_sumsquare", (256, 256, 64, 11)),
])
def test_filters_equal_the_jax_package(fn, args):
    got, want = getattr(filters, fn)(*args), getattr(jfilters, fn)(*args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        np.testing.assert_array_equal(g, w)


# block-multiple (128 frames at the TPU kernel's BLOCK_T) and ragged lengths
@pytest.mark.parametrize("samples", [127 * 256, 10000, 22050])
def test_mel_plain_version_matches_pallas_kernel_and_xla(samples):
    y = audio(0, 2, samples)
    jcfg, tcfg = jmel.MelConfig(), mel.MelConfig()
    want_k = np.asarray(mel_spectrogram_pallas(jnp.asarray(y), jcfg,
                                               interpret=True))
    want_x = np.asarray(jmel.mel_spectrogram(jnp.asarray(y), jcfg))
    calls = mel_kernel.mel_spectrogram_fused_plain.calls
    got = mel.mel_spectrogram_backend(torch.from_numpy(y), tcfg, "cuda")
    assert mel_kernel.mel_spectrogram_fused_plain.calls == calls + 1
    assert got.shape == want_k.shape == (2, 80, 1 + samples // 256)
    np.testing.assert_allclose(got.numpy(), want_k, atol=LOG_ATOL)
    np.testing.assert_allclose(got.numpy(), want_x, atol=LOG_ATOL)
    torch_form = mel.mel_spectrogram_backend(torch.from_numpy(y), tcfg)
    np.testing.assert_allclose(torch_form.numpy(), want_x, atol=LOG_ATOL)


def test_mel_small_config_and_quiet_audio():
    """A narrow config, and audio so quiet that most mels sit at the 1e-5
    floor (log = -11.51): the clamp, not rounding, decides those."""
    y = audio(1, 3, 3000) * np.array([[1.0], [1e-3], [1e-6]], np.float32)
    got = mel_kernel.mel_spectrogram_fused(torch.from_numpy(y),
                                           mel.MelConfig(**SMALL))
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(y),
                                           jmel.MelConfig(**SMALL)))
    np.testing.assert_allclose(got.numpy(), want, atol=LOG_ATOL)
    assert np.isclose(got[2].min(), np.log(1e-5))


def test_mel_backend_and_input_checks():
    y = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="unknown mel backend"):
        mel.mel_spectrogram_backend(y, mel.MelConfig(), "pallas")
    with pytest.raises(ValueError, match="float32"):
        mel_kernel.mel_spectrogram_fused(y.double(), mel.MelConfig())
    with pytest.raises(ValueError, match="too few"):
        mel_kernel.mel_spectrogram_fused(y[:, :512], mel.MelConfig())
    assert mel.mel_frames_for_samples(mel.MelConfig(), 22050) == \
        jmel.mel_frames_for_samples(jmel.MelConfig(), 22050) == 87


def test_mel_config_from_config():
    from tacotron2_tpu_torch.config import Tacotron2Config
    assert mel.MelConfig.from_config(Tacotron2Config()) == mel.MelConfig()
    assert mel.MelConfig().stft == stft.STFTConfig()


@pytest.mark.parametrize("cfg", [dict(), dict(filter_length=256,
                                              hop_length=64, win_length=200)])
def test_stft_matches_jax_and_round_trips(cfg):
    jc, tc = jstft.STFTConfig(**cfg), stft.STFTConfig(**cfg)
    y = audio(2, 2, 16 * tc.hop_length * 4)
    jm, jp = jstft.stft(jnp.asarray(y), jc)
    tm_, tp = stft.stft(torch.from_numpy(y), tc)
    assert tm_.shape == jm.shape == (2, tc.n_bins,
                                     stft.n_frames_for_samples(tc, y.shape[1]))
    np.testing.assert_allclose(tm_.numpy(), np.asarray(jm), atol=1e-4)
    # phases through the audio they give: each package inverts its own,
    # and the port inverts the JAX package's
    back_t = stft.istft(tm_, tp, tc).numpy()
    back_j = np.asarray(jstft.istft(jm, jp, jc))
    cross = stft.istft(torch.from_numpy(np.array(jm)),
                       torch.from_numpy(np.array(jp)), tc).numpy()
    assert back_t.shape == back_j.shape
    np.testing.assert_allclose(back_t, back_j, atol=1e-4)
    np.testing.assert_allclose(cross, back_j, atol=1e-4)
    n = back_t.shape[1]
    np.testing.assert_allclose(back_t, y[:, :n], atol=1e-4)


def test_griffin_lim_matches_jax_from_the_same_start_phase():
    """The start phase is drawn by jax.random.uniform, as the JAX package's
    griffin_lim draws it from this key, and handed to the port. 5
    iterations; atol 1e-3 on audio of scale ~0.1: atan2 near a bin of
    magnitude ~0 is ill-conditioned, and each iteration feeds it back."""
    cfg = dict(filter_length=256, hop_length=64, win_length=256)
    jc, tc = jstft.STFTConfig(**cfg), stft.STFTConfig(**cfg)
    mag = np.abs(np.asarray(jstft.stft(jnp.asarray(audio(3, 1, 4096)),
                                       jc)[0]))
    key = jax.random.PRNGKey(5)
    phase = np.array(jax.random.uniform(key, mag.shape, jnp.float32,
                                          -jnp.pi, jnp.pi))
    want = np.asarray(jstft.griffin_lim(jnp.asarray(mag), jc, n_iters=5,
                                        key=key))
    got = stft.griffin_lim(torch.from_numpy(mag), tc, n_iters=5,
                           phase=torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)
    # without a phase: seeded, repeatable, finite
    g = lambda: torch.Generator().manual_seed(3)
    a = stft.griffin_lim(torch.from_numpy(mag), tc, n_iters=2, generator=g())
    b = stft.griffin_lim(torch.from_numpy(mag), tc, n_iters=2, generator=g())
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_compression_round_trip():
    x = torch.tensor([0.0, 1e-6, 1e-5, 0.5, 3.0])
    c = mel.dynamic_range_compression(x)
    np.testing.assert_allclose(
        c.numpy(), np.asarray(jmel.dynamic_range_compression(
            jnp.asarray(x.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(mel.dynamic_range_decompression(c).numpy(),
                               np.maximum(x.numpy(), 1e-5), rtol=1e-6)


def _rna_tf32(x):
    """numpy: fp32 rounded to TF32 (nearest, ties away from zero, on the
    low 13 mantissa bits), as PTX's cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.int32).view(np.float32)


def _emulated_log_mel(y, cfg, passes):
    """The mel kernel's arithmetic in numpy: each frame folded about its
    centre in fp32 (u[k] = x[k] + x[n - k], v[k] = x[k] - x[n - k] for
    0 < 2k < n; x[k] itself and 0 where row k has no partner), split into
    TF32 hi and lo as the kernel splits it when it stages it, against the
    folded bases as the wrapper packs them (``packed_bases``: part 0 takes u
    into cos and v into sin, part 1 the other way round), products of TF32
    values (exact in fp32) summed in fp32. passes 3: lo hi + hi lo + hi hi
    (3xTF32); 1: plain TF32."""
    x = stft.frame_signal(torch.from_numpy(y), cfg.stft).numpy()
    n_fft, n_bins = cfg.filter_length, cfg.stft.n_bins
    half = n_fft // 2
    paired = np.arange(1, half + 1)
    paired = paired[2 * paired < n_fft]
    mirror = np.zeros_like(x[..., :half + 1])
    mirror[..., paired] = x[..., n_fft - paired]
    u = (x[..., :half + 1] + mirror).astype(np.float32)
    v = (x[..., :half + 1] - mirror).astype(np.float32)
    packs = []
    for pack in mel_kernel.packed_bases(cfg, "cpu"):
        nt, parts, kpad, _ = pack.shape
        p = pack.numpy().reshape(nt, parts, kpad, 2, 64).transpose(1, 2, 3,
                                                                   0, 4)
        packs.append(p.reshape(parts, kpad, 2, nt * 64)[:, :half + 1, :,
                                                        :n_bins])
    b_hi, b_lo = packs

    def product(a, part, col):
        a_hi = _rna_tf32(a)
        a_lo = _rna_tf32(a - a_hi)
        hi, lo = b_hi[part, :, col], b_lo[part, :, col]
        if passes == 1:
            return a_hi @ hi
        return (a_lo @ hi + a_hi @ lo + a_hi @ hi).astype(np.float32)
    re, im = product(u, 0, 0), product(v, 0, 1)
    if b_hi.shape[0] == 2:
        re, im = re + product(v, 1, 0), im + product(u, 1, 1)
    mag = np.sqrt(re * re + im * im)
    mels = mag @ mel.mel_weights(cfg, "cpu").numpy()
    return np.log(np.maximum(mels, 1e-5)).transpose(0, 2, 1)


MEL_KERNEL_LOG_ATOL = 1e-4   # the mel kernel's limit on the card


@pytest.mark.parametrize("cfg", [
    mel.MelConfig(),
    mel.MelConfig(filter_length=200, hop_length=50, win_length=160,
                  n_mel_channels=20, sampling_rate=8000, mel_fmax=4000.0),
    mel.MelConfig(**dict(SMALL, win_length=201)),
    mel.MelConfig(**dict(SMALL, filter_length=255, win_length=255))],
    ids=["n_fft1024", "n_fft200", "off-centre-window", "odd-n_fft"])
def test_mel_kernel_split_tf32_emulation_is_within_tolerance(cfg):
    """3xTF32 on folded frames, as the mel kernel computes its DFT on the
    tensor cores, emulated in numpy on a loud row and a quiet row (most mels
    near the 1e-5 floor) stays within the card's log-domain limit of the
    plain version (frames @ [cos | sin] in fp32). A single TF32 product is
    reported beside it."""
    r = np.random.RandomState(51)
    y = ((r.rand(2, 12 * cfg.hop_length) * 2 - 1) * 0.3).astype(np.float32)
    y[0] *= 1e-4
    want = mel_kernel.mel_spectrogram_fused_plain(torch.from_numpy(y),
                                                  cfg).numpy()
    three = np.abs(_emulated_log_mel(y, cfg, 3) - want).max()
    one = np.abs(_emulated_log_mel(y, cfg, 1) - want).max()
    print(f"n_fft {cfg.filter_length}: 3xTF32 {three:.3e}, TF32 {one:.3e} "
          f"in the log domain (limit {MEL_KERNEL_LOG_ATOL})")
    assert three <= MEL_KERNEL_LOG_ATOL
    assert one > three


def test_mel_kernel_bases_need_a_centred_window():
    """The kernel folds each frame about its centre, where a centred window
    makes the windowed cos bases even and the sin bases odd: one part of
    folded bases. A window padded off centre (n_fft - win_length odd) needs
    the other halves too, a second part; the two parts hold the whole bases
    (rows k and n - k are their even part plus and minus their odd part)."""
    hi, lo = mel_kernel.packed_bases(mel.MelConfig(), "cpu")
    assert hi.shape == lo.shape == (9, 1, 544, 128)
    cfg = mel.MelConfig(filter_length=256, win_length=201)
    hi, lo = mel_kernel.packed_bases(cfg, "cpu")
    assert hi.shape == lo.shape == (3, 2, 160, 128)
    p = (hi.double() + lo.double()).reshape(3, 2, 160, 2, 64)
    p = p.permute(1, 2, 3, 0, 4).reshape(2, 160, 2, 192)[..., :129]
    (ce, so), (co, se) = p[0, :129].unbind(1), p[1, :129].unbind(1)
    cos_b, sin_b = (b.double() for b in stft.dft_basis(cfg.stft, "cpu"))
    k = torch.arange(1, 128)
    for b, even, odd in ((cos_b, ce, co), (sin_b, se, so)):
        torch.testing.assert_close(even[k] + odd[k], b[k], rtol=0, atol=1e-6)
        torch.testing.assert_close(even[k] - odd[k], b[256 - k], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(even[[0, 128]], b[[0, 128]], rtol=0,
                                   atol=1e-6)
        assert float(odd[[0, 128]].abs().max()) == 0.0
