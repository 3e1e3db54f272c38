"""Filterbank and window precomputation (host-side numpy).

The port's own copy of the JAX package's ``audio/filters.py``: the
slaney-scale mel filterbank (librosa 0.6 ``filters.mel`` defaults:
htk=False, norm=1/slaney area normalization; reference layers.py:51-52) and
the periodic Hann window (scipy ``get_window('hann', N, fftbins=True)``;
reference stft.py:64), computed from their defining formulas.

These run once at setup; all arrays are float32 numpy, which
``audio/stft.py`` and ``audio/mel.py`` move to the device once per device.
"""

from __future__ import annotations

import functools

import numpy as np

# Slaney auditory scale constants: linear below 1 kHz (200/3 Hz per mel),
# logarithmic above (27 steps per factor of 6.4).
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOG_STEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies) -> np.ndarray:
    f = np.asanyarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOG_STEP,
        mels,
    )
    return mels


def mel_to_hz(mels) -> np.ndarray:
    m = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_SP * m
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOG_STEP * (m - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2).

    Slaney-normalized (each filter scaled by 2 / bandwidth) to match
    librosa 0.6's default ``norm=1``.
    """
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    band_edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                       n_mels + 2))

    edge_diff = np.diff(band_edges)  # (n_mels + 1,)
    # ramps[i, k] = band_edges[i] - fft_freqs[k]
    ramps = band_edges[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / edge_diff[:-1, None]
    upper = ramps[2:] / edge_diff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    area_norm = 2.0 / (band_edges[2:n_mels + 2] - band_edges[:n_mels])
    weights *= area_norm[:, None]
    return weights.astype(np.float32)


def periodic_hann(win_length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window of length ``win_length``."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window zero-centered inside an ``n_fft``-long frame
    (librosa ``pad_center`` semantics, reference stft.py:66)."""
    if win_length > n_fft:
        raise ValueError("win_length must be <= n_fft")
    window = periodic_hann(win_length)
    out = np.zeros(n_fft, dtype=np.float32)
    start = (n_fft - win_length) // 2
    out[start:start + win_length] = window
    return out


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int, win_length: int):
    """Windowed real-DFT analysis basis as two matmul operands.

    Returns (cos_basis, sin_basis), each (n_fft, n_bins) with
    n_bins = 1 + n_fft // 2, already multiplied by the Hann window so that
    ``frames @ cos_basis`` / ``frames @ sin_basis`` give Re/Im of
    rfft(frame * window): the framed DFT as a dense product, followed by
    the mel-basis product.
    """
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    window = padded_window(win_length, n_fft).astype(np.float64)[:, None]
    cos_basis = (np.cos(angle) * window).astype(np.float32)
    sin_basis = (-np.sin(angle) * window).astype(np.float32)
    return cos_basis, sin_basis


def window_sumsquare(win_length: int, n_fft: int, hop_length: int,
                     n_frames: int) -> np.ndarray:
    """Sum-square envelope of the analysis window across overlapping frames,
    used to cancel windowing modulation in the inverse STFT
    (reference audio_processing.py:7-56)."""
    total = n_fft + hop_length * (n_frames - 1)
    env = np.zeros(total, dtype=np.float32)
    win_sq = padded_window(win_length, n_fft) ** 2
    for i in range(n_frames):
        start = i * hop_length
        end = min(total, start + n_fft)
        env[start:end] += win_sq[:end - start]
    return env
