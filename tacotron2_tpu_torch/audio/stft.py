"""STFT analysis and synthesis, and Griffin-Lim.

Counterpart of the JAX package's ``audio/stft.py`` (reference stft.py:42-141):
the framed DFT is one dense product against a windowed Fourier basis; the
inverse is a windowed overlap-add of ``torch.fft.irfft`` frames with the
window sum-square envelope divided out. Waveforms are ``(B, samples)``,
spectra ``(B, n_bins, n_frames)``, the reference's layout. fp32 throughout
(a CUDA product here runs in full fp32 unless the caller turned TF32 on).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.audio import filters


class STFTConfig(NamedTuple):
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024

    @property
    def n_bins(self) -> int:
        return 1 + self.filter_length // 2


def n_frames_for_samples(cfg: STFTConfig, num_samples: int) -> int:
    """Frame count after centered reflect padding (reference stft.py:85-89:
    pad n_fft//2 on both sides, then hop with no extra padding)."""
    return 1 + num_samples // cfg.hop_length


@functools.lru_cache(maxsize=16)
def _basis(n_fft: int, win_length: int, device: str):
    """(cos, sin) windowed DFT bases (n_fft, n_bins) on ``device``."""
    return tuple(torch.from_numpy(b).to(device)
                 for b in filters.dft_basis(n_fft, win_length))


def dft_basis(cfg: STFTConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return _basis(cfg.filter_length, cfg.win_length, str(device))


def frame_signal(y: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """(B, T) waveform -> (B, n_frames, n_fft) overlapping frames with
    centered reflect padding (a strided view of the padded waveform)."""
    pad = cfg.filter_length // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(1, cfg.filter_length, cfg.hop_length)


def stft(y: torch.Tensor, cfg: STFTConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward STFT. (B, T) -> magnitude, phase each (B, n_bins, n_frames);
    reflect pad, periodic Hann window, real and imaginary parts through the
    windowed DFT basis (reference stft.py:77-105)."""
    frames = frame_signal(y.float(), cfg)
    cos_b, sin_b = dft_basis(cfg, y.device)
    real = frames @ cos_b
    imag = frames @ sin_b
    magnitude = torch.sqrt(real * real + imag * imag)
    phase = torch.atan2(imag, real)
    return magnitude.transpose(1, 2), phase.transpose(1, 2)


def istft(magnitude: torch.Tensor, phase: torch.Tensor,
          cfg: STFTConfig) -> torch.Tensor:
    """Inverse STFT. (B, n_bins, T) x2 -> (B, T * hop) samples: windowed
    overlap-add with the window sum-square envelope divided out (reference
    stft.py:107-136, audio_processing.py:7-56), the n_fft//2 centering pad
    trimmed from both ends."""
    B, _, n_frames = magnitude.shape
    n_fft, hop = cfg.filter_length, cfg.hop_length
    window, frame_idx, envelope = _synthesis_constants(
        cfg, n_frames, str(magnitude.device))
    spec = torch.polar(magnitude.float(), phase.float()).transpose(1, 2)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window

    total = n_fft + hop * (n_frames - 1)
    signal = torch.zeros(B, total, device=frames.device)
    signal.index_add_(1, frame_idx, frames.reshape(B, -1))
    pad = n_fft // 2
    return (signal / envelope)[:, pad:total - pad]


@functools.lru_cache(maxsize=32)
def _synthesis_constants(cfg: STFTConfig, n_frames: int, device: str):
    """The synthesis window (n_fft,), the overlap-add sample index of every
    frame element (n_frames * n_fft,) and the window sum-square envelope
    with its zeros replaced by 1 (total,), on ``device``: Griffin-Lim asks
    for the same ones at every iteration."""
    n_fft, hop = cfg.filter_length, cfg.hop_length
    window = torch.from_numpy(filters.padded_window(cfg.win_length, n_fft))
    frame_idx = (torch.arange(n_frames)[:, None] * hop
                 + torch.arange(n_fft)[None, :]).reshape(-1)
    envelope = filters.window_sumsquare(cfg.win_length, n_fft, hop, n_frames)
    safe = np.where(envelope > np.finfo(np.float32).tiny, envelope, 1.0)
    return (window.to(device), frame_idx.to(device),
            torch.from_numpy(safe.astype(np.float32)).to(device))


def griffin_lim(magnitude: torch.Tensor, cfg: STFTConfig, n_iters: int = 30,
                generator: Optional[torch.Generator] = None,
                phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase recovery (reference audio_processing.py:59-75):
    from a random phase, alternate ISTFT and STFT keeping the target
    magnitude. The start phase is uniform in [-pi, pi) from ``generator``
    (on the magnitude's device; seed 0 without one), or ``phase`` itself."""
    if phase is None:
        if generator is None:
            generator = torch.Generator(device=magnitude.device).manual_seed(0)
        phase = (torch.rand(magnitude.shape, generator=generator,
                            device=magnitude.device) * 2.0 - 1.0) * math.pi
    phase = phase.clone()
    for _ in range(n_iters):
        signal = istft(magnitude, phase, cfg)
        _, new_phase = stft(signal, cfg)
        # the STFT of the trimmed signal can be one frame short
        t = min(new_phase.shape[-1], magnitude.shape[-1])
        phase[..., :t] = new_phase[..., :t]
    return istft(magnitude, phase, cfg)
