"""Mel-spectrogram front end.

Counterpart of the JAX package's ``audio/mel.py`` (reference
``TacotronSTFT``, layers.py:42-80): STFT magnitude -> slaney mel filterbank
-> log dynamic-range compression. ``mel_spectrogram`` is two dense products
plus elementwise ops; ``mel_spectrogram_backend(..., "cuda")`` is the fused
hand-written kernel (``kernels/mel_kernel.py``), which keeps the magnitude
out of device memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tacotron2_tpu_torch.audio import filters
from tacotron2_tpu_torch.audio.stft import (STFTConfig, dft_basis,
                                            frame_signal,
                                            n_frames_for_samples)
from tacotron2_tpu_torch.config import Tacotron2Config


class MelConfig(NamedTuple):
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    sampling_rate: int = 22050
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    @property
    def stft(self) -> STFTConfig:
        return STFTConfig(self.filter_length, self.hop_length, self.win_length)

    @classmethod
    def from_config(cls, config: Tacotron2Config) -> "MelConfig":
        return cls(config.filter_length, config.hop_length, config.win_length,
                   config.n_mel_channels, config.sampling_rate,
                   config.mel_fmin, config.mel_fmax)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5,
                              C: float = 1.0) -> torch.Tensor:
    """log(clamp(x, 1e-5)), reference audio_processing.py:78-84."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0
                                ) -> torch.Tensor:
    return torch.exp(x) / C


@functools.lru_cache(maxsize=16)
def _mel_weights(cfg: MelConfig, device: str) -> torch.Tensor:
    """The mel filterbank transposed, (n_bins, n_mels), on ``device``."""
    w = filters.mel_filterbank(cfg.sampling_rate, cfg.filter_length,
                               cfg.n_mel_channels, cfg.mel_fmin, cfg.mel_fmax)
    return torch.from_numpy(w.T.copy()).to(device)


def mel_weights(cfg: MelConfig, device) -> torch.Tensor:
    return _mel_weights(cfg, str(device))


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, T) waveform in [-1, 1] -> (B, n_mels, n_frames) log-mel, as the
    reference's TacotronSTFT.mel_spectrogram (layers.py:63-80):
    reflect-padded windowed DFT magnitudes, slaney-normalized mel
    projection, log-clamp compression."""
    frames = frame_signal(y.float(), cfg.stft)
    cos_b, sin_b = dft_basis(cfg.stft, y.device)
    real = frames @ cos_b
    imag = frames @ sin_b
    power = real * real + imag * imag
    # sqrt(power), with a zero gradient where the power is 0: the plain
    # sqrt's is inf there, which makes NaN of a differentiated mel (the
    # HiFi-GAN trainer's mel L1) when a bin of generated audio is silent
    zero = power == 0
    magnitude = torch.where(zero, 0.0, torch.sqrt(power.masked_fill(zero, 1)))
    mel = magnitude @ mel_weights(cfg, y.device)
    return dynamic_range_compression(mel).transpose(1, 2)


def mel_frames_for_samples(cfg: MelConfig, num_samples: int) -> int:
    return n_frames_for_samples(cfg.stft, num_samples)


def mel_spectrogram_backend(y: torch.Tensor, cfg: MelConfig,
                            backend: str = "torch") -> torch.Tensor:
    """The interchangeable implementations: 'torch' (two products through
    ``torch.matmul``) or 'cuda' (the single fused kernel; its plain version
    for a CPU tensor)."""
    if backend == "torch":
        return mel_spectrogram(y, cfg)
    if backend == "cuda":
        from tacotron2_tpu_torch.kernels.mel_kernel import (
            mel_spectrogram_fused)
        return mel_spectrogram_fused(y, cfg)
    raise ValueError(f"unknown mel backend {backend!r}")
