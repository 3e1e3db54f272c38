"""Fused mel-spectrogram extraction: hand-written CUDA kernel and its plain
version.

Replaces the TPU kernel ``tacotron2_tpu/kernels/mel_kernel.py``
``_mel_kernel`` (via ``mel_spectrogram_pallas``): framed DFT (products with
the windowed cos and sin bases) -> magnitude -> mel product ->
log(clamp 1e-5), with the (frames x bins) magnitude never in device memory.
fp32 throughout.

``mel_spectrogram_fused`` takes the kernel (``csrc/mel_kernel.cu``) for a
CUDA tensor and the plain version for a CPU tensor; nothing else picks
between them. The kernel reads the overlapping frames straight from the
waveform and does the reflect padding itself; the CUDA source's header note
gives its design and what bounds it on the H100.
"""

from __future__ import annotations

import ctypes

import torch

from tacotron2_tpu_torch.audio.mel import MelConfig, mel_weights
from tacotron2_tpu_torch.audio.stft import (dft_basis, frame_signal,
                                            n_frames_for_samples)
from tacotron2_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"mel_spectrogram": [_P] * 5 + [_I] * 7 + [_P],
               "mel_limits": [_I] * 3 + [ctypes.POINTER(ctypes.c_size_t),
                                         ctypes.POINTER(ctypes.c_int)]}


def mel_spectrogram_fused_plain(y: torch.Tensor, cfg: MelConfig
                                ) -> torch.Tensor:
    """The plain PyTorch version: (B, samples) fp32 -> (B, n_mels, frames)
    log-mel, the kernel's arithmetic (every product in fp32)."""
    mel_spectrogram_fused_plain.calls += 1
    frames = frame_signal(y, cfg.stft)
    cos_b, sin_b = dft_basis(cfg.stft, y.device)
    real = frames @ cos_b
    imag = frames @ sin_b
    magnitude = torch.sqrt(real * real + imag * imag)
    mel = magnitude @ mel_weights(cfg, y.device)
    return torch.log(torch.clamp(mel, min=1e-5)).transpose(1, 2)


mel_spectrogram_fused_plain.calls = 0


def mel_spectrogram_fused(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, samples) fp32 waveform -> (B, n_mels, n_frames) fp32 log-mel.
    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if y.dim() != 2 or y.dtype != torch.float32:
        raise ValueError(f"expected a (B, samples) float32 waveform, got "
                         f"{tuple(y.shape)} {y.dtype}")
    B, S = y.shape
    if S <= cfg.filter_length // 2:
        raise ValueError(f"{S} samples are too few to reflect-pad by "
                         f"{cfg.filter_length // 2}")
    if not y.is_cuda:
        return mel_spectrogram_fused_plain(y, cfg)
    lib = _build.load("mel_kernel", _SIGNATURES)
    need, have = ctypes.c_size_t(0), ctypes.c_int(0)
    with torch.cuda.device(y.device):
        code = lib.mel_limits(cfg.filter_length, cfg.hop_length,
                              cfg.n_mel_channels, ctypes.byref(need),
                              ctypes.byref(have))
        if code == 1:
            raise ValueError(f"the mel kernel takes at most 128 mel "
                             f"channels, got {cfg.n_mel_channels}")
        if code == 2:
            raise ValueError(f"the mel kernel needs {need.value} bytes of "
                             f"shared memory at n_fft {cfg.filter_length}, "
                             f"hop {cfg.hop_length}; a block may use "
                             f"{have.value}")
        if code != 0:
            raise RuntimeError("mel kernel: the device's shared-memory "
                               "limit could not be read")
        y = y.contiguous()
        cos_b, sin_b = dft_basis(cfg.stft, y.device)
        mel_t = mel_weights(cfg, y.device)
        T = n_frames_for_samples(cfg.stft, S)
        out = torch.empty(B, cfg.n_mel_channels, T, device=y.device)
        status = lib.mel_spectrogram(
            y.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
            mel_t.data_ptr(), out.data_ptr(), B, S, T, cfg.filter_length,
            cfg.hop_length, cos_b.shape[1], cfg.n_mel_channels,
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, status, "mel_spectrogram")
    mel_spectrogram_fused.launches += 1
    return out


mel_spectrogram_fused.launches = 0
