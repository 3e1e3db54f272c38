"""Fused mel-spectrogram extraction: hand-written CUDA kernel and its plain
version.

Replaces the TPU kernel ``tacotron2_tpu/kernels/mel_kernel.py``
``_mel_kernel`` (via ``mel_spectrogram_pallas``): framed DFT (products with
the windowed cos and sin bases) -> magnitude -> mel product ->
log(clamp 1e-5), with the (frames x bins) magnitude never in device memory.
fp32 in and out; the kernel takes each DFT product as three TF32 products
(3xTF32: the operands split into TF32 hi and lo parts), which keeps fp32
accuracy on the tensor cores, on frames folded about their centre (half the
depth: with a centred window the windowed bases are even and odd there; an
off-centre window takes a second pass over the same depth).

``mel_spectrogram_fused`` takes the kernel (``csrc/mel_kernel.cu``) for a
CUDA tensor and the plain version for a CPU tensor; nothing else picks
between them. The kernel reads the overlapping frames straight from the
waveform and does the reflect padding itself; the CUDA source's header note
gives its design and what bounds it on the H100. The windowed bases are
split and packed for it once per (n_fft, window, device) (``packed_bases``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tacotron2_tpu_torch.audio.mel import MelConfig, mel_weights
from tacotron2_tpu_torch.audio.stft import (STFTConfig, dft_basis,
                                            frame_signal,
                                            n_frames_for_samples)
from tacotron2_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"mel_spectrogram": [_P] * 5 + [_I] * 8 + [_P],
               "mel_limits": [_I, ctypes.POINTER(ctypes.c_size_t),
                              ctypes.POINTER(ctypes.c_int)]}
_NB, _KC = 64, 32   # MEL_NB bins per tile, MEL_KC depth per chunk


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as hi + lo, each rounded to TF32 (10 mantissa bits,
    nearest with ties away from zero: PTX's cvt.rna.tf32.f32), hi + lo
    within ~2^-22 of x."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


@functools.lru_cache(maxsize=16)
def _packed(stft_cfg: STFTConfig, device: str):
    cos_b, sin_b = dft_basis(stft_cfg, device)
    n_fft, n_bins = cos_b.shape
    half = n_fft // 2
    paired = torch.arange(1, half + 1, device=cos_b.device)
    paired = paired[2 * paired < n_fft]        # rows k paired with n - k

    def fold(b):                               # rows k <= n / 2: even, odd
        even, odd = b[:half + 1].clone(), torch.zeros_like(b[:half + 1])
        even[paired] = (b[paired] + b[n_fft - paired]) / 2
        odd[paired] = (b[paired] - b[n_fft - paired]) / 2
        return even, odd
    cos_e, cos_o = fold(cos_b)
    sin_e, sin_o = fold(sin_b)
    # a window symmetric about the frame's centre leaves cos odd and sin
    # even zero (sin even to rounding at its unpaired rows, sin 0 and sin pi)
    parts = [(cos_e, sin_o)]
    if max(float(cos_o.abs().max()), float(sin_e.abs().max())) > 1e-6:
        parts.append((cos_o, sin_e))
    nt, kpad = -(-n_bins // _NB), -(-(half + 1) // _KC) * _KC
    pad = lambda b: torch.nn.functional.pad(
        b, (0, nt * _NB - n_bins, 0, kpad - half - 1)).reshape(kpad, nt, _NB)
    both = torch.stack([torch.cat([pad(c), pad(s)], dim=2)
                        for c, s in parts])    # (parts, kpad, nt, 2 * NB)
    return tuple(p.permute(2, 0, 1, 3).contiguous() for p in split_tf32(both))


def packed_bases(cfg: MelConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The windowed cos and sin bases as the kernel streams them, folded
    about the frame's centre: rows k <= n_fft / 2 of their even parts (C[k]
    + C[n - k]) / 2 and odd parts (C[k] - C[n - k]) / 2 (row k itself where
    it has no partner), split into TF32 hi and lo parts, each
    (ceil(n_bins / 64), parts, n_fft / 2 + 1 rounded up to 32,
    [cos 64 | sin 64]) with zeros past n_bins and those rows. Part 0 holds
    [cos even | sin odd], which take the folded sums and differences of a
    frame; a window that is not symmetric about the frame's centre (n_fft -
    win_length odd) adds part 1, [cos odd | sin even], which take them the
    other way round. Made once per STFT config and device, as the bases
    themselves."""
    return _packed(cfg.stft, str(device))


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
        code = lib.mel_limits(cfg.n_mel_channels, ctypes.byref(need),
                              ctypes.byref(have))
        if code == 1:
            raise ValueError(f"the mel kernel takes at most 128 mel "
                             f"channels, got {cfg.n_mel_channels}")
        if code == 2:
            raise RuntimeError(f"the mel kernel needs {need.value} bytes "
                               f"of shared memory; a block may use "
                               f"{have.value}")
        if code != 0:
            raise RuntimeError("mel kernel: the device's shared-memory "
                               "limit could not be read")
        y = y.contiguous()
        b_hi, b_lo = packed_bases(cfg, y.device)
        mel_t = mel_weights(cfg, y.device)
        T = n_frames_for_samples(cfg.stft, S)
        out = torch.empty(B, cfg.n_mel_channels, T, device=y.device)
        status = lib.mel_spectrogram(
            y.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(),
            mel_t.data_ptr(), out.data_ptr(), B, S, T, cfg.filter_length,
            cfg.hop_length, cfg.stft.n_bins, cfg.n_mel_channels,
            b_hi.shape[1], torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, status, "mel_spectrogram")
    mel_spectrogram_fused.launches += 1
    return out


mel_spectrogram_fused.launches = 0
