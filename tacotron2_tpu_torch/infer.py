"""Text-to-speech inference pipeline on the port.

Counterpart of the JAX package's ``infer.py`` (the reference notebook's flow
as a library): text_to_sequence -> Tacotron 2 inference -> vocoder ->
waveform. Batched: ``synthesize`` takes a list of texts and per-row gate
stopping trims each result independently. Vocoders: the HiFi-GAN generator,
Griffin-Lim, or none (mel only); WaveGlow and its ``Denoiser`` are not
ported yet. The command line waits for the port's checkpoint module.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from tacotron2_tpu_torch.audio import filters
from tacotron2_tpu_torch.audio.mel import dynamic_range_decompression
from tacotron2_tpu_torch.audio.stft import STFTConfig, griffin_lim
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.models import hifigan, tacotron2
from tacotron2_tpu_torch.text import text_to_sequence

WAVEGLOW_NOT_PORTED = ("the WaveGlow vocoder and its Denoiser are not "
                       "ported yet (ROADMAP.md, section A.2)")


class SynthesisResult(NamedTuple):
    mel: np.ndarray          # (T, n_mels) per item, trimmed
    audio: Optional[np.ndarray]  # (samples,) per item, or None (mel-only)
    alignment: np.ndarray    # (T, T_in)
    gate: np.ndarray         # (T,)


def encode_texts(texts: Sequence[str], cfg: Tacotron2Config):
    """Texts -> padded (ids (B, T) int64, lengths (B,) int32) tensors."""
    seqs = [text_to_sequence(t, cfg.text_cleaners) for t in texts]
    max_len = max(len(s) for s in seqs)
    ids = np.zeros((len(seqs), max_len), np.int64)
    lengths = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        lengths[i] = len(s)
    return torch.from_numpy(ids), torch.from_numpy(lengths)


class Denoiser:
    """WaveGlow bias removal; waits for the WaveGlow port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(WAVEGLOW_NOT_PORTED)


@functools.lru_cache(maxsize=8)
def _inverse_mel_basis(sampling_rate: int, n_fft: int, n_mels: int,
                       fmin: float, fmax: float, device: str) -> torch.Tensor:
    """The mel filterbank's pseudo-inverse, transposed: (n_mels, n_bins)."""
    mel_w = filters.mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)
    return torch.from_numpy(np.linalg.pinv(mel_w).T.copy()).to(device)


def mel_to_linear(mel: torch.Tensor, cfg: Tacotron2Config) -> torch.Tensor:
    """(B, T, n_mels) log-mel -> (B, n_bins, T) linear magnitude through the
    filterbank's pseudo-inverse, clipped at 0 (Griffin-Lim's input)."""
    inv = _inverse_mel_basis(cfg.sampling_rate, cfg.filter_length,
                             cfg.n_mel_channels, cfg.mel_fmin, cfg.mel_fmax,
                             str(mel.device))
    linear = torch.einsum("btm,mf->bft", dynamic_range_decompression(mel),
                          inv)
    return torch.clamp(linear, min=0.0)


@torch.no_grad()
def synthesize(model: tacotron2.Tacotron2, texts: Sequence[str],
               cfg: Tacotron2Config, *, vocoder: str = "griffin_lim",
               vocoder_model: Optional[hifigan.Generator] = None,
               vocoder_cfg: Optional[hifigan.HiFiGANConfig] = None,
               generator: Optional[torch.Generator] = None,
               max_steps: Optional[int] = None, griffin_lim_iters: int = 30,
               fused: bool = False,
               device: Union[str, torch.device] = "cuda"
               ) -> List[SynthesisResult]:
    """Batched text -> (mel, audio). vocoder: 'none' | 'griffin_lim' |
    'hifigan' ('waveglow' is not ported yet). ``fused=True`` decodes one
    text through the single-utterance decoder kernel (deterministic prenet
    only); otherwise the step-by-step decoder, which also takes a quantized
    model. ``generator`` (on the model's device) seeds the prenet dropout
    and Griffin-Lim's start phase. The model, and the vocoder, must already
    be on ``device``."""
    if vocoder == "waveglow":
        raise NotImplementedError(WAVEGLOW_NOT_PORTED)
    if vocoder not in ("none", "griffin_lim", "hifigan"):
        raise ValueError(f"unknown vocoder {vocoder!r}")
    device = tacotron2.resolve_device(device)
    text_ids, text_lengths = encode_texts(texts, cfg)
    cd = cfg.torch_compute_dtype
    if fused:
        if len(texts) != 1 or generator is not None:
            raise ValueError("fused decode is the B=1 deterministic path")
        result = tacotron2.infer_fused(model, text_ids, text_lengths, cfg,
                                       max_steps=max_steps, compute_dtype=cd,
                                       device=device)
    else:
        result = tacotron2.infer(
            model, text_ids, text_lengths, cfg, generator=generator,
            max_steps=max_steps, device=device,
            compute_dtype=None if cd == torch.float32 else cd)
    mel = result.mel_postnet  # (B, T_max, n_mels)

    audio_batch = None
    if vocoder == "hifigan":
        hg_cfg = vocoder_cfg if vocoder_cfg is not None else \
            hifigan.HiFiGANConfig(n_mel_channels=cfg.n_mel_channels)
        audio_batch = hifigan.generator(vocoder_model, mel, hg_cfg)
    elif vocoder == "griffin_lim":
        audio_batch = griffin_lim(
            mel_to_linear(mel, cfg),
            STFTConfig(cfg.filter_length, cfg.hop_length, cfg.win_length),
            n_iters=griffin_lim_iters, generator=generator)

    out = []
    hop = cfg.hop_length
    for b in range(len(texts)):
        T = int(result.mel_lengths[b])
        audio = None
        if audio_batch is not None:
            audio = audio_batch[b][:T * hop].cpu().numpy()
        out.append(SynthesisResult(
            mel=mel[b, :T].cpu().numpy(), audio=audio,
            alignment=result.alignments[b, :T].cpu().numpy(),
            gate=result.gate_energies[b, :T].cpu().numpy()))
    return out
