"""Text-to-speech inference pipeline on the port, as a library and a CLI.

Counterpart of the JAX package's ``infer.py`` (the reference notebook's flow
end to end): checkpoint -> text_to_sequence -> Tacotron 2 inference ->
vocoder -> waveform. Batched: ``synthesize`` takes a list of texts and
per-row gate stopping trims each result independently. Vocoders: WaveGlow
at sigma 0.666 with an optional ``Denoiser`` (the notebook's), the HiFi-GAN
generator, Griffin-Lim, or none (mel only).

    python -m tacotron2_tpu_torch.infer -c OUT/checkpoint_<step>.pt \
        -t "Hello world." -o synth [--vocoder griffin_lim|hifigan|waveglow]
        [--vocoder_checkpoint V.pt [--torch_vocoder]] [--fused | --int8]
        [--hparams max_decoder_steps=...] [--device cuda|cpu]

writes ``<prefix>_<i>_mel.npy`` (n_mels, T) and ``<prefix>_<i>.wav``; it
runs on the card unless ``--device cpu``. It runs with PyTorch's default
TF32 settings: cuDNN convolutions (HiFi-GAN, WaveGlow, the encoder and
postnet convs at fp32) in TF32, matmuls in full fp32.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from tacotron2_tpu_torch.audio import filters
from tacotron2_tpu_torch.audio.mel import dynamic_range_decompression
from tacotron2_tpu_torch.audio.stft import (STFTConfig, griffin_lim, istft,
                                            stft)
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.models import hifigan, tacotron2, waveglow
from tacotron2_tpu_torch.text import text_to_sequence


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
    """WaveGlow bias removal (inference.ipynb cell 17, strength 0.01): the
    vocoder's output on a zero mel at sigma 0 gives a bias spectrum once;
    a call subtracts ``strength`` times its mean over frames from the
    audio's STFT magnitude, clips at 0 and inverts with the audio's phase.
    (The JAX package's ``mode="normal"``, a random mel, is not ported: no
    caller uses it.)"""

    def __init__(self, vocoder: waveglow.WaveGlow,
                 vocoder_cfg: waveglow.WaveGlowConfig,
                 stft_cfg: STFTConfig = STFTConfig(filter_length=1024,
                                                  hop_length=256,
                                                  win_length=1024),
                 n_mel_frames: int = 88):
        self.stft_cfg = stft_cfg
        mel = torch.zeros(1, n_mel_frames, vocoder_cfg.n_mel_channels,
                          device=next(vocoder.parameters()).device)
        bias_audio = waveglow.infer(vocoder, mel, vocoder_cfg, sigma=0.0)
        self.bias_mag = stft(bias_audio, stft_cfg)[0][0]  # (n_bins, T)

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor,
                 strength: float = 0.01) -> torch.Tensor:
        """(B, samples) -> (B, samples) with the bias removed."""
        mag, phase = stft(audio, self.stft_cfg)
        bias = self.bias_mag.to(mag.device).mean(dim=1, keepdim=True)[None]
        mag = torch.clamp(mag - strength * bias, min=0.0)
        return istft(mag, phase, self.stft_cfg)


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


VOCODERS = ("none", "griffin_lim", "waveglow", "hifigan")


@torch.no_grad()
def synthesize(model: tacotron2.Tacotron2, texts: Sequence[str],
               cfg: Tacotron2Config, *, vocoder: str = "griffin_lim",
               vocoder_model: Union[hifigan.Generator, waveglow.WaveGlow,
                                    None] = None,
               vocoder_cfg: Union[hifigan.HiFiGANConfig,
                                  waveglow.WaveGlowConfig, None] = None,
               denoiser: Optional[Denoiser] = None,
               denoiser_strength: float = 0.01, sigma: float = 0.666,
               generator: Optional[torch.Generator] = None,
               max_steps: Optional[int] = None, griffin_lim_iters: int = 30,
               fused: bool = False,
               device: Union[str, torch.device] = "cuda"
               ) -> List[SynthesisResult]:
    """Batched text -> (mel, audio). vocoder: 'none' | 'griffin_lim' |
    'waveglow' | 'hifigan'. ``fused=True`` decodes one text through the
    single-utterance decoder kernel (deterministic prenet only); otherwise
    the step-by-step decoder, which also takes a quantized model.
    ``generator`` (on the model's device) seeds the prenet dropout,
    WaveGlow's z (N(0, sigma^2)) and Griffin-Lim's start phase; without one
    the vocoders draw from a generator seeded 0. WaveGlow's audio goes
    through ``denoiser`` when one is given. The model, and the vocoder,
    must already be on ``device``."""
    if vocoder not in VOCODERS:
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
    if vocoder == "waveglow":
        audio_batch = waveglow.infer(vocoder_model, mel, vocoder_cfg,
                                     sigma=sigma, generator=generator)
        if denoiser is not None:
            audio_batch = denoiser(audio_batch, denoiser_strength)
    elif vocoder == "hifigan":
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


def load_vocoder(kind: str, path: str, cfg: Tacotron2Config, *,
                 torch_format: bool = False,
                 device: Union[str, torch.device] = "cuda"):
    """Vocoder weights -> (module on ``device`` in eval mode, its config).
    'waveglow': a ``checkpoint_<step>.pt`` of the port's
    ``training/vocoder_trainer``, or with ``torch_format`` a published
    WaveGlow ``.pt`` (``convert_waveglow``, at the published widths);
    'hifigan': the generator of a checkpoint of
    ``training/hifigan_trainer``. A trainer's checkpoint carries its
    vocoder's config and is read with ``weights_only``; its mel channels
    and hop must be the Tacotron config's."""
    from tacotron2_tpu_torch.training.checkpoint import load
    device = tacotron2.resolve_device(device)
    if kind not in ("waveglow", "hifigan"):
        raise ValueError(f"unknown vocoder {kind!r}")
    if torch_format:
        if kind != "waveglow":
            raise ValueError("torch_format reads published WaveGlow files "
                             "only")
        from tacotron2_tpu_torch.convert_waveglow import (
            load_waveglow_checkpoint)
        vocoder_cfg = waveglow.WaveGlowConfig(
            n_mel_channels=cfg.n_mel_channels, upsample_stride=cfg.hop_length)
        return (load_waveglow_checkpoint(path, vocoder_cfg, device),
                vocoder_cfg)
    ckpt = load(path)
    if ckpt.get("kind") != kind:
        raise ValueError(f"{path} is not a {kind} checkpoint (kind "
                         f"{ckpt.get('kind')!r})")
    if kind == "waveglow":
        vocoder_cfg = waveglow.WaveGlowConfig(**ckpt["config"])
        module = waveglow.WaveGlow(vocoder_cfg)
    else:
        # a checkpoint from before the slope before conv_post was a
        # setting was trained at LRELU_SLOPE there
        vocoder_cfg = hifigan.HiFiGANConfig(**{
            "post_lrelu_slope": hifigan.LRELU_SLOPE, **ckpt["config"]})
        module = hifigan.Generator(vocoder_cfg)
    if (vocoder_cfg.n_mel_channels, vocoder_cfg.hop_length) != (
            cfg.n_mel_channels, cfg.hop_length):
        raise ValueError(f"{path}: a vocoder of {vocoder_cfg.n_mel_channels} "
                         f"mels and hop {vocoder_cfg.hop_length} for a model "
                         f"of {cfg.n_mel_channels} mels and hop "
                         f"{cfg.hop_length}")
    module.load_state_dict(ckpt["state_dict"], strict=True)
    return module.to(device).eval(), vocoder_cfg


def load_model(path: str, cfg: Tacotron2Config, *, torch_format: bool = False,
               device: Union[str, torch.device] = "cuda"
               ) -> tacotron2.Tacotron2:
    """The Tacotron 2 of a port ``checkpoint_<step>.pt`` (its state_dict,
    running statistics included), or with ``torch_format`` of a file
    holding a reference-format state_dict (bare or under ``state_dict``),
    on ``device`` in eval mode."""
    from tacotron2_tpu_torch.training.checkpoint import load
    blob = load(path)
    sd = blob["state_dict"] if not torch_format or "state_dict" in blob \
        else blob
    model = tacotron2.Tacotron2(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(tacotron2.resolve_device(device)).eval()


def main(argv: Optional[Sequence[str]] = None) -> None:
    from tacotron2_tpu_torch.config import create_config

    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.infer")
    parser.add_argument("-c", "--checkpoint", required=True,
                        help="a checkpoint_<step>.pt of the port's trainer")
    parser.add_argument("-t", "--text", action="append", required=True,
                        help="text to synthesize (repeatable)")
    parser.add_argument("-o", "--output_prefix", default="synth")
    parser.add_argument("--vocoder", default="griffin_lim", choices=VOCODERS)
    parser.add_argument("--vocoder_checkpoint", default=None,
                        help="vocoder weights: a checkpoint of the port's "
                             "vocoder trainers, or a published WaveGlow .pt "
                             "with --torch_vocoder")
    parser.add_argument("--torch_vocoder", action="store_true",
                        help="vocoder checkpoint is a published WaveGlow .pt")
    parser.add_argument("--torch_checkpoint", action="store_true",
                        help="checkpoint is a reference-format state_dict")
    parser.add_argument("--int8", action="store_true",
                        help="int8 weight-only decoder LSTMs (the int8 "
                             "product kernel)")
    parser.add_argument("--fused", action="store_true",
                        help="the single-utterance decoder chunk kernel (one "
                             "text only, deterministic prenet)")
    parser.add_argument("--hparams", type=str, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    if args.vocoder in ("waveglow", "hifigan") and not args.vocoder_checkpoint:
        parser.error(f"--vocoder {args.vocoder} needs --vocoder_checkpoint")
    if args.fused and (args.int8 or len(args.text) != 1):
        parser.error("--fused needs exactly one -t text and no --int8")
    cfg = create_config(args.hparams)
    device = tacotron2.resolve_device(args.device)
    model = load_model(args.checkpoint, cfg,
                       torch_format=args.torch_checkpoint, device=device)
    if args.int8:
        model = tacotron2.quantize_for_serving(model)
    vocoder_model, vocoder_cfg = None, None
    if args.vocoder in ("waveglow", "hifigan"):
        vocoder_model, vocoder_cfg = load_vocoder(
            args.vocoder, args.vocoder_checkpoint, cfg,
            torch_format=args.torch_vocoder, device=device)
    results = synthesize(model, args.text, cfg, vocoder=args.vocoder,
                         vocoder_model=vocoder_model, vocoder_cfg=vocoder_cfg,
                         fused=args.fused, device=device)
    import scipy.io.wavfile
    directory = os.path.dirname(args.output_prefix)
    if directory:
        os.makedirs(directory, exist_ok=True)
    for i, r in enumerate(results):
        np.save(f"{args.output_prefix}_{i}_mel.npy", r.mel.T)  # ref layout
        if r.audio is not None:
            wav = np.clip(r.audio, -1, 1)
            scipy.io.wavfile.write(f"{args.output_prefix}_{i}.wav",
                                   cfg.sampling_rate,
                                   (wav * 32767).astype(np.int16))
        print(f"[{i}] {r.mel.shape[0]} frames "
              f"({r.mel.shape[0] * cfg.hop_length / cfg.sampling_rate:.2f}s)")


if __name__ == "__main__":
    main()
