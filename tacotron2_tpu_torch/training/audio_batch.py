"""Training from raw-audio batches: the mel targets made on the device, in
the step.

Counterpart of the JAX package's ``training/audio_batch.py``. The
reference computes mels on the host in its DataLoader workers
(data_utils.py:37-47); here a step can take padded waveforms and extract
the mels on the card, through the fused mel kernel (``backend="cuda"``,
``kernels/mel_kernel.py``, kernel-table row 8; the JAX package's
``"pallas"``) or the two ``torch.matmul`` products (``"torch"``, the JAX
package's ``"xla"``), then run ``training/state.train_step`` (rows 1-4).
The targets follow the reference collate (data_utils.py:93-108): mel rows
zero past each row's frame count, gate 1 from the last real frame on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tacotron2_tpu_torch.audio.mel import MelConfig, mel_spectrogram_backend
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.models import tacotron2 as model_lib
from tacotron2_tpu_torch.ops.layers import length_mask
from tacotron2_tpu_torch.training.state import (Batch, StepMetrics,
                                                TrainState, train_step)


class AudioBatch(NamedTuple):
    """A padded raw-audio batch. T_samples is hop * (T_mel_bucket - 1), so
    that the mel frame count lands on the bucket."""
    text: torch.Tensor           # (B, T_in) int32
    text_lengths: torch.Tensor   # (B,) int32
    audio: torch.Tensor          # (B, T_samples) fp32 in [-1, 1], zero-padded
    audio_lengths: torch.Tensor  # (B,) int32 valid samples a row


def mel_targets_from_audio(batch: AudioBatch, cfg: Tacotron2Config,
                           backend: str = "cuda") -> Batch:
    """audio -> the training batch (mel, gate, lengths) on the audio's
    device: the mel padded to a multiple of r frames, each row's frame
    count 1 + valid_samples // hop (a centred STFT) capped at the padded
    length, mel zero past it, gate 1 from its last real frame on."""
    mel = mel_spectrogram_backend(batch.audio, MelConfig.from_config(cfg),
                                  backend).transpose(1, 2)  # (B, T, n_mels)
    r = cfg.n_frames_per_step
    mel = F.pad(mel, (0, 0, 0, -mel.shape[1] % r))
    t_mel = mel.shape[1]
    mel_lengths = torch.clamp(1 + batch.audio_lengths // cfg.hop_length,
                              max=t_mel).to(torch.int32)
    mel = torch.where(length_mask(mel_lengths, t_mel)[:, :, None], mel, 0.0)
    t = torch.arange(t_mel, device=mel.device)[None, :]
    gate = (t >= (mel_lengths - 1)[:, None]).float()
    return Batch(batch.text, batch.text_lengths, mel, gate, mel_lengths)


def train_step_from_audio(state: TrainState, batch: AudioBatch,
                          cfg: Tacotron2Config,
                          generator: Optional[torch.Generator] = None,
                          mel_backend: str = "cuda"
                          ) -> Tuple[TrainState, StepMetrics,
                                     model_lib.ForwardOutput]:
    """``train_step`` with the mel targets extracted in the step."""
    return train_step(state, mel_targets_from_audio(batch, cfg, mel_backend),
                      cfg, generator)


def pad_audio_batch(items: Sequence[Tuple[np.ndarray, np.ndarray]],
                    t_text: int, t_mel: int, hop_length: int) -> AudioBatch:
    """An ``AudioBatch`` of host tensors from (text_ids, waveform) pairs,
    the audio padded to hop * (t_mel - 1) samples so that its frames are
    t_mel."""
    B = len(items)
    t_samples = hop_length * (t_mel - 1)
    text = np.zeros((B, t_text), np.int32)
    text_lengths = np.zeros((B,), np.int32)
    audio = np.zeros((B, t_samples), np.float32)
    audio_lengths = np.zeros((B,), np.int32)
    for i, (ids, wav) in enumerate(items):
        n_t = min(len(ids), t_text)
        text[i, :n_t] = ids[:n_t]
        text_lengths[i] = n_t
        n_a = min(len(wav), t_samples)
        audio[i, :n_a] = wav[:n_a]
        audio_lengths[i] = n_a
    return AudioBatch(*(torch.from_numpy(x) for x in
                        (text, text_lengths, audio, audio_lengths)))
