"""Static length buckets and batch assembly.

The port's copy of the JAX package's ``data/bucketing.py``: every batch is
padded to one of a few fixed (text, mel) shapes, and a vocoder request to a
multiple of a fixed number of mel frames, so the kernels see a bounded set
of shapes. ``pad_batch`` and ``BucketSampler`` build the training batches.
"""

from __future__ import annotations

import math
import warnings
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tacotron2_tpu_torch.config import Tacotron2Config

_EXTENSION_WARNED: set = set()


def text_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length.

    Lengths beyond the last configured bucket AUTO-EXTEND the grid (next
    multiple of the last inter-bucket spacing) rather than clamping: a clamp
    would silently truncate the transcript tail. A warning (once per
    extended shape) flags the config as undersized.
    """
    for b in buckets:
        if length <= b:
            return b
    spacing = buckets[-1] - buckets[-2] if len(buckets) >= 2 else buckets[-1]
    extended = (buckets[-1]
                + spacing * math.ceil((length - buckets[-1]) / spacing))
    key = (tuple(buckets), extended)
    if key not in _EXTENSION_WARNED:
        _EXTENSION_WARNED.add(key)
        warnings.warn(
            f"text length {length} exceeds the largest configured text "
            f"bucket {buckets[-1]}; auto-extending to a {extended} bucket "
            f"(one extra shape). Add larger text_buckets to the config to "
            f"silence this.", stacklevel=2)
    return extended


def mel_bucket(length: int, step: int, max_length: int) -> int:
    """Smallest multiple of ``step`` >= length, capped at ``max_length``."""
    return min(step * math.ceil(length / step), max_length)


def pad_batch(items: List[Tuple[np.ndarray, np.ndarray]],
              t_text: int, t_mel: int, n_frames_per_step: int = 1,
              ) -> Tuple[np.ndarray, ...]:
    """Assemble padded arrays from (text_ids, mel(n_mels, T)) pairs.

    Returns (text, text_lengths, mel(B, T, n_mels), gate, mel_lengths):
    channels-last mels, unlike the reference's (B, n_mels, T). The gate
    target is 1.0 from each row's last real frame on (reference
    data_utils.py:107). Text is never truncated; a mel longer than
    ``t_mel`` is, with a warning.
    """
    if t_mel % n_frames_per_step:
        t_mel += n_frames_per_step - t_mel % n_frames_per_step
    B = len(items)
    n_mels = items[0][1].shape[0]
    text = np.zeros((B, t_text), np.int32)
    text_lengths = np.zeros((B,), np.int32)
    mel = np.zeros((B, t_mel, n_mels), np.float32)
    gate = np.zeros((B, t_mel), np.float32)
    mel_lengths = np.zeros((B,), np.int32)
    for i, (ids, m) in enumerate(items):
        L_t = len(ids)
        if L_t > t_text:
            raise ValueError(
                f"text row {i} has {L_t} symbols > padded shape {t_text}; "
                "bucketing must never truncate text (text_bucket "
                "auto-extends: this indicates a mis-sized caller shape)")
        L_m = m.shape[1]
        if L_m > t_mel:
            warnings.warn(
                f"mel row {i} truncated {L_m} -> {t_mel} frames by the "
                f"max_mel_length cap; its gate target will fire early. "
                f"Raise max_mel_length to train on full-length audio.",
                stacklevel=2)
            L_m = t_mel
        text[i, :L_t] = ids
        text_lengths[i] = L_t
        mel[i, :L_m] = m.T[:L_m]
        gate[i, L_m - 1:] = 1.0
        mel_lengths[i] = L_m
    return text, text_lengths, mel, gate, mel_lengths


class BucketSampler:
    """Groups dataset indices into fixed-shape batches.

    Items are binned by (text_bucket, mel_bucket); full bins of
    ``batch_size`` become batches. With ``drop_last`` (training), leftover
    partial bins are dropped, like the reference DataLoader's
    ``drop_last=True`` (train.py:55-58).
    """

    def __init__(self, lengths: Sequence[Tuple[int, int]],
                 config: Tacotron2Config, batch_size: Optional[int] = None,
                 drop_last: bool = True):
        self.lengths = list(lengths)  # (text_len, mel_len) per item
        self.config = config
        self.batch_size = batch_size or config.batch_size
        self.drop_last = drop_last

    def shape_of(self, index: int) -> Tuple[int, int]:
        t_len, m_len = self.lengths[index]
        return (text_bucket(t_len, self.config.text_buckets),
                mel_bucket(m_len, self.config.mel_bucket_step,
                           self.config.max_mel_length))

    def batches(self, epoch_rng: Optional[np.random.RandomState] = None,
                ) -> Iterator[Tuple[Tuple[int, int], List[int]]]:
        """Yields ((t_text, t_mel), item_indices) batches."""
        order = np.arange(len(self.lengths))
        if epoch_rng is not None:
            epoch_rng.shuffle(order)
        bins: dict = {}
        for idx in order:
            shape = self.shape_of(int(idx))
            bins.setdefault(shape, []).append(int(idx))
            if len(bins[shape]) == self.batch_size:
                yield shape, bins.pop(shape)
        if not self.drop_last:
            yield from bins.items()

    def distinct_shapes(self) -> List[Tuple[int, int]]:
        return sorted({self.shape_of(i) for i in range(len(self.lengths))})
