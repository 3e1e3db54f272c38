"""Dataset: (audio path, transcript) filelists -> (symbol IDs, log-mel).

The port's copy of the JAX package's ``data/dataset.py`` (the reference's
``TextMelLoader``, data_utils.py:11-64): reads ``path|text`` filelists,
encodes text, and computes (or loads precomputed) mel spectrograms. Mels
are computed in numpy on the host, with the same math as the port's
``audio/mel.py``, so cached and on-the-fly mels are interchangeable.
"""

from __future__ import annotations

import os
import random
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.io.wavfile

from tacotron2_tpu_torch.audio import filters
from tacotron2_tpu_torch.audio.mel import MelConfig
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.text import text_to_sequence

# Mels computed from wavs are kept, up to this many bytes in all, so that
# epochs after a corpus's first pay no extraction beside the host-bound step
# loop (data/pipeline.py). A corpus larger than this computes the rest anew
# each epoch; precomputed .npy mels (load_mel_from_disk) are read, not kept.
MEL_CACHE_BYTES = 4 << 30

NATIVE_NOT_PORTED = ("the native C++ mel extractor (data/native.py) is not "
                     "ported yet (ROADMAP.md, section A.2); pass "
                     "use_native=None or False for the numpy path")


def load_filelist(path: str, split: str = "|") -> List[List[str]]:
    """Parse a ``audiopath|transcript`` filelist (reference utils.py:18-21)."""
    with open(path, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV -> float32 samples (raw integer range) + sample rate."""
    sampling_rate, data = scipy.io.wavfile.read(path)
    return data.astype(np.float32), sampling_rate


def mel_spectrogram_np(y: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """Host-side (numpy) mel extraction, numerically matching
    ``audio.mel.mel_spectrogram``: reflect pad, windowed rfft magnitudes,
    slaney mel projection, log-clamp. y: (T,) in [-1, 1] -> (n_mels, frames).
    """
    pad = cfg.filter_length // 2
    y = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(y) - cfg.filter_length) // cfg.hop_length
    idx = (np.arange(n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.filter_length)[None, :])
    frames = y[idx] * filters.padded_window(cfg.win_length, cfg.filter_length)
    magnitude = np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)
    mel_w = filters.mel_filterbank(cfg.sampling_rate, cfg.filter_length,
                                   cfg.n_mel_channels, cfg.mel_fmin,
                                   cfg.mel_fmax)
    mel = magnitude @ mel_w.T  # (frames, n_mels)
    return np.log(np.clip(mel, 1e-5, None)).T.astype(np.float32)


class TextMelDataset:
    """Indexable (text IDs, mel) pairs from a filelist.

    Matches the reference's per-item behavior: seeded shuffle at
    construction (data_utils.py:28-29), text cleaning via the configured
    cleaners, wav normalized by max_wav_value, strict sample-rate check.
    Mels computed from wavs are kept (``MEL_CACHE_BYTES``): the same bytes
    come back for the same file. ``use_native=True`` asks for the native
    extractor, which is not ported and raises; None or False take the numpy
    path.
    """

    def __init__(self, filelist_path: str, config: Tacotron2Config,
                 shuffle: bool = True, use_native: Optional[bool] = None):
        if use_native:
            raise NotImplementedError(NATIVE_NOT_PORTED)
        self.entries = load_filelist(filelist_path)
        self.config = config
        self.mel_config = MelConfig.from_config(config)
        if shuffle:
            rng = random.Random(config.seed)
            rng.shuffle(self.entries)
        # optional mixed grapheme/phoneme encoding (text/arpabet.py)
        self._cmudict = None
        self._arpabet_rng = None
        if config.p_arpabet > 0.0 and config.cmudict_path:
            from tacotron2_tpu_torch.text.cmudict import CMUDict
            self._cmudict = CMUDict(config.cmudict_path)
            self._arpabet_rng = random.Random(config.seed + 1)
        self._mels: Dict[str, np.ndarray] = {}
        self._mel_bytes = 0
        self._mels_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.entries)

    def get_text(self, text: str) -> np.ndarray:
        if self._cmudict is not None:
            from tacotron2_tpu_torch.text.arpabet import encode_mixed
            return np.asarray(
                encode_mixed(text, self.config.text_cleaners, self._cmudict,
                             self._arpabet_rng, self.config.p_arpabet),
                np.int32)
        return np.asarray(
            text_to_sequence(text, self.config.text_cleaners), np.int32)

    def get_mel(self, audio_path: str) -> np.ndarray:
        """(n_mels, frames) log-mel from a wav or a cached .npy."""
        if self.config.load_mel_from_disk or audio_path.endswith(".npy"):
            mel = np.load(_npy_path(audio_path))
            if mel.shape[0] != self.config.n_mel_channels:
                raise ValueError(
                    f"mel channel mismatch: {mel.shape[0]} != "
                    f"{self.config.n_mel_channels}")
            return mel.astype(np.float32)
        mel = self._mels.get(audio_path)
        if mel is not None:
            return mel
        audio, sr = load_wav(audio_path)
        if sr != self.config.sampling_rate:
            raise ValueError(f"{audio_path}: sample rate {sr} != "
                             f"{self.config.sampling_rate}")
        mel = mel_spectrogram_np(audio / self.config.max_wav_value,
                                 self.mel_config)
        mel.flags.writeable = False  # shared by every later epoch
        with self._mels_lock:
            if self._mel_bytes + mel.nbytes <= MEL_CACHE_BYTES:
                self._mels[audio_path] = mel
                self._mel_bytes += mel.nbytes
        return mel

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        audio_path, text = self.entries[index][0], self.entries[index][1]
        return self.get_text(text), self.get_mel(audio_path)


def _npy_path(audio_path: str) -> str:
    if audio_path.endswith(".npy"):
        return audio_path
    base, _ = os.path.splitext(audio_path)
    return base + ".npy"


def wav_num_samples(path: str) -> int:
    """Sample count from the RIFF header alone (no decode): lets the
    bucketing pass compute mel lengths (1 + n // hop) without extracting
    a single spectrogram."""
    with open(path, "rb") as f:
        if f.read(4) != b"RIFF":
            raise ValueError(f"{path}: not a RIFF file")
        f.seek(8)
        if f.read(4) != b"WAVE":
            raise ValueError(f"{path}: not a WAVE file")
        bits, channels = 16, 1
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError(f"{path}: no data chunk")
            tag, size = header[:4], struct.unpack("<I", header[4:])[0]
            if tag == b"fmt ":
                fmt = f.read(size)
                channels = struct.unpack("<H", fmt[2:4])[0]
                bits = struct.unpack("<H", fmt[14:16])[0]
            elif tag == b"data":
                return size // (bits // 8) // channels
            else:
                f.seek(size + (size & 1), 1)


def item_lengths(entry: List[str], config: Tacotron2Config) -> Tuple[int, int]:
    """(text_len, mel_len) for one filelist entry, decoding nothing."""
    audio_path, text = entry[0], entry[1]
    text_len = len(text_to_sequence(text, config.text_cleaners))
    if config.load_mel_from_disk or audio_path.endswith(".npy"):
        mel = np.load(_npy_path(audio_path), mmap_mode="r")
        mel_len = mel.shape[1]
    else:
        mel_len = 1 + wav_num_samples(audio_path) // config.hop_length
    return text_len, mel_len
