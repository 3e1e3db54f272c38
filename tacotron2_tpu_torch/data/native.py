"""ctypes bindings for the native DSP library (``native/mel_extract.cc``),
the port's own copy of the JAX package's ``data/native.py``.

Loads ``native/libtaco_dsp.so`` when it has been built (``native/build.sh``,
g++) and exposes WAV reading and log-mel extraction with the numerics of the
numpy path (``dataset.mel_spectrogram_np``). ``available()`` is False until
the library is built; ``TextMelDataset`` then uses numpy.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Tuple

import numpy as np

from tacotron2_tpu_torch.audio.mel import MelConfig

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "libtaco_dsp.so")

_libs: Dict[str, ctypes.CDLL] = {}  # by path: a loaded library stays loaded
_lib_lock = threading.Lock()


def _load():
    """The library at ``_LIB_PATH``, loaded once; None when not built."""
    with _lib_lock:
        lib = _libs.get(_LIB_PATH)
        if lib is not None or not os.path.exists(_LIB_PATH):
            return lib
        lib = ctypes.CDLL(_LIB_PATH)
        lib.taco_mel_init.restype = ctypes.c_void_p
        lib.taco_mel_init.argtypes = [ctypes.c_int] * 5 + [ctypes.c_double] * 2
        lib.taco_mel_free.restype = None
        lib.taco_mel_free.argtypes = [ctypes.c_void_p]
        lib.taco_mel_frames.restype = ctypes.c_int
        lib.taco_mel_frames.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.taco_mel_extract.restype = ctypes.c_int
        lib.taco_mel_extract.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.taco_wav_read.restype = ctypes.c_int
        lib.taco_wav_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        _libs[_LIB_PATH] = lib
        return lib


def available() -> bool:
    return _load() is not None


class NativeMelExtractor:
    """One ``taco_mel`` context for a mel config; ``extract`` may run in
    several threads at once (the context is read-only after init)."""

    def __init__(self, cfg: MelConfig):
        lib = _load()
        if lib is None:
            raise RuntimeError("libtaco_dsp.so not built; run native/build.sh")
        self._lib = lib
        self._handle = lib.taco_mel_init(
            cfg.sampling_rate, cfg.filter_length, cfg.hop_length,
            cfg.win_length, cfg.n_mel_channels,
            float(cfg.mel_fmin), float(cfg.mel_fmax))
        if not self._handle:
            raise RuntimeError("taco_mel_init failed (n_fft power of two?)")
        self.cfg = cfg

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.taco_mel_free(self._handle)
            self._handle = None

    def extract(self, audio: np.ndarray) -> np.ndarray:
        """(T,) float32 in [-1, 1] -> (n_mels, frames) log-mel."""
        audio = np.ascontiguousarray(audio, np.float32)
        n_frames = self._lib.taco_mel_frames(self._handle, len(audio))
        out = np.empty((self.cfg.n_mel_channels, n_frames), np.float32)
        got = self._lib.taco_mel_extract(
            self._handle,
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(audio),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if got != n_frames:
            raise RuntimeError(f"native mel extraction failed ({got})")
        return out


def wav_read(path: str) -> Tuple[np.ndarray, int]:
    """WAV -> (float32 samples in the raw int16 range, sample rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libtaco_dsp.so not built; run native/build.sh")
    sr = ctypes.c_int(0)
    n = lib.taco_wav_read(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        raise IOError(f"cannot read wav {path}")
    out = np.empty((n,), np.float32)
    got = lib.taco_wav_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(sr))
    if got != n:
        raise IOError(f"short wav read {path}")
    return out, sr.value
