"""The port's ctypes binding to the native DSP library
(``tacotron2_tpu_torch/data/native.py`` over ``native/mel_extract.cc``).

The library is compiled here with ``native/build.sh``'s g++ flags into the
test's own directory, and the port's loader is pointed at it: nothing is
written into ``native/``, where a built library would switch
``tests/test_native.py`` and every dataset that defaults to the native
path. The mel against the port's and the JAX package's numpy
``mel_spectrogram_np`` within 5e-4 (tests/test_native.py's tolerance: the
C++ sums in double, numpy in float32).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import scipy.io.wavfile

from tacotron2_tpu.audio.mel import MelConfig as JaxMelConfig
from tacotron2_tpu.data.dataset import mel_spectrogram_np as jax_mel_np

from tacotron2_tpu_torch import data as tdata
from tacotron2_tpu_torch.audio.mel import MelConfig
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.data import native

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "mel_extract.cc")
BUILD_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
ATOL = 5e-4
SMALL_MEL = dict(filter_length=256, hop_length=64, win_length=256,
                 n_mel_channels=20, mel_fmax=8000.0)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """native/mel_extract.cc compiled into a directory of the test's."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the native library cannot build")
    out = tmp_path_factory.mktemp("native") / "libtaco_dsp.so"
    subprocess.run([gxx, *BUILD_FLAGS, "-o", str(out),
                    SOURCE], check=True, timeout=300)
    return str(out)


@pytest.fixture
def lib(built, monkeypatch):
    monkeypatch.setattr(native, "_LIB_PATH", built)
    assert native.available()
    return built


@pytest.fixture(scope="module")
def audio():
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, 22050, endpoint=False)
    y = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(len(t))
    return y.astype(np.float32)


@pytest.mark.parametrize("kw", [{}, SMALL_MEL], ids=["default", "small"])
def test_native_mel_matches_both_numpy_paths(lib, audio, kw):
    y = audio if not kw else audio[:8000]
    got = native.NativeMelExtractor(MelConfig(**kw)).extract(y)
    port = tdata.mel_spectrogram_np(y, MelConfig(**kw))
    jax_ = jax_mel_np(y, JaxMelConfig(**kw))
    assert got.shape == port.shape == jax_.shape
    np.testing.assert_allclose(got, port, atol=ATOL)
    np.testing.assert_allclose(got, jax_, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_native_wav_read(lib, audio, tmp_path, dtype):
    path = str(tmp_path / "test.wav")
    data = ((audio * 20000).astype(np.int16) if dtype == np.int16
            else (audio / 2).astype(np.float32))
    scipy.io.wavfile.write(path, 22050, data)
    got, sr = native.wav_read(path)
    assert sr == 22050 and got.dtype == np.float32
    if dtype == np.int16:  # the raw integer range, as scipy's
        np.testing.assert_array_equal(got, data.astype(np.float32))
    else:  # float WAVs come back in the int16 range
        np.testing.assert_allclose(got / 32768.0, data, atol=1e-4)
    with pytest.raises(IOError):
        native.wav_read(str(tmp_path / "missing.wav"))


def test_dataset_takes_the_native_path_when_built(lib, audio, tmp_path):
    """use_native None (the default) or True: the native reader and
    extractor; False: numpy. The two within ATOL."""
    path = tmp_path / "utt.wav"
    scipy.io.wavfile.write(path, 22050, (audio * 20000).astype(np.int16))
    fl = tmp_path / "list.txt"
    fl.write_text(f"{path}|a short text")
    cfg = Tacotron2Config()
    sets = {flag: tdata.TextMelDataset(str(fl), cfg, use_native=flag)
            for flag in (None, True, False)}
    assert sets[None]._native is not None and sets[True]._native is not None
    assert sets[False]._native is None
    mels = {flag: ds[0][1] for flag, ds in sets.items()}
    want = native.NativeMelExtractor(MelConfig.from_config(cfg)).extract(
        (audio * 20000).astype(np.int16).astype(np.float32)
        / cfg.max_wav_value)
    np.testing.assert_array_equal(mels[None], want)
    np.testing.assert_array_equal(mels[True], want)
    np.testing.assert_allclose(mels[True], mels[False], atol=ATOL)


def test_use_native_without_the_library_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "absent.so"))
    assert not native.available()
    fl = tmp_path / "list.txt"
    fl.write_text(f"{tmp_path / 'x.wav'}|text")
    with pytest.raises(RuntimeError, match="native/build.sh"):
        tdata.TextMelDataset(str(fl), Tacotron2Config(), use_native=True)
    assert tdata.TextMelDataset(str(fl), Tacotron2Config())._native is None
    with pytest.raises(RuntimeError, match="not built"):
        native.wav_read(str(fl))
