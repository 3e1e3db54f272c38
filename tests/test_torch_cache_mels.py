"""The port's mel cache (``python -m tacotron2_tpu_torch.tools.cache_mels``)
on the CPU: with ``--device cpu`` it writes the ``.npy`` mels that the JAX
package's ``tools/cache_mels.py`` writes, bit for bit (run in a subprocess
on a copy of the same wavs), keeps an existing ``.npy``, refuses a wav at another rate,
and its ``--out`` filelist loads through the port's ``TextMelDataset``. The
card path (row 8) is held by ``chip_smoke.py``."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile

from tacotron2_tpu_torch.config import create_config
from tacotron2_tpu_torch.data import TextMelDataset
from tacotron2_tpu_torch.tools import cache_mels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["a tone", "another tone of a different length", "hi"]


def write_tones(root, rate=22050):
    """Three tone wavs of different lengths and a filelist of them."""
    root.mkdir()
    lines = []
    for i, text in enumerate(TEXTS):
        t = np.arange(int(rate * (0.3 + 0.25 * i))) / rate
        wav = 0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t)
        path = root / f"tone{i}.wav"
        scipy.io.wavfile.write(path, rate, (wav * 32767).astype(np.int16))
        lines.append(f"{path}|{text}")
    filelist = root / "list.txt"
    filelist.write_text("\n".join(lines) + "\n")
    return filelist


@pytest.fixture(scope="module")
def cached(tmp_path_factory):
    """The same wavs cached by the JAX tool and by the port, in two
    directories."""
    root = tmp_path_factory.mktemp("cache_mels")
    mine = write_tones(root / "port")
    jax_dir = root / "jax"
    jax_dir.mkdir()
    lines = []
    for line in mine.read_text().splitlines():
        path, text = line.split("|")
        shutil.copy(path, jax_dir / os.path.basename(path))
        lines.append(f"{jax_dir / os.path.basename(path)}|{text}")
    (jax_dir / "list.txt").write_text("\n".join(lines) + "\n")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "cache_mels.py"),
         str(jax_dir / "list.txt"), "--out", str(jax_dir / "mels.txt")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    entries = cache_mels.main([str(mine), "--device", "cpu", "--out",
                               str(root / "port" / "mels.txt")])
    return root, entries


def test_cpu_mels_equal_the_jax_tools(cached):
    root, entries = cached
    assert len(entries) == len(TEXTS)
    for i in range(len(TEXTS)):
        got = np.load(root / "port" / f"tone{i}.npy")
        want = np.load(root / "jax" / f"tone{i}.npy")
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and got.shape[0] == 80
        np.testing.assert_array_equal(got, want)


def test_out_filelist_loads_through_the_dataset(cached):
    """The ``--out`` filelist names the .npy files in the JAX tool's
    format; ``TextMelDataset`` reads them back, texts included."""
    root, entries = cached
    port_lines = (root / "port" / "mels.txt").read_text().splitlines()
    jax_lines = (root / "jax" / "mels.txt").read_text().splitlines()
    assert [l.split("|")[1] for l in port_lines] == [
        l.split("|")[1] for l in jax_lines] == TEXTS
    assert port_lines == ["|".join(e) for e in entries]
    cfg = create_config("load_mel_from_disk=true")
    ds = TextMelDataset(str(root / "port" / "mels.txt"), cfg, shuffle=False)
    for i, entry in enumerate(ds.entries):
        text, mel = ds[i]
        assert entry[0].endswith(f"tone{i}.npy")
        np.testing.assert_array_equal(mel, np.load(entry[0]))
        np.testing.assert_array_equal(text, ds.get_text(TEXTS[i]))


def test_existing_npy_is_kept(tmp_path):
    filelist = write_tones(tmp_path / "keep")
    kept = np.full((80, 3), 7.0, np.float32)
    np.save(tmp_path / "keep" / "tone1.npy", kept)
    cache_mels.main([str(filelist), "--device", "cpu", "--workers", "2"])
    np.testing.assert_array_equal(np.load(tmp_path / "keep" / "tone1.npy"),
                                  kept)
    assert np.load(tmp_path / "keep" / "tone0.npy").shape[0] == 80


def test_wrong_sample_rate_raises(tmp_path):
    filelist = write_tones(tmp_path / "rate", rate=16000)
    with pytest.raises(ValueError, match="sr 16000"):
        cache_mels.main([str(filelist), "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--device"], ["--device", "cuda"], []])
def test_card_path_is_the_default_and_the_jax_flag(tmp_path, monkeypatch,
                                                   flags):
    """A bare ``--device`` (the JAX tool's flag), ``--device cuda`` and no
    flag all take the card, and without one raise rather than fall back to
    the CPU."""
    filelist = write_tones(tmp_path / "card")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cache_mels.main([*flags, str(filelist)] if flags == ["--device"]
                        else [str(filelist), *flags])
    assert not list((tmp_path / "card").glob("*.npy"))
