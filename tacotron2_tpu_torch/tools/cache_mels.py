"""Offline mel cache: a ``.npy`` log-mel beside each wav of a filelist (the
port's counterpart of ``tools/cache_mels.py``).

    python -m tacotron2_tpu_torch.tools.cache_mels filelist.txt
        [--out filelist_mels.txt] [--hparams k=v,...] [--workers 16]
        [--device [cuda|cpu]]

The reference's ``load_mel_from_disk`` workflow (data_utils.py:48-52): run
once, then train with ``load_mel_from_disk=true`` (or on the ``--out``
filelist, which names the ``.npy`` files) and ``TextMelDataset`` reads the
mels instead of extracting them. Each mel is ``(n_mels, frames)`` float32,
written to ``os.path.splitext(wav)[0] + ".npy"``; an existing ``.npy`` is
kept, and a wav at another sample rate than the config's raises.

On the card (the default) each utterance is one call of the fused mel
kernel (``audio/mel.mel_spectrogram_backend(..., "cuda")``, row 8): batching
utterances of unequal length would change their padded tail frames.
``--device cpu`` takes the JAX tool's default host path instead, the
numpy extraction (``data/dataset.mel_spectrogram_np``) on ``--workers``
threads. A bare ``--device``, the JAX tool's flag for its device path, is
the card.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from tacotron2_tpu_torch.audio.mel import MelConfig, mel_spectrogram_backend
from tacotron2_tpu_torch.config import Tacotron2Config, create_config
from tacotron2_tpu_torch.data.dataset import (_npy_path, load_filelist,
                                              load_wav, mel_spectrogram_np)


def cache_mels(entries: Sequence[List[str]], cfg: Tacotron2Config,
               device: Union[str, torch.device] = "cuda", workers: int = 16
               ) -> List[List[str]]:
    """Write each entry's mel next to its wav unless it is there already;
    the entries with their ``.npy`` paths in place of the wavs."""
    from tacotron2_tpu_torch.models.tacotron2 import resolve_device
    device = resolve_device(device)
    mel_cfg = MelConfig.from_config(cfg)

    def extract(audio: np.ndarray) -> np.ndarray:
        if device.type == "cpu":
            return mel_spectrogram_np(audio, mel_cfg)
        y = torch.from_numpy(audio.astype(np.float32))[None].to(device)
        return mel_spectrogram_backend(y, mel_cfg, "cuda")[0].cpu().numpy()

    def process(entry: List[str]) -> List[str]:
        npy_path = _npy_path(entry[0])
        if not os.path.exists(npy_path):
            audio, sr = load_wav(entry[0])
            if sr != cfg.sampling_rate:
                raise ValueError(f"{entry[0]}: sr {sr}")
            np.save(npy_path, extract(audio / cfg.max_wav_value))
        return [npy_path] + list(entry[1:])

    with ThreadPoolExecutor(workers if device.type == "cpu" else 1) as pool:
        return list(pool.map(process, entries))


def main(argv: Optional[Sequence[str]] = None) -> List[List[str]]:
    argv = list(sys.argv[1:] if argv is None else argv)
    for i, arg in enumerate(argv):  # the JAX tool's bare flag: the card
        if arg == "--device" and (i + 1 == len(argv) or not (
                argv[i + 1] == "cpu" or argv[i + 1].startswith("cuda"))):
            argv.insert(i + 1, "cuda")
    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.tools.cache_mels")
    parser.add_argument("filelist")
    parser.add_argument("--out", default=None,
                        help="write a filelist pointing at the cached .npy")
    parser.add_argument("--hparams", default=None)
    parser.add_argument("--workers", type=int, default=16,
                        help="extraction threads of the host path")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: the mel kernel) or cpu "
                             "(numpy)")
    args = parser.parse_args(argv)

    cfg = create_config(args.hparams)
    entries = cache_mels(load_filelist(args.filelist), cfg, args.device,
                         args.workers)
    if args.out:
        with open(args.out, "w") as f:
            for entry in entries:
                f.write("|".join(entry) + "\n")
    print(f"cached {len(entries)} mels")
    return entries


if __name__ == "__main__":
    main()
