"""Blended-bucket training throughput on the card (the port's counterpart
of ``tools/bench_buckets.py``).

    python -m tacotron2_tpu_torch.tools.bench_buckets [--device cuda|cpu]

One training-step shape per text bucket, T_out = 4 T_in: (64, 256),
(128, 512) and (192, 768) at B=128, each timed as ``bench.py`` times its
step (``bench.time_steps``: one warm step, then ``steps`` (10) timed),
then blended by LJSpeech's text-length shares (17.1% up to 64 characters,
60.2% up to 128, 22.8% up to 192: the JAX script's, from the reference's
train filelist) as frames over time (``blend``). Prints a line per shape,
then one JSON line with the JAX script's keys: ``blended_frames_per_s``
and ``rows``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from tacotron2_tpu_torch.config import Tacotron2Config, parse_overrides

SHAPES: Tuple[Tuple[int, int], ...] = ((64, 256), (128, 512), (192, 768))
SHARES = {64: 0.171, 128: 0.602, 192: 0.228}  # LJSpeech text lengths


def blend(rows: Dict[int, dict], shares: Dict[int, float], B: int) -> float:
    """Mel frames/s over the buckets' mix: the shares' frames over the
    shares' step time (each row's ``t_out`` and ``ms_per_step``)."""
    frames = sum(p * B * rows[t]["t_out"] for t, p in shares.items())
    seconds = sum(p * rows[t]["ms_per_step"] / 1e3 for t, p in shares.items())
    return frames / seconds


def bucket_rows(cfg: Tacotron2Config, B: int, steps: int,
                device: Union[str, torch.device],
                shapes: Sequence[Tuple[int, int]] = SHAPES
                ) -> Dict[int, dict]:
    """``{T_in: {"t_out", "ms_per_step", "frames_per_s"}}``, one training
    step shape at a time, printed as it is measured."""
    from tacotron2_tpu_torch.bench import time_steps, train_stepper
    rows = {}
    for t_in, t_out in shapes:
        run = train_stepper(cfg, B, t_in, t_out, device)
        dt = time_steps(run, steps, device)
        del run
        rows[t_in] = {"t_out": t_out, "ms_per_step": round(dt * 1e3, 1),
                      "frames_per_s": round(B * t_out / dt)}
        print(t_in, rows[t_in], flush=True)
    return rows


def run(steps: int = 10, device: Union[str, torch.device] = "cuda",
        hparams: Optional[str] = None) -> dict:
    """Measure the buckets at B=128 and print the JSON line; returns it."""
    from tacotron2_tpu_torch.models.tacotron2 import resolve_device
    cfg = Tacotron2Config(batch_size=128, decoder_scan_unroll=8,
                          prng_impl="unsafe_rbg")
    cfg = parse_overrides(cfg, hparams) if hparams else cfg
    B = 128
    rows = bucket_rows(cfg, B, steps, resolve_device(device))
    line = {"blended_frames_per_s": round(blend(rows, SHARES, B)),
            "rows": rows}
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.tools.bench_buckets")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
