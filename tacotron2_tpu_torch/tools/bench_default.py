"""Training throughput of the stock config on the card (the port's
counterpart of ``tools/bench_default.py``).

    python -m tacotron2_tpu_torch.tools.bench_default [--device cuda|cpu]

What ``python -m tacotron2_tpu_torch.train`` with the stock config steps
at: B=64, bf16, the config's defaults, no bench knobs. The headline shape
(T_in 128, T_out 512) and the LJSpeech blend over the three text buckets,
measured as ``bench_buckets`` measures them. Prints a line per shape, then
one JSON line with the JAX script's keys: ``default_headline_frames_per_s``,
``default_blended_frames_per_s`` and ``rows``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Union

import torch

from tacotron2_tpu_torch.config import Tacotron2Config, parse_overrides
from tacotron2_tpu_torch.tools.bench_buckets import SHARES, blend, bucket_rows


def run(steps: int = 10, device: Union[str, torch.device] = "cuda",
        hparams: Optional[str] = None) -> dict:
    """Measure the stock config's buckets and print the JSON line; returns
    it."""
    from tacotron2_tpu_torch.models.tacotron2 import resolve_device
    cfg = Tacotron2Config()  # the stock config, no overrides
    cfg = parse_overrides(cfg, hparams) if hparams else cfg
    B = cfg.batch_size
    rows = bucket_rows(cfg, B, steps, resolve_device(device))
    line = {"default_headline_frames_per_s": rows[128]["frames_per_s"],
            "default_blended_frames_per_s": round(blend(rows, SHARES, B)),
            "rows": rows}
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.tools.bench_default")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
