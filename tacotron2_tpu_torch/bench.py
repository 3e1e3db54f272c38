"""Headline benchmark of the port: teacher-forced training throughput on
one card (the counterpart of the repository's root ``bench.py``).

    python -m tacotron2_tpu_torch.bench [--device cuda|cpu]
        [--hparams k=v,...]
    torchrun --nproc_per_node=W -m tacotron2_tpu_torch.bench

Prints ONE JSON line:
  {"metric": "train_mel_frames_per_s_per_chip", "value": N,
   "unit": "mel-frames/s/chip", "vs_baseline": R}

``vs_baseline`` is the real-time factor: mel frames/s over
``sampling_rate / hop_length`` (86.13 at the reference's 22050 Hz and hop
256), the seconds of speech the trainer consumes per wall-clock second per
card.

The step is ``training/state.py:train_step``'s (rows 1-4, the cuBLAS dW
products, ``guarded_update``) through ``parallel.make_train_step``, which
computes it bit for bit in one process, at ``bench.py``'s shape: B=128,
T_in=128, T_out=512, bf16, dropout on (from a torch generator), on
``make_batch``'s synthetic batch. The protocol is ``bench.py``'s: one warm
step, then ``STEPS`` (10) timed steps and one synchronise after the last
(``time_steps``). Under torchrun the W ranks take a ``(W, 1)`` mesh and the
global batch of 128, and the value is divided by W. It runs on the card
unless ``--device cpu`` is given; ``--hparams`` overrides the config (the
tests' small widths).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Sequence, Union

import torch

from tacotron2_tpu_torch.config import Tacotron2Config, parse_overrides

T_IN, T_OUT = 128, 512  # bench.py:57
STEPS = 10  # timed steps after the warm one, as bench.py times them


def time_steps(step: Callable[[], object], n: int,
               device: Union[str, torch.device], warm: int = 1) -> float:
    """Seconds per call of ``step`` over ``n`` calls after ``warm`` warm
    ones: host clock from the first timed call to a synchronise after the
    last (the device runs ahead of the host in between, as a training loop
    lets it)."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    for _ in range(warm):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    sync()
    return (time.perf_counter() - t0) / n


def bench_config(hparams: Optional[str] = None) -> Tacotron2Config:
    """bench.py's config: bf16, B=128, and the JAX knobs it sets, which the
    port accepts and ignores (``config.IGNORED_KNOBS``)."""
    cfg = Tacotron2Config(compute_dtype="bfloat16", batch_size=128,
                          decoder_scan_unroll=8, prng_impl="unsafe_rbg",
                          custom_vjp_decoder=True, pallas_train_scan=True,
                          pallas_train_scan_bwd=True)
    return parse_overrides(cfg, hparams) if hparams else cfg


def train_stepper(cfg: Tacotron2Config, B: int, T_in: int, T_out: int,
                  device: Union[str, torch.device], mesh=None, seed: int = 0
                  ) -> Callable[[], object]:
    """A closure that runs one training step at ``(B, T_in, T_out)`` on a
    state from ``seed`` (``parallel.make_train_step`` on ``mesh``, one
    process by default; B the global batch), dropout drawn from one
    generator on the device, each call on the state the last one left."""
    from tacotron2_tpu_torch.parallel import (create_mesh, make_train_step,
                                              replicate_state, shard_batch)
    from tacotron2_tpu_torch.training.state import (create_train_state,
                                                    make_batch)
    mesh = mesh if mesh is not None else create_mesh()
    state = replicate_state(create_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device=device),
        mesh)
    device = next(state.model.parameters()).device
    batch = shard_batch(make_batch(cfg, B, T_in, T_out, seed=seed,
                                   device=device), mesh)
    step = make_train_step(cfg, mesh)
    gen = torch.Generator(device=device).manual_seed(1)
    box = [state]

    def run():
        box[0], metrics = step(box[0], batch, [gen])
        return metrics

    return run


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from tacotron2_tpu_torch.models.tacotron2 import resolve_device
    from tacotron2_tpu_torch.parallel import (create_mesh,
                                              initialize_distributed,
                                              local_device)
    parser = argparse.ArgumentParser(prog="python -m tacotron2_tpu_torch.bench")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--hparams", default=None,
                        help="config overrides, k=v,k=v")
    args = parser.parse_args(argv)

    cfg = bench_config(args.hparams)
    device = local_device(args.device)  # cuda:LOCAL_RANK under torchrun
    initialize_distributed(device=device)
    device = resolve_device(device)
    mesh = create_mesh()  # (W, 1) over torchrun's W ranks, or one process
    try:
        run = train_stepper(cfg, cfg.batch_size, T_IN, T_OUT, device, mesh)
        dt = time_steps(run, STEPS, device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    frames_per_s = cfg.batch_size * T_OUT / dt / mesh.dp
    frames_per_audio_s = cfg.sampling_rate / cfg.hop_length  # 86.13
    line = {
        "metric": "train_mel_frames_per_s_per_chip",
        "value": round(frames_per_s, 2),
        "unit": "mel-frames/s/chip",
        "vs_baseline": round(frames_per_s / frames_per_audio_s, 2),
    }
    if mesh.rank == 0:
        print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
