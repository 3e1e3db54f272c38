"""End-to-end training on a synthetic tone corpus, on the port.

    python -m tacotron2_tpu_torch.tools.train_demo [--steps 300] \
        [--outdir build/demo_run] [--batch 32] [--hparams k=v,...] \
        [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/train_demo.py``, at its
config (B=32, text buckets 32 and 48, mel bucket step 128,
``max_mel_length`` 512, lr 1e-3, bf16). No speech corpus is needed: each
character maps to a fixed tone and an utterance is its characters' tones
in a row (``build_corpus``, the same bytes as the JAX demo's), so a
working text-to-mel model must learn a clean monotonic alignment. Runs the
whole training path: filelist, dataset, bucketing, prefetch and the copy
to the card, ``Trainer.fit``, checkpoints every 500 steps, metric logging.
When ``outdir`` already holds checkpoints the run resumes from the latest,
so a run cut short continues where it stopped.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import scipy.io.wavfile
import torch

from tacotron2_tpu_torch.config import Tacotron2Config, parse_overrides

CHECKPOINT_EVERY = 500


SAMPLING_RATE = 22050
TONE_SAMPLES = int(0.08 * SAMPLING_RATE)  # one character's tone


def tone_audio(text: str) -> np.ndarray:
    """The corpus's int16 audio for ``text``: each character's tone
    (200 + 40 * (ord(ch) % 32) Hz, Hann-windowed), one after another."""
    samples = []
    for ch in text:
        freq = 200.0 + 40.0 * (ord(ch) % 32)
        t = np.arange(TONE_SAMPLES) / SAMPLING_RATE
        tone = np.sin(2 * np.pi * freq * t) * 0.4
        tone *= np.hanning(TONE_SAMPLES)  # avoid clicks
        samples.append(tone)
    return (np.concatenate(samples) * 32767 * 0.5).astype(np.int16)


def build_corpus(root: str, n_utts: int = 128, seed: int = 0,
                 words: Tuple[int, int] = (3, 7)) -> str:
    """Write wavs + filelist: ``n_utts`` utterances of ``words[0]`` to
    ``words[1] - 1`` words drawn from ``seed`` (by default 3 to 6, the JAX
    demo's bytes; (12, 22) gives 5-10 s utterances, LJSpeech's lengths)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    vocab = ["we", "like", "fast", "chips", "sound", "model", "text",
             "train", "mel", "jax"]
    lines = []
    for i in range(n_utts):
        text = " ".join(rng.choice(vocab, rng.randint(*words)))
        path = os.path.join(root, f"utt{i:04d}.wav")
        scipy.io.wavfile.write(path, SAMPLING_RATE, tone_audio(text))
        lines.append(f"{path}|{text}")
    filelist = os.path.join(root, "train.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(lines))
    return filelist


def demo_config(batch: int = 32, hparams: Optional[str] = None
                ) -> Tacotron2Config:
    """The JAX demo's config (tools/train_demo.py:81-85), overrides on top."""
    cfg = Tacotron2Config(
        batch_size=batch, compute_dtype="bfloat16",
        iters_per_checkpoint=CHECKPOINT_EVERY, text_buckets=(32, 48),
        mel_bucket_step=128, max_mel_length=512, learning_rate=1e-3)
    return parse_overrides(cfg, hparams) if hparams else cfg


def run(steps: int, outdir: str, batch: int = 32,
        hparams: Optional[str] = None, device: str = "cuda",
        n_utts: int = 128, words: Tuple[int, int] = (3, 7)) -> dict:
    """Train on the tone corpus until the state's step reaches ``steps``;
    returns (and writes to ``outdir/summary.json``) the summary. The losses
    are the steps run by this call (a resumed run's later part)."""
    from tacotron2_tpu_torch.data import DataPipeline, TextMelDataset
    from tacotron2_tpu_torch.training.diagnostics import alignment_diagnostics
    from tacotron2_tpu_torch.training.state import Batch, eval_step
    from tacotron2_tpu_torch.training.trainer import Trainer

    cfg = demo_config(batch, hparams)
    filelist = build_corpus(os.path.join(outdir, "corpus"), n_utts=n_utts,
                            words=words)
    dataset = TextMelDataset(filelist, cfg)
    pipe = DataPipeline(dataset, cfg, process_index=0, process_count=1)
    trainer = Trainer(cfg, outdir, device=device)
    start = int(trainer.state.step)
    losses = []
    t_start = time.time()
    trainer.fit(pipe, None, epochs=1 << 30, max_steps=steps,
                on_step=lambda step, m: losses.append(m.loss))
    wall = time.time() - t_start
    losses = torch.stack(losses).float().cpu().numpy() if losses else \
        np.zeros(0, np.float32)
    timing = trainer.last_fit
    summary = {
        "steps": int(trainer.state.step), "resumed_from": start,
        "batch": batch, "hparams": hparams,
        "shapes": sorted([t_in, t_out] for kind, t_in, t_out
                         in trainer.shapes_met if kind == "train"),
        "first_loss": float(losses[0]) if len(losses) else None,
        "loss_at_10pct": (float(np.mean(losses[:max(len(losses) // 10, 1)]))
                          if len(losses) else None),
        "final_loss": float(np.mean(losses[-10:])) if len(losses) else None,
        "wall_s": wall,
        "median_step_ms": (float(np.median(timing.step_intervals_s)) * 1e3
                           if timing.step_intervals_s else None),
        "prefetch_wait_s": timing.prefetch_wait_s,
        "steps_per_epoch": pipe.steps_per_epoch(),
        # the first epoch's items are extracted, later epochs' are kept
        "prefetch_wait_by_epoch_s": _by_epoch(
            timing.step_waits_s, start, pipe.steps_per_epoch()),
    }
    # alignment health from a validation-style forward on the first batch
    first = next(iter(pipe.epoch(0)))
    first = Batch(*(None if t is None else t.to(trainer.device)
                    for t in first))
    _, output = eval_step(trainer.state, first, cfg)
    align = output.alignments.float().cpu().numpy()
    np.save(os.path.join(outdir, "alignment.npy"), align[0])
    summary["alignment"] = alignment_diagnostics(
        align, first.text_lengths.cpu().numpy(),
        first.mel_lengths.cpu().numpy())
    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


def _by_epoch(waits, start: int, steps_per_epoch: int) -> list:
    """Sums of per-step waits by the epoch each step belongs to."""
    out = {}
    for i, w in enumerate(waits):
        epoch = (start + i) // steps_per_epoch
        out[epoch] = out.get(epoch, 0.0) + w
    return [out[e] for e in sorted(out)]


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--outdir", default="build/demo_run")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--n-utts", type=int, default=128)
    parser.add_argument("--words", default="3,7",
                        help="words per utterance, LO,HI (HI excluded)")
    parser.add_argument("--hparams", default=None,
                        help="extra config overrides, e.g. seed=777")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(args.steps, args.outdir, batch=args.batch, hparams=args.hparams,
        device=args.device, n_utts=args.n_utts,
        words=tuple(int(w) for w in args.words.split(",")))


if __name__ == "__main__":
    main()
