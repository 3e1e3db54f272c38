"""End-to-end synthesis quality gate for tone-corpus checkpoints, on the port.

Synthesizes a prompt with a model trained on the tone corpus
(``tools/train_demo.py``: each character is a fixed 0.08 s tone) and checks
the mel's dominant frequency in each character's segment against the
character's tone. Each checkpoint is checked through both decoders: the
step-by-step one (``synthesize(fused=False)``, the JAX gate's call) and the
single-utterance decoder kernel (``fused=True``). A run passes only when
both score every character. Per-step parity tests cannot see a fault that
drifts training over thousands of steps; this gate can.

Usage:
  python -m tacotron2_tpu_torch.tools.synthesis_check CHECKPOINT_DIR
      check an existing tone-corpus checkpoint directory;
  python -m tacotron2_tpu_torch.tools.synthesis_check --train \
      [--steps 2500] [--seeds 1234,777] [--batch 32] [--hparams ...] \
      [--known-bad]
      train from scratch once per seed, check each run, and merge the
      results into QUALITY_GATE_TORCH.json (``--out``). ``--known-bad``
      trains with the training scan built with -DSCAN_DPROC_BF16
      (kernels/gate_probe.py) in this process only: the gate must fail it.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from tacotron2_tpu_torch.audio import filters
from tacotron2_tpu_torch.tools import train_demo

REPO = Path(__file__).resolve().parents[2]


def tone_hz(ch: str) -> float:
    """The corpus's tone for character ``ch`` (train_demo.tone_audio)."""
    return 200.0 + 40.0 * (ord(ch) % 32)


def score_mel(mel: np.ndarray, text: str, cfg, tolerance_hz: float,
              verbose: bool = False) -> Dict[str, int]:
    """Score a (frames, n_mels) log-mel against ``text``'s tones: the
    median over each character's frames of the dominant mel channel's
    centre frequency must lie within ``tolerance_hz`` of the tone.
    Characters whose segment runs past the mel's end are not counted."""
    mel_w = filters.mel_filterbank(cfg.sampling_rate, cfg.filter_length,
                                   cfg.n_mel_channels, cfg.mel_fmin,
                                   cfg.mel_fmax)
    bin_freqs = np.linspace(0, cfg.sampling_rate / 2,
                            cfg.filter_length // 2 + 1)
    mel_center = ((mel_w * bin_freqs[None, :]).sum(1)
                  / np.maximum(mel_w.sum(1), 1e-9))
    dominant = mel_center[np.asarray(mel).argmax(axis=1)]
    frames_per_char = train_demo.TONE_SAMPLES / cfg.hop_length
    hits = total = 0
    for i, ch in enumerate(text):
        lo, hi = int(i * frames_per_char), int((i + 1) * frames_per_char)
        if hi > len(dominant):
            break
        got = float(np.median(dominant[lo:hi]))
        ok = abs(got - tone_hz(ch)) < tolerance_hz
        hits += ok
        total += 1
        if verbose:
            print(f"char {ch!r}: expected {tone_hz(ch):6.0f} Hz got "
                  f"{got:6.0f} Hz {'OK' if ok else 'MISS'}")
    return {"chars_matched": hits, "total": total, "frames": len(dominant)}


def check_checkpoint(checkpoint_dir: str, text: str = "we like jax",
                     tolerance_hz: float = 60.0,
                     hparams: Optional[str] = None,
                     device: str = "cuda") -> dict:
    """Restore the latest checkpoint of ``checkpoint_dir`` (the demo's
    config, ``hparams`` on top), synthesize ``text`` with the prenet's
    inference dropout off through both decoders, and score each."""
    from tacotron2_tpu_torch.infer import synthesize
    from tacotron2_tpu_torch.training.checkpoint import Checkpointer
    from tacotron2_tpu_torch.training.state import create_train_state

    cfg = train_demo.demo_config(hparams=hparams)
    state = Checkpointer(checkpoint_dir).restore(
        create_train_state(cfg, device=device))
    print(f"restored step {int(state.step)}", flush=True)
    cfg = cfg.replace(prenet_dropout_at_inference=False)
    out = {"step": int(state.step)}
    for name, fused in (("step_by_step", False), ("fused", True)):
        [res] = synthesize(state.model, [text], cfg, vocoder="none",
                           fused=fused, device=device)
        print(f"{name} decoder:")
        out[name] = score_mel(res.mel, text, cfg, tolerance_hz, verbose=True)
    out["pass"] = all(out[k]["total"] == len(text)
                      and out[k]["chars_matched"] == len(text)
                      for k in ("step_by_step", "fused"))
    print(json.dumps(out), flush=True)
    return out


def _card() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return {"card": "unknown", "power_limit": "unknown"}
    name, _, limit = line.rpartition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                              text=True, cwd=REPO).stdout.strip() or \
            "not a git checkout"
    except OSError:
        return "not a git checkout"


def source_sha256() -> str:
    """sha256 over the port's Python and CUDA sources, in path order: names
    the code a run used where the checkout has no git history."""
    h = hashlib.sha256()
    pkg = REPO / "tacotron2_tpu_torch"
    for f in sorted(p for p in pkg.rglob("*")
                    if p.suffix in (".py", ".cu", ".cuh")):
        h.update(str(f.relative_to(REPO)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def run_label(seed: int, steps: int, batch: int, hparams: Optional[str],
              known_bad: bool) -> str:
    parts = ["known_bad"] if known_bad else []
    if batch != 32:
        parts.append(f"b{batch}")
    if hparams:  # long override strings by their hash: a directory name
        hp = hparams.replace(",", "_").replace("=", "-")
        parts.append(hp if len(hp) <= 48 else
                     "hp-" + hashlib.sha256(hparams.encode()).hexdigest()[:10])
    return "_".join(parts + [f"{steps}steps", f"seed{seed}"])


def run_gate(steps: int, seeds: Sequence[int], text: str,
             tolerance_hz: float, out_path: str, workdir: str,
             batch: int = 32, hparams: Optional[str] = None,
             known_bad: bool = False, n_utts: int = 128,
             device: str = "cuda") -> dict:
    """Train on the tone corpus once per seed (resuming a run directory
    that holds checkpoints), check each run, and merge the results into
    ``out_path`` by run label. The file's ``pass`` covers the shipped
    build's runs at the gate's config (B=32, no overrides)."""
    if known_bad:
        from tacotron2_tpu_torch.kernels import gate_probe
        print(f"known-bad build: {gate_probe.install()}", flush=True)
    gate = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            gate = json.load(f)
    runs = gate.setdefault("runs", {})
    for seed in seeds:
        label = run_label(seed, steps, batch, hparams, known_bad)
        outdir = os.path.join(workdir, label)
        print(f"=== quality gate: {label}, {steps} steps ===", flush=True)
        extra = f"seed={seed}" + (f",{hparams}" if hparams else "")
        summary = train_demo.run(steps, outdir, batch=batch, hparams=extra,
                                 device=device, n_utts=n_utts)
        res = check_checkpoint(outdir, text, tolerance_hz, hparams=extra,
                               device=device)
        runs[label] = {
            "date": datetime.date.today().isoformat(), "commit": _commit(),
            "source_sha256": source_sha256(),
            **_card(), "steps": summary["steps"], "batch": batch,
            "hparams": extra, "n_utts": n_utts, "known_bad": known_bad,
            "step_by_step": res["step_by_step"], "fused": res["fused"],
            "final_loss": summary["final_loss"], "wall_s": summary["wall_s"],
            "median_step_ms": summary["median_step_ms"],
            "prefetch_wait_s": summary["prefetch_wait_s"],
            "resumed_from": summary["resumed_from"],
            "shapes": summary["shapes"], "alignment": summary["alignment"],
            "pass": res["pass"],
        }
    shipped = [r for r in runs.values() if not r["known_bad"]
               and r["batch"] == 32 and r["hparams"].startswith("seed=")
               and "," not in r["hparams"]]
    gate.update({
        "text": text, "tolerance_hz": tolerance_hz,
        "note": ("tone-corpus gate on the port: pass = every character of "
                 "the text scored through both the step-by-step decoder "
                 "and the fused single-utterance kernel, in every shipped "
                 "run at B=32 (known-bad and other shapes recorded beside "
                 "them, outside the verdict)"),
        "pass": bool(shipped) and all(r["pass"] for r in shipped),
    })
    with open(out_path, "w") as f:
        json.dump(gate, f, indent=1)
    print(json.dumps({"quality_gate": gate["pass"], "artifact": out_path,
                      "runs": {k: runs[k]["pass"] for k in runs}}),
          flush=True)
    return gate


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint_dir", nargs="?")
    parser.add_argument("--text", default="we like jax")
    parser.add_argument("--hparams", default=None)
    parser.add_argument("--tolerance-hz", type=float, default=60.0)
    parser.add_argument("--train", action="store_true",
                        help="train per seed, check, merge into --out")
    parser.add_argument("--steps", type=int, default=2500)
    parser.add_argument("--seeds", default="1234,777")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--n-utts", type=int, default=128)
    parser.add_argument("--known-bad", action="store_true",
                        help="train with the -DSCAN_DPROC_BF16 build")
    parser.add_argument("--out", default=str(REPO / "QUALITY_GATE_TORCH.json"))
    parser.add_argument("--workdir", default=str(REPO / "build" /
                                                 "quality_gate"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    if args.train:
        seeds = [int(s) for s in args.seeds.split(",") if s]
        gate = run_gate(args.steps, seeds, args.text, args.tolerance_hz,
                        args.out, args.workdir, batch=args.batch,
                        hparams=args.hparams, known_bad=args.known_bad,
                        n_utts=args.n_utts, device=args.device)
        labels = [run_label(s, args.steps, args.batch, args.hparams,
                            args.known_bad)
                  for s in seeds]
        sys.exit(0 if all(gate["runs"][k]["pass"] for k in labels) else 1)
    if not args.checkpoint_dir:
        parser.error("checkpoint_dir required unless --train")
    check_checkpoint(args.checkpoint_dir, args.text, args.tolerance_hz,
                     args.hparams, device=args.device)


if __name__ == "__main__":
    main()
