"""Model-health diagnostics (the JAX package's
``training/diagnostics.py``).

Quantifies what the reference leaves to eyeballing TensorBoard images
(the "clean diagonal alignment" check, SURVEY §4): scalar alignment
metrics loggable per validation, plus gate-accuracy. All numpy, run on
host over one validation batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def alignment_diagnostics(alignments: np.ndarray,
                          text_lengths: np.ndarray,
                          mel_lengths: np.ndarray) -> Dict[str, float]:
    """alignments: (B, T_out, T_in) attention weights.

    - sharpness: mean max attention weight per decoder step (1.0 = hard);
    - monotonicity: fraction of steps whose argmax does not move backwards;
    - coverage: fraction of encoder positions receiving argmax at least
      once (skipped text reads as low coverage);
    - diagonality: mean |argmax_path - ideal_diagonal| / T_in (0 = perfect).
    """
    B = alignments.shape[0]
    sharp, mono, cover, diag = [], [], [], []
    for b in range(B):
        L_in = int(text_lengths[b])
        L_out = int(mel_lengths[b])
        a = alignments[b, :L_out, :L_in]
        if a.size == 0:
            continue
        path = a.argmax(axis=1)
        sharp.append(float(a.max(axis=1).mean()))
        if len(path) > 1:
            mono.append(float(np.mean(np.diff(path) >= 0)))
        cover.append(len(np.unique(path)) / L_in)
        ideal = np.linspace(0, L_in - 1, L_out)
        diag.append(float(np.mean(np.abs(path - ideal)) / max(L_in, 1)))
    return {
        "alignment/sharpness": float(np.mean(sharp)) if sharp else 0.0,
        "alignment/monotonicity": float(np.mean(mono)) if mono else 0.0,
        "alignment/coverage": float(np.mean(cover)) if cover else 0.0,
        "alignment/diagonal_deviation": float(np.mean(diag)) if diag else 1.0,
    }


def gate_accuracy(gate_energies: np.ndarray, gate_targets: np.ndarray,
                  mel_lengths: np.ndarray,
                  threshold: float = 0.5) -> Dict[str, float]:
    """Binary accuracy of the stop token over valid frames."""
    correct, total = 0, 0
    for b in range(gate_energies.shape[0]):
        L = int(mel_lengths[b])
        pred = 1.0 / (1.0 + np.exp(-gate_energies[b, :L].astype(np.float64)))
        correct += int(((pred > threshold) ==
                        (gate_targets[b, :L] > 0.5)).sum())
        total += L
    return {"gate/accuracy": correct / max(total, 1)}
