"""Observability: TensorBoard metrics + model-health image artifacts.

The port's copy of the JAX package's ``training/logging.py``, the
reference's ``Tacotron2Logger``/plotting_utils (reference logger.py,
plotting_utils.py): per-step scalars
(loss/grad-norm/lr/step-time), validation scalars + parameter histograms,
and the three model-health images — alignment matrix, predicted-vs-target
mel, gate scatter — that serve as the de-facto "model works" check
(SURVEY §4). Also logs TPU-first throughput: mel-frames/s and
audio-seconds/s. Writes happen only on process 0. TensorBoard and
matplotlib are imported when first used; without them the JSONL mirror
still works.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor (any device or dtype) or array as a host float array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu()
    return np.asarray(x)


def _make_figure(draw):
    """Render a matplotlib figure to an HWC uint8 array."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 4))
    draw(fig, ax)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return img


def plot_alignment(alignment: np.ndarray):
    """(T_out, T_in) attention matrix — a clean diagonal means the model
    is aligning (reference plotting_utils.py:14-29)."""
    def draw(fig, ax):
        im = ax.imshow(alignment.T, aspect="auto", origin="lower",
                       interpolation="none")
        ax.set_xlabel("decoder step")
        ax.set_ylabel("encoder step")
        fig.colorbar(im, ax=ax)
    return _make_figure(draw)


def plot_mel(mel: np.ndarray, title: str = ""):
    """(T, n_mels) log-mel."""
    def draw(fig, ax):
        im = ax.imshow(mel.T, aspect="auto", origin="lower",
                       interpolation="none")
        ax.set_xlabel("frames")
        ax.set_ylabel("mel channel")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    return _make_figure(draw)


def plot_gate(gate_target: np.ndarray, gate_pred_sigmoid: np.ndarray):
    """(T,) target vs predicted gate (reference plotting_utils.py:46-61)."""
    def draw(fig, ax):
        t = np.arange(len(gate_target))
        ax.scatter(t, gate_target, alpha=0.5, color="green", marker=".",
                   s=8, label="target")
        ax.scatter(t, gate_pred_sigmoid, alpha=0.5, color="red", marker=".",
                   s=8, label="predicted")
        ax.set_xlabel("frames")
        ax.set_ylabel("gate")
        ax.legend()
    return _make_figure(draw)


class MetricLogger:
    """TensorBoard writer + JSONL mirror (greppable without TB)."""

    def __init__(self, log_dir: str, enabled: Optional[bool] = None):
        if enabled is None:
            from tacotron2_tpu_torch.data.pipeline import (
                process_index_and_count)
            enabled = process_index_and_count()[0] == 0
        self.enabled = enabled
        self.writer = None
        self.jsonl = None
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir)
            except ImportError:  # no tensorboard: the JSONL mirror only
                self.writer = None
            self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_training(self, step: int, loss: float, grad_norm: float,
                     learning_rate: float, duration: float,
                     mel_frames: Optional[int] = None,
                     frames_per_audio_sec: float = 86.13) -> None:
        if not self.enabled:
            return
        scalars = {"training/loss": loss, "training/grad_norm": grad_norm,
                   "training/learning_rate": learning_rate,
                   "training/duration_s": duration}
        if mel_frames is not None and duration > 0:
            fps = mel_frames / duration
            scalars["throughput/mel_frames_per_s"] = fps
            scalars["throughput/audio_sec_per_s"] = fps / frames_per_audio_sec
        self._write(step, scalars)

    def log_validation(self, step: int, loss: float, output=None,
                       batch=None) -> None:
        """Validation loss + model-health images for the first row of the
        given (output, batch), mirroring reference logger.py:19-48."""
        if not self.enabled:
            return
        self._write(step, {"validation/loss": loss})
        if self.writer is not None and output is not None and batch is not None:
            align = _np(output.alignments[0])
            mel_pred = _np(output.mel_postnet[0])
            mel_tgt = _np(batch.mel[0])
            gate_tgt = _np(batch.gate_target[0])
            gate_pred = 1.0 / (1.0 + np.exp(-_np(
                output.gate_energies[0]).astype(np.float64)))
            try:
                images = {"alignment": plot_alignment(align),
                          "mel_predicted": plot_mel(mel_pred),
                          "mel_target": plot_mel(mel_tgt),
                          "gate": plot_gate(gate_tgt, gate_pred)}
            except ImportError:  # no matplotlib: scalars only
                return
            for name, image in images.items():
                self.writer.add_image(name, image, step, dataformats="HWC")

    def log_param_histograms(self, step: int, model) -> None:
        """A histogram of every parameter of ``model``, by name."""
        if not self.enabled or self.writer is None:
            return
        for name, p in model.named_parameters():
            self.writer.add_histogram(name, _np(p), step)

    def write_scalars(self, step: int, scalars: dict) -> None:
        """Log arbitrary scalars (used for diagnostics metrics)."""
        self._write(step, scalars)

    def _write(self, step: int, scalars: dict) -> None:
        if self.writer is not None:
            for key, value in scalars.items():
                self.writer.add_scalar(key, value, step)
        if self.jsonl is not None:
            self.jsonl.write(json.dumps(
                {"step": step, "time": time.time(), **scalars}) + "\n")
            self.jsonl.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        if self.jsonl is not None:
            self.jsonl.close()
