"""The training loop: the reference ``train()`` on one device.

The port's counterpart of the JAX package's ``training/trainer.py``
(reference train.py:149-255): epoch loop, logging at a cadence, periodic
validation and checkpoint, resume and warm start, a learning rate set per
step, and steps whose loss is not finite skipped on the device
(``training/state.py:guarded_update``). Host batch assembly and the copy to
the card run one batch ahead (``data/pipeline.py``); checkpoints are
written in the background. One device: the mesh and ``parallel`` wait for
the port of ``parallel/``.

Dropout is drawn from a generator on the device seeded from
``(config.seed, step)``, so a resumed run draws what an uninterrupted one
would; validation's prenet dropout (``eval_prenet_dropout``) from
``(config.seed, step, batch index)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import (Callable, List, NamedTuple, Optional, Set, Tuple,
                    Union)

import numpy as np
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.data.pipeline import (DataPipeline, DeviceTransfer,
                                               prefetch,
                                               process_index_and_count)
from tacotron2_tpu_torch.models import tacotron2 as model_lib
from tacotron2_tpu_torch.training.checkpoint import Checkpointer, warm_start
from tacotron2_tpu_torch.training.logging import MetricLogger
from tacotron2_tpu_torch.training.state import (Batch, StepMetrics,
                                                TrainState,
                                                create_train_state, eval_step,
                                                train_step)

_TRAIN, _EVAL = 0, 1  # streams of derived seeds


def derived_generator(device: torch.device, *parts: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``parts``
    (numpy's SeedSequence mixes them)."""
    seed = int(np.random.SeedSequence(list(parts)).generate_state(
        1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(seed)


class FitTiming(NamedTuple):
    """Host-clock account of the last ``fit``."""
    steps: int
    wall_s: float              # the whole fit, validation and saves included
    prefetch_wait_s: float     # the step loop blocked on the next batch
    step_intervals_s: List[float]  # between consecutive train_step returns
    interval_shapes: List[Tuple[int, int]]  # (T_in, T_out) of each interval
    step_waits_s: List[float]  # the wait on prefetch before each step


class Trainer:
    def __init__(self, config: Tacotron2Config, output_directory: str,
                 log_directory: str = "logs",
                 checkpoint_path: Optional[str] = None,
                 warm_start_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        # debug_nans and prng_impl steer JAX only and are ignored here:
        # non-finite steps are skipped on the device, and dropout comes
        # from torch generators (config.IGNORED_KNOBS).
        config.validate()
        if config.grad_accum_steps != 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 (training/accumulate.py) is not ported "
                "yet (ROADMAP.md, section A.2)")
        self.config = config
        self.device = model_lib.resolve_device(device)
        self.is_main = process_index_and_count()[0] == 0
        self.checkpointer = Checkpointer(output_directory)
        self.logger = MetricLogger(os.path.join(output_directory,
                                                log_directory))
        if self.is_main:
            # reproducibility snapshot of the exact configuration
            with open(os.path.join(output_directory, "config.json"),
                      "w") as f:
                json.dump(dataclasses.asdict(config), f, indent=2,
                          default=str)

        self.state = create_train_state(
            config, generator=torch.Generator().manual_seed(config.seed),
            device=self.device)
        if checkpoint_path or (warm_start_path is None and
                               self.checkpointer.latest()):
            self.state = self.checkpointer.restore(self.state,
                                                   checkpoint_path)
            if not config.use_saved_learning_rate:
                self.state.learning_rate.fill_(config.learning_rate)
            print(f"Resumed from step {int(self.state.step)}")
        elif warm_start_path:
            warm_start(self.state.model, warm_start_path,
                       config.ignore_layers)
            self.state = self.state._replace(
                stats=model_lib.bn_stats(self.state.model))
            print(f"Warm-started from {warm_start_path} "
                  f"(ignoring {config.ignore_layers})")
        self._lr = float(self.state.learning_rate)
        self.last_fit: Optional[FitTiming] = None
        # ("train" | "val", T_in, T_out) of every batch run, for the record
        self.shapes_met: Set[Tuple[str, int, int]] = set()

    # ------------------------------------------------------------------

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout generator of training step ``step`` (0-based)."""
        return derived_generator(self.device, self.config.seed, _TRAIN, step)

    def fit(self, train_pipeline: DataPipeline,
            val_pipeline: Optional[DataPipeline] = None,
            epochs: Optional[int] = None, lr_schedule=None,
            max_steps: Optional[int] = None,
            on_step: Optional[Callable[[int, StepMetrics], None]] = None
            ) -> TrainState:
        """Train to the end of epoch ``epochs`` (config.epochs if None), or
        until the state's step reaches ``max_steps``. ``lr_schedule``: an
        optional step -> lr callable (training/schedules.py); None keeps the
        state's learning rate. ``on_step(step, metrics)`` is called after
        each step with the step's metrics on the device (reading them waits
        for the device). A resumed run skips the batches of its epoch that
        were already trained on, so it sees what an uninterrupted run
        would."""
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.epochs
        steps_per_epoch = train_pipeline.steps_per_epoch()
        step = int(self.state.step)  # host-side mirror of the step counter
        start_epoch = step // steps_per_epoch if steps_per_epoch else 0
        frames_per_audio_sec = cfg.sampling_rate / cfg.hop_length
        transfer = (DeviceTransfer(self.device)
                    if self.device.type == "cuda" else None)
        t_fit = time.perf_counter()
        wait_s, intervals, shapes, waits, steps_run = 0.0, [], [], [], 0

        def done() -> bool:
            return max_steps is not None and step >= max_steps

        def epochs_from(first: int):
            # every epoch's batches in one stream, so that one prefetch
            # thread runs ahead across epoch boundaries; an epoch always
            # holds steps_per_epoch batches (the buckets' counts fix it)
            for epoch in range(start_epoch, epochs):
                skip = first - epoch * steps_per_epoch \
                    if epoch == start_epoch else 0
                yield from train_pipeline.epoch(epoch, skip=skip)

        batches = prefetch(epochs_from(step), depth=2, transfer=transfer)
        epoch = None
        interval_t0 = time.perf_counter()
        interval_steps = interval_frames = 0
        t_prev = None
        try:
            while not done():
                t0 = time.perf_counter()
                batch = next(batches, None)
                waited = time.perf_counter() - t0
                wait_s += waited
                if batch is None:
                    break
                waits.append(waited)
                if step // steps_per_epoch != epoch:
                    epoch = step // steps_per_epoch
                    if self.is_main:
                        print(f"Epoch {epoch}")
                self.shapes_met.add(("train", batch.text.shape[1],
                                     batch.mel.shape[1]))
                if lr_schedule is not None:
                    self.set_learning_rate(lr_schedule(step))
                # The metrics stay on the device: a non-finite step is
                # skipped inside guarded_update, so the host reads the loss
                # only at the logging cadence and runs ahead in between.
                self.state, metrics, _ = train_step(
                    self.state, batch, cfg, self.step_generator(step))
                step += 1
                steps_run += 1
                t_now = time.perf_counter()
                if t_prev is not None:
                    intervals.append(t_now - t_prev)
                    shapes.append((batch.text.shape[1], batch.mel.shape[1]))
                t_prev = t_now
                if on_step is not None:
                    on_step(step, metrics)
                interval_steps += 1
                interval_frames += int(np.prod(batch.mel.shape[:2]))

                at_ckpt = step % cfg.iters_per_checkpoint == 0
                if at_ckpt or step % cfg.log_interval == 0:
                    loss = float(metrics.loss)  # host sync point
                    duration = ((time.perf_counter() - interval_t0)
                                / interval_steps)
                    if self.is_main:
                        skipped = "" if float(metrics.applied) else " SKIPPED"
                        print(f"Train loss {step} {loss:.6f} Grad Norm "
                              f"{float(metrics.grad_norm):.6f} "
                              f"{duration:.2f}s/it{skipped}")
                        self.logger.log_training(
                            step, loss, float(metrics.grad_norm), self._lr,
                            duration,
                            mel_frames=interval_frames // interval_steps,
                            frames_per_audio_sec=frames_per_audio_sec)
                    interval_t0 = time.perf_counter()
                    interval_steps = interval_frames = 0
                if at_ckpt:
                    if val_pipeline is not None:
                        self.validate(val_pipeline, step)
                    self.checkpointer.save(self.state)
                    t_prev = None  # the interval spans no save
        finally:
            batches.close()
        self.checkpointer.save(self.state, wait=True)
        self.last_fit = FitTiming(steps_run, time.perf_counter() - t_fit,
                                  wait_s, intervals, shapes, waits)
        return self.state

    def validate(self, val_pipeline: DataPipeline, step: int) -> float:
        """Exact validation mean (reference train.py:121-146): each batch's
        loss is already weighted over its real rows (cycled padding rows
        masked out); batches are combined weighted by real-row count, so the
        result is invariant to how the set is split into batches."""
        cfg = self.config
        total, weight = 0.0, 0.0
        last = None
        for i, batch in enumerate(val_pipeline.epoch(0)):
            batch = Batch(*(None if t is None else t.to(self.device)
                            for t in batch))
            self.shapes_met.add(("val", batch.text.shape[1],
                                 batch.mel.shape[1]))
            gen = (derived_generator(self.device, cfg.seed, _EVAL, step, i)
                   if cfg.eval_prenet_dropout else None)
            breakdown, output = eval_step(self.state, batch, cfg, gen)
            n_valid = (float(batch.row_valid.sum())
                       if batch.row_valid is not None
                       else float(batch.text.shape[0]))
            total += float(breakdown.total) * n_valid
            weight += n_valid
            last = (output, batch)
        val_loss = total / max(weight, 1.0)
        if self.is_main:
            print(f"Validation loss {step}: {val_loss:9f}")
            output, batch = last if last else (None, None)
            self.logger.log_validation(step, val_loss, output, batch)
            if output is not None:
                from tacotron2_tpu_torch.training.diagnostics import (
                    alignment_diagnostics, gate_accuracy)
                host = lambda t: t.detach().float().cpu().numpy()
                scalars = alignment_diagnostics(
                    host(output.alignments), host(batch.text_lengths),
                    host(batch.mel_lengths))
                scalars.update(gate_accuracy(
                    host(output.gate_energies), host(batch.gate_target),
                    host(batch.mel_lengths)))
                self.logger.write_scalars(step, scalars)
        return val_loss

    def set_learning_rate(self, lr: float) -> None:
        """Live LR injection (reference train.py:210-211): written into the
        state's device scalar in stream order, without a host sync."""
        if lr != self._lr:
            self.state.learning_rate.fill_(lr)
            self._lr = lr
