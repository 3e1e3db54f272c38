"""Extended benchmark of the port on the card (the counterpart of
``tools/bench_details.py``): the JAX script's measurement matrix.

    python -m tacotron2_tpu_torch.tools.bench_details [STAGE ...]
        [--out PATH] [--device cuda|cpu]

Stages (all by default): ``train_bf16``, ``train_fp32`` (the teacher-forced
step at B=32, T_in 128, T_out 512: rows 1-4), ``infer1``, ``infer8``,
``infer1_int8``, ``infer8_int8`` (the step-by-step decoder, captured CUDA
graph chunks, on seeded weights or their ``quantize_for_serving`` int8 form:
row 7), ``infer1_fused`` (the single-utterance decoder chunk, row 6),
``fused_vs_xla_b8`` (8 utterances as one step-by-step batch against 8
sequential fused B=1 decodes, as the JAX script compares them, and the
port's batched decoder chunk, row 5, at B=8 beside them), ``vocoder``
(WaveGlow at the published widths, sigma 0.666) and ``hifigan`` (the V1
generator, bf16). Every decode runs its full ``max_decoder_steps``: the
gate threshold is 1.5, which no sigmoid reaches. Each stage is timed as
``bench.time_steps`` times a step (a warm call, then the timed calls and a
synchronise after the last); the keys are the JAX script's, plus
``infer_b8_fused_*`` and ``b8_fused_vs_xla_throughput`` for row 5. An
unknown stage is an argparse error. The JSON goes to ``--out`` or, by
default, to stdout; the script never writes the JAX package's
``BENCH_DETAILS.json``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from tacotron2_tpu_torch.bench import time_steps, train_stepper
from tacotron2_tpu_torch.config import Tacotron2Config, parse_overrides

STAGES = ("train_bf16", "train_fp32", "infer1", "infer8", "infer1_int8",
          "infer8_int8", "infer1_fused", "fused_vs_xla_b8", "vocoder",
          "hifigan")
FRAMES_PER_AUDIO_SEC = 22050 / 256


class Bench:
    """The stages on one device, their results by the JAX script's keys.
    ``steps``: timed training steps; ``reps``: timed calls of an inference
    stage, as a share of the JAX script's counts (1.0: 30 a decode, 15 a
    WaveGlow, 40 a HiFi-GAN); ``hparams`` overrides every stage's
    Tacotron 2 config."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 steps: int = 10, reps: float = 1.0,
                 hparams: Optional[str] = None):
        from tacotron2_tpu_torch.models.tacotron2 import resolve_device
        self.device = resolve_device(device)
        self.steps, self.reps, self.hparams = steps, reps, hparams
        self.results: Dict[str, float] = {}

    def _config(self, **kw) -> Tacotron2Config:
        cfg = Tacotron2Config(**kw)
        return parse_overrides(cfg, self.hparams) if self.hparams else cfg

    def _reps(self, n: int) -> int:
        return max(1, round(n * self.reps))

    def _model(self, cfg: Tacotron2Config):
        from tacotron2_tpu_torch.models import tacotron2 as tm
        return tm.Tacotron2(cfg, torch.Generator().manual_seed(0)).to(
            self.device)

    def _text(self, cfg: Tacotron2Config, B: int, T_in: int):
        rng = np.random.RandomState(0)
        text = torch.from_numpy(rng.randint(1, cfg.n_symbols, (B, T_in)))
        return (text.to(self.device),
                torch.full((B,), T_in, dtype=torch.int32, device=self.device))

    def _decoder_inputs(self, model, cfg, B: int, T_in: int):
        """The encoder's output for a random text: (memory, processed
        memory, mask), as the JAX script computes them outside the timing
        of the fused decode."""
        from tacotron2_tpu_torch.models import tacotron2 as tm
        from tacotron2_tpu_torch.ops.layers import length_mask
        text, lengths = self._text(cfg, B, T_in)
        memory = tm.encode(model, text, lengths, cfg,
                           compute_dtype=torch.bfloat16)
        processed = tm.processed_memory_of(model, memory, torch.bfloat16)
        return memory, processed, length_mask(lengths, memory.shape[1])

    def _decode_row(self, tag: str, B: int, steps: int, dt: float) -> float:
        r = self.results
        rtf = dt / (B * steps / FRAMES_PER_AUDIO_SEC)
        r[f"{tag}_rtf"] = round(rtf, 5)
        r[f"{tag}_frames_per_s"] = round(B * steps / dt, 1)
        return rtf

    # ------------------------------------------------------------ stages

    def train(self, compute_dtype: str, B: int = 32, T_in: int = 128,
              T_out: int = 512) -> None:
        cfg = self._config(compute_dtype=compute_dtype, batch_size=B)
        run = train_stepper(cfg, B, T_in, T_out, self.device)
        dt = time_steps(run, self.steps, self.device)
        fps = B * T_out / dt
        self.results[f"train_{compute_dtype}_mel_frames_per_s"] = round(fps, 1)
        self.results[f"train_{compute_dtype}_audio_sec_per_s"] = round(
            fps / FRAMES_PER_AUDIO_SEC, 1)
        self.results[f"train_{compute_dtype}_step_ms"] = round(dt * 1e3, 1)
        print(f"train[{compute_dtype}] {fps:,.0f} mel-frames/s "
              f"({dt * 1e3:.1f} ms/step)", flush=True)

    @torch.no_grad()
    def infer(self, B: int, T_in: int = 128, steps: int = 400,
              quantized: bool = False) -> None:
        """The step-by-step decoder (``models/tacotron2.infer``: on a card
        each chunk a CUDA graph's replay), encoder and postnet included."""
        from tacotron2_tpu_torch.models import tacotron2 as tm
        cfg = self._config(prenet_dropout_at_inference=False,
                           gate_threshold=1.5, max_decoder_steps=steps)
        steps = cfg.max_decoder_steps
        model = self._model(cfg)
        if quantized:
            model = tm.quantize_for_serving(model)
        text, lengths = self._text(cfg, B, T_in)
        dt = time_steps(lambda: tm.infer(
            model, text, lengths, cfg, compute_dtype=torch.bfloat16,
            device=self.device), self._reps(30), self.device)
        tag = f"infer_b{B}" + ("_int8" if quantized else "")
        rtf = self._decode_row(tag, B, steps, dt)
        self.results[f"{tag}_ms_per_frame"] = round(dt / steps * 1e3, 3)
        print(f"infer[B={B}{' int8' if quantized else ''}] RTF {rtf:.5f} "
              f"({B * steps / dt:,.0f} frames/s, "
              f"{dt / steps * 1e3:.3f} ms/frame-step)", flush=True)

    @torch.no_grad()
    def infer_fused(self, T_in: int = 128, steps: int = 448,
                    chunk: int = 64) -> None:
        """B=1 through the single-utterance decoder chunk (row 6), the
        chunk loop alone, its weights packed once."""
        from tacotron2_tpu_torch.kernels import decoder_step as ds
        cfg = self._config(prenet_dropout_at_inference=False,
                           gate_threshold=1.5, max_decoder_steps=steps)
        steps = cfg.max_decoder_steps
        model = self._model(cfg)
        packed = ds.pack_decoder_params(model, torch.bfloat16)
        memory, processed, mask = self._decoder_inputs(model, cfg, 1, T_in)
        dt = time_steps(lambda: ds.decode_autoregressive_fused(
            packed, memory, processed, mask, cfg, max_steps=steps,
            chunk_steps=chunk), self._reps(30), self.device)
        rtf = self._decode_row("infer_b1_fused", 1, steps, dt)
        self.results["infer_b1_fused_us_per_frame"] = round(
            dt / steps * 1e6, 2)
        print(f"infer[B=1 fused] RTF {rtf:.5f} ({steps / dt:,.0f} frames/s, "
              f"{dt / steps * 1e6:.1f} us/frame)", flush=True)

    @torch.no_grad()
    def infer_batch_fused(self, B: int = 8, T_in: int = 128,
                          steps: int = 400, chunk: int = 64) -> None:
        """B rows through the batched decoder chunk (row 5), the chunk loop
        alone."""
        from tacotron2_tpu_torch.kernels import decoder_batch as db
        cfg = self._config(prenet_dropout_at_inference=False,
                           gate_threshold=1.5, max_decoder_steps=steps)
        steps = cfg.max_decoder_steps
        model = self._model(cfg)
        packed = db.pack_batch_decoder_params(model, torch.bfloat16)
        memory, processed, mask = self._decoder_inputs(model, cfg, B, T_in)
        dt = time_steps(lambda: db.decode_autoregressive_batch(
            packed, memory, processed, mask, cfg, max_steps=steps,
            chunk_steps=chunk), self._reps(30), self.device)
        rtf = self._decode_row(f"infer_b{B}_fused", B, steps, dt)
        self.results[f"infer_b{B}_fused_ms_per_frame"] = round(
            dt / steps * 1e3, 3)
        print(f"infer[B={B} fused] RTF {rtf:.5f} ({B * steps / dt:,.0f} "
              f"frames/s)", flush=True)

    def fused_vs_xla_b8(self) -> None:
        """8 concurrent utterances: one step-by-step B=8 batch (the JAX
        script's "XLA" row) against 8 sequential fused B=1 decodes, and
        the port's batched decoder chunk at B=8."""
        self.infer(B=8)
        self.infer_fused()
        self.infer_batch_fused(B=8)
        r = self.results
        b8, fused1 = r["infer_b8_frames_per_s"], r["infer_b1_fused_frames_per_s"]
        r["b8_xla_vs_fused_seq_throughput"] = round(b8 / fused1, 2)
        r["b8_fused_vs_xla_latency"] = round(
            r["infer_b8_rtf"] * 8 / r["infer_b1_fused_rtf"], 2)
        r["b8_fused_vs_xla_throughput"] = round(
            r["infer_b8_fused_frames_per_s"] / b8, 2)
        print(f"fused_vs_xla_b8: step-by-step B=8 {b8:,.0f} frames/s total "
              f"vs fused B=1 {fused1:,.0f} frames/s/stream -> "
              f"{b8 / fused1:.2f}x; the batched chunk at B=8 "
              f"{r['infer_b8_fused_frames_per_s']:,.0f} frames/s", flush=True)

    @torch.no_grad()
    def vocoder(self, B: int = 1, T_mel: int = 400) -> None:
        """WaveGlow at the published widths, fp32, sigma 0.666."""
        from tacotron2_tpu_torch.models import waveglow
        cfg = waveglow.WaveGlowConfig()
        model = waveglow.WaveGlow(cfg, torch.Generator().manual_seed(0)).to(
            self.device)
        mel = torch.from_numpy(np.random.RandomState(0).randn(
            B, T_mel, cfg.n_mel_channels).astype(np.float32)).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(1)
        dt = time_steps(lambda: waveglow.infer(model, mel, cfg, sigma=0.666,
                                               generator=gen),
                        self._reps(15), self.device)
        audio_sec = B * T_mel / FRAMES_PER_AUDIO_SEC
        self.results[f"vocoder_b{B}_rtf"] = round(dt / audio_sec, 4)
        self.results[f"vocoder_b{B}_audio_sec_per_s"] = round(
            audio_sec / dt, 1)
        print(f"vocoder[B={B}] RTF {dt / audio_sec:.4f} "
              f"({audio_sec / dt:,.1f} audio-sec/s)", flush=True)

    @torch.no_grad()
    def hifigan(self, B: int = 1, T_mel: int = 400) -> None:
        """The HiFi-GAN V1 generator, bf16 operands."""
        from tacotron2_tpu_torch.models import hifigan
        cfg = hifigan.HiFiGANConfig()
        model = hifigan.Generator(cfg, torch.Generator().manual_seed(0)).to(
            self.device)
        mel = torch.from_numpy(np.random.RandomState(0).randn(
            B, T_mel, cfg.n_mel_channels).astype(np.float32)).to(self.device)
        dt = time_steps(lambda: hifigan.generator(
            model, mel, cfg, compute_dtype=torch.bfloat16),
            self._reps(40), self.device)
        audio_sec = B * T_mel / FRAMES_PER_AUDIO_SEC
        self.results[f"hifigan_b{B}_rtf"] = round(dt / audio_sec, 5)
        self.results[f"hifigan_b{B}_audio_sec_per_s"] = round(
            audio_sec / dt, 1)
        print(f"hifigan[B={B}] RTF {dt / audio_sec:.5f} "
              f"({audio_sec / dt:,.1f} audio-sec/s)", flush=True)

    def run(self, stages: Sequence[str]) -> Dict[str, float]:
        """The named stages, in the JAX script's order."""
        todo = set(stages)
        if "train_bf16" in todo:
            self.train("bfloat16")
        if "train_fp32" in todo:
            self.train("float32")
        for B, quantized in ((1, False), (8, False), (1, True), (8, True)):
            if f"infer{B}{'_int8' if quantized else ''}" in todo:
                self.infer(B, quantized=quantized)
        if "infer1_fused" in todo:
            self.infer_fused()
        if "fused_vs_xla_b8" in todo:
            self.fused_vs_xla_b8()
        if "vocoder" in todo:
            self.vocoder(B=1)
            self.vocoder(B=8)
        if "hifigan" in todo:
            self.hifigan(B=1)
            self.hifigan(B=8)
        return self.results


def write(results: Dict[str, float], out: Optional[str] = None) -> None:
    """The results as indented JSON, to the file ``out`` or to stdout."""
    text = json.dumps(results, indent=2)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        prog="python -m tacotron2_tpu_torch.tools.bench_details")
    parser.add_argument("stages", nargs="*", default=[],
                        help=f"subset of: {' '.join(STAGES)} (default: all)")
    parser.add_argument("--out", default=None,
                        help="write the JSON here (default: stdout)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    unknown = set(args.stages) - set(STAGES)
    if unknown:
        parser.error(f"unknown stages: {sorted(unknown)}")
    bench = Bench(args.device)
    name = (torch.cuda.get_device_name(bench.device)
            if bench.device.type == "cuda" else "cpu")
    print(f"device: {name}", flush=True)
    results = bench.run(args.stages or STAGES)
    write(results, args.out)
    return results


if __name__ == "__main__":
    main()
