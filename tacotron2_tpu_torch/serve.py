"""Batched TTS serving on the port.

``BatchingSynthesizer`` coalesces concurrent requests into fixed-shape
batches (``max_batch`` rows, one text bucket per batch, padding rows of zero
text and length 1), runs each batch through
``models.tacotron2.infer_batch_fused`` -- the hand-written encoder and
decoder-chunk kernels on a CUDA device -- and resolves one future per
request. A model in its int8 serving form (``quantize_for_serving``) goes
through ``models.tacotron2.infer`` instead, the step-by-step decoder whose
LSTM cells call the int8 kernel: the chunk kernels' packer takes only
unquantized weights. ``VocoderRunner`` turns one mel into audio through the
HiFi-GAN generator or WaveGlow at bucketed lengths. Same API and semantics
as the JAX package's ``serve.py``, with the model given as a module (or its
state_dict) and an explicit ``device``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.data.bucketing import mel_bucket, text_bucket
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.models import hifigan, tacotron2, waveglow
from tacotron2_tpu_torch.text import text_to_sequence


def _as_model(model, config: Tacotron2Config) -> tacotron2.Tacotron2:
    """The module of a state_dict (quantized cells where its keys end in
    ``w_q``), or the module itself."""
    if isinstance(model, Mapping):
        module = tacotron2.Tacotron2(config)
        if any(k.endswith("w_q") for k in model):
            module = tacotron2.quantize_for_serving(module)
        module.load_state_dict(model, strict=True)
        return module
    return model


class BatchingSynthesizer:
    """Submit texts from any thread; batches run on one worker thread.

    Usage:
        synth = BatchingSynthesizer(model, cfg, max_batch=8)
        future = synth.submit("Hello world.")
        mel, alignment, n_frames = future.result()
        synth.close()
    """

    def __init__(self, model: Union[tacotron2.Tacotron2,
                                    Mapping[str, torch.Tensor]],
                 config: Tacotron2Config, max_batch: int = 8,
                 max_wait_ms: float = 5.0, max_steps: Optional[int] = None,
                 deterministic: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.device = tacotron2.resolve_device(device)
        config.validate()
        self.config = (config.replace(prenet_dropout_at_inference=False)
                       if deterministic else config)
        self.model = _as_model(model, config).to(self.device).eval()
        self.quantized = tacotron2.is_quantized(self.model)
        if self.device.type == "cuda" and not self.quantized:
            for t in self.config.text_buckets:
                reason = db.kernel_limits(self.config, t, self.device)
                if reason is not None:
                    raise ValueError(f"decoder kernel cannot serve text "
                                     f"bucket {t}: {reason}")
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_steps = max_steps or config.max_decoder_steps
        # packed once: the layout is independent of the text bucket
        dtype = self.config.torch_compute_dtype
        self._packed = (None if self.quantized else
                        db.pack_batch_decoder_params(self.model, dtype))
        self._packed_lstm = tacotron2.pack_encoder_lstm(self.model, dtype)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- API

    def submit(self, text: str) -> Future:
        if self._closed:
            raise RuntimeError("synthesizer is closed")
        ids = np.asarray(text_to_sequence(text, self.config.text_cleaners),
                         np.int32)
        future: Future = Future()
        self._queue.put((ids, future))
        return future

    def synthesize(self, texts: Sequence[str]) -> List:
        return [f.result() for f in [self.submit(t) for t in texts]]

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._worker.join()

    # ---------------------------------------------------------- worker

    def _collect(self):
        """Pull up to max_batch requests, waiting max_wait_ms after the
        first one arrives."""
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        while len(items) < self.max_batch:
            try:
                item = self._queue.get(timeout=self.max_wait_ms / 1000.0)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-post the shutdown signal
                break
            items.append(item)
        return items

    def _infer(self, text: np.ndarray, lengths: np.ndarray):
        text, lengths = torch.from_numpy(text), torch.from_numpy(lengths)
        if self.quantized:
            cd = self.config.torch_compute_dtype
            res = tacotron2.infer(
                self.model, text, lengths, self.config,
                max_steps=self.max_steps, device=self.device,
                compute_dtype=None if cd == torch.float32 else cd)
        else:
            res = tacotron2.infer_batch_fused(
                self.model, text, lengths, self.config, packed=self._packed,
                packed_lstm=self._packed_lstm, max_steps=self.max_steps,
                device=self.device)
        return (res.mel_postnet.cpu().numpy(), res.alignments.cpu().numpy(),
                res.mel_lengths.cpu().numpy())

    def _run(self) -> None:
        buckets = self.config.text_buckets
        while True:
            items = self._collect()
            if items is None:
                return
            try:
                max_len = max(len(ids) for ids, _ in items)
                t_text = text_bucket(max_len, buckets)
                B = self.max_batch  # fixed batch shape: padding rows
                text = np.zeros((B, t_text), np.int32)
                lengths = np.ones((B,), np.int32)
                for i, (ids, _) in enumerate(items):
                    n = min(len(ids), t_text)
                    text[i, :n] = ids[:n]
                    lengths[i] = n
                mel, align, mel_lengths = self._infer(text, lengths)
                for i, (ids, future) in enumerate(items):
                    n = int(mel_lengths[i])
                    future.set_result((mel[i, :n], align[i, :n, :lengths[i]],
                                       n))
            except BaseException as e:  # propagate to all waiters
                for _, future in items:
                    if not future.done():
                        future.set_exception(e)
                if not isinstance(e, Exception):
                    raise


class VocoderRunner:
    """Neural mel -> waveform vocoding with mel-length bucketing: a request
    is zero-padded to a multiple of ``bucket_step`` frames (capped at
    ``max_frames``) and its audio trimmed back, so the vocoder sees a
    bounded set of shapes. ``kind`` is ``"hifigan"`` or ``"waveglow"``;
    ``vocoder`` its module (``models.hifigan.Generator``,
    ``models.waveglow.WaveGlow``) or that module's state_dict. WaveGlow
    draws z at ``sigma`` from a generator seeded 0 afresh on every call,
    so that a request's audio does not depend on the requests before it.

    Every call runs on the runner's one long-lived thread, whichever thread
    makes it (the HTTP server's handlers, a thread per request). PyTorch
    keeps cuDNN's execution plans per thread, so a call on a fresh thread
    builds one for every convolution again: 63.8 ms against 7.3 ms for
    HiFi-GAN V1 on 200 frames (H100, ``chip_smoke.py``). One thread also
    makes concurrent calls safe: they run one after another, on the card's
    current stream, reading weights nothing writes (WaveGlow's inverse 1x1
    weights are made here, before any call)."""

    def __init__(self, kind: str,
                 vocoder: Union[hifigan.Generator, waveglow.WaveGlow,
                                Mapping[str, torch.Tensor]],
                 vocoder_cfg: Union[hifigan.HiFiGANConfig,
                                    waveglow.WaveGlowConfig], *,
                 max_frames: int, bucket_step: int = 128,
                 sigma: float = 0.666,
                 device: Union[str, torch.device] = "cuda"):
        modules = {"hifigan": hifigan.Generator, "waveglow": waveglow.WaveGlow}
        if kind not in modules:
            raise ValueError(f"unknown neural vocoder {kind!r}")
        self.device = tacotron2.resolve_device(device)
        self.kind = kind
        if isinstance(vocoder, Mapping):
            module = modules[kind](vocoder_cfg)
            module.load_state_dict(vocoder, strict=True)
            vocoder = module
        self.model = vocoder.to(self.device).eval()
        self.cfg = vocoder_cfg
        self.max_frames = max_frames
        self.bucket_step = bucket_step
        self.sigma = sigma
        self.hop = vocoder_cfg.hop_length
        if kind == "waveglow":
            self.model.inverse_weights()
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="vocoder")

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """(n_frames, n_mels) float mel -> (n_frames * hop,) float audio."""
        return self._worker.submit(self._vocode, mel).result()

    @torch.no_grad()
    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        n = mel.shape[0]
        t_mel = mel_bucket(n, self.bucket_step, max(self.max_frames, n))
        padded = torch.zeros(1, t_mel, mel.shape[1], device=self.device)
        padded[0, :n] = torch.as_tensor(mel, dtype=torch.float32)
        if self.kind == "hifigan":
            audio = hifigan.generator(self.model, padded, self.cfg)
        else:
            audio = waveglow.infer(self.model, padded, self.cfg,
                                   sigma=self.sigma,
                                   generator=torch.Generator(
                                       device=self.device).manual_seed(0))
        return audio[0, :n * self.hop].cpu().numpy()
