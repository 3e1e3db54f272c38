"""Batched TTS serving on the port.

``BatchingSynthesizer`` coalesces concurrent requests into batches of up to
``max_batch`` requests, one text bucket per batch, runs each batch through
``models.tacotron2.infer_batch_fused`` -- the hand-written encoder and
decoder-chunk kernels on a CUDA device -- and resolves one future per
request. A batch of n requests is decoded at n rows rounded up to the
decoder kernel's 8-row tile (``decoder_batch.ROW_TILE``), at most
``max_batch``; the rows past n are padding, zero text of length 1. That
leaves a few shapes a text bucket, and on a card the worker decodes each
once before its first request. A model in its int8 serving form
(``quantize_for_serving``) goes through ``models.tacotron2.infer`` instead,
the step-by-step decoder whose LSTM cells call the int8 kernel (the chunk
kernels' packer takes only unquantized weights), at ``max_batch`` rows
always: its captured graphs are keyed by shape. ``VocoderRunner`` turns one
mel into audio through the HiFi-GAN generator or WaveGlow at bucketed
lengths. Same API and semantics as the JAX package's ``serve.py``, with the
model given as a module (or its state_dict) and an explicit ``device``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.data.bucketing import mel_bucket, text_bucket
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.models import hifigan, tacotron2, waveglow
from tacotron2_tpu_torch.text import text_to_sequence
from tacotron2_tpu_torch.utils.profiling import span


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

    On a card the worker first decodes each shape a batch can take, every
    (rows, text bucket) pair of ``tiles`` and the config's buckets, and the
    constructor waits for it: cuDNN keeps the convolutions' plans per thread
    and per shape, so a shape met first by a request would build them in
    its time. ``warmed`` lists the shapes so decoded, in order.

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
        config.validate()
        self.config = (config.replace(prenet_dropout_at_inference=False)
                       if deterministic else config)
        model = _as_model(model, config)
        self.quantized = tacotron2.is_quantized(model)
        dtype = self.config.torch_compute_dtype
        # the decoder kernel's limits, before the model goes to the card
        kernel = torch.device(device).type == "cuda" and not self.quantized
        if kernel:
            db.require_bf16(dtype, device)
        self.device = tacotron2.resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self.tiles = sorted({self._rows(n) for n in range(1, max_batch + 1)})
        if kernel:
            for rows in self.tiles:
                for t in self.config.text_buckets:
                    reason = db.kernel_limits(self.config, t, rows,
                                              self.device)
                    if reason is not None:
                        raise ValueError(
                            f"decoder kernel cannot serve text bucket {t} "
                            f"at {rows} rows: {reason}")
        self.max_wait_ms = max_wait_ms
        self.max_steps = max_steps or config.max_decoder_steps
        # packed once: the layout is independent of the text bucket
        self._packed = (None if self.quantized else
                        db.pack_batch_decoder_params(self.model, dtype))
        self._packed_lstm = tacotron2.pack_encoder_lstm(self.model, dtype)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self.warmed: List[Tuple[int, int]] = []
        # the requests of the batch in hand, its first rows (``_infer``)
        self._batch_requests: Optional[int] = None
        ready: Future = Future()
        self._worker = threading.Thread(target=self._run,
                                        args=(ready, kernel), daemon=True)
        self._worker.start()
        ready.result()   # the warm-up done, or its error raised here

    # ------------------------------------------------------------- API

    def submit(self, text: str) -> Future:
        if self._closed:
            raise RuntimeError("synthesizer is closed")
        ids = np.asarray(text_to_sequence(text, self.config.text_cleaners),
                         np.int32)
        future: Future = Future()
        self._queue.put((ids, future, time.perf_counter()))
        return future

    def synthesize(self, texts: Sequence[str]) -> List:
        return [f.result() for f in [self.submit(t) for t in texts]]

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._worker.join()

    # ---------------------------------------------------------- worker

    def _collect(self):
        """Pull up to max_batch requests: block for the first one, then
        wait up to max_wait_ms for each next one, afresh after every
        arrival, so a batch stays open while requests keep coming less than
        max_wait_ms apart. The span runs from the first request taken to
        the batch closed, not while the worker waits on an empty queue; it
        has no fields, since a span's name is fixed as it opens, and the
        ``serve.batch`` span that follows it carries the batch's rows."""
        first = self._queue.get()
        if first is None:
            return None
        with span("serve.collect"):
            items = [first]
            while len(items) < self.max_batch:
                try:
                    item = self._queue.get(
                        timeout=self.max_wait_ms / 1000.0)
                except queue.Empty:
                    break
                if item is None:
                    self._queue.put(None)  # re-post the shutdown signal
                    break
                items.append(item)
        return items

    def _rows(self, n: int) -> int:
        """The rows a batch of ``n`` requests is decoded at: ``n`` rounded
        up to the decoder kernel's row tile, which a launch computes whole
        anyway, at most ``max_batch``. The quantized path keeps
        ``max_batch``: each shape there is a capture of its own."""
        if self.quantized:
            return self.max_batch
        return min(-(-n // db.ROW_TILE) * db.ROW_TILE, self.max_batch)

    def _warm_up(self) -> None:
        """Decode each (rows, text bucket) shape once, on this thread: every
        row of zero text and length 1, and a gate threshold of 0, at which
        every row latches at its first step. So the decoder runs two chunks
        (the second launched ahead of the first's latch read), while the
        encoder and the postnet run at the served shapes, the postnet over
        the ``max_steps`` frames the decode returns."""
        latched = self.config.replace(gate_threshold=0.0)
        for rows in self.tiles:
            for t in self.config.text_buckets:
                tacotron2.infer_batch_fused(
                    self.model, torch.zeros((rows, t), dtype=torch.int32),
                    torch.ones((rows,), dtype=torch.int32), latched,
                    packed=self._packed, packed_lstm=self._packed_lstm,
                    max_steps=self.max_steps, device=self.device)
                self.warmed.append((rows, t))
        torch.cuda.synchronize(self.device)

    def _infer(self, text: np.ndarray, lengths: np.ndarray):
        """The batch decoded, and the rows of its requests copied to the
        host: the first ``_batch_requests``, which ``_run`` sets for each
        batch, or every row while it is None. A count held beside the call,
        not passed in it, so that a wrapper of ``_infer(text, lengths)``
        (the serving benchmark's) passes the call on unchanged."""
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
        n = self._batch_requests
        with span("serve.to_host"):
            return (res.mel_postnet[:n].cpu().numpy(),
                    res.alignments[:n].cpu().numpy(),
                    res.mel_lengths[:n].cpu().numpy())

    def _run(self, ready: Future, warm: bool) -> None:
        try:
            if warm:
                self._warm_up()
        except Exception as e:  # raised to the constructor
            ready.set_exception(e)
            return
        ready.set_result(None)
        buckets = self.config.text_buckets
        while True:
            items = self._collect()
            if items is None:
                return
            # the rows' waits in the queue, from submit to the batch
            # closed, summed, in us
            closed = time.perf_counter()
            wait_us = int(sum(closed - t for _, _, t in items) * 1e6)
            try:
                max_len = max(len(ids) for ids, _, _ in items)
                t_text = text_bucket(max_len, buckets)
                B = self._rows(len(items))
                self._batch_requests = len(items)
                with span("serve.batch", len(items), wait_us, B):
                    text = np.zeros((B, t_text), np.int32)
                    lengths = np.ones((B,), np.int32)
                    for i, (ids, _, _) in enumerate(items):
                        n = min(len(ids), t_text)
                        text[i, :n] = ids[:n]
                        lengths[i] = n
                    mel, align, mel_lengths = self._infer(text, lengths)
                    for i, (ids, future, _) in enumerate(items):
                        n = int(mel_lengths[i])
                        future.set_result(
                            (mel[i, :n], align[i, :n, :lengths[i]], n))
            except BaseException as e:  # propagate to all waiters
                for _, future, _ in items:
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
    HiFi-GAN V1 on 200 frames (H100, ``chip_smoke.py``). ``submit`` queues
    a mel there and returns a future without waiting, so that a thread
    which must not block (a synthesizer's worker resolving a mel) can hand
    the mel on; ``__call__`` waits for it. One thread also
    makes concurrent calls safe: they run one after another, on the card's
    current stream, reading weights nothing writes (WaveGlow's inverse 1x1
    weights are made here, before any call).

    On a CUDA device HiFi-GAN's generator runs as one CUDA graph per bucket
    up to ``max_frames``, captured on the bucket's first call: a call is
    then one launch instead of hundreds (V1 at 1000 frames holds ~11 ms of
    device work on an H100), so the runner's thread neither holds the host while the
    card sits idle between its launches nor queues them one by one between
    the kernels of a synthesizer sharing the card. A longer mel, and
    WaveGlow (its noise is drawn afresh on every call), run eagerly."""

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
        # bucket frames -> (padded mel buffer, graph, audio buffer)
        self._graphs = {}
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="vocoder")

    def submit(self, mel: np.ndarray) -> Future:
        """Queue a (n_frames, n_mels) float mel for the runner's thread:
        a future of its (n_frames * hop,) float audio. Never blocks; mels
        run one at a time, in the order they were submitted."""
        return self._worker.submit(self._traced, mel, time.perf_counter())

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """(n_frames, n_mels) float mel -> (n_frames * hop,) float audio."""
        return self.submit(mel).result()

    def _bucket(self, n: int) -> int:
        return mel_bucket(n, self.bucket_step, max(self.max_frames, n))

    def _traced(self, mel: np.ndarray, submitted: float) -> np.ndarray:
        """One mel on the runner's thread, in a span whose fields are the
        mel's frames, its bucket's frames, and its wait from ``submit`` to
        here, in us."""
        n = mel.shape[0]
        wait_us = int((time.perf_counter() - submitted) * 1e6)
        with span("vocoder.vocode", n, self._bucket(n), wait_us):
            return self._vocode(mel)

    def _graphed(self, t_mel: int, n_mels: int):
        """The generator at ``t_mel`` frames captured as a CUDA graph over a
        padded mel buffer, after one eager pass on a side stream (cuDNN's
        plans for this thread and the allocator's blocks are made outside
        the capture)."""
        if t_mel not in self._graphs:
            padded = torch.zeros(1, t_mel, n_mels, device=self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                hifigan.generator(self.model, padded, self.cfg)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                audio = hifigan.generator(self.model, padded, self.cfg)
            self._graphs[t_mel] = (padded, graph, audio)
        return self._graphs[t_mel]

    @torch.no_grad()
    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        n = mel.shape[0]
        t_mel = self._bucket(n)
        graphed = (self.kind == "hifigan" and self.device.type == "cuda"
                   and t_mel <= self.max_frames)
        if graphed:
            padded, graph, audio = self._graphed(t_mel, mel.shape[1])
            padded[0, n:].zero_()
        else:
            padded = torch.zeros(1, t_mel, mel.shape[1], device=self.device)
        padded[0, :n] = torch.as_tensor(mel, dtype=torch.float32)
        if graphed:
            graph.replay()
        elif self.kind == "hifigan":
            audio = hifigan.generator(self.model, padded, self.cfg)
        else:
            audio = waveglow.infer(self.model, padded, self.cfg,
                                   sigma=self.sigma,
                                   generator=torch.Generator(
                                       device=self.device).manual_seed(0))
        with span("vocoder.to_host"):
            return audio[0, :n * self.hop].cpu().numpy()
