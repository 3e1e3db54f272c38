"""Streaming (chunked) synthesis: low-latency text -> audio.

Counterpart of the JAX package's ``streaming.py``. The autoregressive
decoder runs in fixed-size chunks -- the single-utterance chunk kernel
(``kernels/decoder_step``) for one utterance, the batched one
(``kernels/decoder_batch``) for ``stream_batch``, the plain step-by-step
``decode_chunk`` with the int8 cell for a quantized model -- and the postnet
and the HiFi-GAN generator run over sliding windows with enough context
margin that every emitted frame and sample is what the offline pipeline
produces:

- postnet (5x conv k=5, zero 'SAME' padding): frame t depends on raw mel
  [t-P, t+P] with P = n_convs * (k-1)/2 (10 for the default config);
- HiFi-GAN generator: sample t depends on postnet mel
  [t/hop - M, t/hop + M] with M = ``hifigan.receptive_field_frames``
  (15 for V1).

A chunk of C = chunk_steps * n_frames_per_step frames is emitted once its
full context window exists. Windows are CLAMPED inside the offline buffer
[0, T_buf = max_steps * r): stacked SAME-padded convs re-pad each layer's
own input, so a zero-filled out-of-range window would compute different
edge intermediates (conv bias and batchnorm make zero a non-fixed-point)
than the offline full-buffer pass. A clamped window's edge is either the
true buffer edge, where its SAME padding coincides with the offline padding,
or an interior point at least one receptive field away from every emitted
frame. Frames past a row's gate-stop are zero in the buffer, as the offline
decode loop leaves them.

So every emitted value is the same function of the same inputs as offline.
The JAX package can promise bit-identical output because one compiled
program serves every window; here each window's convolutions go to
PyTorch's library calls, which may pick another algorithm, and so another
order of sums, for a window's shape than for the whole buffer. The port
therefore promises agreement to rounding, not to the bit: 1e-5 of the
output's largest value in fp32, 2e-2 in bf16 (one bf16 rounding flip in a
conv's operand moves an output by up to 2^-8 of it;
tests/test_torch_streaming.py and chip_smoke.py hold these).

With prenet dropout (``deterministic=False`` and a generator) the fused
chunks draw their keep masks chunk by chunk, so a streamed utterance equals
an offline ``infer_fused`` from the same generator state only at the same
``chunk_steps``.
"""

from __future__ import annotations

from typing import Iterator, Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.data.bucketing import text_bucket
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import decoder_step as ds
from tacotron2_tpu_torch.models import hifigan, tacotron2
from tacotron2_tpu_torch.ops.layers import length_mask
from tacotron2_tpu_torch.serve import _as_model
from tacotron2_tpu_torch.text import text_to_sequence


class StreamEvent(NamedTuple):
    """One incremental emission. ``mel`` events carry postnet mel frames;
    ``audio`` events carry the vocoded samples for earlier frames (the
    vocoder lags the postnet by its context margin)."""
    mel: Optional[np.ndarray]     # (n, n_mel_channels) or None
    audio: Optional[np.ndarray]   # (n * hop_length,) or None
    mel_offset: int               # frame index of mel[0] / audio's frames
    done: bool                    # True on the final event of the stream


def postnet_margin_frames(cfg: Tacotron2Config) -> int:
    """One-sided postnet receptive field in frames: n convs of kernel k
    with zero 'SAME' padding stack to n*(k-1)/2."""
    return cfg.postnet_n_convolutions * (cfg.postnet_kernel_size - 1) // 2


def _clamp_window(want_start: int, width: int, t_buf: int) -> int:
    """Start of a ``width``-frame window fully inside [0, t_buf)."""
    return min(max(want_start, 0), t_buf - width)


class StreamingSynthesizer:
    """Chunked low-latency synthesis.

    Usage:
        s = StreamingSynthesizer(model, cfg, vocoder=gen, vocoder_cfg=hg_cfg)
        for event in s.stream("Hello world."):
            if event.audio is not None:
                playback.write(event.audio)

    ``vocoder=None`` streams postnet mel frames only. ``fused`` (on unless
    the model is quantized) decodes through the chunk kernels.
    """

    def __init__(self, model: Union[tacotron2.Tacotron2,
                                    Mapping[str, torch.Tensor]],
                 config: Tacotron2Config, *,
                 vocoder: Optional[hifigan.Generator] = None,
                 vocoder_cfg: Optional[hifigan.HiFiGANConfig] = None,
                 chunk_steps: int = 32, max_steps: Optional[int] = None,
                 deterministic: bool = True, fused: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = tacotron2.resolve_device(device)
        self.model = _as_model(model, config).to(self.device).eval()
        self.config = (config.replace(prenet_dropout_at_inference=False)
                       if deterministic else config)
        self.chunk_steps = chunk_steps
        self.max_steps = max_steps or config.max_decoder_steps
        self.vocoder = (vocoder.to(self.device).eval()
                        if vocoder is not None else None)
        if vocoder is not None and vocoder_cfg is None:
            vocoder_cfg = hifigan.HiFiGANConfig(
                n_mel_channels=config.n_mel_channels)
        self.vocoder_cfg = vocoder_cfg

        cfg = self.config
        self.C = chunk_steps * cfg.n_frames_per_step  # emission quantum
        self.P = postnet_margin_frames(cfg)
        self.M = (hifigan.receptive_field_frames(vocoder_cfg)
                  if vocoder_cfg is not None else 0)
        # offline buffer extent and fixed (clamped) window widths
        self.T_buf = self.max_steps * cfg.n_frames_per_step
        self.Wp = min(self.C + 2 * self.P, self.T_buf)
        self.Wv = min(self.C + 2 * self.M, self.T_buf)

        quantized = tacotron2.is_quantized(self.model)
        if fused is None:
            fused = not quantized
        if fused and quantized:
            raise ValueError("fused streaming needs unquantized weights")
        self._fused = fused
        kdtype = cfg.torch_compute_dtype
        if fused:
            db.require_bf16(kdtype, self.device)
        self._cd = None if kdtype == torch.float32 else kdtype
        self._packed = (ds.pack_decoder_params(self.model, kdtype)
                        if fused else None)
        self._packed_batch = None  # lazy (kernels/decoder_batch layout)
        self._packed_lstm = tacotron2.pack_encoder_lstm(self.model, kdtype)

    # ------------------------------------------------------------ pieces

    def _encode(self, text: np.ndarray, lengths: torch.Tensor):
        cfg = self.config
        memory = tacotron2.encode(
            self.model, torch.from_numpy(text).to(self.device), lengths, cfg,
            compute_dtype=self._cd, packed_lstm=self._packed_lstm)
        processed = tacotron2.processed_memory_of(self.model, memory,
                                                  self._cd)
        mask = length_mask(lengths, memory.shape[1])
        return memory, processed, mask, tacotron2.init_stream_carry(memory,
                                                                    cfg)

    def _keep_masks(self, B: int, generator):
        if generator is None or not self.config.prenet_dropout_at_inference:
            return None
        shape = (self.chunk_steps, B, self.config.prenet_dim)
        return tuple(torch.rand(shape, generator=generator,
                                device=self.device) < 0.5 for _ in range(2))

    def _chunk(self, carry, memory, processed, mask, generator):
        """One decoder chunk of a single utterance."""
        cfg, K = self.config, self.chunk_steps
        if self._fused:
            return ds.decode_chunk_fused(
                self._packed, carry, memory, processed, mask, cfg,
                chunk_steps=K, keep_masks=self._keep_masks(1, generator))
        return tacotron2.decode_chunk(
            self.model, carry, memory, processed, mask, cfg, chunk_steps=K,
            generator=generator, compute_dtype=self._cd)

    def _batch_chunk(self, carry, memory, processed, mask, generator):
        """One decoder chunk of B concurrent utterances: the batched chunk
        kernel when fused, else the (already batched) plain decode_chunk."""
        cfg, K = self.config, self.chunk_steps
        if self._fused:
            if self._packed_batch is None:
                self._packed_batch = db.pack_batch_decoder_params(
                    self.model, cfg.torch_compute_dtype)
            return db.decode_chunk_batch(
                self._packed_batch, carry, memory, processed, mask, cfg,
                chunk_steps=K,
                keep_masks=self._keep_masks(memory.shape[0], generator))
        return tacotron2.decode_chunk(
            self.model, carry, memory, processed, mask, cfg, chunk_steps=K,
            generator=generator, compute_dtype=self._cd)

    def _postnet(self, mel: torch.Tensor) -> torch.Tensor:
        return mel + tacotron2.postnet_apply(self.model, mel, self.config,
                                             compute_dtype=self._cd)

    def _vocode(self, mel: torch.Tensor) -> torch.Tensor:
        return hifigan.generator(self.vocoder, mel, self.vocoder_cfg)

    def _hop(self) -> int:
        # samples per mel frame = the vocoder's total upsampling factor
        return (self.vocoder_cfg.hop_length if self.vocoder_cfg is not None
                else self.config.hop_length)

    # -------------------------------------------------------------- API

    @torch.no_grad()
    def stream(self, text: str,
               generator: Optional[torch.Generator] = None
               ) -> Iterator[StreamEvent]:
        """Yield StreamEvents for one utterance. The concatenated outputs
        equal the offline ``tacotron2.infer_fused`` (or ``infer``) +
        ``hifigan.generator`` pipeline to the module's stated tolerance."""
        cfg = self.config
        r = cfg.n_frames_per_step
        n_mels = cfg.n_mel_channels
        C, P, M = self.C, self.P, self.M
        T_buf, Wp, Wv = self.T_buf, self.Wp, self.Wv
        hop = self._hop()
        dev = self.device

        ids = text_to_sequence(text, cfg.text_cleaners)
        bucket = text_bucket(len(ids), cfg.text_buckets)
        text_arr = np.zeros((1, bucket), np.int64)
        text_arr[0, :len(ids)] = ids[:bucket]
        lengths = torch.tensor([min(len(ids), bucket)], dtype=torch.int32,
                               device=dev)
        memory, processed, mask, carry = self._encode(text_arr, lengths)

        n_chunks = -(-self.max_steps // self.chunk_steps)
        cap_frames = n_chunks * C
        raw = torch.zeros(cap_frames, n_mels, device=dev)
        post = torch.zeros(cap_frames, n_mels, device=dev)

        n_avail = 0           # raw decoder frames produced
        n_total: Optional[int] = None  # final frame count (known when done)
        e = 0                 # postnet frames emitted
        v = 0                 # vocoded frames emitted
        decoding = True
        vocode = self.vocoder is not None

        def finished_all() -> bool:
            return (n_total is not None and e >= n_total
                    and (not vocode or v >= n_total))

        while True:
            if decoding:
                carry, (mel, _, _) = self._chunk(carry, memory, processed,
                                                 mask, generator)
                raw[n_avail:n_avail + C] = mel[0]
                n_avail += C
                if bool(carry.finished[0]) or n_avail >= self.max_steps * r:
                    decoding = False
                    # clamp to the offline cap (chunks may overshoot when
                    # max_steps is not a multiple of chunk_steps)
                    n_total = min(int(carry.lengths[0]), self.max_steps) * r
                    # frames past the cap exist in the buffer when the gate
                    # never fired; offline they'd be zero 'SAME' padding
                    raw[n_total:] = 0.0

            # postnet: emit frames [e, e+C) once raw context through
            # min(T_buf, e+C+P) exists (done => trailing zeros are final)
            while (e + C + P <= n_avail) or (n_total is not None
                                             and e < n_total):
                s = _clamp_window(e - P, Wp, T_buf)
                out = self._postnet(raw[None, s:s + Wp])[0]
                n_emit = C if n_total is None else min(C, n_total - e)
                post[e:e + n_emit] = out[e - s:e - s + n_emit]
                ev_mel = post[e:e + n_emit].cpu().numpy()
                e += n_emit
                yield StreamEvent(mel=ev_mel, audio=None,
                                  mel_offset=e - n_emit,
                                  done=finished_all())
                if n_total is not None and e >= n_total:
                    break

            # vocoder: emit frames [v, v+C) once postnet context through
            # min(T_buf, v+C+M) exists
            while vocode and (
                    (v + C + M <= e) or
                    (n_total is not None and e >= n_total and v < n_total)):
                s = _clamp_window(v - M, Wv, T_buf)
                audio = self._vocode(post[None, s:s + Wv])
                n_emit = C if n_total is None else min(C, n_total - v)
                samples = audio[0, (v - s) * hop:(v - s + n_emit) * hop]
                samples = samples.cpu().numpy()
                v += n_emit
                yield StreamEvent(mel=None, audio=samples,
                                  mel_offset=v - n_emit,
                                  done=finished_all())
                if n_total is not None and v >= n_total:
                    break

            if finished_all():
                return

    @torch.no_grad()
    def stream_batch(self, texts: Sequence[str],
                     generator: Optional[torch.Generator] = None
                     ) -> Iterator[tuple]:
        """Stream up to 8 concurrent utterances in lockstep; yields
        ``(row, StreamEvent)`` pairs. Decoding runs through the batched
        chunk kernel when fused, and postnet and vocoder windows run
        batched over the rows; each row's emitted frames and samples equal
        its offline pipeline output (the clamped-window argument of
        ``stream``). Rows that gate-latch early stop emitting but ride the
        batch until every row finishes (inherent to lockstep batching)."""
        cfg = self.config
        B = len(texts)
        if not 1 <= B <= 8:
            raise ValueError("stream_batch covers 1..8 texts")
        r = cfg.n_frames_per_step
        n_mels = cfg.n_mel_channels
        C, P, M = self.C, self.P, self.M
        T_buf, Wp, Wv = self.T_buf, self.Wp, self.Wv
        hop = self._hop()
        dev = self.device

        ids_list = [text_to_sequence(t, cfg.text_cleaners) for t in texts]
        bucket = max(text_bucket(len(i), cfg.text_buckets)
                     for i in ids_list)
        text_arr = np.zeros((B, bucket), np.int64)
        for i, ids in enumerate(ids_list):
            text_arr[i, :len(ids)] = ids[:bucket]
        lengths = torch.tensor([min(len(i), bucket) for i in ids_list],
                               dtype=torch.int32, device=dev)
        memory, processed, mask, carry = self._encode(text_arr, lengths)

        n_chunks = -(-self.max_steps // self.chunk_steps)
        cap_frames = n_chunks * C
        raw = torch.zeros(B, cap_frames, n_mels, device=dev)
        post = torch.zeros(B, cap_frames, n_mels, device=dev)

        n_avail = 0
        # per-row final frame count; UNKNOWN until the row's gate latches
        # (or the step cap ends decoding for everyone)
        UNKNOWN = np.iinfo(np.int64).max
        limit = np.full((B,), UNKNOWN, np.int64)
        e = v = 0             # frames emitted (lockstep counters)
        decoding = True
        vocode = self.vocoder is not None

        def all_known() -> bool:
            return bool((limit != UNKNOWN).all())

        def finished_all() -> bool:
            return (all_known() and e >= limit.max()
                    and (not vocode or v >= limit.max()))

        while True:
            if decoding:
                carry, (mel, _, _) = self._batch_chunk(
                    carry, memory, processed, mask, generator)
                raw[:, n_avail:n_avail + C] = mel
                n_avail += C
                fin = carry.finished.cpu().numpy()
                lens = carry.lengths.cpu().numpy().astype(np.int64)
                limit = np.where(fin,
                                 np.minimum(lens, self.max_steps) * r,
                                 limit)
                if bool(fin.all()) or n_avail >= self.max_steps * r:
                    decoding = False
                    limit = np.minimum(lens, self.max_steps) * r
                    for b in range(B):
                        # gate-never-fired rows: frames past the cap are
                        # zero 'SAME' padding offline
                        raw[b, limit[b]:] = 0.0

            while (e + C + P <= n_avail) or (not decoding
                                             and e < limit.max()):
                s = _clamp_window(e - P, Wp, T_buf)
                out = self._postnet(raw[:, s:s + Wp])
                for b in range(B):
                    n_emit = int(min(C, max(limit[b] - e, 0),
                                     cap_frames - e))
                    if n_emit <= 0:
                        continue
                    post[b, e:e + n_emit] = out[b, e - s:e - s + n_emit]
                    done_b = (limit[b] != UNKNOWN
                              and e + n_emit >= limit[b]
                              and not vocode)
                    yield b, StreamEvent(
                        mel=post[b, e:e + n_emit].cpu().numpy(), audio=None,
                        mel_offset=e, done=done_b)
                e += C
                if not decoding and e >= limit.max():
                    break

            while vocode and (
                    (v + C + M <= e) or
                    (not decoding and e >= limit.max()
                     and v < limit.max())):
                s = _clamp_window(v - M, Wv, T_buf)
                audio = self._vocode(post[:, s:s + Wv])
                for b in range(B):
                    n_emit = int(min(C, max(limit[b] - v, 0),
                                     cap_frames - v))
                    if n_emit <= 0:
                        continue
                    samples = audio[b, (v - s) * hop:
                                    (v - s + n_emit) * hop].cpu().numpy()
                    done_b = (limit[b] != UNKNOWN
                              and v + n_emit >= limit[b])
                    yield b, StreamEvent(mel=None, audio=samples,
                                         mel_offset=v, done=done_b)
                v += C
                if not decoding and v >= limit.max():
                    break

            if finished_all():
                return
