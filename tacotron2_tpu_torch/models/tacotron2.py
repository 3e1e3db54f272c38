"""Tacotron 2 in PyTorch: the modules and the serving-path functions.

The modules carry the reference's names (reference model.py), so the
state_dict keys are exactly those of the JAX package's
``convert.export_state_dict`` and one reference-format checkpoint loads
with ``load_state_dict(strict=True)``. The functions mirror the JAX
package's ``models/tacotron2.py`` one by one, taking the module where JAX
takes its params pytree; activations keep its channels-last ``(B, T, C)``
layout and mel tensors are ``(B, T, n_mels)``.

Serving (``infer``, ``infer_batch_fused``, and for one utterance
``infer_fused``): batchnorm runs in eval mode on
its running statistics, and dropout acts only in the prenet (reference
model.py:99), from an explicit ``torch.Generator`` or from keep masks handed
in. Training (``forward`` with ``training=True``, driven by
``training/state.py``): batchnorm on batch statistics, returning the new
running statistics as values; dropout in the encoder convs, prenet,
both decoder LSTM outputs and the postnet, drawn from one
``torch.Generator`` (none without it); the decoder core through
``models/decoder_vjp.core_scan``.

Fidelity notes (traps from the reference, all preserved):
- the BiLSTM never reads padding (packed-sequence semantics, model.py:181);
- the XLA-style decode masks attention energies at padded positions to
  -inf (model.py:79-80); the batched kernel path uses the additive -1e30
  of the TPU kernels (kernels/decoder_batch.py);
- masked outputs: mel -> 0, gate energy -> 1e3 past each row's mel length
  (model.py:487-497).
"""

from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import decoder_step as ds
from tacotron2_tpu_torch.kernels import encoder_lstm
from tacotron2_tpu_torch.kernels import train_scan
from tacotron2_tpu_torch.models import decoder_vjp
from tacotron2_tpu_torch.ops import initializers as init
from tacotron2_tpu_torch.ops.layers import (batchnorm, batchnorm_train, conv1d,
                                            dense, dropout, length_mask)
from tacotron2_tpu_torch.ops.lstm import (LSTMWeights, QuantizedLSTMCell,
                                          bilstm, lstm_cell, lstm_weights)

MASKED_GATE_ENERGY = 1e3  # reference model.py:495


# ======================================================================
# Modules (reference model.py / layers.py names)
# ======================================================================

class LinearNorm(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim, bias=bias)


class ConvNorm(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=bias)


def _conv_bn(in_ch: int, out_ch: int, k: int) -> nn.Sequential:
    return nn.Sequential(ConvNorm(in_ch, out_ch, k), nn.BatchNorm1d(out_ch))


class Encoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        e = cfg.encoder_embedding_dim
        self.convolutions = nn.ModuleList(
            [_conv_bn(e, e, cfg.encoder_kernel_size)
             for _ in range(cfg.encoder_n_convolutions)])
        self.lstm = nn.LSTM(e, e // 2, 1, batch_first=True,
                            bidirectional=True)


class Prenet(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList([LinearNorm(in_dim, dim, bias=False),
                                     LinearNorm(dim, dim, bias=False)])


class LocationLayer(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int, att_dim: int):
        super().__init__()
        self.location_conv = ConvNorm(2, n_filters, kernel_size, bias=False)
        self.location_dense = LinearNorm(n_filters, att_dim, bias=False)


class Attention(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        datt = cfg.attention_dim
        self.query_layer = LinearNorm(cfg.attention_rnn_dim, datt, bias=False)
        self.memory_layer = LinearNorm(cfg.encoder_embedding_dim, datt,
                                       bias=False)
        self.v = LinearNorm(datt, 1, bias=False)
        self.location_layer = LocationLayer(
            cfg.attention_location_n_filters,
            cfg.attention_location_kernel_size, datt)


class Decoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        e, a, d = (cfg.encoder_embedding_dim, cfg.attention_rnn_dim,
                   cfg.decoder_rnn_dim)
        n = cfg.n_mel_channels * cfg.n_frames_per_step
        self.prenet = Prenet(n, cfg.prenet_dim)
        self.attention_rnn = nn.LSTMCell(cfg.prenet_dim + e, a)
        self.attention_layer = Attention(cfg)
        self.decoder_rnn = nn.LSTMCell(a + e, d)
        self.linear_projection = LinearNorm(d + e, n)
        self.gate_layer = LinearNorm(d + e, 1)


class Postnet(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        m, p, k = (cfg.n_mel_channels, cfg.postnet_embedding_dim,
                   cfg.postnet_kernel_size)
        n = cfg.postnet_n_convolutions
        chans = [m] + [p] * (n - 1) + [m]
        self.convolutions = nn.ModuleList(
            [_conv_bn(chans[i], chans[i + 1], k) for i in range(n)])


class Tacotron2(nn.Module):
    """The reference module tree; ``init_params`` draws the reference's
    initialisation from a ``torch.Generator``. For serving (the default)
    the parameters take no gradient; ``trainable=True`` leaves them
    trainable, for ``training/state.py``."""

    def __init__(self, cfg: Tacotron2Config,
                 generator: Optional[torch.Generator] = None,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.n_symbols,
                                      cfg.symbols_embedding_dim)
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.postnet = Postnet(cfg)
        self.init_params(generator)
        self.eval()  # batchnorm mode is chosen per call, never by the module
        self.requires_grad_(trainable)

    @torch.no_grad()  # the parameters require grad until __init__ ends
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> None:
        """Reference init: Xavier-uniform with per-layer gains, the scaled
        embedding init, torch's LSTM default, zero biases and unit/zero
        batchnorm with fresh running statistics."""
        cfg, g = self.cfg, generator
        self.embedding.weight.copy_(init.embedding_init(
            cfg.n_symbols, cfg.symbols_embedding_dim, g))

        def conv_bn(seq: nn.Sequential, gain: str) -> None:
            conv = seq[0].conv
            out_ch, in_ch, k = conv.weight.shape
            conv.weight.copy_(init.conv1d_init(k, in_ch, out_ch, gain, g))
            conv.bias.zero_()
            seq[1].reset_parameters()

        def linear(mod: LinearNorm, gain: str = "linear") -> None:
            lin = mod.linear_layer
            out_dim, in_dim = lin.weight.shape
            lin.weight.copy_(init.dense_init(in_dim, out_dim, gain, g))
            if lin.bias is not None:
                lin.bias.zero_()

        def lstm(mod: nn.Module, suffix: str = "") -> None:
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                p = getattr(mod, name + suffix)
                p.copy_(init.lstm_uniform(p.shape, mod.hidden_size, g))

        for seq in self.encoder.convolutions:
            conv_bn(seq, "relu")
        lstm(self.encoder.lstm, "_l0")
        lstm(self.encoder.lstm, "_l0_reverse")
        dec = self.decoder
        for layer in dec.prenet.layers:
            linear(layer)
        lstm(dec.attention_rnn)
        att = dec.attention_layer
        linear(att.query_layer, "tanh")
        linear(att.memory_layer, "tanh")
        linear(att.v)
        loc = att.location_layer.location_conv.conv
        out_ch, in_ch, k = loc.weight.shape
        loc.weight.copy_(init.conv1d_init(k, in_ch, out_ch, "linear", g))
        linear(att.location_layer.location_dense, "tanh")
        lstm(dec.decoder_rnn)
        linear(dec.linear_projection)
        linear(dec.gate_layer, "sigmoid")
        convs = self.postnet.convolutions
        for i, seq in enumerate(convs):
            conv_bn(seq, "tanh" if i < len(convs) - 1 else "linear")


def _w(layer: LinearNorm) -> torch.Tensor:
    return layer.linear_layer.weight


def _b(layer: LinearNorm) -> Optional[torch.Tensor]:
    return layer.linear_layer.bias


Stats = Dict[str, torch.Tensor]


def bn_stats(model: Tacotron2) -> Stats:
    """Copies of every batchnorm's running statistics, by state_dict name
    (``...running_mean``/``...running_var``): the ``stats`` that the
    training forms read and return as values."""
    return {f"{name}.{k}": getattr(mod, k).detach().clone()
            for name, mod in model.named_modules()
            if isinstance(mod, nn.BatchNorm1d)
            for k in ("running_mean", "running_var")}


def _conv_bn_apply(seq: nn.Sequential, prefix: str, x: torch.Tensor,
                   stats: Optional[Stats], new_stats: Stats, training: bool,
                   compute_dtype, bn_group=None) -> torch.Tensor:
    """conv -> batchnorm, on the running statistics (``stats`` by the
    batchnorm's state_dict ``prefix``, the module's buffers when None) or,
    in training, on the batch statistics, with the new running estimates
    put into ``new_stats``; the result in the compute dtype. ``bn_group``
    syncs the batch statistics over a data-parallel process group
    (``ops/layers.batchnorm_train``)."""
    conv, bn = seq[0].conv, seq[1]
    x = conv1d(x, conv.weight, conv.bias, compute_dtype)
    if stats is None:
        mean, var = bn.running_mean, bn.running_var
    else:
        mean = stats[f"{prefix}.running_mean"]
        var = stats[f"{prefix}.running_var"]
    if training:
        x, new_stats[f"{prefix}.running_mean"], \
            new_stats[f"{prefix}.running_var"] = batchnorm_train(
                x, mean, var, bn.weight, bn.bias, bn.momentum, bn.eps,
                group=bn_group)
    else:
        x = batchnorm(x, mean, var, bn.weight, bn.bias, bn.eps)
    return x.to(compute_dtype) if compute_dtype is not None else x


def _drop(x, generator, training: bool):
    return dropout(x, 0.5, generator=generator,
                   deterministic=not training or generator is None)


# ======================================================================
# Encoder
# ======================================================================

def encoder_lstm_weights(model: Tacotron2) -> Tuple[LSTMWeights, LSTMWeights]:
    lstm = model.encoder.lstm
    return lstm_weights(lstm, "_l0"), lstm_weights(lstm, "_l0_reverse")


def pack_encoder_lstm(model: Tacotron2, dtype: torch.dtype
                      ) -> encoder_lstm.PackedBiLSTM:
    """The encoder BiLSTM's weights as its kernel takes them, for reuse
    across ``encode`` calls (``packed_lstm``)."""
    return encoder_lstm.pack_bilstm(*encoder_lstm_weights(model), dtype)


def encode(model: Tacotron2, text: torch.Tensor, text_lengths: torch.Tensor,
           cfg: Tacotron2Config, *, compute_dtype=None,
           packed_lstm: Optional[encoder_lstm.PackedBiLSTM] = None,
           stats: Optional[Stats] = None, training: bool = False,
           generator: Optional[torch.Generator] = None, bn_group=None):
    """text (B, T_in) int -> encoder memory (B, T_in, e) fp32.

    3x [conv5 -> batchnorm -> relu -> dropout(0.5)] then the length-aware,
    differentiable BiLSTM (reference Encoder, model.py:149-201; the JAX
    package's ``encode``). Serving (the default): batchnorm on ``stats``
    (the module's running statistics when None), no dropout; returns the
    memory. ``training=True``: batchnorm on the batch statistics, dropout
    from ``generator`` (none without one); returns (memory, the new running
    statistics). ``packed_lstm`` is ``pack_encoder_lstm(model,
    compute_dtype or float32)``, packed here if omitted."""
    x = model.embedding.weight[text.long()]
    new_stats: Stats = {}
    for i, seq in enumerate(model.encoder.convolutions):
        x = _conv_bn_apply(seq, f"encoder.convolutions.{i}.1", x, stats,
                           new_stats, training, compute_dtype, bn_group)
        x = _drop(torch.relu(x), generator, training)
    memory = bilstm(*encoder_lstm_weights(model), x, text_lengths,
                    compute_dtype=compute_dtype, packed=packed_lstm)
    return (memory, new_stats) if training else memory


# ======================================================================
# Decoder
# ======================================================================

class DecoderState(NamedTuple):
    """The decoder's recurrent state (reference model.py:270-289)."""
    att_h: torch.Tensor       # (B, attention_rnn_dim)
    att_c: torch.Tensor
    dec_h: torch.Tensor       # (B, decoder_rnn_dim)
    dec_c: torch.Tensor
    att_weights: torch.Tensor      # (B, T_in)
    att_weights_cum: torch.Tensor  # (B, T_in)
    att_context: torch.Tensor      # (B, encoder_embedding_dim)


def init_decoder_state(memory: torch.Tensor,
                       cfg: Tacotron2Config) -> DecoderState:
    B, T_in, e = memory.shape
    z = lambda *shape: torch.zeros(*shape, device=memory.device)
    return DecoderState(z(B, cfg.attention_rnn_dim), z(B, cfg.attention_rnn_dim),
                        z(B, cfg.decoder_rnn_dim), z(B, cfg.decoder_rnn_dim),
                        z(B, T_in), z(B, T_in), z(B, e))


def prenet_apply(model: Tacotron2, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = False,
                 compute_dtype=None) -> torch.Tensor:
    """2x [dense -> relu -> dropout(0.5)], dropout active by default even at
    inference (reference model.py:99), drawn from ``generator``."""
    for layer in model.decoder.prenet.layers:
        x = torch.relu(dense(x, _w(layer), compute_dtype=compute_dtype))
        x = dropout(x, 0.5, generator=generator,
                    deterministic=deterministic or generator is None)
    return x


def _attention_energies(model: Tacotron2, att_hidden: torch.Tensor,
                        processed_memory: torch.Tensor,
                        att_weights: torch.Tensor,
                        att_weights_cum: torch.Tensor,
                        compute_dtype=None) -> torch.Tensor:
    """energies = v . tanh(W_q q + W_loc conv([w; w_cum]) + W_m memory)
    (reference model.py:43-63), fp32 (B, T_in)."""
    att = model.decoder.attention_layer
    loc_layer = att.location_layer
    cat = torch.stack([att_weights, att_weights_cum], dim=-1)
    loc = conv1d(cat, loc_layer.location_conv.conv.weight,
                 compute_dtype=compute_dtype)
    loc = dense(loc, _w(loc_layer.location_dense), compute_dtype=compute_dtype)
    query = dense(att_hidden, _w(att.query_layer),
                  compute_dtype=compute_dtype)[:, None, :]
    energies = dense(torch.tanh(query + loc + processed_memory), _w(att.v),
                     compute_dtype=compute_dtype)[..., 0]
    return energies.float()


def _attention_weights(model: Tacotron2, att_hidden, processed_memory,
                       att_weights, att_weights_cum,
                       mask: Optional[torch.Tensor],
                       compute_dtype=None) -> torch.Tensor:
    """Masked softmax over the energies (reference model.py:79-81:
    masked_fill(-inf) then softmax)."""
    energies = _attention_energies(model, att_hidden, processed_memory,
                                   att_weights, att_weights_cum,
                                   compute_dtype)
    if mask is not None:
        energies = energies.masked_fill(~mask, float("-inf"))
    return torch.softmax(energies, dim=1)


def _attention(model: Tacotron2, att_hidden, memory, processed_memory,
               att_weights, att_weights_cum, mask,
               compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Location-sensitive additive attention (reference model.py:29-86)."""
    weights = _attention_weights(model, att_hidden, processed_memory,
                                 att_weights, att_weights_cum, mask,
                                 compute_dtype)
    if compute_dtype is not None:
        # operands rounded to the compute dtype, fp32 sums
        weights_c = weights.to(compute_dtype).float()
        memory_c = memory.to(compute_dtype).float()
    else:
        weights_c, memory_c = weights, memory.float()
    context = torch.einsum("bt,bte->be", weights_c, memory_c)
    return context, weights


def decoder_core(model: Tacotron2, state: DecoderState,
                 prenet_out: torch.Tensor, memory: torch.Tensor,
                 processed_memory: torch.Tensor,
                 mask: Optional[torch.Tensor], cfg: Tacotron2Config, *,
                 compute_dtype=None,
                 keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> DecoderState:
    """The sequential part of one decoder frame (reference Decoder.decode,
    model.py:340-379 minus the heads): attention LSTM -> attention ->
    decoder LSTM. ``keep`` holds the step's keep masks of the two
    LSTM-output dropouts (training); None runs without them."""
    dec = model.decoder
    cell_input = torch.cat([prenet_out.float(), state.att_context], dim=-1)
    att_h, att_c = lstm_cell(lstm_weights(dec.attention_rnn), cell_input,
                             (state.att_h, state.att_c), compute_dtype)
    if keep is not None:
        att_h = dropout(att_h, cfg.p_attention_dropout, keep=keep[0])
    att_context, att_weights = _attention(
        model, att_h, memory, processed_memory, state.att_weights,
        state.att_weights_cum, mask, compute_dtype)
    att_weights_cum = state.att_weights_cum + att_weights
    dec_input = torch.cat([att_h, att_context], dim=-1)
    dec_h, dec_c = lstm_cell(lstm_weights(dec.decoder_rnn), dec_input,
                             (state.dec_h, state.dec_c), compute_dtype)
    if keep is not None:
        dec_h = dropout(dec_h, cfg.p_decoder_dropout, keep=keep[1])
    return DecoderState(att_h, att_c, dec_h, dec_c, att_weights,
                        att_weights_cum, att_context)


def decoder_head(model: Tacotron2, dec_h: torch.Tensor,
                 att_context: torch.Tensor, compute_dtype=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mel projection + stop gate (reference model.py:373-378)."""
    dec = model.decoder
    x = torch.cat([dec_h.float(), att_context.float()], dim=-1)
    mel = dense(x, _w(dec.linear_projection), _b(dec.linear_projection),
                compute_dtype)
    gate = dense(x, _w(dec.gate_layer), _b(dec.gate_layer),
                 compute_dtype)[..., 0]
    return mel, gate


def decoder_step(model: Tacotron2, state: DecoderState,
                 prenet_out: torch.Tensor, memory: torch.Tensor,
                 processed_memory: torch.Tensor,
                 mask: Optional[torch.Tensor], cfg: Tacotron2Config, *,
                 compute_dtype=None):
    """One full autoregressive frame: core + output heads."""
    new = decoder_core(model, state, prenet_out, memory, processed_memory,
                       mask, cfg, compute_dtype=compute_dtype)
    mel, gate = decoder_head(model, new.dec_h, new.att_context,
                             compute_dtype)
    return new, (mel, gate, new.att_weights)


def processed_memory_of(model: Tacotron2, memory: torch.Tensor,
                        compute_dtype) -> torch.Tensor:
    """The attention's memory projection W_m memory (B, T_in, datt),
    computed once per utterance, outside the decoder loop."""
    return dense(memory, _w(model.decoder.attention_layer.memory_layer),
                 compute_dtype=compute_dtype)


class InferenceResult(NamedTuple):
    mel: torch.Tensor          # (B, T, n_mels) decoder output
    mel_postnet: torch.Tensor  # (B, T, n_mels) decoder + postnet residual
    gate_energies: torch.Tensor  # (B, T)
    alignments: torch.Tensor   # (B, T, T_in)
    mel_lengths: torch.Tensor  # (B,) frames produced per row


class StreamCarry(NamedTuple):
    """Resumable autoregressive decoder state for chunked decoding."""
    t: int                    # decoder steps taken so far
    state: DecoderState
    prev_mel: torch.Tensor    # (B, n_mels * r) last raw frame group
    finished: torch.Tensor    # (B,) bool per-row gate latch
    lengths: torch.Tensor     # (B,) int32 decoder steps per row


def init_stream_carry(memory: torch.Tensor,
                      cfg: Tacotron2Config) -> StreamCarry:
    B = memory.shape[0]
    n = cfg.n_mel_channels * cfg.n_frames_per_step
    dev = memory.device
    return StreamCarry(
        t=0, state=init_decoder_state(memory, cfg),
        prev_mel=torch.zeros(B, n, device=dev),
        finished=torch.zeros(B, dtype=torch.bool, device=dev),
        lengths=torch.zeros(B, dtype=torch.int32, device=dev))


def _step_frame(model, carry: StreamCarry, memory, processed_memory, mask,
                cfg, generator, compute_dtype):
    """One step of ``decode_chunk``/``decode_autoregressive``: outputs
    masked for rows already finished, then the latch. ``carry.t`` is an int
    or, inside a captured chunk, a 0-dim int32 tensor on the device."""
    deterministic = not cfg.prenet_dropout_at_inference or generator is None
    prenet_out = prenet_apply(model, carry.prev_mel, generator,
                              deterministic=deterministic,
                              compute_dtype=compute_dtype)
    state, (mel, gate, align) = decoder_step(
        model, carry.state, prenet_out, memory, processed_memory, mask, cfg,
        compute_dtype=compute_dtype)
    fin = carry.finished
    mel_out = torch.where(fin[:, None], 0.0, mel)
    gate_out = torch.where(fin, MASKED_GATE_ENERGY, gate)
    align_out = torch.where(fin[:, None], 0.0, align)
    # reference semantics: the crossing frame IS emitted, then stop
    t1 = (torch.full_like(carry.lengths, carry.t + 1)
          if isinstance(carry.t, int) else carry.t + 1)
    lengths = torch.where(fin, carry.lengths, t1)
    finished = fin | (torch.sigmoid(gate) > cfg.gate_threshold)
    new = StreamCarry(carry.t + 1, state, mel.float(), finished, lengths)
    return new, (mel_out, gate_out, align_out)


def _steps(model, carry: StreamCarry, memory, processed_memory, mask, cfg,
           generator, compute_dtype, steps: int):
    """``steps`` plain decoder steps from ``carry``: (the new carry,
    time-major (mel (steps, B, n_mels*r), gate (steps, B), align (steps, B,
    T_in)))."""
    outs = []
    for _ in range(steps):
        carry, out = _step_frame(model, carry, memory, processed_memory,
                                 mask, cfg, generator, compute_dtype)
        outs.append(out)
    return carry, tuple(torch.stack(x) for x in zip(*outs))


def _ungroup(mels, gates, aligns, B, cfg):
    """(steps, B, n_mels*r) stacks -> per-frame (B, steps*r, ...)."""
    r = cfg.n_frames_per_step
    steps = mels.shape[0]
    mel = mels.transpose(0, 1).reshape(B, steps * r, cfg.n_mel_channels)
    gate = gates.transpose(0, 1).repeat_interleave(r, dim=1)
    align = aligns.transpose(0, 1).repeat_interleave(r, dim=1)
    return mel, gate, align


# ---------------------------------------------- the step loop as CUDA graphs

class _StaticIO:
    """The buffers a captured chunk reads and writes: the attention inputs
    and the carry (the step index as a 0-dim int32 tensor), and a generator
    of the chunk's own for the prenet's dropout, registered with its graphs;
    the caller's generator state goes into it before a replay and comes back
    after. One decode at a time holds them (``held``)."""

    def __init__(self, memory, processed_memory, mask, cfg, dropout: bool):
        dev = memory.device
        self.memory = memory.clone()
        self.processed = processed_memory.clone()
        self.mask = mask.clone() if mask is not None else None
        c = init_stream_carry(memory, cfg)
        self.carry = c._replace(t=torch.zeros((), dtype=torch.int32,
                                              device=dev))
        self.gen = torch.Generator(device=dev) if dropout else None
        self.graphs: Dict[int, "_CapturedSteps"] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()

    @contextlib.contextmanager
    def held(self):
        """The buffers for one decode, from loading its inputs to copying
        out its outputs: another thread waits for the lock, and another
        stream for the work queued while it was held."""
        with self.lock:
            stream = torch.cuda.current_stream(self.memory.device)
            stream.wait_event(self.done)
            try:
                yield
            finally:
                self.done.record(stream)

    def tensors(self, carry: StreamCarry) -> Tuple[torch.Tensor, ...]:
        return (carry.t, *carry.state, carry.prev_mel, carry.finished,
                carry.lengths)

    def store(self, carry: StreamCarry) -> None:
        """Copy ``carry`` (an int ``t`` or a tensor) into the buffers."""
        if isinstance(carry.t, int):
            self.carry.t.fill_(carry.t)
            carry = carry._replace(t=self.carry.t)
        for dst, src in zip(self.tensors(self.carry), self.tensors(carry)):
            if src is not dst:
                dst.copy_(src)

    def load(self, memory, processed_memory, mask) -> None:
        self.memory.copy_(memory)
        self.processed.copy_(processed_memory)
        if mask is not None:
            self.mask.copy_(mask)


class _CapturedSteps:
    """``steps`` decoder steps of one model captured as one CUDA graph over
    a ``_StaticIO``: a replay reads the carry from the buffers, writes each
    step's masked outputs into ``out`` (time-major) and the new carry back
    into the buffers, so that the next replay goes on from it. Warmed up
    once on a side stream first (cuBLAS, cuDNN and the kernels' libraries
    load outside the capture); the buffers' carry is kept across that."""

    def __init__(self, model, cfg, io: _StaticIO, steps: int, compute_dtype):
        self.io = io
        run = lambda: self._run(model, cfg, steps, compute_dtype)
        saved = [t.clone() for t in io.tensors(io.carry)]
        side = torch.cuda.Stream(io.memory.device)
        side.wait_stream(torch.cuda.current_stream(io.memory.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(io.memory.device).wait_stream(side)
        for dst, src in zip(io.tensors(io.carry), saved):
            dst.copy_(src)
        self.graph = torch.cuda.CUDAGraph()
        if io.gen is not None:
            self.graph.register_generator_state(io.gen)
        with torch.cuda.graph(self.graph, pool=io.pool,
                              capture_error_mode="thread_local"):
            self.out = run()

    def _run(self, model, cfg, steps, compute_dtype):
        io = self.io
        carry, out = _steps(model, io.carry, io.memory, io.processed,
                            io.mask, cfg, io.gen, compute_dtype, steps)
        io.store(carry)
        return out

    def replay(self, generator: Optional[torch.Generator]):
        gen = self.io.gen
        if gen is not None:
            gen.set_state(generator.get_state())
        self.graph.replay()
        if gen is not None:
            generator.set_state(gen.get_state())
        return self.out


# per model: {(shapes and dtypes of the inputs, dropout, the addresses of
# the decoder's weights): _StaticIO}; _LOCK guards it and serialises
# captures
_CAPTURED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LOCK = threading.Lock()


def _decoder_weights_key(model: Tacotron2) -> Tuple[int, ...]:
    """The addresses of every tensor a decoder step reads (the int8 cells'
    packed copies made first): a graph holds them, so a model whose
    weights moved or were repacked needs new graphs."""
    dec = model.decoder
    for cell in (dec.attention_rnn, dec.decoder_rnn):
        if isinstance(cell, QuantizedLSTMCell):
            cell.packed()
    return tuple(t.data_ptr() for t in (*dec.parameters(), *dec.buffers()))


def _static_io(model, memory, processed_memory, mask, cfg, generator,
               compute_dtype) -> _StaticIO:
    dropout = generator is not None and cfg.prenet_dropout_at_inference
    key = (tuple(memory.shape), memory.dtype, processed_memory.dtype,
           mask is not None, compute_dtype, dropout, repr(cfg),
           _decoder_weights_key(model))
    with _LOCK:
        per_model = _CAPTURED.setdefault(model, {})
        io = per_model.get(key)
        if io is None:
            for stale in [k for k in per_model if k[-1] != key[-1]]:
                del per_model[stale]
            io = per_model[key] = _StaticIO(memory, processed_memory, mask,
                                            cfg, dropout)
    return io


def _captured(model, io: _StaticIO, cfg, steps: int, compute_dtype
              ) -> _CapturedSteps:
    """The graph of ``steps`` steps over ``io`` (held by the caller)."""
    graph = io.graphs.get(steps)
    if graph is None:
        with _LOCK:
            graph = io.graphs[steps] = _CapturedSteps(model, cfg, io, steps,
                                                      compute_dtype)
    return graph


def decode_autoregressive(model: Tacotron2, memory: torch.Tensor,
                          memory_lengths: Optional[torch.Tensor],
                          cfg: Tacotron2Config, *,
                          generator: Optional[torch.Generator] = None,
                          max_steps: Optional[int] = None,
                          compute_dtype=None, chunk_steps: int = 64,
                          capture: bool = True):
    """Batched autoregressive inference with per-row gate stopping, in
    chunks of ``chunk_steps`` plain decoder steps (the last chunk only the
    steps left before ``max_steps``). The latch is read once a chunk: the
    loop stops after the chunk in which every row has latched, or at
    ``max_steps``; rows that finish inside a chunk are masked as each step
    masks them, so outputs are (B, max_steps*r, ...) with mel 0, gate 1e3
    and align 0 past each row's last step, plus lengths in frames, whatever
    the chunk length. On a card each chunk is the replay of a CUDA graph,
    captured once per model, input shapes and chunk length;
    ``capture=False`` runs the same chunks step by step there too (the
    comparison the graphs are held to). On the CPU they run step by step.
    """
    B, T_in, _ = memory.shape
    t_max = max_steps or cfg.max_decoder_steps
    mask = (length_mask(memory_lengths, T_in)
            if memory_lengths is not None else None)
    processed = processed_memory_of(model, memory, compute_dtype)
    n = cfg.n_mel_channels * cfg.n_frames_per_step
    dev = memory.device
    mels = torch.zeros(t_max, B, n, device=dev)
    gates = torch.full((t_max, B), MASKED_GATE_ENERGY, device=dev)
    aligns = torch.zeros(t_max, B, T_in, device=dev)
    graphs = memory.is_cuda and capture
    carry = init_stream_carry(memory, cfg)
    held = contextlib.nullcontext()
    if graphs:
        io = _static_io(model, memory, processed, mask, cfg, generator,
                        compute_dtype)
        held = io.held()
    with held:
        if graphs:
            io.load(memory, processed, mask)
            io.store(carry)
            carry = io.carry
        t = 0
        while t < t_max and not (t and bool(carry.finished.all())):
            cs = min(chunk_steps, t_max - t)
            if graphs:
                out = _captured(model, io, cfg, cs, compute_dtype).replay(
                    generator)
            else:
                carry, out = _steps(model, carry, memory, processed, mask,
                                    cfg, generator, compute_dtype, cs)
            for buf, o in zip((mels, gates, aligns), out):
                buf[t:t + cs].copy_(o)
            t += cs
        lengths = carry.lengths * cfg.n_frames_per_step
    mel, gate, align = _ungroup(mels, gates, aligns, B, cfg)
    return mel, gate, align, lengths


def decode_chunk(model: Tacotron2, carry: StreamCarry, memory: torch.Tensor,
                 processed_memory: torch.Tensor,
                 mask: Optional[torch.Tensor], cfg: Tacotron2Config, *,
                 chunk_steps: int, generator: Optional[torch.Generator] = None,
                 compute_dtype=None, capture: bool = True):
    """Run ``chunk_steps`` plain decoder steps from ``carry``. Outputs are
    masked for finished rows and per-frame: mel (B, cs*r, n_mels), gate
    (B, cs*r), align (B, cs*r, T_in). On a card the chunk is the replay of
    a CUDA graph (as in ``decode_autoregressive``; ``capture=False`` runs
    it step by step)."""
    if memory.is_cuda and capture:
        io = _static_io(model, memory, processed_memory, mask, cfg,
                        generator, compute_dtype)
        with io.held():
            io.load(memory, processed_memory, mask)
            io.store(carry)
            out = _captured(model, io, cfg, chunk_steps,
                            compute_dtype).replay(generator)
            out = tuple(o.clone() for o in out)
            c = io.carry
            new = StreamCarry(int(carry.t) + chunk_steps,
                              DecoderState(*(x.clone() for x in c.state)),
                              c.prev_mel.clone(), c.finished.clone(),
                              c.lengths.clone())
    else:
        new, out = _steps(model, carry, memory, processed_memory, mask, cfg,
                          generator, compute_dtype, chunk_steps)
    return new, _ungroup(*out, memory.shape[0], cfg)


# ======================================================================
# Postnet and outputs
# ======================================================================

def postnet_apply(model: Tacotron2, mels: torch.Tensor, cfg: Tacotron2Config,
                  *, compute_dtype=None, stats: Optional[Stats] = None,
                  training: bool = False,
                  generator: Optional[torch.Generator] = None,
                  bn_group=None):
    """5x [conv5 -> batchnorm (-> tanh) -> dropout(0.5)] (reference
    Postnet, model.py:103-146; the JAX package's ``postnet_apply``);
    returns the fp32 residual to add, or in training (residual, the new
    running statistics). Batchnorm and dropout as in ``encode``."""
    x = mels
    new_stats: Stats = {}
    convs = model.postnet.convolutions
    for i, seq in enumerate(convs):
        x = _conv_bn_apply(seq, f"postnet.convolutions.{i}.1", x, stats,
                           new_stats, training, compute_dtype, bn_group)
        if i < len(convs) - 1:
            x = torch.tanh(x)
        x = _drop(x, generator, training)
    return (x.float(), new_stats) if training else x.float()


def mask_outputs(mel: torch.Tensor, mel_postnet: torch.Tensor,
                 gate_energies: torch.Tensor, output_lengths: torch.Tensor):
    """parse_output (reference model.py:487-497): zero mels and pin gate
    energies to 1e3 past each row's mel length."""
    valid = length_mask(output_lengths, mel.shape[1])
    mel = torch.where(valid[:, :, None], mel, 0.0)
    mel_postnet = torch.where(valid[:, :, None], mel_postnet, 0.0)
    gate_energies = torch.where(valid, gate_energies, MASKED_GATE_ENERGY)
    return mel, mel_postnet, gate_energies


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU;
    raises when CUDA is asked for and no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    return device


def _on_device(model: Tacotron2, text, text_lengths, device):
    device = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != device.type:
        raise ValueError(f"the model is on {where}, not on {device}: move it "
                         f"with model.to(device) or pass device={where.type!r}")
    return text.to(where), text_lengths.to(where)


def _finish(model, mel, gate, align, lengths, cfg, compute_dtype
            ) -> InferenceResult:
    mel_postnet = mel + postnet_apply(model, mel, cfg,
                                      compute_dtype=compute_dtype)
    mel, mel_postnet, gate = mask_outputs(mel, mel_postnet, gate, lengths)
    return InferenceResult(mel, mel_postnet, gate, align, lengths)


def infer(model: Tacotron2, text: torch.Tensor, text_lengths: torch.Tensor,
          cfg: Tacotron2Config, *,
          generator: Optional[torch.Generator] = None,
          max_steps: Optional[int] = None,
          compute_dtype=None,
          device: Union[str, torch.device] = "cuda") -> InferenceResult:
    """Batched text -> mel through the plain step-by-step decoder
    (reference Tacotron2.inference, model.py:517-529, made batch-safe), in
    chunks of steps, each a CUDA graph's replay on a card
    (``decode_autoregressive``). The encoder BiLSTM still runs through its
    kernel on a CUDA device."""
    text, text_lengths = _on_device(model, text, text_lengths, device)
    memory = encode(model, text, text_lengths, cfg,
                    compute_dtype=compute_dtype)
    mel, gate, align, lengths = decode_autoregressive(
        model, memory, text_lengths, cfg, generator=generator,
        max_steps=max_steps, compute_dtype=compute_dtype)
    return _finish(model, mel, gate, align, lengths, cfg, compute_dtype)


def infer_batch_fused(model: Tacotron2, text: torch.Tensor,
                      text_lengths: torch.Tensor, cfg: Tacotron2Config, *,
                      packed: Optional[db.BatchDecoderParams] = None,
                      packed_lstm: Optional[encoder_lstm.PackedBiLSTM] = None,
                      max_steps: Optional[int] = None,
                      chunk_steps: int = 64, compute_dtype=None,
                      generator: Optional[torch.Generator] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> InferenceResult:
    """``infer`` through the batched decoder chunk (kernels/decoder_batch):
    the hand-written CUDA kernel on a CUDA model, its plain version on a
    CPU one. ``packed`` and ``packed_lstm`` are the reusable
    ``pack_batch_decoder_params`` and ``pack_encoder_lstm`` results in the
    compute dtype (built on the fly if omitted). ``generator`` with
    ``prenet_dropout_at_inference`` runs the reference's inference-time
    prenet dropout; None runs the deterministic prenet. The model must
    already be on ``device``; on a card the kernel takes bf16 alone, and
    another compute dtype raises before any work."""
    if compute_dtype is None:
        compute_dtype = cfg.torch_compute_dtype
    db.require_bf16(compute_dtype, device)
    text, text_lengths = _on_device(model, text, text_lengths, device)
    kdtype = compute_dtype
    if compute_dtype == torch.float32:
        compute_dtype = None  # full fp32, as the JAX package's None
    if packed is None:
        packed = db.pack_batch_decoder_params(model, kdtype)
    if not cfg.prenet_dropout_at_inference:
        generator = None
    memory = encode(model, text, text_lengths, cfg,
                    compute_dtype=compute_dtype, packed_lstm=packed_lstm)
    processed = processed_memory_of(model, memory, compute_dtype)
    mask = length_mask(text_lengths, memory.shape[1])
    mel, gate, align, lengths = db.decode_autoregressive_batch(
        packed, memory, processed, mask, cfg, max_steps=max_steps,
        chunk_steps=chunk_steps, generator=generator)
    return _finish(model, mel, gate, align, lengths, cfg, compute_dtype)


def infer_fused(model: Tacotron2, text: torch.Tensor,
                text_lengths: torch.Tensor, cfg: Tacotron2Config, *,
                packed: Optional[ds.FusedDecoderParams] = None,
                packed_lstm: Optional[encoder_lstm.PackedBiLSTM] = None,
                max_steps: Optional[int] = None, chunk_steps: int = 64,
                compute_dtype=None,
                generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cuda"
                ) -> InferenceResult:
    """``infer`` for one utterance (B=1) through the single-utterance
    decoder chunk (kernels/decoder_step): the hand-written CUDA kernel on a
    CUDA model, its plain version on a CPU one. ``packed`` and
    ``packed_lstm`` are the reusable ``pack_decoder_params`` and
    ``pack_encoder_lstm`` results in the compute dtype (built on the fly if
    omitted). ``generator`` with ``prenet_dropout_at_inference`` runs the
    reference's inference-time prenet dropout; None runs the deterministic
    prenet. The model must already be on ``device``; on a card the kernel
    takes bf16 alone, and another compute dtype raises before any work."""
    if text.shape[0] != 1:
        raise ValueError("the fused decode takes one utterance (B=1)")
    if compute_dtype is None:
        compute_dtype = cfg.torch_compute_dtype
    db.require_bf16(compute_dtype, device)
    text, text_lengths = _on_device(model, text, text_lengths, device)
    kdtype = compute_dtype
    if compute_dtype == torch.float32:
        compute_dtype = None  # full fp32, as the JAX package's None
    if packed is None:
        packed = ds.pack_decoder_params(model, kdtype)
    if not cfg.prenet_dropout_at_inference:
        generator = None
    memory = encode(model, text, text_lengths, cfg,
                    compute_dtype=compute_dtype, packed_lstm=packed_lstm)
    processed = processed_memory_of(model, memory, compute_dtype)
    mask = length_mask(text_lengths, memory.shape[1])
    mel, gate, align, lengths = ds.decode_autoregressive_fused(
        packed, memory, processed, mask, cfg, max_steps=max_steps,
        chunk_steps=chunk_steps, generator=generator)
    return _finish(model, mel, gate, align, lengths, cfg, compute_dtype)


def is_quantized(model: Tacotron2) -> bool:
    """Whether the decoder's LSTM cells hold int8 weights
    (``quantize_for_serving``)."""
    return isinstance(model.decoder.attention_rnn, QuantizedLSTMCell)


def quantize_for_serving(model: Tacotron2) -> Tacotron2:
    """A copy of ``model`` in its int8 weight-only serving form: the two
    decoder LSTM cells, whose weights are nearly all that a decoder step at
    B=1 reads, become ``QuantizedLSTMCell``s (state_dict keys
    ``decoder.attention_rnn.w_q``, ``.scale``, ``.bias`` and the same for
    ``decoder_rnn``); everything else, which runs once per utterance or is
    small, stays as it is. The copy goes through ``infer``,
    ``decode_autoregressive``, ``decode_chunk`` and the serving layers; the
    kernel packers and the training forms reject it (the int8 product has
    no backward)."""
    out = copy.deepcopy(model)
    for name in ("attention_rnn", "decoder_rnn"):
        cell = getattr(out.decoder, name)
        if not isinstance(cell, QuantizedLSTMCell):
            setattr(out.decoder, name,
                    QuantizedLSTMCell.from_weights(lstm_weights(cell)))
    return out


# ======================================================================
# Training forms (teacher forcing)
# ======================================================================

def decode_teacher_forced(model: Tacotron2, memory: torch.Tensor,
                          memory_lengths: torch.Tensor, mels: torch.Tensor,
                          cfg: Tacotron2Config, *, training: bool,
                          generator: Optional[torch.Generator] = None,
                          compute_dtype=None,
                          keep: Optional[train_scan.Keep] = None):
    """Teacher-forced decoding (reference Decoder.forward, model.py:381-416)
    with the reduction factor r: each step consumes the previous group of r
    target frames (a zero group first) and emits one. mels (B, T_out,
    n_mels). The prenet's dropout is on whenever there is a generator
    (model.py:99); in training the two LSTM-output dropouts draw their keep
    masks from it too, unless ``keep`` hands them in. Returns
    (mel (B, T_out, n_mels), gate (B, T_out), align (B, T_out, T_in))."""
    if is_quantized(model):
        raise ValueError("the training forms need unquantized weights: the "
                         "int8 product of quantize_for_serving has no "
                         "backward")
    B, T_out, n_mels = mels.shape
    r = cfg.n_frames_per_step
    if T_out % r:
        raise ValueError(f"T_out={T_out} not a multiple of "
                         f"n_frames_per_step={r} (pad in the collate)")
    steps = T_out // r
    grouped = mels.reshape(B, steps, n_mels * r)
    go = torch.zeros(B, 1, n_mels * r, dtype=mels.dtype, device=mels.device)
    inputs = torch.cat([go, grouped[:, :-1]], dim=1)
    prenet_out = prenet_apply(model, inputs, generator,
                              compute_dtype=compute_dtype)
    mask = length_mask(memory_lengths, memory.shape[1])
    processed = processed_memory_of(model, memory, compute_dtype)
    if not training:
        keep = None
    elif keep is None and generator is not None:
        keep = train_scan.keep_masks(generator, steps, B,
                                     cfg.attention_rnn_dim,
                                     cfg.decoder_rnn_dim,
                                     cfg.p_attention_dropout,
                                     cfg.p_decoder_dropout)
    dec_h, ctx, w = decoder_vjp.core_scan(
        model, prenet_out.transpose(0, 1), memory, processed, mask, cfg,
        keep=keep, compute_dtype=compute_dtype)
    mel, gate = decoder_head(model, dec_h, ctx, compute_dtype)
    mel = mel.transpose(0, 1).reshape(B, T_out, n_mels)
    gate = gate.t().repeat_interleave(r, dim=1)
    align = w.transpose(0, 1).repeat_interleave(r, dim=1)
    return mel, gate, align


class ForwardOutput(NamedTuple):
    mel: torch.Tensor            # (B, T_out, n_mels)
    mel_postnet: torch.Tensor    # (B, T_out, n_mels)
    gate_energies: torch.Tensor  # (B, T_out)
    alignments: torch.Tensor     # (B, T_out, T_in)


def forward(model: Tacotron2, stats: Stats, text: torch.Tensor,
            text_lengths: torch.Tensor, mels: torch.Tensor,
            output_lengths: torch.Tensor, cfg: Tacotron2Config, *,
            training: bool, generator: Optional[torch.Generator] = None,
            compute_dtype=None, keep: Optional[train_scan.Keep] = None,
            bn_group=None) -> Tuple[ForwardOutput, Stats]:
    """Teacher-forced forward pass (reference Tacotron2.forward,
    model.py:499-515; the JAX package's ``forward``). ``stats`` are the
    batchnorm running statistics (``bn_stats``); the new ones come back as
    values. ``generator=None`` runs no dropout anywhere (the JAX package's
    ``rng=None``). ``bn_group``: the process group of data-parallel ranks
    over which training batchnorm takes its statistics (None: this
    process's batch alone)."""
    kw = dict(stats=stats, training=training, generator=generator,
              compute_dtype=compute_dtype, bn_group=bn_group)
    new_stats = dict(stats)

    def run(fn, *args):  # the output, the new statistics kept
        out = fn(model, *args, cfg, **kw)
        if not training:
            return out
        new_stats.update(out[1])
        return out[0]

    memory = run(encode, text, text_lengths)
    mel, gate, align = decode_teacher_forced(
        model, memory, text_lengths, mels, cfg, training=training,
        generator=generator, compute_dtype=compute_dtype, keep=keep)
    mel_postnet = mel + run(postnet_apply, mel)
    if cfg.mask_padding:
        mel, mel_postnet, gate = mask_outputs(mel, mel_postnet, gate,
                                              output_lengths)
    return ForwardOutput(mel, mel_postnet, gate, align), new_stats
