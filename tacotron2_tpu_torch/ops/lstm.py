"""LSTM primitives: fused cell, time scan, length-aware BiLSTM.

Counterparts of the JAX package's ``ops/lstm.py``. Weights keep torch's
``nn.LSTM``/``nn.LSTMCell`` layout (``weight_ih`` (4H, in), ``weight_hh``
(4H, H), gate blocks in the order i, f, g, o).

``bilstm`` keeps packed-sequence semantics without packing (reference
model.py:181-188): the reverse direction scans a per-row length-reversed
copy, so each row's backward state starts at its own last valid frame, and
every output at t >= length is exactly 0. Both directions run through
``kernels.encoder_lstm.bilstm_scans``: the hand-written CUDA kernels for a
CUDA tensor, their plain versions for a CPU tensor. It is differentiable:
the scans through their autograd Function (the backward kernel), and the
length reversal as a gather, whose backward is the scatter-add the JAX
package's ``take_along_axis`` transposes to.

``quantize_lstm_params`` gives the weight-only int8 serving form of a cell
(``QuantizedLSTMWeights``; ``QuantizedLSTMCell`` holds it as buffers), and
``lstm_cell`` dispatches on it to ``kernels.int8_matmul``: inference only,
there is no backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from tacotron2_tpu_torch.kernels import encoder_lstm
from tacotron2_tpu_torch.kernels.int8_matmul import (int8_matmul, pack_int8,
                                                     quantize_int8)
from tacotron2_tpu_torch.ops.layers import dense, length_mask

State = Tuple[torch.Tensor, torch.Tensor]  # (h, c)


class LSTMWeights(NamedTuple):
    w_ih: torch.Tensor  # (4H, in)
    w_hh: torch.Tensor  # (4H, H)
    b_ih: torch.Tensor  # (4H,)
    b_hh: torch.Tensor  # (4H,)


class QuantizedLSTMWeights(NamedTuple):
    """Weight-only int8 serving form of a cell (``quantize_lstm_params``)."""
    w_q: torch.Tensor    # (in + H, 4H) int8, [w_ih ; w_hh] transposed
    scale: torch.Tensor  # (4H,) fp32 per output channel
    bias: torch.Tensor   # (4H,) fp32, b_ih + b_hh
    packed: Optional[torch.Tensor] = None  # pack_int8(w_q), on a card


class QuantizedLSTMCell(nn.Module):
    """Holds a quantized cell's ``w_q``, ``scale`` and ``bias`` as buffers
    (zeros until filled by ``from_weights`` or ``load_state_dict``), and the
    kernel's packed copy of ``w_q`` as a non-persistent buffer, made by
    ``packed()`` on a card and again whenever ``w_q`` moves or changes."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        G = 4 * hidden_size
        self.register_buffer("w_q", torch.zeros(input_size + hidden_size, G,
                                                dtype=torch.int8))
        self.register_buffer("scale", torch.ones(G))
        self.register_buffer("bias", torch.zeros(G))
        self.register_buffer("w_packed", None, persistent=False)
        self._packed_of = None

    def packed(self) -> torch.Tensor:
        """``pack_int8(w_q)``, packed once per value of ``w_q``."""
        key = (self.w_q.data_ptr(), self.w_q._version)
        if self.w_packed is None or self._packed_of != key:
            self.w_packed = pack_int8(self.w_q)
            self._packed_of = key
        return self.w_packed

    @classmethod
    def from_weights(cls, p: LSTMWeights) -> "QuantizedLSTMCell":
        cell = cls(p.w_ih.shape[1], p.w_hh.shape[1])
        q = quantize_lstm_params(p)
        dev = p.w_ih.device
        cell.w_q, cell.scale, cell.bias = (x.to(dev) for x in q[:3])
        return cell


def lstm_weights(module: nn.Module, suffix: str = ""):
    """The four tensors of an ``nn.LSTMCell`` (suffix "") or of one
    direction of an ``nn.LSTM`` (suffix "_l0" or "_l0_reverse"); the
    ``QuantizedLSTMWeights`` of a ``QuantizedLSTMCell``."""
    if isinstance(module, QuantizedLSTMCell):
        return QuantizedLSTMWeights(
            module.w_q, module.scale, module.bias,
            module.packed() if module.w_q.is_cuda else None)
    return LSTMWeights(*(getattr(module, f"{n}{suffix}") for n in
                         ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))


def quantize_lstm_params(p: LSTMWeights) -> QuantizedLSTMWeights:
    """Weight-only int8 serving form of an LSTM cell's parameters: the two
    gate matrices stacked ([w_ih ; w_hh] as (in + H, 4H), so one kernel call
    streams both) and quantized per output channel, the biases summed."""
    w = torch.cat([p.w_ih, p.w_hh], dim=1).t()
    w_q, scale = quantize_int8(w)
    bias = (p.b_ih.detach().float() + p.b_hh.detach().float()).cpu()
    return QuantizedLSTMWeights(w_q, scale, bias)


def _lstm_cell_int8(p: QuantizedLSTMWeights, x: torch.Tensor,
                    state: State) -> State:
    """Quantized-weight cell: the int8 weights are widened inside
    ``kernels.int8_matmul``, which rounds [x ; h] to bf16 itself; h stays
    fp32 in the concatenation and the bias is added in fp32."""
    h, c = state
    xs = torch.cat([x.float(), h], dim=-1)
    gates = int8_matmul(xs, p.w_q, p.scale, packed=p.packed) + p.bias
    return lstm_apply_gates(gates, c)


def lstm_gates(p: LSTMWeights, x: torch.Tensor, h: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Pre-activation gate block (B, 4H): the cell's two products + biases
    (each product in ``compute_dtype``, the bias add in fp32)."""
    return (dense(x, p.w_ih, compute_dtype=compute_dtype)
            + dense(h, p.w_hh, compute_dtype=compute_dtype)
            + p.b_ih + p.b_hh)


def lstm_apply_gates(gates: torch.Tensor, c: torch.Tensor) -> State:
    """Elementwise half of the cell: gates (B, 4H) + old c -> (h, c)."""
    i, f, g, o = gates.float().chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, new_c


def lstm_cell(p: LSTMWeights, x: torch.Tensor, state: State,
              compute_dtype: Optional[torch.dtype] = None) -> State:
    """One LSTM step. x: (B, in); state: ((B, H), (B, H)) fp32. Quantized
    weights (``quantize_lstm_params``) take the int8 path, whatever the
    compute dtype."""
    if isinstance(p, QuantizedLSTMWeights):
        return _lstm_cell_int8(p, x, state)
    h, c = state
    return lstm_apply_gates(lstm_gates(p, x, h, compute_dtype), c)


def lstm_scan(p: LSTMWeights, xs: torch.Tensor,
              state: Optional[State] = None,
              compute_dtype: Optional[torch.dtype] = None,
              ) -> Tuple[torch.Tensor, State]:
    """Unidirectional LSTM over time. xs: (B, T, in) -> (B, T, H)."""
    B, T = xs.shape[:2]
    H = p.w_hh.shape[1]
    if state is None:
        zeros = torch.zeros(B, H, device=xs.device)
        state = (zeros, zeros)
    hs = []
    for t in range(T):
        state = lstm_cell(p, xs[:, t], state, compute_dtype)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


def _reverse_by_length(xs: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """Reverse each row within its own valid prefix: out[b, t] =
    xs[b, L_b-1-t] for t < L_b. Positions past L_b hold clamped junk, which
    callers mask."""
    T = xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :]
    idx = torch.clamp(lengths[:, None].long() - 1 - t, 0, T - 1)
    return torch.gather(xs, 1, idx[:, :, None].expand(-1, -1, xs.shape[2]))


def bilstm(fwd: LSTMWeights, bwd: LSTMWeights, xs: torch.Tensor,
           lengths: torch.Tensor,
           compute_dtype: Optional[torch.dtype] = None,
           packed: Optional[encoder_lstm.PackedBiLSTM] = None
           ) -> torch.Tensor:
    """Bidirectional LSTM with per-row lengths. (B, T, in) -> (B, T, 2H)
    fp32, exactly 0 at t >= length. ``packed`` is the reusable
    ``encoder_lstm.pack_bilstm(fwd, bwd, compute_dtype or float32)``
    (packed here if omitted)."""
    if packed is None:
        packed = encoder_lstm.pack_bilstm(fwd, bwd,
                                          compute_dtype or torch.float32)
    mask = length_mask(lengths, xs.shape[1])[:, :, None]
    xs_rev = _reverse_by_length(xs, lengths)
    fwd_out, bwd_scan = encoder_lstm.bilstm_scans(packed, xs, xs_rev,
                                                  (*fwd, *bwd))
    bwd_out = _reverse_by_length(bwd_scan, lengths)
    out = torch.cat([fwd_out, bwd_out], dim=-1)
    return torch.where(mask, out, torch.zeros_like(out))
