"""The teacher-forced decoder core with a hand-written backward.

Counterpart of the JAX package's ``models/decoder_vjp.py``. ``core_scan``
runs attention LSTM -> location attention -> decoder LSTM over all steps
and returns the (dec_h, ctx, w) stacks; the mel/gate heads run afterwards
over all steps at once (``models.tacotron2.decoder_head``).

With ``cfg.custom_vjp_decoder`` (the default) it is ``CoreScan``, a
``torch.autograd.Function``: the forward is the scan kernel
(``kernels/train_scan.forward_residuals``), the backward the data-gradient
chain kernel (``backward_chain``), and the gradients the JAX package also
takes out of its scan are single large products in plain torch (cuBLAS)
over the saved stacks: d_memory = sum_t w_t (x) d_ctx_t, each LSTM's
d weight_ih, d weight_hh and d bias over T*B, and the query gradient from
(att_h, d_q). The location conv/dense gradients come from the kernel's
d_K2 by the chain rule of the bilinear fold K2 = conv ⊛ dense. Otherwise the
plain per-step decoder runs under ordinary autograd (the counterpart of
``_decode_tf_xla``), which the tests use as a second reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.kernels import train_scan as ts
from tacotron2_tpu_torch.kernels.decoder_batch import attention_inputs
from tacotron2_tpu_torch.kernels.encoder_lstm import lstm_weight_grads, shift
from tacotron2_tpu_torch.ops.lstm import LSTMWeights, lstm_weights

Stacks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def core_weights(model) -> Tuple[torch.Tensor, ...]:
    """The decoder core's twelve parameters in ``CoreScan``'s order: the
    attention LSTM's four, the query, v, location conv and location dense
    weights, the decoder LSTM's four."""
    dec = model.decoder
    att = dec.attention_layer
    loc = att.location_layer
    return (*lstm_weights(dec.attention_rnn),
            att.query_layer.linear_layer.weight, att.v.linear_layer.weight,
            loc.location_conv.conv.weight,
            loc.location_dense.linear_layer.weight,
            *lstm_weights(dec.decoder_rnn))


def _pack(weights, dtype) -> ts.ScanWeights:
    return ts.pack_scan_weights(LSTMWeights(*weights[:4]), *weights[4:8],
                                LSTMWeights(*weights[8:]), dtype)


def attention_param_grads(dq: torch.Tensor, att_h: torch.Tensor,
                          d_k2: torch.Tensor, d_v: torch.Tensor,
                          conv_w: torch.Tensor, dense_w: torch.Tensor):
    """(d query (datt, A), d v (1, datt), d location conv (F, 2, ks),
    d location dense (datt, F)), as the JAX package's
    ``attention_param_grads``: the query from (att_h, d_q) rounded to
    att_h's dtype with fp32 sums; the forward sees conv and dense only
    through K2[k, c, :] = sum_f conv[f, c, k] dense[:, f], so
    d conv = d_K2 : dense and d dense = conv : d_K2."""
    dqw = dq.to(att_h.dtype).float().reshape(-1, dq.shape[-1])
    d_query = dqw.t() @ att_h.reshape(-1, att_h.shape[-1]).float()
    d_conv = torch.einsum("kcD,Df->fck", d_k2, dense_w.float())
    d_dense = torch.einsum("fck,kcD->Df", conv_w.float(), d_k2)
    return d_query, d_v[None, :], d_conv, d_dense


class CoreScan(torch.autograd.Function):
    """``apply(prenet, memory, processed, mask, keep, p_att, p_dec, dtype,
    *weights)``: prenet (T, B, P), memory (B, Ti, E), processed
    (B, Ti, datt), mask (B, Ti) bool, ``keep`` the two bool keep-mask stacks
    or None, ``dtype`` the operand dtype, ``weights`` as ``core_weights``.
    Returns (dec_h (T, B, D) in the operand dtype, ctx (T, B, E) fp32,
    w (T, B, Ti) fp32). The forward saves the residual stacks and the keep
    masks; the backward uses the same masks."""

    @staticmethod
    def forward(ctx, prenet, memory, processed, mask, keep, p_att, p_dec,
                dtype, *weights):
        sw = _pack(weights, dtype)
        mem, proc, emask = attention_inputs(memory, processed, mask, dtype)
        pre = prenet.to(dtype).contiguous()
        res = ts.forward_residuals(sw, pre, mem, proc, emask, keep=keep,
                                   p_att=p_att, p_dec=p_dec)
        ctx.save_for_backward(pre, mem, proc, *res, *weights)
        ctx.sw, ctx.keep, ctx.p = sw, keep, (p_att, p_dec)
        ctx.in_dtypes = (prenet.dtype, memory.dtype, processed.dtype)
        return res.dec_h, res.ctx, res.w

    @staticmethod
    def backward(ctx, d_dec_h, d_ctx, d_align):
        pre, mem, proc, *rest = ctx.saved_tensors
        res = ts.Residuals(*rest[:8])
        weights = rest[8:]
        W = pre.dtype

        def cot(d, like):
            if d is None:
                return torch.zeros(like.shape, device=like.device)
            return d.float().contiguous()

        g = ts.backward_chain(ctx.sw, res, mem, proc, cot(d_dec_h, res.dec_h),
                              cot(d_ctx, res.ctx), cot(d_align, res.w),
                              keep=ctx.keep, p_att=ctx.p[0], p_dec=ctx.p[1])
        # d_mem[b] = sum_t w_t[b] (x) d_ctx_t[b], operands in W, fp32 sums
        d_memory = torch.bmm(res.w.to(W).float().permute(1, 2, 0),
                             g.d_ctx.float().transpose(0, 1))
        xa = torch.cat([pre, shift(res.ctx).to(W)], dim=-1)
        xd = torch.cat([res.att_h, res.ctx.to(W)], dim=-1)
        ia, ha, ba = lstm_weight_grads(xa, res.att_h, g.dga)
        id_, hd, bd = lstm_weight_grads(xd, res.dec_h, g.dgd)
        dq_w, dv_w, dconv, ddense = attention_param_grads(
            g.d_q, res.att_h, g.d_k2, g.d_v, weights[6], weights[7])
        pdt, mdt, rdt = ctx.in_dtypes
        return (g.d_prenet.to(pdt), d_memory.to(mdt),
                g.d_processed.to(rdt), None, None, None, None, None,
                ia, ha, ba, ba, dq_w, dv_w, dconv, ddense, id_, hd, bd, bd)


def _core_scan_autograd(model, prenet, memory, processed, mask, cfg, keep,
                        compute_dtype) -> Stacks:
    """The plain per-step decoder core under ordinary autograd."""
    from tacotron2_tpu_torch.models.tacotron2 import (decoder_core,
                                                      init_decoder_state)
    state = init_decoder_state(memory, cfg)
    hs, cs, ws = [], [], []
    for t in range(prenet.shape[0]):
        kt = None if keep is None else (keep[0][t], keep[1][t])
        state = decoder_core(model, state, prenet[t], memory, processed,
                             mask, cfg, compute_dtype=compute_dtype, keep=kt)
        hs.append(state.dec_h)
        cs.append(state.att_context)
        ws.append(state.att_weights)
    return torch.stack(hs), torch.stack(cs), torch.stack(ws)


def core_scan(model, prenet: torch.Tensor, memory: torch.Tensor,
              processed: torch.Tensor, mask: torch.Tensor,
              cfg: Tacotron2Config, *, keep: Optional[ts.Keep] = None,
              compute_dtype: Optional[torch.dtype] = None) -> Stacks:
    """The decoder core over all steps (the JAX package's
    ``decoder_vjp.core_scan``). prenet (T, B, P) time-major; ``keep`` the
    attention- and decoder-LSTM dropout keep masks ((T, B, A), (T, B, D)
    bool), or None for no dropout. Returns (dec_h (T, B, D), ctx
    (T, B, E), w (T, B, Ti))."""
    if not cfg.custom_vjp_decoder:
        return _core_scan_autograd(model, prenet, memory, processed, mask,
                                   cfg, keep, compute_dtype)
    return CoreScan.apply(prenet, memory, processed, mask, keep,
                          cfg.p_attention_dropout, cfg.p_decoder_dropout,
                          compute_dtype or torch.float32, *core_weights(model))
