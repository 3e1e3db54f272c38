"""Tacotron 2, plain: NVIDIA/tacotron2 ``model.py`` in torch operations,
fp32 (callers turn TF32 off), no kernels, no cache, no batching tricks.

Weights are a dict by the reference's state_dict names. Activations are
(B, T, C). Departures from ``model.py``, each also the program's stated
behaviour: batchnorm statistics in training are taken over every (row,
frame) of the padded batch (BatchNorm1d's own rule); teacher forcing feeds
each step the previous frame given (a zero frame first), which is the
training forward and, fed with served frames, the check of a served
decode; dropout keep masks are handed in (``Masks``) instead of drawn
inside, so a caller can draw them in the order the program does.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]
BN_EPS = 1e-5
GATE_MASKED = 1e3  # model.py:495


class Dims(NamedTuple):
    n_mels: int
    embed: int
    enc_convs: int
    enc_kernel: int
    prenet: int
    att_rnn: int
    dec_rnn: int
    att_dim: int
    loc_filters: int
    loc_kernel: int
    post_dim: int
    post_kernel: int
    post_convs: int
    p_att: float
    p_dec: float
    n_symbols: int

    @classmethod
    def of(cls, c: dict) -> "Dims":
        return cls(c["n_mel_channels"], c["encoder_embedding_dim"],
                   c["encoder_n_convolutions"], c["encoder_kernel_size"],
                   c["prenet_dim"], c["attention_rnn_dim"],
                   c["decoder_rnn_dim"], c["attention_dim"],
                   c["attention_location_n_filters"],
                   c["attention_location_kernel_size"],
                   c["postnet_embedding_dim"], c["postnet_kernel_size"],
                   c["postnet_n_convolutions"], c["p_attention_dropout"],
                   c["p_decoder_dropout"], c["n_symbols"])


class Masks(NamedTuple):
    """Keep masks (bool) of every dropout of a training forward."""
    enc: list      # per encoder conv, (B, T_in, embed)
    prenet: list   # per prenet layer, (B, S, prenet)
    att: torch.Tensor   # (S, B, att_rnn)
    dec: torch.Tensor   # (S, B, dec_rnn)
    post: list     # per postnet conv, (B, T_out, channels)


def mask_shapes(d: Dims, B: int, T_in: int, S: int):
    """The masks' shapes and keep probabilities, in the order the program
    draws them: encoder convs, prenet layers, the two LSTM outputs, the
    postnet convs."""
    post_ch = [d.post_dim] * (d.post_convs - 1) + [d.n_mels]
    return ([((B, T_in, d.embed), 0.5)] * d.enc_convs
            + [((B, S, d.prenet), 0.5)] * 2
            + [((S, B, d.att_rnn), 1.0 - d.p_att),
               ((S, B, d.dec_rnn), 1.0 - d.p_dec)]
            + [((B, S, c), 0.5) for c in post_ch])


def draw_masks(d: Dims, B: int, T_in: int, S: int,
               generator: torch.Generator) -> Masks:
    """Draw every keep mask from ``generator`` in the program's order,
    one uniform tensor each (``u < keep probability``)."""
    dev = generator.device
    ms = [torch.rand(shape, generator=generator, device=dev) < keep
          for shape, keep in mask_shapes(d, B, T_in, S)]
    e = d.enc_convs
    return Masks(ms[:e], ms[e:e + 2], ms[e + 2], ms[e + 3], ms[e + 4:])


def _drop(x, keep, p):
    return x if keep is None else torch.where(keep, x / (1.0 - p),
                                              torch.zeros_like(x))


class Net:
    """The reference model over one weight dict, with an operand rounding
    (identity for fp32)."""

    def __init__(self, W: Weights, d: Dims, rnd: Optional[Round] = None):
        self.W, self.d = W, d
        self.q = rnd or (lambda t: t)

    # ------------------------------------------------------------ primitives
    def mm(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def conv(self, x, w, b=None, dilation=1):
        k = w.shape[-1]
        y = F.conv1d(self.q(x).transpose(1, 2), self.q(w), b,
                     padding=dilation * (k - 1) // 2, dilation=dilation)
        return y.transpose(1, 2)

    def bn(self, x, prefix, training):
        W = self.W
        if training:
            mean = x.mean(dim=(0, 1))
            var = (x - mean).square().mean(dim=(0, 1))
        else:
            mean, var = W[prefix + ".running_mean"], W[prefix + ".running_var"]
        return ((x - mean) * torch.rsqrt(var + BN_EPS) * W[prefix + ".weight"]
                + W[prefix + ".bias"])

    def lstm(self, prefix, suffix, x, h, c, xw=None):
        W = self.W
        g = (xw if xw is not None else
             self.mm(x, W[f"{prefix}.weight_ih{suffix}"]))
        g = (g + W[f"{prefix}.bias_ih{suffix}"]
             + self.mm(h, W[f"{prefix}.weight_hh{suffix}"])
             + W[f"{prefix}.bias_hh{suffix}"])
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c

    # ------------------------------------------------------------- encoder
    def encode(self, ids, lengths, training=False, masks=None):
        W, d = self.W, self.d
        x = W["embedding.weight"][ids]
        for i in range(d.enc_convs):
            p = f"encoder.convolutions.{i}"
            x = self.conv(x, W[p + ".0.conv.weight"], W[p + ".0.conv.bias"])
            x = torch.relu(self.bn(x, p + ".1", training))
            x = _drop(x, masks.enc[i] if masks else None, 0.5)
        return self.bilstm(x, lengths)

    def bilstm(self, x, lengths):
        """Packed-sequence semantics: each direction reads only a row's
        first ``length`` frames, outputs 0 past them."""
        B, T, _ = x.shape
        H = self.d.embed // 2
        outs = []
        for suffix, order in (("_l0", range(T)),
                              ("_l0_reverse", reversed(range(T)))):
            xw = self.mm(x, self.W[f"encoder.lstm.weight_ih{suffix}"])
            h = x.new_zeros(B, H)
            c = x.new_zeros(B, H)
            out = [None] * T
            for t in order:
                hn, cn = self.lstm("encoder.lstm", suffix, None, h, c,
                                   xw=xw[:, t])
                valid = (t < lengths)[:, None]
                h = torch.where(valid, hn, h)
                c = torch.where(valid, cn, c)
                out[t] = torch.where(valid, hn, torch.zeros_like(hn))
            outs.append(torch.stack(out, dim=1))
        return torch.cat(outs, dim=-1)

    # ------------------------------------------------------------- decoder
    def decode(self, memory, lengths, frames_in, training=False, masks=None,
               chunk=None):
        """Teacher-forced decode: ``frames_in`` (B, S, n_mels) are the
        frames each step is fed (step 0 a zero frame). Returns mel
        (B, S, n_mels), gate (B, S), align (B, S, T_in). ``chunk``: under
        autograd, keep only every ``chunk``-th step's state and compute
        the steps between again in the backward (the same numbers, less
        memory)."""
        W, d = self.W, self.d
        B, T_in, _ = memory.shape
        S = frames_in.shape[1]
        x = frames_in
        for i in range(2):
            x = torch.relu(self.mm(
                x, W[f"decoder.prenet.layers.{i}.linear_layer.weight"]))
            x = _drop(x, masks.prenet[i] if masks else None, 0.5)
        prenet = x
        a = "decoder.attention_layer"
        processed = self.mm(memory, W[a + ".memory_layer.linear_layer.weight"])
        valid = torch.arange(T_in, device=memory.device)[None] < lengths[:, None]

        def steps(t0, t1, att_h, att_c, dec_h, dec_c, w, wcum, ctx):
            mels, gates, aligns = [], [], []
            for t in range(t0, t1):
                att_h, att_c = self.lstm("decoder.attention_rnn", "",
                                         torch.cat([prenet[:, t], ctx], -1),
                                         att_h, att_c)
                att_h = _drop(att_h, masks.att[t] if masks else None,
                              d.p_att)
                loc = self.conv(torch.stack([w, wcum], -1),
                                W[a + ".location_layer.location_conv"
                                      ".conv.weight"])
                loc = self.mm(loc, W[a + ".location_layer.location_dense"
                                         ".linear_layer.weight"])
                query = self.mm(att_h,
                                W[a + ".query_layer.linear_layer.weight"])
                e = self.mm(torch.tanh(query[:, None] + loc + processed),
                            W[a + ".v.linear_layer.weight"])[..., 0]
                w = torch.softmax(e.masked_fill(~valid, float("-inf")), dim=1)
                wcum = wcum + w
                ctx = torch.einsum("bt,bte->be", self.q(w), self.q(memory))
                dec_h, dec_c = self.lstm("decoder.decoder_rnn", "",
                                         torch.cat([att_h, ctx], -1),
                                         dec_h, dec_c)
                dec_h = _drop(dec_h, masks.dec[t] if masks else None,
                              d.p_dec)
                head = torch.cat([dec_h, ctx], -1)
                mels.append(self.mm(
                    head, W["decoder.linear_projection.linear_layer.weight"],
                    W["decoder.linear_projection.linear_layer.bias"]))
                gates.append(self.mm(
                    head, W["decoder.gate_layer.linear_layer.weight"],
                    W["decoder.gate_layer.linear_layer.bias"])[:, 0])
                aligns.append(w)
            return (att_h, att_c, dec_h, dec_c, w, wcum, ctx,
                    torch.stack(mels, 1), torch.stack(gates, 1),
                    torch.stack(aligns, 1))

        z = memory.new_zeros
        carry = (z(B, d.att_rnn), z(B, d.att_rnn), z(B, d.dec_rnn),
                 z(B, d.dec_rnn), z(B, T_in), z(B, T_in), z(B, d.embed))
        outs = []
        step = chunk or S
        for t0 in range(0, S, step):
            t1 = min(S, t0 + step)
            if chunk and torch.is_grad_enabled():
                res = checkpoint(steps, t0, t1, *carry, use_reentrant=False)
            else:
                res = steps(t0, t1, *carry)
            carry, out = res[:7], res[7:]
            outs.append(out)
        return tuple(torch.cat(x, 1) for x in zip(*outs))

    # ------------------------------------------------------------- postnet
    def postnet(self, mel, training=False, masks=None):
        W, d = self.W, self.d
        x = mel
        for i in range(d.post_convs):
            p = f"postnet.convolutions.{i}"
            x = self.conv(x, W[p + ".0.conv.weight"], W[p + ".0.conv.bias"])
            x = self.bn(x, p + ".1", training)
            if i < d.post_convs - 1:
                x = torch.tanh(x)
            x = _drop(x, masks.post[i] if masks else None, 0.5)
        return x

    # --------------------------------------------------------------- whole
    def train_forward(self, ids, text_lengths, mel_target, mel_lengths,
                      masks: Optional[Masks], chunk=None):
        """The training forward (model.py:499-515, parse_output with
        mask_padding): (mel, mel_postnet, gate), masked past each row's
        mel length."""
        memory = self.encode(ids, text_lengths, True, masks)
        go = torch.zeros_like(mel_target[:, :1])
        frames_in = torch.cat([go, mel_target[:, :-1]], dim=1)
        mel, gate, _ = self.decode(memory, text_lengths, frames_in, True,
                                   masks, chunk)
        post = mel + self.postnet(mel, True, masks)
        T = mel.shape[1]
        keep = (torch.arange(T, device=mel.device)[None]
                < mel_lengths[:, None])
        mel = torch.where(keep[..., None], mel, torch.zeros_like(mel))
        post = torch.where(keep[..., None], post, torch.zeros_like(post))
        gate = torch.where(keep, gate, torch.full_like(gate, GATE_MASKED))
        return mel, post, gate


def loss(mel, post, gate, mel_target, gate_target) -> torch.Tensor:
    """loss_function.py: MSE + MSE + BCE-with-logits, each a mean over the
    padded tensor."""
    return (F.mse_loss(mel, mel_target) + F.mse_loss(post, mel_target)
            + F.binary_cross_entropy_with_logits(gate, gate_target))
