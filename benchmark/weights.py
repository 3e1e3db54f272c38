"""Weights made from the seed on the device, in one large draw a model.

Tacotron 2 takes the reference's initialisation (NVIDIA/tacotron2
``layers.py``/``model.py``: Xavier-uniform with per-layer gains, the scaled
embedding init, torch's LSTM default U(-1/sqrt(H), 1/sqrt(H)), zero biases,
unit/zero batchnorm with fresh running statistics): every drawn leaf is a
uniform of its own bound, so one ``torch.rand`` over all of them, cut into
leaves, makes the model. Names are the reference's state_dict keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

GAINS = {"linear": 1.0, "sigmoid": 1.0, "tanh": 5.0 / 3.0,
         "relu": math.sqrt(2.0)}

Leaf = Tuple[str, Tuple[int, ...], Optional[float]]  # bound None: constant


def _xavier(shape, fan_in, fan_out, gain):
    return GAINS[gain] * math.sqrt(6.0 / (fan_in + fan_out))


def tacotron2_leaves(c: dict) -> List[Leaf]:
    """(name, shape, uniform bound) of every parameter; bound None for
    zero biases (and batchnorm, set apart)."""
    e, a, d = (c["encoder_embedding_dim"], c["attention_rnn_dim"],
               c["decoder_rnn_dim"])
    n, p, datt = c["n_mel_channels"], c["prenet_dim"], c["attention_dim"]
    leaves: List[Leaf] = []

    def dense(name, i, o, gain="linear", bias=False):
        leaves.append((name + ".weight", (o, i), _xavier(None, i, o, gain)))
        if bias:
            leaves.append((name + ".bias", (o,), None))

    def conv(name, i, o, k, gain, bias=True):
        leaves.append((name + ".weight", (o, i, k),
                       _xavier(None, i * k, o * k, gain)))
        if bias:
            leaves.append((name + ".bias", (o,), None))

    def lstm(name, i, h, suffix=""):
        b = 1.0 / math.sqrt(h)
        leaves.extend([(f"{name}.weight_ih{suffix}", (4 * h, i), b),
                       (f"{name}.weight_hh{suffix}", (4 * h, h), b),
                       (f"{name}.bias_ih{suffix}", (4 * h,), b),
                       (f"{name}.bias_hh{suffix}", (4 * h,), b)])

    ns, sd = c["n_symbols"], c["symbols_embedding_dim"]
    leaves.append(("embedding.weight", (ns, sd),
                   math.sqrt(3.0) * math.sqrt(2.0 / (ns + sd))))
    for i in range(c["encoder_n_convolutions"]):
        conv(f"encoder.convolutions.{i}.0.conv", e, e,
             c["encoder_kernel_size"], "relu")
    lstm("encoder.lstm", e, e // 2, "_l0")
    lstm("encoder.lstm", e, e // 2, "_l0_reverse")
    dense("decoder.prenet.layers.0.linear_layer", n, p)
    dense("decoder.prenet.layers.1.linear_layer", p, p)
    lstm("decoder.attention_rnn", p + e, a)
    at = "decoder.attention_layer"
    dense(at + ".query_layer.linear_layer", a, datt, "tanh")
    dense(at + ".memory_layer.linear_layer", e, datt, "tanh")
    dense(at + ".v.linear_layer", datt, 1)
    conv(at + ".location_layer.location_conv.conv", 2,
         c["attention_location_n_filters"],
         c["attention_location_kernel_size"], "linear", bias=False)
    dense(at + ".location_layer.location_dense.linear_layer",
          c["attention_location_n_filters"], datt, "tanh")
    lstm("decoder.decoder_rnn", a + e, d)
    dense("decoder.linear_projection.linear_layer", d + e, n, bias=True)
    dense("decoder.gate_layer.linear_layer", d + e, 1, "sigmoid", bias=True)
    pe, pk, pn = (c["postnet_embedding_dim"], c["postnet_kernel_size"],
                  c["postnet_n_convolutions"])
    chans = [n] + [pe] * (pn - 1) + [n]
    for i in range(pn):
        conv(f"postnet.convolutions.{i}.0.conv", chans[i], chans[i + 1], pk,
             "tanh" if i < pn - 1 else "linear")
    return leaves


def batchnorms(c: dict) -> List[Tuple[str, int]]:
    """(state_dict prefix, channels) of every batchnorm."""
    e, n, pe = (c["encoder_embedding_dim"], c["n_mel_channels"],
                c["postnet_embedding_dim"])
    pn = c["postnet_n_convolutions"]
    out = [(f"encoder.convolutions.{i}.1", e)
           for i in range(c["encoder_n_convolutions"])]
    chans = [pe] * (pn - 1) + [n]
    out += [(f"postnet.convolutions.{i}.1", chans[i]) for i in range(pn)]
    return out


def _generator(seed: int, device, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (1 << 63))


def tacotron2(c: dict, seed: int, device, gate_bias: Optional[float] = None
              ) -> Dict[str, torch.Tensor]:
    """The whole state_dict in fp32 on ``device``: one uniform draw for
    every drawn leaf. ``gate_bias``: a stop gate that never fires (zero
    weight, this bias), so that a decode runs to its step limit."""
    leaves = tacotron2_leaves(c)
    drawn = [(nm, sh, b) for nm, sh, b in leaves if b is not None]
    total = sum(math.prod(sh) for _, sh, _ in drawn)
    u = torch.rand(total, generator=_generator(seed, device, 1),
                   device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, bound in leaves:
        if bound is None:
            out[name] = torch.zeros(shape, device=device)
            continue
        k = math.prod(shape)
        out[name] = ((2.0 * u[at:at + k] - 1.0) * bound).view(shape)
        at += k
    for prefix, ch in batchnorms(c):
        out[prefix + ".weight"] = torch.ones(ch, device=device)
        out[prefix + ".bias"] = torch.zeros(ch, device=device)
        out[prefix + ".running_mean"] = torch.zeros(ch, device=device)
        out[prefix + ".running_var"] = torch.ones(ch, device=device)
        out[prefix + ".num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=device)
    if gate_bias is not None:
        out["decoder.gate_layer.linear_layer.weight"].zero_()
        out["decoder.gate_layer.linear_layer.bias"].fill_(gate_bias)
    return out


def parameter_names(weights: Dict[str, torch.Tensor]) -> List[str]:
    """The trainable leaves: every key but the batchnorm buffers."""
    return [k for k in weights
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))]
