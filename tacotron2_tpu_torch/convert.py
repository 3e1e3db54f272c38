"""Weights from the JAX package's pytrees into the port's state_dict.

``state_dict_from_jax(params, stats, cfg)`` takes the JAX package's
``(params, stats)`` trees with numpy (or array-like) leaves and returns the
reference-format state_dict -- the same keys and layouts as the JAX
package's ``convert.export_state_dict`` -- as torch tensors, which
``models.tacotron2.Tacotron2(cfg).load_state_dict(sd, strict=True)`` takes.
This is the port's own copy of that mapping; it needs nothing of the JAX
package. A quantized JAX cell (``{"w_q", "scale", "bias"}``, the JAX
package's ``quantize_for_serving``) comes across as the buffers of a
``QuantizedLSTMCell`` (``<cell>.w_q``, ``.scale``, ``.bias``), which a model
from ``models.tacotron2.quantize_for_serving`` loads.
``hifigan_state_dict_from_jax(params, cfg)`` does the same for the HiFi-GAN
generator (``models.hifigan.Generator``).

Layouts (JAX -> torch):
- dense kernel (in, out) -> Linear weight (out, in)            [transpose]
- conv kernel (k, in, out) -> Conv1d weight (out, in, k)       [transpose]
- LSTM wi (in, 4H) -> weight_ih (4H, in); gate order i, f, g, o is the same
- batchnorm scale/offset -> weight/bias; running stats from ``stats``
- transposed-conv kernel (k, in, out), which ``jax.lax.conv_transpose``
  applies unflipped -> ConvTranspose1d weight (in, out, k)  [flip k, transpose]
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tacotron2_tpu_torch.config import Tacotron2Config


def _t(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def state_dict_from_jax(params: Dict, stats: Dict, cfg: Tacotron2Config
                        ) -> Dict[str, torch.Tensor]:
    """(params, stats) pytrees -> the port's (reference-format) state_dict."""
    out: Dict[str, np.ndarray] = {}

    def dense(prefix, p, bias=True):
        out[f"{prefix}.weight"] = _t(p["kernel"]).T
        if bias:
            out[f"{prefix}.bias"] = _t(p["bias"])

    def conv(prefix, p, bias=True):
        out[f"{prefix}.weight"] = _t(p["kernel"]).transpose(2, 1, 0)
        if bias:
            out[f"{prefix}.bias"] = _t(p["bias"])

    def bn(prefix, p, s):
        out[f"{prefix}.weight"] = _t(p["scale"])
        out[f"{prefix}.bias"] = _t(p["offset"])
        out[f"{prefix}.running_mean"] = _t(s["mean"])
        out[f"{prefix}.running_var"] = _t(s["var"])
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)

    def lstm(prefix, p, suffix=""):
        if "w_q" in p:  # int8 serving form of a decoder cell
            out[f"{prefix}.w_q"] = np.asarray(p["w_q"], dtype=np.int8)
            out[f"{prefix}.scale"] = _t(p["scale"])
            out[f"{prefix}.bias"] = _t(p["bias"])
            return
        out[f"{prefix}.weight_ih{suffix}"] = _t(p["wi"]).T
        out[f"{prefix}.weight_hh{suffix}"] = _t(p["wh"]).T
        out[f"{prefix}.bias_ih{suffix}"] = _t(p["bi"])
        out[f"{prefix}.bias_hh{suffix}"] = _t(p["bh"])

    out["embedding.weight"] = _t(params["embedding"])
    for i, layer in enumerate(params["encoder"]["convs"]):
        conv(f"encoder.convolutions.{i}.0.conv", layer["conv"])
        bn(f"encoder.convolutions.{i}.1", layer["bn"],
           stats["encoder"]["convs"][i])
    lstm("encoder.lstm", params["encoder"]["lstm_fwd"], "_l0")
    lstm("encoder.lstm", params["encoder"]["lstm_bwd"], "_l0_reverse")

    dp = params["decoder"]
    for i, p in enumerate(dp["prenet"]):
        dense(f"decoder.prenet.layers.{i}.linear_layer", p, bias=False)
    lstm("decoder.attention_rnn", dp["attention_rnn"])
    att = "decoder.attention_layer"
    ap = dp["attention"]
    dense(f"{att}.query_layer.linear_layer", ap["query"], bias=False)
    dense(f"{att}.memory_layer.linear_layer", ap["memory"], bias=False)
    dense(f"{att}.v.linear_layer", ap["v"], bias=False)
    conv(f"{att}.location_layer.location_conv.conv", ap["location_conv"],
         bias=False)
    dense(f"{att}.location_layer.location_dense.linear_layer",
          ap["location_dense"], bias=False)
    lstm("decoder.decoder_rnn", dp["decoder_rnn"])
    dense("decoder.linear_projection.linear_layer", dp["projection"])
    dense("decoder.gate_layer.linear_layer", dp["gate"])

    for i, layer in enumerate(params["postnet"]["convs"]):
        conv(f"postnet.convolutions.{i}.0.conv", layer["conv"])
        bn(f"postnet.convolutions.{i}.1", layer["bn"],
           stats["postnet"]["convs"][i])
    return _tensors(out)


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True, order="C"))
            for k, v in out.items()}


def hifigan_state_dict_from_jax(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's HiFi-GAN generator params -> the state_dict of
    ``models.hifigan.Generator(cfg)`` (``cfg`` a ``HiFiGANConfig``)."""
    out: Dict[str, np.ndarray] = {}

    def conv(prefix, p):
        out[f"{prefix}.weight"] = _t(p["kernel"]).transpose(2, 1, 0)
        out[f"{prefix}.bias"] = _t(p["bias"])

    conv("conv_pre", params["conv_pre"])
    n_res = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(params["ups"]):
        out[f"ups.{i}.weight"] = _t(up["kernel"])[::-1].transpose(1, 2, 0)
        out[f"ups.{i}.bias"] = _t(up["bias"])
        for j, block in enumerate(params["resblocks"][i]):
            for name in ("convs1", "convs2"):
                for d, p in enumerate(block[name]):
                    conv(f"resblocks.{i * n_res + j}.{name}.{d}", p)
    conv("conv_post", params["conv_post"])
    return _tensors(out)
