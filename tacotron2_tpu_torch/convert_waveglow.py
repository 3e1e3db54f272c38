"""Published WaveGlow checkpoints into the port's ``WaveGlow``.

Counterpart of the JAX package's ``convert_waveglow.py``: maps the
published ``waveglow_256channels.pt`` (the torch WaveGlow of
arXiv:1811.00002, which the reference notebook loads) onto
``models.waveglow.WaveGlow``. The port's module keeps the published names
and layouts, so what is left to do is:

- weight normalisation: the published WN convs store ``weight_g`` and
  ``weight_v``; the weight is g * v / ||v||, the norm over (in, k) per
  output channel;
- checkpoints from before 2019 hold one cond conv per WN layer
  (``cond_layers.<j>``); they are concatenated into the one fused
  ``cond_layer`` (the layout since, and the port's);
- a ``module.`` prefix (a model saved from ``DataParallel``) is dropped.

The 1x1 weights (c, c, 1) and the transposed conv (in, out, k) load as
they are: the port applies them as torch does (the JAX package transposes
the 1x1 weight, as it applies x @ w).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch

from tacotron2_tpu_torch.models.tacotron2 import resolve_device
from tacotron2_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig


def _weight(sd: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """A conv's (out, in, k) weight, plain or weight-normalised."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"].float()
    g = sd[f"{prefix}.weight_g"].float()  # (out, 1, 1)
    v = sd[f"{prefix}.weight_v"].float()  # (out, in, k)
    norm = v.square().sum(dim=(1, 2), keepdim=True).sqrt()
    return g * v / norm.clamp_min(1e-12)


def convert_waveglow_state_dict(sd: Mapping[str, torch.Tensor],
                                cfg: WaveGlowConfig
                                ) -> Dict[str, torch.Tensor]:
    """A published WaveGlow state_dict -> the state_dict of
    ``WaveGlow(cfg)``."""
    sd = {k[7:] if k.startswith("module.") else k: torch.as_tensor(v)
          for k, v in sd.items()}
    out = {"upsample.weight": sd["upsample.weight"].float(),
           "upsample.bias": sd["upsample.bias"].float()}
    for i in range(cfg.n_flows):
        out[f"convinv.{i}.conv.weight"] = sd[
            f"convinv.{i}.conv.weight"].float()
        pre = f"WN.{i}"
        names = ["start", "end"] + [
            f"{layer}.{j}" for layer in ("in_layers", "res_skip_layers")
            for j in range(cfg.wn_layers)]
        if f"{pre}.cond_layer.bias" in sd:
            names.append("cond_layer")
        else:  # per-layer cond convs
            out[f"{pre}.cond_layer.weight"] = torch.cat(
                [_weight(sd, f"{pre}.cond_layers.{j}")
                 for j in range(cfg.wn_layers)])
            out[f"{pre}.cond_layer.bias"] = torch.cat(
                [sd[f"{pre}.cond_layers.{j}.bias"].float()
                 for j in range(cfg.wn_layers)])
        for name in names:
            out[f"{pre}.{name}.weight"] = _weight(sd, f"{pre}.{name}")
            out[f"{pre}.{name}.bias"] = sd[f"{pre}.{name}.bias"].float()
    return out


def load_waveglow_checkpoint(path: str,
                             cfg: WaveGlowConfig = WaveGlowConfig(),
                             device: Union[str, torch.device] = "cuda"
                             ) -> WaveGlow:
    """A published WaveGlow ``.pt`` -> ``WaveGlow(cfg)`` on ``device`` (the
    card unless the caller asks for the CPU, as every entry point). The
    published file holds a pickled module (``{"model": WaveGlow}``), so it
    is read with ``weights_only=False``, which runs code from the file: load
    only files you trust, with the published ``glow`` module importable. A
    file holding a state_dict, bare or under ``"model"`` or
    ``"state_dict"``, loads the same way."""
    device = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict):
        blob = blob.get("model", blob.get("state_dict", blob))
    sd = blob.state_dict() if hasattr(blob, "state_dict") else blob
    model = WaveGlow(cfg)
    model.load_state_dict(convert_waveglow_state_dict(sd, cfg), strict=True)
    return model.to(device).eval()
