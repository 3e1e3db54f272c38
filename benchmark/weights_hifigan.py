"""HiFi-GAN generator weights made from the seed on the device, in one
draw, keyed by the published state_dict's names (weight norm folded).

The paper's N(0, 0.01) init gives audio of about 1e-4 at V1's widths,
where a fault in the last layers hides under fp32 rounding. So each
weight is N(0, (GAIN / sqrt(fan_in))^2), fan_in the inputs that reach one
output (C_in x k for a convolution, C_in x k / stride for a transposed
one), and each bias N(0, BIAS_STD^2). The audio grows about tenfold
from a gain of 1.0 to 1.3 (four stages of seven convolutions in series);
at 1.15, on the served mels of the seed's Tacotron 2 (standard deviation
0.12-0.16), the audio's largest |value| lies between 0.1 and 0.9, below
tanh's knee.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import weights
from benchmark.reference import hifigan as ref

GAIN = 1.15
BIAS_STD = 0.01


def _std(name: str, shape) -> float:
    if name.endswith(".bias"):
        return BIAS_STD
    if name.startswith("ups."):
        return GAIN / math.sqrt(shape[0] * shape[2])
    return GAIN / math.sqrt(shape[1] * shape[2])


def _strides(d: ref.Dims) -> Dict[str, int]:
    return {f"ups.{i}.weight": u for i, u in enumerate(d.upsample_rates)}


def generator(v: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The generator's state_dict in fp32 on ``device`` for the vocoder
    block ``v`` of a configuration."""
    d = ref.Dims.of(v)
    leaves = ref.shapes(d)
    stride = _strides(d)
    total = sum(math.prod(sh) for _, sh in leaves)
    z = torch.randn(total, generator=weights._generator(seed, device, 2),
                    device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in leaves:
        k = math.prod(shape)
        std = _std(name, shape) * math.sqrt(stride.get(name, 1))
        out[name] = (z[at:at + k] * std).view(shape)
        at += k
    return out
