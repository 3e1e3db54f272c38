"""The operations and bytes of HiFi-GAN's generator, from the widths of a
configuration's ``vocoder`` block (config_v1.json's keys), in the counting
of ``benchmark/work.py``: 2 FLOPs a multiply-add, and every convolution's
input read once, its weights and bias read once and its output written
once, in fp32. The elementwise work between the convolutions (leaky ReLUs,
residual sums, the mean of the fan, tanh) is left out of both: a generator
that fused it into the convolutions would not move those bytes.

At V1's widths a mel frame costs 0.614 GFLOP: 132M, 264M, 132M and 66M in
the four stages' ResBlock fans, 19.5M in the transposed convolutions and
the two end convolutions.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.reference import hifigan as ref

Work = Tuple[float, float]  # (bytes, FLOPs)
F32 = 4


def _conv(t_out: int, c_in: int, c_out: int, k: int) -> Work:
    """A stride-1 convolution over ``t_out`` samples."""
    nbytes = (t_out * (c_in + c_out) + c_out * c_in * k + c_out) * F32
    return nbytes, 2.0 * t_out * c_out * c_in * k


def _up(t_in: int, c_in: int, c_out: int, k: int, stride: int) -> Work:
    """A transposed convolution: each of ``t_in`` input samples scatters
    ``k`` taps to ``c_out`` channels."""
    nbytes = (t_in * c_in + t_in * stride * c_out + c_in * c_out * k
              + c_out) * F32
    return nbytes, 2.0 * t_in * c_in * c_out * k


def generator_work(v: dict, frames: int) -> Work:
    """(bytes, FLOPs) of one generator pass over ``frames`` mel frames."""
    d = ref.Dims.of(v)
    parts = [_conv(frames, d.n_mels, d.upsample_initial_channel, 7)]
    ch, t = d.upsample_initial_channel, frames
    for u, k in zip(d.upsample_rates, d.upsample_kernel_sizes):
        parts.append(_up(t, ch, ch // 2, k, u))
        ch, t = ch // 2, t * u
        for rk, dils in zip(d.resblock_kernel_sizes,
                            d.resblock_dilation_sizes):
            parts += [_conv(t, ch, ch, rk)] * (2 * len(dils))
    parts.append(_conv(t, ch, 1, 7))
    return (sum(b for b, _ in parts), sum(f for _, f in parts))
