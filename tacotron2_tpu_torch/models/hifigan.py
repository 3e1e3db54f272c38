"""HiFi-GAN vocoder generator (mel -> waveform) in PyTorch.

Counterpart of the generator of the JAX package's ``models/hifigan.py``
(HiFi-GAN, arXiv:2010.05646, V1): a fully convolutional feed-forward stack
of transposed-conv upsampling stages, each followed by the averaged
multi-receptive-field ResBlock fan. Weight norm is dropped, as there; init
is the paper's N(0, 0.01). Module names follow the HiFi-GAN reference
implementation (``conv_pre``, ``ups``, ``resblocks`` flat by stage and
kernel, ``convs1``/``convs2``, ``conv_post``); ``generator`` takes the
module where the JAX package takes its params and keeps its channels-last
``(B, T_mel, n_mels)`` input. Every convolution goes to PyTorch's own
(cuDNN on a CUDA device), as the JAX package leaves them to XLA. The
discriminators and losses come with vocoder training.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from tacotron2_tpu_torch.ops.layers import conv1d, conv_transpose1d

LRELU_SLOPE = 0.1


class HiFiGANConfig(NamedTuple):
    n_mel_channels: int = 80
    # generator (V1 of the paper)
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def receptive_field_frames(cfg: HiFiGANConfig) -> int:
    """One-sided receptive field of the generator in input mel frames: an
    output sample at time t depends on mel frames [t/hop - R, t/hop + R].
    Streaming synthesis uses R as the context margin of chunked vocoding.
    Walks the network backward, converting the needed context to each
    stage's input resolution (conservative ceilings). Default V1: 15."""
    # sequential residual units accumulate context; parallel kernels take max
    resblock_ctx = max(
        sum(d * (k - 1) // 2 + (k - 1) // 2 for d in dils)
        for k, dils in zip(cfg.resblock_kernel_sizes,
                           cfg.resblock_dilation_sizes))
    r = 3  # conv_post k=7 at output resolution
    for i in reversed(range(len(cfg.upsample_rates))):
        r += resblock_ctx  # resblock fan at this stage's output resolution
        k, s = cfg.upsample_kernel_sizes[i], cfg.upsample_rates[i]
        r = -(-r // s) + -(-k // s)  # ceil(r/s) + ceil(k/s)
    return r + 3  # conv_pre k=7 at mel resolution


class ResBlock(nn.Module):
    """Multi-receptive-field residual unit (ResBlock1 of the paper)."""

    def __init__(self, channels: int, kernel: int, dilations):
        super().__init__()
        same = lambda d: nn.Conv1d(channels, channels, kernel, dilation=d,
                                   padding=d * (kernel - 1) // 2)
        self.convs1 = nn.ModuleList([same(d) for d in dilations])
        self.convs2 = nn.ModuleList([same(1) for _ in dilations])


class Generator(nn.Module):
    """The generator's module tree; ``init_params`` draws N(0, 0.01)
    weights from a ``torch.Generator`` and zero biases. The parameters take
    no gradient (serving)."""

    def __init__(self, cfg: HiFiGANConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.n_mel_channels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, stride=u,
                                               padding=(k - u) // 2))
            ch //= 2
            for rk, dils in zip(cfg.resblock_kernel_sizes,
                                cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, dils))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self.init_params(generator)
        self.eval()
        self.requires_grad_(False)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.01)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, LRELU_SLOPE)


def _resblock(block: ResBlock, x: torch.Tensor, dilations,
              compute_dtype=None) -> torch.Tensor:
    """Per dilation d: x += conv_k1(lrelu(conv_kd(lrelu(x))))."""
    for c1, c2, d in zip(block.convs1, block.convs2, dilations):
        xt = conv1d(_leaky(x), c1.weight, c1.bias, compute_dtype, dilation=d)
        xt = conv1d(_leaky(xt), c2.weight, c2.bias, compute_dtype)
        x = x + xt
    return x


def generator(model: Generator, mel: torch.Tensor, cfg: HiFiGANConfig,
              compute_dtype=None) -> torch.Tensor:
    """(B, T_mel, n_mels) -> (B, T_mel * hop) fp32 waveform in (-1, 1)."""
    x = mel if compute_dtype is None else mel.to(compute_dtype)
    x = conv1d(x, model.conv_pre.weight, model.conv_pre.bias, compute_dtype)
    n_res = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(model.ups):
        x = conv_transpose1d(_leaky(x), up.weight, up.bias,
                             stride=cfg.upsample_rates[i],
                             compute_dtype=compute_dtype)
        acc = None
        for j, dils in enumerate(cfg.resblock_dilation_sizes):
            y = _resblock(model.resblocks[i * n_res + j], x, dils,
                          compute_dtype)
            acc = y if acc is None else acc + y
        x = acc / n_res
    x = conv1d(_leaky(x), model.conv_post.weight, model.conv_post.bias,
               compute_dtype)
    return torch.tanh(x[..., 0]).float()
