"""HiFi-GAN vocoder generator (mel -> waveform) in PyTorch.

Counterpart of the generator of the JAX package's ``models/hifigan.py``
(HiFi-GAN, arXiv:2010.05646, V1): a fully convolutional feed-forward stack
of transposed-conv upsampling stages, each followed by the averaged
multi-receptive-field ResBlock fan. Weight norm is dropped, as there; init
is the paper's N(0, 0.01). Every leaky ReLU has slope 0.1 but the one
before ``conv_post``, whose slope is ``HiFiGANConfig.post_lrelu_slope``:
by default 0.01, ``F.leaky_relu``'s default, which the published generator
(jik876/hifi-gan ``Generator.forward``) takes there; the JAX package
applies 0.1 there, so a comparison with it passes 0.1. Module names
follow the HiFi-GAN reference implementation (``conv_pre``, ``ups``,
``resblocks`` flat by stage and kernel, ``convs1``/``convs2``,
``conv_post``); ``generator`` takes the module where the JAX package
takes its params and keeps its channels-last ``(B, T_mel, n_mels)``
input. Every convolution goes to PyTorch's own
(cuDNN on a CUDA device), as the JAX package leaves them to XLA.

For training, ``MultiPeriodDiscriminator`` and ``MultiScaleDiscriminator``
(the reference implementation's names: ``discriminators.<i>.convs.<j>``,
``conv_post``), ``discriminate`` and the three losses: LSGAN for the
discriminators and the generator, and feature matching. The
discriminators' activations are (B, C, T) and, in MPD, (B, C, T / period,
period); the JAX package keeps channels last, which changes no logit,
no loss and only the layout of the feature maps.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
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
    # the leaky ReLU before conv_post (the others are LRELU_SLOPE)
    post_lrelu_slope: float = 0.01
    # discriminators
    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3

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


@torch.no_grad()
def _init_normal(module: nn.Module,
                 generator: Optional[torch.Generator]) -> None:
    """N(0, 0.01) weights from ``generator``, zero biases (the paper's)."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator) * 0.01)


class Generator(nn.Module):
    """The generator's module tree; ``init_params`` draws N(0, 0.01)
    weights from a ``torch.Generator`` and zero biases. The parameters take
    no gradient (serving) unless ``trainable``."""

    def __init__(self, cfg: HiFiGANConfig,
                 generator: Optional[torch.Generator] = None,
                 trainable: bool = False):
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
        self.train(trainable)
        self.requires_grad_(trainable)

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        _init_normal(self, generator)


def _leaky(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, slope)


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
    x = conv1d(_leaky(x, cfg.post_lrelu_slope), model.conv_post.weight,
               model.conv_post.bias, compute_dtype)
    return torch.tanh(x[..., 0]).float()


# ------------------------------------------------- multi-period discriminator

MPD_CHANNELS = (32, 128, 512, 1024)


class PeriodDiscriminator(nn.Module):
    """(5, 1) conv2d stack, stride 3 along time, over the (T / p, p) view."""

    def __init__(self):
        super().__init__()
        conv = lambda cin, cout, s: nn.Conv2d(cin, cout, (5, 1), (s, 1),
                                              padding=(2, 0))
        chans = (1,) + MPD_CHANNELS
        self.convs = nn.ModuleList(
            [conv(a, b, 3) for a, b in zip(chans, chans[1:])]
            + [conv(chans[-1], 1024, 1)])
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))


class MultiPeriodDiscriminator(nn.Module):
    """One ``PeriodDiscriminator`` per period of ``cfg.mpd_periods``,
    N(0, 0.01) from ``generator``."""

    def __init__(self, cfg: HiFiGANConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.periods = tuple(cfg.mpd_periods)
        self.discriminators = nn.ModuleList(
            PeriodDiscriminator() for _ in self.periods)
        _init_normal(self, generator)


def mpd_apply(d: PeriodDiscriminator, audio: torch.Tensor, period: int
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One period discriminator: audio (B, T), reflect-padded to a
    multiple of ``period`` and viewed as a (T / period, period) image of
    one channel -> (logits (B, n), feature maps)."""
    B, T = audio.shape
    if T % period:
        audio = F.pad(audio[:, None], (0, period - T % period),
                      mode="reflect")[:, 0]
    x = audio.reshape(B, 1, -1, period)
    fmaps = []
    for conv in d.convs:
        x = _leaky(conv(x))
        fmaps.append(x)
    x = d.conv_post(x)
    fmaps.append(x)
    return x.reshape(B, -1), fmaps


# -------------------------------------------------- multi-scale discriminator

# (kernel, stride, groups, channels) per conv of one scale discriminator
MSD_SPEC = ((15, 1, 1, 128), (41, 2, 4, 128), (41, 2, 16, 256),
            (41, 4, 16, 512), (41, 4, 16, 1024), (41, 1, 16, 1024),
            (5, 1, 1, 1024))


class ScaleDiscriminator(nn.Module):
    """Grouped strided conv1d stack over raw audio."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 1
        for k, stride, groups, ch in MSD_SPEC:
            convs.append(nn.Conv1d(cin, ch, k, stride, padding=(k - 1) // 2,
                                   groups=groups))
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv1d(cin, 1, 3, 1, padding=1)


class MultiScaleDiscriminator(nn.Module):
    """``cfg.msd_scales`` ``ScaleDiscriminator``s, N(0, 0.01) from
    ``generator``."""

    def __init__(self, cfg: HiFiGANConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            ScaleDiscriminator() for _ in range(cfg.msd_scales))
        _init_normal(self, generator)


def msd_apply(d: ScaleDiscriminator, audio: torch.Tensor
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One scale discriminator over (B, T) audio -> (logits, fmaps)."""
    x = audio[:, None]
    fmaps = []
    for conv in d.convs:
        x = _leaky(conv(x))
        fmaps.append(x)
    x = d.conv_post(x)
    fmaps.append(x)
    return x.reshape(x.shape[0], -1), fmaps


def discriminate(mpd: MultiPeriodDiscriminator,
                 msd: MultiScaleDiscriminator, audio: torch.Tensor
                 ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
    """Every discriminator on (B, T) audio: MPD over each period, then MSD
    over each scale, each scale after the first average-pooled (window 4,
    stride 2, padding 2) from the one before. Returns (logits per
    discriminator, feature maps per discriminator)."""
    logits, fmaps = [], []
    for d, period in zip(mpd.discriminators, mpd.periods):
        lg, fm = mpd_apply(d, audio, period)
        logits.append(lg)
        fmaps.append(fm)
    x = audio
    for s, d in enumerate(msd.discriminators):
        if s > 0:
            x = F.avg_pool1d(x[:, None], 4, 2, padding=2)[:, 0]
        lg, fm = msd_apply(d, x)
        logits.append(lg)
        fmaps.append(fm)
    return logits, fmaps


# ------------------------------------------------------------------ losses

def discriminator_loss(real_logits: List[torch.Tensor],
                       fake_logits: List[torch.Tensor]) -> torch.Tensor:
    """LSGAN objective: real -> 1, fake -> 0 (paper eq. 1)."""
    return sum(torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
               for dr, dg in zip(real_logits, fake_logits))


def generator_adversarial_loss(fake_logits: List[torch.Tensor]
                               ) -> torch.Tensor:
    return sum(torch.mean((1.0 - dg) ** 2) for dg in fake_logits)


def feature_matching_loss(real_fmaps: List[List[torch.Tensor]],
                          fake_fmaps: List[List[torch.Tensor]]
                          ) -> torch.Tensor:
    """L1 between the discriminators' activations on real and generated
    audio (paper eq. 3), times 2 as the reference implementation."""
    return 2.0 * sum(torch.mean(torch.abs(fr - fg))
                     for fr_list, fg_list in zip(real_fmaps, fake_fmaps)
                     for fr, fg in zip(fr_list, fg_list))
