"""WaveGlow flow vocoder (mel -> waveform) in PyTorch.

Counterpart of the JAX package's ``models/waveglow.py`` (WaveGlow,
arXiv:1811.00002; the vocoder of the reference notebook, which calls
``waveglow.infer(mel, sigma=0.666)`` and a ``Denoiser``): audio squeezed
into groups of ``n_group`` samples, ``n_flows`` steps of [invertible 1x1
conv -> affine coupling], each coupling's (t, log s) from a WaveNet-style
gated dilated-conv stack (``WN``) conditioned on transposed-conv-upsampled
mels, ``n_early_size`` channels put out early every ``n_early_every``
flows.

The module tree keeps the published torch WaveGlow's names and layouts
(``upsample``, ``convinv.<i>.conv``, ``WN.<i>.{start, in_layers,
res_skip_layers, cond_layer, end}``) without weight normalisation, so that
``convert_waveglow`` only folds g * v / ||v|| into each weight. As there,
activations are (B, C, T) and the 1x1 conv applies z = W x; the JAX
package keeps (B, T, C) and applies x @ W^T. One fused ``cond_layer`` per
flow gives every WN layer's conditioning (the JAX package has one conv per
layer; the concatenation is the same function). ``z`` is (B, n_group,
T_groups) here and (B, T_groups, n_group) there.

Plain torch throughout, as the JAX package leaves it to XLA: every conv
goes to PyTorch's own (cuDNN on a CUDA device, in TF32 when
``torch.backends.cudnn.allow_tf32`` is on, PyTorch's default) and the 1x1
products to ``torch.matmul``. ``infer`` applies the inverse 1x1 weights,
computed once per set of weights on the host in float64
(``WaveGlow.inverse_weights``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn


class WaveGlowConfig(NamedTuple):
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    # WN conditioner
    wn_layers: int = 8
    wn_channels: int = 256
    wn_kernel_size: int = 3
    # mel upsampling (matches hop 256 at 22.05 kHz)
    upsample_kernel: int = 1024
    upsample_stride: int = 256
    sigma: float = 1.0  # training prior std; inference uses sigma=0.666

    @property
    def hop_length(self) -> int:
        """Samples per mel frame."""
        return self.upsample_stride


def _is_early(cfg: WaveGlowConfig, flow_index: int) -> bool:
    """Whether ``n_early_size`` channels leave before flow ``flow_index``."""
    return flow_index % cfg.n_early_every == 0 and flow_index > 0


def remaining_channels(cfg: WaveGlowConfig, flow_index: int) -> int:
    """Channels still in the flow when step ``flow_index`` runs."""
    return cfg.n_group - cfg.n_early_size * sum(
        _is_early(cfg, k) for k in range(flow_index + 1))


class Invertible1x1(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv1d(c, c, 1, bias=False)


class WN(nn.Module):
    """One flow's conditioner: start, ``wn_layers`` gated dilated convs
    with fused residual/skip outputs, one fused cond conv, end."""

    def __init__(self, half: int, n_out: int, cfg: WaveGlowConfig):
        super().__init__()
        n, k, L = cfg.wn_channels, cfg.wn_kernel_size, cfg.wn_layers
        self.start = nn.Conv1d(half, n, 1)
        self.cond_layer = nn.Conv1d(cfg.n_mel_channels * cfg.n_group,
                                    2 * n * L, 1)
        self.in_layers = nn.ModuleList(
            nn.Conv1d(n, 2 * n, k, dilation=2 ** j,
                      padding=2 ** j * (k - 1) // 2) for j in range(L))
        self.res_skip_layers = nn.ModuleList(
            nn.Conv1d(n, 2 * n if j < L - 1 else n, 1) for j in range(L))
        self.end = nn.Conv1d(n, n_out, 1)


class WaveGlow(nn.Module):
    """The flow's module tree; ``init_params`` draws the JAX package's
    initialisation from a ``torch.Generator``: conv weights N(0, 1/fan_in),
    zero biases, each 1x1 weight a random rotation (det +1), and ``WN.end``
    zero, so that every fresh coupling is the identity."""

    def __init__(self, cfg: WaveGlowConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        mel = cfg.n_mel_channels
        self.upsample = nn.ConvTranspose1d(mel, mel, cfg.upsample_kernel,
                                           stride=cfg.upsample_stride)
        self.convinv = nn.ModuleList()
        self.WN = nn.ModuleList()
        for i in range(cfg.n_flows):
            c = remaining_channels(cfg, i)
            self.convinv.append(Invertible1x1(c))
            self.WN.append(WN(c // 2, 2 * (c - c // 2), cfg))
        self._inverse: Tuple[tuple, List[torch.Tensor]] = ((), [])
        self.init_params(generator)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> None:
        for name, p in self.named_parameters():
            if name.endswith("bias") or ".end." in name:
                p.zero_()
            elif name.startswith("convinv."):
                c = p.shape[0]
                q = torch.linalg.qr(torch.randn(c, c, generator=generator,
                                                dtype=torch.float64))[0]
                if torch.linalg.det(q) < 0:
                    q[:, 0] = -q[:, 0]
                p.copy_(q[:, :, None])
            else:
                fan = p.shape[1] * p.shape[2]
                if name.startswith("upsample."):  # (in, out, k)
                    fan = p.shape[0] * p.shape[2]
                p.copy_(torch.randn(p.shape, generator=generator)
                        / np.sqrt(fan))

    def inverse_weights(self) -> List[torch.Tensor]:
        """Each flow's W^-1 (c, c) on the weights' device: inverted once on
        the host in float64 per set of weights (a weight written in place,
        by an optimizer or ``load_state_dict``, or moved, is inverted
        again). Two threads may both invert a new set; the pair of key and
        inverses is replaced in one assignment."""
        ws = [inv.conv.weight for inv in self.convinv]
        key = tuple((w.device, w.data_ptr(), w._version) for w in ws)
        cached_key, inverses = self._inverse
        if cached_key != key:
            inverses = [torch.linalg.inv(w.detach()[:, :, 0].cpu().double())
                        .to(w.device, torch.float32) for w in ws]
            self._inverse = (key, inverses)
        return inverses


class FlowOutput(NamedTuple):
    z: torch.Tensor              # (B, n_group, T_groups) latent
    log_s_total: torch.Tensor    # () sum of every coupling's log s
    log_det_total: torch.Tensor  # () B * T_groups * sum of log |det W|


def upsample_mel(model: WaveGlow, mel: torch.Tensor,
                 cfg: WaveGlowConfig) -> torch.Tensor:
    """(B, T_mel, n_mel) -> (B, n_mel * n_group, T_groups): the transposed
    conv to the sample rate, its tail trimmed to T_mel * stride, folded
    into groups with channel mel * n_group + g (WaveGlow's unfold order)."""
    y = model.upsample(mel.float().transpose(1, 2))
    B, C, _ = y.shape
    t_groups = mel.shape[1] * cfg.upsample_stride // cfg.n_group
    y = y[:, :, :t_groups * cfg.n_group]
    return (y.reshape(B, C, t_groups, cfg.n_group).permute(0, 1, 3, 2)
            .reshape(B, C * cfg.n_group, t_groups))


def wn_conditioner(wn: WN, x_half: torch.Tensor, cond: torch.Tensor,
                   cfg: WaveGlowConfig) -> torch.Tensor:
    """The gated dilated-conv stack: x_half (B, half, T), cond
    (B, n_mel * n_group, T) -> (B, 2 * (c - half), T), (t, log s)."""
    n = cfg.wn_channels
    h = wn.start(x_half)
    cond_all = wn.cond_layer(cond)
    skip_total = None
    for j, (in_layer, res_skip) in enumerate(zip(wn.in_layers,
                                                 wn.res_skip_layers)):
        z = in_layer(h) + cond_all[:, 2 * n * j:2 * n * (j + 1)]
        rs = res_skip(torch.tanh(z[:, :n]) * torch.sigmoid(z[:, n:]))
        if j < cfg.wn_layers - 1:
            h = h + rs[:, :n]
            rs = rs[:, n:]
        skip_total = rs if skip_total is None else skip_total + rs
    return wn.end(skip_total)


def forward(model: WaveGlow, audio: torch.Tensor, mel: torch.Tensor,
            cfg: WaveGlowConfig) -> FlowOutput:
    """Training direction, audio -> z. audio (B, T_samples) in [-1, 1],
    mel (B, T_mel, n_mel) aligned with it (T_samples = T_mel * stride)."""
    cond = upsample_mel(model, mel, cfg)
    B, _, t_groups = cond.shape
    x = (audio[:, :t_groups * cfg.n_group].float()
         .reshape(B, t_groups, cfg.n_group).transpose(1, 2))
    outputs = []
    log_s_total = log_det_total = cond.new_zeros(())
    for i, (inv, wn) in enumerate(zip(model.convinv, model.WN)):
        if _is_early(cfg, i):
            outputs.append(x[:, :cfg.n_early_size])
            x = x[:, cfg.n_early_size:]
        w = inv.conv.weight[:, :, 0]
        x = torch.matmul(w, x)
        log_det_total = (log_det_total
                         + torch.linalg.slogdet(w)[1] * (B * t_groups))
        half = x.shape[1] // 2
        xa, xb = x[:, :half], x[:, half:]
        ls_t = wn_conditioner(wn, xa, cond, cfg)
        t, log_s = ls_t[:, :half], ls_t[:, half:]
        xb = xb * torch.exp(log_s) + t
        log_s_total = log_s_total + log_s.sum()
        x = torch.cat([xa, xb], dim=1)
    outputs.append(x)
    return FlowOutput(torch.cat(outputs, dim=1), log_s_total, log_det_total)


def loss(flow_out: FlowOutput, sigma: float = 1.0) -> torch.Tensor:
    """Negative log-likelihood per element (the WaveGlow objective)."""
    z, log_s_total, log_det_total = flow_out
    return ((z * z).sum() / (2 * sigma * sigma) - log_s_total
            - log_det_total) / z.numel()


@torch.no_grad()
def infer(model: WaveGlow, mel: torch.Tensor, cfg: WaveGlowConfig,
          sigma: float = 0.666, generator: Optional[torch.Generator] = None,
          z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference direction, z -> audio: (B, T_mel, n_mel) ->
    (B, T_mel * stride), parallel over time. ``z`` (B, n_group, T_groups)
    is the latent itself (``forward``'s z gives its audio back); without
    it z is N(0, sigma^2) from ``generator`` (on the mel's device; seed 0
    without one)."""
    cond = upsample_mel(model, mel, cfg)
    B, _, t_groups = cond.shape
    if z is None:
        if generator is None:
            generator = torch.Generator(device=cond.device).manual_seed(0)
        z = torch.randn(B, cfg.n_group, t_groups, generator=generator,
                        device=cond.device) * sigma
    early = [i for i in range(cfg.n_flows) if _is_early(cfg, i)]
    s = cfg.n_early_size
    x = z[:, len(early) * s:]
    inverses = model.inverse_weights()
    for i in reversed(range(cfg.n_flows)):
        half = x.shape[1] // 2
        xa, xb = x[:, :half], x[:, half:]
        ls_t = wn_conditioner(model.WN[i], xa, cond, cfg)
        t, log_s = ls_t[:, :half], ls_t[:, half:]
        xb = (xb - t) * torch.exp(-log_s)
        x = torch.matmul(inverses[i], torch.cat([xa, xb], dim=1))
        if _is_early(cfg, i):
            k = early.index(i)
            x = torch.cat([z[:, k * s:(k + 1) * s], x], dim=1)
    return x.transpose(1, 2).reshape(B, t_groups * cfg.n_group)
