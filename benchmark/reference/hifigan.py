"""HiFi-GAN V1's generator in plain torch: jik876/hifi-gan ``models.py``,
``Generator.forward`` with ``ResBlock1``, as that file writes it.

    x = conv_pre(mel)
    for each upsampling i:
        x = leaky_relu(x, 0.1); x = ups[i](x)
        x = mean over the kernels j of resblocks[i * kernels + j](x)
    x = leaky_relu(x)            # F.leaky_relu's default slope, 0.01
    audio = tanh(conv_post(x))

    ResBlock1(x): for each dilation d:
        x = x + convs2[d](leaky_relu(convs1[d](leaky_relu(x, 0.1)), 0.1))

Weights are keyed by the published state_dict's names with weight norm
folded, as ``remove_weight_norm`` leaves them at inference
(``conv_pre.weight``, ``ups.<i>.weight``,
``resblocks.<k>.convs1.<j>.weight``, ``conv_post.weight`` and their
``.bias``). It imports nothing of the program and nothing of JAX.

Departures from the published file, each with its reason:
- no ``weight_norm`` modules: the weights come folded, as at inference;
- functions over a dict of tensors instead of ``nn.Module``s, so that
  ``rnd`` can round both operands of every convolution (the control of
  ``correct`` computes the reference in bf16 this way);
- the mel comes channels first, (B, n_mels, T), as the published
  ``forward`` takes it, and the audio leaves as (B, T * hop), the
  published (B, 1, T * hop) without its channel axis.
The caller turns TF32 off, so that the reference computes in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1          # models.py's module constant
POST_SLOPE = 0.01          # F.leaky_relu's default, before conv_post


class Dims(NamedTuple):
    n_mels: int
    upsample_rates: Tuple[int, ...]
    upsample_kernel_sizes: Tuple[int, ...]
    upsample_initial_channel: int
    resblock_kernel_sizes: Tuple[int, ...]
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...]

    @classmethod
    def of(cls, v: dict) -> "Dims":
        """From a configuration's ``vocoder`` block (config_v1.json's
        keys)."""
        if str(v.get("resblock", "1")) != "1":
            raise ValueError("only ResBlock1 (resblock \"1\") is written")
        return cls(int(v["num_mels"]), tuple(v["upsample_rates"]),
                   tuple(v["upsample_kernel_sizes"]),
                   int(v["upsample_initial_channel"]),
                   tuple(v["resblock_kernel_sizes"]),
                   tuple(tuple(d) for d in v["resblock_dilation_sizes"]))

    @property
    def hop(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """models.py's ``get_padding`` (utils.py)."""
    return int((kernel_size * dilation - dilation) / 2)


def shapes(d: Dims) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight and bias, in the published order."""
    out = [("conv_pre.weight", (d.upsample_initial_channel, d.n_mels, 7)),
           ("conv_pre.bias", (d.upsample_initial_channel,))]
    ch = d.upsample_initial_channel
    for i, k in enumerate(d.upsample_kernel_sizes):
        out += [(f"ups.{i}.weight", (ch, ch // 2, k)),
                (f"ups.{i}.bias", (ch // 2,))]
        ch //= 2
    ch = d.upsample_initial_channel
    n = 0
    for i in range(len(d.upsample_rates)):
        ch //= 2
        for k, dils in zip(d.resblock_kernel_sizes,
                           d.resblock_dilation_sizes):
            for part in ("convs1", "convs2"):
                for j in range(len(dils)):
                    out += [(f"resblocks.{n}.{part}.{j}.weight", (ch, ch, k)),
                            (f"resblocks.{n}.{part}.{j}.bias", (ch,))]
            n += 1
    out += [("conv_post.weight", (1, ch, 7)), ("conv_post.bias", (1,))]
    return out


def _conv(x, W, name, rnd, **kw):
    return F.conv1d(rnd(x), rnd(W[name + ".weight"]), W[name + ".bias"],
                    **kw)


def resblock1(x: torch.Tensor, W: Dict[str, torch.Tensor], prefix: str,
              kernel: int, dilations, rnd) -> torch.Tensor:
    for j, dil in enumerate(dilations):
        xt = F.leaky_relu(x, LRELU_SLOPE)
        xt = _conv(xt, W, f"{prefix}.convs1.{j}", rnd, dilation=dil,
                   padding=get_padding(kernel, dil))
        xt = F.leaky_relu(xt, LRELU_SLOPE)
        xt = _conv(xt, W, f"{prefix}.convs2.{j}", rnd,
                   padding=get_padding(kernel, 1))
        x = xt + x
    return x


@torch.no_grad()
def generator(W: Dict[str, torch.Tensor], mel: torch.Tensor, d: Dims,
              rnd: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
              ) -> torch.Tensor:
    """(B, n_mels, T) mel -> (B, T * hop) audio, in fp32; ``rnd`` rounds
    both operands of every convolution (identity: none)."""
    x = _conv(mel.float(), W, "conv_pre", rnd, padding=3)
    kernels = len(d.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(d.upsample_rates,
                                   d.upsample_kernel_sizes)):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = F.conv_transpose1d(rnd(x), rnd(W[f"ups.{i}.weight"]),
                               W[f"ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        xs = None
        for j, (rk, dils) in enumerate(zip(d.resblock_kernel_sizes,
                                           d.resblock_dilation_sizes)):
            y = resblock1(x, W, f"resblocks.{i * kernels + j}", rk, dils,
                          rnd)
            xs = y if xs is None else xs + y
        x = xs / kernels
    x = F.leaky_relu(x, POST_SLOPE)
    x = _conv(x, W, "conv_post", rnd, padding=3)
    return torch.tanh(x)[:, 0]


def bf16(t: torch.Tensor) -> torch.Tensor:
    """An operand rounded to bf16 and back (the control's rounding)."""
    return t.to(torch.bfloat16).to(t.dtype)
