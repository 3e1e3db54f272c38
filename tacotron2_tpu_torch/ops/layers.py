"""Core NN primitives: dense, conv1d, eval-mode batchnorm, dropout, masking.

Functional counterparts of the JAX package's ``ops/layers.py``. Activations
keep the JAX package's channels-last layout ``(B, T, C)`` at every public
function; weights keep torch's own layouts (dense ``(out, in)``, conv
``(out, in, k)``), as the modules of ``models/tacotron2.py`` hold them.

Mixed precision follows the JAX package: with a ``compute_dtype`` the
operands are cast to it and the product comes back in it (fp32 accumulation
inside), and an fp32 bias add promotes the result to fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _cast(x: torch.Tensor, w: torch.Tensor, compute_dtype):
    dtype = compute_dtype or torch.float32
    return x.to(dtype), w.to(dtype)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (..., in), weight: (out, in) -> (..., out)."""
    xc, wc = _cast(x, weight, compute_dtype)
    y = torch.matmul(xc, wc.t())
    if bias is not None:
        y = y + bias
    return y


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           compute_dtype: Optional[torch.dtype] = None, *,
           dilation: int = 1) -> torch.Tensor:
    """SAME conv over time. x: (B, T, C_in), weight: (C_out, C_in, k) with k
    odd -> (B, T, C_out) (reference layers.py:26-27 auto padding,
    dilation * (k - 1) / 2)."""
    xc, wc = _cast(x, weight, compute_dtype)
    k = weight.shape[-1]
    y = F.conv1d(xc.transpose(1, 2), wc, padding=dilation * (k - 1) // 2,
                 dilation=dilation)
    y = y.transpose(1, 2)
    if bias is not None:
        y = y + bias
    return y


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, stride: int,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Fractionally-strided conv with torch ConvTranspose1d semantics at
    padding=(k-stride)//2: x (B, T, C_in), weight (C_in, C_out, k) ->
    (B, T*stride, C_out). The JAX package's ``conv_transpose1d``: the full
    transposed conv, (T-1)*stride + k long, with (k-stride)//2 trimmed from
    the front and T*stride kept (the vocoder upsampling stacks)."""
    xc, wc = _cast(x, weight, compute_dtype)
    k = weight.shape[-1]
    y = F.conv_transpose1d(xc.transpose(1, 2), wc, stride=stride)
    pad = (k - stride) // 2
    y = y[:, :, pad:pad + x.shape[1] * stride].transpose(1, 2)
    if bias is not None:
        y = y + bias
    return y


def batchnorm(x: torch.Tensor, running_mean: torch.Tensor,
              running_var: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode per-channel batchnorm over (B, T, C) with running
    statistics (torch BatchNorm1d semantics); keeps x's dtype."""
    inv = torch.rsqrt(running_var + eps) * weight
    y = (x - running_mean) * inv + bias
    return y.to(x.dtype)


def batchnorm_train(x: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, momentum: float = 0.1,
                    eps: float = 1e-5):
    """Training-mode batchnorm over (B, T, C) (the JAX package's
    ``batchnorm(training=True)``): normalise with the batch statistics over
    (B, T) in fp32. Returns (y in x's dtype, new running mean, new running
    var), the running estimates as values (momentum convention
    new = (1-m)*old + m*batch, the unbiased variance going in), so that a
    caller can still keep the old ones; nothing is updated in place."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 1))
    var = (x32 - mean).square().mean(dim=(0, 1))
    n = x.shape[0] * x.shape[1]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    y = (x - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(x.dtype), new_mean, new_var


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (torch F.dropout semantics). ``keep`` feeds a 0/1
    keep mask drawn elsewhere (tests hand in the JAX package's masks);
    otherwise the mask is drawn from ``generator``."""
    if keep is None:
        if deterministic or rate == 0.0:
            return x
        u = torch.rand(x.shape, generator=generator, device=x.device)
        keep = u < 1.0 - rate
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask, True at valid positions
    (reference utils.py:6-10)."""
    positions = torch.arange(max_len, device=lengths.device)[None, :]
    return positions < lengths[:, None]
