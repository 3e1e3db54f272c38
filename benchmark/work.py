"""The yardstick's arithmetic: the chip's peaks, a kernel's bound, the
operations and bytes of the port's kernels (rows 1, 2 and 5 of its kernel
table), and the model FLOPs of Tacotron 2, all from shapes.

Frozen copies, with where each came from:
- ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound``: ``chip_smoke.py:194-195``
  and ``chip_smoke.py:289-297``.
- ``train_scan_work`` (rows 1 and 2): ``chip_smoke.py:1523-1552``
  (``_scan_work``), written over the configuration's widths instead of the
  packed weights.
- ``decoder_chunk_work`` (row 5): ``chip_smoke.py:562-589``
  (``_decoder_work``), written over the widths likewise.
Each counts every input byte read once and every output byte written
once, and 2 FLOPs a multiply-add.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

# Published H100 SXM peaks (NVIDIA data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12,
              "tf32x3": 495e12 / 3}

Work = Tuple[float, float]  # (bytes, FLOPs)


def bound(nbytes: float, flops: Union[float, Dict[str, float]],
          dtype: str = "") -> Tuple[float, str]:
    """(bound in seconds, "bytes" or "operations"): the larger of the
    bytes at the HBM rate and the FLOPs at the peak of their type
    (``flops`` a count at ``dtype``'s rate, or {type: count})."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if not isinstance(flops, dict):
        flops = {dtype: flops}
    t_ops = sum(f / PEAK_FLOPS[k] for k, f in flops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _dims(c: dict):
    a, d = c["attention_rnn_dim"], c["decoder_rnn_dim"]
    e, p = c["encoder_embedding_dim"], c["prenet_dim"]
    n = c["n_mel_channels"] * c["n_frames_per_step"]
    return (a, d, e, p, n, c["attention_dim"],
            c["attention_location_kernel_size"],
            c["attention_location_n_filters"])


def train_scan_work(c: dict, B: int, T_in: int, steps: int,
                    keep: bool, w: int = 2) -> Tuple[Work, Work]:
    """((bytes, FLOPs) of row 1's forward scan, (bytes, FLOPs) of row 2's
    backward chain) over ``steps`` steps at batch ``B`` and ``T_in``
    encoder frames, operands of ``w`` bytes; ``keep``: dropout masks read.
    The location term counts as the model states it, conv then dense."""
    A, D, E, P, _, datt, ks, nf = _dims(c)
    K1, K2 = P + E + A, A + E + D
    loc = T_in * (nf * 2 * ks + nf * datt)
    sb = steps * B
    per_batch = B * T_in * (E + datt) * w
    keep_b = sb * (A + D) if keep else 0
    res_b = sb * ((5 * A + 5 * D) * w + (A + D + E + T_in) * 4)
    # w1, b1, w2, b2, wq, k2, v as packed (operands; biases fp32)
    weights = ((4 * A * K1 + 4 * D * K2 + A * datt + ks * 2 * datt + datt)
               * w + (4 * A + 4 * D) * 4)
    fwd_b = weights + sb * P * w + per_batch + B * T_in * 4 + keep_b + res_b
    fwd_macs = (K1 * 4 * A + K2 * 4 * D + A * datt + loc + T_in * datt
                + T_in * E)
    bwd_b = ((4 * A * K1 + 4 * D * K2 + 2 * A * datt) * w
             + ks * 2 * datt * w + datt * 4 + per_batch
             + res_b + sb * (D + E + T_in) * 4 + keep_b
             + sb * ((4 * A + 4 * D + E) * w + (P + datt) * 4)
             + B * T_in * datt * 4 + (ks * 2 * datt + datt) * 4)
    bwd_macs = (4 * D * K2 + 4 * A * K1 + 2 * A * datt + T_in * E
                + T_in * datt + 3 * loc)
    return (fwd_b, 2.0 * sb * fwd_macs), (bwd_b, 2.0 * sb * bwd_macs)


def decoder_chunk_work(c: dict, B: int, T_in: int, cs: int, keep: bool,
                       w: int = 2) -> Work:
    """(bytes, FLOPs) of one call of row 5's chunk: ``cs`` steps at batch
    ``B`` and ``T_in`` encoder frames, operands of ``w`` bytes (memory and
    processed memory too); ``keep``: the prenet's keep masks read."""
    a, d, e, p, n, datt, ks, nf = _dims(c)
    k1, k2 = p + e + a, a + e + d
    nbytes = ((n * p + p * p + 4 * a * k1 + 4 * d * k2 + a * datt
               + ks * 2 * datt + datt + (d + e) * (n + 1)) * w
              + (4 * a + 4 * d + n + 1) * 4)
    nbytes += B * T_in * (e + datt) * w + B * T_in * 4
    nbytes += 2 * 4 * B * (2 * a + 2 * d + e + n + 2 * T_in + 2)
    nbytes += 4 * cs * B * (n + 1 + T_in)
    if keep:
        nbytes += 2 * 4 * cs * B * p
    loc = T_in * nf * 2 * ks + T_in * nf * datt
    macs = (n * p + p * p + k1 * 4 * a + a * datt + loc
            + T_in * datt + T_in * e + k2 * 4 * d + (d + e) * (n + 1))
    return nbytes, 2.0 * cs * B * macs


def decode_work(c: dict, B: int, T_in: int, steps: int, chunk: int = 64,
                keep: bool = False) -> Work:
    """Row 5 over a whole decode of ``steps`` steps, chunk by chunk as
    ``decode_autoregressive_batch`` calls it."""
    nb = nf = 0.0
    t = 0
    while t < steps:
        cs = min(chunk, steps - t)
        b, f = decoder_chunk_work(c, B, T_in, cs, keep)
        nb, nf, t = nb + b, nf + f, t + cs
    return nb, nf


# ---------------------------------------------------------- model FLOPs

def tacotron2_forward_flops(c: dict, T_in: int, T_out: int) -> float:
    """FLOPs of one utterance's forward: ``T_in`` symbols, ``T_out``
    frames (decoder steps at r = 1). The products only: encoder convs,
    BiLSTM, memory projection, per step prenet, both LSTMs, query,
    location conv and dense, energies, context, projection and gate;
    postnet convs."""
    a, d, e, p, n, datt, ks, nf = _dims(c)
    k = c["encoder_kernel_size"]
    h = e // 2
    enc = (c["encoder_n_convolutions"] * T_in * e * e * k
           + 2 * T_in * 4 * h * (e + h) + T_in * e * datt)
    step = (n * p + p * p + 4 * a * (p + e + a) + a * datt
            + T_in * nf * 2 * ks + T_in * nf * datt + T_in * datt
            + T_in * e + 4 * d * (a + e + d) + (d + e) * (n + 1))
    steps = T_out // c["n_frames_per_step"]
    pe, pk, pn = (c["postnet_embedding_dim"], c["postnet_kernel_size"],
                  c["postnet_n_convolutions"])
    chans = [c["n_mel_channels"]] + [pe] * (pn - 1) + [c["n_mel_channels"]]
    post = T_out * pk * sum(chans[i] * chans[i + 1] for i in range(pn))
    return 2.0 * (enc + steps * step + post)


def tacotron2_train_flops(c: dict, T_in: int, T_out: int) -> float:
    """Forward and backward: three times the forward."""
    return 3.0 * tacotron2_forward_flops(c, T_in, T_out)
