"""The port's ops (tacotron2_tpu_torch/ops) against the JAX package's
(tacotron2_tpu/ops) at fp32, atol 1e-5: the same numpy inputs, JAX layouts
on one side and torch layouts (transposed) on the other."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.ops import layers as jl
from tacotron2_tpu.ops import lstm as jlstm

from tacotron2_tpu_torch.kernels.lstm_layout import (from_blocks,
                                                     from_mma_tiles,
                                                     to_blocks, to_mma_tiles)
from tacotron2_tpu_torch.ops import initializers as ti
from tacotron2_tpu_torch.ops import layers as tl
from tacotron2_tpu_torch.ops import lstm as tlstm

ATOL = 1e-5
RNG = np.random.RandomState(0)


def rand(*shape, scale=0.5):
    return (RNG.randn(*shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL)


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    x, k, b = rand(3, 5, 12), rand(12, 7), rand(7)
    p = {"kernel": k, **({"bias": b} if bias else {})}
    close(tl.dense(t(x), t(k.T), t(b) if bias else None), jl.dense(p, x))


@pytest.mark.parametrize("k", [5, 31])
def test_conv1d_same(k):
    x, w, b = rand(2, 40, 6), rand(k, 6, 9), rand(9)
    want = jl.conv1d({"kernel": w, "bias": b}, x)
    close(tl.conv1d(t(x), t(w.transpose(2, 1, 0)), t(b)), want)


def test_batchnorm_eval():
    x = rand(2, 9, 6)
    p = {"scale": rand(6) + 1, "offset": rand(6)}
    s = {"mean": rand(6), "var": np.abs(rand(6)) + 0.5}
    want, _ = jl.batchnorm(p, s, x, training=False)
    got = tl.batchnorm(t(x), t(s["mean"]), t(s["var"]), t(p["scale"]),
                       t(p["offset"]))
    close(got, want)


def test_length_mask():
    lengths = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(
        tl.length_mask(t(lengths), 7).numpy(),
        np.asarray(jl.length_mask(jnp.asarray(lengths), 7)))


def test_dropout_with_fed_keep_mask():
    """The port never reproduces JAX's RNG: the JAX keep mask is drawn here
    exactly as jl.dropout draws it and handed to the port."""
    x = rand(4, 16)
    key = jax.random.PRNGKey(3)
    keep = np.asarray(jax.random.bernoulli(key, 0.5, x.shape))
    close(tl.dropout(t(x), 0.5, keep=t(keep)), jl.dropout(key, x, 0.5))
    assert torch.equal(tl.dropout(t(x), 0.5, deterministic=True), t(x))


def jax_lstm(in_dim, H):
    return {"wi": rand(in_dim, 4 * H), "wh": rand(H, 4 * H),
            "bi": rand(4 * H), "bh": rand(4 * H)}


def torch_lstm(p):
    return tlstm.LSTMWeights(t(p["wi"].T), t(p["wh"].T), t(p["bi"]),
                             t(p["bh"]))


def test_lstm_cell():
    p = jax_lstm(10, 6)
    x, h, c = rand(3, 10), rand(3, 6), rand(3, 6)
    want = jlstm.lstm_cell(p, x, (h, c))
    got = tlstm.lstm_cell(torch_lstm(p), t(x), (t(h), t(c)))
    for g, w in zip(got, want):
        close(g, w)


def test_lstm_scan():
    p = jax_lstm(10, 6)
    xs = rand(3, 9, 10)
    want, (wh, wc) = jlstm.lstm_scan(p, xs)
    got, (gh, gc) = tlstm.lstm_scan(torch_lstm(p), t(xs))
    close(got, want)
    close(gh, wh)
    close(gc, wc)


def test_reverse_by_length():
    xs = rand(3, 8, 2)
    lengths = np.array([8, 5, 1], np.int32)
    close(tlstm._reverse_by_length(t(xs), t(lengths)),
          jlstm._reverse_by_length(xs, jnp.asarray(lengths)))


@pytest.mark.parametrize("lengths", [[12, 12, 12, 12], [12, 9, 4, 1]])
def test_bilstm_ragged(lengths):
    """Packed-sequence semantics: the reverse direction starts at each row's
    own last frame, and every output at t >= length is exactly 0."""
    fwd, bwd = jax_lstm(16, 8), jax_lstm(16, 8)
    xs = rand(4, 12, 16)
    lens = np.array(lengths, np.int32)
    want = jlstm.bilstm(fwd, bwd, xs, jnp.asarray(lens))
    got = tlstm.bilstm(torch_lstm(fwd), torch_lstm(bwd), t(xs), t(lens))
    close(got, want)
    for b, n in enumerate(lens):
        assert torch.all(got[b, n:] == 0.0)


@pytest.mark.parametrize("gain", ["linear", "tanh", "relu"])
def test_xavier_bounds(gain):
    """Same distribution family as the JAX initializers (the draws differ):
    U(-a, a) with a = gain * sqrt(6 / (fan_in + fan_out))."""
    g = torch.Generator().manual_seed(0)
    w = ti.dense_init(300, 200, gain, g)
    bound = ti.GAINS[gain] * math.sqrt(6.0 / 500)
    assert w.shape == (200, 300)
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.99 * bound
    assert abs(float(w.mean())) < 0.01 * bound


def test_lstm_block_layout_round_trip():
    """The kernels' block-major weight layout: block j, column g*U + u is
    gate g of unit j*U + u, and from_blocks inverts to_blocks."""
    K, H, U = 5, 16, 4
    w = torch.arange(K * 4 * H, dtype=torch.float32).reshape(K, 4 * H)
    wb = to_blocks(w, U)
    assert wb.shape == (H // U, K, 4 * U)
    for j, g, u in [(0, 0, 0), (1, 2, 3), (3, 3, 1)]:
        assert torch.equal(wb[j, :, g * U + u], w[:, g * H + j * U + u])
    assert torch.equal(from_blocks(wb), w)


def test_lstm_mma_layout_round_trip():
    """The persistent decoder chunk's fragment-order layout: group j's k16
    step s, lane l, value v holds the A-fragment element PTX gives that
    lane (a0..a3, lower k first) of the 16 gate columns of units 4j..4j+3,
    gate-major; from_mma_tiles inverts to_mma_tiles."""
    K, H = 48, 16
    w = torch.arange(K * 4 * H, dtype=torch.float32).reshape(K, 4 * H)
    wm = to_mma_tiles(w)
    assert wm.shape == (H // 4, K // 16, 32, 8)
    for j, s, lane, v in [(0, 0, 0, 0), (1, 2, 13, 5), (3, 1, 31, 7),
                          (2, 0, 6, 2)]:
        g, t = lane // 4, lane % 4
        row = g + 8 * ((v // 2) % 2)
        k = 16 * s + 2 * t + v % 2 + 8 * (v // 4)
        q, u = row // 4, row % 4
        assert wm[j, s, lane, v] == w[k, q * H + 4 * j + u]
    assert torch.equal(from_mma_tiles(wm), w)


@pytest.mark.parametrize("B,K,H", [(1, 48, 16), (8, 96, 32), (21, 64, 8)])
def test_persistent_lstm_product_emulated(B, K, H):
    """The persistent chunk's LSTM product in swap-AB form, emulated lane by
    lane as mma.sync.m16n8k16 defines its fragments: A from the
    fragment-order weights, B = X^T from the rows (8 a tile, zero rows past
    B), the C fragments gathered into gate-major rows q * 4 + u; the cell
    on them equals the cell on X @ W (fp32, sums in another order)."""
    g0 = torch.Generator().manual_seed(B + K)
    w = torch.randn(K, 4 * H, generator=g0)
    x = torch.randn(B, K, generator=g0)
    bias = torch.randn(4 * H, generator=g0)
    c = torch.randn(B, H, generator=g0)
    wm = to_mma_tiles(w)
    nb8 = -(-B // 8)
    xp = torch.zeros(nb8 * 8, K)
    xp[:B] = x
    gates = torch.zeros(B, 4 * H)
    for j in range(H // 4):
        cfrag = torch.zeros(16, nb8 * 8)
        for s in range(K // 16):
            a = torch.zeros(16, 16)
            bt = torch.zeros(16, nb8 * 8)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                f = wm[j, s, lane]
                for i in range(2):
                    a[g, 2 * t + i] = f[i]
                    a[g + 8, 2 * t + i] = f[2 + i]
                    a[g, 2 * t + 8 + i] = f[4 + i]
                    a[g + 8, 2 * t + 8 + i] = f[6 + i]
                for nb in range(nb8):
                    row = xp[nb * 8 + g, 16 * s:16 * s + 16]
                    for i in range(2):
                        bt[2 * t + i, nb * 8 + g] = row[2 * t + i]
                        bt[2 * t + 8 + i, nb * 8 + g] = row[2 * t + 8 + i]
            cfrag += a @ bt
        for q in range(4):
            for u in range(4):
                gates[:, q * H + 4 * j + u] = cfrag[q * 4 + u, :B]
    from tacotron2_tpu_torch.kernels.decoder_batch import _cell
    h, cn = _cell(gates + bias, c)
    h_want, c_want = _cell(x @ w + bias, c)
    torch.testing.assert_close(h, h_want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(cn, c_want, atol=1e-5, rtol=1e-5)
