"""The port's encoder BiLSTM (tacotron2_tpu_torch/kernels/encoder_lstm)
against the JAX package's Pallas kernel (tacotron2_tpu/kernels/encoder_lstm,
interpret mode on the CPU) at bf16.

On the CPU the port's wrapper runs its plain version, which carries the
CUDA kernel's arithmetic; the kernel itself is held against that plain
version on the card by tests/test_torch_kernels_gpu.py. Tolerance: atol
3e-2, rtol 0.05, the JAX package's own for this kernel
(tests/test_encoder_lstm.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.kernels import encoder_lstm as jel
from tacotron2_tpu.ops import lstm as jlstm

from tacotron2_tpu_torch.kernels import encoder_lstm as el
from tacotron2_tpu_torch.ops import lstm as tlstm

B, T, E = 16, 12, 256
H = E // 2
JCFG = JaxConfig(
    n_symbols=40, symbols_embedding_dim=128, encoder_embedding_dim=E,
    encoder_n_convolutions=1, attention_rnn_dim=128, decoder_rnn_dim=128,
    prenet_dim=128, attention_dim=128, attention_location_n_filters=4,
    attention_location_kernel_size=7, n_mel_channels=16,
    compute_dtype="bfloat16", pallas_encoder_lstm=True)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=0.05)


@pytest.fixture(scope="module")
def inputs():
    fwd = jlstm.lstm_params(jax.random.PRNGKey(1), E, H)
    bwd = jlstm.lstm_params(jax.random.PRNGKey(2), E, H)
    rng = np.random.RandomState(3)
    xs = (rng.randn(B, T, E) * 0.3).astype(np.float32)
    lengths = np.full((B,), T, np.int32)
    lengths[B // 2:] = T - 3
    xsr = np.asarray(jlstm._reverse_by_length(jnp.asarray(xs),
                                              jnp.asarray(lengths)))
    return fwd, bwd, xs, xsr, lengths


def torch_weights(p):
    t = lambda x: torch.tensor(np.asarray(x))
    return tlstm.LSTMWeights(t(p["wi"]).T, t(p["wh"]).T, t(p["bi"]),
                             t(p["bh"]))


def test_plain_stacks_match_jax_kernel(inputs):
    """All six stacks of the forward kernel: gates and h (bf16), c (fp32),
    for both directions."""
    fwd, bwd, xs, xsr, _ = inputs
    wf, bf = jel._pack_dir(fwd, jnp.bfloat16)
    wb, bb = jel._pack_dir(bwd, jnp.bfloat16)
    want = jel._fwd_call(wf, bf, wb, bb, jnp.asarray(xs).swapaxes(0, 1),
                         jnp.asarray(xsr).swapaxes(0, 1),
                         dims=jel._Dims(b=B, n=E, h=H), interpret=True)
    twf, tbf = el.pack_direction(torch_weights(fwd), torch.bfloat16)
    twb, tbb = el.pack_direction(torch_weights(bwd), torch.bfloat16)
    got = el.bilstm_forward(twf, tbf, twb, tbb,
                            torch.tensor(xs).to(torch.bfloat16),
                            torch.tensor(xsr).to(torch.bfloat16))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        close(g.float(), np.asarray(w, np.float32))


def test_bilstm_scans_match_jax(inputs):
    fwd, bwd, xs, xsr, _ = inputs
    want = jel.bilstm_scans(fwd, bwd, jnp.asarray(xs), jnp.asarray(xsr),
                            JCFG)
    wts = (torch_weights(fwd), torch_weights(bwd))
    packed = el.pack_bilstm(*wts, torch.bfloat16)
    got = el.bilstm_scans(packed, torch.tensor(xs), torch.tensor(xsr),
                          tuple(x for w in wts for x in w))
    for g, w in zip(got, want):
        close(g, w)


def test_bilstm_bf16_matches_jax_kernel_path(inputs):
    """``ops.lstm.bilstm`` at bf16 against the JAX bilstm on its kernel
    path, with exact zeros past each row's length."""
    fwd, bwd, xs, _, lengths = inputs
    want = jlstm.bilstm(fwd, bwd, jnp.asarray(xs), jnp.asarray(lengths),
                        compute_dtype=jnp.bfloat16, cfg=JCFG)
    got = tlstm.bilstm(torch_weights(fwd), torch_weights(bwd),
                       torch.tensor(xs), torch.tensor(lengths),
                       compute_dtype=torch.bfloat16)
    close(got, want)
    assert torch.all(got[B // 2:, T - 3:] == 0.0)


def test_plain_version_counts_calls(inputs):
    """CPU tensors take the plain version, and only it: the kernel's
    launch count does not move."""
    fwd, bwd, xs, xsr, _ = inputs
    plain0 = el.bilstm_forward_plain.calls
    launches0 = el.bilstm_forward.launches
    wts = (torch_weights(fwd), torch_weights(bwd))
    packed = el.pack_bilstm(*wts, torch.float32)
    el.bilstm_scans(packed, torch.tensor(xs[:2, :3]),
                    torch.tensor(xsr[:2, :3]),
                    tuple(x for w in wts for x in w))
    assert el.bilstm_forward_plain.calls == plain0 + 1
    assert el.bilstm_forward.launches == launches0


def test_backward_plain_matches_jax_kernel(inputs):
    """Row 4: the backward chain's four stacks (dgates bf16, dx fp32) of
    both directions against ``_bwd_call`` at bf16, from the same forward
    stacks and cotangents. Largest |err| as a share of each stack's largest
    |value| within 2e-2 (bf16 rounding flips of dgates carried back)."""
    fwd, bwd, xs, xsr, _ = inputs
    wf, bf = jel._pack_dir(fwd, jnp.bfloat16)
    wb, bb = jel._pack_dir(bwd, jnp.bfloat16)
    dims = jel._Dims(b=B, n=E, h=H)
    gf, gb, hf, hb, cf, cb = jel._fwd_call(
        wf, bf, wb, bb, jnp.asarray(xs).swapaxes(0, 1),
        jnp.asarray(xsr).swapaxes(0, 1), dims=dims, interpret=True)
    rng = np.random.RandomState(4)
    dhf, dhb = ((rng.randn(T, B, H) * 0.1).astype(np.float32)
                for _ in range(2))
    want = jel._bwd_call(wf.T, wb.T, gf, gb, cf, cb, jnp.asarray(dhf),
                         jnp.asarray(dhb), dims=dims, interpret=True)
    t = lambda x, dt=torch.float32: torch.tensor(np.asarray(x, np.float32)
                                                 ).to(dt)
    got = el.bilstm_backward(
        t(wf.T, torch.bfloat16), t(wb.T, torch.bfloat16),
        t(gf, torch.bfloat16), t(gb, torch.bfloat16), t(cf), t(cb), t(dhf),
        t(dhb))
    for name, g, w in zip(("dgf", "dgb", "dxf", "dxb"), got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= 2e-2, (name, err)


def test_bilstm_grads_match_jax_vjp(inputs):
    """``ops.lstm.bilstm`` under autograd (the Function around the
    backward chain, and the gather's scatter-add) against ``jax.vjp`` of
    the JAX ``bilstm`` at fp32 with ragged lengths: the input's and every
    weight's gradient within 1e-4 of its largest value, and exactly zero
    gradient at the positions past each row's length."""
    fwd, bwd, xs, _, lengths = inputs
    rng = np.random.RandomState(5)
    cot = (rng.randn(B, T, 2 * H) * 0.1).astype(np.float32)
    out, vjp = jax.vjp(lambda f, b, x: jlstm.bilstm(f, b, x,
                                                    jnp.asarray(lengths)),
                       fwd, bwd, jnp.asarray(xs))
    dfwd, dbwd, dxs = vjp(jnp.asarray(cot))
    wts = [torch_weights(p) for p in (fwd, bwd)]
    leaves = [x.clone().requires_grad_(True) for w in wts for x in w]
    x = torch.tensor(xs, requires_grad=True)
    got = tlstm.bilstm(tlstm.LSTMWeights(*leaves[:4]),
                       tlstm.LSTMWeights(*leaves[4:]), x,
                       torch.tensor(lengths))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    (got * torch.tensor(cot)).sum().backward()
    want = [np.asarray(d[k], np.float32).T if k[0] == "w"
            else np.asarray(d[k], np.float32)
            for d in (dfwd, dbwd) for k in ("wi", "wh", "bi", "bh")]
    for name, g, w in zip(["wi", "wh", "bi", "bh"] * 2 + ["xs"],
                          [p.grad for p in leaves] + [x.grad],
                          want + [np.asarray(dxs)]):
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)
    assert torch.all(x.grad[B // 2:, T - 3:] == 0.0)
