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


# ------------------------------------------- the cluster forward, emulated

EC_CL, EC_PAD = 16, 8   # csrc/encoder_lstm.cu
LANE = np.arange(32)
G4, T4 = LANE // 4, LANE % 4


def _bf(x):
    """x rounded to bf16, back in fp32 (round to nearest even)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _ldmatrix_x4(sm, rows, cols):
    """ldmatrix.x4 from a 2-D shared array: lane l gives the address
    (rows[l], cols[l]) of row l % 8 of matrix l // 8; lane l's register i
    holds elements 2 (l % 4) and 2 (l % 4) + 1 of row l // 4 of matrix i.
    Returns (32 lanes, 4 registers, 2 values)."""
    src = 8 * np.arange(4)[None, :] + G4[:, None]       # (lane, register)
    r, c = rows[src], cols[src] + 2 * T4[:, None]
    return np.stack([sm[r, c], sm[r, c + 1]], axis=-1)


def _mma(acc, fa, fb):
    """acc (32, 4) += A @ B as mma.sync.m16n8k16 defines its fragments:
    A from fa (32, 4, 2), B from fb (32, 2, 2), C (g, 2t..2t+1) in c0, c1
    and (g + 8, 2t..2t+1) in c2, c3."""
    a = np.zeros((16, 16), np.float32)
    b = np.zeros((16, 8), np.float32)
    for h in range(2):
        a[G4, 2 * T4 + h] = fa[:, 0, h]
        a[G4 + 8, 2 * T4 + h] = fa[:, 1, h]
        a[G4, 2 * T4 + 8 + h] = fa[:, 2, h]
        a[G4 + 8, 2 * T4 + 8 + h] = fa[:, 3, h]
        b[2 * T4 + h, G4] = fb[:, 0, h]
        b[2 * T4 + 8 + h, G4] = fb[:, 1, h]
    c = a @ b
    acc += np.stack([c[G4, 2 * T4], c[G4, 2 * T4 + 1], c[G4 + 8, 2 * T4],
                     c[G4 + 8, 2 * T4 + 1]], axis=1)


def _ec_product(acc, a, a_row, w, w_row, k0, nk):
    """ec_product: acc (4 n8 tiles, 32, 4) += A @ W^T, A the warp's 16 rows
    of a from a_row, W^T its 32 weight rows of w from w_row, k16 steps from
    column k0 of w, both by the kernel's ldmatrix addresses."""
    r8, mi = LANE & 7, LANE >> 3
    for s in range(nk):
        fa = _ldmatrix_x4(a, a_row + r8 + (mi & 1) * 8, (mi >> 1) * 8 + s * 16)
        wc = k0 + (mi & 1) * 8 + s * 16
        f0 = _ldmatrix_x4(w, w_row + r8 + (mi >> 1) * 8, wc)
        f1 = _ldmatrix_x4(w, w_row + 16 + r8 + (mi >> 1) * 8, wc)
        _mma(acc[0], fa, f0[:, 0:2])
        _mma(acc[1], fa, f0[:, 2:4])
        _mma(acc[2], fa, f1[:, 0:2])
        _mma(acc[3], fa, f1[:, 2:4])


def _emulate_cluster_forward(wf, bf, wb, bb, xs, xsr):
    """encoder_cluster_kernel, block by block and lane by lane: clusters of
    16 blocks, cluster 2 rg + d scanning direction d for row group rg; the
    block's rows of [wi ; wh]^T staged from the block-major weights; the x
    part (the x warp's, from the staged x rows) then the h part (the h
    warp's, from the h buffer) into one fp32 accumulator per gate; the cell
    on the gate-interleaved accumulators; h rounded to bf16 and pushed into
    every block's h buffer of the next parity, 16 bytes a row as the
    shuffles gather them. Returns the six stacks as the kernel stores
    them."""
    B, T, N = xs.shape
    H = wf.shape[0] * 4
    K = N + H
    UB, MT = H // EC_CL, 1 if B <= 16 else 2 if B <= 96 else 3
    NUG, R = UB // 8, 16 * MT
    LW, LX, LH = K + EC_PAD, N + EC_PAD, H + EC_PAD
    NG = -(-B // R)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    out = [np.full((T, B, 4 * H), np.nan, np.float32),
           np.full((T, B, 4 * H), np.nan, np.float32),
           np.full((T, B, H), np.nan, np.float32),
           np.full((T, B, H), np.nan, np.float32),
           np.full((T, B, H), np.nan, np.float32),
           np.full((T, B, H), np.nan, np.float32)]
    for cl in range(2 * NG):
        d, row0 = cl & 1, (cl >> 1) * R
        x = (xsr if d else xs).float().numpy()
        wg = (wb if d else wf).float().numpy()       # (H / 4, K, 16)
        bias = (bb if d else bf).numpy()
        gout, hout, cout = out[d], out[2 + d], out[4 + d]
        ws = np.zeros((EC_CL, 32 * NUG, LW), np.float32)
        for rank in range(EC_CL):
            u0 = rank * UB
            for i in range(UB // 4 * K * 2):
                half, k, bl = i & 1, (i >> 1) % K, (i >> 1) // K
                piece = wg[u0 // 4 + bl, k, half * 8:half * 8 + 8]
                for q in range(8):
                    col = half * 8 + q
                    u = bl * 4 + (col & 3)
                    ws[rank, (u >> 3) * 32 + (col >> 2) * 8 + (u & 7),
                       k] = piece[q]
        hs = np.zeros((EC_CL, 2, R, LH), np.float32)
        cst = np.zeros((EC_CL, MT * NUG, 32, 4), np.float32)
        for t in range(T):
            xsm = np.zeros((R, LX), np.float32)    # rows past B read zeros
            for r in range(R):
                if row0 + r < B:
                    xsm[r, :N] = x[row0 + r, t]
            pushes = []
            for rank in range(EC_CL):
                u0 = rank * UB
                for warp in range(MT * NUG):
                    mt, ug = warp // NUG, warp % NUG
                    unit = u0 + ug * 8 + 2 * T4
                    acc = np.zeros((4, 32, 4), np.float32)
                    _ec_product(acc, xsm, mt * 16, ws[rank], ug * 32, 0,
                                N // 16)
                    if t > 0:
                        _ec_product(acc, hs[rank, (t - 1) & 1], mt * 16,
                                    ws[rank], ug * 32, N, H // 16)
                    hp = np.zeros((2, 32, 2), np.float32)
                    for hh in range(2):
                        row = row0 + mt * 16 + G4 + 8 * hh
                        for q in range(2):
                            e = 2 * hh + q
                            gv = [acc[j, :, e] + bias[j * H + unit + q]
                                  for j in range(4)]
                            cn = (sig(gv[1]) * cst[rank, warp, :, e]
                                  + sig(gv[0]) * np.tanh(gv[2]))
                            cst[rank, warp, :, e] = cn
                            hp[hh, :, q] = _bf(sig(gv[3]) * np.tanh(cn))
                            ok = row < B
                            for j in range(4):
                                gout[t, row[ok], j * H + unit[ok] + q] = \
                                    _bf(gv[j][ok])
                            hout[t, row[ok], unit[ok] + q] = hp[hh, ok, q]
                            cout[t, row[ok], unit[ok] + q] = cn[ok]
                        # lane l's 16 bytes: the pairs of lanes (l & ~3) | i
                        v = hp[hh][(LANE & ~3)[:, None] + np.arange(4)]
                        v = v.reshape(32, 8)
                        rl = mt * 16 + G4 + 8 * hh
                        for lane in range(32):
                            for p in range(T4[lane], EC_CL, 4):
                                pushes.append((p, t & 1, rl[lane],
                                               u0 + ug * 8, v[lane]))
            for p, par, r, c0, v in pushes:   # behind the cluster barrier
                hs[p, par, r, c0:c0 + 8] = v
    return out


@pytest.mark.parametrize("B,T,N,Hd", [(3, 3, 32, 128), (40, 2, 32, 128),
                                      (20, 2, 16, 256), (100, 2, 16, 128)])
def test_cluster_forward_index_map(B, T, N, Hd):
    """Row 3's bf16 cluster kernel emulated (cluster row groups of 16, 32
    and 48 rows, the staged weight rows, the ldmatrix addresses and mma
    fragments of the x and h parts, the gate-interleaved cell, the
    exchange of h between the cluster's blocks) against the plain version:
    every element of the six stacks written, within the bf16 tolerance
    (sums in another order)."""
    rng = np.random.RandomState(B + Hd)
    bf16 = torch.bfloat16
    mk = lambda *s: torch.from_numpy((rng.rand(*s) - 0.5).astype(np.float32))
    from tacotron2_tpu_torch.kernels.lstm_layout import to_blocks
    wf, wb = (to_blocks(mk(N + Hd, 4 * Hd).mul(0.2).to(bf16), 4)
              for _ in range(2))
    bf, bb = (mk(4 * Hd).mul(0.2) for _ in range(2))
    xs, xsr = (mk(B, T, N).to(bf16) for _ in range(2))
    got = _emulate_cluster_forward(wf, bf, wb, bb, xs, xsr)
    want = el.bilstm_forward_plain(wf, bf, wb, bb, xs, xsr)
    for name, g, w in zip(("gf", "gb", "hf", "hb", "cf", "cb"), got, want):
        assert not np.isnan(g).any(), name
        close(g, w.float().numpy())
        if name in ("cf", "cb"):
            np.testing.assert_allclose(g, w.numpy(), atol=2e-3)


def test_probe_variants_find_their_markers():
    """The card's probes switch parts of the kernels off by editing copies
    of the sources at markers; every marker must still be in the source
    (each variant differs from the source as built), or the probe raises
    on the card."""
    from tacotron2_tpu_torch.kernels import chunk_probe, encoder_probe
    enc = encoder_probe._sources()
    assert len(set(enc.values())) == len(enc)
    for source in ("decoder_batch", "decoder_step"):
        chunk = chunk_probe._variants(source)
        assert chunk["traced"]["persistent_chunk.cuh"] != \
            chunk["idle"]["persistent_chunk.cuh"]
        assert "pc_trace_read" in chunk["traced"][f"{source}.cu"]


def _emulate_cluster_backward(wt, g, c, dh):
    """encoder_bwd_cluster_kernel for one direction, block by block and
    lane by lane: clusters of 16 blocks over row groups of 16, 32 or 48;
    block r owns units 16 r .. 16 r + 15 and their four gates; each thread
    its (row, unit) pairs (pair block warp + 8 k); the A fragments of wh^T
    read from the column tiles; the B fragments at ldmatrix's addresses in
    dgs; each warp's unit tiles w and w + 8 pushed into those blocks' recv
    of the next parity, 8 bytes (two rows) a store; the partials summed in
    rank order. Returns (dg (T, B, 4H) as stored, the times each element was
    stored)."""
    from tacotron2_tpu_torch.kernels.lstm_layout import to_col_tiles
    T, B, G = g.shape
    H = G // 4
    N = wt.shape[1] - H
    assert H == 16 * EC_CL
    MT = 1 if B <= 16 else 2 if B <= 96 else 3
    R, LR = 16 * MT, 16 * MT + 8
    wct = to_col_tiles(wt).float().numpy()
    g, c, dh = g.float().numpy(), c.numpy(), dh.numpy()
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    bf = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16).float().numpy()
    lanes = np.arange(32)
    gq, t4 = lanes >> 2, lanes & 3
    out = np.zeros((T, B, G), np.float32)
    writes = np.zeros((T, B, G), np.int32)
    for row0 in range(0, B, R):
        # A[rank][warp][m][gate s]: (16 units, 16 k) from each lane's
        # registers r (two bf16 each)
        A = np.zeros((EC_CL, 8, 2, 4, 16, 16), np.float32)
        for rank in range(EC_CL):
            u0 = 16 * rank
            for w in range(8):
                for m in range(2):
                    for s in range(4):
                        for r in range(4):
                            for e in range(2):
                                unit = 16 * (w + 8 * m) + gq + 8 * (r & 1)
                                col = N + unit
                                gate = s * H + u0 + 2 * t4 + 8 * (r >> 1) + e
                                A[rank, w, m, s, gq + 8 * (r & 1),
                                  2 * t4 + 8 * (r >> 1) + e] = \
                                    wct[col >> 5, gate, col & 31]
        recv = np.zeros((EC_CL, 2, EC_CL, 16, LR), np.float32)
        dc = np.zeros((EC_CL, 8, MT, 32), np.float32)
        for t in reversed(range(T)):
            par, npar = t & 1, (t - 1) & 1
            dgs = np.zeros((EC_CL, R, 64 + 8), np.float32)
            for rank in range(EC_CL):
                u0 = 16 * rank
                for w in range(8):
                    for k in range(MT):
                        b = w + 8 * k
                        r = 8 * (b >> 2) + gq
                        ul = 4 * (b & 3) + t4
                        rows = row0 + r
                        ok = rows < B
                        carry = np.zeros(32, np.float32)
                        if t < T - 1:
                            for p in range(EC_CL):
                                carry += recv[rank, par, p, ul, r]
                        rr = np.where(ok, rows, 0)
                        dhv = np.where(ok, dh[t, rr, u0 + ul], 0)
                        dhv = (carry + dhv).astype(np.float32)
                        gv = [np.where(ok, g[t, rr, q * H + u0 + ul], 0)
                              for q in range(4)]
                        cn = np.where(ok, c[t, rr, u0 + ul], 0)
                        cp = np.where(ok, c[t - 1, rr, u0 + ul], 0) if t \
                            else np.zeros(32, np.float32)
                        i, f, o = sig(gv[0]), sig(gv[1]), sig(gv[3])
                        gg, tc = np.tanh(gv[2]), np.tanh(cn)
                        dcv = dc[rank, w, k] + dhv * o * (1 - tc * tc)
                        dgv = [dcv * gg * i * (1 - i), dcv * cp * f * (1 - f),
                               dcv * i * (1 - gg * gg), dhv * tc * o * (1 - o)]
                        dc[rank, w, k] = dcv * f
                        for q in range(4):
                            dgs[rank, r, q * 16 + ul] = bf(dgv[q])
                # the 16-byte stores of dg[t]
                for i in range(R * 8):
                    r, p = i >> 3, i & 7
                    if row0 + r < B:
                        sl = slice((p >> 1) * H + u0 + (p & 1) * 8,
                                   (p >> 1) * H + u0 + (p & 1) * 8 + 8)
                        out[t, row0 + r, sl] = dgs[rank, r, p * 8:p * 8 + 8]
                        writes[t, row0 + r, sl] += 1
            if t == 0:
                continue
            r8, mi = lanes & 7, lanes >> 3
            for rank in range(EC_CL):
                acc = np.zeros((8, 2, 2 * MT, 16, 8), np.float32)
                for s in range(4):
                    for jp in range(MT):
                        # ldmatrix x4: lane L gives the address of row r8 of
                        # matrix mi; lane (g, q) gets (row g, cols 2q, 2q+1)
                        # of each matrix
                        mats = [dgs[rank, 16 * jp + np.arange(8) + (i >> 1) * 8,
                                    16 * s + (i & 1) * 8:16 * s + (i & 1) * 8
                                    + 8] for i in range(4)]
                        bmat = np.zeros((2, 16, 8), np.float32)
                        for nt in range(2):
                            for e in range(2):
                                bmat[nt, 2 * t4 + e, gq] = \
                                    mats[2 * nt][gq, 2 * t4 + e]
                                bmat[nt, 8 + 2 * t4 + e, gq] = \
                                    mats[2 * nt + 1][gq, 2 * t4 + e]
                        for w in range(8):
                            for m in range(2):
                                for nt in range(2):
                                    acc[w, m, 2 * jp + nt] += \
                                        A[rank, w, m, s] @ bmat[nt]
                for w in range(8):
                    for m in range(2):
                        peer = w + 8 * m
                        for j in range(2 * MT):
                            for hh in range(2):
                                for e in range(2):
                                    recv[peer, npar, rank, gq + 8 * hh,
                                         8 * j + 2 * t4 + e] = \
                                        acc[w, m, j, gq + 8 * hh, 2 * t4 + e]
    return out, writes


@pytest.mark.parametrize("B,T", [(3, 3), (20, 2), (100, 2)])
def test_cluster_backward_index_map(B, T):
    """Row 4's bf16 cluster kernel emulated (row groups of 16, 32 and 48,
    the pair ownership, the A fragments from the column tiles, the B
    fragments at ldmatrix's addresses, the exchange of the carry's partials
    by unit tile and step parity, the rank-order sums, the 16-byte stores
    of dg) against the plain version: every element of dg stored exactly
    once, within the bf16 tolerance (sums in another order); dx, the
    product after the chain, from the emulated dg against the plain dx."""
    rng = np.random.RandomState(B + T)
    bf16 = torch.bfloat16
    Hd, N = 16 * EC_CL, 32
    mk = lambda *s: torch.from_numpy((rng.rand(*s) - 0.5).astype(np.float32))
    wt = mk(4 * Hd, N + Hd).mul(0.2).to(bf16)
    g = mk(T, B, 4 * Hd).mul(2).to(bf16)
    c = mk(T, B, Hd)
    dh = mk(T, B, Hd)
    want = el.bilstm_backward_plain(wt, wt, g, g, c, c, dh, dh)
    dg, writes = _emulate_cluster_backward(wt, g, c, dh)
    np.testing.assert_array_equal(writes, 1)
    close(dg, want[0].float().numpy())
    dx = torch.from_numpy(dg).to(bf16).float() @ wt.float()[:, :N]
    np.testing.assert_allclose(dx.numpy(), want[2].numpy(), atol=1e-2,
                               rtol=1e-2)
