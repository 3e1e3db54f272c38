"""The port's single-utterance decoder chunk
(tacotron2_tpu_torch/kernels/decoder_step) against the JAX package's Pallas
kernel (tacotron2_tpu/kernels/decoder_step, interpret mode on the CPU).

On the CPU the port's wrapper runs its plain version, which carries the
CUDA kernel's arithmetic; the kernel itself is held against that plain
version on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
Inputs come from numpy seeds and go to both packages. At fp32, atol 1e-4
(three chunks of fp32 steps whose sums run in another order; the JAX
package holds its own kernel to its XLA path at 1e-5 per chunk). At bf16,
atol 1e-2 over three 8-step chunks on values up to ~0.5: both sides round
the same operands at the same places, and now and then a sum that differs
in its last fp32 bit rounds to the other bf16 neighbour.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.kernels import decoder_step as jds
from tacotron2_tpu.models import tacotron2 as jm

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.kernels import decoder_step as ds
from tacotron2_tpu_torch.models import tacotron2 as tm

# the widths of tests/test_fused_decoder.py
DIMS = dict(
    n_symbols=148, symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=2, attention_rnn_dim=40, decoder_rnn_dim=48,
    prenet_dim=16, attention_dim=24, attention_location_n_filters=8,
    attention_location_kernel_size=15, postnet_embedding_dim=32,
    postnet_n_convolutions=3, n_mel_channels=20, max_decoder_steps=24,
    text_buckets=(16,), gate_threshold=0.99, compute_dtype="float32")
ATOL = {"float32": 1e-4, "bfloat16": 1e-2}


def configs(**kw):
    kw = {**DIMS, **kw}
    return JaxConfig(**kw), Tacotron2Config(**kw)


def setup(jcfg, tcfg, seed=0, t_in=12, valid=None):
    params, stats = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tm.Tacotron2(tcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    rng = np.random.RandomState(seed)
    memory = (rng.randn(1, t_in, jcfg.encoder_embedding_dim) * 0.5
              ).astype(np.float32)
    w_mem = np.asarray(params["decoder"]["attention"]["memory"]["kernel"])
    processed = (memory @ w_mem).astype(np.float32)
    mask = np.arange(t_in)[None, :] < (valid or t_in)
    return params, stats, model, memory, processed, mask


def close(got, want, what, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               err_msg=what)


def check_carry(tc, jc, atol):
    np.testing.assert_array_equal(tc.finished.numpy(), np.asarray(jc.finished))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert tc.t == int(jc.t)
    for field in jc.state._fields:
        close(getattr(tc.state, field), getattr(jc.state, field),
              f"state.{field}", atol)
    close(tc.prev_mel, jc.prev_mel, "prev_mel", atol)


def run_both(params, model, memory, processed, mask, jcfg, tcfg, dtype,
             chunks, cs, rng=None):
    """Three resumed chunks through both packages; yields per chunk
    (port's carry and outputs, JAX package's carry and outputs)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jfp = jds.pack_decoder_params(params, jcfg, dtype=jdt)
    tfp = ds.pack_decoder_params(model, tdt)
    jmem, jproc, jmask = map(jnp.asarray, (memory, processed, mask))
    tmem, tproc, tmask = map(torch.from_numpy, (memory, processed, mask))
    jc = jm.init_stream_carry(jmem, jcfg)
    tc = tm.init_stream_carry(tmem, tcfg)
    for _ in range(chunks):
        keep = None
        if rng is not None:
            k1, k2 = jds._prenet_keep_masks(rng, jc.t, cs, tcfg.prenet_dim)
            keep = (torch.tensor(np.asarray(k1)[:, :1]),
                    torch.tensor(np.asarray(k2)[:, :1]))
        jc, jout = jds.decode_chunk_fused(
            jfp, jc, jmem, jproc, jmask, jcfg, chunk_steps=cs, dtype=jdt,
            interpret=True, rng=rng)
        tc, tout = ds.decode_chunk_fused(
            tfp, tc, tmem, tproc, tmask, tcfg, chunk_steps=cs,
            keep_masks=keep)
        yield tc, tout, jc, jout


def case(thr, ks, r, dropout, dtype="float32", valid=None):
    return pytest.param(thr, ks, r, dropout, dtype, valid,
                        id=f"{thr}-{ks}-{r}-{dropout}-{dtype}-{valid}")


@pytest.mark.parametrize("thr,ks,r,dropout,dtype,valid", [
    case(0.99, 15, 1, False),    # runs to the cap
    case(0.3, 15, 1, False),     # the gate latches early: masking, the
    #                              carry keeps stepping after the latch
    case(0.0, 15, 1, False),     # thr <= 0: latches at once
    case(1.0, 15, 1, False),     # thr >= 1: never
    case(0.99, 31, 1, False),    # default-size location kernel
    case(0.99, 15, 2, False),    # reduction factor r=2
    case(0.99, 15, 1, True),     # JAX-drawn prenet keep masks
    case(0.99, 15, 1, False, valid=9),  # masked encoder positions
    case(0.99, 15, 1, False, "bfloat16"),
    case(0.3, 15, 2, True, "bfloat16"),
])
def test_chunk_matches_jax_kernel(thr, ks, r, dropout, dtype, valid):
    jcfg, tcfg = configs(gate_threshold=thr, n_frames_per_step=r,
                         attention_location_kernel_size=ks)
    params, _, model, memory, processed, mask = setup(jcfg, tcfg,
                                                      valid=valid)
    rng = jax.random.PRNGKey(42) if dropout else None
    atol = ATOL[dtype]
    calls = ds.decoder_step_chunk_plain.calls
    for tc, tout, jc, jout in run_both(params, model, memory, processed,
                                       mask, jcfg, tcfg, dtype, 3, 8, rng):
        for g, w, name in zip(tout, jout, ("mel", "gate", "align")):
            assert g.shape == w.shape
            close(g, w, name, atol)
        # the carry after every chunk, after a latch too
        check_carry(tc, jc, atol)
    assert ds.decoder_step_chunk_plain.calls == calls + 3
    if thr <= 0.3:
        assert bool(tc.finished[0]) and int(tc.lengths[0]) < 24
        assert float(tout[0].abs().max()) == 0.0       # masked outputs
        assert float(tc.prev_mel.abs().max()) > 0.0    # the state moved on
    if thr >= 0.99:
        assert not bool(tc.finished[0]) and int(tc.lengths[0]) == 24


def test_resumed_chunks_equal_one_shot():
    jcfg, tcfg = configs(gate_threshold=0.4)
    _, _, model, memory, processed, mask = setup(jcfg, tcfg, seed=1)
    fp = ds.pack_decoder_params(model, torch.float32)
    mem, proc, msk = map(torch.from_numpy, (memory, processed, mask))
    c1 = tm.init_stream_carry(mem, tcfg)
    outs = []
    for _ in range(2):
        c1, out = ds.decode_chunk_fused(fp, c1, mem, proc, msk, tcfg,
                                        chunk_steps=8)
        outs.append(out)
    c2, one = ds.decode_chunk_fused(fp, tm.init_stream_carry(mem, tcfg), mem,
                                    proc, msk, tcfg, chunk_steps=16)
    for i, name in enumerate(("mel", "gate", "align")):
        close(torch.cat([o[i] for o in outs], dim=1), one[i], name, 1e-6)
    assert torch.equal(c1.finished, c2.finished)
    assert torch.equal(c1.lengths, c2.lengths)
    for f in c1.state._fields:
        close(getattr(c1.state, f), getattr(c2.state, f), f, 1e-6)


@pytest.mark.parametrize("thr,max_steps,cs", [
    (0.99, 20, 8),   # the last chunk would overshoot max_steps
    (0.3, 24, 8),    # early exit once the gate has latched
    (0.3, 5, 8),     # the cap inside the first chunk
])
def test_autoregressive_matches_jax_kernel(thr, max_steps, cs):
    jcfg, tcfg = configs(gate_threshold=thr, n_frames_per_step=2)
    params, _, model, memory, processed, mask = setup(jcfg, tcfg, seed=5)
    calls = ds.decoder_step_chunk_plain.calls
    got = ds.decode_autoregressive_fused(
        ds.pack_decoder_params(model, torch.float32),
        torch.from_numpy(memory), torch.from_numpy(processed),
        torch.from_numpy(mask), tcfg, max_steps=max_steps, chunk_steps=cs)
    want = jds.decode_autoregressive_fused(
        jds.pack_decoder_params(params, jcfg, dtype=jnp.float32),
        jnp.asarray(memory), jnp.asarray(processed), jnp.asarray(mask), jcfg,
        max_steps=max_steps, chunk_steps=cs, dtype=jnp.float32,
        interpret=True)
    for g, w, name in zip(got, want, ("mel", "gate", "align", "lengths")):
        assert g.shape == w.shape, name
        close(g, w, name, 1e-4)
    if thr == 0.3:  # chunk-granular early exit: fewer chunks than the cap's
        assert ds.decoder_step_chunk_plain.calls - calls <= -(-max_steps // cs)


@pytest.mark.parametrize("thr,dtype", [(0.99, "float32"), (0.3, "float32"),
                                       (0.99, "bfloat16")])
def test_infer_fused_matches_jax(thr, dtype):
    jcfg, tcfg = configs(gate_threshold=thr, max_decoder_steps=20,
                         compute_dtype=dtype)
    params, stats, model, *_ = setup(jcfg, tcfg, seed=2)
    rng = np.random.RandomState(2)
    text = rng.randint(1, 148, (1, 12)).astype(np.int32)
    lengths = np.array([12], np.int32)
    want = jm.infer_fused(params, stats, jnp.asarray(text),
                          jnp.asarray(lengths), jcfg, chunk_steps=8)
    got = tm.infer_fused(model, torch.from_numpy(text),
                         torch.from_numpy(lengths), tcfg, chunk_steps=8,
                         device="cpu")
    np.testing.assert_array_equal(got.mel_lengths.numpy(),
                                  np.asarray(want.mel_lengths))
    # bf16: the encoder, the postnet and 20 decoder steps all round
    atol = 1e-4 if dtype == "float32" else 3e-2
    for f in ("mel", "mel_postnet", "gate_energies", "alignments"):
        close(getattr(got, f), getattr(want, f), f, atol)
    if dtype == "float32":  # and the plain step-by-step decoder agrees
        ref = tm.infer(model, torch.from_numpy(text),
                       torch.from_numpy(lengths), tcfg, device="cpu")
        close(got.mel_postnet, ref.mel_postnet, "infer", 1e-4)


def test_infer_fused_draws_dropout_from_a_generator():
    jcfg, tcfg = configs(max_decoder_steps=8)
    _, _, model, *_ = setup(jcfg, tcfg, seed=3)
    text, lengths = torch.ones(1, 6, dtype=torch.long), torch.tensor([6])
    run = lambda g: tm.infer_fused(model, text, lengths, tcfg, device="cpu",
                                   generator=g).mel
    a = run(torch.Generator().manual_seed(1))
    b = run(torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, run(None))
    off = tcfg.replace(prenet_dropout_at_inference=False)
    c = tm.infer_fused(model, text, lengths, off, device="cpu",
                       generator=torch.Generator().manual_seed(1)).mel
    assert torch.equal(c, run(None))


def test_input_checks():
    jcfg, tcfg = configs()
    _, _, model, memory, processed, mask = setup(jcfg, tcfg)
    fp = ds.pack_decoder_params(model, torch.float32)
    assert fp.k2.dtype == torch.float32
    assert ds.pack_decoder_params(model, torch.bfloat16).k2.dtype == \
        torch.float32  # the location term stays fp32 at bf16 too
    two = torch.from_numpy(np.repeat(memory, 2, axis=0))
    with pytest.raises(ValueError, match="one row"):
        ds.decode_chunk_fused(
            fp, tm.init_stream_carry(two, tcfg), two,
            torch.from_numpy(np.repeat(processed, 2, axis=0)), None, tcfg,
            chunk_steps=2)
    mem = torch.from_numpy(memory)
    with pytest.raises(ValueError, match="both prenet keep masks"):
        ds.decoder_step_chunk(
            fp, None, mem, torch.from_numpy(processed), None, t0=0,
            chunk_steps=2, gate_logit=0.0, kp1=torch.ones(2, 1, 16))
    with pytest.raises(ValueError, match="one utterance"):
        tm.infer_fused(model, torch.ones(2, 4, dtype=torch.long),
                       torch.tensor([4, 4]), tcfg, device="cpu")


# ------------------------------- the persistent chunk at B=1, emulated

def test_bf16_pack_keeps_the_fragment_order_weights():
    """The persistent chunk reads both LSTMs in mma fragment order: at bf16
    the pack keeps them (here the input depths are whole k16 steps
    already), at fp32 it has none."""
    from tacotron2_tpu_torch.kernels.lstm_layout import (from_blocks,
                                                         from_mma_tiles)
    tcfg = Tacotron2Config(**{**DIMS, "attention_rnn_dim": 48})
    model = tm.Tacotron2(tcfg, torch.Generator().manual_seed(0))
    fp = ds.pack_decoder_params(model, torch.bfloat16)
    for blocks, frags in ((fp.w1, fp.w1f), (fp.w2, fp.w2f)):
        assert frags is not None and frags.dtype == torch.bfloat16
        assert torch.equal(from_mma_tiles(frags), from_blocks(blocks))
    fp32 = ds.pack_decoder_params(model, torch.float32)
    assert fp32.w1f is None and fp32.w2f is None


def test_bf16_pack_pads_lstm_depths_to_k16_steps():
    """At A=40 the LSTM input depths, 16 + 32 + 40 = 88 and 40 + 32 + 48 =
    120, are no whole k16 steps: the fragment-order copies hold each
    [wi ; wh] with zero rows after it up to 96 and 128 (pc_depth), which
    meet X's zero columns in the kernel."""
    from tacotron2_tpu_torch.kernels.lstm_layout import (from_blocks,
                                                         from_mma_tiles)
    tcfg = Tacotron2Config(**DIMS)
    model = tm.Tacotron2(tcfg, torch.Generator().manual_seed(0))
    fp = ds.pack_decoder_params(model, torch.bfloat16)
    for blocks, frags, K, Kp in ((fp.w1, fp.w1f, 88, 96),
                                 (fp.w2, fp.w2f, 120, 128)):
        w = from_blocks(blocks)
        got = from_mma_tiles(frags)
        assert w.shape[0] == K and got.shape == (Kp, w.shape[1])
        assert torch.equal(got[:K], w) and not got[K:].any()


PC_WARPS, PC_UMAX, PC_UG, PC_EP = 16, 2, 4, 4   # csrc/persistent_chunk.cuh


@pytest.mark.parametrize("K,H,G", [(96, 32, 4), (160, 64, 8)])
def test_persistent_lstm_partials_at_one_row(K, H, G):
    """pc_lstm at B=1 (one n8 tile, the row in column 0), emulated: block b
    owns unit groups b and b + G; the 16 warps split the k16 steps
    (k0 = warp nk / 16); each warp's C fragments (gates^T: 16 gate rows x 8
    columns) land in the partial buffer at ((warp * PC_UMAX + j) * 16 + g +
    8 (e >> 1)) * 8 + 2 t4 + (e & 1); the cell adds gate q of unit u from
    row q * 4 + u in warp order. Equals the cell on x @ W (fp32)."""
    from tacotron2_tpu_torch.kernels.decoder_batch import _cell
    from tacotron2_tpu_torch.kernels.lstm_layout import to_mma_tiles
    g0 = torch.Generator().manual_seed(K + H)
    w = torch.randn(K, 4 * H, generator=g0)
    x = torch.randn(1, K, generator=g0)
    bias = torch.randn(4 * H, generator=g0)
    c = torch.randn(1, H, generator=g0)
    wm = to_mma_tiles(w)                 # (H / 4, K / 16, 32, 8)
    nk = K // 16
    lane = np.arange(32)
    gq, tq = lane // 4, lane % 4
    gates = torch.full((1, 4 * H), float("nan"))
    for b in range(G):
        red = np.zeros(PC_WARPS * PC_UMAX * 16 * 8, np.float32)
        for warp in range(PC_WARPS):
            k0, k1 = warp * nk // PC_WARPS, (warp + 1) * nk // PC_WARPS
            for j in range(PC_UMAX):
                grp = b + j * G
                if grp >= H // PC_UG:
                    continue
                acc = np.zeros((32, 4), np.float32)
                for kk in range(k0, k1):
                    f = wm[grp, kk].numpy()           # (lane, 8 values)
                    a = np.zeros((16, 16), np.float32)
                    for h in range(2):
                        a[gq, 2 * tq + h] = f[:, h]
                        a[gq + 8, 2 * tq + h] = f[:, 2 + h]
                        a[gq, 2 * tq + 8 + h] = f[:, 4 + h]
                        a[gq + 8, 2 * tq + 8 + h] = f[:, 6 + h]
                    bt = np.zeros((16, 8), np.float32)   # X^T, row 0 only
                    bt[:, 0] = x[0, 16 * kk:16 * kk + 16].numpy()
                    cm = a @ bt
                    acc += np.stack([cm[gq, 2 * tq], cm[gq, 2 * tq + 1],
                                     cm[gq + 8, 2 * tq],
                                     cm[gq + 8, 2 * tq + 1]], axis=1)
                for e in range(4):
                    red[((warp * PC_UMAX + j) * 16 + gq + (e >> 1) * 8) * 8
                        + 2 * tq + (e & 1)] = acc[:, e]
        for j in range(PC_UMAX):
            for u in range(PC_UG):
                unit = (b + j * G) * PC_UG + u
                if unit >= H:
                    continue
                for q in range(4):
                    s = np.float32(0.0)
                    for wp in range(PC_WARPS):
                        s += red[((wp * PC_UMAX + j) * 16 + q * PC_UG + u)
                                 * 8]
                    gates[0, q * H + unit] = float(s)
    assert not torch.isnan(gates).any()
    h, cn = _cell(gates + bias, c)
    h_want, c_want = _cell(x @ w + bias, c)
    torch.testing.assert_close(h, h_want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(cn, c_want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,D,ks", [(37, 128, 31), (9, 64, 15)])
def test_single_utterance_energy_items(T, D, ks):
    """pc_energy_f32, the persistent chunk's energies at row 6's cast
    points, emulated item by item: PC_EP positions an item, thread i on
    position i / 128 and columns i % 128 + 128 j, the location term in
    fp32 from fp32 K2 and unrounded w, w_cum windows, tanh rounded to bf16
    before the v-product, each position's four warp sums added in warp
    order. Equals the plain version's conv form of the same step."""
    rng = np.random.RandomState(T + D)
    q = rng.randn(D).astype(np.float32)
    w, wc = rng.rand(T).astype(np.float32), rng.rand(T).astype(np.float32)
    k2 = (rng.randn(ks, 2, D) * 0.1).astype(np.float32)
    proc = rng.randn(T, D).astype(np.float32)
    v = torch.from_numpy(rng.randn(D).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()
    pad, ww = (ks - 1) // 2, PC_EP + ks - 1
    e = np.full(T, np.nan, np.float32)
    for t0 in range(0, T, PC_EP):
        pos = t0 - pad + np.arange(ww)
        inside = (pos >= 0) & (pos < T)
        win0 = np.where(inside, w[np.clip(pos, 0, T - 1)], 0.0)
        win1 = np.where(inside, wc[np.clip(pos, 0, T - 1)], 0.0)
        red = np.zeros(16, np.float32)
        for i in range(512):
            tl, t = i >> 7, t0 + (i >> 7)
            if t >= T:
                continue
            acc = np.float32(0.0)
            for d in range(i & 127, D, 128):
                m = np.float32(q[d])
                for k in range(ks):
                    m = np.float32(m + k2[k, 0, d] * np.float32(win0[tl + k]))
                    m = np.float32(m + k2[k, 1, d] * np.float32(win1[tl + k]))
                acc += bf(np.tanh(m + proc[t, d])) * v[d]
            red[i >> 5] += acc
        for p in range(min(PC_EP, T - t0)):
            r = red[4 * p:4 * p + 4]
            e[t0 + p] = ((r[0] + r[1]) + r[2]) + r[3]
    win = torch.from_numpy(np.stack([w, wc])[None])       # (1, 2, T)
    loc = torch.nn.functional.conv1d(
        win, torch.from_numpy(k2).permute(2, 1, 0), padding=pad)
    feat = torch.tanh(torch.from_numpy(q)[None, None] + loc.transpose(1, 2)
                      + torch.from_numpy(proc)[None])
    want = (feat.to(torch.bfloat16).float() @ torch.from_numpy(v))[0]
    np.testing.assert_allclose(e, want.numpy(), rtol=1e-4, atol=2e-3)
