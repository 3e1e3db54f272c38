"""The port's batched decoder chunk (tacotron2_tpu_torch/kernels/decoder_batch)
against the JAX package's Pallas kernel (tacotron2_tpu/kernels/decoder_batch,
interpret mode on the CPU).

On the CPU the port's wrapper runs its plain version, which carries the
CUDA kernel's arithmetic; the kernel itself is held against that plain
version on the card by tests/test_torch_kernels_gpu.py. Inputs come
from numpy seeds and go to both packages. At fp32, atol 1e-4 (the JAX
package's own tolerance for this kernel, tests/test_decoder_batch.py); at
bf16 (the serving default), atol 1e-2 over three 6-step chunks, where the
worst field differs by 1.2e-3 (mel) on values up to ~0.5.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.kernels import decoder_batch as jdb
from tacotron2_tpu.kernels.decoder_step import (_prenet_keep_masks,
                                                gate_logit_threshold)
from tacotron2_tpu.models import tacotron2 as jm

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.models import tacotron2 as tm

DIMS = dict(
    n_symbols=40, symbols_embedding_dim=128, encoder_embedding_dim=128,
    encoder_n_convolutions=1, attention_rnn_dim=128, decoder_rnn_dim=128,
    prenet_dim=128, attention_dim=128, attention_location_n_filters=4,
    attention_location_kernel_size=7, n_mel_channels=16,
    max_decoder_steps=24, postnet_embedding_dim=32,
    postnet_n_convolutions=2, compute_dtype="float32")
ATOL = 1e-4
ATOL_BF16 = (1e-2, 0.0)  # (atol, rtol): ~8x the worst bf16 reading, 1.2e-3


def configs(**kw):
    kw = {**DIMS, **kw}
    return JaxConfig(**kw), Tacotron2Config(**kw)


def setup(jcfg, tcfg, B, seed=0, t_in=20):
    params, stats = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tm.Tacotron2(tcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    rng = np.random.RandomState(seed)
    memory = (rng.randn(B, t_in, jcfg.encoder_embedding_dim) * 0.5
              ).astype(np.float32)
    w_mem = np.asarray(params["decoder"]["attention"]["memory"]["kernel"])
    processed = (memory @ w_mem).astype(np.float32)
    lengths = np.full((B,), t_in, np.int32)
    lengths[B // 2:] = max(2, t_in - 6)
    mask = np.arange(t_in)[None, :] < lengths[:, None]
    return params, model, memory, processed, mask, lengths


def close(got, want, what, tol=(ATOL, 0.0)):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol[0],
                               rtol=tol[1], err_msg=what)


def check_carry(tc, jc, tol=(ATOL, 0.0)):
    np.testing.assert_array_equal(tc.finished.numpy(), np.asarray(jc.finished))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert tc.t == int(jc.t)
    for field in jc.state._fields:
        close(getattr(tc.state, field), getattr(jc.state, field),
              f"state.{field}", tol)
    close(tc.prev_mel, jc.prev_mel, "prev_mel", tol)


def case(B, gate_threshold, r, dropout, dtype="float32"):
    cid = f"{B}-{gate_threshold}-{r}-{dropout}"
    return pytest.param(B, gate_threshold, r, dropout, dtype,
                        id=cid if dtype == "float32" else f"{cid}-{dtype}")


@pytest.mark.parametrize("B,gate_threshold,r,dropout,dtype", [
    case(4, 0.99, 1, False),   # runs to the cap, ragged lengths
    case(4, 0.3, 1, False),    # per-row gate latch
    case(3, 0.99, 2, False),   # reduction factor r=2, odd batch
    case(21, 0.3, 1, False),   # three of the TPU kernel's 8-row tiles, latch
    case(4, 0.99, 1, True),    # prenet keep masks drawn by the JAX package
    # the serving default: bf16 cast points (x1, x2, x3 and q rounded
    # before each product, memory and processed memory in bf16)
    case(4, 0.99, 1, False, "bfloat16"),
    case(3, 0.99, 2, True, "bfloat16"),
])
def test_chunk_matches_jax_kernel(B, gate_threshold, r, dropout, dtype):
    jcfg, tcfg = configs(gate_threshold=gate_threshold, n_frames_per_step=r)
    params, model, memory, processed, mask, _ = setup(jcfg, tcfg, B)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = ATOL_BF16 if dtype == "bfloat16" else (ATOL, 0.0)
    jfp = jdb.pack_batch_decoder_params(params, jcfg, dtype=jdt)
    tfp = db.pack_batch_decoder_params(model, tdt)
    rng = jax.random.PRNGKey(42) if dropout else None
    jmem, jproc, jmask = map(jnp.asarray, (memory, processed, mask))
    tmem, tproc, tmask = map(torch.from_numpy, (memory, processed, mask))
    jc = jm.init_stream_carry(jmem, jcfg)
    tc = tm.init_stream_carry(tmem, tcfg)
    rows = -(-B // 8) * 8
    for _ in range(3):
        keep = None
        if dropout:
            k1, k2 = _prenet_keep_masks(rng, jc.t, 6, tcfg.prenet_dim, B,
                                        rows=rows)
            keep = (torch.tensor(np.asarray(k1)[:, :B]),
                    torch.tensor(np.asarray(k2)[:, :B]))
        jc, (jmel, jgate, jalign) = jdb.decode_chunk_batch(
            jfp, jc, jmem, jproc, jmask, jcfg, chunk_steps=6,
            dtype=jdt, interpret=True, rng=rng)
        tc, (tmel, tgate, talign) = db.decode_chunk_batch(
            tfp, tc, tmem, tproc, tmask, tcfg, chunk_steps=6,
            keep_masks=keep)
        close(tmel, jmel, "mel", tol)
        close(tgate, jgate, "gate", tol)
        close(talign, jalign, "align", tol)
    check_carry(tc, jc, tol)


def test_autoregressive_matches_jax_kernel():
    """Host loop over chunks == the JAX while_loop: early exit once every
    row latched, the tail filled with mel 0 / gate 1e3 / align 0, lengths
    in frames."""
    jcfg, tcfg = configs(gate_threshold=0.5, max_decoder_steps=18)
    params, model, memory, processed, mask, _ = setup(jcfg, tcfg, 4, seed=5)
    got = db.decode_autoregressive_batch(
        db.pack_batch_decoder_params(model, torch.float32),
        torch.from_numpy(memory), torch.from_numpy(processed),
        torch.from_numpy(mask), tcfg, chunk_steps=6)
    want = jdb.decode_autoregressive_batch(
        jdb.pack_batch_decoder_params(params, jcfg, dtype=jnp.float32),
        jnp.asarray(memory), jnp.asarray(processed), jnp.asarray(mask), jcfg,
        chunk_steps=6, dtype=jnp.float32, interpret=True)
    for g, w, name in zip(got, want, ("mel", "gate", "align", "lengths")):
        close(g, w, name)


@pytest.mark.parametrize("thr", [-0.5, 0.0, 0.3, 0.5, 0.99, 1.0, 2.0])
def test_gate_logit_threshold_matches_jax(thr):
    jcfg, tcfg = configs(gate_threshold=thr)
    assert db.gate_logit_threshold(tcfg) == gate_logit_threshold(jcfg)


def test_all_masked_row_stays_finite():
    """The additive -1e30 mask keeps a row with no valid encoder position
    finite (uniform weights) where -inf would give NaN; the other rows are
    unaffected by it."""
    jcfg, tcfg = configs()
    _, model, memory, processed, mask, _ = setup(jcfg, tcfg, 3)
    fp = db.pack_batch_decoder_params(model, torch.float32)
    mem, proc = torch.from_numpy(memory), torch.from_numpy(processed)
    full = torch.from_numpy(mask)
    dead = full.clone()
    dead[1] = False
    outs = []
    for m in (full, dead):
        carry = tm.init_stream_carry(mem, tcfg)
        outs.append(db.decode_chunk_batch(fp, carry, mem, proc, m, tcfg,
                                          chunk_steps=4))
    (_, (mel_a, _, _)), (carry, (mel_b, gate_b, align_b)) = outs
    for x in (mel_b, gate_b, align_b, carry.state.att_context):
        assert torch.isfinite(x).all()
    np.testing.assert_allclose(align_b[1].numpy(), 1.0 / memory.shape[1],
                               rtol=1e-6)
    np.testing.assert_array_equal(mel_a[[0, 2]].numpy(),
                                  mel_b[[0, 2]].numpy())


def sequential_decode(fp, inputs, memory, cfg, max_steps, chunk_steps,
                      generator):
    """The chunk loop that reads each chunk's latch before launching the
    next (the reference for the look-ahead loop), on the plain chunk."""
    B, t_in, _ = memory.shape
    carry = tm.init_stream_carry(memory, cfg)
    outs = []
    while carry.t < max_steps:
        if bool(carry.finished.all()):
            break
        cs = min(chunk_steps, max_steps - carry.t)
        keep = None
        if generator is not None:
            keep = tuple(torch.rand((cs, B, cfg.prenet_dim),
                                    generator=generator) < 0.5
                         for _ in range(2))
        carry, out = db._decode_chunk(fp, carry, inputs, cfg, cs, keep,
                                      db.decoder_chunk_plain)
        outs.append(out)
    mel = torch.zeros(B, max_steps, cfg.n_mel_channels)
    gate = torch.full((B, max_steps), db.GATE_MASK)
    align = torch.zeros(B, max_steps, t_in)
    for x, i in ((mel, 0), (gate, 1), (align, 2)):
        x[:, :carry.t] = torch.cat([o[i] for o in outs], dim=1)
    return mel, gate, align, carry.lengths


@pytest.mark.parametrize("stop,dropout", [
    (True, False),    # every row latches in the second of four chunks
    (True, True),     # the same with inference-time prenet dropout
    (False, False),   # no latch: the decode reaches max_steps
], ids=["stop", "stop-generator", "cap"])
def test_look_ahead_equals_sequential_loop(stop, dropout):
    """The loop that launches chunk k+1 before reading chunk k's latch
    gives, bit for bit, what the chunk-by-chunk loop gives: the chunk past
    the stop is dropped (one discard), and a generator is left as the
    chunk-by-chunk loop leaves it."""
    cs, max_steps, B = 6, 24, 4
    cfg = Tacotron2Config(**{**DIMS, "gate_threshold": 1.0})
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(3))
    fp = db.pack_batch_decoder_params(model, torch.float32)
    g = torch.Generator().manual_seed(4)
    memory = torch.randn(B, 20, 128, generator=g) * 0.5
    proc = torch.randn(B, 20, 128, generator=g) * 0.5
    mask = torch.arange(20)[None] < torch.tensor([20, 17, 14, 20])[:, None]
    inputs = db.attention_inputs(memory, proc, mask, torch.float32)
    rng = lambda: torch.Generator().manual_seed(5) if dropout else None
    if stop:
        # a gate threshold between the lowest of the rows' running maxima
        # after chunk 0 and after chunk 1: some row is still running after
        # chunk 0, and every row has latched after chunk 1
        free = sequential_decode(fp, inputs, memory, cfg, max_steps, cs,
                                 rng())[1]
        lo = float(free[:, :cs].max(1).values.min())
        hi = float(free[:, :2 * cs].max(1).values.min())
        assert lo < hi
        cfg = cfg.replace(gate_threshold=1 / (1 + math.exp(-(lo + hi) / 2)))
    g_seq, g_ahead = rng(), rng()
    want = sequential_decode(fp, inputs, memory, cfg, max_steps, cs, g_seq)
    discarded = db._autoregressive.discarded
    launches = db.decoder_chunk_plain.calls
    got = db._autoregressive(fp, inputs, memory, cfg, max_steps, cs, g_ahead,
                             chunk=db.decoder_chunk_plain)
    for x, y, name in zip(got, want, ("mel", "gate", "align", "lengths")):
        assert torch.equal(x, y), name
    assert db._autoregressive.discarded - discarded == int(stop)
    assert db.decoder_chunk_plain.calls - launches == (3 if stop else 4)
    if stop:
        assert int(got[3].max()) <= 2 * cs < max_steps
        assert 0 < int(got[3].max()) - cs
    if dropout:
        assert torch.equal(g_ahead.get_state(), g_seq.get_state())
