"""The port's hand-written CUDA kernels against their plain versions, on the
card (marker ``gpu``; each test skips without a CUDA device).

This file imports nothing of JAX, so it runs where only the port is
installed: ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``. The
plain versions are held against the JAX package on the CPU by
tests/test_torch_encoder_lstm.py, tests/test_torch_decoder_batch.py,
tests/test_torch_decoder_step.py, tests/test_torch_int8.py and
tests/test_torch_audio.py.

Tolerances. Decoder chunk: each output and carry field within its own
share of its largest |value| (DEC_REL), about ten times the worst reading
of that field on the card, so that attention weights of ~1/T are held as
tightly as mel values; the kernel and its plain version share every cast
point and differ only in the order of fp32 sums. Encoder: fp32 1e-4 absolute; bf16 3e-2
absolute (one bf16 rounding flip of an operand, 2^-8 relative, carried
through a few steps of the recurrence). Single-utterance decoder chunk: as
the batched one, with its own table (STEP_REL). int8 product: 1e-5 of the
output's largest value (exact products, fp32 sums in another order). Mel
kernel: 1e-4 in the log domain (its DFT as three TF32 products, ~2^-22 of
each product, and fp32 sums of 1024 and 513 terms in another order; the log
turns a relative error into an absolute one). TF32 is off for the plain
versions' products. Rows across the row tiles serving decodes at: the
same bits, but for cuDNN's convolutions (TILE_RMS, from the readings).
"""

import importlib
import json
import math

import pytest
import torch

from tacotron2_tpu_torch.audio.mel import MelConfig
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import decoder_step as ds
from tacotron2_tpu_torch.kernels import encoder_lstm as el
from tacotron2_tpu_torch.kernels.lstm_layout import to_blocks
from tacotron2_tpu_torch.kernels import mel_kernel as mk
from tacotron2_tpu_torch.models import tacotron2 as tm

# the package exports a function ``int8_matmul`` that hides the module
i8 = importlib.import_module("tacotron2_tpu_torch.kernels.int8_matmul")

CFG = Tacotron2Config(
    n_symbols=40, symbols_embedding_dim=128, encoder_embedding_dim=128,
    encoder_n_convolutions=1, attention_rnn_dim=128, decoder_rnn_dim=128,
    prenet_dim=128, attention_dim=128, attention_location_n_filters=4,
    attention_location_kernel_size=31, n_mel_channels=16,
    postnet_embedding_dim=32, postnet_n_convolutions=2,
    compute_dtype="float32")
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)]  # encoder, atol
CARRY = ("h1", "c1", "h2", "c2", "w", "wc", "ctx", "prev")
# Decoder chunk: largest |err| of each field as a share of the field's
# largest |value|, about ten times the worst reading on the card over these
# cases and chip_smoke.py's full-width chunks (the same table).
DEC_REL = {
    torch.bfloat16: dict(mel=2e-2, gate=9e-2, align=2e-2, h1=2e-2, c1=2e-2,
                         h2=8e-3, c2=9e-3, w=2e-2, wc=3e-3, ctx=5e-3,
                         prev=2e-2),
    torch.float32: dict(mel=6e-6, gate=4e-5, align=4e-6, h1=3e-6, c1=3e-6,
                        h2=3e-6, c2=2e-6, w=3e-6, wc=3e-6, ctx=3e-6,
                        prev=5e-6),
}
# Single-utterance decoder chunk, the same measure: about ten times the
# worst reading on the card over these cases and chip_smoke.py's full-width
# chunks (the same table).
STEP_REL = {
    torch.bfloat16: dict(mel=1e-2, gate=3e-1, align=2e-2, h1=1e-2, c1=1e-2,
                         h2=5e-3, c2=5e-3, w=2e-2, wc=2e-3, ctx=3e-3,
                         prev=1e-2),
}
INT8_REL = 1e-5
MEL_LOG_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def zero_carry(B, T, n, device):
    z = lambda *s: torch.zeros(*s, device=device)
    i32 = lambda: torch.zeros(B, dtype=torch.int32, device=device)
    return db.ChunkCarry(z(B, 128), z(B, 128), z(B, 128), z(B, 128),
                         z(B, T), z(B, T), z(B, 128), z(B, n), i32(), i32())


def chunk_case(device, dtype, B, r, dropout):
    """A 16-step chunk at T=37 from a zero carry: (fp, args, kwargs)."""
    cfg = CFG.replace(gate_threshold=0.3, n_frames_per_step=r)
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(0)).to(device)
    fp = db.pack_batch_decoder_params(model, dtype)
    g = torch.Generator(device=device).manual_seed(1)
    T = 37
    mem = torch.randn(B, T, 128, generator=g, device=device) * 0.5
    proc = torch.randn(B, T, 128, generator=g, device=device) * 0.5
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    mask = torch.arange(T, device=device)[None] < lengths[:, None]
    mem, proc, emask = db.attention_inputs(mem, proc, mask, dtype)
    n, p = fp.pre1.shape
    carry = zero_carry(B, T, n, device)
    kp = (None, None)
    if dropout:
        kp = tuple((torch.rand(16, B, p, generator=g, device=device) < 0.5
                    ).float() for _ in range(2))
    kw = dict(t0=3, chunk_steps=16, gate_logit=-0.5, kp1=kp[0], kp2=kp[1])
    return (fp, carry, mem, proc, emask), kw


def assert_chunks_close(got, want, rel):
    """Each output and carry field within ``rel[field]`` times the field's
    largest |value|; finished and lengths exactly."""
    pairs = [(f, getattr(got, f), getattr(want, f))
             for f in ("mel", "gate", "align")]
    pairs += [(f, getattr(got.carry, f), getattr(want.carry, f))
              for f in CARRY]
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        assert err <= rel[name] * scale, (
            f"{name}: max |err| {err} beyond {rel[name]} of the field's "
            f"largest value {scale}")
    assert torch.equal(got.carry.fin, want.carry.fin)
    assert torch.equal(got.carry.lens, want.carry.lens)


def perturbed(out):
    """Attention off: align scaled by 1.05; w shifted by one encoder
    position."""
    return [out._replace(align=out.align * 1.05),
            out._replace(carry=out.carry._replace(
                w=torch.roll(out.carry.w, 1, dims=1)))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,r,dropout", [(4, 1, False), (21, 2, True)])
def test_decoder_kernel_matches_plain(cuda, B, r, dropout):
    """bf16, the kernel's one precision: every output and carry field;
    finished and lengths exactly. The same check rejects the kernel's
    output with its attention perturbed."""
    bf16 = torch.bfloat16
    args, kw = chunk_case(cuda, bf16, B, r, dropout)
    got = db.decoder_chunk(*args, **kw)
    want = db.decoder_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_chunks_close(got, want, DEC_REL[bf16])
    for bad in perturbed(got):
        with pytest.raises(AssertionError):
            assert_chunks_close(bad, want, DEC_REL[bf16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_check_rejects_perturbed_attention(dtype):
    """On the CPU, with the plain version: the decoder comparison passes an
    output against itself and fails it with align 5% off or w shifted by
    one position, at the limits the card's comparison uses."""
    args, kw = chunk_case(torch.device("cpu"), dtype, 4, 1, False)
    out = db.decoder_chunk_plain(*args, **kw)
    assert_chunks_close(out, out, DEC_REL[dtype])
    for bad in perturbed(out):
        with pytest.raises(AssertionError):
            assert_chunks_close(bad, out, DEC_REL[dtype])


@pytest.mark.gpu
def test_decoder_kernel_rejects_mismatched_inputs(cuda):
    """A bf16 chunk on the card never falls back to the plain version:
    inputs the kernel does not take raise."""
    model = tm.Tacotron2(CFG).to(cuda)
    fp = db.pack_batch_decoder_params(model, torch.bfloat16)
    x = torch.zeros(2, 8, 128, device=cuda)
    mem, proc, emask = db.attention_inputs(x, x, None, torch.float32)
    with pytest.raises(ValueError):
        db.decoder_chunk(fp, zero_carry(2, 8, 16, cuda), mem, proc, emask,
                         t0=0, chunk_steps=2, gate_logit=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,T", [(8, 20), (13, 7)])
def test_encoder_kernel_matches_plain(cuda, dtype, tol, B, T):
    """All six stacks of both directions (B=13: a ragged row tile)."""
    N, H = 256, 128
    g = torch.Generator(device=cuda).manual_seed(0)
    rand = lambda *s: (torch.rand(*s, generator=g, device=cuda) - 0.5)
    wf, wb = (to_blocks(rand(N + H, 4 * H).mul(0.2).to(dtype), 4)
              for _ in range(2))
    bf, bb = (rand(4 * H).mul(0.2) for _ in range(2))
    xs, xsr = (rand(B, T, N).to(dtype) for _ in range(2))
    got = el.bilstm_forward(wf, bf, wb, bb, xs, xsr)
    want = el.bilstm_forward_plain(wf, bf, wb, bb, xs, xsr)
    torch.cuda.synchronize()
    for name, a, b in zip(("gf", "gb", "hf", "hb", "cf", "cb"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0,
                                   msg=name)


@pytest.mark.gpu
def test_encoder_kernel_rejects_cpu_weights(cuda):
    xs = torch.zeros(8, 4, 256, device=cuda)
    w = torch.zeros(32, 384, 16)
    b = torch.zeros(512)
    with pytest.raises(ValueError):
        el.bilstm_forward(w, b, w, b, xs, xs)


# ------------------------------------------------------------ training slice

from tacotron2_tpu_torch.kernels import train_scan as ts  # noqa: E402
from tacotron2_tpu_torch.models import decoder_vjp as dv  # noqa: E402

# Scan kernels against their plain versions: the largest |err| of each
# stack as a share of its largest |value| (same table in chip_smoke.py).
SCAN_REL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
ENC_BWD_REL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


def rel_errs(got, want, names):
    out = {}
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        out[name] = err / scale if scale > 0 else err
    return out


def scan_case(device, dtype, B, T_in, steps, dropout, seed=0, cfg=CFG):
    """(sw, prenet, mem, proc, emask, keep, kw) at cfg's widths (CFG:
    128, ks 31)."""
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(seed)).to(device)
    sw = dv._pack(dv.core_weights(model), dtype)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    rand = lambda *s: torch.randn(*s, generator=g, device=device) * 0.3
    lengths = torch.randint(T_in // 2, T_in + 1, (B,), generator=g,
                            device=device)
    lengths[0] = T_in
    mask = torch.arange(T_in, device=device)[None] < lengths[:, None]
    E, datt = cfg.encoder_embedding_dim, cfg.attention_dim
    mem, proc, emask = db.attention_inputs(rand(B, T_in, E),
                                           rand(B, T_in, datt), mask, dtype)
    prenet = rand(steps, B, cfg.prenet_dim).to(dtype)
    keep = (ts.keep_masks(g, steps, B, cfg.attention_rnn_dim,
                          cfg.decoder_rnn_dim, 0.1, 0.1) if dropout
            else None)
    return sw, prenet, mem, proc, emask, dict(keep=keep, p_att=0.1,
                                              p_dec=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T_in,dropout", [(8, 37, False), (13, 20, True)])
def test_scan_forward_kernel_matches_plain(cuda, dtype, B, T_in, dropout):
    """Row 1: all eight residual stacks over 6 steps (B=13: a ragged row
    tile; T_in=37: not a multiple of the energy tile)."""
    sw, pre, mem, proc, emask, kw = scan_case(cuda, dtype, B, T_in, 6,
                                              dropout)
    got = ts.forward_residuals(sw, pre, mem, proc, emask, **kw)
    want = ts.forward_residuals_plain(sw, pre, mem, proc, emask, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ts.Residuals._fields)
    assert max(errs.values()) <= SCAN_REL[dtype], errs


def _bwd_case(cuda, dtype, B, T_in, dropout, cfg=CFG, steps=6):
    sw, pre, mem, proc, emask, kw = scan_case(cuda, dtype, B, T_in, steps,
                                              dropout, cfg=cfg)
    res = ts.forward_residuals_plain(sw, pre, mem, proc, emask, **kw)
    g = torch.Generator(device=cuda).manual_seed(5)
    cot = lambda x: torch.randn(x.shape, generator=g, device=cuda) * 0.1
    return sw, res, mem, proc, (cot(res.dec_h), cot(res.ctx),
                                cot(res.w) * (emask == 0)), kw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T_in,dropout", [(8, 37, False), (13, 20, True)])
def test_scan_backward_kernel_matches_plain(cuda, dtype, B, T_in, dropout):
    """Row 2: every output, d_processed, d_K2 and d_v included, from the
    same residuals and cotangents."""
    sw, res, mem, proc, cots, kw = _bwd_case(cuda, dtype, B, T_in, dropout)
    got = ts.backward_chain(sw, res, mem, proc, *cots, **kw)
    want = ts.backward_chain_plain(sw, res, mem, proc, *cots, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ts.ChainGrads._fields)
    assert max(errs.values()) <= SCAN_REL[dtype], errs


# The bf16 chain on the tensor cores: rows not a multiple of the product's
# 16-row fragments (1, 13), a full 128-row tile, encoder lengths no
# multiple of its 32-position tiles, and products whose column count
# (P+E+A = 96+136+128, A+E+D = 128+136+128) leaves a ragged column tile.
RAGGED = CFG.replace(prenet_dim=96, encoder_embedding_dim=136)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T_in,cfg", [(1, 37, CFG), (8, 64, RAGGED),
                                        (13, 45, RAGGED), (128, 70, CFG)],
                         ids=["B1", "B8-ragged", "B13-ragged", "B128"])
def test_scan_backward_tensor_core_shapes_match_plain(cuda, B, T_in, cfg):
    """Row 2 at bf16 with dropout, every output within SCAN_REL."""
    sw, res, mem, proc, cots, kw = _bwd_case(cuda, torch.bfloat16, B, T_in,
                                             True, cfg=cfg)
    got = ts.backward_chain(sw, res, mem, proc, *cots, **kw)
    want = ts.backward_chain_plain(sw, res, mem, proc, *cots, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ts.ChainGrads._fields)
    assert max(errs.values()) <= SCAN_REL[torch.bfloat16], errs


# Shapes outside the tensor-core chain's range (an attention width of 256,
# LSTM widths that are no multiple of 32, an encoder width that is no
# multiple of 8, 33 location taps): at bf16 they take the CUDA-core chain,
# the one the fp32 step runs, instantiated at bf16.
@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [
    CFG.replace(attention_dim=256),
    CFG.replace(attention_rnn_dim=40, decoder_rnn_dim=40),
    CFG.replace(encoder_embedding_dim=132),
    CFG.replace(attention_location_kernel_size=33)],
    ids=["datt256", "lstm40", "E132", "ks33"])
def test_scan_backward_cuda_core_shapes_match_plain(cuda, cfg):
    """Row 2 at bf16 with dropout outside the tensor-core range (B=13,
    T_in=45), every output within SCAN_REL."""
    sw, res, mem, proc, cots, kw = _bwd_case(cuda, torch.bfloat16, 13, 45,
                                             True, cfg=cfg)
    launches = ts.backward_chain.launches
    got = ts.backward_chain(sw, res, mem, proc, *cots, **kw)
    assert ts.backward_chain.launches == launches + 1
    want = ts.backward_chain_plain(sw, res, mem, proc, *cots, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ts.ChainGrads._fields)
    assert max(errs.values()) <= SCAN_REL[torch.bfloat16], errs


@pytest.mark.gpu
def test_scan_backward_accumulators_are_deterministic(cuda):
    """Two runs of the backward kernel at B=128 give the same bits of d_K2,
    d_v and d_processed, and of the gate and query cotangents (fixed-order
    sums of the K slices and tiles, no atomics)."""
    sw, res, mem, proc, cots, kw = _bwd_case(cuda, torch.bfloat16, 128, 45,
                                             True)
    a = ts.backward_chain(sw, res, mem, proc, *cots, **kw)
    b = ts.backward_chain(sw, res, mem, proc, *cots, **kw)
    for name in ("d_k2", "d_v", "d_processed", "dga", "dgd", "d_q"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(8, 20), (13, 7)])
def test_encoder_backward_kernel_matches_plain(cuda, dtype, B, T):
    """Row 4: dgates and dx of both directions."""
    N, H = 256, 128
    g = torch.Generator(device=cuda).manual_seed(2)
    rand = lambda *s: (torch.rand(*s, generator=g, device=cuda) - 0.5)
    wf, wb = (to_blocks(rand(N + H, 4 * H).mul(0.2).to(dtype), 4)
              for _ in range(2))
    bf, bb = (rand(4 * H).mul(0.2) for _ in range(2))
    xs, xsr = (rand(B, T, N).to(dtype) for _ in range(2))
    gf, gb, _, _, cf, cb = el.bilstm_forward_plain(wf, bf, wb, bb, xs, xsr)
    from tacotron2_tpu_torch.kernels.lstm_layout import from_blocks
    wtf, wtb = (from_blocks(w).t().contiguous() for w in (wf, wb))
    dhf, dhb = (rand(T, B, H) for _ in range(2))
    args = (wtf, wtb, gf, gb, cf, cb, dhf, dhb)
    got = el.bilstm_backward(*args)
    want = el.bilstm_backward_plain(*args)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ("dgf", "dgb", "dxf", "dxb"))
    assert max(errs.values()) <= ENC_BWD_REL[dtype], errs


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One fp32 training step of CFG's model on the card (all four kernels)
    against the same step on the CPU (their plain versions): the loss to
    1e-5 and every parameter gradient within 1e-4 of its largest value
    (1e-3 of 1e-3 for gradients that are zero up to rounding)."""
    from tacotron2_tpu_torch.training import state as st
    counts = (el.bilstm_forward.launches, el.bilstm_backward.launches,
              ts.forward_residuals.launches, ts.backward_chain.launches)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = st.create_train_state(
            CFG, generator=torch.Generator().manual_seed(3), device=dev)
        batch = st.make_batch(CFG, 8, 24, 12, seed=1, device=dev)
        out[dev.type] = st.loss_and_grads(state, batch, CFG)
    after = (el.bilstm_forward.launches, el.bilstm_backward.launches,
             ts.forward_residuals.launches, ts.backward_chain.launches)
    assert all(a == c + 1 for a, c in zip(after, counts)), (counts, after)
    (lg, gg, _, _), (lc, gc, _, _) = out["cuda"], out["cpu"]
    assert abs(float(lg.total) - float(lc.total)) <= 1e-5 * abs(float(lc.total))
    for k in gc:
        scale = max(float(gc[k].abs().max()), 1e-3)
        err = float((gg[k].cpu() - gc[k]).abs().max())
        assert err <= 1e-4 * scale, (k, err / scale)


# ------------------------------------------- the single-utterance kernels

def step_case(device, dtype, T, cs, r, dropout):
    """A ``cs``-step chunk of one row at encoder length T (the last 5
    positions masked) from a zero carry: (fp, args, kwargs)."""
    cfg = CFG.replace(gate_threshold=0.3, n_frames_per_step=r)
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(0)).to(device)
    fp = ds.pack_decoder_params(model, dtype)
    g = torch.Generator(device=device).manual_seed(2)
    mem = torch.randn(1, T, 128, generator=g, device=device) * 0.5
    proc = torch.randn(1, T, 128, generator=g, device=device) * 0.5
    if dtype == torch.bfloat16:  # processed memory holds bf16 values
        proc = proc.to(dtype).float()
    mask = torch.arange(T, device=device)[None] < T - 5
    mem, proc, emask = ds.attention_inputs(mem, proc, mask)
    n, p = fp.pre1.shape
    kp = (None, None)
    if dropout:
        kp = tuple((torch.rand(cs, 1, p, generator=g, device=device) < 0.5
                    ).float() for _ in range(2))
    kw = dict(t0=3, chunk_steps=cs, gate_logit=-0.5, kp1=kp[0], kp2=kp[1])
    return (fp, zero_carry(1, T, n, device), mem, proc, emask), kw


@pytest.mark.gpu
@pytest.mark.parametrize("T,cs,r,dropout", [(37, 16, 1, False),
                                            (64, 32, 2, True),
                                            (190, 7, 1, False)])
def test_decoder_step_kernel_matches_plain(cuda, T, cs, r, dropout):
    """bf16, the kernel's one precision: every output and carry field,
    after the latch too; finished and lengths exactly; perturbed attention
    is rejected; the input carry is left as it was."""
    bf16 = torch.bfloat16
    args, kw = step_case(cuda, bf16, T, cs, r, dropout)
    before = [x.clone() for x in args[1]]
    launches = ds.decoder_step_chunk.launches
    got = ds.decoder_step_chunk(*args, **kw)
    assert ds.decoder_step_chunk.launches == launches + 1
    want = ds.decoder_step_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_chunks_close(got, want, STEP_REL[bf16])
    for bad in perturbed(got):
        with pytest.raises(AssertionError):
            assert_chunks_close(bad, want, STEP_REL[bf16])
    assert all(torch.equal(a, b) for a, b in zip(args[1], before))


@pytest.mark.gpu
def test_decoder_step_kernel_rejects_what_it_does_not_take(cuda):
    (fp, carry, mem, proc, emask), kw = step_case(cuda, torch.bfloat16, 20,
                                                  4, 1, False)
    with pytest.raises(ValueError, match="mem"):   # memory must be fp32
        ds.decoder_step_chunk(fp, carry, mem.bfloat16(), proc, emask, **kw)
    with pytest.raises(ValueError, match="k2"):    # the batched chunk's pack
        ds.decoder_step_chunk(fp._replace(k2=fp.k2.bfloat16()), carry, mem,
                              proc, emask, **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        ds.decoder_step_chunk(fp, carry._replace(h1=carry.h1.cpu()), mem,
                              proc, emask, **kw)


# the JAX package's test shapes, the two decoder cells at B=1, more than 8
# rows, and edges ragged in K and N (N not a multiple of 8: byte loads)
@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", [(1, 256, 512), (8, 1792, 4096),
                                   (3, 100, 83), (1, 1792, 4096),
                                   (1, 2560, 4096), (19, 257, 40),
                                   (2, 33, 7), (5, 64, 33)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_matches_plain(cuda, B, K, N, xdtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(B, K, generator=g, device=cuda).to(xdtype)
    w = torch.randn(K, N, generator=g, device=cuda) * 0.05
    w_q, scale = (t.to(cuda) for t in i8.quantize_int8(w))
    launches = i8.int8_matmul.launches
    got = i8.int8_matmul(x, w_q, scale, packed=i8.pack_int8(w_q))
    assert i8.int8_matmul.launches == launches + 1
    want = i8.int8_matmul_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert got.shape == (B, N) and got.dtype == torch.float32
    scale_ = float(want.abs().max())
    assert float((got - want).abs().max()) <= INT8_REL * scale_
    # one column's scale off by 5% must show
    bad = got.clone()
    bad[:, N // 2] *= 1.05
    assert float((bad - want).abs().max()) > INT8_REL * scale_


@pytest.mark.gpu
def test_int8_kernel_rejects_mixed_devices(cuda):
    w_q, scale = i8.quantize_int8(torch.ones(4, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        i8.int8_matmul(torch.ones(1, 4, device=cuda), w_q, scale)
    with pytest.raises(ValueError, match="contiguous"):
        i8.int8_matmul(torch.ones(1, 4, device=cuda),
                       w_q.t().contiguous().t().to(cuda), scale.to(cuda))


# whole tiles of 64 frames, a ragged last tile, fewer frames than a tile,
# a narrow config whose depth is no multiple of the staged chunk (and whose
# 101 bins leave a ragged bin tile, as 513 do), the front end's batch of
# 16 x 6 s (1.5 tiles of frames straddle each pair of waveforms), a window
# off the frame's centre (n_fft - win_length odd: the second pass of folded
# bases) and an odd n_fft (no unpaired middle row)
@pytest.mark.gpu
@pytest.mark.parametrize("B,S,cfg", [
    (2, 127 * 256, MelConfig()), (3, 10000, MelConfig()),
    (1, 700, MelConfig()), (16, 6 * 22050, MelConfig()),
    (2, 3000, MelConfig(filter_length=200, hop_length=50, win_length=160,
                        n_mel_channels=20, sampling_rate=8000,
                        mel_fmax=4000.0)),
    (2, 3000, MelConfig(filter_length=256, hop_length=64, win_length=201,
                        n_mel_channels=20, sampling_rate=8000,
                        mel_fmax=4000.0)),
    (2, 3000, MelConfig(filter_length=255, hop_length=64, win_length=255,
                        n_mel_channels=20, sampling_rate=8000,
                        mel_fmax=4000.0))])
def test_mel_kernel_matches_plain(cuda, B, S, cfg):
    g = torch.Generator(device=cuda).manual_seed(4)
    y = (torch.rand(B, S, generator=g, device=cuda) * 2 - 1) * 0.3
    y[0] *= 1e-4   # a quiet row: most mels near the 1e-5 floor
    launches = mk.mel_spectrogram_fused.launches
    got = mk.mel_spectrogram_fused(y, cfg)
    assert mk.mel_spectrogram_fused.launches == launches + 1
    want = mk.mel_spectrogram_fused_plain(y, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, cfg.n_mel_channels,
                                       1 + S // cfg.hop_length)
    assert float((got - want).abs().max()) <= MEL_LOG_ATOL
    shifted = torch.roll(got, 1, dims=2)   # frames off by one must show
    assert float((shifted - want).abs().max()) > MEL_LOG_ATOL


@pytest.mark.gpu
def test_mel_kernel_rejects_what_it_does_not_take(cuda):
    """More than 128 mels, and too few samples to reflect-pad; its shared
    memory no longer depends on the hop, so hop 1024 is taken."""
    y = torch.zeros(1, 4000, device=cuda)
    with pytest.raises(ValueError, match="128 mel"):
        mk.mel_spectrogram_fused(y, MelConfig(n_mel_channels=160))
    with pytest.raises(ValueError, match="too few"):
        mk.mel_spectrogram_fused(y[:, :512], MelConfig())
    got = mk.mel_spectrogram_fused(y, MelConfig(hop_length=1024))
    assert got.shape == (1, 80, 1 + 4000 // 1024)


# ------------------------------------------------------ slice 5: rows 1, 5

def kernel_names(run):
    """Names of the CUDA kernels one run() launches (torch.profiler). Now
    and then a short session on the card's machine records no device event
    at all, so the session is widened by 50 ms of idle time on each side of
    run(), and a session that still records none is taken again, up to
    three times."""
    import time
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            run()
            torch.cuda.synchronize()
            time.sleep(0.05)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("T_in", [64, 192])
@pytest.mark.parametrize("B", [1, 13, 128, 200])
def test_scan_forward_tensor_core_shapes_match_plain(cuda, B, T_in,
                                                     dropout):
    """Row 1 at bf16 on the tensor cores (B=200: two 128-row tiles), every
    residual stack within SCAN_REL; the CUDA-core LSTM kernel never runs."""
    sw, pre, mem, proc, emask, kw = scan_case(cuda, torch.bfloat16, B, T_in,
                                              6, dropout)
    run = lambda: ts.forward_residuals(sw, pre, mem, proc, emask, **kw)
    names = kernel_names(run)
    assert any("scan_cell_kernel" in n for n in names), set(names)
    assert not any("scan_lstm_kernel" in n for n in names), set(names)
    got = run()
    want = ts.forward_residuals_plain(sw, pre, mem, proc, emask, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ts.Residuals._fields)
    assert max(errs.values()) <= SCAN_REL[torch.bfloat16], errs


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [
    CFG.replace(attention_rnn_dim=40, decoder_rnn_dim=40),
    CFG.replace(attention_dim=256)], ids=["lstm40", "datt256"])
def test_scan_forward_cuda_core_shapes_match_plain(cuda, cfg):
    """Row 1 at bf16 outside the tensor-core range (B=13, T_in=45, with
    dropout) takes the CUDA-core kernels, every stack within SCAN_REL."""
    sw, pre, mem, proc, emask, kw = scan_case(cuda, torch.bfloat16, 13, 45,
                                              6, True, cfg=cfg)
    run = lambda: ts.forward_residuals(sw, pre, mem, proc, emask, **kw)
    names = kernel_names(run)
    assert any("scan_lstm_kernel" in n for n in names), set(names)
    assert not any("scan_cell_kernel" in n for n in names), set(names)
    got = run()
    want = ts.forward_residuals_plain(sw, pre, mem, proc, emask, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ts.Residuals._fields)
    assert max(errs.values()) <= SCAN_REL[torch.bfloat16], errs


def persistent_case(device, B, cs, keep, gate_logit=1e30, T=37):
    """A bf16 chunk of cs steps at T encoder positions from a zero carry
    (the narrow widths of CFG): (args, kwargs)."""
    model = tm.Tacotron2(CFG, torch.Generator().manual_seed(0)).to(device)
    fp = db.pack_batch_decoder_params(model, torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(2 + B)
    mem = torch.randn(B, T, 128, generator=g, device=device) * 0.5
    proc = torch.randn(B, T, 128, generator=g, device=device) * 0.5
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    mask = torch.arange(T, device=device)[None] < lengths[:, None]
    mem, proc, emask = db.attention_inputs(mem, proc, mask, torch.bfloat16)
    n, p = fp.pre1.shape
    kp = (None, None)
    if keep:
        kp = tuple((torch.rand(cs, B, p, generator=g, device=device) < 0.5
                    ).float() for _ in range(2))
    kw = dict(t0=5, chunk_steps=cs, gate_logit=gate_logit, kp1=kp[0],
              kp2=kp[1])
    return (fp, zero_carry(B, T, n, device), mem, proc, emask), kw


@pytest.mark.gpu
@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("cs", [1, 64])
@pytest.mark.parametrize("B,T", [(1, 37), (4, 37), (8, 37), (13, 37),
                                 (21, 37), (32, 37), (21, 192), (32, 192)])
def test_persistent_chunk_matches_plain(cuda, B, T, cs, keep):
    """Row 5 at bf16, one persistent launch: every output and carry field
    within DEC_REL, finished and lengths exactly. B=32 is the rows serving
    pads to; at T=192 the energies take two rows an item."""
    args, kw = persistent_case(cuda, B, cs, keep, T=T)
    got = db.decoder_chunk(*args, **kw)
    want = db.decoder_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_chunks_close(got, want, DEC_REL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 21, 32])
def test_persistent_chunk_latches_mid_chunk(cuda, B):
    """A gate threshold that some rows cross mid-chunk (the midpoint of the
    widest gap between the plain version's gate logits in their middle
    half, so no logit sits near it): finished and lengths equal the plain
    version's, every field within DEC_REL."""
    cs = 16
    args, kw = persistent_case(cuda, B, cs, False)
    free = db.decoder_chunk_plain(*args, **kw).gate.flatten().sort().values
    mid = free[len(free) // 4:3 * len(free) // 4]
    i = int((mid[1:] - mid[:-1]).argmax())
    kw["gate_logit"] = float(mid[i] + mid[i + 1]) / 2
    got = db.decoder_chunk(*args, **kw)
    want = db.decoder_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert bool(want.carry.fin.any())
    assert int(want.carry.lens.min()) < kw["t0"] + cs
    assert_chunks_close(got, want, DEC_REL[torch.bfloat16])


@pytest.mark.gpu
def test_persistent_chunk_is_one_deterministic_launch(cuda):
    """A 64-step bf16 chunk is one kernel launch (plus the scratch's
    memset), and two runs give the same bits."""
    args, kw = persistent_case(cuda, 13, 64, True)
    run = lambda: db.decoder_chunk(*args, **kw)
    names = kernel_names(run)
    assert sum("persistent_chunk_kernel" in n for n in names) == 1, names
    a, b = run(), run()
    for x, y in zip((a.mel, a.gate, a.align, *a.carry),
                    (b.mel, b.gate, b.align, *b.carry)):
        assert torch.equal(x, y)


def served_case(device, B, T, cs, keep):
    """A bf16 chunk of cs steps at the default config's full width (the
    served one), B rows of T encoder positions with seeded lengths, from a
    zero carry: (args, kwargs)."""
    from tacotron2_tpu_torch.config import create_config
    cfg = create_config()
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(5)).to(device)
    fp = db.pack_batch_decoder_params(model, torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(B + T)
    mem = torch.randn(B, T, cfg.encoder_embedding_dim, generator=g,
                      device=device) * 0.5
    proc = torch.randn(B, T, cfg.attention_dim, generator=g,
                       device=device) * 0.5
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device=device)
    mask = torch.arange(T, device=device)[None] < lengths[:, None]
    mem, proc, emask = db.attention_inputs(mem, proc, mask, torch.bfloat16)
    n, p = fp.pre1.shape
    a, d, e = (cfg.attention_rnn_dim, cfg.decoder_rnn_dim,
               cfg.encoder_embedding_dim)
    z = lambda *s: torch.zeros(*s, device=device)
    i32 = lambda: torch.zeros(B, dtype=torch.int32, device=device)
    carry = db.ChunkCarry(z(B, a), z(B, a), z(B, d), z(B, d), z(B, T),
                          z(B, T), z(B, e), z(B, n), i32(), i32())
    kp = (None, None)
    if keep:
        kp = tuple((torch.rand(cs, B, p, generator=g, device=device) < 0.5
                    ).float() for _ in range(2))
    kw = dict(t0=4, chunk_steps=cs, gate_logit=1e30, kp1=kp[0], kp2=kp[1])
    return (fp, carry, mem, proc, emask), kw


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,keep", [(32, 64, False), (32, 128, True),
                                      (32, 192, False), (24, 192, True),
                                      (17, 128, False)])
def test_persistent_chunk_at_served_widths(cuda, B, T, keep):
    """Row 5 at the default config's full width, a 64-step chunk at the
    rows serving pads to (and at 24 and 17, where groups hold 3 and 2 rows)
    over the three text buckets: every item partition of every phase
    (row groups of 2 to 4 in the prenet, query and projection, of 2 in the
    energies at T=192 and in the softmax and context), every field within
    DEC_REL, finished and lengths exactly."""
    args, kw = served_case(cuda, B, T, 64, keep)
    got = db.decoder_chunk(*args, **kw)
    want = db.decoder_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_chunks_close(got, want, DEC_REL[torch.bfloat16])


@pytest.mark.gpu
def test_persistent_chunk_takes_one_round_a_phase(cuda):
    """At B=32 and T_in 192 (where the energies took two rounds of
    single-row items, and the other phases two to four) each phase of items
    takes one round (``decoder_chunk.rounds``); at B=1 too (row 6)."""
    args, kw = served_case(cuda, 32, 192, 2, False)
    db.decoder_chunk(*args, **kw)
    assert db.decoder_chunk.phase_rounds == (1,) * db.N_ITEM_PHASES
    assert db.decoder_chunk.rounds == 1
    args, kw = full_step_case(cuda, 192, 2, False)
    ds.decoder_step_chunk(*args, **kw)
    assert ds.decoder_step_chunk.rounds == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [33, 64])
def test_persistent_chunk_slices_rows_past_one_launch(cuda, B):
    """Row 5 at more rows than one launch takes (32): ceil(B / 32)
    launches, each slice of 32 rows the same bits as those rows run alone,
    the rounds of items the largest over the slices, and every field
    within DEC_REL of the plain version."""
    args, kw = persistent_case(cuda, B, 16, True)
    launches = db.decoder_chunk.launches
    got = db.decoder_chunk(*args, **kw)
    assert db.decoder_chunk.launches == launches + -(-B // 32)
    rounds = db.decoder_chunk.phase_rounds
    fp, carry, mem, proc, emask = args
    alone = []
    for i in range(0, B, 32):
        cut = slice(i, i + 32)
        part = db.decoder_chunk(
            fp, db.ChunkCarry(*(x[cut] for x in carry)), mem[cut], proc[cut],
            emask[cut], **{**kw, "kp1": kw["kp1"][:, cut].contiguous(),
                           "kp2": kw["kp2"][:, cut].contiguous()})
        alone.append(db.decoder_chunk.phase_rounds)
        for x, y in zip((got.mel, got.gate, got.align),
                        (part.mel, part.gate, part.align)):
            assert torch.equal(x[:, cut], y)   # (cs, B, ...)
        for x, y in zip(got.carry, part.carry):
            assert torch.equal(x[cut], y)
    assert rounds == tuple(map(max, zip(*alone)))
    want = db.decoder_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_chunks_close(got, want, DEC_REL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("change,words", [
    (dict(attention_dim=256), "attention width"),
    (dict(attention_location_kernel_size=33), "location kernel size"),
    (dict(compute_dtype="float32"), "take bf16")])
def test_decoder_chunks_refuse_what_the_plan_refuses(cuda, change, words):
    """On the card, a config the kernels do not take (an attention width
    above 128 or 33 location taps, which the persistent plan refuses; fp32,
    which no kernel takes): both chunks raise ValueError with the reason,
    ``infer_fused`` raises, and ``BatchingSynthesizer`` refuses the config
    at construction (``StreamingSynthesizer`` too at fp32). No plain
    version runs on the card."""
    from tacotron2_tpu_torch.serve import BatchingSynthesizer
    from tacotron2_tpu_torch.streaming import StreamingSynthesizer
    cfg = CFG.replace(**{"compute_dtype": "bfloat16", **change})
    dt = cfg.torch_compute_dtype
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(0)).to(cuda)
    T = 20
    mem = torch.randn(1, T, 128, device=cuda)
    proc = torch.randn(1, T, cfg.attention_dim, device=cuda)
    kw = dict(t0=0, chunk_steps=2, gate_logit=0.0)
    carry = zero_carry(1, T, cfg.n_mel_channels, cuda)
    plain = (db.decoder_chunk_plain.calls, ds.decoder_step_chunk_plain.calls)
    with pytest.raises(ValueError, match=words):
        db.decoder_chunk(db.pack_batch_decoder_params(model, dt), carry,
                         *db.attention_inputs(mem, proc, None, dt), **kw)
    with pytest.raises(ValueError, match=words):
        ds.decoder_step_chunk(ds.pack_decoder_params(model, dt), carry,
                              *ds.attention_inputs(mem, proc, None), **kw)
    with pytest.raises(ValueError, match=words):
        tm.infer_fused(model, torch.ones(1, T, dtype=torch.long),
                       torch.tensor([T]), cfg, max_steps=2)
    with pytest.raises(ValueError, match=words):
        BatchingSynthesizer(model, cfg, max_batch=4, device=cuda)
    if dt == torch.float32:
        with pytest.raises(ValueError, match=words):
            StreamingSynthesizer(model, cfg, device=cuda)
    assert (db.decoder_chunk_plain.calls,
            ds.decoder_step_chunk_plain.calls) == plain


# ------------------------------------------------------ slice 6: rows 3, 6

# Row 3 against its plain version: each stack's largest |err| as a share of
# its largest |value| (chip_smoke.py's ENC_FWD_REL, the same table), and
# every element within chip_smoke.py's ENC_TOL (atol, rtol).
ENC_FWD_REL = dict(gf=5e-2, gb=5e-2, hf=6e-2, hb=5e-2, cf=2e-3, cb=2e-3)
ENC_TOL = (3e-2, 5e-2)
ENC_NAMES = ("gf", "gb", "hf", "hb", "cf", "cb")


def encoder_case(device, dtype, B, T, N=512, H=256):
    """Seeded weights and inputs of the encoder BiLSTM at (B, T, N, H)."""
    g = torch.Generator(device=device).manual_seed(B * 1000 + T)
    rand = lambda *s: (torch.rand(*s, generator=g, device=device) - 0.5)
    wf, wb = (to_blocks(rand(N + H, 4 * H).mul(0.1).to(dtype), 4)
              for _ in range(2))
    bf, bb = (rand(4 * H).mul(0.2) for _ in range(2))
    xs, xsr = (torch.relu(rand(B, T, N) * 2).to(dtype) for _ in range(2))
    return wf, bf, wb, bb, xs, xsr


def assert_encoder_close(got, want):
    errs = rel_errs(got, want, ENC_NAMES)
    for name in ENC_NAMES:
        assert errs[name] <= ENC_FWD_REL[name], errs
    for name, a, b in zip(ENC_NAMES, got, want):
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= ENC_TOL[0] + ENC_TOL[1] * b.float().abs())
                    .all()), (name, float(diff.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [32, 48, 128, 192])
@pytest.mark.parametrize("B", [1, 8, 13, 32, 128])
def test_encoder_cluster_kernel_matches_plain(cuda, B, T):
    """Row 3 at bf16 and full width (N=512, H=256): one launch of the
    cluster kernel (no per-step launch), the same bits in two runs, every
    stack within ENC_FWD_REL and ENC_TOL of the plain version."""
    args = encoder_case(cuda, torch.bfloat16, B, T)
    run = lambda: el.bilstm_forward(*args)
    names = kernel_names(run)
    assert sum("encoder_cluster_kernel" in n for n in names) == 1, names
    assert not any("encoder_step" in n for n in names), set(names)
    assert el.forward_plan(B, 512, 256, torch.bfloat16, cuda)[0] == "cluster"
    got, again = run(), run()
    for name, a, b in zip(ENC_NAMES, got, again):
        assert torch.equal(a, b), name
    want = el.bilstm_forward_plain(*args)
    torch.cuda.synchronize()
    assert_encoder_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,N,H", [(torch.float32, 512, 256),
                                       (torch.bfloat16, 256, 64),
                                       (torch.bfloat16, 200, 256)],
                         ids=["fp32", "H64", "N200"])
def test_encoder_off_range_shapes_take_the_per_step_kernel(cuda, dtype, N,
                                                            H):
    """fp32, and bf16 shapes the cluster kernel does not take (H not 128
    or 256, N not in 16s), launch encoder_step once a step and match the
    plain version as before."""
    B, T = 8, 12
    args = encoder_case(cuda, dtype, B, T, N=N, H=H)
    run = lambda: el.bilstm_forward(*args)
    names = kernel_names(run)
    assert sum("encoder_step" in n for n in names) == T, names
    assert not any("encoder_cluster_kernel" in n for n in names), names
    assert el.forward_plan(B, N, H, dtype, cuda)[0] == "per-step"
    got = run()
    want = el.bilstm_forward_plain(*args)
    torch.cuda.synchronize()
    tol = dict(DTYPES)[dtype]
    for name, a, b in zip(ENC_NAMES, got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0,
                                   msg=name)


def full_step_case(device, T, cs, keep, r=1, gate_logit=1e30):
    """A bf16 chunk of one row at the default config's full width
    (n_frames_per_step r), T encoder positions with the last 9 masked,
    from a zero carry: (args, kwargs)."""
    from tacotron2_tpu_torch.config import create_config
    cfg = create_config().replace(n_frames_per_step=r)
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(7)).to(device)
    fp = ds.pack_decoder_params(model, torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(T + cs + r)
    mem = torch.randn(1, T, cfg.encoder_embedding_dim, generator=g,
                      device=device) * 0.5
    proc = (torch.randn(1, T, cfg.attention_dim, generator=g, device=device)
            * 0.5).bfloat16().float()   # processed memory holds bf16 values
    mask = torch.arange(T, device=device)[None] < T - 9
    mem, proc, emask = ds.attention_inputs(mem, proc, mask)
    n, p = fp.pre1.shape
    z = lambda *s: torch.zeros(*s, device=device)
    i32 = lambda: torch.zeros(1, dtype=torch.int32, device=device)
    a, d, e = (cfg.attention_rnn_dim, cfg.decoder_rnn_dim,
               cfg.encoder_embedding_dim)
    carry = db.ChunkCarry(z(1, a), z(1, a), z(1, d), z(1, d), z(1, T),
                          z(1, T), z(1, e), z(1, n), i32(), i32())
    kp = (None, None)
    if keep:
        kp = tuple((torch.rand(cs, 1, p, generator=g, device=device) < 0.5
                    ).float() for _ in range(2))
    kw = dict(t0=2, chunk_steps=cs, gate_logit=gate_logit, kp1=kp[0],
              kp2=kp[1])
    return (fp, carry, mem, proc, emask), kw


def assert_one_persistent_chunk(run):
    names = kernel_names(run)
    assert sum("persistent_chunk_kernel" in n for n in names) == 1, names


@pytest.mark.gpu
@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("T", [64, 128, 192])
def test_decoder_step_persistent_full_width(cuda, T, keep):
    """Row 6 at bf16 and full width, a 64-step chunk: one persistent
    launch, every field within STEP_REL, finished and lengths exactly."""
    args, kw = full_step_case(cuda, T, 64, keep)
    run = lambda: ds.decoder_step_chunk(*args, **kw)
    assert_one_persistent_chunk(run)
    got = run()
    want = ds.decoder_step_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_chunks_close(got, want, STEP_REL[torch.bfloat16])


@pytest.mark.gpu
def test_decoder_step_persistent_two_frames_a_step(cuda):
    """Row 6 at full width with r=2 (160 projection columns a step) and
    keep masks: one persistent launch, every field within STEP_REL."""
    args, kw = full_step_case(cuda, 128, 32, True, r=2)
    run = lambda: ds.decoder_step_chunk(*args, **kw)
    assert_one_persistent_chunk(run)
    got = run()
    want = ds.decoder_step_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.mel.shape == (32, 1, 160)
    assert_chunks_close(got, want, STEP_REL[torch.bfloat16])


@pytest.mark.gpu
def test_decoder_step_persistent_latches_mid_chunk(cuda):
    """Row 6 at full width with a gate threshold the row first crosses in
    the middle of the chunk (the midpoint of the widest gap between the
    plain version's gate logits whose first crossing falls in steps 4 to
    11 of 16, with the gate column as packed or negated, whichever gives
    the wider gap): finished and lengths equal the plain version's, and
    every field (the state keeps stepping after the latch) within
    STEP_REL."""
    cs = 16
    args, kw = full_step_case(cuda, 128, cs, False)
    fp, n = args[0], args[0].pre1.shape[0]
    best = None
    for sign in (1.0, -1.0):   # the gate column as packed, and negated
        wpe, bpe = fp.wpe.clone(), fp.bpe.clone()
        wpe[:, n] *= sign
        bpe[n] *= sign
        trial = (fp._replace(wpe=wpe, bpe=bpe), *args[1:])
        free = ds.decoder_step_chunk_plain(*trial, **kw).gate.flatten()
        vals = free.sort().values
        for i in range(cs - 1):
            thr = float(vals[i] + vals[i + 1]) / 2
            first = int((free > thr).int().argmax())
            gap = float(vals[i + 1] - vals[i])
            if bool((free > thr).any()) and 4 <= first <= 11 and (
                    best is None or gap > best[0]):
                best = (gap, thr, trial)
    assert best is not None
    kw["gate_logit"] = best[1]
    args = best[2]
    got = ds.decoder_step_chunk(*args, **kw)
    want = ds.decoder_step_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert bool(want.carry.fin.all())
    assert int(want.carry.lens[0]) < kw["t0"] + cs
    assert_chunks_close(got, want, STEP_REL[torch.bfloat16])


# ------------------------------------------- row 7 at more rows, row 4 as one
# cluster launch, and the step-by-step decoder as captured chunks

@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(1792, 4096), (2560, 4096), (257, 40),
                                 (100, 83), (33, 7)])
@pytest.mark.parametrize("B", [1, 3, 8, 13, 19])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_int8_kernel_rows_and_ragged_edges(cuda, B, K, N, xdtype):
    """Row 7 against its plain version at 1 to 19 rows (one launch: rows
    past 8 are more n8 tiles of the same weights), the decoder cells'
    shapes and edges ragged in K and N, x in fp32 and bf16 read as they
    are, with the packed copy and an out= buffer: within INT8_REL, the same
    bits in two runs, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(B * 7 + K)
    x = torch.randn(B, K, generator=g, device=cuda).to(xdtype)
    w = torch.randn(K, N, generator=g, device=cuda) * 0.05
    w_q, scale = (t.to(cuda) for t in i8.quantize_int8(w))
    packed = i8.pack_int8(w_q)
    out = torch.full((B, N), float("nan"), device=cuda)
    launches = i8.int8_matmul.launches
    got = i8.int8_matmul(x, w_q, scale, packed=packed, out=out)
    again = i8.int8_matmul(x, w_q, scale, packed=packed)
    assert i8.int8_matmul.launches == launches + 2
    assert got.data_ptr() == out.data_ptr()
    names = kernel_names(lambda: i8.int8_matmul(x, w_q, scale,
                                                packed=packed))
    assert sum("int8_matmul_kernel" in n for n in names) == 1, names
    want = i8.int8_matmul_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale_ = float(want.abs().max())
    assert float((got - want).abs().max()) <= INT8_REL * scale_
    bad = got.clone()
    bad[:, N // 2] *= 1.05
    assert float((bad - want).abs().max()) > INT8_REL * scale_


@pytest.mark.gpu
def test_int8_kernel_rejects_a_wrong_pack_or_out(cuda):
    w_q, scale = (t.to(cuda) for t in i8.quantize_int8(torch.ones(64, 40)))
    x = torch.ones(2, 64, device=cuda)
    with pytest.raises(ValueError, match="pack_int8"):
        i8.int8_matmul(x, w_q, scale, packed=i8.pack_int8(w_q[:32]))
    with pytest.raises(ValueError, match="pack_int8"):
        i8.int8_matmul(x, w_q, scale)
    with pytest.raises(ValueError, match="out must be"):
        i8.int8_matmul(x, w_q, scale, packed=i8.pack_int8(w_q),
                       out=torch.empty(2, 41, device=cuda))


# Row 4, kernel against its plain version: each field's largest |err| as a
# share of its largest |value| (chip_smoke.py's ENC_BWD_REL, the same table).
ENC_BWD_FIELD_REL = dict(dgf=5e-2, dgb=3e-2, dxf=9e-3, dxb=2e-2)


def encoder_backward_case(device, B, T):
    """Row 4's inputs at full width, bf16: the forward kernel's stacks of
    seeded weights and inputs, and seeded cotangents of h."""
    wf, bf, wb, bb, xs, xsr = encoder_case(device, torch.bfloat16, B, T)
    gf, gb, _, _, cf, cb = el.bilstm_forward(wf, bf, wb, bb, xs, xsr)
    from tacotron2_tpu_torch.kernels.lstm_layout import from_blocks
    wtf, wtb = (from_blocks(w).t().contiguous() for w in (wf, wb))
    g = torch.Generator(device=device).manual_seed(B + T)
    dhf, dhb = (torch.randn(T, B, 256, generator=g, device=device) * 0.1
                for _ in range(2))
    return wtf, wtb, gf, gb, cf, cb, dhf, dhb


@pytest.mark.gpu
@pytest.mark.parametrize("T", [32, 48, 128, 192])
@pytest.mark.parametrize("B", [1, 8, 13, 32, 128])
def test_encoder_backward_cluster_kernel_matches_plain(cuda, B, T):
    """Row 4 at bf16 and full width (N=512, H=256): the chain as one launch
    of the cluster kernel (no per-step launch) and dx as one tensor-core
    product a direction; every field within ENC_BWD_FIELD_REL of the plain
    version; dg and dx the same bits in two runs."""
    args = encoder_backward_case(cuda, B, T)
    run = lambda: el.bilstm_backward(*args)
    names = kernel_names(run)
    assert sum("encoder_bwd_cluster_kernel" in n for n in names) == 1, names
    assert sum("tc_product_kernel" in n for n in names) == 2, names
    assert not any("lstm_gates_bwd_kernel" in n for n in names), set(names)
    assert el.backward_plan(B, 512, 256, torch.bfloat16, cuda)[0] == \
        "cluster"
    got, again = run(), run()
    names4 = ("dgf", "dgb", "dxf", "dxb")
    for name, a, b in zip(names4, got, again):
        assert torch.equal(a, b), name
    want = el.bilstm_backward_plain(*args)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, names4)
    for name in names4:
        assert errs[name] <= ENC_BWD_FIELD_REL[name], errs


@pytest.mark.gpu
def test_encoder_backward_fp32_takes_the_per_step_kernels(cuda):
    """fp32 at full width keeps two launches a step, and matches the plain
    version as before."""
    B, T = 8, 12
    wf, bf, wb, bb, xs, xsr = encoder_case(cuda, torch.float32, B, T)
    gf, gb, _, _, cf, cb = el.bilstm_forward_plain(wf, bf, wb, bb, xs, xsr)
    from tacotron2_tpu_torch.kernels.lstm_layout import from_blocks
    wtf, wtb = (from_blocks(w).t().contiguous() for w in (wf, wb))
    g = torch.Generator(device=cuda).manual_seed(4)
    dhf, dhb = (torch.randn(T, B, 256, generator=g, device=cuda) * 0.1
                for _ in range(2))
    args = (wtf, wtb, gf, gb, cf, cb, dhf, dhb)
    names = kernel_names(lambda: el.bilstm_backward(*args))
    assert sum("lstm_gates_bwd_kernel" in n for n in names) == T, names
    assert not any("encoder_bwd_cluster_kernel" in n for n in names)
    assert el.backward_plan(B, 512, 256, torch.float32, cuda)[0] == \
        "per-step"
    got = el.bilstm_backward(*args)
    want = el.bilstm_backward_plain(*args)
    torch.cuda.synchronize()
    errs = rel_errs(got, want, ("dgf", "dgb", "dxf", "dxb"))
    assert max(errs.values()) <= ENC_BWD_REL[torch.float32], errs


def decode_case(device, weights, B):
    """A narrow model (CFG) on the card, int8 or bf16 weights, B texts of
    ragged lengths: (model, text, lengths, compute dtype)."""
    model = tm.Tacotron2(CFG.replace(gate_threshold=0.99),
                         torch.Generator().manual_seed(3)).to(device)
    if weights == "int8":
        model = tm.quantize_for_serving(model)
    g = torch.Generator().manual_seed(B)
    text = torch.randint(1, 40, (B, 23), generator=g).to(device)
    lengths = torch.randint(10, 24, (B,), generator=g).int().to(device)
    lengths[0] = 23
    return model, text, lengths, torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("weights", ["int8", "bf16"])
@pytest.mark.parametrize("B", [1, 8])
def test_captured_decode_equals_the_eager_loop(cuda, B, weights, dropout):
    """``decode_autoregressive`` as CUDA graphs of 16-step chunks (and a
    9-step remainder: max_steps 41) against the same chunks run step by
    step: equal outputs.
    With a generator the prenet's dropout fires (the output differs from
    the deterministic one) and one seed gives the same output twice."""
    model, text, lengths, cd = decode_case(cuda, weights, B)
    cfg = model.cfg
    memory = tm.encode(model, text, lengths, cfg, compute_dtype=cd)

    def run(capture, seed=11, dropout=dropout):
        gen = (torch.Generator(device=cuda).manual_seed(seed) if dropout
               else None)
        return tm.decode_autoregressive(
            model, memory, lengths, cfg, max_steps=41, compute_dtype=cd,
            chunk_steps=16, generator=gen, capture=capture)

    got, again, want = run(True), run(True), run(False)
    for f, a, b, c in zip(("mel", "gate", "align", "lengths"), got, want,
                          again):
        assert torch.equal(a, b), f
        assert torch.equal(a, c), f
    if dropout:
        assert not torch.equal(got[0], run(True, dropout=False)[0])
        assert not torch.equal(got[0], run(True, seed=12)[0])


@pytest.mark.gpu
def test_captured_decode_chunk_resumes(cuda):
    """``decode_chunk`` replays its graph from a carry handed in: two
    chunks of 8 steps equal one eager run of 16, and the graphs do not
    launch the int8 kernel through its wrapper (the device counts it)."""
    model, text, lengths, cd = decode_case(cuda, "int8", 1)
    cfg = model.cfg
    memory = tm.encode(model, text, lengths, cfg, compute_dtype=cd)
    proc = tm.processed_memory_of(model, memory, cd)
    mask = torch.arange(memory.shape[1], device=cuda)[None] < lengths[:, None]
    c = tm.init_stream_carry(memory, cfg)
    outs = []
    for i in range(2):
        launches = i8.int8_matmul.launches
        c, out = tm.decode_chunk(model, c, memory, proc, mask, cfg,
                                 chunk_steps=8, compute_dtype=cd)
        outs.append(out)
    assert i8.int8_matmul.launches == launches   # a replay: no wrapper call
    e, want = tm.decode_chunk(model, tm.init_stream_carry(memory, cfg),
                              memory, proc, mask, cfg, chunk_steps=16,
                              compute_dtype=cd, capture=False)
    for i in range(3):
        assert torch.equal(torch.cat([o[i] for o in outs], dim=1), want[i])
    assert c.t == e.t == 16
    assert torch.equal(c.state.att_h, e.state.att_h)
    assert torch.equal(c.lengths, e.lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [False, True])
def test_captured_decode_from_two_threads(cuda, streams):
    """Two threads decode one model at one shape at the same time, so
    through the same graphs and buffers (each on a stream of its own, or
    both on the default stream): every result equals the eager loop's."""
    from concurrent.futures import ThreadPoolExecutor
    model, text, lengths, cd = decode_case(cuda, "int8", 1)
    cfg = model.cfg
    memory = tm.encode(model, text, lengths, cfg, compute_dtype=cd)

    def run(capture=True):
        return tm.decode_autoregressive(
            model, memory, lengths, cfg, max_steps=41, compute_dtype=cd,
            chunk_steps=16, capture=capture)

    want = run(capture=False)
    run()   # the graphs captured before the threads start
    torch.cuda.synchronize()

    def worker(_):
        stream = torch.cuda.Stream() if streams else None
        with torch.cuda.stream(stream):
            outs = [run() for _ in range(6)]
        torch.cuda.synchronize()
        return outs

    with ThreadPoolExecutor(2) as pool:
        results = [o for outs in pool.map(worker, range(2)) for o in outs]
    for got in results:
        for f, a, b in zip(("mel", "gate", "align", "lengths"), got, want):
            assert torch.equal(a, b), f


@pytest.mark.gpu
def test_quantized_serving_captures_in_its_worker(cuda):
    """``BatchingSynthesizer`` on int8 weights decodes on its worker thread
    through graphs captured there: the result equals the worker's padded
    batch decoded step by step on this thread."""
    from tacotron2_tpu_torch.data.bucketing import text_bucket
    from tacotron2_tpu_torch.serve import BatchingSynthesizer
    from tacotron2_tpu_torch.text import text_to_sequence
    cfg = CFG.replace(n_symbols=148, gate_threshold=0.99,
                      prenet_dropout_at_inference=False)
    model = tm.quantize_for_serving(
        tm.Tacotron2(cfg, torch.Generator().manual_seed(3)))
    synth = BatchingSynthesizer(model.state_dict(), cfg, max_batch=2,
                                max_steps=20, device=cuda)
    try:
        mel, _, n = synth.submit("abc").result(timeout=600)
    finally:
        synth.close()
    ids = text_to_sequence("abc", cfg.text_cleaners)
    text = torch.zeros(2, text_bucket(len(ids), cfg.text_buckets),
                       dtype=torch.long, device=cuda)
    text[0, :len(ids)] = torch.tensor(ids)
    lengths = torch.tensor([len(ids), 1], dtype=torch.int32, device=cuda)
    qm = synth.model
    memory = tm.encode(qm, text, lengths, cfg)
    out = tm.decode_autoregressive(qm, memory, lengths, cfg, max_steps=20,
                                   capture=False)
    want = tm._finish(qm, *out, cfg, None)
    assert n == int(want.mel_lengths[0])
    assert torch.equal(torch.from_numpy(mel), want.mel_postnet[0, :n].cpu())


# Rows 1 and 2 at the quality gate's shapes (B=32, T_in 32 and 48, and 40
# between them; 128 decoder steps), full width, bf16 with dropout: T_in 40
# and 48 are no multiple of the 32-position attention tiles, so the
# backward's attn_tiles_kernel and the forward's energy grid take a ragged
# last tile. Each field within its own share of its largest |value|, the
# tables of chip_smoke.py (SCAN_FWD_REL, SCAN_BWD_REL; change both together).
SCAN_FWD_REL = dict(ga=5e-2, gd=5e-2, att_h=6e-2, dec_h=5e-2, att_c=7e-3,
                    dec_c=2e-2, ctx=5e-2, w=5e-2)
SCAN_BWD_REL = dict(dga=7e-2, dgd=4e-2, d_prenet=3e-2, d_ctx=5e-2, d_q=5e-2,
                    d_processed=1e-2, d_k2=2e-2, d_v=7e-3)
FULL = Tacotron2Config()


@pytest.mark.gpu
@pytest.mark.parametrize("T_in", [32, 40, 48])
def test_scan_kernels_at_the_gate_shapes_match_plain(cuda, T_in):
    sw, pre, mem, proc, emask, kw = scan_case(cuda, torch.bfloat16, 32, T_in,
                                              128, True, seed=T_in, cfg=FULL)
    got = ts.forward_residuals(sw, pre, mem, proc, emask, **kw)
    res = ts.forward_residuals_plain(sw, pre, mem, proc, emask, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(got, res, ts.Residuals._fields)
    assert all(errs[k] <= SCAN_FWD_REL[k] for k in errs), errs
    g = torch.Generator(device=cuda).manual_seed(T_in)
    cot = lambda x: torch.randn(x.shape, generator=g, device=cuda) * 0.01
    cots = (cot(res.dec_h), cot(res.ctx), cot(res.w) * (emask == 0))
    gk = ts.backward_chain(sw, res, mem, proc, *cots, **kw)
    gp = ts.backward_chain_plain(sw, res, mem, proc, *cots, **kw)
    again = ts.backward_chain(sw, res, mem, proc, *cots, **kw)
    torch.cuda.synchronize()
    errs = rel_errs(gk, gp, ts.ChainGrads._fields)
    assert all(errs[k] <= SCAN_BWD_REL[k] for k in errs), errs
    for name in ts.ChainGrads._fields:
        assert torch.equal(getattr(gk, name), getattr(again, name)), name


@pytest.mark.gpu
def test_prefetch_copies_to_the_card_one_batch_ahead(cuda):
    """20 batches through ``prefetch`` with a ``DeviceTransfer`` whose copy
    stream is held back by a sleep before every copy: each batch, read on
    the consumer's stream right after it is received, equals its CPU
    source (the consumer waited for its copy, and no pinned buffer was
    refilled before its copy ran)."""
    from tacotron2_tpu_torch.data.pipeline import DeviceTransfer, prefetch
    from tacotron2_tpu_torch.training.state import Batch
    g = torch.Generator().manual_seed(0)
    batches = [Batch(torch.randint(0, 148, (32, 48), generator=g),
                     torch.randint(1, 48, (32,), generator=g),
                     torch.randn(32, 256, 80, generator=g),
                     torch.rand(32, 256, generator=g),
                     torch.randint(1, 256, (32,), generator=g),
                     torch.ones(32)) for _ in range(20)]
    transfer = DeviceTransfer(cuda)
    send = transfer.send

    def slow_send(batch):
        with torch.cuda.stream(transfer.stream):
            torch.cuda._sleep(2_000_000)  # ~1 ms of the copy stream
        return send(batch)
    transfer.send = slow_send
    read = [tuple(t.clone() for t in b)
            for b in prefetch(iter(batches), depth=2, transfer=transfer)]
    torch.cuda.synchronize()
    assert len(read) == 20
    for got, want in zip(read, batches):
        for a, b in zip(got, want):
            assert a.is_cuda and torch.equal(a.cpu(), b)


# LSTM widths that are not whole blocks of 8 units (attention_rnn_dim=20,
# decoder_rnn_dim=24, the JAX package's trainer-test widths): the kernels
# run on weights padded with zero units (lstm_layout.pad_core_weights).
ODD = CFG.replace(attention_rnn_dim=20, decoder_rnn_dim=24)
ODD_GRAD_REL = 1e-4
DECODER_CORE = ("decoder.attention_rnn.", "decoder.decoder_rnn.",
                "decoder.attention_layer.")


@pytest.mark.gpu
def test_train_step_at_lstm_widths_not_in_eights(cuda):
    """One fp32 training forward and backward with the LSTM dropout on
    given keep masks at A=20, D=24 on the card: rows 1 and 2 launch and
    their plain versions do not run; the loss and every decoder-core
    gradient within ODD_GRAD_REL of its largest value of the same step on
    the CPU (PyTorch's own convolutions on the card, as chip_smoke.py's
    fp32 step check)."""
    from tacotron2_tpu_torch.training import state as tstate
    from tacotron2_tpu_torch.training.loss import tacotron2_loss
    B, T_in, T_out = 8, 24, 16
    out = {}
    for dev in ("cpu", cuda):
        model = tm.Tacotron2(ODD, torch.Generator().manual_seed(0),
                             trainable=True).to(dev)
        batch = tstate.make_batch(ODD, B, T_in, T_out, seed=0, device=dev)
        keep = ts.keep_masks(torch.Generator().manual_seed(1), T_out, B, 20,
                             24, 0.1, 0.1)
        keep = tuple(k.to(dev) for k in keep)
        launches = (ts.forward_residuals.launches,
                    ts.backward_chain.launches)
        plain = (ts.forward_residuals_plain.calls,
                 ts.backward_chain_plain.calls)
        params = dict(model.named_parameters())
        with torch.backends.cudnn.flags(enabled=False):
            fwd, _ = tm.forward(model, tm.bn_stats(model), batch.text,
                                batch.text_lengths, batch.mel,
                                batch.mel_lengths, ODD, training=True,
                                keep=keep)
            loss = tacotron2_loss(fwd, batch.mel, batch.gate_target).total
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (ts.forward_residuals.launches,
                    ts.backward_chain.launches) == (launches[0] + 1,
                                                    launches[1] + 1)
            assert (ts.forward_residuals_plain.calls,
                    ts.backward_chain_plain.calls) == plain
        out[str(dev)] = (loss.detach(), grads)
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(float(lg) - float(lc)) <= ODD_GRAD_REL * abs(float(lc))
    names = [k for k in gc if k.startswith(DECODER_CORE)]
    errs = rel_errs([gg[k].cpu() for k in names], [gc[k] for k in names],
                    names)
    assert all(e <= ODD_GRAD_REL for e in errs.values()), errs


@pytest.mark.gpu
def test_serving_chunks_at_lstm_widths_not_in_eights(cuda):
    """Rows 5 (B=8) and 6 (B=1) at A=20, D=24 through the chunk loop's
    ``_decode_chunk`` (the pack padded to 24 and 24 units, the carry padded
    and sliced back; the attention LSTM's input depth, 128 + 128 + 24 =
    280, padded with zero rows to 288 in the fragment-order copy): one
    launch each, every output and carry field within DEC_REL / STEP_REL of
    the same chunk through the plain versions on the same padded pack."""
    cfg = ODD.replace(gate_threshold=0.3)
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(0)).to(cuda)
    bf16 = torch.bfloat16
    fused_inputs = lambda fp, *a: ds.attention_inputs(*a)
    batch_inputs = lambda fp, *a: db.attention_inputs(*a, fp.w1.dtype)
    for B, pack, inputs, chunk, plain, table in (
            (8, db.pack_batch_decoder_params, batch_inputs,
             db.decoder_chunk, db.decoder_chunk_plain, DEC_REL),
            (1, ds.pack_decoder_params, fused_inputs,
             ds.decoder_step_chunk, ds.decoder_step_chunk_plain, STEP_REL)):
        fp = pack(model, bf16)
        assert fp.w1.shape[0] * 8 == 24 and fp.w2.shape[0] * 8 == 24
        assert fp.w1f.shape[1] * 16 == 288
        g = torch.Generator(device=cuda).manual_seed(B)
        T = 37
        memory = torch.randn(B, T, 128, generator=g, device=cuda) * 0.5
        proc = torch.randn(B, T, 128, generator=g, device=cuda) * 0.5
        mask = torch.ones(B, T, dtype=torch.bool, device=cuda)
        carry0 = tm.init_stream_carry(memory, cfg)
        outs = {}
        for name, fn in (("kernel", chunk), ("plain", plain)):
            calls = (chunk.launches, plain.calls)
            carry, (mel, gate, align) = db._decode_chunk(
                fp, carry0, inputs(fp, memory, proc, mask), cfg, 16, None,
                fn)
            torch.cuda.synchronize()
            assert (chunk.launches - calls[0], plain.calls - calls[1]) == (
                (1, 0) if name == "kernel" else (0, 1)), name
            s = carry.state
            assert s.att_h.shape == (B, 20) and s.dec_h.shape == (B, 24)
            outs[name] = (mel, gate, align, s.att_h, s.att_c, s.dec_h,
                          s.dec_c, s.att_weights, s.att_weights_cum,
                          s.att_context, carry.prev_mel)
        errs = rel_errs(outs["kernel"], outs["plain"],
                        ("mel", "gate", "align") + CARRY)
        limits = table[bf16]
        assert all(errs[k] <= limits[k] for k in errs), (B, errs)


# WaveGlow (plain torch: cuDNN convolutions, cuBLAS products) on the card
# against the CPU, fp32 with TF32 off (the fixture): z, log s and log det
# of ``forward``, the audio of ``infer`` with that z, each within
# WAVEGLOW_REL of its largest value (fp32 sums in other orders through six
# exp(log s) couplings).
WAVEGLOW_REL = 1e-4


@pytest.mark.gpu
def test_waveglow_on_the_card_matches_the_cpu(cuda):
    from tacotron2_tpu_torch.models import waveglow as wg
    cfg = wg.WaveGlowConfig(n_flows=6, n_early_every=2, wn_layers=4,
                            wn_channels=64)
    model = wg.WaveGlow(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # live couplings, and log |det W| away from 0
        for w in model.WN:
            w.end.weight.normal_(0, 0.02, generator=g)
        for inv in model.convinv:
            w = inv.conv.weight
            w.mul_(torch.empty(w.shape[0], 1, 1).uniform_(0.8, 1.25,
                                                          generator=g))
    g = torch.Generator().manual_seed(2)
    mel = torch.randn(2, 16, 80, generator=g)
    audio = torch.randn(2, 16 * 256, generator=g) * 0.3
    got = {}
    for dev in ("cpu", cuda):
        model = model.to(dev)
        with torch.no_grad():
            out = wg.forward(model, audio.to(dev), mel.to(dev), cfg)
        back = wg.infer(model, mel.to(dev), cfg, z=out.z)
        got[str(dev)] = [t.cpu() for t in (*out, back)]
    errs = rel_errs(got["cuda"], got["cpu"], ("z", "log_s", "log_det",
                                              "audio"))
    assert all(e <= WAVEGLOW_REL for e in errs.values()), errs
    assert float((got["cuda"][3] - audio).abs().max()) <= (
        WAVEGLOW_REL * float(audio.abs().max()))


# ------------------------------------- the chunk loop's one-chunk look-ahead

def sequential_decode(fp, inputs, memory, cfg, max_steps, chunk,
                      generator):
    """The chunk loop that reads each chunk's latch (a read that drains the
    stream) before it launches the next: the reference for the loop that
    reads it one chunk behind."""
    B, t_in, _ = memory.shape
    dev = memory.device
    carry = tm.init_stream_carry(memory, cfg)
    outs = []
    while carry.t < max_steps:
        if bool(carry.finished.all()):
            break
        cs = min(64, max_steps - carry.t)
        keep = None
        if generator is not None:
            keep = tuple(torch.rand((cs, B, cfg.prenet_dim),
                                    generator=generator, device=dev) < 0.5
                         for _ in range(2))
        carry, out = db._decode_chunk(fp, carry, inputs, cfg, cs, keep,
                                      chunk)
        outs.append(out)
    mel = torch.zeros(B, max_steps, cfg.n_mel_channels, device=dev)
    gate = torch.full((B, max_steps), db.GATE_MASK, device=dev)
    align = torch.zeros(B, max_steps, t_in, device=dev)
    for x, i in ((mel, 0), (gate, 1), (align, 2)):
        x[:, :carry.t] = torch.cat([o[i] for o in outs], dim=1)
    return mel, gate, align, carry.lengths


def mid_decode_stop(gate, cs=64):
    """(step, gate threshold, sign) at which every row has latched by that
    step and some row had not one step before, on the gate times sign: the
    middle one of the steps after the first chunk and before the last at
    which the lowest of the rows' running gate maxima rises, by more than
    the threshold's round trip through the sigmoid can move it, on the
    sign with the more such steps (a seeded gate drifts up or down)."""
    best = []
    for sign in (1, -1):
        low = (sign * gate.float()).cummax(dim=1).values.min(dim=0).values
        low = low.cpu()
        rises = [t for t in range(cs, low.shape[0] - cs)
                 if low[t] - low[t - 1] > 1e-6]
        if len(rises) > len(best):
            best = rises
            t = rises[len(rises) // 2]
            logit = (float(low[t - 1]) + float(low[t])) / 2
            found = t, 1 / (1 + math.exp(-logit)), sign
    assert best, "the lowest running maximum never rises mid-decode"
    return found


def decode_trace(run, tmp_path):
    """run() under torch.profiler (host and card): the CUDA runtime calls
    as (start us, name, correlation), by start, the correlations of the
    ``persistent_chunk_kernel`` launches, and the names of the device's
    copies. A session that records no chunk kernel is taken again, up to
    three times (as ``kernel_names``)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        path = tmp_path / f"decode{i}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        corr = lambda e: e.get("args", {}).get("correlation")
        chunks = {corr(e) for e in events if e.get("cat") == "kernel"
                  and "persistent_chunk_kernel" in e["name"]}
        if chunks:
            break
    calls = sorted((e["ts"], e["name"], corr(e)) for e in events
                   if e.get("cat") == "cuda_runtime")
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"]
    return out, calls, chunks, copies


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("stop", [False, True], ids=["never", "mid"])
@pytest.mark.parametrize("B", [32, 1])
def test_look_ahead_decode_equals_sequential(cuda, B, stop, dropout,
                                             tmp_path):
    """Rows 5 (B=32 through ``decode_autoregressive_batch``) and 6 (B=1
    through ``decode_autoregressive_fused``) at full width, T_in 128, 1000
    steps: the loop that launches chunk k+1 before reading chunk k's latch
    gives the chunk-by-chunk loop's bits, with a gate that never fires and
    with one at which every row has latched mid-decode (the chunk past the
    stop dropped, one discard), and leaves a generator as that loop does.
    On the host, chunk k's latch is read (``cudaEventSynchronize``) after
    chunk k+1's launch and before chunk k+2's, nothing drains the stream
    between the first launch and the last, and no copy goes to pageable
    memory."""
    from tacotron2_tpu_torch.config import create_config
    cfg = create_config().replace(gate_threshold=1.0)
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(11)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(B)
    T, steps = 128, 1000
    memory = torch.randn(B, T, cfg.encoder_embedding_dim, generator=g,
                         device=cuda) * 0.5
    proc = (torch.randn(B, T, cfg.attention_dim, generator=g, device=cuda)
            * 0.5).bfloat16().float()
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device=cuda)
    lengths[0] = T
    mask = torch.arange(T, device=cuda)[None] < lengths[:, None]
    if B == 1:
        pack = lambda: ds.pack_decoder_params(model, torch.bfloat16)
        inputs = ds.attention_inputs(memory, proc, mask)
        chunk, decode = ds.decoder_step_chunk, ds.decode_autoregressive_fused
    else:
        pack = lambda: db.pack_batch_decoder_params(model, torch.bfloat16)
        inputs = db.attention_inputs(memory, proc, mask, torch.bfloat16)
        chunk, decode = db.decoder_chunk, db.decode_autoregressive_batch
    rng = lambda: (torch.Generator(device=cuda).manual_seed(7) if dropout
                   else None)
    fp = pack()
    if stop:
        free = sequential_decode(fp, inputs, memory, cfg, steps, chunk,
                                 rng())[1]
        t_stop, thr, sign = mid_decode_stop(free)
        cfg = cfg.replace(gate_threshold=thr)
        if sign < 0:   # the gate's column negated: every gate logit negated
            layer = model.decoder.gate_layer.linear_layer
            with torch.no_grad():
                layer.weight.neg_()
                layer.bias.neg_()
            fp = pack()
    g_seq = rng()
    want = sequential_decode(fp, inputs, memory, cfg, steps, chunk, g_seq)

    def run():
        gen, discarded = rng(), db._autoregressive.discarded
        out = decode(fp, memory, proc, mask, cfg, max_steps=steps,
                     generator=gen)
        return out, gen, db._autoregressive.discarded - discarded

    (got, g_ahead, discards), calls, chunks, copies = decode_trace(
        run, tmp_path)
    for x, y, name in zip(got, want, ("mel", "gate", "align", "lengths")):
        assert torch.equal(x, y), name
    assert discards == int(stop)
    if stop:
        assert int(got[3].max()) == t_stop + 1
    if dropout:
        assert torch.equal(g_ahead.get_state(), g_seq.get_state())
    launches = [ts for ts, _, c in calls if c in chunks]
    reads = [ts for ts, name, _ in calls if name == "cudaEventSynchronize"]
    n = t_stop // 64 + 2 if stop else -(-steps // 64)
    assert len(launches) == n and len(reads) == n - 1, (len(launches),
                                                        len(reads))
    for k, read in enumerate(reads):
        assert launches[k + 1] < read, k
        assert k + 2 == n or read < launches[k + 2], k
    drains = [name for ts, name, _ in calls
              if launches[0] <= ts <= launches[-1]
              and ("StreamSynchronize" in name or "DeviceSynchronize" in name
                   or name == "cudaMemcpy")]
    assert not drains, drains
    assert not [c for c in copies if "Pageable" in c], copies


# ------------------------------------------------ serving at the row tile

TILES = (8, 16, 24, 32)   # the rows a served batch is decoded at
# Rows decoded at another tile with cuDNN's convolutions in, as served: the
# encoder's output and the postnet's residual for the same rows, as a
# root-mean-square gap over the real rows, as a share of the tile-32 one.
# cuDNN picks a convolution's algorithm by its shape, and another algorithm
# sums in another order and rounds some bf16 outputs the other way (with
# cuDNN off the rows are the same bits at every tile). About three times
# the worst reading on the card, five texts at seeds 5 and 6: the encoder
# 6.9e-4 (tile 24 only; its three convolutions 1.1e-5, carried through the
# BiLSTM), the postnet 1.2e-3 (at some tiles and frame counts, none at
# others).
TILE_RMS = dict(memory=2e-3, postnet=4e-3)
SERVED_TEXTS = ["Hello world.", "It is 9 a.m. and the sun is up.",
                "Printing, in the only sense with which we are concerned.",
                "Dogs bark.", "A longer sentence, with a comma or two, "
                "goes here to fill its bucket."]


def rms_gap(x, y):
    x, y = x.float(), y.float()
    return float((x - y).square().sum().sqrt() / y.square().sum().sqrt())


@pytest.mark.gpu
def test_served_rows_decode_alike_at_every_tile(cuda):
    """The same five texts (bucket 128) through ``infer_batch_fused`` at
    full width, 400 steps, padded to each row tile a batch of them can be
    decoded at (8, 16, 24, 32). With cuDNN off, each text's ``mel``,
    ``mel_postnet``, gates, alignments and ``mel_lengths`` are the same bits
    at every tile: nothing the port computes mixes rows or sums a row
    otherwise at another row count. With cuDNN on, as served, the lengths
    are the same, and the encoder's output and the postnet's residual for
    the same rows within ``TILE_RMS`` of those at 32 rows."""
    from tacotron2_tpu_torch.config import create_config
    from tacotron2_tpu_torch.text import text_to_sequence
    cfg = create_config().replace(prenet_dropout_at_inference=False)
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(5)).to(cuda)
    packed = db.pack_batch_decoder_params(model, torch.bfloat16)
    packed_lstm = tm.pack_encoder_lstm(model, torch.bfloat16)
    ids = [text_to_sequence(t, cfg.text_cleaners) for t in SERVED_TEXTS]
    n = len(ids)
    text = torch.zeros(32, 128, dtype=torch.int32)
    lengths = torch.ones(32, dtype=torch.int32)
    for b, i in enumerate(ids):
        text[b, :len(i)] = torch.tensor(i)
        lengths[b] = len(i)

    def decode(rows):
        return tm.infer_batch_fused(
            model, text[:rows], lengths[:rows], cfg, packed=packed,
            packed_lstm=packed_lstm, max_steps=400, device=cuda)

    with torch.backends.cudnn.flags(enabled=False):
        plain_conv = {rows: decode(rows) for rows in TILES}
    served = {rows: decode(rows) for rows in TILES}
    t, lens = text.to(cuda), lengths.to(cuda)
    with torch.no_grad():
        memory = {rows: tm.encode(model, t[:rows], lens[:rows], cfg,
                                  compute_dtype=torch.bfloat16,
                                  packed_lstm=packed_lstm) for rows in TILES}
        mel = served[32].mel
        postnet = {rows: tm.postnet_apply(model, mel[:rows], cfg,
                                          compute_dtype=torch.bfloat16)
                   for rows in TILES}
    for rows in TILES[:-1]:
        for name, x, y in zip(tm.InferenceResult._fields, plain_conv[rows],
                              plain_conv[32]):
            assert torch.equal(x[:n], y[:n]), (rows, name)
        assert torch.equal(served[rows].mel_lengths[:n],
                           served[32].mel_lengths[:n]), rows
        for name, got in (("memory", memory), ("postnet", postnet)):
            gap = rms_gap(got[rows][:n], got[32][:n])
            assert gap <= TILE_RMS[name], (rows, name, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["encoder", "decoder"])
def test_kernel_rows_do_not_depend_on_the_tile(cuda, kernel):
    """Rows 3 and 5 at full width (bf16, T_in 128; row 5 a 64-step chunk
    with keep masks): five rows of fixed inputs, padded with rows of noise
    to 8, 16, 24 and 32 rows, give the same bits in those five rows at
    every tile. So neither kernel's plan by B (row 3's 16- or 32-row
    cluster groups, row 5's n8 tiles and row groups) changes how a row is
    summed, and no padding row reaches a real one."""
    n = len(SERVED_TEXTS)
    g = torch.Generator(device=cuda).manual_seed(11)
    noise = lambda x: torch.randn(x.shape, generator=g,
                                  device=cuda).to(x.dtype)
    outs = {}
    if kernel == "encoder":
        wf, bf, wb, bb, xs, xsr = encoder_case(cuda, torch.bfloat16, 32, 128)
        for rows in TILES:
            x, xr = xs[:rows].clone(), xsr[:rows].clone()
            x[n:], xr[n:] = noise(x[n:]), noise(xr[n:])
            outs[rows] = [y[:, :n] for y in el.bilstm_forward(
                wf, bf, wb, bb, x, xr)]     # (T, B, ...)
    else:
        (fp, carry, mem, proc, emask), kw = served_case(cuda, 32, 128, 64,
                                                        True)
        for rows in TILES:
            m, p = mem[:rows].clone(), proc[:rows].clone()
            m[n:], p[n:] = noise(m[n:]), noise(p[n:])
            got = db.decoder_chunk(
                fp, db.ChunkCarry(*(x[:rows] for x in carry)), m, p,
                emask[:rows], **{**kw, "kp1": kw["kp1"][:, :rows].contiguous(),
                                 "kp2": kw["kp2"][:, :rows].contiguous()})
            outs[rows] = ([y[:, :n] for y in (got.mel, got.gate, got.align)]
                          + [y[:n] for y in got.carry])
    for rows in TILES[:-1]:
        for i, (x, y) in enumerate(zip(outs[rows], outs[32])):
            assert torch.equal(x, y), (rows, i)


@pytest.mark.gpu
@pytest.mark.parametrize("max_batch,tiles", [(32, [8, 16, 24, 32]),
                                             (6, [6])])
def test_synthesizer_warms_every_shape_before_its_first_request(
        cuda, max_batch, tiles):
    """On the card the constructor returns once the worker has decoded
    every (rows, text bucket) shape a batch can take, the row tiles up to
    ``max_batch`` by the buckets, in order; requests then decode at those
    shapes (a batch of two at the first tile)."""
    from tacotron2_tpu_torch.serve import BatchingSynthesizer
    cfg = CFG.replace(n_symbols=148, compute_dtype="bfloat16",
                      text_buckets=(32, 64))
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(2))
    synth = BatchingSynthesizer(model, cfg, max_batch=max_batch,
                                max_wait_ms=200, max_steps=20, device=cuda)
    try:
        assert synth.tiles == tiles
        assert synth.warmed == [(r, t) for r in tiles for t in (32, 64)]
        shapes = []
        infer = synth._infer

        def recorded(text, lengths):
            shapes.append(text.shape)
            return infer(text, lengths)

        synth._infer = recorded
        (mel, _, frames), _ = synth.synthesize(SERVED_TEXTS[:2])
    finally:
        synth.close()
    assert shapes == [(tiles[0], 64)]
    assert 0 < frames <= 20 and mel.shape == (frames, cfg.n_mel_channels)
