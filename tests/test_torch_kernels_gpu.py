"""The port's hand-written CUDA kernels against their plain versions, on the
card (marker ``gpu``; each test skips without a CUDA device).

This file imports nothing of JAX, so it runs where only the port is
installed: ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``. The
plain versions are held against the JAX package on the CPU by
tests/test_torch_encoder_lstm.py and tests/test_torch_decoder_batch.py.

Tolerances. Decoder chunk: each output and carry field within its own
share of its largest |value| (DEC_REL), about ten times the worst reading
of that field on the card, so that attention weights of ~1/T are held as
tightly as mel values; the kernel and its plain version share every cast
point and differ only in the order of fp32 sums. Encoder: fp32 1e-4 absolute; bf16 3e-2
absolute (one bf16 rounding flip of an operand, 2^-8 relative, carried
through a few steps of the recurrence). TF32 is off for the plain versions'
products.
"""

import pytest
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import encoder_lstm as el
from tacotron2_tpu_torch.kernels.lstm_layout import to_blocks
from tacotron2_tpu_torch.models import tacotron2 as tm

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
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,r,dropout", [(4, 1, False), (21, 2, True)])
def test_decoder_kernel_matches_plain(cuda, dtype, tol, B, r, dropout):
    """Every output and carry field; finished and lengths exactly. The
    same check rejects the kernel's output with its attention perturbed."""
    args, kw = chunk_case(cuda, dtype, B, r, dropout)
    got = db.decoder_chunk(*args, **kw)
    want = db.decoder_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_chunks_close(got, want, DEC_REL[dtype])
    for bad in perturbed(got):
        with pytest.raises(AssertionError):
            assert_chunks_close(bad, want, DEC_REL[dtype])


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
    """A CUDA tensor never falls back to the plain version: inputs the
    kernel does not take raise."""
    model = tm.Tacotron2(CFG).to(cuda)
    fp = db.pack_batch_decoder_params(model, torch.float32)
    x = torch.zeros(2, 8, 128, device=cuda)
    mem, proc, emask = db.attention_inputs(x, x, None, torch.bfloat16)
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
