"""The port's int8 weight-only path (kernels/int8_matmul, the quantized LSTM
cell, quantize_for_serving) against the JAX package's (the Pallas kernel in
interpret mode). Inputs come from numpy seeds and go to both; both sides
compute from the same ``w_q``.

Tolerances: the product at rtol/atol 1e-5, the JAX package's own for this
kernel (tests/test_kernels.py): bf16 x int8 products are exact in fp32 and
only the order of the fp32 sums differs. The quantized cell at 1e-5, a
quantized model's ``infer`` at 1e-4 over 12 steps (the plain decode's
tolerance elsewhere in these tests).
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.kernels import int8_matmul as jint8
from tacotron2_tpu.kernels import quantize_int8 as jquantize
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.ops import lstm as jlstm

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.ops import lstm
from tacotron2_tpu_torch.serve import BatchingSynthesizer
from tacotron2_tpu_torch.training import state as tstate

# the package exports a function ``int8_matmul`` that hides the module
i8 = importlib.import_module("tacotron2_tpu_torch.kernels.int8_matmul")

DIMS = dict(
    n_symbols=148, symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=1, attention_rnn_dim=40, decoder_rnn_dim=48,
    prenet_dim=16, attention_dim=24, attention_location_n_filters=4,
    attention_location_kernel_size=7, n_mel_channels=12,
    max_decoder_steps=12, postnet_embedding_dim=16,
    postnet_n_convolutions=2, compute_dtype="float32", gate_threshold=0.99)


def weights(seed, K, N):
    rng = np.random.RandomState(seed)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    w[:, N // 2] = 0.0            # an all-zero channel: scale 1, not 0
    w[0, 0] = 0.5 * np.abs(w[:, 0]).max() / 127  # a tie at .5: half to even
    return rng, w


@pytest.mark.parametrize("K,N", [(256, 512), (100, 83), (7, 5)])
def test_quantize_int8_bit_equal(K, N):
    _, w = weights(0, K, N)
    jq, js = jquantize(w)
    tq, ts = i8.quantize_int8(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i8.quantize_int8(w)[0].numpy(), tq.numpy())


# the shapes of tests/test_kernels.py (the last is its padding path), then
# B = 1 at an odd depth, and more than 8 rows
@pytest.mark.parametrize("B,K,N", [(1, 256, 512), (8, 1792, 4096),
                                   (3, 100, 83), (1, 33, 7), (11, 64, 40)])
def test_plain_version_matches_pallas_kernel(B, K, N):
    rng, w = weights(1, K, N)
    x = rng.randn(B, K).astype(np.float32)
    w_q, scale = jquantize(w)
    want = np.asarray(jint8(jnp.asarray(x), w_q, scale, interpret=True))
    calls = i8.int8_matmul_plain.calls
    got = i8.int8_matmul(torch.from_numpy(x),
                         torch.from_numpy(np.array(w_q)),
                         torch.from_numpy(np.array(scale)))
    assert i8.int8_matmul_plain.calls == calls + 1
    assert got.shape == (B, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_x_is_rounded_to_bf16_inside_whatever_its_type():
    rng, w = weights(2, 64, 32)
    x = torch.from_numpy(rng.randn(2, 64).astype(np.float32))
    w_q, scale = i8.quantize_int8(w)
    a = i8.int8_matmul(x, w_q, scale)
    b = i8.int8_matmul(x.to(torch.bfloat16), w_q, scale)
    assert torch.equal(a, b)
    exact = (x @ w_q.float()) * scale
    assert not torch.equal(a, exact)


def test_input_checks():
    w_q, scale = i8.quantize_int8(np.ones((4, 6), np.float32))
    x = torch.ones(2, 4)
    with pytest.raises(ValueError, match="does not multiply"):
        i8.int8_matmul(torch.ones(2, 5), w_q, scale)
    with pytest.raises(TypeError):
        i8.int8_matmul(x, w_q.float(), scale)
    with pytest.raises(TypeError):
        i8.int8_matmul(x, w_q, scale[:3])
    with pytest.raises(TypeError):
        i8.int8_matmul(x.int(), w_q, scale)


def _cell_params(seed, n_in, H):
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    return rng, {"wi": u(n_in, 4 * H), "wh": u(H, 4 * H), "bi": u(4 * H),
                 "bh": u(4 * H)}


def test_quantized_cell_matches_jax():
    rng, p = _cell_params(3, 20, 12)
    jq = jlstm.quantize_lstm_params({k: jnp.asarray(v) for k, v in p.items()})
    tw = lstm.LSTMWeights(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (p["wi"].T, p["wh"].T, p["bi"],
                                      p["bh"])))
    tq = lstm.quantize_lstm_params(tw)
    np.testing.assert_array_equal(tq.w_q.numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq["scale"]))
    np.testing.assert_array_equal(tq.bias.numpy(), np.asarray(jq["bias"]))
    x, h, c = (rng.randn(3, n).astype(np.float32) for n in (20, 12, 12))
    jh, jc = jlstm.lstm_cell(jq, jnp.asarray(x),
                             (jnp.asarray(h), jnp.asarray(c)))
    cell = lstm.QuantizedLSTMCell.from_weights(tw)
    assert sorted(cell.state_dict()) == ["bias", "scale", "w_q"]
    th, tc = lstm.lstm_cell(lstm.lstm_weights(cell), torch.from_numpy(x),
                            (torch.from_numpy(h), torch.from_numpy(c)),
                            compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


@pytest.fixture(scope="module")
def quantized():
    jcfg, tcfg = JaxConfig(**DIMS), Tacotron2Config(**DIMS)
    params, stats = jm.init_params(jax.random.PRNGKey(4), jcfg)
    qparams = jm.quantize_for_serving(params)
    model = tm.Tacotron2(tcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    return jcfg, tcfg, qparams, stats, model


def test_quantize_for_serving_equals_converted_jax_quantization(quantized):
    """The port's own quantization of the converted weights holds the same
    numbers as the JAX package's quantized params carried across by
    ``state_dict_from_jax``, and leaves the original model as it was."""
    jcfg, tcfg, qparams, stats, model = quantized
    qmodel = tm.quantize_for_serving(model)
    assert tm.is_quantized(qmodel) and not tm.is_quantized(model)
    carried = state_dict_from_jax(qparams, stats, tcfg)
    own = qmodel.state_dict()
    assert sorted(own) == sorted(carried)
    assert own["decoder.attention_rnn.w_q"].dtype == torch.int8
    for k, v in carried.items():
        np.testing.assert_array_equal(own[k].numpy(), v.numpy(), err_msg=k)
    assert tm.quantize_for_serving(qmodel).state_dict().keys() == own.keys()


def test_infer_on_quantized_model_matches_jax(quantized):
    jcfg, tcfg, qparams, stats, model = quantized
    qmodel = tm.quantize_for_serving(model)
    rng = np.random.RandomState(5)
    text = rng.randint(1, 40, (2, 9)).astype(np.int32)
    lengths = np.array([9, 6], np.int32)
    want = jm.infer(qparams, stats, jnp.asarray(text), jnp.asarray(lengths),
                    jcfg)
    got = tm.infer(qmodel, torch.from_numpy(text), torch.from_numpy(lengths),
                   tcfg, device="cpu")
    np.testing.assert_array_equal(got.mel_lengths.numpy(),
                                  np.asarray(want.mel_lengths))
    for f in ("mel", "mel_postnet", "gate_energies", "alignments"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   err_msg=f)
    plain = tm.infer(model, torch.from_numpy(text),
                     torch.from_numpy(lengths), tcfg, device="cpu")
    assert not np.allclose(plain.mel.numpy(), got.mel.numpy(), atol=1e-4)


def test_serving_takes_a_quantized_state_dict(quantized):
    """``BatchingSynthesizer`` builds the quantized module from a
    state_dict whose keys end in ``w_q`` and serves it through ``infer``
    (the int8 cell), not through the chunk kernel's packer."""
    jcfg, tcfg, qparams, stats, model = quantized
    sd = state_dict_from_jax(qparams, stats, tcfg)
    calls = i8.int8_matmul_plain.calls
    synth = BatchingSynthesizer(sd, tcfg, max_batch=2, max_steps=5,
                                device="cpu")
    try:
        assert synth.quantized and synth._packed is None
        mel, align, n = synth.submit("abc").result(timeout=120)
    finally:
        synth.close()
    assert n == 5 and mel.shape == (5, 12) and np.isfinite(mel).all()
    assert i8.int8_matmul_plain.calls == calls + 2 * 5
    want = tm.infer(tm.quantize_for_serving(model),
                    *_padded("abc", tcfg, 2), tcfg, max_steps=5,
                    device="cpu")
    np.testing.assert_allclose(mel, want.mel_postnet[0].numpy(), atol=1e-6)


def _padded(text, cfg, B):
    from tacotron2_tpu_torch.data.bucketing import text_bucket
    from tacotron2_tpu_torch.text import text_to_sequence
    ids = text_to_sequence(text, cfg.text_cleaners)
    t = np.zeros((B, text_bucket(len(ids), cfg.text_buckets)), np.int64)
    t[0, :len(ids)] = ids
    lengths = np.ones((B,), np.int32)
    lengths[0] = len(ids)
    return torch.from_numpy(t), torch.from_numpy(lengths)


def test_quantized_model_is_rejected_by_packers_and_training(quantized):
    from tacotron2_tpu_torch.kernels import decoder_batch as db
    from tacotron2_tpu_torch.kernels import decoder_step as ds
    _, tcfg, _, _, model = quantized
    qmodel = tm.quantize_for_serving(model)
    for pack in (db.pack_batch_decoder_params, ds.pack_decoder_params):
        with pytest.raises(ValueError, match="unquantized"):
            pack(qmodel, torch.float32)
    text = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="unquantized"):
        tm.infer_fused(qmodel, text, torch.tensor([4]), tcfg, device="cpu")
    batch = tstate.make_batch(tcfg, 2, 6, 8, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        tm.forward(qmodel, tm.bn_stats(qmodel), batch.text,
                   batch.text_lengths, batch.mel, batch.mel_lengths, tcfg,
                   training=True)


# ---------------------------------------------------------------------------
# The CUDA kernel's index maps (csrc/int8_matmul.cu), emulated lane by lane in
# numpy: the packed weight order, the widening by byte permutes, the swap-AB
# fragment maps and the K-split reduction order. The kernel itself runs only
# on the card (tests/test_torch_kernels_gpu.py).

def _byte_perm(x, y, sel):
    """PTX prmt (CUDA __byte_perm) on uint32 arrays: byte n of the result is
    byte (sel >> 4n) & 7 of the eight bytes of (x, y)."""
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def _widen4(u):
    """The kernel's widen4: four biased bytes -> two bf16x2 words."""
    f = [(_byte_perm(u, 0x4B000000, 0x7650 + i).view(np.float32)
          - np.float32(8388736.0)) for i in range(4)]
    lo = _byte_perm(f[0].view(np.uint32), f[1].view(np.uint32), 0x7632)
    hi = _byte_perm(f[2].view(np.uint32), f[3].view(np.uint32), 0x7632)
    return lo, hi


def _bf16x2(w):
    """A bf16x2 word -> (low element, high element) as fp32."""
    w = np.asarray(w, np.uint32)
    return ((w << np.uint32(16)).view(np.float32),
            (w & np.uint32(0xFFFF0000)).view(np.float32))


def test_widening_by_byte_permutes_is_exact():
    """Every int8 value, biased as pack_int8 stores it, widens to itself in
    bf16, in its place of the pair."""
    v = np.arange(-128, 128, dtype=np.int32)
    u = (v.astype(np.int8).view(np.uint8) ^ 0x80).astype(np.uint32)
    word = u[0::4] | (u[1::4] << 8) | (u[2::4] << 16) | (u[3::4] << 24)
    lo, hi = _widen4(word)
    got = np.stack([*_bf16x2(lo), *_bf16x2(hi)], axis=1).reshape(-1)
    np.testing.assert_array_equal(got, v.astype(np.float32))


def _lane_fragments(packed):
    """Each lane's A fragments as the kernel forms them from its 16 packed
    bytes: (tiles, chunks, 32 lanes, 2 k16 halves, 4 registers, 2) fp32."""
    p = packed.numpy().astype(np.uint32)
    words = (p[..., 0::4] | (p[..., 1::4] << 8) | (p[..., 2::4] << 16)
             | (p[..., 3::4] << 24))                  # (nt, kc, 32, 4)
    lo, hi = _widen4(words)
    regs = np.stack([*_bf16x2(lo), *_bf16x2(hi)], -1)  # word w: r 2(w&1)..
    return regs.reshape(*p.shape[:3], 2, 4, 2)


def test_pack_int8_is_the_lane_order():
    """pack_int8 puts w_q[k, n] where PTX's m16n8k16 A fragment of lane
    (g, q) wants it: register r holds rows g + 8 (r & 1) (the weight
    columns) and k 2q + 8 (r >> 1) and the next; zeros past K and N."""
    rng = np.random.RandomState(6)
    K, N = 70, 37
    w_q = torch.from_numpy(rng.randint(-128, 128, (K, N)).astype(np.int8))
    frag = _lane_fragments(i8.pack_int8(w_q))
    nt, kc = frag.shape[:2]
    assert (nt, kc) == (3, 3)
    wpad = np.zeros((kc * 32, nt * 16), np.float32)
    wpad[:K, :N] = w_q.numpy()
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for h in range(2):
            for r in range(4):
                for e in range(2):
                    m = g + 8 * (r & 1)
                    k = 16 * h + 8 * (r >> 1) + 2 * q + e
                    want = wpad[k::32, m::16].T    # (tiles, chunks)
                    np.testing.assert_array_equal(
                        frag[:, :, lane, h, r, e], want)


def _smem(rg, tpb, ks_max):
    """i8_smem: each warp's ring (2 stages of at most 5 chunks of 512
    bytes) and its two 8-byte barriers, and x (8 rg rows of each of the
    eight slices of K, padded by 8, as bf16)."""
    return tpb * 8 * (2 * 5 * 512 + 2 * 8) + 8 * 8 * rg * (ks_max + 8) * 2


def _built_tiles():
    """I8_TPB as csrc/int8_matmul.cu defines it."""
    src = (Path(i8.__file__).parent / "csrc" / "int8_matmul.cu").read_text()
    return int(re.search(r"#define I8_TPB (\d+)", src).group(1))


def _stage_x(xb, b0, rows, rg, ks_max, c0, nch, tpb):
    """The kernel's staging of one slice of K in one block: lane l of the
    slice's warp u of tpb takes the pieces 32 (tpb j + u) + l, row-major,
    walking them as store_x does, and stores each (four bf16 values, zeros
    past K). Returns the staged x; asserts each piece is stored once."""
    B, K = xb.shape
    ks, k0 = nch * 32, c0 * 32
    p4 = ks // 4
    staged = np.full((8 * rg, ks_max + 8), np.nan, np.float32)
    stored = np.zeros((8 * rg, ks_max + 8), np.int32)
    for part in range(tpb):
        for lane in range(32):
            start = 32 * part + lane
            xr, xc = (start // p4, start % p4) if ks else (rows, 0)
            while xr < rows:
                k = k0 + 4 * xc + np.arange(4)
                staged[xr, 4 * xc:4 * xc + 4] = np.where(
                    k < K, xb[b0 + xr, np.minimum(k, K - 1)], 0.0)
                stored[xr, 4 * xc:4 * xc + 4] += 1
                xc += 32 * tpb
                while xc >= p4:
                    xc -= p4
                    xr += 1
    assert (stored[:rows, :ks] == 1).all()
    assert (stored[rows:] == 0).all() and (stored[:, ks:] == 0).all()
    return staged


def _emulate_kernel(x, w_q, scale, tpb):
    """csrc/int8_matmul.cu's int8_matmul emulated with I8_TPB = tpb:
    launches of up to 64 rows (32 where x does not fit); a launch's blocks
    take tpb tiles where shared memory allows (else one); block j's warp w
    takes tile tpb j + w // 8 (none past the last) and chunks [s KC / 8,
    (s + 1) KC / 8) of K, s = w % 8, reading the slice's x as the block
    staged it (_stage_x) at the B fragments' addresses, rows past B as
    zeros; each mma's C fragment goes into the warp's partials, and each
    tile's partials are summed in warp order. Returns (out, times each
    element was written)."""
    B, K = x.shape
    N = w_q.shape[1]
    frag = _lane_fragments(i8.pack_int8(w_q))
    NT, KC = frag.shape[:2]
    ks_max = -(-KC // 8) * 32
    most = 8
    while most > 1 and _smem(most, 1, ks_max) > 227 * 1024:
        most //= 2
    xb = x.to(torch.bfloat16).float().numpy()
    out = np.zeros((B, N), np.float32)
    writes = np.zeros((B, N), np.int32)
    lanes = np.arange(32)
    g, q = lanes >> 2, lanes & 3
    sc = scale.numpy()
    for b0 in range(0, B, 8 * most):
        rows = min(8 * most, B - b0)
        RG = min(1 if rows <= 8 else 2 if rows <= 16 else 4 if rows <= 32
                 else 8, most)
        TPB = tpb if tpb > 1 and _smem(RG, 2, ks_max) <= 227 * 1024 else 1
        for blk in range(-(-NT // TPB)):
            staged = [_stage_x(xb, b0, rows, RG, ks_max, w * KC // 8,
                               (w + 1) * KC // 8 - w * KC // 8, TPB)
                      for w in range(8)]
            for part in range(TPB):
                tile = blk * TPB + part
                if tile >= NT:
                    continue
                red = np.zeros((8, 8 * RG, 16), np.float32)
                for w in range(8):
                    c0, c1 = w * KC // 8, (w + 1) * KC // 8
                    xw = staged[w]
                    acc = np.zeros((RG, 32, 4), np.float32)
                    for c in range(c0, c1):
                        for h in range(2):
                            A = np.zeros((16, 16), np.float32)
                            for r in range(4):
                                for e in range(2):
                                    A[g + 8 * (r & 1),
                                      8 * (r >> 1) + 2 * q + e] = \
                                        frag[tile, c, :, h, r, e]
                            kk = (c - c0) * 32 + h * 16 + 2 * q
                            for rg in range(RG):
                                live = rg * 8 + g < rows
                                Bm = np.zeros((16, 8), np.float32)
                                for e in range(2):
                                    row = np.minimum(rg * 8 + g,
                                                     8 * RG - 1)
                                    Bm[2 * q + e, g] = np.where(
                                        live, xw[row, kk + e], 0.0)
                                    Bm[8 + 2 * q + e, g] = np.where(
                                        live, xw[row, kk + 8 + e], 0.0)
                                C = A @ Bm
                                for e in range(4):
                                    acc[rg, :, e] += C[g + 8 * (e >> 1),
                                                       2 * q + (e & 1)]
                    for rg in range(RG):
                        for e in range(4):
                            red[w, rg * 8 + 2 * q + (e & 1),
                                g + 8 * (e >> 1)] = acc[rg, :, e]
                for i in range(8 * RG * 16):
                    r, n = i >> 4, tile * 16 + (i & 15)
                    if b0 + r >= B or n >= N:
                        continue
                    total = np.float32(0)
                    for w in range(8):
                        total += red[w, r, i & 15]
                    out[b0 + r, n] = total * sc[n]
                    writes[b0 + r, n] += 1
    return out, writes


@pytest.mark.parametrize("B,K,N", [(1, 100, 83), (13, 200, 300),
                                   (19, 257, 40), (70, 64, 33),
                                   (3, 96, 50), (8, 576, 70)])
def test_kernel_index_map(B, K, N):
    """Row 7's kernel, in the layout the source builds, emulated lane by
    lane against the plain version: x staged exactly once a block, every
    output element written exactly once, within the product's tolerance
    (the same exact products, fp32 sums in another order)."""
    rng, w = weights(7, K, N)
    x = torch.from_numpy(rng.randn(B, K).astype(np.float32))
    w_q, scale = i8.quantize_int8(w)
    got, writes = _emulate_kernel(x, w_q, scale, _built_tiles())
    np.testing.assert_array_equal(writes, 1)
    want = i8.int8_matmul_plain(x, w_q, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("tpb", [1, 2])
def test_kernel_index_map_tiles_a_block(tpb):
    """One and two tiles a block (the probe builds both) emulated the same
    way, at ragged and whole-chunk K, ragged N, one and several row groups:
    x staged once a block, every element written once."""
    for B, K, N in ((3, 100, 83), (19, 257, 40), (5, 320, 40)):
        rng, w = weights(8, K, N)
        x = torch.from_numpy(rng.randn(B, K).astype(np.float32))
        w_q, scale = i8.quantize_int8(w)
        got, writes = _emulate_kernel(x, w_q, scale, tpb)
        np.testing.assert_array_equal(writes, 1)
        want = i8.int8_matmul_plain(x, w_q, scale).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_probe_variants_find_their_markers():
    """The card's probe switches parts of the kernel off by editing copies
    of the source at markers; every marker must still be in the source."""
    from tacotron2_tpu_torch.kernels import int8_probe
    variants = int8_probe._sources()
    assert len(set(variants.values())) == len(variants)
