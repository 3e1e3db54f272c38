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
