"""The port's whole serving slice against the JAX package's: the same
weights and texts through ``infer_batch_fused`` and ``BatchingSynthesizer``
on both sides (the JAX decoder kernel in interpret mode, the port's plain
versions on the CPU). fp32, atol 1e-4, lengths equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.serve import BatchingSynthesizer as JaxSynthesizer
from tacotron2_tpu.text import text_to_sequence

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.serve import BatchingSynthesizer

DIMS = dict(
    symbols_embedding_dim=128, encoder_embedding_dim=128,
    encoder_n_convolutions=2, attention_rnn_dim=128, decoder_rnn_dim=128,
    prenet_dim=128, attention_dim=128, attention_location_n_filters=4,
    attention_location_kernel_size=7, n_mel_channels=16,
    postnet_embedding_dim=32, postnet_n_convolutions=3, gate_threshold=0.5,
    max_decoder_steps=10, text_buckets=(24, 48), compute_dtype="float32")
ATOL = 1e-4
TEXTS = [  # 3 in the 24-symbol bucket, 2 in the 48-symbol one
    "Hello world.",
    "Short and sweet.",
    "It is 9 a.m.",
    "A longer sentence goes into the second bucket.",
    "Dr. Who paid $3 for {T IY1} and cake.",
]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig(**DIMS), Tacotron2Config(**DIMS)
    params, stats = jm.init_params(jax.random.PRNGKey(7), jcfg)
    model = tm.Tacotron2(tcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    return params, stats, jcfg, model, tcfg


def batch(texts, cfg, bucket):
    ids = [text_to_sequence(t, cfg.text_cleaners) for t in texts]
    assert max(len(i) for i in ids) <= bucket
    text = np.zeros((len(ids), bucket), np.int32)
    lengths = np.array([len(i) for i in ids], np.int32)
    for b, i in enumerate(ids):
        text[b, :len(i)] = i
    return text, lengths


@pytest.mark.parametrize("texts,bucket", [(TEXTS[:3], 24), (TEXTS[3:], 48)],
                         ids=["bucket24", "bucket48"])
def test_infer_batch_fused_matches_jax(models, texts, bucket):
    params, stats, jcfg, model, tcfg = models
    text, lengths = batch(texts, tcfg, bucket)
    want = jm.infer_batch_fused(params, stats, jnp.asarray(text),
                                jnp.asarray(lengths), jcfg, chunk_steps=4)
    got = tm.infer_batch_fused(model, torch.from_numpy(text),
                               torch.from_numpy(lengths), tcfg, chunk_steps=4,
                               device="cpu")
    np.testing.assert_array_equal(got.mel_lengths.numpy(),
                                  np.asarray(want.mel_lengths))
    for name in ("mel", "mel_postnet", "gate_energies", "alignments"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)


def test_synthesizer_matches_jax(models):
    """Five requests over two buckets: every (mel_postnet, alignment, n)
    future agrees with the JAX package's synthesizer."""
    params, stats, jcfg, model, tcfg = models
    ours = BatchingSynthesizer(model, tcfg, max_batch=4, max_wait_ms=50,
                               device="cpu")
    theirs = JaxSynthesizer(params, stats, jcfg, max_batch=4, max_wait_ms=50)
    try:
        got = ours.synthesize(TEXTS)
        want = theirs.synthesize(TEXTS)
    finally:
        ours.close()
        theirs.close()
    for text, (gm, ga, gn), (wm, wa, wn) in zip(TEXTS, got, want):
        assert gn == wn, text
        assert gm.shape == wm.shape and ga.shape == wa.shape, text
        np.testing.assert_allclose(gm, np.asarray(wm), atol=ATOL,
                                   err_msg=text)
        np.testing.assert_allclose(ga, np.asarray(wa), atol=ATOL,
                                   err_msg=text)


def test_plain_infer_matches_jax(models):
    """``infer``: the step-by-step decoder of the plain path (-inf mask,
    sigmoid latch), against the JAX package's XLA ``infer``."""
    params, stats, jcfg, model, tcfg = models
    text, lengths = batch(TEXTS[:3], tcfg, 24)
    want = jm.infer(params, stats, jnp.asarray(text), jnp.asarray(lengths),
                    jcfg, max_steps=6)
    got = tm.infer(model, torch.from_numpy(text), torch.from_numpy(lengths),
                   tcfg, max_steps=6, device="cpu")
    np.testing.assert_array_equal(got.mel_lengths.numpy(),
                                  np.asarray(want.mel_lengths))
    for name in ("mel", "mel_postnet", "gate_energies", "alignments"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)


def test_decode_chunk_matches_jax(models):
    """``decode_chunk`` resumes exactly: two chunks of 3 steps against the
    JAX package's, outputs and carries."""
    params, stats, jcfg, model, tcfg = models
    text, lengths = batch(TEXTS[:3], tcfg, 24)
    jmem, _ = jm.encode(params, stats, jnp.asarray(text),
                        jnp.asarray(lengths), jcfg, training=False)
    memory = torch.tensor(np.asarray(jmem))
    jproc = jm.dense(params["decoder"]["attention"]["memory"], jmem)
    proc = tm.processed_memory_of(model, memory, None)
    np.testing.assert_allclose(proc.numpy(), np.asarray(jproc), atol=ATOL)
    jmask = jm.length_mask(jnp.asarray(lengths), 24)
    mask = torch.tensor(np.asarray(jmask))
    jc, tc = jm.init_stream_carry(jmem, jcfg), tm.init_stream_carry(memory,
                                                                     tcfg)
    for _ in range(2):
        jc, jout = jm.decode_chunk(params, jc, jmem, jproc, jmask, jcfg,
                                   chunk_steps=3)
        tc, tout = tm.decode_chunk(model, tc, memory, proc, mask, tcfg,
                                   chunk_steps=3)
        for g, w in zip(tout, jout):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert tc.t == int(jc.t)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for field in jc.state._fields:
        np.testing.assert_allclose(getattr(tc.state, field).numpy(),
                                   np.asarray(getattr(jc.state, field)),
                                   atol=ATOL, err_msg=field)
