"""The port's streaming synthesis (tacotron2_tpu_torch/streaming) against
its own offline pipeline and against the JAX package's
``StreamingSynthesizer``, for plain, fused and quantized weights.

Tolerances: streamed against the port's offline pass at 1e-5 in fp32 (the
same function of the same inputs; a window's convolutions may sum in
another order than the whole buffer's) and 2e-2 in bf16 (a sum that differs
in its last bit can round a conv's bf16 operand the other way, 2^-8 of it);
against the JAX package at 1e-4 (24 fp32 decoder steps, then the postnet).
The vocoder's weights are drawn at N(0, 0.3) so that the audio is of order
0.1 and the tolerances mean something.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.models import hifigan as jh
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu import streaming as jstream

from tacotron2_tpu_torch import streaming
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import (hifigan_state_dict_from_jax,
                                         state_dict_from_jax)
from tacotron2_tpu_torch.data.bucketing import text_bucket
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import decoder_step as ds
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.text import text_to_sequence

# the widths of tests/test_streaming.py
DIMS = dict(
    n_symbols=148, symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=2, attention_rnn_dim=40, decoder_rnn_dim=48,
    prenet_dim=16, attention_dim=24, attention_location_n_filters=8,
    attention_location_kernel_size=15, postnet_embedding_dim=32,
    postnet_n_convolutions=3, n_mel_channels=20, max_decoder_steps=24,
    text_buckets=(16, 32), gate_threshold=0.99, compute_dtype="float32")
HG = dict(n_mel_channels=20, upsample_rates=(4, 4),
          upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
TEXT = "hello world"
TEXTS = ["hello world", "a much longer line of text", "hi"]


class World:
    """One set of weights in both packages."""

    def __init__(self, **kw):
        kw = {**DIMS, **kw}
        self.jcfg, self.tcfg = JaxConfig(**kw), Tacotron2Config(**kw)
        self.params, self.stats = jm.init_params(jax.random.PRNGKey(0),
                                                 self.jcfg)
        self.model = tm.Tacotron2(self.tcfg)
        self.model.load_state_dict(state_dict_from_jax(
            self.params, self.stats, self.tcfg))
        self.jhg = jh.HiFiGANConfig(**HG)
        # the JAX package's slope before conv_post
        self.thg = th.HiFiGANConfig(**HG, post_lrelu_slope=jh.LRELU_SLOPE)
        rng = np.random.RandomState(1)
        self.gparams = jax.tree.map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.3
                                  / np.sqrt(max(p.size // p.shape[-1], 1))),
            jh.init_generator(jax.random.PRNGKey(1), self.jhg))
        self.voc = th.Generator(self.thg)
        self.voc.load_state_dict(hifigan_state_dict_from_jax(self.gparams,
                                                             self.thg))

    def weights(self, mode):
        """(JAX params, port's model, fused flag) for plain / fused /
        quantized."""
        if mode == "quantized":
            return (jm.quantize_for_serving(self.params),
                    tm.quantize_for_serving(self.model), None)
        return self.params, self.model, mode == "fused"


@pytest.fixture(scope="module")
def world():
    return World()


def collect(events):
    events = list(events)
    mel = [e.mel for e in events if e.mel is not None]
    audio = [e.audio for e in events if e.audio is not None]
    return (np.concatenate(mel), np.concatenate(audio) if audio else None,
            events)


def offline(world, model, fused, texts, max_steps, cfg=None, vocode=True):
    """The port's offline pipeline on the bucket-padded texts, as the
    streamer pads them: (mel, audio) per row, trimmed."""
    cfg = cfg or world.tcfg
    cfg = cfg.replace(prenet_dropout_at_inference=False)
    ids = [text_to_sequence(t, cfg.text_cleaners) for t in texts]
    bucket = max(text_bucket(len(i), cfg.text_buckets) for i in ids)
    text = np.zeros((len(ids), bucket), np.int64)
    for i, s in enumerate(ids):
        text[i, :len(s)] = s
    lengths = torch.tensor([len(i) for i in ids], dtype=torch.int32)
    cd = cfg.torch_compute_dtype
    if fused and len(texts) == 1:
        res = tm.infer_fused(model, torch.from_numpy(text), lengths, cfg,
                             max_steps=max_steps, device="cpu")
    elif fused:
        res = tm.infer_batch_fused(model, torch.from_numpy(text), lengths,
                                   cfg, max_steps=max_steps, device="cpu")
    else:
        res = tm.infer(model, torch.from_numpy(text), lengths, cfg,
                       max_steps=max_steps, device="cpu",
                       compute_dtype=None if cd == torch.float32 else cd)
    audio = th.generator(world.voc, res.mel_postnet, world.thg)
    out = []
    for b in range(len(texts)):
        n = int(res.mel_lengths[b])
        out.append((res.mel_postnet[b, :n].numpy(),
                    audio[b, :n * world.thg.hop_length].numpy()
                    if vocode else None))
    return out


@pytest.mark.parametrize("mode", ["plain", "fused", "quantized"])
@pytest.mark.parametrize("vocode", [False, True], ids=["mel", "hifigan"])
def test_stream_matches_offline_and_jax(world, mode, vocode):
    jparams, model, fused = world.weights(mode)
    kw = dict(chunk_steps=8, max_steps=24)
    s = streaming.StreamingSynthesizer(
        model, world.tcfg, vocoder=world.voc if vocode else None,
        vocoder_cfg=world.thg if vocode else None, fused=fused,
        device="cpu", **kw)
    launches = (ds.decoder_step_chunk_plain.calls,
                db.decoder_chunk_plain.calls)
    mel, audio, events = collect(s.stream(TEXT))
    used = (ds.decoder_step_chunk_plain.calls - launches[0],
            db.decoder_chunk_plain.calls - launches[1])
    assert used == ((3, 0) if mode == "fused" else (0, 0))
    (want_mel, want_audio), = offline(world, model, mode == "fused", [TEXT],
                                      24, vocode=vocode)
    assert mel.shape == want_mel.shape == (24, 20)
    np.testing.assert_allclose(mel, want_mel, atol=1e-5)
    js = jstream.StreamingSynthesizer(
        jparams, world.stats, world.jcfg,
        vocoder_params=world.gparams if vocode else None,
        vocoder_cfg=world.jhg if vocode else None, fused=fused, **kw)
    jmel, jaudio, jevents = collect(js.stream(TEXT))
    np.testing.assert_allclose(mel, jmel, atol=1e-4)
    assert [(e.mel_offset, e.done, e.mel is None) for e in events] == \
        [(e.mel_offset, e.done, e.mel is None) for e in jevents]
    assert events[-1].done and not any(e.done for e in events[:-1])
    if vocode:
        assert audio.shape == want_audio.shape == (24 * 16,)
        assert np.abs(want_audio).max() > 1e-2
        np.testing.assert_allclose(audio, want_audio, atol=1e-5)
        np.testing.assert_allclose(audio, jaudio, atol=1e-4)
    else:
        assert audio is None


@pytest.mark.parametrize("thr,max_steps,cs", [
    (0.45, 24, 8),   # the gate fires inside a chunk: frames past it are zero
    (0.99, 20, 8),   # the last chunk overshoots the cap: frames past it zeroed
    (0.99, 6, 8),    # the buffer is shorter than a window: clamped to it
])
def test_stream_edges(thr, max_steps, cs):
    world = World(gate_threshold=thr)
    kw = dict(chunk_steps=cs, max_steps=max_steps)
    s = streaming.StreamingSynthesizer(world.model, world.tcfg,
                                       vocoder=world.voc,
                                       vocoder_cfg=world.thg, device="cpu",
                                       **kw)
    mel, audio, _ = collect(s.stream(TEXT))
    (want_mel, want_audio), = offline(world, world.model, True, [TEXT],
                                      max_steps)
    assert mel.shape == want_mel.shape
    if thr < 0.9:
        assert 0 < mel.shape[0] < max_steps   # it did stop early
    np.testing.assert_allclose(mel, want_mel, atol=1e-5)
    np.testing.assert_allclose(audio, want_audio, atol=1e-5)
    js = jstream.StreamingSynthesizer(
        world.params, world.stats, world.jcfg, vocoder_params=world.gparams,
        vocoder_cfg=world.jhg, **kw)
    jmel, jaudio, _ = collect(js.stream(TEXT))
    np.testing.assert_allclose(mel, jmel, atol=1e-4)
    np.testing.assert_allclose(audio, jaudio, atol=1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_stream_batch_matches_offline_and_jax(world, fused):
    kw = dict(chunk_steps=8, max_steps=24)
    s = streaming.StreamingSynthesizer(world.model, world.tcfg,
                                       vocoder=world.voc,
                                       vocoder_cfg=world.thg, fused=fused,
                                       device="cpu", **kw)
    calls = db.decoder_chunk_plain.calls
    got = list(s.stream_batch(TEXTS))
    assert db.decoder_chunk_plain.calls - calls == (3 if fused else 0)
    js = jstream.StreamingSynthesizer(
        world.params, world.stats, world.jcfg, vocoder_params=world.gparams,
        vocoder_cfg=world.jhg, fused=fused, **kw)
    want = list(js.stream_batch(TEXTS))
    assert [(b, e.mel_offset, e.done) for b, e in got] == \
        [(b, e.mel_offset, e.done) for b, e in want]
    off = offline(world, world.model, fused, TEXTS, 24)
    for row in range(len(TEXTS)):
        mel, audio, _ = collect(e for b, e in got if b == row)
        jmel, jaudio, _ = collect(e for b, e in want if b == row)
        np.testing.assert_allclose(mel, off[row][0], atol=1e-5)
        np.testing.assert_allclose(audio, off[row][1], atol=1e-5)
        np.testing.assert_allclose(mel, jmel, atol=1e-4)
        np.testing.assert_allclose(audio, jaudio, atol=1e-4)
    with pytest.raises(ValueError, match="1..8"):
        next(s.stream_batch([]))


def test_stream_bf16_within_its_tolerance():
    world = World(compute_dtype="bfloat16")
    s = streaming.StreamingSynthesizer(world.model, world.tcfg,
                                       vocoder=world.voc,
                                       vocoder_cfg=world.thg, chunk_steps=8,
                                       max_steps=24, device="cpu")
    mel, audio, _ = collect(s.stream(TEXT))
    (want_mel, want_audio), = offline(world, world.model, True, [TEXT], 24)
    np.testing.assert_allclose(mel, want_mel,
                               atol=2e-2 * np.abs(want_mel).max())
    np.testing.assert_allclose(audio, want_audio,
                               atol=2e-2 * np.abs(want_audio).max())


def test_stream_with_dropout_equals_offline_at_the_same_chunk(world):
    """Keep masks are drawn chunk by chunk from the generator: the streamed
    mel equals ``infer_fused`` from the same seed at the same chunk_steps."""
    s = streaming.StreamingSynthesizer(world.model, world.tcfg, chunk_steps=8,
                                       max_steps=24, deterministic=False,
                                       device="cpu")
    mel, _, _ = collect(s.stream(TEXT, torch.Generator().manual_seed(3)))
    ids = text_to_sequence(TEXT, world.tcfg.text_cleaners)
    text = np.zeros((1, 16), np.int64)
    text[0, :len(ids)] = ids
    res = tm.infer_fused(world.model, torch.from_numpy(text),
                         torch.tensor([len(ids)]), world.tcfg, max_steps=24,
                         chunk_steps=8, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(mel, res.mel_postnet[0].numpy(), atol=1e-5)
    quiet, _, _ = collect(s.stream(TEXT))
    assert not np.allclose(mel, quiet, atol=1e-3)


def test_margins_windows_and_checks(world):
    assert streaming.postnet_margin_frames(world.tcfg) == \
        jstream.postnet_margin_frames(world.jcfg) == 6
    assert streaming.postnet_margin_frames(Tacotron2Config()) == 10
    for args in ((-3, 10, 40), (35, 10, 40), (12, 10, 40), (0, 40, 40)):
        assert streaming._clamp_window(*args) == jstream._clamp_window(*args)
    s = streaming.StreamingSynthesizer(world.model, world.tcfg,
                                       vocoder=world.voc, device="cpu")
    assert s.vocoder_cfg == th.HiFiGANConfig(n_mel_channels=20)
    assert (s.C, s.P, s.M) == (32, 6, 15)
    with pytest.raises(ValueError, match="unquantized"):
        streaming.StreamingSynthesizer(tm.quantize_for_serving(world.model),
                                       world.tcfg, fused=True, device="cpu")
