"""The port's HTTP server (tacotron2_tpu_torch/http_server.py) on the CPU:
the nine cases of tests/test_http_server.py, at its config (its widths,
attention_rnn_dim=20 among them; fp32 here, so that the served mels can be
held to the JAX package's), plus WaveGlow, the command line, and one
``VocoderRunner`` called from many threads at once.

Weights come from the JAX package's ``init_params`` (and
``init_generator``) through the port's ``convert`` functions. What the
server returns is held against the JAX package on the same weights: a mel
(JSON or NDJSON) against ``models.tacotron2.infer`` on the text padded to
its bucket, within REL = 1e-4 of its largest value; HiFi-GAN audio against
the JAX package's ``serve.VocoderRunner`` within 2 int16 steps (ATOL_PCM);
a Griffin-Lim WAV (its start phase is drawn, on each side from its own
generator) by its length, that of the JAX package's Griffin-Lim at the JAX
frame count.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu import audio as jaudio
from tacotron2_tpu import serve as jserve
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.models import hifigan as jh
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.text import text_to_sequence

from tacotron2_tpu_torch import http_server
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import (hifigan_state_dict_from_jax,
                                         state_dict_from_jax)
from tacotron2_tpu_torch.data.bucketing import text_bucket
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.models import waveglow as twg
from tacotron2_tpu_torch.serve import VocoderRunner

KW = dict(
    n_symbols=148, symbols_embedding_dim=16, encoder_embedding_dim=16,
    encoder_n_convolutions=2, attention_rnn_dim=20, decoder_rnn_dim=24,
    prenet_dim=8, attention_dim=12, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=16,
    postnet_n_convolutions=3, n_mel_channels=8, max_decoder_steps=8,
    filter_length=64, hop_length=16, win_length=64, text_buckets=(16, 32),
    compute_dtype="float32")
JCFG, CFG = JaxConfig(**KW), Tacotron2Config(**KW)
HG = dict(n_mel_channels=8, upsample_rates=(4, 4),
          upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
          resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
REL, ATOL_PCM = 1e-4, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    params, stats = jm.init_params(jax.random.PRNGKey(0), JCFG)
    model = tm.Tacotron2(CFG)
    model.load_state_dict(state_dict_from_jax(params, stats, CFG))
    return params, stats, model


def jax_mel(weights, text):
    """The JAX package's mel of ``text`` padded to its bucket, trimmed to
    its frames, fp32, no prenet dropout (the server is deterministic)."""
    params, stats, _ = weights
    ids = text_to_sequence(text, JCFG.text_cleaners)
    ids_b = np.zeros((1, text_bucket(len(ids), JCFG.text_buckets)), np.int32)
    ids_b[0, :len(ids)] = ids
    res = jm.infer(params, stats, jnp.asarray(ids_b),
                   jnp.asarray([len(ids)], jnp.int32),
                   JCFG.replace(prenet_dropout_at_inference=False))
    n = int(res.mel_lengths[0])
    return np.asarray(res.mel_postnet[0, :n])


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.server_close()
    srv.RequestHandlerClass.synthesizer.close()


@pytest.fixture(scope="module")
def server(weights):
    srv = http_server.make_server(weights[2], CFG, port=0, device="cpu")
    yield _start(srv)
    _stop(srv)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=180)


def _wav(body):
    sr, data = scipy.io.wavfile.read(io.BytesIO(body))
    assert sr == CFG.sampling_rate and data.dtype == np.int16
    return data


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        assert json.load(r)["status"] == "ok"


def test_synthesize_mel_json(server, weights):
    with _post(server + "/synthesize", {"text": "hello world"}) as r:
        body = json.load(r)
    mel = np.asarray(body["mel"])
    assert body["n_frames"] >= 1
    assert mel.shape == (body["n_frames"], CFG.n_mel_channels)
    assert rel_err(mel, jax_mel(weights, "hello world")) <= REL


def test_synthesize_wav(server, weights):
    with _post(server + "/synthesize",
               {"text": "hi", "vocoder": "griffin_lim"}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        wav = r.read()
    assert wav[:4] == b"RIFF"
    data = _wav(wav)
    frames = len(jax_mel(weights, "hi"))
    want = jaudio.griffin_lim(
        jnp.ones((1, CFG.filter_length // 2 + 1, frames)),
        jaudio.STFTConfig(CFG.filter_length, CFG.hop_length, CFG.win_length),
        n_iters=1, key=jax.random.PRNGKey(0))
    assert data.shape == (want.shape[1],)
    assert np.abs(data).max() > 0


def test_missing_text_400(server):
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(server + "/synthesize", {})
    assert exc_info.value.code == 400


def test_concurrent_requests(server, weights):
    results = {}

    def call(i):
        with _post(server + "/synthesize", {"text": f"utterance {i}"}) as r:
            results[i] = np.asarray(json.load(r)["mel"])
    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert sorted(results) == [0, 1, 2, 3]
    for i, mel in results.items():
        assert rel_err(mel, jax_mel(weights, f"utterance {i}")) <= REL, i


def test_vocoder_not_loaded_400(server):
    for vocoder in ("hifigan", "waveglow", "wavenet"):
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(server + "/synthesize", {"text": "hi", "vocoder": vocoder})
        assert exc_info.value.code == 400, vocoder


def test_stream_mel_ndjson(server, weights):
    """No vocoder loaded: /stream emits newline-delimited JSON mel events,
    which together are the offline mel."""
    with _post(server + "/stream", {"text": "streaming test"}) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(ln) for ln in r.read().splitlines() if ln]
    assert lines and lines[-1]["done"]
    assert lines[0]["mel_offset"] == 0
    assert np.asarray(lines[0]["mel"]).shape == (lines[0]["n_frames"],
                                                 CFG.n_mel_channels)
    mel = np.concatenate([np.asarray(ev["mel"]).reshape(-1, 8)
                          for ev in lines])
    assert mel.shape[0] == sum(ev["n_frames"] for ev in lines) >= 1
    assert rel_err(mel, jax_mel(weights, "streaming test")) <= REL


@pytest.fixture(scope="module")
def hifigan_server(weights):
    jcfg, tcfg = jh.HiFiGANConfig(**HG), th.HiFiGANConfig(**HG)
    # redrawn at N(0, 0.09 / fan_in): the init's N(0, 0.01) gives audio
    # below one int16 step
    rng = np.random.RandomState(1)
    gp = jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.3
                              / np.sqrt(max(p.size // p.shape[-1], 1))),
        jh.init_generator(jax.random.PRNGKey(1), jcfg))
    gen = th.Generator(tcfg)
    gen.load_state_dict(hifigan_state_dict_from_jax(gp, tcfg))
    srv = http_server.make_server(weights[2], CFG, port=0,
                                  vocoder_kind="hifigan", vocoder=gen,
                                  vocoder_cfg=tcfg, chunk_steps=4,
                                  device="cpu")
    runner = jserve.VocoderRunner("hifigan", gp, jcfg,
                                  max_frames=CFG.max_decoder_steps)
    yield _start(srv), tcfg, runner
    _stop(srv)


def test_synthesize_hifigan_wav(hifigan_server, weights):
    url, hg_cfg, jax_runner = hifigan_server
    with _post(url + "/synthesize",
               {"text": "hi", "vocoder": "hifigan"}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        wav = r.read()
    assert wav[:4] == b"RIFF"
    want = (np.clip(jax_runner(jax_mel(weights, "hi")), -1, 1) * 32767
            ).astype(np.int16)
    got = _wav(wav)
    assert got.shape == want.shape == (len(want),)
    assert np.abs(got.astype(int) - want).max() <= ATOL_PCM
    assert np.abs(want).max() > 100


def test_stream_pcm(hifigan_server, weights):
    """HiFi-GAN loaded: /stream emits s16le PCM; total samples = n_frames *
    vocoder hop (checked against the offline /synthesize frame count), and
    the samples are the JAX package's vocoder on the offline mel."""
    url, hg_cfg, jax_runner = hifigan_server
    with _post(url + "/synthesize", {"text": "stream me"}) as r:
        n_frames = json.load(r)["n_frames"]
    with _post(url + "/stream", {"text": "stream me"}) as r:
        assert r.headers["Content-Type"].startswith("audio/L16")
        pcm = r.read()
    samples = np.frombuffer(pcm, "<i2")
    assert samples.shape[0] == n_frames * hg_cfg.hop_length
    want = (np.clip(jax_runner(jax_mel(weights, "stream me")), -1, 1)
            * 32767).astype(np.int16)
    assert np.abs(samples.astype(int) - want).max() <= ATOL_PCM


def test_synthesize_waveglow_wav(weights):
    """WaveGlow loaded: a WAV of n_frames * hop samples, the same as
    ``VocoderRunner`` gives for the served mel, and the same for the same
    request twice (z is drawn from a generator seeded 0 on every call)."""
    wg_cfg = twg.WaveGlowConfig(n_mel_channels=8, n_flows=4, n_early_every=2,
                                wn_layers=2, wn_channels=16,
                                upsample_kernel=64, upsample_stride=16)
    wg = twg.WaveGlow(wg_cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for wn in wg.WN:
            wn.end.weight.normal_(0, 0.05, generator=torch.Generator()
                                  .manual_seed(4))
    srv = http_server.make_server(weights[2], CFG, port=0,
                                  vocoder_kind="waveglow", vocoder=wg,
                                  vocoder_cfg=wg_cfg, device="cpu")
    url = _start(srv)
    try:
        wavs = []
        for _ in range(2):
            with _post(url + "/synthesize",
                       {"text": "hi", "vocoder": "waveglow"}) as r:
                wavs.append(_wav(r.read()))
        with _post(url + "/synthesize", {"text": "hi"}) as r:
            mel = np.asarray(json.load(r)["mel"], np.float32)
    finally:
        _stop(srv)
    runner = VocoderRunner("waveglow", wg, wg_cfg, device="cpu",
                           max_frames=CFG.max_decoder_steps)
    want = (np.clip(runner(mel), -1, 1) * 32767).astype(np.int16)
    assert wavs[0].shape == (mel.shape[0] * CFG.hop_length,)
    np.testing.assert_array_equal(wavs[0], wavs[1])
    assert np.abs(wavs[0].astype(int) - want).max() <= ATOL_PCM
    assert rel_err(mel, jax_mel(weights, "hi")) <= REL


def test_main_rejects_a_vocoder_without_weights(tmp_path):
    with pytest.raises(SystemExit) as exc:
        http_server.main(["-c", str(tmp_path), "--vocoder", "hifigan",
                          "--device", "cpu"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:  # an empty directory
        http_server.main(["-c", str(tmp_path), "--device", "cpu"])
    assert exc.value.code == 2


def test_vocoder_runner_serves_many_threads_on_one():
    """16 threads call one VocoderRunner at once (as the server's handler
    threads do), with a short switch interval: every call runs on the
    runner's one thread, and each returns what a call alone returns."""
    import sys
    hg_cfg = th.HiFiGANConfig(**HG)
    gen = th.Generator(hg_cfg, torch.Generator().manual_seed(5))
    runner = VocoderRunner("hifigan", gen, hg_cfg, max_frames=8,
                           device="cpu")
    seen = set()
    vocode = runner._vocode
    runner._vocode = lambda mel: (seen.add(threading.get_ident()),
                                  vocode(mel))[1]
    rng = np.random.RandomState(6)
    mels = [rng.randn(3 + i % 5, 8).astype(np.float32) for i in range(16)]
    want = [vocode(m) for m in mels]
    got = [None] * 16

    def call(i):
        got[i] = runner(mels[i])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(seen) == 1 and threading.get_ident() not in seen
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
