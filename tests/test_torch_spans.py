"""The program's spans (``utils/profiling.span``) on the CPU, under
``torch.profiler`` recording every thread: a small ``BatchingSynthesizer``
fed requests at known times, one batch decoded to an early stop, and a
small ``Trainer.fit``. Each span's thread, nesting and fields, and that a
traced run computes what an untraced one does."""

import json
import os
import threading
import time

import numpy as np
import pytest
import scipy.io.wavfile
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from tacotron2_tpu_torch import data as tdata
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.models import hifigan as th
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.serve import BatchingSynthesizer, VocoderRunner
from tacotron2_tpu_torch.text import text_to_sequence
from tacotron2_tpu_torch.training.checkpoint import state_dict_of
from tacotron2_tpu_torch.training.trainer import Trainer

SERVE = Tacotron2Config(
    symbols_embedding_dim=16, encoder_embedding_dim=16, decoder_rnn_dim=24,
    prenet_dim=8, attention_rnn_dim=24, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=5,
    postnet_embedding_dim=8, n_mel_channels=6, text_buckets=(16, 32, 48),
    compute_dtype="float32", max_decoder_steps=40)
TRAIN = Tacotron2Config(
    symbols_embedding_dim=16, encoder_embedding_dim=16,
    encoder_n_convolutions=2, attention_rnn_dim=24, decoder_rnn_dim=16,
    prenet_dim=8, attention_dim=12, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=16,
    postnet_n_convolutions=3, max_decoder_steps=20, n_mel_channels=16,
    iters_per_checkpoint=1000, log_interval=1, batch_size=2,
    text_buckets=(16, 32, 64), mel_bucket_step=32, max_mel_length=96)
TEXTS = ["Hello world.", "Short, sweet.", "It is 9 a.m.", "A cat sat.",
         "Dogs bark.", "Yes.", "Two birds."]
MAX_STEPS = 150     # three decoder chunks of at most 64 steps
WAIT_MS = 200.0     # the synthesizer's max_wait_ms
APART_S = 0.03      # the second request of the first batch comes this late


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(body, tmp):
    """Run ``body`` under ``torch.profiler`` recording every thread's
    activity; the trace's events."""
    prof = profile(acc_events=True, activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    try:
        body()
    finally:
        prof.stop()
    path = os.path.join(str(tmp), "window.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def spans(events, name):
    """(start, end, fields, thread) of every span ``name``, by start."""
    out = []
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            parts = e["name"].split(":")
            if parts[:2] == ["tt2", name]:
                out.append((e["ts"], e["ts"] + e["dur"], parts[2:],
                            e["tid"]))
    return sorted(out)


def model(gate_bias):
    """Seeded weights and a stop gate that never fires (a large negative
    bias) or fires at once (a large positive one)."""
    torch.manual_seed(0)
    m = tm.Tacotron2(SERVE)
    gate = m.decoder.gate_layer.linear_layer
    with torch.no_grad():
        gate.weight.zero_()
        gate.bias.fill_(gate_bias)
    return m


# --------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """Three batches: requests A and B ``APART_S`` apart (one batch,
    closed ``WAIT_MS`` after B), then C alone, then D to G at once (a full
    batch, closed as it fills). C also went through untraced first."""
    tmp = tmp_path_factory.mktemp("serving")
    synth = BatchingSynthesizer(model(-30.0), SERVE, max_batch=4,
                                max_wait_ms=WAIT_MS, max_steps=MAX_STEPS,
                                device="cpu")
    got = {}
    try:
        got["untraced"] = synth.submit(TEXTS[2]).result()

        def body():
            a = synth.submit(TEXTS[0])
            time.sleep(APART_S)
            b = synth.submit(TEXTS[1])
            a.result(), b.result()
            got["traced"] = synth.submit(TEXTS[2]).result()
            for f in [synth.submit(t) for t in TEXTS[3:]]:
                f.result()

        events = traced(body, tmp)
    finally:
        worker = synth._worker
        synth.close()
    return events, worker, got


def test_serving_spans_run_on_the_worker_thread(serving):
    events, worker, _ = serving
    for name in ("serve.collect", "serve.batch", "decoder.chunk",
                 "serve.to_host"):
        assert {s[3] for s in spans(events, name)} == {worker.native_id}, \
            name
    assert [len(spans(events, n)) for n in
            ("serve.collect", "serve.batch", "serve.to_host")] == [3, 3, 3]


def test_serving_spans_nest_in_their_batch(serving):
    """Each batch: its gathering, then its span holding three chunks of
    64, 64 and 22 steps, the first launched with no latch to read and the
    other two ahead of the read of the chunk before, and, after them, one
    copy to the host."""
    events, _, _ = serving
    collect = spans(events, "serve.collect")
    chunks = spans(events, "decoder.chunk")
    to_host = spans(events, "serve.to_host")
    for i, (b0, b1, _, _) in enumerate(spans(events, "serve.batch")):
        assert collect[i][1] <= b0
        inside = [c for c in chunks if b0 <= c[0] and c[1] <= b1]
        assert [c[2] for c in inside] == [["64", "0"], ["64", "1"],
                                          ["22", "1"]]
        assert [h for h in to_host if b0 <= h[0] and h[1] <= b1] \
            == [to_host[i]]
        assert inside[-1][1] <= to_host[i][0]
    assert len(chunks) == 9


def test_serving_queue_waits(serving):
    """Rows, and the waits from submit to the batch closed, summed: A
    waited the gap to B and then ``WAIT_MS``, B at least ``WAIT_MS``, C at
    least ``WAIT_MS`` alone; the first request's wait covers its
    batch's gathering."""
    events, _, _ = serving
    (_, _, f1, _), (_, _, f2, _), _ = spans(events, "serve.batch")
    (c1, d1, _, _), (c2, d2, _, _), _ = spans(events, "serve.collect")
    assert [int(f1[0]), int(f2[0])] == [2, 1]
    sum1, sum2 = int(f1[1]), int(f2[1])
    assert sum1 >= (APART_S + 2 * WAIT_MS / 1e3) * 1e6
    assert sum1 - WAIT_MS * 1e3 >= d1 - c1 >= WAIT_MS * 1e3
    assert sum2 + 1 >= d2 - c2 >= WAIT_MS * 1e3


def test_full_batch_closes_without_waiting(serving):
    """Four requests at once fill the batch: it closes as the last one is
    taken, well before ``WAIT_MS``, and each waited less than that."""
    events, _, _ = serving
    *_, (_, _, f, _) = spans(events, "serve.batch")
    *_, (c0, c1, _, _) = spans(events, "serve.collect")
    assert int(f[0]) == 4
    assert c1 - c0 < WAIT_MS * 1e3 / 2
    assert int(f[1]) < 4 * WAIT_MS * 1e3 / 2


def test_serving_traced_computes_what_untraced_does(serving):
    """C alone, traced and untraced: the same frames, alignment and
    length."""
    _, _, got = serving
    (mel, align, n), (mel0, align0, n0) = got["traced"], got["untraced"]
    assert n == n0 == MAX_STEPS
    np.testing.assert_array_equal(mel, mel0)
    np.testing.assert_array_equal(align, align0)


def test_decoder_chunk_holding_only_the_stop(tmp_path):
    """A gate that fires at the first step: the first chunk runs, the
    second is launched ahead of the first's latch read, which stops the
    loop, and is dropped; nothing of the decoder runs after it."""
    ids = np.zeros((2, 16), np.int32)
    lengths = np.zeros((2,), np.int32)
    for i, t in enumerate(TEXTS[:2]):
        seq = text_to_sequence(t, SERVE.text_cleaners)
        ids[i, :len(seq)] = seq
        lengths[i] = len(seq)
    out = {}

    def body():
        out["res"] = tm.infer_batch_fused(
            model(30.0), torch.from_numpy(ids), torch.from_numpy(lengths),
            SERVE, max_steps=MAX_STEPS, device="cpu")

    discarded = db._autoregressive.discarded
    events = traced(body, tmp_path)
    chunks = spans(events, "decoder.chunk")
    assert [c[2] for c in chunks] == [["64", "0"], ["64", "1"]]
    assert db._autoregressive.discarded - discarded == 1
    assert out["res"].mel_lengths.tolist() == [1, 1]
    # each chunk's products inside its span, none after the stop

    def products(t0, t1):
        return [e["name"] for e in events if e.get("cat") == "cpu_op"
                and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1
                and ("mm" in e["name"] or "linear" in e["name"])]

    assert products(*chunks[0][:2]) and products(*chunks[1][:2])
    assert not products(chunks[1][1], float("inf"))


# --------------------------------------------------------------- vocoder

HG = th.HiFiGANConfig(n_mel_channels=6, upsample_rates=(4, 4),
                      upsample_kernel_sizes=(8, 8),
                      upsample_initial_channel=16,
                      resblock_kernel_sizes=(3, 5),
                      resblock_dilation_sizes=((1, 3), (1, 3)))
VOC_FRAMES = (13, 16)  # bucket_step 8: buckets of 16 and 16


def vocoder_runner():
    gen = th.Generator(HG, torch.Generator().manual_seed(4))
    return VocoderRunner("hifigan", gen, HG, max_frames=32, bucket_step=8,
                         device="cpu")


def voc_mels():
    rng = np.random.RandomState(8)
    return [rng.randn(n, 6).astype(np.float32) for n in VOC_FRAMES]


@pytest.fixture(scope="module")
def vocoding(tmp_path_factory):
    """Two mels submitted at once to one ``VocoderRunner``, traced, and
    the same two untraced. The runner's thread is held until both are
    submitted, so that each waits from before the first call starts,
    however the threads are scheduled."""
    runner = vocoder_runner()
    untraced = [runner(m) for m in voc_mels()]
    got = {}

    def body():
        hold = threading.Event()
        held = runner._worker.submit(hold.wait)
        futures = [runner.submit(m) for m in voc_mels()]
        hold.set()
        held.result()
        got["traced"] = [f.result() for f in futures]
    events = traced(body, tmp_path_factory.mktemp("vocoding"))
    worker = {t.native_id for t in runner._worker._threads}
    return events, worker, got["traced"], untraced


def test_vocoder_spans_on_the_runner_thread(vocoding):
    """One ``vocoder.vocode`` a mel on the runner's thread, its fields
    the frames, the bucket's frames and the wait from submit (the second
    mel, submitted before the first call started, waited out that call),
    holding one ``vocoder.to_host`` after the generator's convolutions."""
    events, worker, _, _ = vocoding
    calls = spans(events, "vocoder.vocode")
    to_host = spans(events, "vocoder.to_host")
    assert len(calls) == len(to_host) == 2
    assert {s[3] for s in calls + to_host} == worker
    assert [c[2][:2] for c in calls] == [["13", "16"], ["16", "16"]]
    (a0, a1, fa, _), (b0, _, fb, _) = calls
    assert int(fb[2]) >= (a1 - a0) > 0 and int(fa[2]) >= 0
    convs = [e["ts"] for e in events if e.get("cat") == "cpu_op"
             and "conv" in e["name"]]
    for (c0, c1, _, _), (h0, h1, f, _) in zip(calls, to_host):
        assert c0 <= h0 < h1 <= c1 and f == []
        assert any(c0 <= t < h0 for t in convs)


def test_vocoder_traced_computes_what_untraced_does(vocoding):
    _, _, traced_audio, untraced = vocoding
    for a, b in zip(traced_audio, untraced):
        np.testing.assert_array_equal(a, b)


def test_vocoder_spans_cost_nothing_without_a_profiler(monkeypatch):
    """No profiler: a submit opens no ``record_function`` on either
    thread."""
    def refuse(*args, **kw):
        raise AssertionError("record_function called with no profiler")
    runner = vocoder_runner()
    mel = voc_mels()[0]
    want = runner(mel)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    np.testing.assert_array_equal(runner.submit(mel).result(), want)


# -------------------------------------------------------------- training

def corpus(root, n=4):
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        wav = (rng.randn(4096 + 1024 * i) * 2000).astype(np.int16)
        path = root / f"utt{i}.wav"
        scipy.io.wavfile.write(path, 22050, wav)
        lines.append(f"{path}|utterance number {i} for training")
    filelist = root / "list.txt"
    filelist.write_text("\n".join(lines))
    return str(filelist)


def pipeline(filelist):
    return tdata.DataPipeline(tdata.TextMelDataset(filelist, TRAIN), TRAIN,
                              batch_size=2, drop_last=True, process_index=0,
                              process_count=1)


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    """Four steps of a small ``Trainer.fit``, the last three traced, and
    the same four steps untraced."""
    tmp = tmp_path_factory.mktemp("training")
    filelist = corpus(tmp)
    trainer = Trainer(TRAIN, str(tmp / "traced"), device="cpu")
    trainer.fit(pipeline(filelist), epochs=100, max_steps=1)
    events = traced(lambda: trainer.fit(pipeline(filelist), epochs=100,
                                        max_steps=4), tmp)
    plain = Trainer(TRAIN, str(tmp / "plain"), device="cpu")
    plain.fit(pipeline(filelist), epochs=100, max_steps=4)
    return events, trainer, plain


def test_training_step_spans_nest(training):
    """One ``train.step`` a step, on the thread that called ``fit``,
    holding one ``train.grads`` and, after it, one ``train.update``."""
    events, _, _ = training
    steps = spans(events, "train.step")
    grads = spans(events, "train.grads")
    update = spans(events, "train.update")
    assert len(steps) == len(grads) == len(update) == 3
    for (s0, s1, f, _), (g0, g1, _, _), (u0, u1, _, _) in zip(
            steps, grads, update):
        assert s0 <= g0 < g1 <= u0 < u1 <= s1 and f == []
    assert {s[3] for s in steps + grads + update} \
        == {threading.get_native_id()}


def test_training_traced_computes_what_untraced_does(training):
    """Four steps with the last three traced leave the state that four
    untraced steps leave, bit for bit."""
    _, trainer, plain = training
    a, b = state_dict_of(trainer.state), state_dict_of(plain.state)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(trainer.state.step) == int(plain.state.step) == 4
