"""The port's data path, schedules, diagnostics and metric log against the
JAX package's, on one seeded corpus (int16 wavs written with scipy).

Tolerances: batches, lengths, symbol ids, shuffle order and the sampler's
buckets are equal; a dataset item's mel within 1e-5 of its largest |value|
(numpy on both sides, the same ops); the numpy mel against the port's torch
``audio.mel.mel_spectrogram`` within 1e-4 in the log domain (fp32 products
in another order); schedules within 1e-7 and diagnostics within 1e-6.
"""

import json
import random
import threading
import time

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tacotron2_tpu import data as jdata
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.data import dataset as jdataset
from tacotron2_tpu.text import arpabet as jarpabet
from tacotron2_tpu.text.cmudict import CMUDict as JaxCMUDict
from tacotron2_tpu.training import diagnostics as jdiag
from tacotron2_tpu.training import logging as jlogging
from tacotron2_tpu.training import schedules as jsched

from tacotron2_tpu_torch import data as tdata
from tacotron2_tpu_torch.audio import mel as tmel
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.data import dataset as tdataset
from tacotron2_tpu_torch.text import arpabet as tarpabet
from tacotron2_tpu_torch.text.cmudict import CMUDict
from tacotron2_tpu_torch.training import diagnostics as tdiag
from tacotron2_tpu_torch.training import logging as tlogging
from tacotron2_tpu_torch.training import schedules as tsched

KW = dict(batch_size=2, text_buckets=(16, 32, 64), mel_bucket_step=32,
          max_mel_length=256)
TEXTS = ["hello world.", "the quick brown fox jumps over the lazy dog",
         "a b c.", "testing one two three, testing.",
         "yet another utterance here", "short", "two more words",
         "hello again world"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    kw = {**KW, **kw}
    return JaxConfig(**kw), Tacotron2Config(**kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_corpus")
    rng = np.random.RandomState(0)
    lines = []
    for i, text in enumerate(TEXTS):
        wav = (rng.randn(4096 + 1536 * i) * 3000).astype(np.int16)
        path = root / f"utt{i}.wav"
        scipy.io.wavfile.write(path, 22050, wav)
        lines.append(f"{path}|{text}")
    filelist = root / "filelist.txt"
    filelist.write_text("\n".join(lines))
    return str(filelist)


def _items(seed, n=5, n_mels=4):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 40, rng.randint(3, 12)).astype(np.int32),
             rng.randn(n_mels, rng.randint(5, 30)).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("r", [1, 2, 3])
def test_pad_batch_matches_jax(r):
    items = _items(r)
    got = tdata.pad_batch(items, 16, 29, r)
    want = jdata.pad_batch(items, 16, 29, r)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pad_batch_refuses_to_truncate_text():
    with pytest.raises(ValueError, match="never truncate"):
        tdata.pad_batch(_items(0), 4, 32)


@pytest.mark.parametrize("drop_last", [True, False])
def test_bucket_sampler_matches_jax(drop_last):
    jcfg, tcfg = configs(batch_size=3)
    rng = np.random.RandomState(5)
    lengths = [(int(rng.randint(2, 70)), int(rng.randint(10, 300)))
               for _ in range(40)]
    js = jdata.BucketSampler(lengths, jcfg, drop_last=drop_last)
    ts = tdata.BucketSampler(lengths, tcfg, drop_last=drop_last)
    for seed in (None, 0, 11):
        rj = None if seed is None else np.random.RandomState(seed)
        rt = None if seed is None else np.random.RandomState(seed)
        assert list(ts.batches(rt)) == list(js.batches(rj))
    assert ts.distinct_shapes() == js.distinct_shapes()


def test_dataset_items_match_jax(corpus):
    """Symbol ids, the seeded shuffle order and the mels."""
    jcfg, tcfg = configs()
    jds = jdata.TextMelDataset(corpus, jcfg, use_native=False)
    tds = tdata.TextMelDataset(corpus, tcfg)
    assert tds.entries == jds.entries
    assert len(tds) == len(jds) == len(TEXTS)
    for i in range(len(tds)):
        (ti, tm), (ji, jm) = tds[i], jds[i]
        np.testing.assert_array_equal(ti, ji)
        assert tm.shape == jm.shape and tm.dtype == np.float32
        assert np.abs(tm - jm).max() <= 1e-5 * np.abs(jm).max()


def test_dataset_without_shuffle_keeps_file_order(corpus):
    _, tcfg = configs()
    tds = tdata.TextMelDataset(corpus, tcfg, shuffle=False)
    assert [e[1] for e in tds.entries] == TEXTS


def test_dataset_keeps_computed_mels_within_its_budget(corpus,
                                                      monkeypatch):
    _, tcfg = configs()
    tds = tdata.TextMelDataset(corpus, tcfg, shuffle=False)
    first = tds[0][1]
    assert tds[0][1] is first and not first.flags.writeable
    fresh = tdata.mel_spectrogram_np(
        tdata.load_wav(tds.entries[0][0])[0] / tcfg.max_wav_value,
        tds.mel_config)
    np.testing.assert_array_equal(first, fresh)
    # past the budget a mel is computed anew each time, with the same bytes
    monkeypatch.setattr(tdataset, "MEL_CACHE_BYTES", first.nbytes)
    small = tdata.TextMelDataset(corpus, tcfg, shuffle=False)
    assert small[0][1] is small[0][1]
    again = small[1][1]
    assert small[1][1] is not again
    np.testing.assert_array_equal(small[1][1], again)


def test_native_extractor_is_refused(corpus, monkeypatch, tmp_path):
    """``use_native=True`` without the built library raises (the JAX
    package's semantics); False takes numpy."""
    from tacotron2_tpu_torch.data import native
    _, tcfg = configs()
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "absent.so"))
    with pytest.raises(RuntimeError, match="native/build.sh"):
        tdata.TextMelDataset(corpus, tcfg, use_native=True)
    assert len(tdata.TextMelDataset(corpus, tcfg, use_native=False)) == 8


def test_cached_npy_mels_load(corpus, tmp_path):
    """A ``.npy`` path loads the cached mel, as in the JAX package."""
    jcfg, tcfg = configs()
    mel = np.random.RandomState(3).randn(80, 17).astype(np.float32)
    np.save(tmp_path / "cached.npy", mel)
    fl = tmp_path / "npy.txt"
    fl.write_text(f"{tmp_path / 'cached.npy'}|cached text")
    (ti, tm), (ji, jm) = (tdata.TextMelDataset(str(fl), tcfg)[0],
                          jdata.TextMelDataset(str(fl), jcfg,
                                               use_native=False)[0])
    np.testing.assert_array_equal(tm, mel)
    np.testing.assert_array_equal(ti, ji)
    assert (tdataset.item_lengths([str(tmp_path / "cached.npy"), "cached"],
                                  tcfg)
            == jdataset.item_lengths([str(tmp_path / "cached.npy"),
                                      "cached"], jcfg))


@pytest.mark.parametrize("n_samples", [2048, 22050, 30001])
def test_mel_spectrogram_np_matches_port_mel(n_samples):
    _, tcfg = configs()
    mcfg = tmel.MelConfig.from_config(tcfg)
    y = (np.random.RandomState(n_samples).randn(n_samples) * 0.3).astype(
        np.float32)
    got = tdata.mel_spectrogram_np(y, mcfg)
    want = tmel.mel_spectrogram(torch.from_numpy(y)[None], mcfg)[0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_item_lengths_and_wav_num_samples_match_jax(corpus):
    jcfg, tcfg = configs()
    for entry in tdataset.load_filelist(corpus):
        n = tdataset.wav_num_samples(entry[0])
        assert n == jdataset.wav_num_samples(entry[0])
        assert n == len(scipy.io.wavfile.read(entry[0])[1])
        assert (tdataset.item_lengths(entry, tcfg)
                == jdataset.item_lengths(entry, jcfg))


def _pipelines(corpus, drop_last, batch_size):
    jcfg, tcfg = configs()
    common = dict(batch_size=batch_size, drop_last=drop_last,
                  process_index=0, process_count=1)
    jp = jdata.DataPipeline(
        jdata.TextMelDataset(corpus, jcfg, use_native=False), jcfg,
        num_workers=2, **common)
    tp = tdata.DataPipeline(tdata.TextMelDataset(corpus, tcfg), tcfg,
                            **common)
    return jp, tp


@pytest.mark.parametrize("drop_last,batch_size", [(True, 2), (False, 3)])
def test_pipeline_epochs_match_jax(corpus, drop_last, batch_size):
    """Two epochs, field by field; without drop_last a partial bucket is
    cycled to the batch size and its duplicates marked in row_valid."""
    jp, tp = _pipelines(corpus, drop_last, batch_size)
    assert tp.lengths == jp.lengths
    assert tp.steps_per_epoch() == jp.steps_per_epoch()
    cycled = 0
    for epoch in (0, 1):
        got, want = list(tp.epoch(epoch)), list(jp.epoch(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for name in g._fields:
                gv, wv = getattr(g, name), getattr(w, name)
                if wv is None:
                    assert gv is None, name
                    continue
                assert isinstance(gv, torch.Tensor) and gv.device.type == "cpu"
                np.testing.assert_array_equal(gv.numpy(), np.asarray(wv),
                                              err_msg=name)
            cycled += int((g.row_valid == 0).sum())
    assert (cycled > 0) == (not drop_last)


def test_pipeline_skip_leaves_out_the_first_batches(corpus):
    _, tp = _pipelines(corpus, False, 2)
    full = list(tp.epoch(1))
    rest = list(tp.epoch(1, skip=2))
    assert len(rest) == len(full) - 2
    for g, w in zip(rest, full[2:]):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_pipeline_shards_by_process(corpus):
    _, tcfg = configs()
    ds = tdata.TextMelDataset(corpus, tcfg)
    parts = [tdata.DataPipeline(ds, tcfg, process_index=i, process_count=3)
             for i in range(3)]
    assert sorted(i for p in parts for i in p.indices) == list(range(8))
    assert tdata.DataPipeline(ds, tcfg).indices == list(range(8))


def test_prefetch_keeps_order():
    got = list(tdata.prefetch(iter(range(50)), depth=3,
                              transfer=lambda x: x * 2))
    assert got == [2 * i for i in range(50)]


def test_prefetch_reraises_a_workers_error():
    def items():
        yield 1
        yield 2
        raise OSError("disk gone")
    it = tdata.prefetch(items(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_prefetch_releases_its_producer_when_the_consumer_stops():
    """A consumer that stops early leaves no producer thread blocked on a
    full queue."""
    before = set(threading.enumerate())
    it = tdata.prefetch(iter(range(1000)), depth=1)
    assert next(it) == 0
    new = lambda: [t for t in threading.enumerate()
                   if t not in before and t.is_alive()]
    assert new()  # the producer
    it.close()
    deadline = time.time() + 10
    while new() and time.time() < deadline:
        time.sleep(0.01)
    assert not new()


SCHEDULES = {
    "constant": lambda m: m.constant(1e-3),
    "exponential": lambda m: m.exponential_decay(1e-3, 0.5, 100),
    "staircase": lambda m: m.exponential_decay(1e-3, 0.5, 100,
                                               staircase=True, min_lr=2e-4),
    "warmup": lambda m: m.warmup_exponential(1e-3, 50, 0.5, 200, 1e-5),
    "piecewise": lambda m: m.piecewise([(0, 1e-3), (100, 5e-4),
                                        (300, 1e-4)]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    got, want = SCHEDULES[name](tsched), SCHEDULES[name](jsched)
    for step in (0, 1, 49, 50, 99, 100, 101, 250, 299, 300, 1000, 10000):
        assert abs(got(step) - want(step)) <= 1e-7, step


def _alignment_case(seed):
    rng = np.random.RandomState(seed)
    B, T_out, T_in = 4, 20, 9
    a = rng.rand(B, T_out, T_in).astype(np.float32) ** 4
    a /= a.sum(-1, keepdims=True)
    return (a, np.array([9, 5, 7, 1], np.int32),
            np.array([20, 12, 0, 6], np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_alignment_diagnostics_match_jax(seed):
    a, tl, ml = _alignment_case(seed)
    got = tdiag.alignment_diagnostics(a, tl, ml)
    want = jdiag.alignment_diagnostics(a, tl, ml)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_gate_accuracy_matches_jax():
    rng = np.random.RandomState(4)
    energies = (rng.randn(4, 20) * 3).astype(np.float32)
    targets = (rng.rand(4, 20) > 0.6).astype(np.float32)
    lengths = np.array([20, 7, 0, 13], np.int32)
    got = tdiag.gate_accuracy(energies, targets, lengths)
    want = jdiag.gate_accuracy(energies, targets, lengths)
    assert got.keys() == want.keys()
    assert abs(got["gate/accuracy"] - want["gate/accuracy"]) <= 1e-6


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metric_logger_jsonl_keys_match_jax(tmp_path):
    """The same calls write records with the same keys and values (the
    time stamp aside); a tensor batch and output are accepted."""
    records = {}
    for name, mod in (("jax", jlogging), ("torch", tlogging)):
        log = mod.MetricLogger(str(tmp_path / name))
        if log.writer is not None:  # the JSONL mirror alone
            log.writer.close()
            log.writer = None
        log.log_training(10, 1.5, 0.7, 1e-3, 0.2, mel_frames=512)
        log.log_training(20, 1.25, 0.5, 1e-3, 0.0)
        log.log_validation(20, 1.1)
        log.write_scalars(20, {"alignment/sharpness": 0.5})
        log.close()
        records[name] = _jsonl(tmp_path / name / "metrics.jsonl")
    assert len(records["torch"]) == len(records["jax"]) == 4
    for g, w in zip(records["torch"], records["jax"]):
        assert g.keys() == w.keys()
        g.pop("time"), w.pop("time")
        assert g == pytest.approx(w, rel=1e-12)


def test_metric_logger_disabled_writes_nothing(tmp_path):
    log = tlogging.MetricLogger(str(tmp_path / "off"), enabled=False)
    log.log_training(1, 1.0, 1.0, 1e-3, 0.1)
    log.close()
    assert not (tmp_path / "off").exists()


CMUDICT_DATA = ("HELLO  HH AH0 L OW1\nWORLD  W ER1 L D\nTHE  DH AH0\n"
                "TWO  T UW1\n")


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_encode_mixed_matches_jax(tmp_path, p):
    path = tmp_path / "cmudict.txt"
    path.write_text(CMUDICT_DATA)
    text = "Hello world, the two of us said hello 42 times."
    got = tarpabet.encode_mixed(text, ["english_cleaners"],
                                CMUDict(str(path)), random.Random(3), p)
    want = jarpabet.encode_mixed(text, ["english_cleaners"],
                                 JaxCMUDict(str(path)), random.Random(3), p)
    assert got == want
    assert (tarpabet.words_to_arpabet(text, CMUDict(str(path)),
                                      random.Random(9), p)
            == jarpabet.words_to_arpabet(text, JaxCMUDict(str(path)),
                                         random.Random(9), p))


def test_dataset_with_arpabet_matches_jax(corpus, tmp_path):
    path = tmp_path / "cmudict.txt"
    path.write_text(CMUDICT_DATA)
    jcfg, tcfg = configs(p_arpabet=0.5, cmudict_path=str(path))
    jds = jdata.TextMelDataset(corpus, jcfg, use_native=False)
    tds = tdata.TextMelDataset(corpus, tcfg)
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds.get_text(tds.entries[i][1]),
                                      jds.get_text(jds.entries[i][1]))
