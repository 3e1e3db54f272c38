"""The controls at a size a test run holds: the reference put in the
program's place in fp8 (the precision below the configuration's bf16)
fails the cell's limits."""

import os

import torch

from benchmark import run as bench_run
from benchmark.loops import serve_open, train
from benchmark.tests import tiny

torch.set_num_threads(2)


def limits(workload):
    return bench_run.load_json(os.path.join(
        bench_run.HERE, "limits", workload + ".json"))["limits"]


def test_training_control_fails(tmp_path):
    c = tiny.config()
    mix = dict(batch=8, utterances=96, frames_per_char=2.0,
               frame_jitter=0.15, mel_mean=-4.0, mel_std=2.0,
               shares={"16": 0.171, "32": 0.602, "48": 0.228})
    r = tiny.run("train-ljspeech-b64", mix, {}, tmp_path, seed=77)
    corpus = train.Corpus(r, mix)
    order = list(range(len(corpus.texts)))
    # three batches of rows alike in bucket, as the sampler makes them
    by = {}
    for i in order:
        key = (next(b for b in c["text_buckets"] if corpus.lengths[i] <= b),
               -(-int(corpus.frames[i]) // c["mel_bucket_step"]))
        by.setdefault(key, []).append(i)
    rows = [v[:8] for v in by.values() if len(v) >= 8][:3]
    want = train.reference_steps(c, r.seed, corpus, rows, r.device)
    low = train.reference_steps(c, r.seed, corpus, rows, r.device, "fp8")
    got = train.compare(low, want)
    lim = limits("train-ljspeech-b64")
    assert any(got[k] > lim[k] for k in lim if k in got), (got, lim)


def test_serving_control_fails():
    c = tiny.config()
    texts = ["the people of the world.", "a house on a hill and a tree.",
             "several things were done."]
    g = torch.Generator().manual_seed(5)
    raw = [torch.randn(40, c["n_mel_channels"], generator=g) * 0.3
           for _ in texts]
    fp32 = serve_open.reference_predictions(c, 5, -30.0, texts, raw, "cpu")
    got = serve_open.reference_gaps(c, 5, -30.0, texts, raw,
                                    [p[1] for p in fp32], "cpu", "fp8",
                                    against=fp32)
    lim = limits("serve-ljspeech-poisson")
    assert any(got[k] > lim[k] for k in lim if k in got), (got, lim)
