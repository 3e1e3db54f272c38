"""The port's ``Trainer`` on the CPU, at narrow widths: three steps over the
port pipeline's batches against the JAX package's ``guarded_update`` over
the JAX pipeline's (dropout off; the tolerances of
tests/test_torch_training.py), resume bit for bit with dropout on, fit
then resume, validation invariant to how the set is split into batches,
warm start, the learning-rate schedule, and CUDA by default."""

import glob
import json
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax
import jax.numpy as jnp

from tacotron2_tpu import data as jdata
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.training import loss as jloss
from tacotron2_tpu.training import state as jstate

from test_torch_training import (DIMS, REL_FWD, REL_GRAD, REL_STEPS,
                                 as_np, assert_close_by_name, rel_err)
from tacotron2_tpu_torch import data as tdata
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.training import schedules
from tacotron2_tpu_torch.training import state as tstate
from tacotron2_tpu_torch.training.checkpoint import state_dict_of
from tacotron2_tpu_torch.training.trainer import Trainer

PIPE = dict(batch_size=2, text_buckets=(16, 32, 64), mel_bucket_step=32,
            max_mel_length=96)
SMALL = dict(
    n_symbols=148, symbols_embedding_dim=16, encoder_embedding_dim=16,
    encoder_n_convolutions=2, attention_rnn_dim=24, decoder_rnn_dim=16,
    prenet_dim=8, attention_dim=12, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=16,
    postnet_n_convolutions=3, max_decoder_steps=20, n_mel_channels=16,
    iters_per_checkpoint=1000, epochs=2, log_interval=1, **PIPE)
CFG = Tacotron2Config(**SMALL)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_corpus(root, n, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        wav = (rng.randn(4096 + 1024 * i) * 2000).astype(np.int16)
        path = root / f"utt{i}.wav"
        scipy.io.wavfile.write(path, 22050, wav)
        lines.append(f"{path}|utterance number {i} for training")
    filelist = root / "list.txt"
    filelist.write_text("\n".join(lines))
    return str(filelist)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("trainer_corpus"), 4, 0)


def pipeline(filelist, cfg, batch_size=2, drop_last=True, shuffle=False):
    return tdata.DataPipeline(
        tdata.TextMelDataset(filelist, cfg, shuffle=shuffle), cfg,
        batch_size=batch_size, drop_last=drop_last, process_index=0,
        process_count=1)


def snapshot(trainer):
    s = trainer.state
    out = dict(state_dict_of(s))
    for group in ("exp_avg", "exp_avg_sq"):
        out.update({f"{group}/{k}": v.clone()
                    for k, v in getattr(s, group).items()})
    out.update(step=s.step.clone(), adam_count=s.adam_count.clone(),
               lr=s.learning_rate.clone())
    return out


def assert_identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_three_steps_over_pipeline_batches_match_jax(corpus):
    """Forward, loss, clip, decay, Adam over three batches of each side's
    own pipeline (the same batches, field by field in
    tests/test_torch_data.py), dropout off, fp32."""
    kw = {**DIMS, **PIPE, "n_symbols": 148}  # real text: the full table
    jcfg, tcfg = JaxConfig(**kw), Tacotron2Config(**kw)
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    ts_ = tstate.create_train_state(tcfg, device="cpu")
    ts_.model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    ts_ = tstate.state_for(ts_.model, tcfg)
    js = jstate.TrainState(jnp.zeros((), jnp.int32), params, stats,
                           jstate.make_optimizer(jcfg).init(params),
                           jnp.asarray(jcfg.learning_rate, jnp.float32))
    common = dict(batch_size=2, process_index=0, process_count=1)
    jb = list(jdata.DataPipeline(jdata.TextMelDataset(
        corpus, jcfg, use_native=False), jcfg, num_workers=2,
        **common).epoch(0))
    tb = list(tdata.DataPipeline(tdata.TextMelDataset(corpus, tcfg), tcfg,
                                 **common).epoch(0))
    assert len(tb) == len(jb) == 2
    def loss_fn(p, s, j):
        out, new = jm.forward(p, s, j.text, j.text_lengths, j.mel,
                              j.mel_lengths, jcfg, training=True, rng=None)
        return jloss.tacotron2_loss(out, j.mel, j.gate_target).total, new

    @jax.jit
    def jax_step(js, j):
        (jl, jst), jg = jax.value_and_grad(loss_fn, has_aux=True)(
            js.params, js.stats, j)
        js, jnorm, _ = jstate.guarded_update(js, jg, jst, jl, jcfg)
        return js, jl, jnorm

    for step, (j, t) in enumerate([(jb[0], tb[0]), (jb[1], tb[1]),
                                   (jb[0], tb[0])]):
        js, jl, jnorm = jax_step(js, j._replace(row_valid=None))
        ts_, m, _ = tstate.train_step(ts_, t, tcfg)
        assert rel_err(m.loss, jl) <= REL_FWD, step
        assert rel_err(m.grad_norm, jnorm) <= REL_GRAD, step
    want = state_dict_from_jax(js.params, js.stats, tcfg)
    params = dict(ts_.model.named_parameters())
    # as tests/test_torch_training.py: a conv bias before a batchnorm has a
    # gradient that is zero up to rounding; Adam turns it into ~lr steps
    noise = [k for k in params if k.endswith(".0.conv.bias")]
    for k in noise:
        assert np.abs(as_np(params[k]) - as_np(want[k])).max() <= \
            2 * 3 * jcfg.learning_rate, k
    assert_close_by_name({k: v for k, v in params.items() if k not in noise},
                         want, REL_STEPS)


def test_resume_is_bit_for_bit(tmp_path, corpus):
    """2 steps, a new Trainer resumed from the checkpoint, 2 more steps:
    the same parameters, statistics, moments and step as 4 steps without a
    break, every dropout on (a generator per step from (seed, step))."""
    cfg = CFG.replace(compute_dtype="float32")
    pipe = pipeline(corpus, cfg)
    assert pipe.steps_per_epoch() == 2
    whole = Trainer(cfg, str(tmp_path / "whole"), device="cpu")
    whole.fit(pipe, epochs=100, max_steps=4)
    first = Trainer(cfg, str(tmp_path / "cut"), device="cpu")
    first.fit(pipe, epochs=100, max_steps=1)  # cut inside epoch 0
    second = Trainer(cfg, str(tmp_path / "cut"), device="cpu")
    assert int(second.state.step) == 1
    second.fit(pipe, epochs=100, max_steps=4)
    assert int(second.state.step) == 4
    assert_identical(snapshot(second), snapshot(whole))
    # and a run without dropout differs: the draws took part
    plain = Trainer(cfg.replace(p_attention_dropout=0.0,
                                p_decoder_dropout=0.0),
                    str(tmp_path / "plain"), device="cpu")
    plain.fit(pipe, epochs=100, max_steps=1)
    assert not torch.equal(snapshot(plain)["embedding.weight"],
                           snapshot(first)["embedding.weight"])


def test_fit_and_resume(tmp_path, corpus):
    """The counterpart of tests/test_trainer.py:test_fit_and_resume."""
    out = str(tmp_path / "run")
    cfg = CFG.replace(iters_per_checkpoint=2)
    trainer = Trainer(cfg, out, device="cpu")
    pipe = pipeline(corpus, cfg)
    val = pipeline(corpus, cfg, drop_last=False)
    state = trainer.fit(pipe, val, epochs=2)
    steps_done = int(state.step)
    assert steps_done == 2 * pipe.steps_per_epoch()
    assert trainer.checkpointer.latest().endswith(f"_{steps_done}.pt")
    assert trainer.last_fit.steps == steps_done
    assert {k for k, _, _ in trainer.shapes_met} == {"train", "val"}
    jsonl = glob.glob(os.path.join(out, "logs", "metrics.jsonl"))
    with open(jsonl[0]) as f:
        records = [json.loads(line) for line in f]
    keys = set().union(*records)
    assert {"training/loss", "validation/loss",
            "alignment/sharpness", "gate/accuracy"} <= keys
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["iters_per_checkpoint"] == 2

    trainer2 = Trainer(cfg, out, device="cpu")
    assert int(trainer2.state.step) == steps_done
    state2 = trainer2.fit(pipe, epochs=3)
    assert int(state2.step) == 3 * pipe.steps_per_epoch()


def test_validation_invariant_to_partitioning(tmp_path_factory):
    """The counterpart of tests/test_trainer.py: cycled padding rows are
    weighted out and batch means combined by real-row count, so the loss
    does not depend on the batch size (a 5-item set forces a cycled partial
    batch at both sizes); with prenet dropout the draws differ, the loss
    stays finite."""
    root = tmp_path_factory.mktemp("val_corpus")
    filelist = write_corpus(root, 5, 1)
    cfg = CFG.replace(eval_prenet_dropout=False)
    trainer = Trainer(cfg, str(root / "run"), device="cpu")
    loss_a = trainer.validate(pipeline(filelist, cfg, 2, False), step=0)
    loss_b = trainer.validate(pipeline(filelist, cfg, 4, False), step=0)
    assert loss_a == pytest.approx(loss_b, rel=1e-5)
    dropout = Trainer(CFG, str(root / "run2"), device="cpu")
    loss_c = dropout.validate(pipeline(filelist, CFG, 2, False), step=3)
    assert np.isfinite(loss_c)
    assert loss_c == dropout.validate(pipeline(filelist, CFG, 2, False),
                                      step=3)


def test_warm_start_keeps_the_fresh_embedding(tmp_path, corpus):
    src = Trainer(CFG, str(tmp_path / "src"), device="cpu")
    src.fit(pipeline(corpus, CFG), epochs=1)
    path = src.checkpointer.latest()
    fresh = Trainer(CFG.replace(seed=99), str(tmp_path / "fresh"),
                    device="cpu")
    warm = Trainer(CFG.replace(seed=99), str(tmp_path / "warm"),
                   warm_start_path=path, device="cpu")
    assert int(warm.state.step) == 0
    got, trained, new = (dict(t.state.model.named_parameters())
                         for t in (warm, src, fresh))
    assert torch.equal(got["embedding.weight"], new["embedding.weight"])
    assert torch.equal(got["decoder.gate_layer.linear_layer.weight"],
                       trained["decoder.gate_layer.linear_layer.weight"])
    for k, v in warm.state.stats.items():
        assert torch.equal(v, src.state.stats[k]), k


def test_learning_rate_schedule_is_applied(tmp_path, corpus):
    trainer = Trainer(CFG, str(tmp_path / "run"), device="cpu")
    sched = schedules.exponential_decay(1e-3, 0.5, 1)
    trainer.fit(pipeline(corpus, CFG), epochs=1, lr_schedule=sched)
    assert float(trainer.state.learning_rate) == pytest.approx(sched(1))
    with open(os.path.join(str(tmp_path / "run"), "logs",
                           "metrics.jsonl")) as f:
        lrs = [json.loads(line)["training/learning_rate"] for line in f]
    assert lrs == pytest.approx([sched(0), sched(1)])


def test_gradient_accumulation_is_refused(tmp_path):
    """A batch that does not split into the micro-batches is refused when
    the Trainer is built (batch_size 2, 3 micro-batches)."""
    with pytest.raises(ValueError, match="divisible"):
        Trainer(CFG.replace(grad_accum_steps=3), str(tmp_path / "run"),
                device="cpu")


def test_trainer_needs_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG, str(tmp_path / "run"))
