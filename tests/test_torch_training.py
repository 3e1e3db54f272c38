"""The port's training step (tacotron2_tpu_torch/training, the training
forms of models/tacotron2) against the JAX package's, at fp32 on the CPU.

Weights come from the JAX package's ``init_params`` through
``convert.state_dict_from_jax``; batches from the same seeded maker on both
sides. Dropout is off (``generator=None`` here, ``rng=None`` there), which
is the form the two can be compared in; the kernels' dropout is held
against JAX-drawn masks in tests/test_torch_train_scan.py.

Tolerances, each the largest |err| as a share of the field's largest
|value|: 1e-4 for forward values, running statistics and the loss; 1e-3
for gradients (sums over B*T in other orders, and the port's hand-written
backward against the JAX package's) and for the parameters after three
Adam steps (Adam's first step moves every element by about lr whatever
the size of its gradient, so rounding in a small gradient shows); the loss
functions to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _make_batch
from tacotron2_tpu.config import Tacotron2Config as JaxConfig
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.training import loss as jloss
from tacotron2_tpu.training import state as jstate

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.training import loss as tloss
from tacotron2_tpu_torch.training import state as tstate

B, T_IN, T_OUT = 8, 24, 8
DIMS = dict(n_symbols=40, symbols_embedding_dim=128,
            encoder_embedding_dim=128, encoder_n_convolutions=1,
            attention_rnn_dim=128, decoder_rnn_dim=128, prenet_dim=128,
            attention_dim=128, attention_location_n_filters=4,
            attention_location_kernel_size=7, n_mel_channels=16,
            postnet_embedding_dim=32, postnet_n_convolutions=2,
            compute_dtype="float32")
REL_FWD, REL_GRAD, REL_STEPS = 1e-4, 1e-3, 1e-3


def configs(**kw):
    kw = {**DIMS, **kw}
    return JaxConfig(**kw), Tacotron2Config(**kw)


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.array(x, np.float32)


def rel_err(got, want):
    """Largest |err| as a share of the largest |value|, or of 1e-3 when
    that is smaller (as tests/test_train_scan.py): a conv bias right
    before a batchnorm has a gradient that is zero up to rounding."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-3)
    return float(np.abs(got - want).max() / scale)


def assert_close_by_name(got, want, rel):
    bad = {k: e for k in got if (e := rel_err(got[k], want[k])) > rel}
    assert not bad, f"beyond {rel} of the largest value: {bad}"


def setup(r=1, seed=0):
    jcfg, tcfg = configs(n_frames_per_step=r)
    params, stats = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tm.Tacotron2(tcfg, trainable=True)
    model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    jb = _make_batch(jcfg, B=B, T_in=T_IN, T_out=T_OUT, seed=seed)
    tb = tstate.make_batch(tcfg, B, T_IN, T_OUT, seed=seed, device="cpu")
    return jcfg, tcfg, params, stats, model, jb, tb


def param_names(model):
    return [n for n, _ in model.named_parameters()]


def jax_loss_fn(jcfg, stats, jb):
    def loss_fn(params):
        out, new_stats = jm.forward(params, stats, jb.text, jb.text_lengths,
                                    jb.mel, jb.mel_lengths, jcfg,
                                    training=True, rng=None)
        bd = jloss.tacotron2_loss(out, jb.mel, jb.gate_target)
        return bd.total, (new_stats, out)
    return loss_fn


def test_make_batch_matches_jax_maker():
    _, _, _, _, _, jb, tb = setup()
    for name in ("text", "text_lengths", "mel", "gate_target", "mel_lengths"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_matches_jax(weighted):
    r = np.random.RandomState(1)
    mel, post, target = (r.randn(4, 6, 5).astype(np.float32)
                         for _ in range(3))
    gate = (r.randn(4, 6) * 3).astype(np.float32)
    gate_t = (r.rand(4, 6) > 0.5).astype(np.float32)
    rows = np.array([1, 1, 0, 1], np.float32) if weighted else None
    want = jloss.tacotron2_loss(
        jm.ForwardOutput(mel, post, gate, None), target, gate_t,
        row_weights=None if rows is None else jnp.asarray(rows))
    t = torch.from_numpy
    got = tloss.tacotron2_loss(
        tm.ForwardOutput(t(mel), t(post), t(gate), None), t(target),
        t(gate_t), row_weights=None if rows is None else t(rows))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("r", [1, 2])
def test_forward_training_matches_jax(r):
    """``forward(training=True)``: outputs and the new batchnorm running
    statistics."""
    jcfg, tcfg, params, stats, model, jb, tb = setup(r)
    (_, (jstats, jout)) = jax_loss_fn(jcfg, stats, jb)(params)
    out, new_stats = tm.forward(model, tm.bn_stats(model), tb.text,
                                tb.text_lengths, tb.mel, tb.mel_lengths,
                                tcfg, training=True)
    for name, g, w in zip(tm.ForwardOutput._fields, out, jout):
        assert rel_err(g, w) <= REL_FWD, name
    want = state_dict_from_jax(params, jstats, tcfg)
    assert set(new_stats) == {k for k in want if k.endswith(
        ("running_mean", "running_var"))}
    assert_close_by_name(new_stats, want, REL_FWD)


@pytest.mark.parametrize("r", [1, 2])
def test_gradients_match_jax_grad(r):
    """Every parameter's gradient against ``jax.grad``, name by name
    through ``state_dict_from_jax``."""
    jcfg, tcfg, params, stats, model, jb, tb = setup(r)
    jgrads, _ = jax.grad(jax_loss_fn(jcfg, stats, jb), has_aux=True)(params)
    want = state_dict_from_jax(jgrads, stats, tcfg)
    state = tstate.state_for(model, tcfg)
    loss, grads, _, _ = tstate.loss_and_grads(state, tb, tcfg)
    assert set(grads) == set(param_names(model))
    assert_close_by_name(grads, {k: want[k] for k in grads}, REL_GRAD)


def test_three_step_trajectory_matches_jax():
    """Three steps of forward + loss + ``guarded_update`` (clip, decay,
    Adam, lr): the loss and gradient norm of each step, then every
    parameter, Adam moment and running statistic."""
    jcfg, tcfg, params, stats, model, jb, tb = setup()
    tx = jstate.make_optimizer(jcfg)
    js = jstate.TrainState(jnp.zeros((), jnp.int32), params, stats,
                           tx.init(params),
                           jnp.asarray(jcfg.learning_rate, jnp.float32))
    ts_ = tstate.state_for(model, tcfg)
    for step in range(3):
        loss_fn = jax_loss_fn(jcfg, js.stats, jb)
        (jl, (jst, _)), jg = jax.value_and_grad(loss_fn, has_aux=True)(
            js.params)
        js, jnorm, japplied = jstate.guarded_update(js, jg, jst, jl, jcfg)
        ts_, m, _ = tstate.train_step(ts_, tb, tcfg)
        assert rel_err(m.loss, jl) <= REL_FWD, step
        assert rel_err(m.grad_norm, jnorm) <= REL_GRAD, step
        assert float(m.applied) == float(japplied) == 1.0
    want = state_dict_from_jax(js.params, js.stats, tcfg)
    params = dict(model.named_parameters())
    # A conv bias right before a batchnorm has a gradient that is zero up
    # to rounding on both sides, and Adam turns that noise into steps of
    # about lr each: those are held to 2 lr per step, the rest to REL_STEPS.
    noise = [k for k in params if k.endswith(".0.conv.bias")]
    for k in noise:
        err = np.abs(as_np(params[k]) - as_np(want[k])).max()
        assert err <= 2 * 3 * jcfg.learning_rate, (k, err)
    assert_close_by_name({k: v for k, v in params.items() if k not in noise},
                         want, REL_STEPS)
    # the running means carry those biases' noise (a batch mean includes
    # the bias), so they get the same bound; the variances do not
    for k, v in ts_.stats.items():
        if k.endswith("running_mean"):
            err = np.abs(as_np(v) - as_np(want[k])).max()
            assert err <= 2 * 3 * jcfg.learning_rate, (k, err)
    assert_close_by_name({k: v for k, v in ts_.stats.items()
                          if k.endswith("running_var")}, want, REL_FWD)
    adam = js.opt_state[2]
    mu = state_dict_from_jax(adam.mu, js.stats, tcfg)
    assert_close_by_name(ts_.exp_avg, {k: mu[k] for k in ts_.exp_avg},
                         REL_GRAD)
    assert int(ts_.step) == 3 and int(ts_.adam_count) == int(adam.count)


def test_non_finite_batch_skips_the_update():
    """A batch whose loss is NaN: applied 0; parameters, Adam moments, the
    Adam count and the running statistics unchanged; step + 1."""
    _, tcfg, _, _, model, _, tb = setup()
    state = tstate.state_for(model, tcfg)
    state, _, _ = tstate.train_step(state, tb, tcfg)  # non-zero moments
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    mel = tb.mel.clone()
    mel[0, 0, 0] = float("nan")
    bad = tb._replace(mel=mel)
    new, m, _ = tstate.train_step(state, bad, tcfg)
    assert float(m.applied) == 0.0 and not torch.isfinite(m.loss)
    for k, v in model.named_parameters():
        assert torch.equal(v, before[k]), k
    for old, cur in ((state.exp_avg, new.exp_avg),
                     (state.exp_avg_sq, new.exp_avg_sq),
                     (state.stats, new.stats)):
        for k in old:
            assert torch.equal(old[k], cur[k]), k
    assert int(new.adam_count) == int(state.adam_count)
    assert int(new.step) == int(state.step) + 1


def test_eval_step_matches_jax_with_row_weights():
    jcfg, tcfg, params, stats, model, jb, tb = setup()
    rows = np.ones(B, np.float32)
    rows[-2:] = 0.0
    want, _ = jstate.eval_step(
        jstate.TrainState(jnp.zeros((), jnp.int32), params, stats, None,
                          jnp.asarray(1e-3)),
        jb._replace(row_valid=jnp.asarray(rows)), jcfg)
    state = tstate.state_for(model, tcfg)
    got, _ = tstate.eval_step(state, tb._replace(
        row_valid=torch.from_numpy(rows)), tcfg)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= REL_FWD


def test_dropout_step_is_seeded_and_finite():
    """With a generator every dropout is on: the step is finite, and two
    runs from the same seed give the same loss."""
    _, tcfg, _, _, model, _, tb = setup()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    losses = []
    for _ in range(2):
        model.load_state_dict(sd)
        state = tstate.state_for(model, tcfg)
        _, m, _ = tstate.train_step(state, tb, tcfg,
                                    torch.Generator().manual_seed(7))
        losses.append(float(m.loss))
        assert float(m.applied) == 1.0
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


REL_LOSS_A20, REL_GRAD_A20 = 1e-5, 1e-4


def _jax_lstm_keep(jcfg, dec_key, steps, batch):
    """The decoder LSTMs' keep masks as the JAX package's XLA scan draws
    them (``decoder_vjp._step_keep_masks``: step t's key is
    fold_in(fold_in(dec_key, 200), t), then fold_in 0 and 1)."""
    scan_rng = jax.random.fold_in(dec_key, 200)
    att, dec = [], []
    for t in range(steps):
        key_t = jax.random.fold_in(scan_rng, t)
        att.append(jax.random.bernoulli(jax.random.fold_in(key_t, 0),
                                        1.0 - jcfg.p_attention_dropout,
                                        (batch, jcfg.attention_rnn_dim)))
        dec.append(jax.random.bernoulli(jax.random.fold_in(key_t, 1),
                                        1.0 - jcfg.p_decoder_dropout,
                                        (batch, jcfg.decoder_rnn_dim)))
    return tuple(torch.from_numpy(np.stack([np.asarray(k) for k in ks]))
                 for ks in (att, dec))


def test_train_step_at_lstm_widths_not_in_eights(monkeypatch):
    """One training step at attention_rnn_dim=20, decoder_rnn_dim=24 (the
    JAX package's trainer-test widths; the scan kernels pad them to whole
    blocks of 8 units): the loss within 1e-5 and every gradient within
    1e-4 of its largest value against ``jax.grad``, with the two LSTM
    dropouts on the JAX-drawn keep masks and no other dropout (the JAX
    prenet's is turned off here, the port's runs without a generator)."""
    jcfg, tcfg = configs(attention_rnn_dim=20, decoder_rnn_dim=24)
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    model = tm.Tacotron2(tcfg, trainable=True)
    model.load_state_dict(state_dict_from_jax(params, stats, tcfg))
    jb = _make_batch(jcfg, B=B, T_in=T_IN, T_out=T_OUT, seed=0)
    tb = tstate.make_batch(tcfg, B, T_IN, T_OUT, seed=0, device="cpu")
    dec_key = jax.random.PRNGKey(5)
    prenet = jm.prenet_apply
    monkeypatch.setattr(jm, "prenet_apply",
                        lambda p, x, rng, **kw: prenet(p, x, None, **kw))

    def loss_fn(p):
        memory, _ = jm.encode(p, stats, jb.text, jb.text_lengths, jcfg,
                              training=True)
        mel, gate, align = jm.decode_teacher_forced(
            p, memory, jb.text_lengths, jb.mel, jcfg, training=True,
            rng=dec_key)
        residual, _ = jm.postnet_apply(p, stats, mel, jcfg, training=True)
        mel, post, gate = jm.mask_outputs(mel, mel + residual, gate,
                                          jb.mel_lengths)
        return jloss.tacotron2_loss(jm.ForwardOutput(mel, post, gate, align),
                                    jb.mel, jb.gate_target).total

    jl, jg = jax.value_and_grad(loss_fn)(params)
    keep = _jax_lstm_keep(jcfg, dec_key, T_OUT, B)
    assert not keep[0].all() and not keep[1].all()
    # train_step's two halves, the training forward taking the JAX masks
    # (train_step draws its own from a generator): loss_and_grads, then
    # guarded_update
    state = tstate.state_for(model, tcfg)
    params_t = dict(model.named_parameters())
    out, new_stats = tm.forward(model, state.stats, tb.text, tb.text_lengths,
                                tb.mel, tb.mel_lengths, tcfg, training=True,
                                keep=keep)
    loss = tloss.tacotron2_loss(out, tb.mel, tb.gate_target).total
    grads = dict(zip(params_t, torch.autograd.grad(loss,
                                                   list(params_t.values()))))
    assert rel_err(loss, jl) <= REL_LOSS_A20
    want = state_dict_from_jax(jg, stats, tcfg)
    assert set(grads) == set(param_names(model))
    assert_close_by_name(grads, {k: want[k] for k in grads}, REL_GRAD_A20)
    new, _, applied = tstate.guarded_update(state, grads, new_stats,
                                            loss.detach(), tcfg)
    assert float(applied) == 1.0 and int(new.step) == 1
