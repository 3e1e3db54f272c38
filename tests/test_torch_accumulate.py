"""The port's gradient accumulation (``training/accumulate.py``) against
the JAX package's ``accum_train_step``, and in ``Trainer``.

fp32, B=8, the widths and tolerances of tests/test_torch_training.py,
dropout off (``forward`` patched to ``rng=None`` in the JAX package); the
state compared by tests/test_torch_parallel.py's rules.
"""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_batch
from tacotron2_tpu.training import accumulate as jacc
from tacotron2_tpu.training import state as jstate

from test_torch_parallel import _reference, all_gaps, no_dropout
from test_torch_trainer import CFG, corpus, pipeline  # noqa: F401
from test_torch_training import B, T_IN, T_OUT, setup
from tacotron2_tpu_torch.training import state as tstate
from tacotron2_tpu_torch.training.accumulate import accum_train_step
from tacotron2_tpu_torch.training.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_steps(state, batch, cfg, n_micro, steps=2):
    out = []
    for _ in range(steps):
        state, m = accum_train_step(state, batch, cfg, n_micro)
        out.append(m)
    got = {f"param/{k}": v.detach()
           for k, v in state.model.named_parameters()}
    got.update({f"stats/{k}": v for k, v in state.stats.items()})
    got.update({f"exp_avg/{k}": v for k, v in state.exp_avg.items()})
    got["loss"] = torch.stack([m.loss for m in out])
    got["grad_norm"] = torch.stack([m.grad_norm for m in out])
    return state, got


def test_accumulated_steps_match_jax(monkeypatch):
    """Two steps of two micro-batches: losses, gradient norms, every
    parameter, running statistic and first moment."""
    no_dropout(monkeypatch)
    jcfg, tcfg, params, stats, model, jb, tb = setup()
    js = jstate.create_train_state(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(lambda s, b, r: jacc.accum_train_step(s, b, r, jcfg, 2))
    ref = _reference(step, js, jb, tcfg)
    _, got = _port_steps(tstate.state_for(model, tcfg), tb, tcfg, 2)
    gaps = all_gaps(got, ref, tcfg.learning_rate)
    assert not gaps, gaps


def test_one_micro_batch_is_train_step():
    """n_micro=1 with a dropout generator: ``train_step`` bit for bit."""
    _, tcfg, _, _, model, _, tb = setup()
    other = type(model)(tcfg, trainable=True)
    other.load_state_dict(model.state_dict())
    a, b = tstate.state_for(model, tcfg), tstate.state_for(other, tcfg)
    gen = lambda: torch.Generator().manual_seed(5)
    a, ma = accum_train_step(a, tb, tcfg, 1, [gen()])
    b, mb, _ = tstate.train_step(b, tb, tcfg, gen())
    for x, y in zip(ma, mb):
        assert torch.equal(x, y)
    for (k, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), k
    for group in ("stats", "exp_avg", "exp_avg_sq"):
        for k, v in getattr(a, group).items():
            assert torch.equal(v, getattr(b, group)[k]), (group, k)


def test_indivisible_batch_is_refused():
    _, tcfg, _, _, model, _, tb = setup()
    with pytest.raises(ValueError, match="divisible"):
        accum_train_step(tstate.state_for(model, tcfg), tb, tcfg, 3)
    with pytest.raises(ValueError, match="generators"):
        accum_train_step(tstate.state_for(model, tcfg), tb, tcfg, 2,
                         [None])


def test_trainer_accumulates_gradients(tmp_path, corpus):  # noqa: F811
    """``Trainer`` with grad_accum_steps=2 trains (batch_size 2: two
    micro-batches of one row, dropout from one generator each): finite
    steps, every one applied, the parameters moved; the same run again is
    the same bit for bit."""
    cfg = CFG.replace(grad_accum_steps=2)
    runs = []
    for name in ("a", "b"):
        trainer = Trainer(cfg, str(tmp_path / name), device="cpu")
        before = {k: v.detach().clone()
                  for k, v in trainer.state.model.named_parameters()}
        seen = []
        trainer.fit(pipeline(corpus, cfg), epochs=1,
                    on_step=lambda step, m: seen.append(
                        (float(m.loss), float(m.applied))))
        assert len(seen) == int(trainer.state.step) >= 1
        assert all(np.isfinite(l) and a == 1.0 for l, a in seen)
        after = dict(trainer.state.model.named_parameters())
        assert any(not torch.equal(after[k], v) for k, v in before.items())
        runs.append(after)
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k
