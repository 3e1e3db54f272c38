"""The port's dynamic loss scaler (``training/loss_scaler.py``) against the
JAX package's over a sequence of finite and non-finite gradients: the scale
and the count of good steps after each, the unscaled gradients and the
skip flag, equal (powers of two and small integers on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.training import loss_scaler as jls

from tacotron2_tpu_torch.training import loss_scaler as tls

# finite (True) or not, per step: two windows of 3 good steps, overflows
# between them and at the start
SEQUENCE = [False, True, True, True, True, False, True, True, True, True,
            True, True, False, False, True]


def grads(step, finite):
    rng = np.random.RandomState(step)
    g = {"w": rng.randn(3, 4).astype(np.float32) * 2.0 ** 20,
         "b": rng.randn(4).astype(np.float32)}
    if not finite:
        g["b"][step % 4] = np.inf if step % 2 else np.nan
    return g


@pytest.mark.parametrize("window", [3, 1000])
def test_scale_and_count_follow_jax(window):
    js = jls.init_loss_scaler(2.0 ** 16)
    ts = tls.init_loss_scaler(2.0 ** 16, device="cpu")
    for step, finite in enumerate(SEQUENCE):
        g = grads(step, finite)
        jg, jok, js = jls.unscale_and_check(
            js, {k: jnp.asarray(v) for k, v in g.items()},
            scale_window=window)
        tg, tok, ts = tls.unscale_and_check(
            ts, {k: torch.from_numpy(v) for k, v in g.items()},
            scale_window=window)
        assert bool(tok) == bool(jok) == finite, step
        assert float(ts.scale) == float(js.scale), step
        assert int(ts.good_steps) == int(js.good_steps), step
        assert ts.scale.dtype == torch.float32
        assert ts.good_steps.dtype == torch.int32
        for k in g:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
    if window == 3:  # the sequence halved and doubled the scale
        assert float(ts.scale) != 2.0 ** 16


def test_scale_loss_and_apply_or_skip():
    ts = tls.init_loss_scaler(device="cpu")
    assert float(ts.scale) == 2.0 ** 32
    loss = torch.tensor(0.5)
    assert float(tls.scale_loss(ts, loss)) == float(
        jls.scale_loss(jls.init_loss_scaler(), jnp.asarray(0.5)))
    upd = {"w": torch.tensor([1.0, -2.0]), "b": torch.tensor([3.0])}
    kept = tls.apply_or_skip(upd, torch.tensor(True))
    skipped = tls.apply_or_skip(upd, torch.tensor(False))
    for k, v in upd.items():
        want = jls.apply_or_skip({k: jnp.asarray(v.numpy())},
                                 jnp.asarray(True))[k]
        np.testing.assert_array_equal(kept[k].numpy(), np.asarray(want))
        assert torch.equal(skipped[k], torch.zeros_like(v))
    # a non-finite update is zeroed too (the JAX multiplier leaves NaN)
    nan = tls.apply_or_skip({"w": torch.tensor([float("nan")])},
                            torch.tensor(False))
    assert torch.equal(nan["w"], torch.zeros(1))


def test_scaler_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tls.init_loss_scaler()
