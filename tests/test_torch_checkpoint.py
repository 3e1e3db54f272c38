"""The port's checkpoints (training/checkpoint.py) on the CPU, at narrow
widths: the round trip is exact, a save is a snapshot of the state at the
call (the step after it updates the parameters in place), keep-5 garbage
collection, the file's reference format, and warm start."""

import json
import os

import pytest
import torch

from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.training import checkpoint as tckpt
from tacotron2_tpu_torch.training import state as tstate

CFG = Tacotron2Config(
    n_symbols=40, symbols_embedding_dim=16, encoder_embedding_dim=16,
    encoder_n_convolutions=1, attention_rnn_dim=16, decoder_rnn_dim=16,
    prenet_dim=8, attention_dim=8, attention_location_n_filters=2,
    attention_location_kernel_size=5, postnet_embedding_dim=8,
    postnet_n_convolutions=2, n_mel_channels=8, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: faster than many at these small shapes, and it
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh(seed=0):
    return tstate.create_train_state(
        CFG, generator=torch.Generator().manual_seed(seed), device="cpu")


def batch(seed=0):
    return tstate.make_batch(CFG, 3, 7, 6, seed=seed, device="cpu")


def trained(steps=2, seed=0):
    state = fresh(seed)
    for i in range(steps):
        state, _, _ = tstate.train_step(
            state, batch(i), CFG, torch.Generator().manual_seed(i))
    return state


def values(state):
    """Every tensor of the state by name, cloned."""
    out = {f"param/{k}": v.detach().clone()
           for k, v in state.model.named_parameters()}
    for group in ("stats", "exp_avg", "exp_avg_sq"):
        out.update({f"{group}/{k}": v.clone()
                    for k, v in getattr(state, group).items()})
    for name in ("step", "adam_count", "learning_rate"):
        out[name] = getattr(state, name).clone()
    return out


def assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_round_trip_is_exact(tmp_path):
    state = trained(2)
    state = state._replace(learning_rate=torch.tensor(3e-4))
    ckpt = tckpt.Checkpointer(str(tmp_path))
    path = ckpt.save(state, wait=True)
    assert path.endswith("checkpoint_2.pt")
    restored = ckpt.restore(fresh(seed=9))
    assert_same(values(restored), values(state))


def test_save_snapshots_before_the_next_in_place_step(tmp_path):
    """``guarded_update`` writes the parameters in place: the file must
    hold the values at ``save``, not those of the step that follows while
    the write is in flight."""
    state = trained(1)
    before = values(state)
    ckpt = tckpt.Checkpointer(str(tmp_path))
    ckpt.save(state)  # asynchronous
    state, _, _ = tstate.train_step(state, batch(5), CFG)
    ckpt.wait()
    assert not torch.equal(before["param/embedding.weight"],
                           state.model.embedding.weight)
    assert_same(values(ckpt.restore(fresh(seed=3))), before)


def test_file_holds_the_reference_format(tmp_path):
    state = trained(1)
    path = tckpt.Checkpointer(str(tmp_path)).save(state, wait=True)
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"state_dict", "optimizer", "iteration",
                         "learning_rate"}
    assert ckpt["iteration"] == 1
    assert ckpt["learning_rate"] == pytest.approx(CFG.learning_rate)
    assert set(ckpt["optimizer"]) == {"exp_avg", "exp_avg_sq", "adam_count"}
    assert int(ckpt["optimizer"]["adam_count"]) == 1
    # the state_dict loads strictly into the reference module tree, with
    # the running statistics of the state (not the module's stale buffers)
    model = tm.Tacotron2(CFG)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    for k, v in state.stats.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    assert all(t.device.type == "cpu" for t in ckpt["state_dict"].values())
    with open(path + ".json") as f:
        assert json.load(f) == {"step": 1, "learning_rate":
                                pytest.approx(CFG.learning_rate)}
    assert not os.path.exists(path + ".tmp")


def test_latest_and_keep_five(tmp_path):
    state = fresh()
    ckpt = tckpt.Checkpointer(str(tmp_path))
    assert ckpt.latest() is None
    for step in (3, 10, 1, 7, 100, 20, 40):
        ckpt.save(state._replace(step=torch.tensor(step, dtype=torch.int32)))
    ckpt.wait()
    names = [os.path.basename(p) for p in ckpt.all_checkpoints()]
    assert names == [f"checkpoint_{s}.pt" for s in (7, 10, 20, 40, 100)]
    assert ckpt.latest().endswith("checkpoint_100.pt")
    left = sorted(os.listdir(tmp_path))
    assert left == sorted(n + s for n in names for s in ("", ".json"))
    assert int(ckpt.restore(fresh()).step) == 100
    path = os.path.join(str(tmp_path), "checkpoint_20.pt")
    assert int(ckpt.restore(fresh(), path).step) == 20


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.Checkpointer(str(tmp_path / "none")).restore(fresh())


def test_restore_refuses_another_shape(tmp_path):
    tckpt.Checkpointer(str(tmp_path)).save(trained(1), wait=True)
    other = tstate.create_train_state(CFG.replace(prenet_dim=4),
                                      device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        tckpt.Checkpointer(str(tmp_path)).restore(other)


def test_a_failed_write_is_raised_by_wait(tmp_path):
    ckpt = tckpt.Checkpointer(str(tmp_path))
    os.rmdir(tmp_path)  # the write has nowhere to go
    ckpt.save(fresh())
    with pytest.raises(RuntimeError, match="does not exist"):
        ckpt.wait()
    ckpt.wait()  # raised once


@pytest.mark.parametrize("bare", [False, True])
def test_warm_start_skips_ignored_and_missing_keys(tmp_path, bare):
    """The embedding (ignore_layers) keeps its fresh values, a key the file
    lacks keeps its own, the rest load; a bare state_dict loads too."""
    src = trained(1, seed=4)
    path = tckpt.Checkpointer(str(tmp_path)).save(src, wait=True)
    if bare:
        sd = tckpt.load(path)["state_dict"]
        del sd["postnet.convolutions.0.0.conv.bias"]
        sd["not.a.layer"] = torch.zeros(3)
        path = str(tmp_path / "bare.pt")
        torch.save(sd, path)
    dst = fresh(seed=5)
    emb = dst.model.embedding.weight.detach().clone()
    bias = dst.model.postnet.convolutions[0][0].conv.bias.detach().clone()
    loaded = tckpt.warm_start(dst.model, path, ["embedding"])
    assert "embedding.weight" not in loaded
    assert torch.equal(dst.model.embedding.weight, emb)
    want = tckpt.state_dict_of(src)
    for k in loaded:
        assert torch.equal(dst.model.state_dict()[k], want[k]), k
    if bare:
        assert "postnet.convolutions.0.0.conv.bias" not in loaded
        assert torch.equal(dst.model.postnet.convolutions[0][0].conv.bias,
                           bias)
    else:
        assert len(loaded) == len(want) - 1


def test_warm_start_refuses_another_shape(tmp_path):
    path = tckpt.Checkpointer(str(tmp_path)).save(trained(1), wait=True)
    other = tstate.create_train_state(CFG.replace(prenet_dim=4),
                                      device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.warm_start(other.model, path, ["embedding"])
