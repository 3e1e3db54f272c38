"""The port's model-parallel axis (``parallel/``, mp > 1) on gloo ranks on
the CPU: a group of two ranks (``(1, 2)`` and ``(2, 1)`` meshes, and the
one-process step) and a group of four (a ``(2, 2)`` mesh, its checkpoint,
and ``Trainer.fit`` unbroken and resumed), each spawned once
(``tests/torch_model_parallel_worker.py``), against each other and against
the JAX package's ``(2, 2)`` mesh step.

mp changes where the Adam moments live, not the math: ``(1, 2)`` must equal
one process and ``(2, 2)`` must equal ``(2, 1)`` bit for bit. fp32, global
B=8, the widths of tests/test_torch_training.py, dropout off except in the
Trainer (``generator=None`` in the port, ``forward`` patched to
``rng=None`` in the JAX package).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

from __graft_entry__ import _make_batch
from tacotron2_tpu import parallel as jpar
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.parallel.sharding import _leaf_pspec

from test_torch_parallel import (B, STEPS, T_IN, T_OUT, TRAINER, _free_port,
                                 _reference, no_dropout, rel_err,
                                 write_ragged_corpus)
from test_torch_trainer import SMALL
from test_torch_training import DIMS, configs
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.models import tacotron2 as tm
from tacotron2_tpu_torch.parallel import ShardPlan, shard_dim
from tacotron2_tpu_torch.training import state as tstate
from tacotron2_tpu_torch.training.checkpoint import Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_model_parallel_worker.py")
TIMEOUT_S = 150
MESH_TRAINER = {**TRAINER, "mesh_shape": [2, 2], "iters_per_checkpoint": 2}
# the Trainer tests' widths: 24, 16, 12 and 8 wide layers divide by 2, 3
# and 4 in different ways
WIDTHS = {k: SMALL[k] for k in (
    "n_symbols", "symbols_embedding_dim", "encoder_embedding_dim",
    "encoder_n_convolutions", "attention_rnn_dim", "decoder_rnn_dim",
    "prenet_dim", "attention_dim", "attention_location_n_filters",
    "attention_location_kernel_size", "postnet_embedding_dim",
    "postnet_n_convolutions", "n_mel_channels")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run both groups of ranks once, at the same time; their output
    directory."""
    root = tmp_path_factory.mktemp("mp")
    jcfg, tcfg = configs()
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    torch.save(state_dict_from_jax(params, stats, tcfg), root / "init.pt")
    spec = dict(dims=DIMS, B=B, T_in=T_IN, T_out=T_OUT, steps=STEPS,
                trainer=MESH_TRAINER, corpus=write_ragged_corpus(root))
    (root / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for world in (2, 4):
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(port),
             str(root)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:  # on a timeout or any error, no rank outlives it
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a rank exited {p.returncode}:\n{out}"
    return root


def load(root, name, rank=0):
    return torch.load(root / f"{name}_{rank}.pt")


def plan_for(model, mp, index):
    dims = {}
    for n, p in model.named_parameters():
        d = shard_dim(n, p.shape, mp)
        if d is not None:
            dims[n] = d
    return ShardPlan(dims, index, mp, None)


def dims_model():
    return tm.Tacotron2(Tacotron2Config(**DIMS), trainable=True)


def assert_rank_state(got, whole, mp, index):
    """A rank's tensors against a whole state's, bit for bit: the whole
    parameters and statistics, and part ``index`` of ``mp`` of each
    moment."""
    plan = plan_for(dims_model(), mp, index)
    assert plan.dims
    for k, w in whole.items():
        kind, _, name = k.partition("/")
        want = plan.part(name, w) if kind.startswith("exp_avg") else w
        assert got[k].shape == want.shape, k
        assert torch.equal(got[k], want), k


def test_one_by_two_equals_one_process(ranks):
    """Two ranks of a (1, 2) mesh, each on the whole batch, against
    ``train_step`` in one process: the same losses, parameters and
    statistics, and each rank's parts of the same moments."""
    one = load(ranks, "one")
    for r in range(2):
        assert_rank_state(load(ranks, "mp12", r), one, 2, r)


def test_two_by_two_equals_two_by_one(ranks):
    """mp changes placement, not math: each rank of (2, 2) holds what a
    rank of (2, 1) holds, its moments cut to its mp part."""
    whole = load(ranks, "mp21", 0)
    assert torch.equal(whole["loss"], load(ranks, "mp21", 1)["loss"])
    for r in range(4):
        assert_rank_state(load(ranks, "mp22", r), whole, 2, r % 2)


def test_two_by_two_matches_jax_mesh_step(ranks, monkeypatch):
    """The JAX package's step on a (2, 2) mesh of the conftest's virtual
    CPU devices: each step's loss to rtol 2e-5 (tests/test_parallel.py's
    limit), every parameter after the steps within 1e-4, except a conv
    bias right before a batchnorm (a gradient at the rounding level, which
    Adam turns into steps of about lr either way: 2 lr a step, as
    tests/test_torch_parallel.py holds it)."""
    no_dropout(monkeypatch)
    jcfg, tcfg = configs()
    mesh = jpar.create_mesh((2, 2))
    state = jpar.create_sharded_state(jax.random.PRNGKey(0), jcfg, mesh)
    step = jpar.make_train_step(jcfg, mesh, state)
    jb = _make_batch(jcfg, B=B, T_in=T_IN, T_out=T_OUT, seed=0)
    losses, norms, params, _, _ = _reference(step, state, jb, tcfg)
    got = load(ranks, "mp22", 0)
    np.testing.assert_allclose(got["loss"].numpy(), losses, rtol=2e-5)
    bad = {}
    for k, w in params.items():
        limit = (2 * STEPS * tcfg.learning_rate
                 if k.endswith(".0.conv.bias") else 1e-4)
        gap = float((got[f"param/{k}"] - torch.as_tensor(w)).abs().max())
        if gap > limit:
            bad[k] = gap
    assert not bad, bad
    assert rel_err(got["grad_norm"], norms) <= 1e-3


def test_moment_slices_hold_one_mp_th_of_sharded_leaves(ranks):
    got = load(ranks, "mp22", 3)
    model = dims_model()
    n_sharded = n_parts = 0
    for n, p in model.named_parameters():
        for group in ("exp_avg", "exp_avg_sq"):
            part = got[f"{group}/{n}"]
            if shard_dim(n, p.shape, 2) is None:
                assert part.shape == p.shape, n
            else:
                n_sharded += p.numel()
                n_parts += part.numel()
    assert n_sharded and n_parts * 2 == n_sharded


def test_two_by_two_checkpoint_restores_at_one_by_one(ranks):
    """The (2, 2) checkpoint holds whole moments; one process restores it
    to the (2, 2) state: rank m's parts are part m of what it restored."""
    cfg = Tacotron2Config(**DIMS)
    fresh = tstate.state_for(tm.Tacotron2(cfg, trainable=True), cfg)
    ckpt = Checkpointer(str(ranks / "ckpt22"))
    assert [os.path.basename(p) for p in ckpt.all_checkpoints()] == [
        f"checkpoint_{STEPS}.pt"]
    restored = ckpt.restore(fresh)
    assert restored.shard is None and int(restored.step) == STEPS
    whole = {f"param/{k}": v.detach()
             for k, v in restored.model.named_parameters()}
    for group in ("stats", "exp_avg", "exp_avg_sq"):
        whole.update({f"{group}/{k}": v
                      for k, v in getattr(restored, group).items()})
    for r in range(4):
        got = {k: v for k, v in load(ranks, "mp22", r).items() if k in whole}
        assert_rank_state(got, whole, 2, r % 2)


def test_resumed_two_by_two_trainer_equals_unbroken(ranks):
    """``Trainer.fit`` at (2, 2), dropout on: a Trainer resumed from rank
    0's step-2 checkpoint (whole moments cut to each rank's parts) equals
    the unbroken one bit for bit on every rank; every rank holds the same
    whole parameters; rank 0 alone wrote checkpoints."""
    first = [load(ranks, "fit", r) for r in range(4)]
    for r in range(4):
        resumed = load(ranks, "resumed", r)
        assert int(resumed["step"]) == 4
        for k, v in first[r].items():
            assert torch.equal(resumed[k], v), (r, k)
        for k, v in first[0].items():
            if k.startswith(("param/", "stats/")):
                assert torch.equal(first[r][k], v), (r, k)
    assert os.path.exists(ranks / "fit_0" / "checkpoint_2.pt")
    assert not any(os.path.exists(ranks / f"fit_{r}") for r in (1, 2, 3))


@pytest.mark.parametrize("mp", [2, 3, 4])
def test_shard_dim_follows_leaf_pspec(mp):
    """Every parameter of a converted state at the small widths: a JAX
    leaf filled with its index along its last axis, converted to the
    reference layout, shows which torch dim that axis became. The leaf is
    sharded by ``_leaf_pspec`` exactly when ``shard_dim`` names that dim,
    and part m of it along that dim is JAX's block m of the last axis."""
    jcfg, tcfg = configs(**WIDTHS)
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    leaves, treedef = jax.tree.flatten(params)
    probe = [np.broadcast_to(np.arange(l.shape[-1], dtype=np.float32)
                             + 10000.0 * i, l.shape) if l.ndim else l
             for i, l in enumerate(leaves)]
    sd = state_dict_from_jax(jax.tree.unflatten(treedef, probe), stats, tcfg)
    model = tm.Tacotron2(tcfg, trainable=True)
    n_sharded = 0
    for name, p in model.named_parameters():
        t = torch.as_tensor(np.asarray(sd[name]))
        leaf = leaves[int(t.reshape(-1)[0]) // 10000]
        spec = _leaf_pspec(leaf.shape, mp)
        along = [d for d in range(t.ndim) if t.shape[d] == leaf.shape[-1]
                 and t.ndim > 1 and torch.equal(
                     t.movedim(d, -1).reshape(-1, t.shape[d])[0] % 10000,
                     torch.arange(t.shape[d], dtype=t.dtype))]
        dim = shard_dim(name, tuple(p.shape), mp)
        if spec == jax.sharding.PartitionSpec():
            assert dim is None, (name, leaf.shape)
            continue
        assert dim in along, (name, dim, along)
        n_sharded += 1
        size = t.shape[dim] // mp
        for m in range(mp):
            part = ShardPlan({name: dim}, m, mp, None).part(name, t)
            assert torch.equal(part % 10000, (t % 10000).narrow(
                dim, m * size, size)), (name, m)
            assert int(part.min()) % 10000 == m * size
    assert n_sharded
    # the placement itself: JAX's sharding of such a leaf over a (1, mp)
    # mesh gives mp index m the same block
    mesh = jpar.create_mesh((1, mp))
    name = "decoder.attention_rnn.weight_ih"
    leaf_i = int(torch.as_tensor(np.asarray(sd[name])).reshape(-1)[0]) // 10000
    spec = _leaf_pspec(leaves[leaf_i].shape, mp)
    placed = jax.device_put(probe[leaf_i], NamedSharding(mesh, spec))
    for shard in placed.addressable_shards:
        m = list(mesh.devices.reshape(-1)).index(shard.device)
        assert float(np.asarray(shard.data).min()) % 10000 == (
            m * leaves[leaf_i].shape[-1] // mp)
