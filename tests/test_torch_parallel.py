"""The port's data parallelism (``tacotron2_tpu_torch/parallel``) on two
processes joined by gloo on the CPU, against the port's single-process step
and against the JAX package's data-parallel step.

One spawn of two ranks (``tests/torch_parallel_worker.py``) runs every
multi-process part; the tests read what each rank wrote. fp32, global
B=8, the widths and tolerances of tests/test_torch_training.py, dropout off
(``generator=None`` in the port, ``forward`` patched to ``rng=None`` in the
JAX package, as that file does). The batch statistics are synced across
ranks, as they are over the JAX package's dp-sharded batch
(``tacotron2_tpu/training/state.py:10-14``): the same step with them
unsynced must fail the comparison.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _make_batch
from tacotron2_tpu import parallel as jpar
from tacotron2_tpu.models import tacotron2 as jm
from tacotron2_tpu.training import accumulate as jacc
from tacotron2_tpu.training import state as jstate

from test_torch_trainer import SMALL
from test_torch_training import (DIMS, REL_FWD, REL_GRAD, REL_STEPS, as_np,
                                 configs, rel_err)
from tacotron2_tpu_torch import data as tdata
from tacotron2_tpu_torch.config import Tacotron2Config
from tacotron2_tpu_torch.convert import state_dict_from_jax
from tacotron2_tpu_torch.parallel import (Mesh, create_mesh,
                                          initialize_distributed, local_rows)
from tacotron2_tpu_torch.parallel import mesh as tmesh
from tacotron2_tpu_torch.training import state as tstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 2
B, T_IN, T_OUT = 8, 24, 8
ROW_VALID = [1.0] * 5 + [0.0] * 3
TRAINER = {**SMALL, "batch_size": 4, "epochs": 1}
TIMEOUT_S = 120
STEPS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_ragged_corpus(root, n=16, seed=0):
    """Noise utterances whose texts and lengths spread over the text
    buckets (16, 32, 64) and the mel buckets: a strided shard per rank
    would bucket them differently."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        n_samples = int(rng.randint(8, 90)) * 256
        wav = (rng.randn(n_samples) * 2000).astype(np.int16)
        path = root / f"utt{i}.wav"
        scipy.io.wavfile.write(path, 22050, wav)
        words = " ".join(["ab", "word", "longer"][j % 3]
                         for j in range(int(rng.randint(1, 12))))
        lines.append(f"{path}|{words}")
    filelist = root / "list.txt"
    filelist.write_text("\n".join(lines))
    return str(filelist)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two ranks once; their output directory."""
    root = tmp_path_factory.mktemp("dp")
    jcfg, tcfg = configs()
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    torch.save(state_dict_from_jax(params, stats, tcfg), root / "init.pt")
    spec = dict(dims=DIMS, B=B, T_in=T_IN, T_out=T_OUT, row_valid=ROW_VALID,
                trainer=TRAINER, corpus=write_ragged_corpus(root))
    (root / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), str(root)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:  # on a timeout or any error, no rank outlives it
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return root


def load(root, name, rank=0):
    return torch.load(root / f"{name}_{rank}.pt")


def no_dropout(monkeypatch):
    """The JAX package's forward with rng=None (a test-time patch)."""
    orig = jm.forward
    monkeypatch.setattr(jm, "forward",
                        lambda *a, rng=None, **k: orig(*a, rng=None, **k))


def state_gaps(got, params, stats, mu, steps, lr):
    """Every tensor of a rank's state beyond its tolerance, by name, against
    reference values by reference name (test_torch_training.py's rules: a
    conv bias right before a batchnorm, and so each running mean, within 2
    lr a step, Adam turning its rounding-level gradient into steps of about
    lr; other parameters REL_STEPS, running variances REL_FWD, first
    moments REL_GRAD)."""
    bad = {}

    def check(name, g, w, rel=None, atol=None):
        err = (rel_err(g, w) if rel is not None
               else float(np.abs(as_np(g) - as_np(w)).max()))
        if err > (rel if rel is not None else atol):
            bad[name] = err

    noise = 2 * steps * lr
    for k, w in params.items():
        if k.endswith(".0.conv.bias"):
            check(k, got[f"param/{k}"], w, atol=noise)
        else:
            check(k, got[f"param/{k}"], w, rel=REL_STEPS)
    for k, w in stats.items():
        if k.endswith("running_mean"):
            check(k, got[f"stats/{k}"], w, atol=noise)
        else:
            check(k, got[f"stats/{k}"], w, rel=REL_FWD)
    for k, w in mu.items():
        check(f"exp_avg/{k}", got[f"exp_avg/{k}"], w, rel=REL_GRAD)
    return bad


def metric_gaps(got, losses, norms):
    bad = {}
    for i, (l, n) in enumerate(zip(losses, norms)):
        if rel_err(got["loss"][i], l) > REL_FWD:
            bad[f"loss {i}"] = rel_err(got["loss"][i], l)
        if rel_err(got["grad_norm"][i], n) > REL_GRAD:
            bad[f"grad_norm {i}"] = rel_err(got["grad_norm"][i], n)
    return bad


@pytest.fixture(scope="module")
def jax_dp(ranks):
    """The JAX package's data-parallel step on a (2, 1) mesh of the
    conftest's virtual CPU devices, dropout off, two steps."""
    mp = pytest.MonkeyPatch()
    no_dropout(mp)
    try:
        jcfg, tcfg = configs()
        mesh = jpar.create_mesh((WORLD, 1))
        state = jpar.create_sharded_state(jax.random.PRNGKey(0), jcfg, mesh)
        step = jpar.make_train_step(jcfg, mesh, state)
        jb = _make_batch(jcfg, B=B, T_in=T_IN, T_out=T_OUT, seed=0)
        return _reference(step, state, jb, tcfg)
    finally:
        mp.undo()


def _reference(step, state, jb, tcfg):
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, jb, jax.random.PRNGKey(1))
        losses.append(float(m.loss))
        norms.append(float(m.grad_norm))
    sd = state_dict_from_jax(state.params, state.stats, tcfg)
    mu = state_dict_from_jax(state.opt_state[2].mu, state.stats, tcfg)
    stats = {k: v for k, v in sd.items()
             if k.endswith(("running_mean", "running_var"))}
    params = {k: v for k, v in sd.items() if k not in stats
              and not k.endswith("num_batches_tracked")}
    return losses, norms, params, stats, {k: mu[k] for k in params}


def all_gaps(got, ref, lr):
    losses, norms, params, stats, mu = ref
    return {**metric_gaps(got, losses, norms),
            **state_gaps(got, params, stats, mu, STEPS, lr)}


def test_ranks_hold_equal_states(ranks):
    """Both ranks end every run with the same tensors, bit for bit; with
    batchnorm unsynced, all but the running statistics (each rank's own)."""
    for name in ("synced_micro1", "unsynced_micro1", "synced_micro2"):
        a, b = load(ranks, name, 0), load(ranks, name, 1)
        assert a.keys() == b.keys() and int(a["step"]) == STEPS
        for k in a:
            if name != "unsynced_micro1" or not k.startswith("stats/"):
                assert torch.equal(a[k], b[k]), (name, k)
    a, b = (load(ranks, "unsynced_micro1", r) for r in range(WORLD))
    assert not all(torch.equal(a[k], b[k]) for k in a
                   if k.startswith("stats/"))


def test_two_rank_step_matches_single_process_step(ranks):
    """Two ranks of B=4 against the port's ``train_step`` on B=8."""
    _, tcfg = configs()
    model = tstate.model_lib.Tacotron2(tcfg, trainable=True)
    model.load_state_dict(torch.load(ranks / "init.pt"))
    state = tstate.state_for(model, tcfg)
    batch = tstate.make_batch(tcfg, B, T_IN, T_OUT, seed=0, device="cpu")
    losses, norms = [], []
    for _ in range(STEPS):
        state, m, _ = tstate.train_step(state, batch, tcfg)
        losses.append(float(m.loss))
        norms.append(float(m.grad_norm))
    params = {k: v.detach() for k, v in model.named_parameters()}
    ref = (losses, norms, params, state.stats, state.exp_avg)
    gaps = all_gaps(load(ranks, "synced_micro1"), ref, tcfg.learning_rate)
    assert not gaps, gaps


def test_two_rank_step_matches_jax_data_parallel_step(ranks, jax_dp):
    _, tcfg = configs()
    got = load(ranks, "synced_micro1")
    assert float(got["applied"].min()) == 1.0
    gaps = all_gaps(got, jax_dp, tcfg.learning_rate)
    assert not gaps, gaps


def test_unsynced_batchnorm_fails_the_comparison(ranks, jax_dp):
    """Each rank's own batch statistics (the reference's DDP behaviour) is
    not the JAX package's step: the same comparison must reject it, on the
    running statistics at least."""
    _, tcfg = configs()
    gaps = all_gaps(load(ranks, "unsynced_micro1"), jax_dp,
                    tcfg.learning_rate)
    assert any("running" in k for k in gaps), gaps


def test_two_rank_accumulated_step_matches_jax(ranks, monkeypatch):
    """Two ranks x two micro-batches (each rank's share of each micro-batch
    block, ``local_rows``) against the JAX package's ``accum_train_step``
    on the whole batch."""
    no_dropout(monkeypatch)
    jcfg, tcfg = configs()
    state = jstate.create_train_state(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(lambda s, b, r: jacc.accum_train_step(s, b, r, jcfg, 2))
    jb = _make_batch(jcfg, B=B, T_in=T_IN, T_out=T_OUT, seed=0)
    ref = _reference(step, state, jb, tcfg)
    gaps = all_gaps(load(ranks, "synced_micro2"), ref, tcfg.learning_rate)
    assert not gaps, gaps


def test_two_rank_eval_matches_jax_with_row_weights(ranks):
    """The eval of a batch padded with 3 invalid rows (rank 1 holds all of
    them) combined across ranks: the JAX package's ``eval_step`` on the
    whole batch."""
    jcfg, tcfg = configs()
    params, stats = jm.init_params(jax.random.PRNGKey(0), jcfg)
    jb = _make_batch(jcfg, B=B, T_in=T_IN, T_out=T_OUT, seed=0)
    want, _ = jstate.eval_step(
        jstate.TrainState(jnp.zeros((), jnp.int32), params, stats, None,
                          jnp.asarray(1e-3)),
        jb._replace(row_valid=jnp.asarray(ROW_VALID, jnp.float32)), jcfg)
    got = [load(ranks, "eval", r) for r in range(WORLD)]
    assert torch.equal(got[0], got[1])
    for g, w in zip(got[0], want):
        assert rel_err(g, w) <= REL_FWD


def test_ranks_meet_the_same_buckets_and_steps(ranks):
    """On a ragged corpus both ranks meet the same (T_in, T_out) shapes in
    the same order and count the same steps, and their rows together are
    the single process's batches. Strided shards (one per rank, the
    pipeline's default under a process group) would not."""
    cfg = Tacotron2Config(**TRAINER)
    spec = json.loads((ranks / "spec.json").read_text())
    ds = tdata.TextMelDataset(spec["corpus"], cfg)
    whole = tdata.DataPipeline(ds, cfg, drop_last=False, process_index=0,
                               process_count=1)
    want = list(whole.epoch(0))
    got = [load(ranks, "pipeline", r) for r in range(WORLD)]
    assert len(want) > 1
    for g in got:
        assert g["steps_per_epoch"] == whole.steps_per_epoch() == len(want)
        assert len(g["batches"]) == len(want)
    for w, *parts in zip(want, *(g["batches"] for g in got)):
        for k in ("text", "mel", "row_valid"):
            assert torch.equal(torch.cat([p[k] for p in parts]),
                               getattr(w, k)), k
    strided = [tdata.DataPipeline(ds, cfg, batch_size=2, drop_last=False,
                                  process_index=r, process_count=WORLD)
               for r in range(WORLD)]
    shapes = [[tuple(b.mel.shape[1:2]) + tuple(b.text.shape[1:])
               for b in p.epoch(0)] for p in strided]
    assert shapes[0] != shapes[1]


def test_two_rank_fit_keeps_ranks_equal_and_rank0_writes(ranks):
    """``Trainer.fit`` over an epoch on two ranks: the same parameters and
    statistics on both (the state was replicated, the gradients averaged),
    a checkpoint from rank 0 and nothing at all from rank 1."""
    a, b = load(ranks, "trainer", 0), load(ranks, "trainer", 1)
    assert int(a["step"]) >= 1
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ckpts = [f for f in os.listdir(ranks / "run_0")
             if f.startswith("checkpoint_") and f.endswith(".pt")]
    assert ckpts == [f"checkpoint_{int(a['step'])}.pt"]
    assert not os.path.exists(ranks / "run_1")


def test_initialize_distributed_is_a_noop_without_an_environment(
        monkeypatch):
    for var in tmesh._TORCHRUN_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = create_mesh()
    assert (mesh.dp, mesh.mp, mesh.rank, mesh.group) == (1, 1, 0, None)
    assert create_mesh((1, 1)) == mesh
    # torchrun's environment, all four variables, makes it multi-process
    for var in tmesh._TORCHRUN_ENV_VARS:
        monkeypatch.setenv(var, "1")
    assert tmesh._multiprocess_env()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tmesh.local_device("cuda") == torch.device("cuda", 3)
    assert tmesh.local_device("cuda:0") == torch.device("cuda", 0)
    assert tmesh.local_device("cpu") == torch.device("cpu")


def test_mesh_shapes_are_refused():
    """A shape needs exactly the ranks there are: in one process both
    (1, 2), the model-parallel axis, and (2, 1) need two."""
    for shape in ((1, 2), (2, 1)):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            create_mesh(shape)


def test_local_rows_shard_each_micro_batch_block():
    """P('dp') rows, per micro-batch block: rank r of 2 at B=8 takes rows
    r*4..r*4+3, or with 2 micro-batches its half of each block of 4."""
    rows = lambda r, n: list(local_rows(8, Mesh(2, 1, r, None), n))
    assert rows(0, 1) == [0, 1, 2, 3] and rows(1, 1) == [4, 5, 6, 7]
    assert rows(0, 2) == [0, 1, 4, 5] and rows(1, 2) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="divisible"):
        local_rows(6, Mesh(2, 1, 0, None), 2)


def test_train_cli_under_a_one_rank_torchrun_environment(tmp_path,
                                                          monkeypatch):
    """``python -m tacotron2_tpu_torch.train`` under torchrun's environment
    of one rank (gloo with ``--device cpu``) runs as a one-rank group, its
    collectives included, and writes the checkpoint that the same command
    without that environment writes, bit for bit."""
    from tacotron2_tpu_torch import train
    fl = write_ragged_corpus(tmp_path, n=8, seed=1)
    dims = {k: v for k, v in SMALL.items() if not isinstance(v, tuple)}
    hparams = ",".join([f"{k}={v}" for k, v in dims.items()] + [
        "text_buckets=16+32+64", f"training_files={fl}",
        f"validation_files={fl}", "epochs=1", "batch_size=2",
        "iters_per_checkpoint=2"])
    argv = ["--hparams", hparams, "--device", "cpu"]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tacotron2_tpu_torch.train", "-o",
         str(tmp_path / "ranked"), *argv], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        out = proc.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "Process group: backend gloo, data parallel over 1 rank(s)" in out
    for var in tmesh._TORCHRUN_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["-o", str(tmp_path / "plain"), *argv])
    finally:
        torch.set_num_threads(n)
    assert not torch.distributed.is_initialized()
    names = sorted(f for f in os.listdir(tmp_path / "plain")
                   if f.startswith("checkpoint_") and f.endswith(".pt"))
    assert names and names == sorted(
        f for f in os.listdir(tmp_path / "ranked")
        if f.startswith("checkpoint_") and f.endswith(".pt"))
    a = torch.load(tmp_path / "ranked" / names[-1])
    b = torch.load(tmp_path / "plain" / names[-1])
    assert a["iteration"] == b["iteration"] >= 1
    for k, v in b["state_dict"].items():
        assert torch.equal(a["state_dict"][k], v), k
