"""One rank of the two-process data-parallel checks of the port
(``tests/test_torch_parallel.py`` spawns two, joined by gloo on the CPU).

Usage: python torch_parallel_worker.py <rank> <world> <port> <root>

``<root>/spec.json`` (written by the test) holds the configurations, the
batch shape and the corpus; ``<root>/init.pt`` the initial weights (the JAX
package's init, converted). Each part writes its results under ``<root>``
with the rank in the file name; the test compares them with the port's
single-process step and with the JAX package. Imports only torch and the
port.
"""

import json
import os
import sys

import torch


def _config(kw):
    from tacotron2_tpu_torch.config import Tacotron2Config
    return Tacotron2Config(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in kw.items()})


def _state(cfg, init):
    from tacotron2_tpu_torch.models import tacotron2 as tm
    from tacotron2_tpu_torch.training import state as tstate
    model = tm.Tacotron2(cfg, trainable=True)
    model.load_state_dict(init)
    return tstate.state_for(model, cfg)


def _tensors(state, metrics):
    out = {f"param/{k}": v.detach().clone()
           for k, v in state.model.named_parameters()}
    for group in ("stats", "exp_avg"):
        out.update({f"{group}/{k}": v.clone()
                    for k, v in getattr(state, group).items()})
    out["loss"] = torch.stack([m.loss for m in metrics])
    out["grad_norm"] = torch.stack([m.grad_norm for m in metrics])
    out["applied"] = torch.stack([m.applied for m in metrics])
    out["step"] = state.step.clone()
    return out


def steps(spec, init, root, rank, mesh, n_micro):
    """Two data-parallel steps on this rank's rows of the spec's batch, no
    dropout; with batchnorm synced, then with it unsynced (the group
    withheld from ``batchnorm_train``, which must then fail the test's
    comparison)."""
    from tacotron2_tpu_torch.models import tacotron2 as tm
    from tacotron2_tpu_torch.parallel import (make_train_step,
                                              replicate_state, shard_batch)
    from tacotron2_tpu_torch.training import state as tstate
    cfg = _config(spec["dims"]).replace(grad_accum_steps=n_micro)
    batch = tstate.make_batch(cfg, spec["B"], spec["T_in"], spec["T_out"],
                              seed=0, device="cpu")
    local = shard_batch(batch, mesh, n_micro)
    plain = tm.batchnorm_train
    variants = [("synced", plain)]
    if n_micro == 1:
        variants.append(("unsynced", lambda *a, group=None, **k:
                         plain(*a, **k)))
    for name, bn in variants:
        tm.batchnorm_train = bn
        try:
            state = replicate_state(_state(cfg, init), mesh)
            step = make_train_step(cfg, mesh)
            metrics = []
            for _ in range(2):
                state, m = step(state, local, None)
                metrics.append(m)
        finally:
            tm.batchnorm_train = plain
        torch.save(_tensors(state, metrics),
                   os.path.join(root, f"{name}_micro{n_micro}_{rank}.pt"))


def evaluate(spec, init, root, rank, mesh):
    """The data-parallel eval of a batch whose last rows pad it (row_valid
    0), each rank on its rows."""
    from tacotron2_tpu_torch.parallel import make_eval_step, shard_batch
    from tacotron2_tpu_torch.training import state as tstate
    cfg = _config(spec["dims"])
    batch = tstate.make_batch(cfg, spec["B"], spec["T_in"], spec["T_out"],
                              seed=0, device="cpu")
    batch = batch._replace(row_valid=torch.tensor(spec["row_valid"]))
    breakdown, _ = make_eval_step(cfg, mesh)(
        _state(cfg, init), shard_batch(batch, mesh), None)
    torch.save(torch.stack(list(breakdown)),
               os.path.join(root, f"eval_{rank}.pt"))


def pipeline(spec, root, rank, mesh):
    """Every global batch of an epoch of the ragged corpus, this rank's
    rows of each, and the epoch's step count."""
    from tacotron2_tpu_torch.data import DataPipeline, TextMelDataset
    from tacotron2_tpu_torch.parallel import local_rows
    cfg = _config(spec["trainer"])
    pipe = DataPipeline(TextMelDataset(spec["corpus"], cfg), cfg,
                        drop_last=False, process_index=0, process_count=1)
    rows = local_rows(pipe.batch_size, mesh)
    batches = [{k: getattr(b, k) for k in ("text", "mel", "row_valid")}
               for b in pipe.epoch(0, rows=rows)]
    torch.save({"steps_per_epoch": pipe.steps_per_epoch(),
                "batches": batches},
               os.path.join(root, f"pipeline_{rank}.pt"))


def trainer(spec, root, rank):
    """``Trainer.fit`` for one epoch of the ragged corpus, each rank with an
    output directory of its own: only rank 0's may hold a checkpoint. Then
    every parameter and statistic of this rank."""
    from tacotron2_tpu_torch.data import DataPipeline, TextMelDataset
    from tacotron2_tpu_torch.training.trainer import Trainer
    cfg = _config(spec["trainer"])
    out = os.path.join(root, f"run_{rank}")
    run = Trainer(cfg, out, device="cpu")
    pipe = DataPipeline(TextMelDataset(spec["corpus"], cfg), cfg,
                        process_index=0, process_count=1)
    run.fit(pipe, epochs=1)
    state = run.state
    tensors = {f"param/{k}": v.detach().clone()
               for k, v in state.model.named_parameters()}
    tensors.update({f"stats/{k}": v.clone() for k, v in state.stats.items()})
    tensors["step"] = state.step.clone()
    torch.save(tensors, os.path.join(root, f"trainer_{rank}.pt"))


def main() -> None:
    rank, world, port, root = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from tacotron2_tpu_torch.parallel import (create_mesh,
                                              initialize_distributed)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = create_mesh()
    if (mesh.dp, mesh.rank) != (world, rank):
        raise RuntimeError(f"rank {rank} of {world}: mesh {mesh}")
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    init = torch.load(os.path.join(root, "init.pt"))
    steps(spec, init, root, rank, mesh, n_micro=1)
    steps(spec, init, root, rank, mesh, n_micro=2)
    evaluate(spec, init, root, rank, mesh)
    pipeline(spec, root, rank, mesh)
    trainer(spec, root, rank)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
