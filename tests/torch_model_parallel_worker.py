"""One rank of the model-parallel checks of the port
(``tests/test_torch_model_parallel.py`` spawns a group of two ranks and a
group of four, joined by gloo on the CPU).

Usage: python torch_model_parallel_worker.py <rank> <world> <port> <root>

``<root>/spec.json`` (written by the test) holds the configurations, the
batch shape and the corpus; ``<root>/init.pt`` the initial weights (the JAX
package's init, converted). Two ranks run a ``(1, 2)`` mesh, a ``(2, 1)``
mesh and (rank 0) the one-process ``train_step``; four ranks run a
``(2, 2)`` mesh, save its checkpoint, and run ``Trainer.fit`` at ``(2, 2)``
unbroken and resumed. Each part writes its results under ``<root>`` with
the mesh and the rank in the file name. Imports only torch and the port.
"""

import json
import os
import sys

import torch

from torch_parallel_worker import _config, _state


def _tensors(state, metrics=()):
    """Every tensor of a rank's state (the moments as the rank holds them:
    its parts of the sharded leaves) and the steps' metrics."""
    out = {f"param/{k}": v.detach().clone()
           for k, v in state.model.named_parameters()}
    for group in ("stats", "exp_avg", "exp_avg_sq"):
        out.update({f"{group}/{k}": v.clone()
                    for k, v in getattr(state, group).items()})
    if metrics:
        out["loss"] = torch.stack([m.loss for m in metrics])
        out["grad_norm"] = torch.stack([m.grad_norm for m in metrics])
    out["step"] = state.step.clone()
    out["adam_count"] = state.adam_count.clone()
    return out


def steps(spec, init, root, rank, shape):
    """``spec["steps"]`` steps of ``make_train_step`` on a ``shape`` mesh
    on this rank's rows of the spec's batch, no dropout. Returns the
    state."""
    from tacotron2_tpu_torch.parallel import (create_mesh, make_train_step,
                                              replicate_state, shard_batch,
                                              shard_plan, shard_state)
    from tacotron2_tpu_torch.training import state as tstate
    mesh = create_mesh(shape)
    if (mesh.dp_index, mesh.mp_index) != (rank // shape[1], rank % shape[1]):
        raise RuntimeError(f"rank {rank}: mesh {mesh}")
    cfg = _config(spec["dims"])
    batch = tstate.make_batch(cfg, spec["B"], spec["T_in"], spec["T_out"],
                              seed=0, device="cpu")
    state = replicate_state(_state(cfg, init), mesh)
    state = shard_state(state, shard_plan(state.model, mesh))
    step = make_train_step(cfg, mesh)
    local = shard_batch(batch, mesh)
    metrics = []
    for _ in range(spec["steps"]):
        state, m = step(state, local, None)
        metrics.append(m)
    name = "mp{}{}".format(*shape)
    torch.save(_tensors(state, metrics),
               os.path.join(root, f"{name}_{rank}.pt"))
    return state


def one_process(spec, init, root):
    """The port's ``train_step`` in this process alone, on the whole
    batch."""
    from tacotron2_tpu_torch.training import state as tstate
    cfg = _config(spec["dims"])
    batch = tstate.make_batch(cfg, spec["B"], spec["T_in"], spec["T_out"],
                              seed=0, device="cpu")
    state, metrics = _state(cfg, init), []
    for _ in range(spec["steps"]):
        state, m, _ = tstate.train_step(state, batch, cfg)
        metrics.append(m)
    torch.save(_tensors(state, metrics), os.path.join(root, "one_0.pt"))


def trainer(spec, root, rank):
    """``Trainer.fit`` at ``(2, 2)`` (dropout on) for 4 steps with a
    checkpoint every 2, each rank with an output directory of its own;
    then a Trainer resumed from rank 0's step-2 checkpoint for the same 2
    steps."""
    import torch.distributed as dist
    from tacotron2_tpu_torch.data import DataPipeline, TextMelDataset
    from tacotron2_tpu_torch.training.trainer import Trainer
    cfg = _config(spec["trainer"])
    pipe = DataPipeline(TextMelDataset(spec["corpus"], cfg), cfg,
                        process_index=0, process_count=1)
    first = Trainer(cfg, os.path.join(root, f"fit_{rank}"), device="cpu")
    first.fit(pipe, epochs=1 << 30, max_steps=4)
    torch.save(_tensors(first.state), os.path.join(root, f"fit_{rank}.pt"))
    dist.barrier()  # rank 0's checkpoints are written
    resumed = Trainer(cfg, os.path.join(root, f"resumed_{rank}"),
                      checkpoint_path=os.path.join(root, "fit_0",
                                                   "checkpoint_2.pt"),
                      device="cpu")
    resumed.fit(pipe, epochs=1 << 30, max_steps=4)
    torch.save(_tensors(resumed.state),
               os.path.join(root, f"resumed_{rank}.pt"))


def main() -> None:
    rank, world, port, root = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from tacotron2_tpu_torch.parallel import initialize_distributed
    from tacotron2_tpu_torch.training.checkpoint import Checkpointer
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    init = torch.load(os.path.join(root, "init.pt"))
    if world == 2:
        steps(spec, init, root, rank, (1, 2))
        steps(spec, init, root, rank, (2, 1))
        if rank == 0:
            one_process(spec, init, root)
    else:
        state = steps(spec, init, root, rank, (2, 2))
        Checkpointer(os.path.join(root, "ckpt22")).save(state, wait=True)
        trainer(spec, root, rank)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
