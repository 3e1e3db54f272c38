"""Process group and data-parallel layout (the JAX package's
``parallel/mesh.py``).

The JAX package puts its devices on a ``(dp, mp)`` mesh and lets GSPMD
derive the collectives. The port runs one process per card (or several
processes on one card, or CPU processes) joined by a ``torch.distributed``
process group: NCCL between cards, gloo on the CPU. ``Mesh`` records the
``(dp, mp)`` shape over that group, in JAX's order (the ranks reshaped
``(dp, mp)``: rank r is dp index r // mp and mp index r % mp,
``tacotron2_tpu/parallel/mesh.py:create_mesh``), with the two kinds of
subgroup the steps reduce over; ``local_rows`` gives a rank its rows of a
global batch, in the layout of JAX's ``P('dp')``: the mp ranks of one dp
index hold the same rows.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# torchrun's environment: with all four set, this process is one rank of a
# group whose rendezvous is at MASTER_ADDR:MASTER_PORT.
_TORCHRUN_ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _multiprocess_env() -> bool:
    return all(os.environ.get(v) for v in _TORCHRUN_ENV_VARS)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(device: Union[str, torch.device]) -> torch.device:
    """``device``, with a bare ``"cuda"`` made this rank's card
    (``cuda:LOCAL_RANK``) under torchrun's environment."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and _multiprocess_env()):
        return torch.device("cuda", _local_rank())
    return device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Union[str, torch.device] = "cuda"
                           ) -> None:
    """Join the process group: the counterpart of JAX's
    ``jax.distributed.initialize`` (reference train.py:27-39).

    Explicit arguments (``coordinator_address`` as ``host:port``), or
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
    LOCAL_RANK picks the card), make the rendezvous mandatory: a failure
    propagates. With neither this is a single process and a no-op. The
    decision comes from the arguments and the environment only, never from
    a CUDA query, so a multi-process run cannot silently become several
    single-process runs. The backend is NCCL for a CUDA ``device``, gloo
    for the CPU; on CUDA this rank's card is made current first."""
    if dist.is_initialized():
        return
    if coordinator_address is None and not _multiprocess_env():
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else _local_rank())
    explicit = {} if coordinator_address is None else dict(
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            **explicit)


class Mesh(NamedTuple):
    """A ``(dp, mp)`` layout over the default process group. ``group`` is
    every rank, None without a process group: nothing is reduced.
    ``dp_group`` is the ranks with this rank's mp index, which split the
    batch (batch statistics and gradients are reduced over it; None when
    there is one dp index and mp > 1, or without a process group);
    ``mp_group`` the ranks of this rank's dp index, which hold one
    weight's slices (None at mp = 1)."""
    dp: int
    mp: int
    rank: int
    group: Optional[dist.ProcessGroup]
    dp_group: Optional[dist.ProcessGroup] = None
    mp_group: Optional[dist.ProcessGroup] = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp


def create_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one). ``None`` or ``(1, 1)`` (the config's default) puts every rank on
    dp, as the JAX package does. A shape that needs more ranks than exist
    raises ValueError, and so does one that leaves ranks out (each rank is
    a process that must take part in every collective). At mp > 1 every
    rank must call this, with the same shape: each subgroup is made by a
    collective call of all ranks, in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None or tuple(shape) == (1, 1):
        shape = (world, 1)
    dp, mp = shape
    if dp * mp > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {dp * mp} ranks, "
                         f"have {world}")
    if dp * mp < world:
        raise ValueError(f"mesh shape {tuple(shape)} leaves "
                         f"{world - dp * mp} of {world} ranks out")
    if not dist.is_initialized():
        return Mesh(dp, mp, rank, None)
    # an initialised group is used even at one rank, so that a one-rank
    # torchrun runs the collectives it would run at several
    group = dist.group.WORLD
    if mp == 1:
        return Mesh(dp, mp, rank, group, dp_group=group)
    dp_groups = ([dist.new_group([d * mp + m for d in range(dp)])
                  for m in range(mp)] if dp > 1 else None)
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)])
                 for d in range(dp)]
    return Mesh(dp, mp, rank, group,
                dp_group=dp_groups[rank % mp] if dp_groups else None,
                mp_group=mp_groups[rank // mp])


def local_rows(batch_size: int, mesh: Mesh, n_micro: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch_size`` that this rank takes:
    JAX's ``P('dp')`` gives dp index r of W the contiguous rows
    ``[r B/W, (r+1) B/W)``. With ``n_micro`` micro-batches, micro-batch i
    is block i of the global batch (``training/accumulate.py``), so the
    rank takes its contiguous share of each block: B viewed as
    ``(n_micro, W, B / (n_micro W))``, index r of the middle axis. Each
    micro-batch's synced batch statistics are then those of its block."""
    W = mesh.dp
    if batch_size % (W * n_micro):
        raise ValueError(f"batch {batch_size} is not divisible by {W} ranks "
                         f"x {n_micro} micro-batches")
    rows = np.arange(batch_size).reshape(n_micro, W, -1)[:, mesh.dp_index]
    return rows.reshape(-1)


def shard_batch(batch, mesh: Mesh, n_micro: int = 1):
    """This rank's rows (``local_rows``) of every tensor of a global
    ``Batch``."""
    rows = torch.from_numpy(local_rows(batch.text.shape[0], mesh, n_micro))
    return type(batch)(*(None if t is None else t[rows.to(t.device)]
                         for t in batch))
