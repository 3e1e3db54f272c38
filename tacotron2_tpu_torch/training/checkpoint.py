"""Checkpointing: save / resume / warm-start.

The port's counterpart of the JAX package's ``training/checkpoint.py``,
with the same three modes as the reference (train.py:84-118):

- fresh start;
- resume: restores parameters, batchnorm statistics, the Adam moments and
  count, the step and the learning rate;
- warm start: loads weights only, dropping the layers named in
  ``ignore_layers`` (default: the embedding, for a new symbol set).

Format: ``checkpoint_<step>.pt``, written by ``torch.save`` and read with
``weights_only=True``, holding a dict in the reference's shape:
``state_dict`` (the reference names, the batchnorm running statistics
included, so the file loads into ``models.tacotron2.Tacotron2``),
``optimizer`` (``exp_avg`` and ``exp_avg_sq`` by parameter name and
``adam_count``), ``iteration`` and ``learning_rate``; beside it a JSON
sidecar with ``step`` and ``learning_rate``. Writes go through a ``.tmp``
file and ``os.replace`` on a background thread, one at a time, and only on
process 0.

The vocoder trainers' states (``training/vocoder_trainer.py``,
``training/hifigan_trainer.py``) go to the same files: such a state makes
its own dict (its ``snapshot()``: ``kind`` "waveglow" or "hifigan", the
vocoder's config as a dict under ``config`` and its state_dict under
``state_dict``, the torch optimizers' state, ``iteration``,
``learning_rate``) and loads one back (its
``restored(ckpt)``). A Tacotron 2 checkpoint has no ``kind``.

A model-parallel state (mp > 1, ``parallel/sharding.py``) holds only its
part of some Adam moments: ``save`` gathers the whole moments first, a
collective, so every rank calls it; ``restore`` cuts a whole checkpoint to
the state's parts. A checkpoint thus has one format whatever the mesh, as
the JAX package's does, and restores on any other.

``save`` copies every tensor to host memory before it returns:
``training/state.py:guarded_update`` updates the parameters in place, so a
reference handed to the writer thread would be overwritten by the next
step.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, Iterable, List, Optional

import torch

from tacotron2_tpu_torch.models import tacotron2 as model_lib
from tacotron2_tpu_torch.parallel.sharding import gather_state, shard_state
from tacotron2_tpu_torch.training.state import TrainState

_CKPT_RE = re.compile(r"^checkpoint_(\d+)\.pt$")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that nothing else holds (a CPU tensor is copied too)."""
    return t.detach().to("cpu", copy=True)


def host_tree(obj):
    """``obj`` (dicts, lists and tuples of tensors and plain values, such as
    a module's or an optimizer's ``state_dict()``) with every tensor a host
    copy."""
    if isinstance(obj, torch.Tensor):
        return _host(obj)
    if isinstance(obj, dict):
        return {k: host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_tree(v) for v in obj)
    return obj


def state_dict_of(state: TrainState) -> Dict[str, torch.Tensor]:
    """The model's reference-format state_dict with the state's batchnorm
    running statistics (which live in ``state.stats``, not in the module's
    buffers), as host copies."""
    sd = {k: _host(v) for k, v in state.model.state_dict().items()}
    sd.update({k: _host(v) for k, v in state.stats.items()})
    return sd


def snapshot(state) -> dict:
    """The checkpoint dict of ``state``, every tensor copied to the host
    (a vocoder trainer's state makes its own)."""
    if not isinstance(state, TrainState):
        return state.snapshot()
    return {
        "state_dict": state_dict_of(state),
        "optimizer": {
            "exp_avg": {k: _host(v) for k, v in state.exp_avg.items()},
            "exp_avg_sq": {k: _host(v) for k, v in state.exp_avg_sq.items()},
            "adam_count": _host(state.adam_count),
        },
        "iteration": int(state.step),
        "learning_rate": float(state.learning_rate),
    }


class Checkpointer:
    """Directory of ``checkpoint_<step>.pt`` files with async writes."""

    def __init__(self, directory: str, keep: int = 5):
        from tacotron2_tpu_torch.data.pipeline import process_index_and_count
        self.directory = directory
        self.keep = keep
        self.writes = process_index_and_count()[0] == 0
        self._pending: Optional[threading.Thread] = None
        self._error: List[BaseException] = []
        if self.writes:
            os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------

    def save(self, state, wait: bool = False) -> Optional[str]:
        """Snapshot to host memory now, write in the background. Returns the
        path (on process 0; None elsewhere). Every rank calls it for a
        sharded state (the moments are gathered first)."""
        if isinstance(state, TrainState):
            state = gather_state(state)
        if not self.writes:
            return None
        self.wait()  # one write in flight at a time
        snap = snapshot(state)
        step = snap["iteration"]
        path = os.path.join(self.directory, f"checkpoint_{step}.pt")

        def write():
            try:
                tmp = path + ".tmp"
                torch.save(snap, tmp)
                os.replace(tmp, path)
                meta = {"step": step, "learning_rate": snap["learning_rate"]}
                with open(path + ".json", "w") as f:
                    json.dump(meta, f)
                self._gc()
            except BaseException as e:  # raised by the next wait()
                self._error.append(e)

        self._pending = threading.Thread(target=write, daemon=True)
        self._pending.start()
        if wait:
            self.wait()
        return path

    def wait(self) -> None:
        """Wait for the write in flight; raise its error, if it had one."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error:
            raise self._error.pop()

    def _gc(self) -> None:
        ckpts = self.all_checkpoints()
        for path in ckpts[:-self.keep] if self.keep else []:
            for suffix in ("", ".json"):
                try:
                    os.remove(path + suffix)
                except FileNotFoundError:
                    pass

    # ---------------- restore ----------------

    def all_checkpoints(self) -> List[str]:
        if not os.path.isdir(self.directory):
            return []
        found = []
        for name in os.listdir(self.directory):
            match = _CKPT_RE.match(name)
            if match:
                found.append((int(match.group(1)),
                              os.path.join(self.directory, name)))
        return [p for _, p in sorted(found)]

    def latest(self) -> Optional[str]:
        ckpts = self.all_checkpoints()
        return ckpts[-1] if ckpts else None

    def restore(self, state, path: Optional[str] = None):
        """Full resume into ``state``'s model (loaded in place, strictly)
        on its device: parameters, batchnorm statistics, Adam moments and
        count, step and learning rate (reference load_checkpoint,
        train.py:99-109), the moments cut to ``state``'s shard plan if it
        has one. Returns the restored state. A vocoder trainer's state
        loads its own (``restored``)."""
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        ckpt = load(path)
        if not isinstance(state, TrainState):
            return state.restored(ckpt)
        if "kind" in ckpt:
            raise ValueError(f"{path} holds a {ckpt['kind']} vocoder, not "
                             f"a Tacotron 2")
        model = state.model
        dev = next(model.parameters()).device
        model.load_state_dict(ckpt["state_dict"], strict=True)
        opt = ckpt["optimizer"]
        names = [n for n, _ in model.named_parameters()]
        for key in ("exp_avg", "exp_avg_sq"):
            if set(opt[key]) != set(names):
                raise KeyError(f"checkpoint {key} does not name the model's "
                               f"parameters: {sorted(set(opt[key]) ^ set(names))}")
        moments = {key: {n: opt[key][n].to(dev, torch.float32)
                         for n in names} for key in ("exp_avg", "exp_avg_sq")}
        scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)
        whole = TrainState(
            scalar(ckpt["iteration"], torch.int32), model,
            model_lib.bn_stats(model), moments["exp_avg"],
            moments["exp_avg_sq"], opt["adam_count"].to(dev, torch.int32),
            scalar(ckpt["learning_rate"], torch.float32))
        return shard_state(whole, state.shard)


def load(path: str) -> dict:
    """A checkpoint (or a bare state_dict) read with ``weights_only``."""
    return torch.load(path, map_location="cpu", weights_only=True)


def warm_start(model: model_lib.Tacotron2, path: str,
               ignore_layers: Iterable[str]) -> List[str]:
    """Load weights from a checkpoint, or from a file holding a bare
    reference-format state_dict, into ``model`` in place, skipping every
    key that has a dotted component in ``ignore_layers`` and every key the
    file or the model lacks (reference warm_start_model, train.py:84-96).
    Returns the keys loaded."""
    loaded = load(path)
    loaded = loaded.get("state_dict", loaded)
    ignore = set(ignore_layers)
    own = model.state_dict()
    keys = [k for k in own if k in loaded and not set(k.split(".")) & ignore]
    with torch.no_grad():
        for k in keys:
            if tuple(loaded[k].shape) != tuple(own[k].shape):
                raise ValueError(f"shape mismatch at {k}: file "
                                 f"{tuple(loaded[k].shape)} vs model "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(loaded[k])
    return keys
