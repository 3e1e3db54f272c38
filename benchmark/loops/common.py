"""What the loops share: the run's context, synchronisation, the
comparison of a reading with its limit."""

from __future__ import annotations

import dataclasses
import gc
import math
from typing import Dict, List, NamedTuple, Optional

import torch


@dataclasses.dataclass
class Run:
    """A cell's run: its parameters and where it may write."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict      # the configuration file's contents
    traffic: dict     # the traffic file's contents
    limits: dict      # {number: limit} of the cell's comparison
    device: torch.device
    scratch: str      # a directory of this run's own, under TMPDIR
    t_start: float    # the run's start on the host clock
    faults: tuple = ()  # faults planted in the timed path (tests only)


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a loop hands back to ``run.py``."""
    metrics: Dict[str, float]          # end-to-end metrics, by name
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    facts: dict                        # what the per-layer readers read
    trace: Optional[object] = None     # trace.Trace of a traced run
    notes: List[str] = dataclasses.field(default_factory=list)
    refused: Optional[str] = None      # why the run gives no result


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def model_config(cfg_file: dict, **overrides):
    """The program's ``Tacotron2Config`` from a configuration file's
    numbers (every key the config knows), with ``overrides``."""
    from tacotron2_tpu_torch.config import Tacotron2Config
    fields = {f.name for f in dataclasses.fields(Tacotron2Config)}
    kw = {k: (tuple(v) if isinstance(v, list) and k != "text_cleaners"
              else v) for k, v in cfg_file.items() if k in fields}
    kw.update(overrides)
    return Tacotron2Config(**kw)


def gap_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| as a share of max |want|."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    d = float((got - want).abs().max())
    return d / scale if scale > 0 else d
