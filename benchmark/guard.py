"""The check that a run loaded neither JAX nor the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: ``tacotron2_tpu`` is the JAX package and forbidden,
``tacotron2_tpu_torch`` is the port under test."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "tacotron2_tpu")


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules`` by
    default), sorted."""
    names = list(sys.modules) if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)


# Libraries that load JAX by themselves where they are installed:
# TensorFlow (which tensorboard, behind the trainer's logger, imports when
# it finds it) loads ``jax`` through ``tensorflow.lite``. tensorboard runs
# without it.
LOADERS = ("tensorflow",)


def keep_out() -> None:
    """Make the libraries that would load JAX unimportable in this
    process (unless already loaded)."""
    for name in LOADERS:
        sys.modules.setdefault(name, None)
