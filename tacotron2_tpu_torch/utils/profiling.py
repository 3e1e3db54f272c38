"""Profiling and tracing (the JAX package's ``utils/profiling.py``).

The reference's observability is a per-iteration ``time.perf_counter``
print (reference train.py:209,239-243). Here:

- ``span``: a named range at one of the program's layer boundaries (a
  serving batch, a decoder chunk, a training step and its phases), which
  a running ``torch.profiler`` records beside the card's operations and
  which costs one flag read when none runs;
- ``profile_trace``: a context manager around ``torch.profiler`` that
  writes a trace (host activity, and the card's kernels when there is one)
  which TensorBoard's profile plugin and Perfetto read.
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import ContextManager, Iterator, Optional

import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

SPAN_PREFIX = "tt2:"
_NO_SPAN = contextlib.nullcontext()


def span(name: str, *fields) -> ContextManager:
    """A ``torch.profiler.record_function`` range named
    ``tt2:<name>:<field>:...`` while a profiler runs, else a shared null
    context: a bare ``record_function`` does its work with no profiler
    too. The gate is ``torch.autograd.profiler._is_profiler_enabled``, a
    module flag the profiler sets for the whole process, so it holds on
    every thread of a profiler started with ``profile_all_threads``;
    ``torch._C._autograd._profiler_enabled()`` reads the calling thread's
    state and is False on such a thread. The fields are joined only while
    a profiler runs, so callers pass numbers, not strings built for the
    name. Spans go at batch, chunk, step and phase boundaries, never
    inside a per-step or per-leaf loop."""
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(
        ":".join([SPAN_PREFIX + name, *(str(f) for f in fields)]))


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[profile]:
    """Profile the body: CPU activity, and CUDA activity when a card is
    present. On exit the trace is written under ``log_dir`` as
    ``<host>_<pid>.<ms>.pt.trace.json`` (TensorBoard's profile plugin reads
    the directory, Perfetto the file). Yields the profiler, whose events
    the caller may read after the block. Every thread's operators are
    recorded (the ``Trainer``'s prefetch thread, a server's handlers), and
    the card's kernels whichever thread launched them."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir),
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        yield prof


def latest_trace(log_dir: str) -> Optional[str]:
    """The newest trace file ``profile_trace`` wrote under ``log_dir``."""
    paths = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    return max(paths, key=os.path.getmtime) if paths else None
