"""Profiling and tracing (the JAX package's ``utils/profiling.py``).

The reference's observability is a per-iteration ``time.perf_counter``
print (reference train.py:209,239-243). Here:

- ``StepTimer``: wall-clock step timing with a warm-up skip and a
  percentile summary;
- ``profile_trace``: a context manager around ``torch.profiler`` that
  writes a trace (host activity, and the card's kernels when there is one)
  which TensorBoard's profile plugin and Perfetto read;
- ``start_profiler_server``: the counterpart of JAX's live capture
  endpoint. PyTorch has no such server, so this is a small HTTP server
  whose request captures a window of the requested length with
  ``profile_trace`` and answers with the trace's path.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, List, Optional

import numpy as np
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


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


def start_profiler_server(port: int = 9999, log_dir: str = "profiles",
                          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Serve captures on ``host:port`` from a daemon thread:
    ``GET /capture?ms=N`` profiles the next N milliseconds of this process
    (every thread's operators, the card's kernels) into ``log_dir`` and
    answers ``{"trace": path}``; one capture at a time (409 while one
    runs). Returns the server: ``shutdown()`` stops it."""
    busy = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path != "/capture":
                return self._reply(404, {"error": "GET /capture?ms=N"})
            try:
                ms = float(urllib.parse.parse_qs(url.query)
                           .get("ms", ["1000"])[0])
            except ValueError:
                return self._reply(400, {"error": "ms must be a number"})
            if not busy.acquire(blocking=False):
                return self._reply(409, {"error": "a capture is running"})
            try:
                with profile_trace(log_dir):
                    time.sleep(ms / 1e3)
                self._reply(200, {"trace": latest_trace(log_dir)})
            finally:
                busy.release()

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # no line per request on stderr
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


class StepTimer:
    """Records step wall times; reports mean/p50/p90 past a warmup."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def measured(self) -> List[float]:
        return self.times[self.warmup:]

    def summary(self) -> dict:
        m = self.measured or self.times
        if not m:
            return {}
        arr = np.asarray(m)
        return {"mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p90_s": float(np.percentile(arr, 90)),
                "steps": len(m)}
