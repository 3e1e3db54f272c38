"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so a
build takes seconds). It is compiled for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout the first
time a kernel is called; the hash covers the source, the headers beside it
and the flags, so an edited source builds anew. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Only this module runs ``nvcc``, and it builds nothing but the sources in
``csrc/``. Nothing here is imported or run when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("encoder_lstm", "decoder_batch", "train_scan", "decoder_step",
           "int8_matmul", "mel_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (not on PATH, nor under CUDA_HOME): the port's "
            "CUDA kernels are built from source on the machine with the card")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path]:
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file; returns the
    process and the temporary path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, started: Tuple[subprocess.Popen, Path]) -> str:
    """Wait for nvcc, move the library into place; returns nvcc's output."""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                           f"csrc/{name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))
    return log


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build every missing library in parallel (one nvcc per source);
    returns nvcc's output (register and shared-memory use) by name."""
    with _LOCK:
        started = {n: _start(n) for n in names if not _lib_path(n).exists()}
        return {n: _finish(n, p) for n, p in started.items()}


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    returns a cudaError_t as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _finish(name, _start(name))
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: {lib.error_string(status).decode()}")
