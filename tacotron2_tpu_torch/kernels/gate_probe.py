"""The known-bad training-scan build that the quality gate must reject.

    from tacotron2_tpu_torch.kernels import gate_probe
    gate_probe.install()   # this process's train_scan is now the bad build

    python -m tacotron2_tpu_torch.kernels.gate_probe
        # row 2's d_processed, shipped and known-bad, against the plain
        # version at the gate's shapes (needs a card)

``install`` compiles ``csrc/train_scan.cu`` with ``-DSCAN_DPROC_BF16`` into
``build/kernels/gate_probe/`` and puts that library in place of
``train_scan`` in this process (``_build._LIBS``), before anything has
loaded the shipped one. The define rounds the backward chain's
``d_processed`` accumulator to bf16 after every step's add, in both the
tensor-core and the CUDA-core chain: the fault that once drifted training
while every per-step parity test passed. Nothing on the shipped path sets
the define or calls this module; ``tools/synthesis_check.py --known-bad``
does, in its own process.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels import train_scan as ts

DEFINE = "SCAN_DPROC_BF16"


def build() -> str:
    """Compile the known-bad variant; returns the library's path."""
    src = (_build.CSRC / "train_scan.cu").read_text()
    if src.count(f"#ifdef {DEFINE}") != 2:
        raise RuntimeError(f"train_scan.cu no longer has the two {DEFINE} "
                           f"sites the probe build needs")
    out = _build.BUILD_DIR / "gate_probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libtrain_scan_dproc_bf16.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, f"-D{DEFINE}", "-I",
           str(_build.CSRC), "-o", str(lib), str(_build.CSRC / "train_scan.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the {DEFINE} build:\n"
                           f"{proc.stdout}")
    return str(lib)


def _load(path: str) -> ctypes.CDLL:
    """The library at ``path`` with train_scan's C signatures."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in ts._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def install() -> str:
    """Build the variant and make it this process's ``train_scan``;
    returns the library's path. Raises if the shipped library is already
    loaded here."""
    with _build._LOCK:
        if "train_scan" in _build._LIBS:
            raise RuntimeError("the shipped train_scan library is already "
                               "loaded in this process")
    path = build()
    lib = _load(path)
    with _build._LOCK:
        _build._LIBS["train_scan"] = lib
    return path


def _chain_inputs(model, dev, B, T_in, steps, seed):
    """The backward chain's inputs at full width, bf16, dropout on: packed
    weights, the plain forward's residuals of seeded attention inputs, and
    seeded cotangents."""
    from tacotron2_tpu_torch.kernels import decoder_batch as db
    from tacotron2_tpu_torch.models import decoder_vjp as dv
    from tacotron2_tpu_torch.models import tacotron2 as tm
    cfg, bf16 = model.cfg, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    sw = dv._pack(dv.core_weights(model), bf16)
    lengths = torch.randint(T_in // 2, T_in + 1, (B,), generator=g,
                            device=dev)
    mask = torch.arange(T_in, device=dev)[None] < lengths[:, None]
    memory = torch.randn(B, T_in, cfg.encoder_embedding_dim, generator=g,
                         device=dev) * 0.3
    processed = tm.processed_memory_of(model, memory, bf16)
    mem, proc, emask = db.attention_inputs(memory, processed, mask, bf16)
    prenet = (torch.rand(steps, B, cfg.prenet_dim, generator=g, device=dev)
              * 0.5).to(bf16)
    kw = dict(keep=ts.keep_masks(g, steps, B, cfg.attention_rnn_dim,
                                 cfg.decoder_rnn_dim, cfg.p_attention_dropout,
                                 cfg.p_decoder_dropout),
              p_att=cfg.p_attention_dropout, p_dec=cfg.p_decoder_dropout)
    res = ts.forward_residuals_plain(sw, prenet, mem, proc, emask, **kw)
    cot = lambda x: torch.randn(x.shape, generator=g, device=dev) * 0.01
    return (sw, res, mem, proc, cot(res.dec_h), cot(res.ctx),
            cot(res.w) * (emask == 0)), kw


def main() -> int:
    """Row 2's d_processed from the shipped and the known-bad library
    against the plain version, B=32 at the gate's T_in and step counts:
    the largest |err| as a share of the largest |value|."""
    if not torch.cuda.is_available():
        print("gate_probe: no CUDA device", file=sys.stderr)
        return 1
    from tacotron2_tpu_torch.config import create_config
    from tacotron2_tpu_torch.models import tacotron2 as tm
    dev = torch.device("cuda")
    shipped = _build.load("train_scan", ts._SIGNATURES)
    bad = _load(build())
    model = tm.Tacotron2(create_config(),
                         torch.Generator().manual_seed(1234)).to(dev)
    for T_in, steps in ((32, 128), (32, 256), (48, 256)):
        args, kw = _chain_inputs(model, dev, 32, T_in, steps, T_in + steps)
        want = ts.backward_chain_plain(*args, **kw).d_processed
        shares = {}
        for name, lib in (("shipped", shipped), ("known-bad", bad)):
            _build._LIBS["train_scan"] = lib
            got = ts.backward_chain(*args, **kw).d_processed
            torch.cuda.synchronize()
            shares[name] = float((got - want).abs().max()
                                 / want.abs().max())
        _build._LIBS["train_scan"] = shipped
        print(f"gate_probe B=32 T_in={T_in} {steps} steps bf16: d_processed "
              f"largest |err| against the plain version as a share of its "
              f"largest |value|: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in shares.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
