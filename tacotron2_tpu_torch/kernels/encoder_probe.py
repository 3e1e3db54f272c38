"""Where a step of the encoder BiLSTM's cluster kernel goes, on the card.

    python -m tacotron2_tpu_torch.kernels.encoder_probe [B ...]

Builds variants of ``csrc/encoder_lstm.cu`` beside the normal build (in
``build/kernels/encoder_probe/``), each with one part of
``encoder_cluster_kernel``'s step switched off: the x warps' x part, the h
part, the push of h into the other blocks, the stores of the six stacks,
and all four together (the cluster barrier, the cell and the loads of x
left). Then, at the default widths (N=512, H=256, bf16,
seeded weights, T=128), it prints each variant's time and time a step at
each B (1, 8, 32 and 128 by default), and how far each variant's output
is from the plain version (a variant with a part switched off is wrong by
design; the built kernel must not be). Needs one CUDA device and nvcc;
nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels import encoder_lstm as el
from tacotron2_tpu_torch.kernels.lstm_layout import to_blocks

# (marker in csrc/encoder_lstm.cu, its replacement) of each part
_PARTS = {
    "x part": ("      if (t + 1 < T) x_part(t + 1);",
               "      if (t + 1 < T && T < 0) x_part(t + 1);"),
    "h part": ("      ec_product(acc, hs + ((size_t)((t - 1) & 1) * R + "
               "mt * 16) * LH, LH,",
               "      if (T < 0) ec_product(acc, hs + ((size_t)((t - 1) & 1)"
               " * R + mt * 16) * LH, LH,"),
    "push": ("      for (int p = t4; p < EC_CL; p += 4) st_cluster16(dst, p, "
             "v);",
             "      for (int p = t4; p < EC_CL && T < 0; p += 4) "
             "st_cluster16(dst, p, v);"),
    "stores": ("      if (row < B) {\n        const size_t o = (size_t)t * B "
               "+ row;",
               "      if (row < B && T < 0) {\n        const size_t o = "
               "(size_t)t * B + row;"),
}
_VARIANTS = {"as built": (), "no x part": ("x part",),
             "no h part": ("h part",), "no push": ("push",),
             "no stores": ("stores",),
             "no x, h, push, stores": ("x part", "h part", "push", "stores")}


def _sources():
    """{variant: source of csrc/encoder_lstm.cu with its parts off}."""
    src = (_build.CSRC / "encoder_lstm.cu").read_text()
    out = {}
    for name, parts in _VARIANTS.items():
        text = src
        for part in parts:
            old, new = _PARTS[part]
            if old not in text:
                raise RuntimeError(f"encoder_lstm.cu no longer has the "
                                   f"{part} marker {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_variants():
    out = _build.BUILD_DIR / "encoder_probe"
    out.mkdir(parents=True, exist_ok=True)
    started = []
    for i, (name, text) in enumerate(_sources().items()):
        cu, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        started.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, proc in started:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in el._SIGNATURES.items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        cdll.error_string.argtypes = [ctypes.c_int]
        cdll.error_string.restype = ctypes.c_char_p
        libs[name] = cdll
    return libs


def _ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("encoder_probe: no CUDA device", file=sys.stderr)
        return 1
    batches = [int(b) for b in argv] or [1, 8, 32, 128]
    dev = torch.device("cuda")
    N, H, T = 512, 256, 128
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.rand(*s, generator=g, device=dev) - 0.5
    wf, wb = (to_blocks(rand(N + H, 4 * H).mul(0.1).to(bf16), 4)
              for _ in range(2))
    bf, bb = (rand(4 * H).mul(0.2) for _ in range(2))
    libs = _build_variants()
    saved = _build.load("encoder_lstm", el._SIGNATURES)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    try:
        for B in batches:
            xs, xsr = (torch.relu(rand(B, T, N) * 2).to(bf16)
                       for _ in range(2))
            want = el.bilstm_forward_plain(wf, bf, wb, bb, xs, xsr)
            row = []
            for name, lib in libs.items():
                _build._LIBS["encoder_lstm"] = lib
                run = lambda: el.bilstm_forward(wf, bf, wb, bb, xs, xsr)
                got = run()
                torch.cuda.synchronize()
                err = max(float((a.float() - b.float()).abs().max()
                                / b.float().abs().max())
                          for a, b in zip(got, want))
                ms = _ms(run)
                row.append(f"{name} {ms:.4f} ms ({ms / T * 1e3:.2f} us a "
                           f"step; worst share {err:.1e})")
            print(f"encoder probe [{card}] bf16 B={B} T={T} N={N} H={H}: "
                  + "; ".join(row))
    finally:
        _build._LIBS["encoder_lstm"] = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
