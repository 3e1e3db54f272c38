"""Where a call of the int8 weight product (row 7) goes, on the card.

    python -m tacotron2_tpu_torch.kernels.int8_probe

Builds variants of ``csrc/int8_matmul.cu`` beside the normal build (in
``build/kernels/int8_probe/``): layouts (tiles a block takes, ``I8_TPB``;
the ring's stages and their most chunks, ``I8_STAGES`` and
``I8_STAGE_CHUNKS``),
ways of staging x, and the built layout with a part of
``int8_matmul_kernel`` switched off: the staging of x, the widening, the
products, and x and the products (the weight stream through the ring
left). Then, at
the two decoder cells' shapes (K 1792 and 2560, N 4096) and B 1 and 8, it
prints each variant's device time per call in a CUDA graph of 100 calls
(x in fp32, and the built kernel also with x in bf16), beside
``torch.matmul`` on a bf16 copy dequantised ahead of time timed the same
way, and how far each variant's output is from the plain version (a
variant with a part switched off is wrong by design; the others must not
be). The weights stay in the 50 MB L2 between calls, as they do between
the decoder's steps. Needs one CUDA device and nvcc; nothing here runs on
import.
"""

from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys

import torch

from tacotron2_tpu_torch.kernels import _build

# the package exports a function ``int8_matmul`` that hides the module
i8 = importlib.import_module("tacotron2_tpu_torch.kernels.int8_matmul")

_LDG = "    return __ldg(reinterpret_cast<const float4*>(row + k));"
# (marker in csrc/int8_matmul.cu, its replacement) of each part
_PARTS = {
    "x": ("  while (xr < rows) {\n    load_x();\n    store_x();\n  }",
          "  while (xr < rows && a.N < 0) {\n    load_x();\n    store_x();\n"
          "  }"),
    "x first": ("  load_x();\n  if (lane == 0) start_stream();",
                "  if (a.N < 0) load_x();\n  if (lane == 0) start_stream();"),
    "x store": ("  store_x();\n  while", "  if (a.N < 0) store_x();\n  while"),
    "widening": ("    widen4(w4[2 * h], af[h][0], af[h][1]);\n"
                 "    widen4(w4[2 * h + 1], af[h][2], af[h][3]);",
                 "    af[h][0] = w4[2 * h]; af[h][1] = w4[2 * h] >> 8;\n"
                 "    af[h][2] = w4[2 * h + 1];"
                 " af[h][3] = w4[2 * h + 1] >> 8;"),
    "x stores": ("      *reinterpret_cast<uint2*>(xw + xr * LX + 4 * xc) = "
                 "as_bf16x4(v[j]);",
                 "      asm volatile(\"\" ::\"r\"(as_bf16x4(v[j]).x));"),
    "x loads": ("        v[j] = load4(x + (size_t)r * a.K, 4 * c, a.K - k0, "
                "a.x_vec);", "        v[j] = {};"),
    "x via L2": (_LDG, _LDG.replace("__ldg", "__ldcg")),
    "x via L1": (_LDG, _LDG.replace("__ldg(", "*(")),
    "pair barrier": ("    named_sync(1 + slice, 32 * TPB);",
                     "    __syncwarp();"),
    "weights first": ("  load_x();\n  if (lane == 0) start_stream();",
                      "  if (lane == 0) start_stream();"),
    "x after": ("  store_x();\n  while", "  load_x();\n  store_x();\n  while"),
    "products": ("          mma_bf16(acc[rg], af[h], bf);",
                 "          acc[rg][0] += __uint_as_float(af[h][0] ^ bf[0]);"),
}
_OFF = ("x", "x first", "x store")


def _ring(stages, chunks):
    return (f"-DI8_STAGES={stages}", f"-DI8_STAGE_CHUNKS={chunks}")


# name: (parts switched off, -D flags)
_VARIANTS = {"as built": ((), ()),
             "1 tile a block": ((), ("-DI8_TPB=1",)),
             "x in batches of 20": ((), ("-DI8_XBATCH=20",)),
             "ring of 2 stages of at most 4 chunks": ((), _ring(2, 4)),
             "ring of 4 stages of at most 2 chunks": ((), _ring(4, 2)),
             "ring of 6 stages of at most 2 chunks": ((), _ring(6, 2)),
             "ring of 8 single chunks": ((), _ring(8, 1)),
             "ring of 3 stages of at most 4 chunks": ((), _ring(3, 4)),
             "ring of 1 stage of at most 10 chunks": ((), _ring(1, 10)),
             "x loads without stores": (("x stores",), ()),
             "x stores without loads": (("x loads",), ()),
             "x loaded through L2 only": (("x via L2",), ()),
             "x loaded through L1": (("x via L1",), ()),
             "x in batches of 5": ((), ("-DI8_XBATCH=5",)),
             "no pair barrier": (("pair barrier",), ()),
             "x after the weights": (("weights first", "x after"), ()),
             "no x staging": (_OFF, ()),
             "no widening": (("widening",), ()),
             "no products": (("products",), ()),
             "weight stream only": ((*_OFF, "products"), ())}


def _sources():
    """{variant: (source of csrc/int8_matmul.cu with its parts off, its -D
    flags)}."""
    src = (_build.CSRC / "int8_matmul.cu").read_text()
    out = {}
    for name, (parts, flags) in _VARIANTS.items():
        text = src
        for part in parts:
            old, new = _PARTS[part]
            if old not in text:
                raise RuntimeError(f"int8_matmul.cu no longer has the {part} "
                                   f"marker {old!r}")
            text = text.replace(old, new)
        out[name] = (text, flags)
    return out


def _build_variants():
    out = _build.BUILD_DIR / "int8_probe"
    out.mkdir(parents=True, exist_ok=True)
    started = []
    for i, (name, (text, flags)) in enumerate(_sources().items()):
        cu, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
               str(_build.CSRC), "-o", str(lib), str(cu)]
        started.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, lib, proc in started:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in i8._SIGNATURES.items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def graph_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Mean device time of fn() over ``calls`` calls captured in one CUDA
    graph and replayed: the kernels' own time and the gaps between them,
    without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("int8_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    libs = _build_variants()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    N = 4096
    for K in (1792, 2560):
        w = torch.randn(K, N, generator=g, device=dev) * 0.05
        w_q, scale = (t.to(dev) for t in i8.quantize_int8(w))
        packed = i8.pack_int8(w_q)
        wb = (w_q.float() * scale).to(torch.bfloat16)
        for B in (1, 8):
            x = torch.randn(B, K, generator=g, device=dev)
            xb = x.to(torch.bfloat16)
            want = i8.int8_matmul_plain(x, w_q, scale)
            out = torch.empty(B, N, device=dev)
            row = []
            runs = [(name, lib, x) for name, lib in libs.items()]
            runs.insert(1, ("as built, x in bf16", libs["as built"], xb))
            for name, lib, xx in runs:
                call = lambda: lib.int8_matmul(
                    xx.data_ptr(), xx.dtype == torch.bfloat16,
                    packed.data_ptr(), scale.data_ptr(), out.data_ptr(), B,
                    K, N, torch.cuda.current_stream().cuda_stream)
                out.fill_(float("nan"))
                status = call()
                if status:
                    row.append(f"{name} failed (cudaError_t {status})")
                    continue
                us = graph_ms(call) * 1e3
                torch.cuda.synchronize()
                err = float((out - want).abs().max() / want.abs().max())
                row.append(f"{name} {us:.2f} us (share {err:.1e})")
            lib_us = graph_ms(lambda: torch.matmul(xb, wb)) * 1e3
            print(f"int8 probe [{card}] B={B} K={K} N={N}, device time per "
                  f"call in a CUDA graph: " + "; ".join(row)
                  + f"; torch.matmul on a dequantised bf16 copy "
                  f"{lib_us:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
