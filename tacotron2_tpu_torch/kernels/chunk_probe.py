"""Where a step of the persistent decoder chunk goes, on the card.

    python -m tacotron2_tpu_torch.kernels.chunk_probe [B | step] [T_in]

Builds two variants of ``csrc/decoder_batch.cu`` (the batched chunk), or
with ``step`` of ``csrc/decoder_step.cu`` (the single-utterance chunk),
and of the persistent kernel both include (``csrc/persistent_chunk.cuh``)
beside the normal build (in ``build/kernels/probe/``): one that records
the GPU clock (``%globaltimer``) in block 0 after each grid barrier, and
one whose phases do no work, so that a chunk is its barriers alone. Then,
at the default config's full width (seeded random weights, bf16, one
64-step chunk at B rows, 8 by default, one row for ``step``; T_in encoder
positions, 128 by default), it prints the chunk's time as built and in
both variants, and the median time of each phase over the steps (from the
barrier before it to the one after it, so each includes one barrier),
with the rounds of items the phase takes where it shares out items (the
persistent plan's, ``phase_rounds`` of the chunk's wrapper). Needs one
CUDA device and nvcc; nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tacotron2_tpu_torch.kernels import _build
from tacotron2_tpu_torch.kernels import decoder_batch as db
from tacotron2_tpu_torch.kernels import decoder_step as ds

PHASES = ("prenet", "attention LSTM", "query", "energies",
          "softmax and context", "decoder LSTM", "projection")
# each phase's index in the plan's rounds of items; the LSTM phases have none
ITEM_PHASE = (0, None, 1, 2, 3, None, 4)
_TRACE = '''
__device__ unsigned long long pc_trace[8192];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PC_MARK if (bid == 0 && tid == 0) pc_trace[(st * 8 + (ph++)) & 8191] = gtime();
'''
_READ = ('int pc_trace_read(void* h) { return (int)cudaMemcpyFromSymbol('
         'h, pc_trace, sizeof(pc_trace)); }\n')


def _patched(name, marks):
    src = (_build.CSRC / name).read_text()
    for old, new in marks.items():
        if old not in src:
            raise RuntimeError(f"{name} no longer has {old!r}")
        src = src.replace(old, new)
    return src


def _variants(source="decoder_batch"):
    """{variant: {file name: source}}: the traced and the barrier-only
    copies of csrc/<source>.cu and csrc/persistent_chunk.cuh."""
    name = f"{source}.cu"
    cu = _patched(name, {'extern "C" {\n': 'extern "C" {\n' + _READ})
    head = _patched("persistent_chunk.cuh", {
        '#include "mma.cuh"\n': '#include "mma.cuh"\n' + _TRACE,
        "grid_sync(P.bar, target);": "grid_sync(P.bar, target); PC_MARK",
        "    const int par = st & 1;\n":
            "    const int par = st & 1;\n    int ph = 0;\n    PC_MARK\n"})
    idle = (head.replace("for (int it = bid; it < P.items[",
                         "for (int it = bid; it < 0 * P.items[")
            .replace("    pc_lstm<NB>(", "    if (c.t0 < 0) pc_lstm<NB>("))
    return {"traced": {name: cu, "persistent_chunk.cuh": head},
            "idle": {name: cu, "persistent_chunk.cuh": idle}}


def _build_variants(source, signatures):
    started = []
    for name, files in _variants(source).items():
        out = _build.BUILD_DIR / "probe" / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():   # the copy beside the .cu wins
            (out / fname).write_text(text)
        cu, lib = out / f"{source}.cu", out / f"lib{source}-{name}.so"
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
        for fn, argtypes in signatures.items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        cdll.error_string.argtypes = [ctypes.c_int]
        cdll.error_string.restype = ctypes.c_char_p
        libs[name] = cdll
    return libs


def _chunk_args(B: int, T: int, dev: torch.device, step: bool):
    """The chunk's arguments at T encoder positions: the batched chunk's
    at B rows, or with ``step`` the single-utterance chunk's (B=1, its
    pack and its fp32 attention inputs)."""
    from tacotron2_tpu_torch.config import create_config
    from tacotron2_tpu_torch.models import tacotron2 as tm
    cfg = create_config()
    model = tm.Tacotron2(cfg, torch.Generator().manual_seed(1234)).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    rand = lambda n: torch.randn(B, T, n, generator=g, device=dev) * 0.3
    if step:
        fp = ds.pack_decoder_params(model, torch.bfloat16)
        mem, proc, emask = ds.attention_inputs(
            rand(cfg.encoder_embedding_dim), rand(cfg.attention_dim), None)
    else:
        fp = db.pack_batch_decoder_params(model, torch.bfloat16)
        mem, proc, emask = db.attention_inputs(
            rand(cfg.encoder_embedding_dim), rand(cfg.attention_dim), None,
            torch.bfloat16)
    a, d, e = (cfg.attention_rnn_dim, cfg.decoder_rnn_dim,
               cfg.encoder_embedding_dim)
    z = lambda *s: torch.zeros(*s, device=dev)
    i32 = lambda: torch.zeros(B, dtype=torch.int32, device=dev)
    carry = db.ChunkCarry(z(B, a), z(B, a), z(B, d), z(B, d), z(B, T),
                          z(B, T), z(B, e), z(B, cfg.n_mel_channels), i32(),
                          i32())
    return (fp, carry, mem, proc, emask), dict(t0=0, chunk_steps=64,
                                               gate_logit=1e30)


def _ms(fn, iters=10):
    for _ in range(2):
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
        print("chunk_probe: no CUDA device", file=sys.stderr)
        return 1
    step = bool(argv) and argv[0] == "step"
    B = 1 if step else int(argv[0]) if argv else 8
    T = int(argv[1]) if len(argv) > 1 else 128
    mod, source = (ds, "decoder_step") if step else (db, "decoder_batch")
    dev = torch.device("cuda")
    args, kw = _chunk_args(B, T, dev, step)
    chunk = ds.decoder_step_chunk if step else db.decoder_chunk
    run = lambda: chunk(*args, **kw)
    built = _ms(run)
    rounds = chunk.phase_rounds
    libs = _build_variants(source, mod._SIGNATURES)
    saved = _build.load(source, mod._SIGNATURES)
    try:
        _build._LIBS[source] = libs["idle"]
        idle = _ms(run)
        _build._LIBS[source] = libs["traced"]
        traced = _ms(run)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8192)()
        _build.check(libs["traced"], libs["traced"].pc_trace_read(buf),
                     "pc_trace_read")
    finally:
        _build._LIBS[source] = saved
    cs = kw["chunk_steps"]
    marks = torch.tensor(list(buf[:cs * 8]), dtype=torch.float64)
    marks = marks.reshape(cs, 8)
    phase_us = (marks[:, 1:] - marks[:, :-1])[2:].median(dim=0).values / 1e3
    step_us = float((marks[1:, 0] - marks[:-1, 0])[2:].median()) / 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    what = "single-utterance chunk (row 6)" if step else "batched chunk"
    by_phase = (f"{name} {float(t):.2f}" + (
        "" if i is None else f" ({rounds[i]} round{'s' * (rounds[i] != 1)})")
        for name, t, i in zip(PHASES, phase_us, ITEM_PHASE))
    print(f"chunk probe [{card}] {what} bf16 B={B} T_in={T} {cs} steps: "
          f"chunk "
          f"{built:.4f} ms as built, {traced:.4f} ms traced, {idle:.4f} ms "
          f"with its phases doing no work ({idle / (7 * cs) * 1e3:.2f} us a "
          f"barrier); a step {step_us:.2f} us; by phase, its barrier "
          f"included (us, median over steps 2..{cs - 1}): "
          + ", ".join(by_phase))
    return 0


if __name__ == "__main__":
    sys.exit(main())
