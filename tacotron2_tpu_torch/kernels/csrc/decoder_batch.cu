// Batched decoder chunk: `cs` autoregressive Tacotron 2 decoder steps for B
// rows at once, for the batched serving path.
//
// Replaces the TPU kernel tacotron2_tpu/kernels/decoder_batch.py
// _make_kernel (called by _batch_chunk_call). Each step, for every row:
//   prenet        a2 = relu(relu(prev @ pre1) [* 2 keep1] @ pre2) [* 2 keep2]
//   attention LSTM  [a2 ; ctx ; h1] @ w1 + b1 -> (h1, c1)
//   query         q = h1 @ wq
//   location attention
//                 e[t] = v . tanh(q + loc[t] + proc[t]),
//                 loc[t] = sum_k sum_c K2[k,c,:] * [w ; w_cum][c, t+k-pad]
//                 (K2 = location conv folded through location dense)
//                 w' = softmax(e + mask)  (additive -1e30 mask, so an
//                 all-masked row stays finite), ctx = sum_t w'[t] mem[t]
//   decoder LSTM  [h1 ; ctx ; h2] @ w2 + b2 -> (h2, c2)
//   projection    [h2 ; ctx] @ wpe + bpe -> n mel values and the gate logit
//   latch         finished rows emit mel 0, gate 1e3 and align 0; a row's
//                 length counts the step whose gate logit crosses the
//                 threshold, and the row latches after it.
// Cast points are the TPU kernel's: operands rounded to the operand type W
// before each product, fp32 sums, fp32 h, c, w, w_cum, ctx; memory and
// processed memory in W.
//
// What bounds it on the H100: at B = 8 every step streams the two LSTM
// weight matrices (1792 x 4096 and 2560 x 4096, ~36 MB in bf16) for 8 rows
// of work -- 8 FLOP per weight byte, far below the ~295 FLOP/byte at which
// the tensor cores become the limit. The TPU kernel keeps these weights in
// its 128 MB VMEM for the whole chunk; no SM can (227 KB of shared memory),
// but the 50 MB L2 holds them, so each step reads them from L2.
//
// Design. A bf16 chunk of at most 32 rows (the serving path) runs as ONE
// cooperative persistent launch: see persistent_chunk.cuh. The
// fp32 chunk, and bf16 shapes that kernel does not take
// (persistent_plan), keep the first design: a few launches per step, each
// a plain grid, from a host loop over the chunk's steps inside the C entry
// point (one call from Python runs the whole chunk):
//   1 prenet_kernel      64 second-layer columns x one row per block
//   2 lstm_kernel        blocks own DEC_UNITS hidden units (all four gate
//                        columns) x 8 rows: 128 blocks at 1024 units; the
//                        weights come block-major (kernels/lstm_layout.py),
//                        so a block's loads are whole 32-byte sectors
//   3 query_kernel       32 query columns x one row per block
//   4 energy_kernel      8 encoder positions (a warp each) x one row per
//                        block; all of K2, the block's window of w / w_cum
//                        and its slice of processed memory sit in shared
//                        memory
//   5 softmax_ctx_kernel 64 context columns x one row per block; every block
//                        recomputes the row's softmax (T values)
//   6 lstm_kernel        again, for the decoder LSTM
//   7 proj_kernel        32 projection columns x one row per block; the block
//                        holding the gate column latches the row
// (Kernels 1, 3 and 7 work on one row per block and are shared with the
// single-utterance chunk: decoder_common.cuh.)
// Launch boundaries are the grid-wide barriers between phases. h1, h2 and
// the latch are double-buffered, because blocks of one launch read the old
// value of the whole row while others write the new one. Every product
// keeps T2_LOADS global loads in flight per thread, so a step is not one
// chain of L2 latencies.
#include <math.h>

#include "attention.cuh"
#include "decoder_common.cuh"
#include "lstm_cell.cuh"
#include "persistent_chunk.cuh"

// 2 and 6. LSTM cell over the input [s0 ; s1 ; s2] (fp32 sources, rounded to
// W here); c updated in place (each element by the one thread that owns
// it), the new h written to h_out (not the buffer s2 reads).
template <typename W>
__global__ void __launch_bounds__(DEC_THREADS)
lstm_kernel(const float* __restrict__ s0, int L0, const float* __restrict__ s1,
            int L1, const float* __restrict__ s2, int L2, const W* __restrict__ w,
            const float* __restrict__ bias, float* c, float* __restrict__ h_out,
            int B, int H) {
  constexpr int COLS = 4 * DEC_UNITS;
  constexpr int KSPLIT = DEC_THREADS / COLS;
  extern __shared__ float smem[];
  const int K = L0 + L1 + L2;
  const int u0 = blockIdx.x * DEC_UNITS;
  const int b0 = blockIdx.y * T2_BT;
  float* xs = smem;
  float* red = xs + T2_BT * K;
  float* gsm = red + KSPLIT * T2_BT * COLS;
  // stage the block's T2_BT input rows, one load per row in flight together
  for (int k = threadIdx.x; k < K; k += DEC_THREADS) {
    const float* src = s0;
    int L = L0, kk = k;
    if (k >= L0 + L1) {
      src = s2, L = L2, kk = k - L0 - L1;
    } else if (k >= L0) {
      src = s1, L = L1, kk = k - L0;
    }
    float v[T2_BT];
#pragma unroll
    for (int b = 0; b < T2_BT; ++b)
      v[b] = b0 + b < B ? src[(size_t)(b0 + b) * L + kk] : 0.0f;
#pragma unroll
    for (int b = 0; b < T2_BT; ++b) xs[k * T2_BT + b] = rnd<W>(v[b]);
  }
  __syncthreads();
  gate_product<W, DEC_UNITS, DEC_THREADS>(
      xs, K, w + (size_t)blockIdx.x * K * COLS, red, gsm);
  for (int i = threadIdx.x; i < T2_BT * DEC_UNITS; i += DEC_THREADS) {
    const int b = i / DEC_UNITS, u = i % DEC_UNITS, row = b0 + b;
    if (row >= B) continue;
    const int unit = u0 + u;
    const float gi = gsm[b * COLS + 0 * DEC_UNITS + u] + bias[unit];
    const float gff = gsm[b * COLS + 1 * DEC_UNITS + u] + bias[H + unit];
    const float gg = gsm[b * COLS + 2 * DEC_UNITS + u] + bias[2 * H + unit];
    const float go = gsm[b * COLS + 3 * DEC_UNITS + u] + bias[3 * H + unit];
    const size_t idx = (size_t)row * H + unit;
    const float cn = sigmoid_f(gff) * c[idx] + sigmoid_f(gi) * tanhf(gg);
    c[idx] = cn;
    h_out[idx] = sigmoid_f(go) * tanhf(cn);
  }
}

// Dynamic shared memory of each kernel of the chunk, in bytes, in launch
// order; the one place these sizes are stated (decoder_chunk_limits reports
// them to Python).
enum { K_PRENET, K_LSTM, K_QUERY, K_ENERGY, K_SOFTMAX_CTX, K_PROJ, N_KERNELS };

static void chunk_smem(int T, int n, int p, int E, int A, int D, int datt,
                       int ks, size_t out[N_KERNELS]) {
  const int k_lstm = p + E + A > A + E + D ? p + E + A : A + E + D;
  out[K_PRENET] = sizeof(float) * (n + p + PRE_COLS + DEC_THREADS);
  out[K_LSTM] = gate_product_smem<DEC_UNITS, DEC_THREADS>(k_lstm);
  out[K_QUERY] = sizeof(float) * (A + DEC_THREADS + 32);
  out[K_ENERGY] = sizeof(float) * ((size_t)ks * 2 * datt + 2 * datt +
                                   2 * (E_TILE + ks - 1) + E_TILE * datt);
  out[K_SOFTMAX_CTX] = sizeof(float) * (T + SM_THREADS + CTX_COLS);
  out[K_PROJ] = sizeof(float) * (D + E + PROJ_COLS + DEC_THREADS);
}

// 0 when the chunk can run these dimensions on the current device; 1 when
// A or D is not a multiple of DEC_UNITS; 2 when ks is even; 3 + i when
// kernel i (the enum above) needs more shared memory than one block may
// opt into, with *need and *have its bytes and the device's; -1 when the
// device cannot be asked.
static int chunk_limits(int T, int n, int p, int E, int A, int D, int datt,
                        int ks, size_t* need, int* have) {
  if (A % DEC_UNITS || D % DEC_UNITS) return 1;
  if (ks % 2 == 0) return 2;
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(have, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  size_t sm[N_KERNELS];
  chunk_smem(T, n, p, E, A, D, datt, ks, sm);
  for (int i = 0; i < N_KERNELS; ++i) {
    if (sm[i] > (size_t)*have) {
      *need = sm[i];
      return 3 + i;
    }
  }
  return 0;
}

template <typename W>
static cudaError_t run(const Chunk& c, cudaStream_t s) {
  size_t sm[N_KERNELS];
  chunk_smem(c.T, c.n, c.p, c.E, c.A, c.D, c.datt, c.ks, sm);
  cudaError_t err;
#define T2_SMEM(kern, bytes)                                                   \
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             (int)(bytes));                                    \
  if (err != cudaSuccess) return err;
  T2_SMEM(prenet_kernel<W>, sm[K_PRENET]);
  T2_SMEM(lstm_kernel<W>, sm[K_LSTM]);
  auto query = query_kernel<W, true>;  // a name without a comma, for the macro
  T2_SMEM(query, sm[K_QUERY]);
  T2_SMEM(energy_kernel<W>, sm[K_ENERGY]);
  T2_SMEM(softmax_ctx_kernel<W>, sm[K_SOFTMAX_CTX]);
  T2_SMEM(proj_kernel<W>, sm[K_PROJ]);
#undef T2_SMEM
  const int rows8 = (c.B + T2_BT - 1) / T2_BT;
  const dim3 g_l1(c.A / DEC_UNITS, rows8), g_l2(c.D / DEC_UNITS, rows8);
  const dim3 g_q((c.datt + 31) / 32, c.B), g_e((c.T + E_TILE - 1) / E_TILE, c.B);
  const dim3 g_s((c.E + CTX_COLS - 1) / CTX_COLS, c.B);
  const dim3 g_p((c.p + PRE_COLS - 1) / PRE_COLS, c.B);
  const dim3 g_j((c.n + 1 + PROJ_COLS - 1) / PROJ_COLS, c.B);
  const W* mem = (const W*)c.mem;
  const W* proc = (const W*)c.proc;
  for (int st = 0; st < c.cs; ++st) {
    float* h1_in = c.h1 + (size_t)(st % 2) * c.B * c.A;
    float* h1_out = c.h1 + (size_t)((st + 1) % 2) * c.B * c.A;
    float* h2_in = c.h2 + (size_t)(st % 2) * c.B * c.D;
    float* h2_out = c.h2 + (size_t)((st + 1) % 2) * c.B * c.D;
    int* fin_in = c.fin + (size_t)(st % 2) * c.B;
    int* fin_out = c.fin + (size_t)((st + 1) % 2) * c.B;
    prenet_kernel<W><<<g_p, DEC_THREADS, sm[K_PRENET], s>>>(
        c.prev, (const W*)c.pre1, (const W*)c.pre2, c.kp1, c.kp2, c.a2, st,
        c.B, c.n, c.p);
    lstm_kernel<W><<<g_l1, DEC_THREADS, sm[K_LSTM], s>>>(
        c.a2, c.p, c.ctx, c.E, h1_in, c.A, (const W*)c.w1, c.b1, c.c1, h1_out,
        c.B, c.A);
    query<<<g_q, DEC_THREADS, sm[K_QUERY], s>>>(
        h1_out, (const W*)c.wq, c.q, c.A, c.datt);
    energy_kernel<W><<<g_e, SM_THREADS, sm[K_ENERGY], s>>>(
        c.q, c.w, c.wc, (const W*)c.k2, (const W*)c.v, proc, c.e, c.T, c.datt,
        c.ks);
    softmax_ctx_kernel<W><<<g_s, SM_THREADS, sm[K_SOFTMAX_CTX], s>>>(
        c.e, c.emask, mem, c.w, c.wc, c.ctx, c.align, fin_in, st, c.B, c.T, c.E);
    lstm_kernel<W><<<g_l2, DEC_THREADS, sm[K_LSTM], s>>>(
        h1_out, c.A, c.ctx, c.E, h2_in, c.D, (const W*)c.w2, c.b2, c.c2, h2_out,
        c.B, c.D);
    proj_kernel<W><<<g_j, DEC_THREADS, sm[K_PROJ], s>>>(
        h2_out, c.ctx, (const W*)c.wpe, c.bpe, c.mel, c.gate, c.prev, fin_in,
        fin_out, c.len, st, c.t0 + st, c.gate_logit, c.B, c.D, c.E, c.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" {

// Runs cs decoder steps. h1 / h2 / fin point at (2, B, A) / (2, B, D) /
// (2, B) buffers whose slot 0 holds the incoming state; the final state
// lands in slot cs % 2. Every other carry is updated in place. w1f / w2f:
// the LSTM weights in mma fragment order (kernels/lstm_layout.py
// to_mma_tiles), or null; with them, a bf16 chunk at the shapes
// persistent_plan takes runs as one cooperative launch, using scratch
// (decoder_chunk_scratch bytes), else the per-step launches of run<W>.
// rounds (host memory, PC_NPH ints, or null) gets the persistent launch's
// rounds of items by phase (persistent_plan), zeros without one. Returns
// cudaError_t.
int decoder_chunk(int bf16, const void* pre1, const void* pre2, const void* w1,
                  const void* b1, const void* w2, const void* b2, const void* wq,
                  const void* k2, const void* v, const void* wpe, const void* bpe,
                  const void* w1f, const void* w2f,
                  const void* mem, const void* proc, const void* emask,
                  const void* kp1, const void* kp2, void* h1, void* c1, void* h2,
                  void* c2, void* w, void* wc, void* ctx, void* prev, void* fin,
                  void* len, void* a2, void* q, void* e, void* mel, void* gate,
                  void* align, void* scratch, int B, int T, int n, int p, int E,
                  int A, int D, int datt, int ks, int cs, int t0,
                  float gate_logit, void* stream, int* rounds) {
  if (rounds)
    for (int i = 0; i < PC_NPH; ++i) rounds[i] = 0;
  size_t need;
  int have;
  if (chunk_limits(T, n, p, E, A, D, datt, ks, &need, &have) != 0)
    return (int)cudaErrorInvalidValue;
  Chunk c{pre1, pre2, w1, w2, wq, k2, v, wpe,
          (const float*)b1, (const float*)b2, (const float*)bpe,
          mem, proc, (const float*)emask, (const float*)kp1, (const float*)kp2,
          (float*)h1, (float*)c1, (float*)h2, (float*)c2, (float*)w, (float*)wc,
          (float*)ctx, (float*)prev, (int*)fin, (int*)len,
          (float*)a2, (float*)q, (float*)e,
          (float*)mel, (float*)gate, (float*)align,
          B, T, n, p, E, A, D, datt, ks, cs, t0, gate_logit};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16 && w1f && w2f) {
    Persist P{};
    size_t smem = 0;
    const int plan = persistent_plan<__nv_bfloat16>(c, &P, &smem, rounds);
    if (plan < 0) return (int)cudaErrorInvalidDevice;
    if (plan == 0) {
      P.w1f = (const uint4*)w1f;
      P.w2f = (const uint4*)w2f;
      return (int)run_persistent<__nv_bfloat16>(P, smem, scratch, s);
    }
  }
  return (int)(bf16 ? run<__nv_bfloat16>(c, s) : run<float>(c, s));
}

// Bytes of scratch decoder_chunk takes at these shapes. Returns 0.
int decoder_chunk_scratch(int B, int p, int E, int A, int D, size_t* bytes) {
  *bytes = persistent_scratch(B, p + E + A, A + E + D);
  return 0;
}

// chunk_limits for Python (kernels/decoder_batch.py:kernel_limits).
int decoder_chunk_limits(int T, int n, int p, int E, int A, int D, int datt,
                         int ks, size_t* need, int* have) {
  return chunk_limits(T, n, p, E, A, D, datt, ks, need, have);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
