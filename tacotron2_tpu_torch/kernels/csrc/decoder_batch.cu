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
// cooperative persistent launch: see the "persistent chunk" section. The
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
#include "mma.cuh"

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

struct Chunk {
  // weights (W unless noted)
  const void *pre1, *pre2, *w1, *w2, *wq, *k2, *v, *wpe;
  const float *b1, *b2, *bpe;
  // per batch
  const void *mem, *proc;
  const float* emask;
  const float *kp1, *kp2;  // (cs, B, p) 0/1 keep masks, or null
  // carry (in/out)
  float *h1, *c1, *h2, *c2, *w, *wc, *ctx, *prev;
  int *fin, *len;
  // scratch
  float *a2, *q, *e;
  // outputs
  float *mel, *gate, *align;
  int B, T, n, p, E, A, D, datt, ks, cs, t0;
  float gate_logit;
};

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

// ------------------------------------------- persistent chunk, bf16
//
// One cooperative launch runs the whole chunk: G blocks (one per SM, all
// resident at once: cudaLaunchCooperativeKernel refuses a grid the device
// cannot co-schedule) walk the chunk's steps, and a grid-wide barrier
// (grid_sync) stands where a launch boundary stood between the seven
// phases of a step. Every block reaches every barrier of every step,
// latched rows included. The prenet, query, softmax and context, and
// projection phases take the per-step kernels' arithmetic over (row,
// column block) items, which the blocks share out;
// the energies are an im2col tensor-core product over (row, 32 positions)
// items, as the training scan rebuilds them; the LSTM phases are
// tensor-core products in swap-AB form.
//
// LSTM phases. Block b owns the unit groups b, b + G, ... (PC_UG = 4 units
// each, so one m16 tile holds the group's 16 gate columns, gate-major) of
// both LSTMs for the whole chunk. gates^T (16 x B) = W^T (16 x K) @ X^T
// (K x B) on bf16 mma.sync m16n8k16: operand A is the group's weights,
// packed once in the fragment order of the instruction
// (kernels/lstm_layout.py to_mma_tiles: each lane's 16 bytes of a k16 step
// contiguous, so a warp reads 512 bytes a step in one load a lane);
// operand B is X, the rows' inputs in bf16, 8 rows to an n8 tile. The
// weights of an LSTM stay in shared memory for the chunk where they fit
// (at the default widths the decoder LSTM's, ~160 KB a block); the rest
// stream from L2 straight into registers. The 16 warps split K; their
// fp32 partials are added in warp order (deterministic) and the cell runs
// a thread per (unit, row). X is built by the phases that produce its
// parts (prenet, context, h), double-buffered by step parity, so no phase
// reads a row another block is writing.
//
// What bounds it: latency. A step moves ~15 MB from L2 (the attention
// LSTM's weights) and does ~0.3 GFLOP, but it is seven phases, each a few
// dependent round trips to L2 and a grid barrier; on an NVIDIA H100 80GB
// HBM3 at 700 W a barrier alone costs ~1.6 us and a phase 3-6 us with its
// barrier (kernels/chunk_probe.py measures both). Fewer phases, not fewer
// bytes, is what moves it.

#define PC_THREADS 512
#define PC_WARPS (PC_THREADS / 32)
#define PC_UG 4         // hidden units per unit group (one m16 tile)
#define PC_UMAX 2       // unit groups a block owns in each LSTM
#define PC_NBMAX 4      // n8 tiles of rows: B <= 32
#define PC_ET 32        // positions per energy item (two m16 tiles)
#define PC_KC 64        // im2col depth of the energies: 2 ks taps, padded
#define PC_CTX 64       // context columns per softmax item
#define PC_PRE 16       // second-layer prenet columns per item
#define PC_QCOLS 8      // query columns per item
#define PC_PROJ 8       // projection columns per item
#define PC_XOFF 256     // bytes before the operand rows in the scratch

typedef __nv_bfloat16 bf16;

struct Persist {
  Chunk c;
  const uint4 *w1f, *w2f;  // (H / PC_UG, K / 16, 32 lanes) x 16 bytes
  bf16 *x1, *x2;           // (2, Bp, K1), (2, Bp, K2): X by step parity
  unsigned* bar;           // grid barrier: the count of arrivals
  int Bp, K1, K2, U;       // U unit groups a block owns in each LSTM
  int res1, res2;          // LSTM weights resident in shared memory
  int off2, offk, offs;    // bytes: w2's resident copy, K2 and v, the
                           //   phase scratch
};

// All blocks of the grid meet here. The counter only grows (zeroed before
// the launch): thread 0 of each block adds its arrival with release
// semantics and waits, with acquire loads, until all gridDim.x blocks have
// arrived at this barrier (`target`, the block's running count of
// arrivals expected). The barriers around it order the block's other
// threads' writes before the arrival and their reads after the release.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar),
                 "r"(1u)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
    } while ((int)(v - target) < 0);
  }
  __syncthreads();
}

// Block-wide max (is_max) or sum over PC_THREADS threads.
__device__ float pc_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < PC_WARPS ? red[lane] : (is_max ? -INFINITY : 0.0f);
    r = is_max ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// The prenet, query and projection items: the arithmetic of
// decoder_common.cuh's kernels over (row, column block) items, with
// narrow column blocks and block_matvec's TREE sums. Values other blocks
// write during the launch (prev, h1, h2, ctx, the latch) are read through
// plain pointers, never the read-only path.

// PC_PRE columns of a2 from c2 for row `row`; every item of a row
// recomputes the first layer. store(j, value) writes column j. sm: n + p +
// PC_PRE + PC_THREADS floats.
template <typename Store>
__device__ __forceinline__ void pc_prenet(
    const float* prev, const bf16* __restrict__ pre1,
    const bf16* __restrict__ pre2, const float* __restrict__ kp1,
    const float* __restrict__ kp2, int step, int B, int n, int p, int row,
    int c2, float* sm, Store store) {
  constexpr int COLS1 = 256;
  float* pm = sm;             // n
  float* a1 = pm + n;         // p
  float* o2 = a1 + p;         // PC_PRE
  float* red = o2 + PC_PRE;   // PC_THREADS
  for (int i = threadIdx.x; i < n; i += PC_THREADS)
    pm[i] = rnd<bf16>(prev[(size_t)row * n + i]);
  __syncthreads();
  for (int c0 = 0; c0 < p; c0 += COLS1)
    block_matvec<bf16, PC_THREADS, COLS1>(pm, n, pre1, p, c0,
                                          min(COLS1, p - c0), red, a1 + c0);
  const size_t kbase = ((size_t)step * B + row) * p;
  for (int j = threadIdx.x; j < p; j += PC_THREADS) {
    float s = fmaxf(a1[j], 0.0f);
    if (kp1) s *= kp1[kbase + j] * 2.0f;
    a1[j] = rnd<bf16>(s);
  }
  __syncthreads();
  const int ncols = min(PC_PRE, p - c2);
  block_matvec<bf16, PC_THREADS, PC_PRE, true>(a1, p, pre2, p, c2, ncols,
                                               red, o2);
  if (threadIdx.x < ncols) {
    const int j = c2 + threadIdx.x;
    float s = fmaxf(o2[threadIdx.x], 0.0f);
    if (kp2) s *= kp2[kbase + j] * 2.0f;
    store(j, s);
  }
}

// q (B, D) = W(W(h1) @ wq): PC_QCOLS columns from c0 of row `row`. sm: A +
// PC_THREADS + PC_QCOLS floats.
__device__ __forceinline__ void pc_query(const float* h1,
                                         const bf16* __restrict__ wq,
                                         float* q, int A, int D, int row,
                                         int c0, float* sm) {
  float* hs = sm;                   // A
  float* red = hs + A;              // PC_THREADS
  float* out = red + PC_THREADS;    // PC_QCOLS
  const int ncols = min(PC_QCOLS, D - c0);
  for (int i = threadIdx.x; i < A; i += PC_THREADS)
    hs[i] = rnd<bf16>(h1[(size_t)row * A + i]);
  __syncthreads();
  block_matvec<bf16, PC_THREADS, PC_QCOLS, true>(hs, A, wq, D, c0, ncols,
                                                 red, out);
  if (threadIdx.x < ncols)
    q[(size_t)row * D + c0 + threadIdx.x] = rnd<bf16>(out[threadIdx.x]);
}

// PC_PROJ columns from c0 of the mel + gate projection of row `row`; the
// item holding the gate column latches the row (reads fin_in, writes
// fin_out) and counts its length. sm: D + E + PC_PROJ + PC_THREADS floats.
__device__ __forceinline__ void pc_proj(
    const float* h2, const float* ctx, const bf16* __restrict__ wpe,
    const float* __restrict__ bpe, float* mel, float* gate, float* prev,
    const int* fin_in, int* fin_out, int* len, int step, int t_abs,
    float gate_logit, int B, int D, int E, int n, int row, int c0,
    float* sm) {
  const int K = D + E, NO = n + 1;
  float* x3 = sm;                   // K
  float* outs = x3 + K;             // PC_PROJ
  float* red = outs + PC_PROJ;      // PC_THREADS
  const int ncols = min(PC_PROJ, NO - c0);
  const bool done = fin_in[row] != 0;
  for (int k = threadIdx.x; k < K; k += PC_THREADS)
    x3[k] = rnd<bf16>(k < D ? h2[(size_t)row * D + k]
                            : ctx[(size_t)row * E + (k - D)]);
  __syncthreads();
  block_matvec<bf16, PC_THREADS, PC_PROJ, true>(x3, K, wpe, NO, c0, ncols,
                                                red, outs);
  if (threadIdx.x >= ncols) return;
  const int col = c0 + threadIdx.x;
  const float v = outs[threadIdx.x] + bpe[col];
  const size_t o = (size_t)step * B + row;
  if (col < n) {
    mel[o * n + col] = done ? 0.0f : v;
    prev[(size_t)row * n + col] = v;
  } else {
    gate[o] = done ? GATE_MASK : v;
    if (!done) len[row] = t_abs + 1;
    fin_out[row] = (done || v > gate_logit) ? 1 : 0;
  }
}

// One LSTM phase: the block's unit groups (wb[j] null past the last) over
// all rows, then the cell; out(row, unit, h) stores h. c (B, H) fp32 in
// place. red: PC_WARPS * PC_UMAX * 16 * NB * 8 floats.
template <int NB, typename Out>
__device__ __forceinline__ void pc_lstm(const bf16* x, int K,
                                        const uint4* const (&wb)[PC_UMAX],
                                        int g0, int G,
                                        const float* __restrict__ bias,
                                        float* c, int H, int B, float* red,
                                        Out out) {
  constexpr int PF = NB <= 2 ? 4 : 2;   // k16 steps loaded ahead
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nk = K / 16;
  const int k0 = warp * nk / PC_WARPS, k1 = (warp + 1) * nk / PC_WARPS;
  float acc[PC_UMAX][NB][4];
#pragma unroll
  for (int j = 0; j < PC_UMAX; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nb][e] = 0.0f;
  for (int ks = k0; ks < k1; ks += PF) {
    uint4 a[PF][PC_UMAX];
    uint32_t b[PF][NB][2];
#pragma unroll
    for (int f = 0; f < PF; ++f) {
      const int kk = ks + f;
      if (kk >= k1) break;
#pragma unroll
      for (int j = 0; j < PC_UMAX; ++j)
        if (wb[j]) a[f][j] = wb[j][(size_t)kk * 32 + lane];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const bf16* xr = x + (size_t)(nb * 8 + g) * K + kk * 16 + 2 * t4;
        b[f][nb][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[f][nb][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
    }
#pragma unroll
    for (int f = 0; f < PF; ++f) {
      if (ks + f >= k1) break;
#pragma unroll
      for (int j = 0; j < PC_UMAX; ++j) {
        if (!wb[j]) continue;
        const uint32_t fa[4] = {a[f][j].x, a[f][j].y, a[f][j].z, a[f][j].w};
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(acc[j][nb], fa, b[f][nb]);
      }
    }
  }
  constexpr int LD = NB * 8;
#pragma unroll
  for (int j = 0; j < PC_UMAX; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((warp * PC_UMAX + j) * 16 + g + (e >> 1) * 8) * LD + nb * 8 +
            2 * t4 + (e & 1)] = acc[j][nb][e];
  __syncthreads();
  // the cell, a thread per (group, unit, row); the warps' partials in order
  for (int i = threadIdx.x; i < PC_UMAX * PC_UG * B; i += PC_THREADS) {
    const int j = i / (PC_UG * B), u = (i / B) % PC_UG, row = i % B;
    const int unit = (g0 + j * G) * PC_UG + u;
    if (unit >= H) continue;
    float gq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = 0.0f;
      for (int w = 0; w < PC_WARPS; ++w)
        s += red[((w * PC_UMAX + j) * 16 + q * PC_UG + u) * LD + row];
      gq[q] = s + bias[q * H + unit];
    }
    const size_t idx = (size_t)row * H + unit;
    const float cn =
        sigmoid_f(gq[1]) * c[idx] + sigmoid_f(gq[0]) * tanhf(gq[2]);
    c[idx] = cn;
    out(row, unit, sigmoid_f(gq[3]) * tanhf(cn));
  }
  __syncthreads();
}

// Energies of PC_ET positions from t0 of row `row`: the location term as
// an im2col bf16 mma.sync product, windows (PC_ET x PC_KC taps) @ K2
// (PC_KC x D), then e[t] = sum_d W(tanh(q + loc + proc)) v[d] (the cast
// points of energy_kernel; the sums in another order). k2s: K2 as [2k +
// c][d] in bf16, rows of D + 8, zero rows past 2 ks; vs: v in fp32; both
// resident. Warp w takes 16 positions x 16 columns (tile w: m16 tile
// w / (D / 16), n16 group w % (D / 16)). sm: PC_ET * (PC_KC + 8) / 2 + D +
// (D / 16) * PC_ET floats.
__device__ __forceinline__ void pc_energy(
    const float* q, const float* w, const float* wc, const bf16* k2s,
    const float* vs, const bf16* __restrict__ proc, float* e, int T, int D,
    int ks, int row, int t0, float* sm) {
  constexpr int WLD = PC_KC + 8;
  bf16* win = reinterpret_cast<bf16*>(sm);          // [PC_ET][WLD]
  float* qs = sm + PC_ET * WLD / 2;                 // D
  float* red = qs + D;                              // [D / 16][PC_ET]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const int pad = (ks - 1) / 2, ng = D / 16, KLD = D + 8;
  const size_t rT = (size_t)row * T;
  const bool busy = warp < 2 * ng;
  const int mt = warp / ng, n0 = (warp % ng) * 16;
  // every load of the item first: windows, q, the warp's proc values
  constexpr int NWIN = PC_ET * PC_KC / PC_THREADS;
  float wv[NWIN], pv[2][4], qv = 0.0f;
#pragma unroll
  for (int it = 0; it < NWIN; ++it) {
    const int i = tid + it * PC_THREADS, tl = i / PC_KC, kc = i % PC_KC;
    const int pos = t0 + tl + (kc >> 1) - pad;
    const bool in = kc < 2 * ks && pos >= 0 && pos < T;
    wv[it] = in ? ((kc & 1) ? wc : w)[rT + pos] : 0.0f;
  }
  if (tid < D) qv = q[(size_t)row * D + tid];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int ee = 0; ee < 4; ++ee) {
      const int t = t0 + mt * 16 + g + (ee >> 1) * 8;
      const int d = n0 + j * 8 + 2 * t4 + (ee & 1);
      pv[j][ee] = busy && t < T ? to_f<bf16>(proc[(rT + t) * D + d]) : 0.0f;
    }
#pragma unroll
  for (int it = 0; it < NWIN; ++it) {
    const int i = tid + it * PC_THREADS;
    win[(i / PC_KC) * WLD + i % PC_KC] = from_f<bf16>(wv[it]);
  }
  if (tid < D) qs[tid] = qv;
  __syncthreads();
  if (busy) {
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int k16 = 0; k16 < PC_KC; k16 += 16) {
      uint32_t fa[4], fb[4];
      ldmatrix_x4(fa, &win[(mt * 16 + r8 + (mi & 1) * 8) * WLD + k16 +
                           (mi >> 1) * 8]);
      ldmatrix_x4_trans(fb, &k2s[(k16 + r8 + (mi & 1) * 8) * KLD + n0 +
                                 (mi >> 1) * 8]);
      mma_bf16(acc[0], fa, fb);
      mma_bf16(acc[1], fa, fb + 2);
    }
    float part[2] = {0.0f, 0.0f};   // positions g and g + 8 of the tile
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int ee = 0; ee < 4; ++ee) {
        const int d = n0 + j * 8 + 2 * t4 + (ee & 1);
        const float f = tanhf(qs[d] + acc[j][ee] + pv[j][ee]);
        part[ee >> 1] = fmaf(rnd<bf16>(f), vs[d], part[ee >> 1]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
    }
    if (t4 == 0) {
      red[(warp % ng) * PC_ET + mt * 16 + g] = part[0];
      red[(warp % ng) * PC_ET + mt * 16 + g + 8] = part[1];
    }
  }
  __syncthreads();
  if (tid < PC_ET && t0 + tid < T) {
    float s = 0.0f;
    for (int j = 0; j < ng; ++j) s += red[j * PC_ET + tid];
    e[rT + t0 + tid] = s;
  }
}

// Masked softmax of row `row` and PC_CTX context columns from c0
// (softmax_ctx_kernel's arithmetic); the item at c0 = 0 also stores w,
// w_cum and the align output. store(col, v) writes the context. sm: T +
// PC_THREADS + PC_CTX floats.
template <typename Store>
__device__ __forceinline__ void pc_softmax_ctx(
    const float* e, const float* __restrict__ emask,
    const bf16* __restrict__ mem, float* w, float* wc, float* align,
    const int* fin, int step, int B, int T, int E, int row, int c0,
    float* sm, Store store) {
  float* wn = sm;                  // T
  float* red = sm + T;             // PC_THREADS
  float* out = red + PC_THREADS;   // PC_CTX
  const size_t rT = (size_t)row * T;
  float mx = -INFINITY;
  for (int t = threadIdx.x; t < T; t += PC_THREADS) {
    const float x = e[rT + t] + emask[rT + t];
    wn[t] = x;
    mx = fmaxf(mx, x);
  }
  mx = pc_reduce(mx, red, true);
  float s = 0.0f;
  for (int t = threadIdx.x; t < T; t += PC_THREADS) {
    const float x = expf(wn[t] - mx);
    wn[t] = x;
    s += x;
  }
  s = pc_reduce(s, red, false);
  for (int t = threadIdx.x; t < T; t += PC_THREADS) wn[t] = wn[t] / s;
  __syncthreads();
  if (c0 == 0) {
    const bool done = fin[row] != 0;
    float* al = align + ((size_t)step * B + row) * T;
    for (int t = threadIdx.x; t < T; t += PC_THREADS) {
      w[rT + t] = wn[t];
      wc[rT + t] += wn[t];
      al[t] = done ? 0.0f : wn[t];
    }
  }
  const int ncols = min(PC_CTX, E - c0);
  block_matvec<bf16, PC_THREADS, PC_CTX>(wn, T, mem + rT * E, E, c0, ncols,
                                         red, out);
  if (threadIdx.x < ncols) store(c0 + threadIdx.x, out[threadIdx.x]);
}

template <int NB>
__global__ void __launch_bounds__(PC_THREADS, 1)
persistent_chunk_kernel(Persist P) {
  extern __shared__ __align__(16) unsigned char pc_raw[];
  const Chunk& c = P.c;
  float* sm = reinterpret_cast<float*>(pc_raw + P.offs);
  const int G = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
  const int B = c.B, A = c.A, D = c.D, E = c.E, p = c.p, n = c.n;
  const int K1 = P.K1, K2 = P.K2, Bp = P.Bp;
  const int nk1 = K1 / 16, nk2 = K2 / 16;
  // the block's weight tiles, copied into shared memory where resident
  const uint4* wb1[PC_UMAX];
  const uint4* wb2[PC_UMAX];
  uint4* r1 = reinterpret_cast<uint4*>(pc_raw);
  uint4* r2 = reinterpret_cast<uint4*>(pc_raw + P.off2);
#pragma unroll
  for (int j = 0; j < PC_UMAX; ++j) {
    const int gi = bid + j * G;
    wb1[j] = wb2[j] = nullptr;
    if (j < P.U && gi < A / PC_UG) {
      const uint4* src = P.w1f + (size_t)gi * nk1 * 32;
      if (P.res1) {
        uint4* dst = r1 + (size_t)j * nk1 * 32;
        for (int i = tid; i < nk1 * 32; i += PC_THREADS) dst[i] = src[i];
        src = dst;
      }
      wb1[j] = src;
    }
    if (j < P.U && gi < D / PC_UG) {
      const uint4* src = P.w2f + (size_t)gi * nk2 * 32;
      if (P.res2) {
        uint4* dst = r2 + (size_t)j * nk2 * 32;
        for (int i = tid; i < nk2 * 32; i += PC_THREADS) dst[i] = src[i];
        src = dst;
      }
      wb2[j] = src;
    }
  }
  // K2 as [2k + c][d] (bf16, zero rows past 2 ks) and v (fp32), resident
  bf16* k2s = reinterpret_cast<bf16*>(pc_raw + P.offk);
  float* vs = reinterpret_cast<float*>(k2s + PC_KC * (c.datt + 8));
  for (int i = tid; i < PC_KC * c.datt; i += PC_THREADS) {
    const int kc = i / c.datt, d = i % c.datt;
    k2s[kc * (c.datt + 8) + d] =
        kc < 2 * c.ks ? ((const bf16*)c.k2)[i] : from_f<bf16>(0.0f);
  }
  for (int d = tid; d < c.datt; d += PC_THREADS)
    vs[d] = to_f<bf16>(((const bf16*)c.v)[d]);
  // the incoming carry into the step-0 operand rows
  {
    bf16* x1 = P.x1;
    bf16* x2 = P.x2;
    const int stride = G * PC_THREADS;
    for (int i = bid * PC_THREADS + tid; i < B * E; i += stride)
      x1[(size_t)(i / E) * K1 + p + i % E] = from_f<bf16>(c.ctx[i]);
    for (int i = bid * PC_THREADS + tid; i < B * A; i += stride)
      x1[(size_t)(i / A) * K1 + p + E + i % A] = from_f<bf16>(c.h1[i]);
    for (int i = bid * PC_THREADS + tid; i < B * D; i += stride)
      x2[(size_t)(i / D) * K2 + A + E + i % D] = from_f<bf16>(c.h2[i]);
  }
  __syncthreads();
  const bf16 *pre1 = (const bf16*)c.pre1, *pre2 = (const bf16*)c.pre2;
  const bf16* wq = (const bf16*)c.wq;
  const bf16* wpe = (const bf16*)c.wpe;
  const bf16 *mem = (const bf16*)c.mem, *proc = (const bf16*)c.proc;
  const int n_pre = (p + PC_PRE - 1) / PC_PRE;
  const int n_q = (c.datt + PC_QCOLS - 1) / PC_QCOLS;
  const int n_e = (c.T + PC_ET - 1) / PC_ET;
  const int n_ctx = (E + PC_CTX - 1) / PC_CTX;
  const int n_proj = (n + 1 + PC_PROJ - 1) / PC_PROJ;
  unsigned target = 0;
  for (int st = 0; st < c.cs; ++st) {
    const int par = st & 1;
    bf16* x1i = P.x1 + (size_t)par * Bp * K1;
    bf16* x1o = P.x1 + (size_t)(par ^ 1) * Bp * K1;
    bf16* x2i = P.x2 + (size_t)par * Bp * K2;
    bf16* x2o = P.x2 + (size_t)(par ^ 1) * Bp * K2;
    float* h1_out = c.h1 + (size_t)(par ^ 1) * B * A;
    float* h2_out = c.h2 + (size_t)(par ^ 1) * B * D;
    const int* fin_in = c.fin + (size_t)par * B;
    int* fin_out = c.fin + (size_t)(par ^ 1) * B;
    // 1. prenet -> X1's first p columns
    for (int it = bid; it < B * n_pre; it += G) {
      const int row = it / n_pre;
      __syncthreads();
      pc_prenet(
          c.prev, pre1, pre2, c.kp1, c.kp2, st, B, n, p, row,
          (it % n_pre) * PC_PRE, sm, [&](int j, float s) {
            x1i[(size_t)row * K1 + j] = from_f<bf16>(s);
          });
    }
    grid_sync(P.bar, target);
    // 2. attention LSTM -> h1 (fp32), and into both X's
    pc_lstm<NB>(x1i, K1, wb1, bid, G, c.b1, c.c1, A, B, sm,
                [&](int row, int unit, float h) {
                  h1_out[(size_t)row * A + unit] = h;
                  const bf16 hb = from_f<bf16>(h);
                  x2i[(size_t)row * K2 + unit] = hb;
                  x1o[(size_t)row * K1 + p + E + unit] = hb;
                });
    grid_sync(P.bar, target);
    // 3. query
    for (int it = bid; it < B * n_q; it += G) {
      __syncthreads();
      pc_query(h1_out, wq, c.q, A, c.datt, it / n_q, (it % n_q) * PC_QCOLS,
               sm);
    }
    grid_sync(P.bar, target);
    // 4. energies
    for (int it = bid; it < B * n_e; it += G) {
      __syncthreads();
      pc_energy(c.q, c.w, c.wc, k2s, vs, proc, c.e, c.T, c.datt, c.ks,
                it / n_e, (it % n_e) * PC_ET, sm);
    }
    grid_sync(P.bar, target);
    // 5. softmax and context -> ctx (fp32), and into both X's
    for (int it = bid; it < B * n_ctx; it += G) {
      const int row = it / n_ctx;
      __syncthreads();
      pc_softmax_ctx(c.e, c.emask, mem, c.w, c.wc, c.align, fin_in, st, B,
                     c.T, E, row, (it % n_ctx) * PC_CTX, sm,
                     [&](int col, float val) {
                       c.ctx[(size_t)row * E + col] = val;
                       const bf16 vb = from_f<bf16>(val);
                       x2i[(size_t)row * K2 + A + col] = vb;
                       x1o[(size_t)row * K1 + p + col] = vb;
                     });
    }
    grid_sync(P.bar, target);
    // 6. decoder LSTM -> h2 (fp32), and into the next step's X2
    pc_lstm<NB>(x2i, K2, wb2, bid, G, c.b2, c.c2, D, B, sm,
                [&](int row, int unit, float h) {
                  h2_out[(size_t)row * D + unit] = h;
                  x2o[(size_t)row * K2 + A + E + unit] = from_f<bf16>(h);
                });
    grid_sync(P.bar, target);
    // 7. projection and latch
    for (int it = bid; it < B * n_proj; it += G) {
      __syncthreads();
      pc_proj(
          h2_out, c.ctx, wpe, c.bpe, c.mel, c.gate, c.prev, fin_in, fin_out,
          c.len, st, c.t0 + st, c.gate_logit, B, D, E, n, it / n_proj,
          (it % n_proj) * PC_PROJ, sm);
    }
    grid_sync(P.bar, target);
  }
}

// The persistent kernel's plan at these shapes: 0 and the grid, scratch
// layout and shared memory when it takes them (bf16, B <= 32 rows, LSTM
// widths in unit groups, depths in k16 steps, at most PC_UMAX groups a
// block, an attention width in 16s up to 128, at most PC_KC / 2 taps),
// else 1 (run<W> takes the chunk); < 0 a device query failed.
static int persistent_plan(const Chunk& c, Persist* P, size_t* smem) {
  const int K1 = c.p + c.E + c.A, K2 = c.A + c.E + c.D;
  if (c.B > 8 * PC_NBMAX || c.A % PC_UG || c.D % PC_UG || K1 % 16 ||
      K2 % 16 || c.datt % 16 || c.datt > 128 || 2 * c.ks > PC_KC)
    return 1;
  int dev, sms, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  const int groups = (c.A > c.D ? c.A : c.D) / PC_UG;
  const int U = (groups + sms - 1) / sms;
  if (U > PC_UMAX) return 1;
  const int NB = (c.B + 7) / 8;
  // the LSTM phases' partials
  size_t scratch = (size_t)PC_WARPS * PC_UMAX * 16 * NB * 8;
  const size_t phase[] = {
      (size_t)c.n + c.p + PC_PRE + PC_THREADS,
      (size_t)c.A + PC_THREADS + PC_QCOLS,
      (size_t)PC_ET * (PC_KC + 8) / 2 + c.datt + (c.datt / 16) * PC_ET,
      (size_t)c.T + PC_THREADS + PC_CTX,
      (size_t)c.D + c.E + PC_PROJ + PC_THREADS};
  for (size_t f : phase) scratch = f > scratch ? f : scratch;
  // K2 (bf16) and v (fp32) beside the phase scratch, 16-byte aligned
  const size_t k2b = ((size_t)PC_KC * (c.datt + 8) * sizeof(bf16) +
                      c.datt * sizeof(float) + 15) / 16 * 16;
  scratch = scratch * sizeof(float) + k2b;
  const size_t w1b = (size_t)U * K1 / 16 * 512, w2b = (size_t)U * K2 / 16 * 512;
  int res1 = 0, res2 = 0;
  if (w1b + w2b + scratch <= (size_t)optin) {
    res1 = res2 = 1;
  } else if (w2b + scratch <= (size_t)optin) {
    res2 = 1;
  } else if (scratch > (size_t)optin) {
    return 1;
  }
  P->c = c;
  P->K1 = K1, P->K2 = K2, P->U = U, P->Bp = NB * 8;
  P->res1 = res1, P->res2 = res2;
  P->off2 = (int)(res1 ? w1b : 0);
  P->offk = (int)(P->off2 + (res2 ? w2b : 0));
  P->offs = P->offk + (int)k2b;
  *smem = P->off2 + (res2 ? w2b : 0) + scratch;
  return 0;
}

// Bytes of scratch the persistent kernel takes: the barrier, then X1 and
// X2 for both step parities, rows padded to whole n8 tiles.
static size_t persistent_scratch(int B, int K1, int K2) {
  const size_t Bp = (B + 7) / 8 * 8;
  return PC_XOFF + 2 * Bp * (K1 + K2) * sizeof(bf16);
}

template <int NB>
static cudaError_t launch_persistent(Persist& P, size_t smem,
                                     cudaStream_t s) {
  auto kern = persistent_chunk_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      PC_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(sms),
                                    dim3(PC_THREADS), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

static cudaError_t run_persistent(Persist& P, size_t smem, void* scratch,
                                  cudaStream_t s) {
  const Chunk& c = P.c;
  const size_t bytes = persistent_scratch(c.B, P.K1, P.K2);
  cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, s);
  if (err != cudaSuccess) return err;
  P.bar = (unsigned*)scratch;
  P.x1 = (bf16*)((char*)scratch + PC_XOFF);
  P.x2 = P.x1 + 2 * (size_t)P.Bp * P.K1;
  switch (P.Bp / 8) {
    case 1: return launch_persistent<1>(P, smem, s);
    case 2: return launch_persistent<2>(P, smem, s);
    case 3: return launch_persistent<3>(P, smem, s);
    default: return launch_persistent<4>(P, smem, s);
  }
}

extern "C" {

// Runs cs decoder steps. h1 / h2 / fin point at (2, B, A) / (2, B, D) /
// (2, B) buffers whose slot 0 holds the incoming state; the final state
// lands in slot cs % 2. Every other carry is updated in place. w1f / w2f:
// the LSTM weights in mma fragment order (kernels/lstm_layout.py
// to_mma_tiles), or null; with them, a bf16 chunk at the shapes
// persistent_plan takes runs as one cooperative launch, using scratch
// (decoder_chunk_scratch bytes), else the per-step launches of run<W>.
// Returns cudaError_t.
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
                  float gate_logit, void* stream) {
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
    const int plan = persistent_plan(c, &P, &smem);
    if (plan < 0) return (int)cudaErrorInvalidDevice;
    if (plan == 0) {
      P.w1f = (const uint4*)w1f;
      P.w2f = (const uint4*)w2f;
      return (int)run_persistent(P, smem, scratch, s);
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
