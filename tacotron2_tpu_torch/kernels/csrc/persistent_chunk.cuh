// The persistent decoder chunk: one cooperative launch runs `cs`
// autoregressive Tacotron 2 decoder steps, at bf16, for the batched serving
// chunk (decoder_batch.cu, row 5 of PERF.md's kernel table) and for the
// single-utterance chunk (decoder_step.cu, row 6). The two TPU kernels those
// files replace cast at different points; the template parameter AT, the
// type of the attention's memory, processed memory and K2, carries the
// difference:
//   AT = bf16  (row 5, tacotron2_tpu/kernels/decoder_batch.py) the query
//              rounded to bf16, the location term an im2col bf16 tensor-core
//              product of the rounded windows, memory and processed memory
//              in bf16;
//   AT = float (row 6, tacotron2_tpu/kernels/decoder_step.py) the query, K2,
//              w, w_cum, the location term and the processed memory in
//              fp32 (the location term on CUDA cores), only tanh's output
//              rounded to bf16 before the v-product, and the context summed
//              from fp32 memory.
// Everything else -- prenet, both LSTMs on mma.sync in swap-AB form, the
// softmax, the projection and the gate latch -- is one code path.
#pragma once

#include <math.h>

#include <type_traits>

#include "attention.cuh"
#include "decoder_common.cuh"
#include "lstm_cell.cuh"
#include "mma.cuh"

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

// One cooperative launch runs the whole chunk: G blocks (one per SM, all
// resident at once: cudaLaunchCooperativeKernel refuses a grid the device
// cannot co-schedule) walk the chunk's steps, and a grid-wide barrier
// (grid_sync) stands where a launch boundary stood between the seven
// phases of a step. Every block reaches every barrier of every step,
// latched rows included. The prenet, query, softmax and context, and
// projection phases take the per-step kernels' arithmetic over (row
// group, column block) items, which the blocks share out; at AT = bf16 the
// energies are an im2col tensor-core product over (row group, 32
// positions) items, as the training scan rebuilds them, at AT = float an
// fp32 sum over (row, PC_EP positions) items; the LSTM phases are
// tensor-core products in swap-AB form.
//
// Row groups. An item takes a group of rows for its column or position
// block, and persistent_plan sizes the groups from B, T and the grid so
// that each of those five phases is one round of at most G items at any
// B <= 32 (one row an item where B rows of items fit the grid, as at
// B <= 8 and at B = 1). An item reads its weight slice once for all its
// rows and starts the rows' loads together, so a group costs about what
// one row does; a second round would be a second chain of L2 round trips
// in series. The work each item of a row repeats (the first prenet layer,
// the softmax) is done once per item of the row, as with one row an item.
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
// a thread per (unit, row); at NB = 4 one unit group's partials at a time,
// so that they leave the decoder LSTM's weights room in shared memory. X
// is built by the phases that produce its parts (prenet, context, h),
// double-buffered by step parity, so no phase reads a row another block
// is writing.
//
// What bounds it: latency. A step moves ~15 MB from L2 (the attention
// LSTM's weights) and does ~0.3 GFLOP, but it is seven phases, each a few
// dependent round trips to L2 and a grid barrier; on an NVIDIA H100 80GB
// HBM3 at 700 W a barrier alone costs ~1.6 us and a phase 3-6 us with its
// barrier at B <= 8; at B = 32 each LSTM phase ~13 us, the others 4.6-7.4
// (kernels/chunk_probe.py measures them). Fewer phases, not fewer bytes,
// is what moves it. At B = 1 (row 6) the same holds: the step
// barely computes, and its seven launches a step of the first design
// become seven grid barriers.

#define PC_THREADS 512
#define PC_WARPS (PC_THREADS / 32)
#define PC_UG 4         // hidden units per unit group (one m16 tile)
#define PC_UMAX 2       // unit groups a block owns in each LSTM
#define PC_NBMAX 4      // n8 tiles of rows: B <= 32
#define PC_ET 32        // positions per bf16 energy item (two m16 tiles)
#define PC_EP 4         // positions per fp32 energy item, 128 threads each
#define PC_KC 64        // im2col depth of the energies: 2 ks taps, padded
#define PC_CTX 64       // context columns per softmax item
#define PC_PRE 16       // second-layer prenet columns per item
#define PC_QCOLS 8      // query columns per item
#define PC_PROJ 8       // projection columns per item
#define PC_XOFF 256     // bytes before the operand rows in the scratch
#define PC_RM_MAT 4     // most rows an item of the prenet, query, projection
#define PC_RM_ATT 2     // most rows an item of the energies and the context
#define PC_NPH 5        // phases of items: prenet, query, energies, softmax
                        //   and context, projection

typedef __nv_bfloat16 bf16;

// The fp32 attention of the single-utterance TPU kernel (AT = float).
template <typename AT>
constexpr bool pc_f32att = std::is_same<AT, float>::value;

// The most rows an item takes (cap PC_RM_MAT or PC_RM_ATT) in a chunk of NB
// n8 tiles of rows: registers and shared memory hold that many.
__host__ __device__ constexpr int pc_rm(int cap, int NB) {
  return cap < NB ? cap : NB;
}

// Unit groups whose LSTM partials share the buffer at once: one at NB = 4,
// where both groups' (64 KB) would push the decoder LSTM's weights (160 KB
// at the default widths) out of shared memory.
__host__ __device__ constexpr int pc_lstm_groups(int NB) {
  return NB > 3 ? 1 : PC_UMAX;
}

struct Persist {
  Chunk c;
  const uint4 *w1f, *w2f;  // (H / PC_UG, K / 16, 32 lanes) x 16 bytes
  bf16 *x1, *x2;           // (2, Bp, K1), (2, Bp, K2): X by step parity
  unsigned* bar;           // grid barrier: the count of arrivals
  int Bp, K1, K2, U;       // U unit groups a block owns in each LSTM
  int res1, res2;          // LSTM weights resident in shared memory
  int off2, offk, offs;    // bytes: w2's resident copy, K2 and v, the
                           //   phase scratch
  int nb[PC_NPH];          // column or position blocks a row, by phase
  int rows[PC_NPH];        // rows an item, by phase
  int items[PC_NPH];       // items, by phase: nb times the row groups
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

// The product of a row group with ncols <= COLS columns of a row-major
// matrix: out[r * old + c] = sum_{k<K} x[r * K + k] * w_r[k * ld + c0 + c]
// for the RM rows of x (shared memory), w_r = w + r * wrs where PERROW
// (each row its own matrix: the context's memory), else w (one matrix for
// all rows, each weight read once for all of them). Rows from nr on hold
// anything: their sums are left out, and PERROW reads row nr - 1 for them.
// block_matvec's layout and order of sums: COLS columns x PC_THREADS / COLS
// slices of K, T2_LOADS loads in flight a thread, each row's sum in k order
// within a thread, then the slices in order (with TREE across each warp's
// lanes first, then in warp order), so at RM = 1 the bits are
// block_matvec's. red: RM * PC_THREADS floats. Ends with __syncthreads.
template <typename W, int RM, int COLS, bool TREE, bool PERROW>
__device__ __forceinline__ void pc_matvec(const float* x, int K,
                                          const W* __restrict__ w,
                                          size_t ld, size_t wrs, int c0,
                                          int ncols, int nr, float* red,
                                          float* out, int old) {
  constexpr int KSPLIT = PC_THREADS / COLS;
  constexpr int NW = PERROW ? RM : 1;      // weight rows a k step
  constexpr int NL = T2_LOADS / NW;        // k steps a batch of loads
  const int cl = threadIdx.x % COLS, ks = threadIdx.x / COLS;
  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.0f;
  if (cl < ncols) {
    const W* wc[NW];
#pragma unroll
    for (int q = 0; q < NW; ++q)
      wc[q] = w + (size_t)min(q, nr - 1) * wrs + c0 + cl;
    int k = ks;
    for (; k + (NL - 1) * KSPLIT < K; k += NL * KSPLIT) {
      float wv[NL][NW];
#pragma unroll
      for (int j = 0; j < NL; ++j)
#pragma unroll
        for (int q = 0; q < NW; ++q)
          wv[j][q] = to_f<W>(wc[q][(size_t)(k + j * KSPLIT) * ld]);
#pragma unroll
      for (int j = 0; j < NL; ++j)
#pragma unroll
        for (int r = 0; r < RM; ++r)
          acc[r] = fmaf(x[r * K + k + j * KSPLIT], wv[j][PERROW ? r : 0],
                        acc[r]);
    }
    for (; k < K; k += KSPLIT)
#pragma unroll
      for (int r = 0; r < RM; ++r)
        acc[r] = fmaf(x[r * K + k],
                      to_f<W>(wc[PERROW ? r : 0][(size_t)k * ld]), acc[r]);
  }
  if constexpr (TREE) {
    static_assert(COLS < 32 && 32 % COLS == 0, "TREE: lanes share columns");
    static_assert(RM * COLS <= PC_THREADS, "a thread a sum");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      for (int o = COLS; o < 32; o <<= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
      if (lane < COLS) red[(r * PC_WARPS + warp) * COLS + lane] = acc[r];
    }
    __syncthreads();
    const int r = threadIdx.x / COLS, c = threadIdx.x % COLS;
    if (r < nr && c < ncols) {
      float s = 0.0f;
      for (int j = 0; j < PC_WARPS; ++j) s += red[(r * PC_WARPS + j) * COLS + c];
      out[r * old + c] = s;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RM; ++r) red[r * PC_THREADS + threadIdx.x] = acc[r];
    __syncthreads();
    for (int i = threadIdx.x; i < RM * COLS; i += PC_THREADS) {
      const int r = i / COLS, c = i % COLS;
      if (r >= nr || c >= ncols) continue;
      float s = 0.0f;
      for (int j = 0; j < KSPLIT; ++j) s += red[r * PC_THREADS + j * COLS + c];
      out[r * old + c] = s;
    }
  }
  __syncthreads();
}

// Block-wide max (is_max) or sum of each of the RM values v[r] over
// PC_THREADS threads, each in the order of one block reduction (warp
// shuffles, then the warps' results by warp 0's shuffles); every thread
// gets the results. red: RM * (PC_WARPS + 1) floats.
template <int RM>
__device__ void pc_reduce(float (&v)[RM], float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    v[r] = is_max ? warp_max(v[r]) : warp_sum(v[r]);
    if (lane == 0) red[r * PC_WARPS + warp] = v[r];
  }
  __syncthreads();
  if (warp < RM) {
    float x = lane < PC_WARPS ? red[warp * PC_WARPS + lane]
                              : (is_max ? -INFINITY : 0.0f);
    x = is_max ? warp_max(x) : warp_sum(x);
    if (lane == 0) red[RM * PC_WARPS + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RM; ++r) v[r] = red[RM * PC_WARPS + r];
  __syncthreads();
}

// The prenet, query and projection items: the arithmetic of
// decoder_common.cuh's kernels over (row group, column block) items, rows
// r0 .. r0 + nr - 1 (nr <= RM), with narrow column blocks and
// block_matvec's TREE sums. Values other blocks write during the launch
// (prev, h1, h2, ctx, the latch) are read through plain pointers, never the
// read-only path.

// PC_PRE columns of a2 from c2 for the group's rows; every item recomputes
// its rows' first layer. store(row, j, value) writes column j. sm: RM (n +
// p + PC_PRE + PC_THREADS) floats.
template <int RM, typename Store>
__device__ __forceinline__ void pc_prenet(
    const float* prev, const bf16* __restrict__ pre1,
    const bf16* __restrict__ pre2, const float* __restrict__ kp1,
    const float* __restrict__ kp2, int step, int B, int n, int p, int r0,
    int nr, int c2, float* sm, Store store) {
  constexpr int COLS1 = 256;
  float* pm = sm;                  // [RM][n]
  float* a1 = pm + RM * n;         // [RM][p]
  float* o2 = a1 + RM * p;         // [RM][PC_PRE]
  float* red = o2 + RM * PC_PRE;   // RM * PC_THREADS
  for (int i = threadIdx.x; i < nr * n; i += PC_THREADS)
    pm[i] = rnd<bf16>(prev[(size_t)r0 * n + i]);
  __syncthreads();
  for (int c0 = 0; c0 < p; c0 += COLS1)
    pc_matvec<bf16, RM, COLS1, false, false>(pm, n, pre1, p, 0, c0,
                                             min(COLS1, p - c0), nr, red,
                                             a1 + c0, p);
  const size_t kbase = ((size_t)step * B + r0) * p;
  for (int i = threadIdx.x; i < nr * p; i += PC_THREADS) {
    float s = fmaxf(a1[i], 0.0f);
    if (kp1) s *= kp1[kbase + i] * 2.0f;
    a1[i] = rnd<bf16>(s);
  }
  __syncthreads();
  const int ncols = min(PC_PRE, p - c2);
  pc_matvec<bf16, RM, PC_PRE, true, false>(a1, p, pre2, p, 0, c2, ncols, nr,
                                           red, o2, PC_PRE);
  if (threadIdx.x < nr * PC_PRE && threadIdx.x % PC_PRE < ncols) {
    const int r = threadIdx.x / PC_PRE, j = c2 + threadIdx.x % PC_PRE;
    float s = fmaxf(o2[threadIdx.x], 0.0f);
    if (kp2) s *= kp2[kbase + (size_t)r * p + j] * 2.0f;
    store(r0 + r, j, s);
  }
}

// q (B, D) = W(h1) @ wq, rounded to bf16 where ROUND_Q (row 5; row 6 keeps
// it in fp32): PC_QCOLS columns from c0 of the group's rows. sm: RM (A +
// PC_THREADS + PC_QCOLS) floats.
template <bool ROUND_Q, int RM>
__device__ __forceinline__ void pc_query(const float* h1,
                                         const bf16* __restrict__ wq,
                                         float* q, int A, int D, int r0,
                                         int nr, int c0, float* sm) {
  float* hs = sm;                        // [RM][A]
  float* red = hs + RM * A;              // RM * PC_THREADS
  float* out = red + RM * PC_THREADS;    // [RM][PC_QCOLS]
  const int ncols = min(PC_QCOLS, D - c0);
  for (int i = threadIdx.x; i < nr * A; i += PC_THREADS)
    hs[i] = rnd<bf16>(h1[(size_t)r0 * A + i]);
  __syncthreads();
  pc_matvec<bf16, RM, PC_QCOLS, true, false>(hs, A, wq, D, 0, c0, ncols, nr,
                                             red, out, PC_QCOLS);
  if (threadIdx.x < nr * PC_QCOLS && threadIdx.x % PC_QCOLS < ncols) {
    const int r = threadIdx.x / PC_QCOLS, cc = threadIdx.x % PC_QCOLS;
    const float v = out[threadIdx.x];
    q[(size_t)(r0 + r) * D + c0 + cc] = ROUND_Q ? rnd<bf16>(v) : v;
  }
}

// PC_PROJ columns from c0 of the mel + gate projection of the group's rows;
// the item holding the gate column latches its rows (reads fin_in, writes
// fin_out) and counts their lengths. sm: RM (D + E + PC_PROJ + PC_THREADS)
// floats.
template <int RM>
__device__ __forceinline__ void pc_proj(
    const float* h2, const float* ctx, const bf16* __restrict__ wpe,
    const float* __restrict__ bpe, float* mel, float* gate, float* prev,
    const int* fin_in, int* fin_out, int* len, int step, int t_abs,
    float gate_logit, int B, int D, int E, int n, int r0, int nr, int c0,
    float* sm) {
  const int K = D + E, NO = n + 1;
  float* x3 = sm;                        // [RM][K]
  float* outs = x3 + RM * K;             // [RM][PC_PROJ]
  float* red = outs + RM * PC_PROJ;      // RM * PC_THREADS
  const int ncols = min(PC_PROJ, NO - c0);
  for (int i = threadIdx.x; i < nr * K; i += PC_THREADS) {
    const int row = r0 + i / K, k = i % K;
    x3[i] = rnd<bf16>(k < D ? h2[(size_t)row * D + k]
                            : ctx[(size_t)row * E + (k - D)]);
  }
  __syncthreads();
  pc_matvec<bf16, RM, PC_PROJ, true, false>(x3, K, wpe, NO, 0, c0, ncols, nr,
                                            red, outs, PC_PROJ);
  if (threadIdx.x >= nr * PC_PROJ || threadIdx.x % PC_PROJ >= ncols) return;
  const int row = r0 + threadIdx.x / PC_PROJ;
  const int col = c0 + threadIdx.x % PC_PROJ;
  const bool done = fin_in[row] != 0;
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
// place. The partials pass through red pc_lstm_groups(NB) unit groups at a
// time, each group's cell after its pass: red holds PC_WARPS *
// pc_lstm_groups(NB) * 16 * NB * 8 floats.
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
  constexpr int LD = NB * 8, JS = pc_lstm_groups(NB);
#pragma unroll
  for (int j0 = 0; j0 < PC_UMAX; j0 += JS) {
    if (!wb[j0]) break;   // the same in every thread of the block
#pragma unroll
    for (int j = j0; j < j0 + JS; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((warp * JS + j - j0) * 16 + g + (e >> 1) * 8) * LD + nb * 8 +
              2 * t4 + (e & 1)] = acc[j][nb][e];
    __syncthreads();
    // the cell, a thread per (group, unit, row); the warps' partials in order
    for (int i = threadIdx.x; i < JS * PC_UG * B; i += PC_THREADS) {
      const int j = i / (PC_UG * B), u = (i / B) % PC_UG, row = i % B;
      const int unit = (g0 + (j0 + j) * G) * PC_UG + u;
      if (unit >= H) continue;
      float gq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.0f;
        for (int w = 0; w < PC_WARPS; ++w)
          s += red[((w * JS + j) * 16 + q * PC_UG + u) * LD + row];
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
}

// Energies of PC_ET positions from t0 of the group's rows r0 .. r0 + nr - 1
// (nr <= RM): the location term as an im2col bf16 mma.sync product, windows
// (PC_ET x PC_KC taps) @ K2 (PC_KC x D), then e[t] = sum_d W(tanh(q + loc +
// proc)) v[d] (the cast points of energy_kernel; the sums in another
// order). k2s: K2 as [2k + c][d] in bf16, rows of D + 8, zero rows past 2
// ks; vs: v in fp32; both resident. Warp w takes 16 positions x 16 columns
// of every row of the group (tile w: m16 tile w / (D / 16), n16 group w %
// (D / 16)); all rows' loads are started before any product. sm: RM (PC_ET *
// (PC_KC + 8) / 2 + D + (D / 16) * PC_ET) floats.
template <int RM>
__device__ __forceinline__ void pc_energy(
    const float* q, const float* w, const float* wc, const bf16* k2s,
    const float* vs, const bf16* __restrict__ proc, float* e, int T, int D,
    int ks, int r0, int nr, int t0, float* sm) {
  constexpr int WLD = PC_KC + 8;
  bf16* win = reinterpret_cast<bf16*>(sm);          // [RM][PC_ET][WLD]
  float* qs = sm + RM * PC_ET * WLD / 2;            // [RM][D]
  float* red = qs + RM * D;                         // [RM][D / 16][PC_ET]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const int pad = (ks - 1) / 2, ng = D / 16, KLD = D + 8;
  const bool busy = warp < 2 * ng;
  const int mt = warp / ng, n0 = (warp % ng) * 16;
  // every load of the item first: windows, q, the warp's proc values
  constexpr int NWIN = PC_ET * PC_KC / PC_THREADS;
  float wv[RM][NWIN], pv[RM][2][4], qv[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const bool live = r < nr;
    const size_t rT = (size_t)(r0 + r) * T;
#pragma unroll
    for (int it = 0; it < NWIN; ++it) {
      const int i = tid + it * PC_THREADS, tl = i / PC_KC, kc = i % PC_KC;
      const int pos = t0 + tl + (kc >> 1) - pad;
      const bool in = live && kc < 2 * ks && pos >= 0 && pos < T;
      wv[r][it] = in ? ((kc & 1) ? wc : w)[rT + pos] : 0.0f;
    }
    qv[r] = live && tid < D ? q[(size_t)(r0 + r) * D + tid] : 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int ee = 0; ee < 4; ++ee) {
        const int t = t0 + mt * 16 + g + (ee >> 1) * 8;
        const int d = n0 + j * 8 + 2 * t4 + (ee & 1);
        pv[r][j][ee] = live && busy && t < T
                           ? to_f<bf16>(proc[(rT + t) * D + d]) : 0.0f;
      }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int it = 0; it < NWIN; ++it) {
      const int i = tid + it * PC_THREADS;
      win[(r * PC_ET + i / PC_KC) * WLD + i % PC_KC] = from_f<bf16>(wv[r][it]);
    }
    if (tid < D) qs[r * D + tid] = qv[r];
  }
  __syncthreads();
  if (busy) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= nr) break;
      const bf16* wr = win + r * PC_ET * WLD;
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int k16 = 0; k16 < PC_KC; k16 += 16) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4(fa, &wr[(mt * 16 + r8 + (mi & 1) * 8) * WLD + k16 +
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
          const float f = tanhf(qs[r * D + d] + acc[j][ee] + pv[r][j][ee]);
          part[ee >> 1] = fmaf(rnd<bf16>(f), vs[d], part[ee >> 1]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      }
      if (t4 == 0) {
        float* rr = red + (r * ng + warp % ng) * PC_ET + mt * 16 + g;
        rr[0] = part[0];
        rr[8] = part[1];
      }
    }
  }
  __syncthreads();
  const int r = tid / PC_ET, tl = tid % PC_ET;
  if (r < nr && t0 + tl < T) {
    float s = 0.0f;
    for (int j = 0; j < ng; ++j) s += red[(r * ng + j) * PC_ET + tl];
    e[(size_t)(r0 + r) * T + t0 + tl] = s;
  }
}

// Energies of PC_EP positions from t0 of row `row` with the
// single-utterance TPU kernel's cast points (energy_kernel<W, float>): the
// location term in fp32, from the fp32 K2 and the unrounded w and w_cum
// windows, q and proc in fp32, only tanh's output rounded to bf16 before
// the v-product. Thread i takes position i / 128 and the columns
// i % 128 + 128 j; each position's 4 warp sums are added in warp order.
// k2s: K2 (ks, 2, D) fp32, resident; vs: v in fp32. sm: 2 (PC_EP + ks - 1)
// + PC_WARPS floats.
__device__ __forceinline__ void pc_energy_f32(
    const float* q, const float* w, const float* wc, const float* k2s,
    const float* vs, const float* __restrict__ proc, float* e, int T, int D,
    int ks, int row, int t0, float* sm) {
  static_assert(PC_THREADS == 128 * PC_EP, "128 threads a position");
  const int pad = (ks - 1) / 2, ww = PC_EP + ks - 1;
  float* win0 = sm;            // w window, positions t0-pad .. t0+PC_EP+pad
  float* win1 = win0 + ww;     // w_cum window
  float* red = win1 + ww;      // PC_WARPS
  const size_t rT = (size_t)row * T;
  for (int j = threadIdx.x; j < ww; j += PC_THREADS) {
    const int pos = t0 - pad + j;
    const bool in = pos >= 0 && pos < T;
    win0[j] = in ? w[rT + pos] : 0.0f;
    win1[j] = in ? wc[rT + pos] : 0.0f;
  }
  __syncthreads();
  const int tl = threadIdx.x >> 7, t = t0 + tl;
  float acc = 0.0f;
  if (t < T) {
    for (int d = threadIdx.x & 127; d < D; d += 128) {
      float m = q[(size_t)row * D + d];
      for (int k = 0; k < ks; ++k) {
        m = fmaf(k2s[(2 * k) * D + d], win0[tl + k], m);
        m = fmaf(k2s[(2 * k + 1) * D + d], win1[tl + k], m);
      }
      const float f = tanhf(m + proc[(rT + t) * D + d]);
      acc = fmaf(rnd<bf16>(f), vs[d], acc);
    }
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < PC_EP && t0 + threadIdx.x < T) {
    const float* r = red + threadIdx.x * 4;
    e[rT + t0 + threadIdx.x] = ((r[0] + r[1]) + r[2]) + r[3];
  }
}

// Masked softmax of the group's rows r0 .. r0 + nr - 1 (nr <= RM) and
// PC_CTX context columns from c0 (softmax_ctx_kernel's arithmetic); the
// item at c0 = 0 also stores their w, w_cum and align output; the context
// sums fp32 weights times memory in AT, each row from its own memory.
// store(row, col, v) writes the context. sm: RM (T + PC_THREADS + PC_CTX)
// floats.
template <typename AT, int RM, typename Store>
__device__ __forceinline__ void pc_softmax_ctx(
    const float* e, const float* __restrict__ emask,
    const AT* __restrict__ mem, float* w, float* wc, float* align,
    const int* fin, int step, int B, int T, int E, int r0, int nr, int c0,
    float* sm, Store store) {
  float* wn = sm;                        // [RM][T]
  float* red = wn + RM * T;              // RM * PC_THREADS
  float* out = red + RM * PC_THREADS;    // [RM][PC_CTX]
  const size_t rT = (size_t)r0 * T;
  float mx[RM], s[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    mx[r] = -INFINITY;
    if (r >= nr) continue;
    for (int t = threadIdx.x; t < T; t += PC_THREADS) {
      const size_t i = rT + (size_t)r * T + t;
      const float x = e[i] + emask[i];
      wn[r * T + t] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  pc_reduce<RM>(mx, red, true);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    s[r] = 0.0f;
    if (r >= nr) continue;
    for (int t = threadIdx.x; t < T; t += PC_THREADS) {
      const float x = expf(wn[r * T + t] - mx[r]);
      wn[r * T + t] = x;
      s[r] += x;
    }
  }
  pc_reduce<RM>(s, red, false);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r >= nr) continue;
    for (int t = threadIdx.x; t < T; t += PC_THREADS)
      wn[r * T + t] = wn[r * T + t] / s[r];
  }
  __syncthreads();
  if (c0 == 0) {
    for (int i = threadIdx.x; i < nr * T; i += PC_THREADS) {
      const int row = r0 + i / T;
      const bool done = fin[row] != 0;
      w[rT + i] = wn[i];
      wc[rT + i] += wn[i];
      align[((size_t)step * B + r0) * T + i] = done ? 0.0f : wn[i];
    }
  }
  const int ncols = min(PC_CTX, E - c0);
  pc_matvec<AT, RM, PC_CTX, false, true>(wn, T, mem + rT * E, E,
                                         (size_t)T * E, c0, ncols, nr, red,
                                         out, PC_CTX);
  if (threadIdx.x < nr * PC_CTX && threadIdx.x % PC_CTX < ncols)
    store(r0 + threadIdx.x / PC_CTX, c0 + threadIdx.x % PC_CTX,
          out[threadIdx.x]);
}

template <int NB, typename AT>
__global__ void __launch_bounds__(PC_THREADS, 1)
persistent_chunk_kernel(Persist P) {
  constexpr bool F32 = pc_f32att<AT>;
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
  // K2 and v (fp32), resident: K2 as [2k + c][d], in bf16 with zero rows
  // past 2 ks for the im2col product (AT = bf16), as given in fp32 else
  bf16* k2s = reinterpret_cast<bf16*>(pc_raw + P.offk);
  float* k2f = reinterpret_cast<float*>(pc_raw + P.offk);
  float* vs = F32 ? k2f + 2 * c.ks * c.datt
                  : reinterpret_cast<float*>(k2s + PC_KC * (c.datt + 8));
  if constexpr (F32) {
    for (int i = tid; i < 2 * c.ks * c.datt; i += PC_THREADS)
      k2f[i] = ((const float*)c.k2)[i];
  } else {
    for (int i = tid; i < PC_KC * c.datt; i += PC_THREADS) {
      const int kc = i / c.datt, d = i % c.datt;
      k2s[kc * (c.datt + 8) + d] =
          kc < 2 * c.ks ? ((const bf16*)c.k2)[i] : from_f<bf16>(0.0f);
    }
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
  const AT *mem = (const AT*)c.mem, *proc = (const AT*)c.proc;
  // item it of phase ph takes rows r0 .. r0 + nr - 1 and block it % nb
  constexpr int RMM = pc_rm(PC_RM_MAT, NB), RMA = pc_rm(PC_RM_ATT, NB);
  auto item = [&](int ph, int it, int& r0, int& nr) {
    r0 = it / P.nb[ph] * P.rows[ph];
    nr = min(P.rows[ph], B - r0);
    return it % P.nb[ph];
  };
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
    for (int it = bid; it < P.items[0]; it += G) {
      int r0, nr;
      const int cb = item(0, it, r0, nr);
      __syncthreads();
      pc_prenet<RMM>(
          c.prev, pre1, pre2, c.kp1, c.kp2, st, B, n, p, r0, nr,
          cb * PC_PRE, sm, [&](int row, int j, float s) {
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
    for (int it = bid; it < P.items[1]; it += G) {
      int r0, nr;
      const int cb = item(1, it, r0, nr);
      __syncthreads();
      pc_query<!F32, RMM>(h1_out, wq, c.q, A, c.datt, r0, nr, cb * PC_QCOLS,
                          sm);
    }
    grid_sync(P.bar, target);
    // 4. energies
    for (int it = bid; it < P.items[2]; it += G) {
      int r0, nr;
      const int cb = item(2, it, r0, nr);
      __syncthreads();
      if constexpr (F32)   // one row an item (persistent_plan)
        pc_energy_f32(c.q, c.w, c.wc, k2f, vs, proc, c.e, c.T, c.datt, c.ks,
                      r0, cb * PC_EP, sm);
      else
        pc_energy<RMA>(c.q, c.w, c.wc, k2s, vs, proc, c.e, c.T, c.datt,
                       c.ks, r0, nr, cb * PC_ET, sm);
    }
    grid_sync(P.bar, target);
    // 5. softmax and context -> ctx (fp32), and into both X's
    for (int it = bid; it < P.items[3]; it += G) {
      int r0, nr;
      const int cb = item(3, it, r0, nr);
      __syncthreads();
      pc_softmax_ctx<AT, RMA>(c.e, c.emask, mem, c.w, c.wc, c.align, fin_in,
                              st, B, c.T, E, r0, nr, cb * PC_CTX, sm,
                              [&](int row, int col, float val) {
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
    for (int it = bid; it < P.items[4]; it += G) {
      int r0, nr;
      const int cb = item(4, it, r0, nr);
      __syncthreads();
      pc_proj<RMM>(
          h2_out, c.ctx, wpe, c.bpe, c.mel, c.gate, c.prev, fin_in, fin_out,
          c.len, st, c.t0 + st, c.gate_logit, B, D, E, n, r0, nr,
          cb * PC_PROJ, sm);
    }
    grid_sync(P.bar, target);
  }
}

// The persistent kernel's plan at these shapes: 0 and the grid, scratch
// layout and shared memory when it takes them (bf16 weights, B <= 32 rows,
// LSTM widths in unit groups, depths in k16 steps, at most PC_UMAX groups a
// block, an attention width in 16s up to 128, at most PC_KC / 2 taps),
// else 1 (the caller's per-step launches take the chunk); < 0 a device
// query failed. With the plan, rounds (if not null) gets the rounds of
// items each of the PC_NPH phases takes: ceil(items / grid).
template <typename AT>
static int persistent_plan(const Chunk& c, Persist* P, size_t* smem,
                           int* rounds) {
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
  // Row groups: each phase's blocks a row, and the fewest rows an item
  // that fit its items in one round of the grid, up to what an item holds
  // (fp32 energies: one row)
  const int rmm = pc_rm(PC_RM_MAT, NB), rma = pc_rm(PC_RM_ATT, NB);
  const int nb[PC_NPH] = {
      (c.p + PC_PRE - 1) / PC_PRE, (c.datt + PC_QCOLS - 1) / PC_QCOLS,
      pc_f32att<AT> ? (c.T + PC_EP - 1) / PC_EP : (c.T + PC_ET - 1) / PC_ET,
      (c.E + PC_CTX - 1) / PC_CTX, (c.n + 1 + PC_PROJ - 1) / PC_PROJ};
  const int rm[PC_NPH] = {rmm, rmm, pc_f32att<AT> ? 1 : rma, rma, rmm};
  int rows[PC_NPH], items[PC_NPH];
  for (int i = 0; i < PC_NPH; ++i) {
    const int fit = sms / nb[i] > 1 ? sms / nb[i] : 1;   // groups a round
    const int r = (c.B + fit - 1) / fit;
    rows[i] = r < rm[i] ? r : rm[i];
    items[i] = nb[i] * ((c.B + rows[i] - 1) / rows[i]);
  }
  // the LSTM phases' partials, then each phase's scratch
  size_t scratch = (size_t)PC_WARPS * pc_lstm_groups(NB) * 16 * NB * 8;
  const size_t phase[] = {
      (size_t)rmm * (c.n + c.p + PC_PRE + PC_THREADS),
      (size_t)rmm * (c.A + PC_THREADS + PC_QCOLS),
      pc_f32att<AT> ? (size_t)2 * (PC_EP + c.ks - 1) + PC_WARPS
                    : (size_t)rma * (PC_ET * (PC_KC + 8) / 2 + c.datt +
                                     (c.datt / 16) * PC_ET),
      (size_t)rma * (c.T + PC_THREADS + PC_CTX),
      (size_t)rmm * (c.D + c.E + PC_PROJ + PC_THREADS)};
  for (size_t f : phase) scratch = f > scratch ? f : scratch;
  // K2 (bf16 im2col rows, or fp32) and v (fp32) beside the phase
  // scratch, 16-byte aligned
  const size_t k2e = pc_f32att<AT>
                         ? (size_t)2 * c.ks * c.datt * sizeof(float)
                         : (size_t)PC_KC * (c.datt + 8) * sizeof(bf16);
  const size_t k2b = (k2e + c.datt * sizeof(float) + 15) / 16 * 16;
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
  for (int i = 0; i < PC_NPH; ++i) {
    P->nb[i] = nb[i], P->rows[i] = rows[i], P->items[i] = items[i];
    if (rounds) rounds[i] = (items[i] + sms - 1) / sms;
  }
  return 0;
}

// Bytes of scratch the persistent kernel takes: the barrier, then X1 and
// X2 for both step parities, rows padded to whole n8 tiles.
static size_t persistent_scratch(int B, int K1, int K2) {
  const size_t Bp = (B + 7) / 8 * 8;
  return PC_XOFF + 2 * Bp * (K1 + K2) * sizeof(bf16);
}

template <int NB, typename AT>
static cudaError_t launch_persistent(Persist& P, size_t smem,
                                     cudaStream_t s) {
  auto kern = persistent_chunk_kernel<NB, AT>;
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

template <typename AT>
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
    case 1: return launch_persistent<1, AT>(P, smem, s);
    case 2: return launch_persistent<2, AT>(P, smem, s);
    case 3: return launch_persistent<3, AT>(P, smem, s);
    default: return launch_persistent<4, AT>(P, smem, s);
  }
}
