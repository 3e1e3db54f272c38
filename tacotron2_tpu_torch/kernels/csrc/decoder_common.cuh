// Device code shared by the two serving decoders, the batched chunk
// (decoder_batch.cu) and the single-utterance chunk (decoder_step.cu): the
// prenet, the attention query and the mel + gate projection with the gate
// latch. One row per block, so both entry points launch them unchanged.
// Cast points are the TPU kernels': operands rounded to the operand type W
// before each product, fp32 sums.
#pragma once

#include <math.h>

#include "lstm_cell.cuh"

#define DEC_UNITS 8      // hidden units per LSTM block
#define DEC_THREADS 1024 // lstm, prenet, query, proj blocks
#define PRE_COLS 64      // second-layer prenet columns per block
#define PROJ_COLS 32     // projection columns per proj_kernel block
#define GATE_MASK 1e3f   // gate value of finished rows (reference model.py:495)

// 1. prenet: PRE_COLS columns of a2 (B, p) fp32 from prev (B, n) per
// block; every block of a row recomputes the whole first layer (n x p).
template <typename W>
__global__ void __launch_bounds__(DEC_THREADS)
prenet_kernel(const float* __restrict__ prev, const W* __restrict__ pre1,
              const W* __restrict__ pre2, const float* __restrict__ kp1,
              const float* __restrict__ kp2, float* __restrict__ a2, int step,
              int B, int n, int p) {
  constexpr int COLS1 = 256;
  extern __shared__ float sm[];
  float* pm = sm;           // n
  float* a1 = pm + n;       // p
  float* o2 = a1 + p;       // PRE_COLS
  float* red = o2 + PRE_COLS;  // DEC_THREADS
  const int row = blockIdx.y, c2 = blockIdx.x * PRE_COLS;
  for (int i = threadIdx.x; i < n; i += DEC_THREADS)
    pm[i] = rnd<W>(prev[(size_t)row * n + i]);
  __syncthreads();
  for (int c0 = 0; c0 < p; c0 += COLS1)
    block_matvec<W, DEC_THREADS, COLS1>(pm, n, pre1, p, c0, min(COLS1, p - c0),
                                        red, a1 + c0);
  const size_t kbase = ((size_t)step * B + row) * p;
  for (int j = threadIdx.x; j < p; j += DEC_THREADS) {
    float s = fmaxf(a1[j], 0.0f);
    if (kp1) s *= kp1[kbase + j] * 2.0f;
    a1[j] = rnd<W>(s);
  }
  __syncthreads();
  const int ncols = min(PRE_COLS, p - c2);
  block_matvec<W, DEC_THREADS, PRE_COLS>(a1, p, pre2, p, c2, ncols, red, o2);
  if (threadIdx.x < ncols) {
    const int j = c2 + threadIdx.x;
    float s = fmaxf(o2[threadIdx.x], 0.0f);
    if (kp2) s *= kp2[kbase + j] * 2.0f;
    a2[(size_t)row * p + j] = s;
  }
}

// 3. q (B, D) = h1 @ wq; 32 columns of one row per block. ROUND_Q rounds q
// to W (the batched TPU kernel rounds q into its cat vector before the
// location product; the single-utterance one keeps it in fp32).
template <typename W, bool ROUND_Q>
__global__ void __launch_bounds__(DEC_THREADS)
query_kernel(const float* __restrict__ h1, const W* __restrict__ wq,
             float* __restrict__ q, int A, int D) {
  extern __shared__ float sm[];
  float* hs = sm;             // A
  float* red = hs + A;        // DEC_THREADS
  float* out = red + DEC_THREADS;  // 32
  const int row = blockIdx.y, c0 = blockIdx.x * 32;
  const int ncols = min(32, D - c0);
  for (int i = threadIdx.x; i < A; i += DEC_THREADS)
    hs[i] = rnd<W>(h1[(size_t)row * A + i]);
  __syncthreads();
  block_matvec<W, DEC_THREADS, 32>(hs, A, wq, D, c0, ncols, red, out);
  if (threadIdx.x < ncols)
    q[(size_t)row * D + c0 + threadIdx.x] =
        ROUND_Q ? rnd<W>(out[threadIdx.x]) : out[threadIdx.x];
}

// 7. PROJ_COLS columns of the mel + gate projection of one row per block;
// the block holding the gate column also latches the row and counts its
// length. The latch reads fin_in and writes fin_out (double-buffered: other
// blocks of the launch read the row's old latch).
template <typename W>
__global__ void __launch_bounds__(DEC_THREADS)
proj_kernel(const float* __restrict__ h2, const float* __restrict__ ctx,
            const W* __restrict__ wpe, const float* __restrict__ bpe,
            float* __restrict__ mel, float* __restrict__ gate,
            float* __restrict__ prev, const int* __restrict__ fin_in,
            int* __restrict__ fin_out, int* __restrict__ len, int step,
            int t_abs, float gate_logit, int B, int D, int E, int n) {
  extern __shared__ float sm[];
  const int K = D + E, NO = n + 1;
  float* x3 = sm;                  // K
  float* outs = x3 + K;            // PROJ_COLS
  float* red = outs + PROJ_COLS;   // DEC_THREADS
  const int row = blockIdx.y, c0 = blockIdx.x * PROJ_COLS;
  const int ncols = min(PROJ_COLS, NO - c0);
  const bool done = fin_in[row] != 0;
  for (int k = threadIdx.x; k < K; k += DEC_THREADS)
    x3[k] = rnd<W>(k < D ? h2[(size_t)row * D + k] : ctx[(size_t)row * E + (k - D)]);
  __syncthreads();
  block_matvec<W, DEC_THREADS, PROJ_COLS>(x3, K, wpe, NO, c0, ncols, red, outs);
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
