// Device code of the location-sensitive attention of the teacher-forced
// training scan (train_scan.cu): the energies
//   e[t] = v . tanh(q + loc[t] + proc[t]),
//   loc[t] = sum_k sum_c K2[k,c,:] * [w ; w_cum][c, t+k-pad]
// (K2 = the location conv folded through the location dense), then the
// masked softmax (additive mask, -1e30 at padding) and the context.
// Cast points are the TPU kernels': q, K2, v, w and w_cum as operands
// rounded to W, tanh in fp32 and rounded to W before the v-product, the
// softmax in fp32, ctx = sum_t w(fp32) * mem(W) with fp32 sums.
#pragma once

#include <math.h>

#include "lstm_cell.cuh"

#define E_TILE 8         // encoder positions per energy_kernel block
#define SM_THREADS 256   // energy and softmax_ctx blocks
#define CTX_COLS 64      // context columns per softmax_ctx_kernel block
static_assert(E_TILE * 32 == SM_THREADS, "energy_kernel: one warp per position");

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max (is_max) or sum of v over SM_THREADS threads; every thread
// gets the result.
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < SM_THREADS / 32 ? red[lane] : (is_max ? -INFINITY : 0.0f);
    r = is_max ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// Attention energies e (B, T) for E_TILE positions of one row. Thread
// layout: one warp per position, its 32 lanes over the attention dim.
template <typename W>
__global__ void __launch_bounds__(SM_THREADS)
energy_kernel(const float* __restrict__ q, const float* __restrict__ w,
              const float* __restrict__ wc, const W* __restrict__ k2,
              const W* __restrict__ v, const W* __restrict__ proc,
              float* __restrict__ e, int T, int D, int ks) {
  extern __shared__ float sm[];
  const int row = blockIdx.y, t0 = blockIdx.x * E_TILE;
  const int pad = (ks - 1) / 2, ww = E_TILE + ks - 1;
  float* k2s = sm;             // (ks, 2, D)
  float* qs = k2s + ks * 2 * D;
  float* vs = qs + D;
  float* win0 = vs + D;        // w window, positions t0-pad .. t0+E_TILE+pad
  float* win1 = win0 + ww;     // w_cum window
  float* pr = win1 + ww;       // proc of the block's positions (E_TILE, D)
  const int nt = min(E_TILE, T - t0);
  stage<W, SM_THREADS>(k2s, k2, ks * 2 * D);
  stage<W, SM_THREADS>(pr, proc + ((size_t)row * T + t0) * D, nt * D);
  for (int i = threadIdx.x; i < D; i += SM_THREADS) {
    qs[i] = q[(size_t)row * D + i];
    vs[i] = to_f<W>(v[i]);
  }
  for (int j = threadIdx.x; j < ww; j += SM_THREADS) {
    const int pos = t0 - pad + j;
    const bool in = pos >= 0 && pos < T;
    win0[j] = in ? rnd<W>(w[(size_t)row * T + pos]) : 0.0f;
    win1[j] = in ? rnd<W>(wc[(size_t)row * T + pos]) : 0.0f;
  }
  __syncthreads();
  const int dg = threadIdx.x & 31, tl = threadIdx.x >> 5;
  const int t = t0 + tl;
  float acc = 0.0f;
  if (t < T) {
    const float* prt = pr + tl * D;
    for (int d = dg; d < D; d += 32) {
      float m = qs[d];
      for (int k = 0; k < ks; ++k) {
        m = fmaf(k2s[(2 * k) * D + d], win0[tl + k], m);
        m = fmaf(k2s[(2 * k + 1) * D + d], win1[tl + k], m);
      }
      const float f = tanhf(m + prt[d]);
      acc = fmaf(rnd<W>(f), vs[d], acc);
    }
  }
  acc = warp_sum(acc);
  if (dg == 0 && t < T) e[(size_t)row * T + t] = acc;
}

// Masked softmax over the row's T energies, then CTX_COLS columns of the
// context. Block x == 0 also stores w', w_cum += w' and the align output.
template <typename W>
__global__ void __launch_bounds__(SM_THREADS)
softmax_ctx_kernel(const float* __restrict__ e, const float* __restrict__ emask,
                   const W* __restrict__ mem, float* __restrict__ w,
                   float* __restrict__ wc, float* __restrict__ ctx,
                   float* __restrict__ align, const int* __restrict__ fin,
                   int step, int B, int T, int E) {
  extern __shared__ float sm[];
  float* wn = sm;                  // T
  float* red = sm + T;             // SM_THREADS
  float* out = red + SM_THREADS;   // CTX_COLS
  const int row = blockIdx.y;
  const size_t rT = (size_t)row * T;
  float mx = -INFINITY;
  for (int t = threadIdx.x; t < T; t += SM_THREADS) {
    const float x = e[rT + t] + emask[rT + t];
    wn[t] = x;
    mx = fmaxf(mx, x);
  }
  mx = block_reduce(mx, red, true);
  float s = 0.0f;
  for (int t = threadIdx.x; t < T; t += SM_THREADS) {
    const float x = expf(wn[t] - mx);
    wn[t] = x;
    s += x;
  }
  s = block_reduce(s, red, false);
  for (int t = threadIdx.x; t < T; t += SM_THREADS) wn[t] = wn[t] / s;
  __syncthreads();
  if (blockIdx.x == 0) {
    const bool done = fin[row] != 0;
    float* al = align + ((size_t)step * B + row) * T;
    for (int t = threadIdx.x; t < T; t += SM_THREADS) {
      w[rT + t] = wn[t];
      wc[rT + t] += wn[t];
      al[t] = done ? 0.0f : wn[t];
    }
  }
  const int c0 = blockIdx.x * CTX_COLS, ncols = min(CTX_COLS, E - c0);
  block_matvec<W, SM_THREADS, CTX_COLS>(wn, T, mem + rT * E, E, c0, ncols,
                                        red, out);
  if (threadIdx.x < ncols) ctx[(size_t)row * E + c0 + threadIdx.x] = out[threadIdx.x];
}

