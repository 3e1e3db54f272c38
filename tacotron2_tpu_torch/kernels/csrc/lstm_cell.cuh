// Shared device code of the port's recurrent kernels: operand-type helpers
// and the block-level LSTM gate product.
//
// W is the operand type of the products (float or __nv_bfloat16). Values
// fed to a product are rounded to W first, products are exact in fp32 and
// sums are fp32 -- the cast points of the TPU kernels (bf16 operands, fp32
// accumulation, fp32 cell state).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define T2_BT 8     // batch rows per block of the gate product
#define T2_LOADS 16  // global loads each thread keeps in flight

template <typename W> __device__ __forceinline__ float to_f(W x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename W> __device__ __forceinline__ W from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to W's precision, back in fp32.
template <typename W> __device__ __forceinline__ float rnd(float x) {
  return to_f<W>(from_f<W>(x));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[b] += xs[k][b] * wv for the T2_BT rows, reading xs[k] as 16-byte
// words.
__device__ __forceinline__ void accumulate_rows(const float* xs, int k,
                                                float wv, float* acc) {
  static_assert(T2_BT % 4 == 0, "rows in whole 16-byte words");
  const float4* xv = reinterpret_cast<const float4*>(xs + (size_t)k * T2_BT);
#pragma unroll
  for (int q = 0; q < T2_BT / 4; ++q) {
    const float4 x = xv[q];
    acc[4 * q + 0] = fmaf(x.x, wv, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(x.y, wv, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(x.z, wv, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(x.w, wv, acc[4 * q + 3]);
  }
}

// Gate pre-activation sums (no bias) of UNITS hidden units -- all four gate
// blocks i, f, g, o, so that the cell update stays inside the block -- for
// T2_BT batch rows, by NT threads.
//
//   xs  shared [K][T2_BT] fp32 (k-major: the T2_BT rows' values of one k
//       are two 16-byte words), already rounded to W (zeros past B)
//   w   global (K, 4*UNITS) row-major, W: the block's slab of the weights
//       in the block-major layout (kernels/lstm_layout.py), column
//       g*UNITS + u holding gate g of the block's unit u
//   gsm shared [T2_BT][4*UNITS] out: gsm[b][c] = sum_k xs[k][b] * w[k][c]
//   red shared [KSPLIT][T2_BT][4*UNITS] scratch
//
// Thread layout: 4*UNITS columns x KSPLIT slices of K. The slab's rows are
// contiguous, so a warp's loads cover whole 32-byte sectors. Each thread
// keeps T2_BT sums, so every weight element read feeds T2_BT FMAs, and
// starts T2_LOADS weight loads before it uses any of them, so that their
// latencies overlap; the KSPLIT partial sums are added in shared memory.
// Ends with __syncthreads.
template <typename W, int UNITS, int NT>
__device__ __forceinline__ void gate_product(const float* xs, int K,
                                             const W* __restrict__ w,
                                             float* red, float* gsm) {
  constexpr int COLS = 4 * UNITS;
  constexpr int KSPLIT = NT / COLS;
  const int tid = threadIdx.x;
  const int cl = tid % COLS;
  const int ks = tid / COLS;
  const W* wc = w + cl;
  constexpr size_t ld = COLS;
  float acc[T2_BT];
#pragma unroll
  for (int b = 0; b < T2_BT; ++b) acc[b] = 0.0f;
  int k = ks;
  for (; k + (T2_LOADS - 1) * KSPLIT < K; k += T2_LOADS * KSPLIT) {
    float wv[T2_LOADS];
#pragma unroll
    for (int j = 0; j < T2_LOADS; ++j)
      wv[j] = to_f<W>(wc[(size_t)(k + j * KSPLIT) * ld]);
#pragma unroll
    for (int j = 0; j < T2_LOADS; ++j) accumulate_rows(xs, k + j * KSPLIT, wv[j], acc);
  }
  for (; k < K; k += KSPLIT) accumulate_rows(xs, k, to_f<W>(wc[(size_t)k * ld]), acc);
#pragma unroll
  for (int b = 0; b < T2_BT; ++b) red[(ks * T2_BT + b) * COLS + cl] = acc[b];
  __syncthreads();
  for (int i = tid; i < T2_BT * COLS; i += NT) {
    float s = 0.0f;
    for (int j = 0; j < KSPLIT; ++j) s += red[j * T2_BT * COLS + i];
    gsm[i] = s;
  }
  __syncthreads();
}

// Shared memory of one gate_product block, in bytes.
template <int UNITS, int NT>
inline size_t gate_product_smem(int K) {
  constexpr int COLS = 4 * UNITS;
  constexpr int KSPLIT = NT / COLS;
  return sizeof(float) * ((size_t)T2_BT * K + (size_t)KSPLIT * T2_BT * COLS +
                          (size_t)T2_BT * COLS);
}

// One row's product with ncols <= COLS columns of a row-major matrix:
// out[c] = sum_{k<K} x[k] * w[k*ld + c0 + c], by NT threads laid out as
// COLS columns x NT/COLS slices of K, T2_LOADS loads in flight per thread.
// x and out in shared memory; red is NT floats of shared scratch. Ends with
// __syncthreads.
template <typename W, int NT, int COLS>
__device__ __forceinline__ void block_matvec(const float* x, int K,
                                             const W* __restrict__ w,
                                             size_t ld, int c0, int ncols,
                                             float* red, float* out) {
  constexpr int KSPLIT = NT / COLS;
  const int cl = threadIdx.x % COLS, ks = threadIdx.x / COLS;
  float acc = 0.0f;
  if (cl < ncols) {
    const W* wc = w + c0 + cl;
    int k = ks;
    for (; k + (T2_LOADS - 1) * KSPLIT < K; k += T2_LOADS * KSPLIT) {
      float wv[T2_LOADS];
#pragma unroll
      for (int j = 0; j < T2_LOADS; ++j)
        wv[j] = to_f<W>(wc[(size_t)(k + j * KSPLIT) * ld]);
#pragma unroll
      for (int j = 0; j < T2_LOADS; ++j)
        acc = fmaf(x[k + j * KSPLIT], wv[j], acc);
    }
    for (; k < K; k += KSPLIT) acc = fmaf(x[k], to_f<W>(wc[(size_t)k * ld]), acc);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (ks == 0 && cl < ncols) {
    float s = 0.0f;
    for (int j = 0; j < KSPLIT; ++j) s += red[j * COLS + cl];
    out[cl] = s;
  }
  __syncthreads();
}

// dst[i] = src[i] in fp32 for i < count, by NT threads, T2_LOADS loads in
// flight per thread (no barrier).
template <typename W, int NT>
__device__ __forceinline__ void stage(float* dst, const W* __restrict__ src,
                                      int count) {
  int i = threadIdx.x;
  for (; i + (T2_LOADS - 1) * NT < count; i += T2_LOADS * NT) {
    float v[T2_LOADS];
#pragma unroll
    for (int j = 0; j < T2_LOADS; ++j) v[j] = to_f<W>(src[i + j * NT]);
#pragma unroll
    for (int j = 0; j < T2_LOADS; ++j) dst[i + j * NT] = v[j];
  }
  for (; i < count; i += NT) dst[i] = to_f<W>(src[i]);
}
