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
// x and out in shared memory; red is NT floats of shared scratch. The
// slices' sums are added in slice order by one thread a column. Ends with
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

// ------------------------------------------------------------- backward

// One unit's LSTM cell backward, the TPU kernels' lstm_gates_bwd: from the
// stored gate pre-activations (gi, gf, gg, go), c_{t-1}, c_t, the cotangent
// of h_t and the carried cotangent of c_t, the four gate cotangents dg
// (i, f, g, o); returns the cotangent of c_{t-1}.
__device__ __forceinline__ float lstm_unit_bwd(float gi, float gf, float gg,
                                               float go, float cp, float cn,
                                               float dh, float dc_in,
                                               float* dg) {
  const float i = sigmoid_f(gi), f = sigmoid_f(gf), g = tanhf(gg);
  const float o = sigmoid_f(go);
  const float tc = tanhf(cn);
  const float d_o = dh * tc;
  const float dc = dc_in + dh * o * (1.0f - tc * tc);
  dg[0] = dc * g * i * (1.0f - i);
  dg[1] = dc * cp * f * (1.0f - f);
  dg[2] = dc * i * (1.0f - g * g);
  dg[3] = d_o * o * (1.0f - o);
  return dc * f;
}

// Pointers of one LSTM's gate backward at one step (lstm_gates_bwd_kernel).
template <typename W>
struct GatesBwd {
  const W* g;              // (B, 4H) gate pre-activations of step t
  const float* c_new;      // (B, H) c_t
  const float* c_prev;     // (B, H) c_{t-1}, or null at t = 0
  const float* dh_carry;   // cotangent of h_t from step t+1, row stride
  int dh_ld;               //   dh_ld, or null at the chain's start
  const float* dh_in;      // (B, H) cotangent of h_t from outside, or null
  const unsigned char* keep;  // (B, H) 0/1 dropout keep mask, or null
  float scale;             // 1 / (1 - p) of that dropout
  float* dc;               // (B, H) carried cotangent of c, in/out
  W* dg;                   // (B, 4H) out: gate cotangents, rounded to W
};

// Elementwise half of the LSTM backward for one step, one thread per (row,
// unit), one LSTM per blockIdx.y: dh = dh_carry + dh_in, times the keep
// mask's scale; then lstm_unit_bwd. The product dg @ [wi ; wh]^T follows in
// tile_product_kernel.
template <typename W>
__global__ void lstm_gates_bwd_kernel(GatesBwd<W> a0, GatesBwd<W> a1, int B,
                                      int H) {
  const GatesBwd<W>& a = blockIdx.y ? a1 : a0;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, u = i % H;
  float dh = 0.0f;
  if (a.dh_carry) dh = a.dh_carry[(size_t)b * a.dh_ld + u];
  if (a.dh_in) dh += a.dh_in[i];
  if (a.keep) dh = dh * (a.keep[i] ? a.scale : 0.0f);
  const W* g = a.g + (size_t)b * 4 * H;
  float dg[4];
  a.dc[i] = lstm_unit_bwd(to_f<W>(g[u]), to_f<W>(g[H + u]),
                          to_f<W>(g[2 * H + u]), to_f<W>(g[3 * H + u]),
                          a.c_prev ? a.c_prev[i] : 0.0f, a.c_new[i], dh,
                          a.dc[i], dg);
  W* o = a.dg + (size_t)b * 4 * H;
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q * H + u] = from_f<W>(dg[q]);
}

#define TP_COLS 32      // output columns per tile_product_kernel block
#define TP_THREADS 1024

// Shared memory of one tile_product_kernel block, in bytes.
inline size_t tile_product_smem(int K) {
  return gate_product_smem<TP_COLS / 4, TP_THREADS>(K);
}

// out (B, ncols) fp32 = x (B, K) @ w (K, ncols), x in W, w column-tiled
// (kernels/lstm_layout.py to_col_tiles: (ceil(ncols / TP_COLS), K, TP_COLS),
// zero columns past ncols). One block per (column tile, T2_BT rows), up to
// two independent products by blockIdx.z; the sums are gate_product's.
template <typename W>
__global__ void __launch_bounds__(TP_THREADS)
tile_product_kernel(const W* __restrict__ x0, const W* __restrict__ w0,
                    float* __restrict__ out0, const W* __restrict__ x1,
                    const W* __restrict__ w1, float* __restrict__ out1, int B,
                    int K, int ncols) {
  extern __shared__ float smem[];
  const W* x = blockIdx.z ? x1 : x0;
  const W* w = blockIdx.z ? w1 : w0;
  float* out = blockIdx.z ? out1 : out0;
  constexpr int KSPLIT = TP_THREADS / TP_COLS;
  const int b0 = blockIdx.y * T2_BT;
  float* xs = smem;
  float* red = xs + T2_BT * K;
  float* gsm = red + KSPLIT * T2_BT * TP_COLS;
  for (int k = threadIdx.x; k < K; k += TP_THREADS) {
    float v[T2_BT];
#pragma unroll
    for (int b = 0; b < T2_BT; ++b)
      v[b] = b0 + b < B ? to_f<W>(x[(size_t)(b0 + b) * K + k]) : 0.0f;
#pragma unroll
    for (int b = 0; b < T2_BT; ++b) xs[k * T2_BT + b] = v[b];
  }
  __syncthreads();
  gate_product<W, TP_COLS / 4, TP_THREADS>(
      xs, K, w + (size_t)blockIdx.x * K * TP_COLS, red, gsm);
  const int c0 = blockIdx.x * TP_COLS;
  for (int i = threadIdx.x; i < T2_BT * TP_COLS; i += TP_THREADS) {
    const int b = i / TP_COLS, c = i % TP_COLS;
    if (b0 + b < B && c0 + c < ncols)
      out[(size_t)(b0 + b) * ncols + c0 + c] = gsm[i];
  }
}

// Set the dynamic shared memory of the backward kernels for products of
// depth K; returns the first error.
template <typename W>
inline cudaError_t tile_product_prepare(int K) {
  return cudaFuncSetAttribute(tile_product_kernel<W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tile_product_smem(K));
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
