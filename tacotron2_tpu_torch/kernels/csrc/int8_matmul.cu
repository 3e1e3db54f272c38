// int8 weight-only product for serving:
//   out (B, N) fp32 = (bf16(x) (B, K) @ w_q (K, N) int8) * scale (N,)
// with fp32 sums and the per-column scale applied once at the end.
//
// Replaces the TPU kernel tacotron2_tpu/kernels/int8_matmul.py _kernel
// (called by int8_matmul). The point of that kernel is kept: the weights
// travel as int8 and are widened in registers (every int8 value is exact in
// bf16 and in fp32), so the dequantised matrix never exists in device
// memory. x is rounded to bf16 here, inside, whatever type the model runs
// in; the products bf16 x int8 are exact in fp32.
//
// What bounds it on the H100: with 1 to 8 rows the work is one pass over
// the K x N weight bytes (7.3 MB and 10.5 MB for the two decoder cells):
// bytes, not operations. Design: a block owns a strip of I8_COLS output
// columns and walks all of K once; a thread reads 8 consecutive int8
// weights in one 8-byte load (byte loads at a ragged or unaligned edge) and
// keeps I8_LOADS loads in flight, holds ROWS x 8 fp32 sums, and the K
// slices meet by warp shuffles and one pass through shared memory. Ragged K
// and N are masked here; the TPU wrapper's padding is not carried over.
// Rows beyond 8 are taken 8 at a time by the C entry point (the weights are
// then read once per 8 rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define I8_COLS 32      // output columns per block
#define I8_THREADS 512  // 4 column groups of 8 x 128 slices of K
#define I8_LOADS 4      // weight loads each thread keeps in flight
#define I8_MAX_ROWS 8

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight weights of row k starting at column c as fp32; columns at or past N
// read as 0. `wide` says that every in-range group of 8 is 8-byte aligned.
__device__ __forceinline__ void load_w8(const int8_t* __restrict__ wq, int k,
                                        int c, int N, bool wide, float* o) {
  const int8_t* p = wq + (size_t)k * N + c;
  if (wide && c + 8 <= N) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const uint32_t u[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = (float)(int8_t)((u[i >> 2] >> (8 * (i & 3))) & 0xffu);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = c + i < N ? (float)__ldg(p + i) : 0.0f;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(I8_THREADS)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int b0, int B, int K, int N) {
  constexpr int KSPLIT = I8_THREADS / 4;
  constexpr int WARPS = I8_THREADS / 32;
  __shared__ float red[WARPS][ROWS][I8_COLS];
  const int cg = threadIdx.x & 3, ks = threadIdx.x >> 2;
  const int c = blockIdx.x * I8_COLS + cg * 8;
  const bool wide = (N % 8 == 0) &&
                    (reinterpret_cast<uintptr_t>(wq) % 8 == 0);
  float acc[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.0f;
  if (c < N) {
    int k = ks;
    for (; k + (I8_LOADS - 1) * KSPLIT < K; k += I8_LOADS * KSPLIT) {
      float wv[I8_LOADS][8];
#pragma unroll
      for (int j = 0; j < I8_LOADS; ++j)
        load_w8(wq, k + j * KSPLIT, c, N, wide, wv[j]);
#pragma unroll
      for (int j = 0; j < I8_LOADS; ++j) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = b0 + r < B
              ? round_bf16(__ldg(x + (size_t)(b0 + r) * K + k + j * KSPLIT))
              : 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(xv, wv[j][i], acc[r][i]);
        }
      }
    }
    for (; k < K; k += KSPLIT) {
      float wv[8];
      load_w8(wq, k, c, N, wide, wv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float xv = b0 + r < B
            ? round_bf16(__ldg(x + (size_t)(b0 + r) * K + k)) : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(xv, wv[i], acc[r][i]);
      }
    }
  }
  // the warp's 8 slices of each column group meet in lanes 0..3
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[r][i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[warp][r][lane * 8 + i] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * I8_COLS; i += I8_THREADS) {
    const int r = i / I8_COLS, cl = i % I8_COLS;
    const int col = blockIdx.x * I8_COLS + cl;
    if (b0 + r >= B || col >= N) continue;
    float s = 0.0f;
    for (int j = 0; j < WARPS; ++j) s += red[j][r][cl];
    out[(size_t)(b0 + r) * N + col] = s * scale[col];
  }
}

extern "C" {

// x (B, K) fp32, wq (K, N) int8, scale (N,) fp32 -> out (B, N) fp32, all
// contiguous. Returns cudaError_t.
int int8_matmul(const void* x, const void* wq, const void* scale, void* out,
                int B, int K, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + I8_COLS - 1) / I8_COLS);
  const float* xf = (const float*)x;
  const int8_t* w = (const int8_t*)wq;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  for (int b0 = 0; b0 < B; b0 += I8_MAX_ROWS) {
    const int rows = B - b0 < I8_MAX_ROWS ? B - b0 : I8_MAX_ROWS;
    if (rows == 1)
      int8_matmul_kernel<1><<<grid, I8_THREADS, 0, s>>>(xf, w, sc, o, b0, B, K, N);
    else if (rows == 2)
      int8_matmul_kernel<2><<<grid, I8_THREADS, 0, s>>>(xf, w, sc, o, b0, B, K, N);
    else if (rows <= 4)
      int8_matmul_kernel<4><<<grid, I8_THREADS, 0, s>>>(xf, w, sc, o, b0, B, K, N);
    else
      int8_matmul_kernel<8><<<grid, I8_THREADS, 0, s>>>(xf, w, sc, o, b0, B, K, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
