// Tensor-core product of rows by a column-tiled weight, split along K:
//   out (M, N) fp32 = X (bf16) @ W (bf16) = sum over z of part[z],
//   part[z] = X[:, K_z] @ W[K_z, :]
// for the K slices z of a fixed split, each slice's sums in fp32. The last
// block of a tile to finish (an integer counter tells it; no floating-point
// atomics) adds the tile's slices in order 0, 1, ..., so a result is the
// same bits on every run. Products of bf16 values are exact in fp32: the
// cast points of the TPU kernels (bf16 operands, fp32 sums) hold; only the
// order of the sums differs from a row-by-row loop.
//
// Used by the training scan's backward chain (dgates @ [wi ; wh]^T for both
// LSTMs, and the query of every step) and its forward (the query of each
// step; the forward's gate products run the same ring and warp tiles in
// train_scan.cu's scan_cell_kernel, with the LSTM cell in the epilogue).
//
// Layout: X row-major (M, K) with row stride ldx; W column-tiled as
// kernels/lstm_layout.py to_col_tiles makes it, (ceil(N / 32), K, 32) with
// zero columns past N. K must be a multiple of TC_KC and ldx of 8.
//
// Design (what bounds it on the H100): at M = 128 rows a weight byte feeds
// 128 multiply-adds, below the ~295 FLOP per byte where the tensor cores
// rather than memory bound a bf16 product, so reading the weights is what
// bounds it, and a block owns TC_MT rows (all of them at B <= 128) and one
// column tile of TC_NT columns, so each weight element is read once per
// product (and the rows once per 128 columns). K is split into slices so that the column tiles make enough
// blocks to fill the 132 SMs in one wave (a second, partial wave would
// double the time of the SMs that take it). A ring of TC_STAGES chunks of
// TC_KC rows fed by cp.async keeps loads in flight; warps (4 x 2, each
// 32 x 32) read operands with ldmatrix from rows padded by 16 bytes (no
// bank conflicts) and run mma.sync m16n8k16 bf16 with fp32 sums. On an
// NVIDIA H100 80GB HBM3 at 700 W a 128 x 4096 @ 4096 x 2560 product takes
// ~40 us against ~3 us of tensor-core work and ~6 us of weights from HBM:
// neither deeper rings, wider tiles, more slices nor staggered chunk
// orders moved it (PERF.md), so what bounds it is still open.
#pragma once

#include <cuda_bf16.h>

#include "mma.cuh"

#define TC_MT 128      // rows per block
#define TC_NT 64       // columns per block
#define TC_KC 32       // depth of one chunk
#define TC_STAGES 4    // chunks in the ring
#define TC_THREADS 256 // 8 warps, 4 x 2, each 32 rows x 32 columns
#define TC_ZMAX 8      // most K slices
#define TC_XLD (TC_KC + 8)   // X chunk row, bf16
#define TC_WLD (TC_NT + 8)   // W chunk row, bf16

struct TcSmem {
  __nv_bfloat16 x[TC_STAGES][TC_MT * TC_XLD];
  __nv_bfloat16 w[TC_STAGES][TC_KC * TC_WLD];
};

// The weight rows k0 .. k0 + TC_KC of the block's TC_NT columns (two
// 32-column tiles from tile0) into ring slot `slot`.
__device__ __forceinline__ void tc_load_w(
    TcSmem& s, int slot, const __nv_bfloat16* __restrict__ w, int K,
    int ntiles32, int tile0, int k0) {
  constexpr int PR = TC_NT / 8;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < TC_KC * PR; i += TC_THREADS) {
    const int kr = i / PR, p = i % PR;
    const int tile = tile0 + (p >> 2);
    const bool in = tile < ntiles32;
    const __nv_bfloat16* src =
        in ? w + ((size_t)tile * K + k0 + kr) * 32 + (p & 3) * 8 : w;
    cp_async16(&s.w[slot][kr * TC_WLD + p * 8], src, in ? 16 : 0);
  }
}

// Chunk c (rows k0 .. k0 + TC_KC of the depth) into ring slot `slot`.
__device__ __forceinline__ void tc_load_chunk(
    TcSmem& s, int slot, const __nv_bfloat16* __restrict__ x, int ldx, int M,
    int m0, const __nv_bfloat16* __restrict__ w, int K, int ntiles32,
    int tile0, int k0) {
  // X: TC_MT rows x 64 bytes, 4 pieces of 16 bytes a row
  for (int i = threadIdx.x; i < TC_MT * 4; i += TC_THREADS) {
    const int r = i >> 2, p = i & 3;
    const bool in = m0 + r < M;
    const __nv_bfloat16* src = in ? x + (size_t)(m0 + r) * ldx + k0 + p * 8 : x;
    cp_async16(&s.x[slot][r * TC_XLD + p * 8], src, in ? 16 : 0);
  }
  tc_load_w(s, slot, w, K, ntiles32, tile0, k0);
}

// One chunk of the block's product from ring slot `slot` into the warp's
// accumulators acc[m16 tile][n8 tile][4].
__device__ __forceinline__ void tc_chunk_mma(const TcSmem& s, int slot,
                                             float (*acc)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int r = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int k16 = 0; k16 < TC_KC; k16 += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(a[i], &s.x[slot][(wm * 32 + i * 16 + r + (mi & 1) * 8) *
                                       TC_XLD + k16 + (mi >> 1) * 8]);
#pragma unroll
    for (int j = 0; j < 2; ++j)   // n16 groups: b[j] = {b0, b1} of two n8
      ldmatrix_x4_trans(b[j], &s.w[slot][(k16 + r + (mi & 1) * 8) * TC_WLD +
                                         wn * 32 + j * 16 + (mi >> 1) * 8]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[i][j], a[i], &b[j >> 1][(j & 1) * 2]);
  }
}

// Where a product goes: out (M, N); with nslice > 1, the slices' partials
// part (nslice, M, N) and one zeroed counter per block tile (left zeroed);
// columns n < n2 also to out2 (M, ld2), or none with a null out2.
struct TcOut {
  float* out;
  float* part;
  int* count;
  float* out2;
  int n2, ld2;
};

// grid (ceil(N / TC_NT), ceil(M / TC_MT), nslice), TC_THREADS threads,
// sizeof(TcSmem) bytes of dynamic shared memory.
__global__ void __launch_bounds__(TC_THREADS)
tc_product_kernel(const __nv_bfloat16* __restrict__ x, int ldx, int M, int K,
                  const __nv_bfloat16* __restrict__ w, int N, TcOut o) {
  extern __shared__ __align__(16) unsigned char tc_raw[];
  TcSmem& s = *reinterpret_cast<TcSmem*>(tc_raw);
  const int m0 = blockIdx.y * TC_MT, n0 = blockIdx.x * TC_NT;
  const int ntiles32 = (N + 31) / 32, tile0 = n0 / 32;
  const int nch = K / TC_KC, z = blockIdx.z, nz = gridDim.z;
  const int c0 = z * nch / nz, c1 = (z + 1) * nch / nz;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const bool busy = m0 + wm * 32 < M;   // warp-uniform: rows past M skipped
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int n = c1 - c0;
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < n)
      tc_load_chunk(s, st, x, ldx, M, m0, w, K, ntiles32, tile0,
                    (c0 + st) * TC_KC);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    const int next = i + TC_STAGES - 1;
    if (next < n)
      tc_load_chunk(s, next % TC_STAGES, x, ldx, M, m0, w, K, ntiles32,
                    tile0, (c0 + next) * TC_KC);
    cp_async_commit();
    if (busy) tc_chunk_mma(s, i % TC_STAGES, acc);
  }
  cp_async_wait<0>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool split = nz > 1;
  float* dst = split ? o.part + (size_t)z * M * N : o.out;
  if (busy) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * 32 + i * 16 + g + (e >> 1) * 8;
          const int n = n0 + wn * 32 + j * 8 + 2 * t4 + (e & 1);
          if (m >= M || n >= N) continue;
          dst[(size_t)m * N + n] = acc[i][j][e];
          if (!split && o.out2 && n < o.n2)
            o.out2[(size_t)m * o.ld2 + n] = acc[i][j][e];
        }
  }
  if (!split) return;
  // the last of the tile's nz blocks adds the slices, in slice order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* cnt = o.count + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == nz - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the tile's slices, 4 columns a load where the rows allow it, every
  // element of the thread's share loaded before it is added (the tile is
  // summed by this one block: loads in flight are what its time depends on)
  constexpr int PER = TC_MT * TC_NT / 4 / TC_THREADS;
  const bool vec = N % 4 == 0;
  float4 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int zz = 0; zz < nz; ++zz) {
    float4 p[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * TC_THREADS;
      const int m = m0 + i / (TC_NT / 4), n = n0 + (i % (TC_NT / 4)) * 4;
      const float* src = o.part + ((size_t)zz * M + m) * N + n;
      p[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m >= M || n >= N) continue;
      if (vec) {
        p[u] = __ldcg(reinterpret_cast<const float4*>(src));
      } else {
        p[u].x = __ldcg(src);
        if (n + 1 < N) p[u].y = __ldcg(src + 1);
        if (n + 2 < N) p[u].z = __ldcg(src + 2);
        if (n + 3 < N) p[u].w = __ldcg(src + 3);
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      v[u].x += p[u].x, v[u].y += p[u].y, v[u].z += p[u].z, v[u].w += p[u].w;
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * TC_THREADS;
    const int m = m0 + i / (TC_NT / 4), n = n0 + (i % (TC_NT / 4)) * 4;
    if (m >= M || n >= N) continue;
    const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n + c >= N) break;
      o.out[(size_t)m * N + n + c] = e[c];
      if (o.out2 && n + c < o.n2) o.out2[(size_t)m * o.ld2 + n + c] = e[c];
    }
  }
  if (threadIdx.x == 0) *cnt = 0;
}

// The number of K slices for a product of N columns and M rows: as many
// blocks as fit the card's SMs in one wave, at most one slice per chunk.
// Fixed by the shapes, so the order of the slices' sums is too.
inline int tc_slices(int M, int N, int K, int sms) {
  const int blocks = ((N + TC_NT - 1) / TC_NT) * ((M + TC_MT - 1) / TC_MT);
  int z = sms / blocks;
  const int nch = K / TC_KC;
  if (z > nch) z = nch;
  if (z > TC_ZMAX) z = TC_ZMAX;
  return z < 1 ? 1 : z;
}

// Counters a product of M rows and N columns needs (one per block tile).
inline int tc_tiles(int M, int N) {
  return ((N + TC_NT - 1) / TC_NT) * ((M + TC_MT - 1) / TC_MT);
}

// Launch out = X @ W in `nslice` K slices on stream st.
inline cudaError_t tc_product(const __nv_bfloat16* x, int ldx, int M, int K,
                              const __nv_bfloat16* w, int N, int nslice,
                              const TcOut& o, cudaStream_t st) {
  const dim3 grid((N + TC_NT - 1) / TC_NT, (M + TC_MT - 1) / TC_MT, nslice);
  tc_product_kernel<<<grid, TC_THREADS, sizeof(TcSmem), st>>>(x, ldx, M, K, w,
                                                              N, o);
  return cudaGetLastError();
}

inline cudaError_t tc_product_prepare() {
  return cudaFuncSetAttribute(tc_product_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(TcSmem));
}
