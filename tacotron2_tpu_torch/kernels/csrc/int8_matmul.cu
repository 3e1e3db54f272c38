// int8 weight-only product for serving:
//   out (B, N) fp32 = (bf16(x) (B, K) @ w_q (K, N) int8) * scale (N,)
// with fp32 sums and the per-column scale applied once at the end.
//
// Replaces the TPU kernel tacotron2_tpu/kernels/int8_matmul.py _kernel
// (called by int8_matmul). The point of that kernel is kept: the weights
// travel as int8 and are widened on chip (every int8 value is exact in bf16),
// so the dequantised matrix never exists in device memory. x is rounded to
// bf16 here, once, as it is staged, whatever type the caller passes (fp32 or
// bf16); the products bf16 x int8 are exact in fp32.
//
// What bounds it on the H100: with 1 to 8 rows the work is one pass over the
// K x N weight bytes (7.3 MB and 10.5 MB for the two decoder cells, 2.2 and
// 3.1 us at 3.35 TB/s): bytes, not operations. To stream them at the card's
// rate every SM must keep ~32 KB in flight.
//
// Design:
// - Packed weights. kernels/int8_matmul.py pack_int8 lays w_q out once per
//   model in the order the lanes read it: per tile of 16 columns and chunk of
//   32 rows of K, 512 bytes, 16 for each lane, which are that lane's A
//   fragments of the chunk's two m16n8k16 products, each byte biased by 128
//   (v ^ 0x80). A warp's stream over its K range is one contiguous run.
// - Swap-AB tensor-core products. The 16 weight columns of a tile are the
//   m16 side, up to 8 rows of x the n8 side, on bf16 mma.sync with fp32
//   sums, so the multiply-adds at B = 8 leave the CUDA cores. Rows beyond 8
//   take more n8 tiles against the same A fragments: a launch reads the
//   weights once for up to 32 rows at the decoder cells' depths.
// - Widening by byte permutes: a biased byte u becomes the fp32 2^23 + u by
//   one prmt into 0x4B000000, minus 2^23 + 128 gives v exactly, and the high
//   halves of two such fp32 values are the bf16 pair (exact: |v| <= 128).
// - A shared-memory ring per warp, fed by bulk copies (cp.async.bulk, the
//   TMA's one-dimensional form) that complete on an mbarrier per stage:
//   a warp's slice of K in 2 stages of up to 2.5 KB (16 warps an SM: one
//   block of two tiles or two of one). Stages of 1 KB and of 0.5 KB (more
//   copies for the same bytes) read slower on the card, and so did deeper
//   rings (PERF.md).
// - All SMs. A block of 8 warps owns one tile of 16 columns, and its warps
//   split K eight ways; where its shared memory allows, a block of 16 warps
//   owns two tiles (I8_TPB), the two warps of each slice of K sharing one
//   staged x. The warps' partials meet in shared memory and are summed in
//   warp order 0, 1, ..., 7. No float atomics and a fixed order: two runs
//   give the same bits. (Splitting K across the blocks of a cluster
//   instead, and reducing through distributed shared memory, was slower on
//   the card: PERF.md.)
// - x staged in shared memory as bf16 (the cast point), one copy per slice
//   of K, rows padded so that the B fragments' loads meet no bank conflict.
//   Every block needs all of x, and at B = 8 staging it is a large part of
//   a call: two tiles a block halve the copies an SM stages. (Sharing one
//   staging among the blocks of a cluster through distributed shared
//   memory, and bringing x by bulk copies beside the weights, a copy per
//   row of each stage or of each slice, were all slower on the card:
//   PERF.md.)
// Ragged K and N are zero-padded by the packing and masked here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"

#define I8_WARPS 8                   // warps per block: slices of K
#define I8_THREADS (32 * I8_WARPS)
#define I8_KC 32                     // rows of K per packed chunk
#define I8_CHUNK 512                 // bytes per packed chunk of one tile
#ifndef I8_STAGE_CHUNKS
#define I8_STAGE_CHUNKS 5            // most chunks per ring stage (2.5 KB)
#endif
#ifndef I8_STAGES
#define I8_STAGES 2                  // ring stages per warp
#endif
#define I8_MAX_RG 8                  // most n8 row groups per launch (64 rows)
#define I8_XPAD 8                    // bf16 padding of a staged x row
#ifndef I8_XBATCH
#define I8_XBATCH 10                 // x pieces a lane loads before storing
#endif                               //   (all of them at B <= 8, K <= 2560)
#ifndef I8_TPB
#define I8_TPB 2                     // most column tiles a block takes
#endif


// ------------------------------------------------- mbarrier, bulk copy

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// One arrival that also expects `bytes` of transactions on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------- a barrier

// The `count` threads of named barrier `id` (whole warps) meet.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ----------------------------------------------------------- the widening

// x[k .. k + 3] of one row as a piece of x (zeros at k >= K), and its
// store as four bf16 values: fp32 x is rounded there (the cast point), bf16
// x is stored as it came. `vec`: the row holds whole, aligned groups of four
// (one 16- or 8-byte load).
__device__ __forceinline__ float4 load4(const float* row, int k, int K,
                                        bool vec) {
  if (vec && k + 4 <= K)
    return __ldg(reinterpret_cast<const float4*>(row + k));
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = k + i < K ? __ldg(row + k + i) : 0.0f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ uint2 load4(const __nv_bfloat16* row, int k,
                                       int K, bool vec) {
  if (vec && k + 4 <= K)
    return __ldg(reinterpret_cast<const uint2*>(row + k));
  const unsigned short* u = reinterpret_cast<const unsigned short*>(row);
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = k + i < K ? u[k + i] : 0u;
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

__device__ __forceinline__ uint2 as_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ uint2 as_bf16x4(uint2 v) { return v; }

// Four bytes biased by 128 (u = v + 128) -> two bf16 pairs {v0, v1},
// {v2, v3}, exactly: prmt puts u into the low byte of the fp32 2^23 + u.
__device__ __forceinline__ void widen4(uint32_t u, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t base = 0x4B000000u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, base, 0x7650 + i)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// Chunk cc of a ring slot widened: lane's A fragments of the chunk's two
// k16 products.
__device__ __forceinline__ void widen_chunk(const unsigned char* slot,
                                            int cc, int lane,
                                            uint32_t (&af)[2][4]) {
  const uint4 v = reinterpret_cast<const uint4*>(slot + cc * I8_CHUNK)[lane];
  const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    widen4(w4[2 * h], af[h][0], af[h][1]);
    widen4(w4[2 * h + 1], af[h][2], af[h][3]);
  }
}

// ------------------------------------------------------------- the kernel

struct I8Args {
  const void* x;          // (B, K) fp32 or bf16
  const uint4* wp;        // packed: (NT, KC, 32, 16 bytes)
  const float* scale;     // (N,)
  float* out;             // (B, N)
  int b0, B, K, N, KC;    // KC chunks of 32 rows of K
  int NT;                 // tiles of 16 columns
  int ks_max;             // the widest warp slice of K, in rows
  bool x_vec;             // x's rows in aligned groups of four values
};

constexpr int I8_RING = I8_STAGES * I8_STAGE_CHUNKS * I8_CHUNK;  // a warp's

// Shared memory of one block with RG row groups and TPB tiles, in bytes:
// each warp's ring and its barriers, and x (8 RG rows of each of the eight
// slices of K). A warp's partials take its ring's place once its stream is
// done.
static size_t i8_smem(int RG, int TPB, int ks_max) {
  return (size_t)TPB * I8_WARPS * (I8_RING + I8_STAGES * sizeof(uint64_t)) +
         (size_t)I8_WARPS * 8 * RG * (ks_max + I8_XPAD) * 2;
}
static_assert(8 * I8_MAX_RG * 16 * sizeof(float) <= I8_RING,
              "a warp's partials fit its ring");

// grid ceil(NT / TPB): warp w of block j takes tile TPB j + w / 8 (none
// past NT), rows b0 .. b0 + 8 RG - 1 of x, and chunks [s KC / 8,
// (s + 1) KC / 8) of K, s = w % 8.
template <typename XT, int RG, int TPB>
__global__ void __launch_bounds__(I8_THREADS * TPB, 2 / TPB)
int8_matmul_kernel(I8Args a) {
  extern __shared__ __align__(128) unsigned char i8_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = warp % I8_WARPS, part = warp / I8_WARPS;
  const int LX = a.ks_max + I8_XPAD;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(i8_raw + TPB * I8_WARPS * I8_RING);
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(bars + TPB * I8_WARPS * I8_STAGES);
  unsigned char* wring = i8_raw + warp * I8_RING;
  uint64_t* wbar = bars + warp * I8_STAGES;
  __nv_bfloat16* xw = xs + (size_t)slice * 8 * RG * LX;

  const int tile = blockIdx.x * TPB + part;
  const int c0 = slice * a.KC / I8_WARPS;
  const int nch = (slice + 1) * a.KC / I8_WARPS - c0;
  // chunks a stage: the slice in I8_STAGES stages, as far as a slot holds
  const int sc =
      max(1, min(I8_STAGE_CHUNKS, (nch + I8_STAGES - 1) / I8_STAGES));
  const int nst = tile < a.NT ? (nch + sc - 1) / sc : 0;
  const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(a.wp) +
                              ((size_t)tile * a.KC + c0) * I8_CHUNK;

  // stage i of the warp's stream into ring slot i % I8_STAGES (lane 0)
  auto fetch = [&](int i) {
    const int first = i * sc;
    const int n = min(sc, nch - first);
    uint64_t* bar = wbar + i % I8_STAGES;
    mbar_expect(bar, n * I8_CHUNK);
    bulk_g2s(wring + (i % I8_STAGES) * I8_STAGE_CHUNKS * I8_CHUNK,
             wsrc + (size_t)first * I8_CHUNK, n * I8_CHUNK, bar);
  };

  // the slice's x: rows b0 .. b0 + rows - 1, K rows 32 c0 .. 32 (c0 + nch),
  // as bf16 (zeros past K), four values a piece; the B fragments of rows
  // past B read as zeros below. The slice's TPB warps share the pieces:
  // lane l of the slice's warp u takes the (32 (TPB j + u) + l)-th of them,
  // row-major. Each lane loads I8_XBATCH pieces before it stores any, so
  // that they are in flight together, and the first batch is asked for
  // before the weights: behind them it would wait until the weights have
  // drained.
  const int ks = nch * I8_KC, k0 = c0 * I8_KC, p4 = ks / 4;
  const int rows = min(8 * RG, a.B - a.b0);
  const XT* x = reinterpret_cast<const XT*>(a.x) + (size_t)a.b0 * a.K + k0;
  const int start = 32 * part + lane;
  int xr = ks ? start / p4 : rows, xc = ks ? start % p4 : 0;
  decltype(load4(x, 0, 0, false)) v[I8_XBATCH];
  auto load_x = [&]() {   // the next I8_XBATCH pieces into v
    int r = xr, c = xc;
#pragma unroll
    for (int j = 0; j < I8_XBATCH; ++j) {
      if (r < rows) {
        v[j] = load4(x + (size_t)r * a.K, 4 * c, a.K - k0, a.x_vec);
        for (c += 32 * TPB; c >= p4; c -= p4) ++r;
      }
    }
  };
  auto store_x = [&]() {  // the same pieces from v, as bf16
#pragma unroll
    for (int j = 0; j < I8_XBATCH; ++j) {
      if (xr >= rows) break;
      *reinterpret_cast<uint2*>(xw + xr * LX + 4 * xc) = as_bf16x4(v[j]);
      for (xc += 32 * TPB; xc >= p4; xc -= p4) ++xr;
    }
  };
  auto start_stream = [&]() {   // lane 0
#pragma unroll
    for (int i = 0; i < I8_STAGES; ++i) mbar_init(wbar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < nst && i < I8_STAGES; ++i) fetch(i);
  };
  load_x();
  if (lane == 0) start_stream();
  store_x();
  while (xr < rows) {
    load_x();
    store_x();
  }
  // x staged by the slice's warps; the barriers' initialisation seen by
  // all lanes
  if (TPB > 1)
    named_sync(1 + slice, 32 * TPB);
  else
    __syncwarp();

  const int g = lane >> 2, q = lane & 3;
  float acc[RG][4];
#pragma unroll
  for (int rg = 0; rg < RG; ++rg)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[rg][e] = 0.0f;
  for (int i = 0; i < nst; ++i) {
    const int slot = i % I8_STAGES;
    mbar_wait(wbar + slot, (i / I8_STAGES) & 1);
    const int first = i * sc;
#pragma unroll
    for (int cc = 0; cc < I8_STAGE_CHUNKS; ++cc) {
      if (cc >= sc || first + cc >= nch) break;
      uint32_t af[2][4];
      widen_chunk(wring + slot * I8_STAGE_CHUNKS * I8_CHUNK, cc, lane, af);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = (first + cc) * I8_KC + h * 16 + 2 * q;
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) {
          const __nv_bfloat16* xp = xw + (size_t)(rg * 8 + g) * LX + kk;
          const bool live = rg * 8 + g < rows;
          const uint32_t bf[2] = {
              live ? *reinterpret_cast<const uint32_t*>(xp) : 0u,
              live ? *reinterpret_cast<const uint32_t*>(xp + 8) : 0u};
          mma_bf16(acc[rg], af[h], bf);
        }
      }
    }
    // every lane has used the slot's bytes: the TMA may refill it
    __syncwarp();
    if (lane == 0 && i + I8_STAGES < nst) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(i + I8_STAGES);
    }
  }

  // the warp's partials in its ring, [row][column]: accumulator e of row
  // group rg is column g + 8 (e >> 1), row 8 rg + 2 q + (e & 1)
  float* red = reinterpret_cast<float*>(wring);
#pragma unroll
  for (int rg = 0; rg < RG; ++rg)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(rg * 8 + 2 * q + (e & 1)) * 16 + g + 8 * (e >> 1)] = acc[rg][e];
  __syncthreads();
  // each tile's eight slices of K summed in warp order
  constexpr int PER_TILE = 8 * RG * 16;
  for (int i = tid; i < TPB * PER_TILE; i += I8_THREADS * TPB) {
    const int p = i / PER_TILE, j = i % PER_TILE;
    const int n = (blockIdx.x * TPB + p) * 16 + (j & 15);
    const int row = a.b0 + (j >> 4);
    if (row >= a.B || n >= a.N) continue;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < I8_WARPS; ++w)
      sum += reinterpret_cast<const float*>(
          i8_raw + (p * I8_WARPS + w) * I8_RING)[j];
    a.out[(size_t)row * a.N + n] = sum * a.scale[n];
  }
}

#define I8_SMEM_MAX (227 * 1024)

template <typename XT, int RG, int TPB>
static cudaError_t i8_launch(const I8Args& a, cudaStream_t st) {
  auto kern = int8_matmul_kernel<XT, RG, TPB>;
  // The shared memory a launch may ask for is granted per device; every
  // launch's need is below I8_SMEM_MAX, so that is granted once per device
  // (granting it twice, from two threads, is harmless).
  static std::atomic<unsigned long long> granted{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(granted.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM_MAX);
    if (err != cudaSuccess) return err;
    granted.fetch_or(bit);
  }
  kern<<<(a.NT + TPB - 1) / TPB, I8_THREADS * TPB,
         i8_smem(RG, TPB, a.ks_max), st>>>(a);
  return cudaGetLastError();
}

// Two tiles a block where its shared memory allows it, else one.
template <typename XT, int RG>
static cudaError_t i8_launch_tiles(const I8Args& a, cudaStream_t st) {
  if constexpr (I8_TPB > 1) {
    if (i8_smem(RG, 2, a.ks_max) <= I8_SMEM_MAX)
      return i8_launch<XT, RG, 2>(a, st);
  }
  return i8_launch<XT, RG, 1>(a, st);
}

// Row groups of 8 a launch takes for `rows` rows, at most `most`.
static int i8_row_groups(int rows, int most) {
  const int rg = rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : 8;
  return rg < most ? rg : most;
}

template <typename XT>
static cudaError_t i8_run(I8Args a, cudaStream_t st) {
  int most = I8_MAX_RG;   // row groups whose x fits a block's shared memory
  while (most > 1 && i8_smem(most, 1, a.ks_max) > I8_SMEM_MAX) most /= 2;
  for (int b0 = 0; b0 < a.B; b0 += 8 * most) {
    a.b0 = b0;
    cudaError_t err;
    switch (i8_row_groups(a.B - b0, most)) {
      case 1: err = i8_launch_tiles<XT, 1>(a, st); break;
      case 2: err = i8_launch_tiles<XT, 2>(a, st); break;
      case 4: err = i8_launch_tiles<XT, 4>(a, st); break;
      default: err = i8_launch_tiles<XT, 8>(a, st);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" {

// x (B, K) fp32 (x_bf16 = 0) or bf16, wp the packed weights
// (pack_int8: (ceil(N / 16), ceil(K / 32), 32, 16) bytes, 16-byte aligned),
// scale (N,) fp32 -> out (B, N) fp32, all contiguous. Up to 32 rows a
// launch at the decoder cells' depths (64 where K is shallow enough for 64
// rows of x in shared memory). Returns cudaError_t.
int int8_matmul(const void* x, int x_bf16, const void* wp, const void* scale,
                void* out, int B, int K, int N, void* stream) {
  if (B < 1 || K < 1 || N < 1 || (uintptr_t)wp % 16)
    return (int)cudaErrorInvalidValue;
  const int KC = (K + I8_KC - 1) / I8_KC;
  const bool vec = K % 4 == 0 && (uintptr_t)x % (x_bf16 ? 8 : 16) == 0;
  I8Args a{x, (const uint4*)wp, (const float*)scale, (float*)out,
           0, B, K, N, KC, (N + 15) / 16,
           ((KC + I8_WARPS - 1) / I8_WARPS) * I8_KC, vec};
  if (i8_smem(1, 1, a.ks_max) > I8_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) return (int)i8_run<__nv_bfloat16>(a, st);
  return (int)i8_run<float>(a, st);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
