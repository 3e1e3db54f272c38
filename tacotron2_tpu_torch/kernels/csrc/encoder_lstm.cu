// Encoder BiLSTM: the forward of both directions of the text encoder's
// BiLSTM over all T steps (serving and training), and below, its backward
// chain (training): run_bwd_cluster at bf16 (one launch on clusters, as the
// forward), run_bwd (two launches a step) for the rest.
//
// Replaces the TPU kernel tacotron2_tpu/kernels/encoder_lstm.py
// _make_fwd_kernel (called by _fwd_call). Same contract as that kernel:
// the forward direction scans xf, the backward direction scans xr (the
// caller's per-row length-reversed copy), each step computes
// g = [x_t ; h_{t-1}] @ [wi ; wh] + b and the cell, and the six stacks come
// back time-major: gates (T,B,4H) and h (T,B,H) in the operand type, c
// (T,B,H) in fp32.
//
// What bounds it on the H100. Each step is a (B x 768) @ (768 x 1024)
// product per direction at the default widths, and step t cannot start
// before step t-1's h: the scan is a chain of T dependent steps. At B = 128
// the work is ~0.4 GFLOP a step (0.052 ms at the bf16 tensor-core peak for
// T = 128): operations. At serving sizes (B <= 8) a step barely computes
// and the chain's latency is all: ~65.8 us a step when each step was a
// launch that re-read the weights (2 x 1.5 MB) from L2 on CUDA cores.
//
// Design, bf16 at the shapes encoder_cluster_ok takes (H 128 or 256, N in
// 16s; every B and T): ONE launch for the whole scan, on thread-block
// clusters. A cluster of EC_CL = 16 blocks owns one direction and one group
// of R = 16, 32 or 48 rows (cluster_mt: B = 128 takes 6 clusters, one
// wave); block r of the cluster owns hidden units r H/16 .. (r+1) H/16 - 1
// and keeps their four gates' columns of [wi ; wh] (96 KB at H = 256,
// N = 512) in shared memory for all T steps, so the weights are read once
// a launch, not once a step. Each warp tile (16 rows x 8 units' 32 gate
// columns) has two warps:
//   x warp  the x part of the NEXT step, acc = x_{t+1} @ wi on bf16
//           mma.sync m16n8k16, from x_{t+1}'s rows staged in shared memory
//           by cp.async as soon as the x part before was done; the sums
//           left in shared memory;
//   h warp  the recurrence: acc = that x part; wait on the cluster barrier
//           (every block's h_{t-1} has landed in this block's shared
//           memory); acc += h_{t-1} @ wh into the same fp32 accumulators;
//           the cell in registers (the column tiles are gate-interleaved,
//           n8 tile j of a warp gate j of 8 units, as train_scan.cu's
//           scan_cell_kernel, so each thread holds all four gates of its
//           units and keeps their c in registers for the whole scan); then
//           the new h, rounded to bf16 (the TPU kernel's cast point), into
//           every block of the cluster through distributed shared memory
//           (st.shared::cluster, 16 bytes a store, double-buffered by step
//           parity), and barrier.cluster.arrive.release.
// So a step's critical path is the barrier, the h part (K = H), the cell
// and the exchange; the x part (K = N, two thirds of the work) and the
// loads of x run beside it. The cluster barrier stands where the launch
// boundary stood. One fp32 accumulator per gate over all of K (the x part
// first, the h part into the same sums); no partial sum is rounded and
// there are no atomics, so two runs give the same bits. Clusters never
// wait for each other, so a grid larger than the card holds at once only
// runs in more waves. fp32, and the shapes the cluster kernel does not
// take, keep the first design (encoder_step, below): one launch per step
// from a host loop inside the C entry point, CUDA cores, weights from L2.
#include <stdint.h>

#include "lstm_cell.cuh"
#include "mma.cuh"
#include "tc_product.cuh"

#define ENC_UNITS 4      // hidden units per block
#define ENC_THREADS 512  // 16 gate columns x 32 slices of K

template <typename W>
__global__ void __launch_bounds__(ENC_THREADS)
encoder_step(const W* __restrict__ xf, const W* __restrict__ xr,
             const W* __restrict__ wf, const float* __restrict__ bf,
             const W* __restrict__ wb, const float* __restrict__ bb,
             W* gf, W* gb, W* hf, W* hb, float* cf, float* cb,
             int B, int T, int N, int H, int t) {
  constexpr int COLS = 4 * ENC_UNITS;
  constexpr int KSPLIT = ENC_THREADS / COLS;
  extern __shared__ float smem[];
  const int dir = blockIdx.y;
  const int u0 = blockIdx.x * ENC_UNITS;
  const int b0 = blockIdx.z * T2_BT;
  const int K = N + H;
  const W* x = dir ? xr : xf;
  const W* w = dir ? wb : wf;
  const float* bias = dir ? bb : bf;
  W* g = dir ? gb : gf;
  W* h = dir ? hb : hf;
  float* c = dir ? cb : cf;
  float* xs = smem;
  float* red = xs + T2_BT * K;
  float* gsm = red + KSPLIT * T2_BT * COLS;

  // stage [x_t ; h_{t-1}] of the block's T2_BT rows, one load per row in
  // flight together
  for (int k = threadIdx.x; k < K; k += ENC_THREADS) {
    float v[T2_BT];
#pragma unroll
    for (int b = 0; b < T2_BT; ++b) {
      const int row = b0 + b;
      v[b] = 0.0f;
      if (row < B) {
        if (k < N)
          v[b] = to_f<W>(x[((size_t)row * T + t) * N + k]);
        else if (t > 0)
          v[b] = to_f<W>(h[((size_t)(t - 1) * B + row) * H + (k - N)]);
      }
    }
#pragma unroll
    for (int b = 0; b < T2_BT; ++b) xs[k * T2_BT + b] = v[b];
  }
  __syncthreads();
  gate_product<W, ENC_UNITS, ENC_THREADS>(
      xs, K, w + (size_t)blockIdx.x * K * COLS, red, gsm);

  for (int i = threadIdx.x; i < T2_BT * ENC_UNITS; i += ENC_THREADS) {
    const int b = i / ENC_UNITS, u = i % ENC_UNITS, row = b0 + b;
    if (row >= B) continue;
    const int unit = u0 + u;
    const float gi = gsm[b * COLS + 0 * ENC_UNITS + u] + bias[unit];
    const float gff = gsm[b * COLS + 1 * ENC_UNITS + u] + bias[H + unit];
    const float gg = gsm[b * COLS + 2 * ENC_UNITS + u] + bias[2 * H + unit];
    const float go = gsm[b * COLS + 3 * ENC_UNITS + u] + bias[3 * H + unit];
    const float cp = t > 0 ? c[((size_t)(t - 1) * B + row) * H + unit] : 0.0f;
    const float cn = sigmoid_f(gff) * cp + sigmoid_f(gi) * tanhf(gg);
    const float hn = sigmoid_f(go) * tanhf(cn);
    const size_t gb4 = ((size_t)t * B + row) * 4 * H;
    g[gb4 + unit] = from_f<W>(gi);
    g[gb4 + H + unit] = from_f<W>(gff);
    g[gb4 + 2 * H + unit] = from_f<W>(gg);
    g[gb4 + 3 * H + unit] = from_f<W>(go);
    h[((size_t)t * B + row) * H + unit] = from_f<W>(hn);
    c[((size_t)t * B + row) * H + unit] = cn;
  }
}

template <typename W>
static cudaError_t run(const void* xf, const void* xr, const void* wf,
                       const float* bf, const void* wb, const float* bb,
                       void* gf, void* gb, void* hf, void* hb, float* cf,
                       float* cb, int B, int T, int N, int H,
                       cudaStream_t stream) {
  const size_t smem = gate_product_smem<ENC_UNITS, ENC_THREADS>(N + H);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_step<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / ENC_UNITS, 2, (B + T2_BT - 1) / T2_BT);
  for (int t = 0; t < T; ++t) {
    encoder_step<W><<<grid, ENC_THREADS, smem, stream>>>(
        (const W*)xf, (const W*)xr, (const W*)wf, bf, (const W*)wb, bb,
        (W*)gf, (W*)gb, (W*)hf, (W*)hb, cf, cb, B, T, N, H, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// --------------------------------------------- the cluster forward, bf16

#define EC_CL 16   // blocks per cluster: one direction's units, 16 ways
#define EC_PAD 8   // bf16 padding of each shared row (16 bytes: the eight
                   //   rows of an ldmatrix fall in distinct banks)

typedef __nv_bfloat16 bf16;

struct EncFwd {
  const bf16 *xf, *xr;  // (B, T, N)
  const bf16 *wf, *wb;  // block-major [wi ; wh], (H / 4, N + H, 16)
  const float *bf, *bb; // (4H,)
  bf16 *gf, *gb;        // (T, B, 4H)
  bf16 *hf, *hb;        // (T, B, H)
  float *cf, *cb;       // (T, B, H)
  int B, T, N, H, NG;   // NG row groups of 16 MT rows per direction
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves: arrive (release: this thread's writes,
// remote ones included, are visible to every thread of the cluster that
// has waited) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// 16 bytes into block `rank` of the cluster at the shared address its own
// copy of `local` has.
__device__ __forceinline__ void st_cluster16(const void* local,
                                             unsigned rank, uint4 v) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// acc[j] += A (16 rows of a, row stride lda) @ W^T, W^T the warp's 32 rows
// of w (row stride lw: n8 tile j = rows 8j .. 8j+7), over nk k16 steps;
// both operands in shared memory, [row][k], loaded by ldmatrix (matrix mi
// = lane / 8 of an x4 load: A rows 8 (mi % 2), k half mi / 2; W rows
// 8 (mi / 2), k half mi % 2).
__device__ __forceinline__ void ec_product(float (&acc)[4][4], const bf16* a,
                                           int lda, const bf16* w, int lw,
                                           int nk, int lane) {
  const int r8 = lane & 7, mi = lane >> 3;
  const bf16* ap = a + (size_t)(r8 + (mi & 1) * 8) * lda + (mi >> 1) * 8;
  const bf16* bp = w + (size_t)(r8 + (mi >> 1) * 8) * lw + (mi & 1) * 8;
#pragma unroll 4
  for (int s = 0; s < nk; ++s) {
    uint32_t fa[4], f0[4], f1[4];
    ldmatrix_x4(fa, ap + s * 16);
    ldmatrix_x4(f0, bp + s * 16);
    ldmatrix_x4(f1, bp + (size_t)16 * lw + s * 16);
    mma_bf16(acc[0], fa, f0);
    mma_bf16(acc[1], fa, f0 + 2);
    mma_bf16(acc[2], fa, f1);
    mma_bf16(acc[3], fa, f1 + 2);
  }
}

// Named barriers over nthreads threads, which meet here each at its own
// place in the code: id 1 the whole block (h and x warps), id 2 the x
// warps alone.
__device__ __forceinline__ void ec_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// Launched in clusters of EC_CL blocks (x), 2 NG clusters: cluster 2 rg + d
// scans direction d for rows 16 MT rg .. 16 MT (rg + 1) - 1. Block r owns
// units u0 = r H / EC_CL .. + H / EC_CL in NUG = H / (8 EC_CL) groups of 8.
// Its NT = MT NUG tiles (mt, ug), rows 16 mt .. 16 mt + 15 of the group x
// unit group ug's 32 gate columns, have two warps each: h warp `tile`
// runs the recurrence, x warp NT + `tile` computes the x part one step
// ahead. Shared memory: ws [32 NUG][N + H + EC_PAD] bf16, the block's rows
// of [wi ; wh]^T, row 32 ug + 8 j + u gate j of unit u0 + 8 ug + u; hs
// [2][16 MT][H + EC_PAD] bf16, h by step parity, all H units; xp [2][NT][16]
// [32] fp32, the x parts by step parity, accumulator i of lane l at
// [i][l]; xs [16 MT][N + EC_PAD] bf16, the x rows of the x warps' next
// step, staged by cp.async as soon as the last x part is done.
template <int MT>
__global__ void __launch_bounds__(128 * MT, 1)
encoder_cluster_kernel(EncFwd a) {
  extern __shared__ __align__(16) unsigned char ec_raw[];
  const int B = a.B, T = a.T, N = a.N, H = a.H, K = N + H;
  const int UB = H / EC_CL, NUG = UB / 8, R = 16 * MT, NT = MT * NUG;
  const int LW = K + EC_PAD, LH = H + EC_PAD;
  bf16* ws = reinterpret_cast<bf16*>(ec_raw);
  bf16* hs = ws + (size_t)32 * NUG * LW;
  float* xp = reinterpret_cast<float*>(hs + (size_t)2 * R * LH);
  const unsigned rank = cluster_rank();
  const int cl = (int)cluster_index();
  const int dir = cl & 1, row0 = (cl >> 1) * R;
  const bf16* x = dir ? a.xr : a.xf;
  const bf16* wg = dir ? a.wb : a.wf;
  const float* bias = dir ? a.bb : a.bf;
  bf16* gout = dir ? a.gb : a.gf;
  bf16* hout = dir ? a.hb : a.hf;
  float* c_out = dir ? a.cb : a.cf;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool xw = warp >= NT;                 // an x warp
  const int tile = xw ? warp - NT : warp;
  const int mt = tile / NUG, ug = tile % NUG;
  const int u0 = (int)rank * UB;
  const int unit = u0 + ug * 8 + 2 * t4;   // this thread's units: unit, +1

  // the block's weight rows, from the block-major layout (4-unit blocks,
  // column 4 q + u = gate q of unit u), 16 bytes a load
  for (int i = tid; i < UB / 4 * K * 2; i += nt) {
    const int half = i & 1, k = (i >> 1) % K, bl = (i >> 1) / K;
    const uint4 v = *reinterpret_cast<const uint4*>(
        wg + ((size_t)(u0 / 4 + bl) * K + k) * 16 + half * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = half * 8 + q, u = bl * 4 + (col & 3);
      ws[(size_t)((u >> 3) * 32 + (col >> 2) * 8 + (u & 7)) * LW + k] = e[q];
    }
  }
  float bq[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) bq[j][q] = bias[j * H + unit + q];
  const bf16* wrow = ws + (size_t)ug * 32 * LW;
  const int LX = N + EC_PAD, nx = 32 * NT;    // the x warps' threads
  bf16* xs = reinterpret_cast<bf16*>(xp + (size_t)2 * NT * 16 * 32);
  // x_s of the group's rows into xs (zeros past B), by the x warps
  auto load_x = [&](int s) {
    const int per_row = N / 8;
    for (int i = tid - nx; i < R * per_row; i += nx) {
      const int r = i / per_row, c8 = i % per_row, row = row0 + r;
      const bool in = row < B;
      cp_async16(xs + (size_t)r * LX + c8 * 8,
                 x + ((size_t)(in ? row : 0) * T + s) * N + c8 * 8,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };
  // the x part of step s (x_s in xs) into xp[s & 1]; then x_{s+1} into xs
  auto x_part = [&](int s) {
    cp_async_wait<0>();
    ec_sync(2, nx);                  // x_s is in xs for every x warp
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    ec_product(acc, xs + (size_t)mt * 16 * LX, LX, wrow, LW, N / 16, lane);
    float* dst = xp + (size_t)((s & 1) * NT + tile) * 16 * 32 + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(j * 4 + e) * 32] = acc[j][e];
    ec_sync(2, nx);                  // every x warp is done with x_s
    if (s + 1 < T) load_x(s + 1);
  };
  if (xw) {
    load_x(0);
    x_part(0);
  }
  __syncthreads();
  cluster_arrive();   // every block of the cluster has started before any
  cluster_wait();     // writes into another's shared memory

  float cst[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // c of (row, unit) pairs e
  for (int t = 0; t < T; ++t) {
    if (xw) {
      if (t > 0) cluster_wait();
      cluster_arrive();              // the x warps carry no h
      if (t + 1 < T) x_part(t + 1);
      ec_sync(1, nt);                // x part t+1 in xp; x part t read
      continue;
    }
    float acc[4][4];
    const float* src = xp + (size_t)((t & 1) * NT + tile) * 16 * 32 + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = src[(j * 4 + e) * 32];
    if (t > 0) {
      cluster_wait();                // h_{t-1} of every block has landed
      ec_product(acc, hs + ((size_t)((t - 1) & 1) * R + mt * 16) * LH, LH,
                 wrow + N, LW, H / 16, lane);
    }
    // the cell: accumulator e of n8 tile j is gate j of row 16 mt + g +
    // 8 (e >> 1), unit + (e & 1)
    uint32_t hp[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + g + 8 * hh, row = row0 + r;
      float gv[4][2], hv[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = 2 * hh + q;
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j][q] = acc[j][e] + bq[j][q];
        const float cn = sigmoid_f(gv[1][q]) * cst[e] +
                         sigmoid_f(gv[0][q]) * tanhf(gv[2][q]);
        cst[e] = cn;
        hv[q] = sigmoid_f(gv[3][q]) * tanhf(cn);
      }
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(hv[0], hv[1]);
      hp[hh] = *reinterpret_cast<const uint32_t*>(&h2);
      if (row < B) {
        const size_t o = (size_t)t * B + row;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<__nv_bfloat162*>(gout + o * 4 * H + j * H +
                                             unit) =
              __floats2bfloat162_rn(gv[j][0], gv[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(hout + o * H + unit) = h2;
        *reinterpret_cast<float2*>(c_out + o * H + unit) =
            make_float2(cst[2 * hh], cst[2 * hh + 1]);
      }
    }
    // each row's 8 units (16 bytes) gathered from its four lanes; lane t4
    // stores both rows into blocks t4, t4 + 4, t4 + 8, t4 + 12
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint4 v;
      v.x = __shfl_sync(0xffffffffu, hp[hh], (lane & ~3) | 0);
      v.y = __shfl_sync(0xffffffffu, hp[hh], (lane & ~3) | 1);
      v.z = __shfl_sync(0xffffffffu, hp[hh], (lane & ~3) | 2);
      v.w = __shfl_sync(0xffffffffu, hp[hh], (lane & ~3) | 3);
      const bf16* dst = hs + ((size_t)(t & 1) * R + mt * 16 + g + 8 * hh) *
                                 LH + u0 + ug * 8;
#pragma unroll
      for (int p = t4; p < EC_CL; p += 4) st_cluster16(dst, p, v);
    }
    cluster_arrive();
    ec_sync(1, nt);                  // x part t+1 is in xp
  }
  cluster_wait();   // no block leaves while another may still write to it
}

// Shared memory of encoder_cluster_kernel<MT>, in bytes.
static size_t cluster_smem(int MT, int N, int H) {
  const size_t nug = H / EC_CL / 8, R = 16 * MT;
  return sizeof(bf16) * (32 * nug * (N + H + EC_PAD) + 2 * R * (H + EC_PAD) +
                         R * (N + EC_PAD)) +
         sizeof(float) * 2 * MT * nug * 16 * 32;
}

// m16 tiles of rows a cluster takes: 16 rows up to B = 16, then 32, and 48
// from B = 97, so that B = 128 needs 6 clusters of 16 and runs in one wave
// on an H100, which holds 7 at once (encoder_lstm_fwd_plan); 64 rows would
// not fit a block's shared memory.
static int cluster_mt(int B) { return B <= 16 ? 1 : B <= 96 ? 2 : 3; }

// Whether the cluster kernel takes these shapes: bf16, H a multiple of
// 8 EC_CL up to 16 EC_CL (128 or 256), N a multiple of 16, the inputs on
// 16-byte boundaries and the shared memory within what a block may use.
static bool encoder_cluster_ok(int bf16, int B, int N, int H,
                               const void* xf, const void* xr,
                               const void* wf, const void* wb) {
  if (!bf16 || B < 1 || H % (8 * EC_CL) || H > 16 * EC_CL || N < 16 ||
      N % 16)
    return false;
  if (((uintptr_t)xf | (uintptr_t)xr | (uintptr_t)wf | (uintptr_t)wb) % 16)
    return false;
  int dev, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return cluster_smem(cluster_mt(B), N, H) <= (size_t)optin;
}

// The launch configuration of encoder_cluster_kernel<MT>, its attributes
// set (dynamic shared memory, a cluster of 16: non-portable).
template <int MT>
static cudaError_t cluster_config(const EncFwd& a, cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr) {
  auto kern = encoder_cluster_kernel<MT>;
  const size_t smem = cluster_smem(MT, a.N, a.H);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(2 * a.NG * EC_CL);
  cfg->blockDim = dim3(64 * MT * (a.H / EC_CL / 8));
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = EC_CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int MT>
static cudaError_t run_cluster(const EncFwd& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<MT>(a, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, encoder_cluster_kernel<MT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

static EncFwd encoder_args(const void* xf, const void* xr, const void* wf,
                           const void* bf, const void* wb, const void* bb,
                           void* gf, void* gb, void* hf, void* hb, void* cf,
                           void* cb, int B, int T, int N, int H) {
  const int R = 16 * cluster_mt(B);
  return EncFwd{(const bf16*)xf, (const bf16*)xr, (const bf16*)wf,
                (const bf16*)wb, (const float*)bf, (const float*)bb,
                (bf16*)gf, (bf16*)gb, (bf16*)hf, (bf16*)hb, (float*)cf,
                (float*)cb, B, T, N, H, (B + R - 1) / R};
}

// ------------------------------------------------------------- backward
//
// Replaces the TPU kernel tacotron2_tpu/kernels/encoder_lstm.py
// _make_bwd_kernel (called by _bwd_call): the reverse-time data-gradient
// chain of both directions. Per step t, from T-1 down to 0, for each
// direction: dh = dh_{t+1 carry} + dh_in[t]; the cell backward
// (lstm_unit_bwd) gives dg[t], rounded to the operand type; then
// dx = dg[t] @ [wi ; wh]^T in fp32, whose first N columns are dx[t] and last
// H columns the carry into step t-1. The weight gradients are not formed
// here: the caller takes them as single products over T*B.
//
// What bounds it on the H100: the same as the forward -- per step, a
// (B x 4H) @ (4H x (N+H)) product per direction (each weight element feeds
// T2_BT rows) and the launches. Design: two launches per step covering both
// directions, lstm_gates_bwd_kernel (one thread per row and unit) and
// tile_product_kernel (one block per 32 output columns and 8 rows, the
// transposed weights column-tiled, kernels/lstm_layout.py to_col_tiles);
// the product lands in a (B, N+H) scratch per direction, whose first N
// columns are copied into dx[t] and whose last H columns the next step's
// gate launch reads. fp32, and bf16 shapes the cluster design below does
// not take, run this one.
template <typename W>
static cudaError_t run_bwd(const W* wtf, const W* wtb, const W* gf,
                           const W* gb, const float* cf, const float* cb,
                           const float* dhf, const float* dhb, W* dgf, W* dgb,
                           float* dxf, float* dxb, float* dcf, float* dcb,
                           float* scrf, float* scrb, int B, int T, int N,
                           int H, cudaStream_t stream) {
  const int K = 4 * H, NO = N + H;
  cudaError_t err = tile_product_prepare<W>(K);
  if (err != cudaSuccess) return err;
  const dim3 g_gates((B * H + 255) / 256, 2);
  const dim3 g_prod((NO + TP_COLS - 1) / TP_COLS, (B + T2_BT - 1) / T2_BT, 2);
  const size_t smem = tile_product_smem(K);
  const size_t gs = (size_t)B * K, hs = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t == T - 1;
    GatesBwd<W> a0{gf + t * gs, cf + t * hs, t ? cf + (t - 1) * hs : nullptr,
                   last ? nullptr : scrf + N, NO, dhf + t * hs, nullptr,
                   1.0f, dcf, dgf + t * gs};
    GatesBwd<W> a1{gb + t * gs, cb + t * hs, t ? cb + (t - 1) * hs : nullptr,
                   last ? nullptr : scrb + N, NO, dhb + t * hs, nullptr,
                   1.0f, dcb, dgb + t * gs};
    lstm_gates_bwd_kernel<W><<<g_gates, 256, 0, stream>>>(a0, a1, B, H);
    tile_product_kernel<W><<<g_prod, TP_THREADS, smem, stream>>>(
        dgf + t * gs, wtf, scrf, dgb + t * gs, wtb, scrb, B, K, NO);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t xo = (size_t)t * B * N;
    err = cudaMemcpy2DAsync(dxf + xo, N * sizeof(float), scrf,
                            NO * sizeof(float), N * sizeof(float), B,
                            cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
    err = cudaMemcpy2DAsync(dxb + xo, N * sizeof(float), scrb,
                            NO * sizeof(float), N * sizeof(float), B,
                            cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ------------------------------------------ the cluster backward, bf16
//
// bf16 at H = 16 EC_CL (256) and N in 32s: the chain of both directions in
// ONE launch on clusters of EC_CL blocks, row 3's design carried over. A
// cluster owns one direction and one group of R = 16, 32 or 48 rows
// (cluster_mt, as the forward); block r owns hidden units u0 = 16 r ..
// u0 + 15 and all four of their gates (its 64 "gate columns" k = 16 q + i:
// gate q of unit u0 + i). Per step t, from T - 1 down to 0:
//   cell    each thread takes MT (row, unit) pairs, the same every step:
//           dh = (the 16 blocks' partials of the carry, summed in rank
//           order) + dh_in[t]; lstm_unit_bwd in registers (dc stays in a
//           register for the whole chain) -> dg, rounded to bf16 (the TPU
//           kernel's cast point) into the block's shared dgs [R][64];
//   store   dg[t] of the block's columns to device memory, 16 bytes a store;
//   product each block forms the partial carry of ALL H units from its own
//           64 gate columns, swap-AB on mma.sync m16n8k16: the units are
//           the m16 side (warp w: unit tiles w and w + 8, its slice of
//           wh^T held in registers as A fragments for the whole chain), the
//           rows the n8 side (B fragments by ldmatrix from dgs), fp32 sums;
//   push    unit tile p of the partial goes to block p (the owner of those
//           units) through distributed shared memory, 8 bytes a store, into
//           recv[step parity][this block's rank][unit][row]: each block
//           receives R x H fp32 a step (half of what sending dg would take)
//           and sums the 16 partials in a fixed order;
//   barrier barrier.cluster.arrive.release / wait.acquire, the step's only
//           synchronisation between blocks.
// Each step's g, c and dh_in rows of the block's units are staged by
// cp.async one step ahead (g and dh_in double-buffered, c in a ring of
// three: a step reads c_t and c_{t-1}). dx = dg @ wi^T leaves the chain: one
// product over all T*B rows per direction after it, on the tensor cores
// (tc_product.cuh), bf16 operands and fp32 sums as the TPU kernel's body.
// No float atomics, every sum in a fixed order: two runs give the same bits.

#define EB_UNITS 16     // units per block (H / EC_CL)
#define EB_THREADS 256  // 8 warps: unit tiles w and w + 8 of the product
#define EB_GPAD 8       // bf16 padding of a staged g / dgs row
#define EB_FPAD 4       // fp32 padding of a staged c / dh_in row

struct EncBwd {
  const bf16 *wtf, *wtb;  // [wi ; wh]^T column-tiled, (ceil((N+H)/32), 4H, 32)
  const bf16 *gf, *gb;    // (T, B, 4H)
  const float *cf, *cb;   // (T, B, H)
  const float *dhf, *dhb; // (T, B, H)
  bf16 *dgf, *dgb;        // (T, B, 4H) out
  int B, T, N, H, NG;     // NG row groups of 16 MT rows per direction
};

// Shared memory of encoder_bwd_cluster_kernel<MT>, in bytes.
static size_t bwd_cluster_smem(int MT) {
  const size_t R = 16 * MT;
  return sizeof(float) * (2 * EC_CL * EB_UNITS * (R + 8) +
                          5 * R * (EB_UNITS + EB_FPAD)) +
         sizeof(bf16) * 3 * R * (4 * EB_UNITS + EB_GPAD);
}

// 8 bytes into block `rank` of the cluster at the shared address its own
// copy of `local` has.
__device__ __forceinline__ void st_cluster8(const float* local, unsigned rank,
                                            float a, float b) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(a), "f"(b)
               : "memory");
}

// Launched in clusters of EC_CL blocks (x), 2 NG clusters: cluster 2 rg + d
// runs direction d for rows 16 MT rg .. 16 MT (rg + 1) - 1. Shared memory:
// recv [2][EC_CL][EB_UNITS][R + 8] fp32, the partials of the carry by step
// parity, source rank, unit and row; cs [3][R][EB_UNITS + EB_FPAD] fp32, c
// of the block's units by step mod 3; ds [2][R][..] fp32, dh_in by step
// parity; gs [2][R][64 + EB_GPAD] bf16, g of the block's gate columns by
// step parity (column 16 q + i: gate q of unit u0 + i); dgs [R][64 +
// EB_GPAD] bf16, the step's dg.
template <int MT>
__global__ void __launch_bounds__(EB_THREADS, 1)
encoder_bwd_cluster_kernel(EncBwd a) {
  extern __shared__ __align__(16) unsigned char eb_raw[];
  constexpr int R = 16 * MT, LR = R + 8, LF = EB_UNITS + EB_FPAD;
  constexpr int LG = 4 * EB_UNITS + EB_GPAD;
  const int B = a.B, T = a.T, N = a.N, H = a.H, G = 4 * H;
  float* recv = reinterpret_cast<float*>(eb_raw);
  float* cs = recv + 2 * EC_CL * EB_UNITS * LR;
  float* ds = cs + 3 * R * LF;
  bf16* gs = reinterpret_cast<bf16*>(ds + 2 * R * LF);
  bf16* dgs = gs + 2 * R * LG;
  const unsigned rank = cluster_rank();
  const int cl = (int)cluster_index();
  const int dir = cl & 1, row0 = (cl >> 1) * R;
  const bf16* wt = dir ? a.wtb : a.wtf;
  const bf16* g = dir ? a.gb : a.gf;
  const float* c = dir ? a.cb : a.cf;
  const float* dh_in = dir ? a.dhb : a.dhf;
  bf16* dg_out = dir ? a.dgb : a.dgf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int u0 = (int)rank * EB_UNITS;

  // the warp's A fragments: unit tiles mt = warp + 8 m, k16 step s = gate s
  // (k = 16 s + i: gate s of unit u0 + i); A[unit][k] = wh[gate][unit] =
  // wt[s H + u0 + i][N + unit], from the column tiles
  uint32_t af[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int sq = 0; sq < 4; ++sq)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int unit = 16 * (warp + 8 * m) + gq + 8 * (r & 1);
        const int col = N + unit;
        const int gate = sq * H + u0 + 2 * t4 + 8 * (r >> 1);
        const bf16* p = wt + ((size_t)(col >> 5) * G + gate) * 32 + (col & 31);
        __nv_bfloat162 v;
        v.x = p[0];
        v.y = p[32];   // the next gate row of the same tile
        af[m][sq][r] = *reinterpret_cast<const uint32_t*>(&v);
      }

  // g[s] and dh_in[s] of the group's rows into slot s & 1; c[s] into slot
  // s % 3 (zeros past B)
  auto stage_gd = [&](int s) {
    bf16* gdst = gs + (size_t)(s & 1) * R * LG;
    float* ddst = ds + (size_t)(s & 1) * R * LF;
    for (int i = tid; i < R * 12; i += EB_THREADS) {
      const int r = i / 12, p = i % 12, row = row0 + r;
      const bool in = row < B;
      const size_t o = (size_t)s * B + (in ? row : 0);
      if (p < 8)   // gate p / 2, units u0 + 8 (p & 1) ..
        cp_async16(gdst + (size_t)r * LG + p * 8,
                   g + o * G + (p >> 1) * H + u0 + (p & 1) * 8, in ? 16 : 0);
      else
        cp_async16(ddst + (size_t)r * LF + (p - 8) * 4,
                   dh_in + o * H + u0 + (p - 8) * 4, in ? 16 : 0);
    }
  };
  auto stage_c = [&](int s) {
    float* cdst = cs + (size_t)(s % 3) * R * LF;
    for (int i = tid; i < R * 4; i += EB_THREADS) {
      const int r = i / 4, p = i % 4, row = row0 + r;
      const bool in = row < B;
      cp_async16(cdst + (size_t)r * LF + p * 4,
                 c + ((size_t)s * B + (in ? row : 0)) * H + u0 + p * 4,
                 in ? 16 : 0);
    }
  };
  stage_gd(T - 1);
  stage_c(T - 1);
  if (T >= 2) stage_c(T - 2);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cluster_arrive();   // every block of the cluster has started before any
  cluster_wait();     // writes into another's shared memory

  float dc[MT];
#pragma unroll
  for (int k = 0; k < MT; ++k) dc[k] = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
    // the cell backward of the thread's (row, unit) pairs: pair block
    // b = warp + 8 k, rows 8 (b >> 2) .. + 7, units 4 (b & 3) .. + 3
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      const int b = warp + 8 * k;
      const int r = 8 * (b >> 2) + gq, ul = 4 * (b & 3) + t4;
      float carry = 0.0f;
      if (t < T - 1) {
        const float* src = recv + ((size_t)par * EC_CL * EB_UNITS + ul) * LR
                           + r;
#pragma unroll
        for (int p = 0; p < EC_CL; ++p) carry += src[(size_t)p * EB_UNITS * LR];
      }
      const float dh = carry + ds[((size_t)par * R + r) * LF + ul];
      const bf16* gr = gs + ((size_t)par * R + r) * LG + ul;
      const float cn = cs[((size_t)(t % 3) * R + r) * LF + ul];
      const float cp = t ? cs[((size_t)((t + 2) % 3) * R + r) * LF + ul] : 0.0f;
      float dgv[4];
      dc[k] = lstm_unit_bwd(__bfloat162float(gr[0]),
                            __bfloat162float(gr[EB_UNITS]),
                            __bfloat162float(gr[2 * EB_UNITS]),
                            __bfloat162float(gr[3 * EB_UNITS]), cp, cn, dh,
                            dc[k], dgv);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dgs[(size_t)r * LG + q * EB_UNITS + ul] = __float2bfloat16(dgv[q]);
    }
    __syncthreads();   // dgs holds the step's dg
    for (int i = tid; i < R * 8; i += EB_THREADS) {
      const int r = i >> 3, p = i & 7, row = row0 + r;
      if (row < B)
        *reinterpret_cast<uint4*>(dg_out + ((size_t)t * B + row) * G +
                                  (p >> 1) * H + u0 + (p & 1) * 8) =
            *reinterpret_cast<const uint4*>(dgs + (size_t)r * LG + p * 8);
    }
    if (t >= 1) stage_gd(t - 1);
    if (t >= 2) stage_c(t - 2);
    cp_async_commit();
    if (t >= 1) {
      // partial carry (all H units x R rows) from the block's 64 columns
      float acc[2][2 * MT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
      const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
      for (int sq = 0; sq < 4; ++sq)
#pragma unroll
        for (int jp = 0; jp < MT; ++jp) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, dgs + (size_t)(16 * jp + r8 + (mi >> 1) * 8) * LG +
                               16 * sq + (mi & 1) * 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][2 * jp], af[m][sq], bfr);
            mma_bf16(acc[m][2 * jp + 1], af[m][sq], bfr + 2);
          }
        }
      // unit tile warp + 8 m belongs to block warp + 8 m: accumulator e of
      // n8 tile j is unit g + 8 (e >> 1) of the tile, row 8 j + 2 t4 + (e & 1)
      const int npar = (t - 1) & 1;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned peer = (unsigned)(warp + 8 * m);
#pragma unroll
        for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* dst =
                recv + (((size_t)npar * EC_CL + rank) * EB_UNITS + gq +
                        8 * hh) * LR + 8 * j + 2 * t4;
            st_cluster8(dst, peer, acc[m][j][2 * hh], acc[m][j][2 * hh + 1]);
          }
      }
    }
    cp_async_wait<0>();
    cluster_arrive();  // this block's pushes and staged rows are visible
    cluster_wait();    // every block's partials of step t have landed
  }
}

// Whether the cluster backward takes these shapes: bf16, H = 16 EC_CL,
// N a multiple of 32, every pointer on a 16-byte boundary, the shared
// memory within what a block may use.
static bool bwd_cluster_ok(int bf16, int B, int N, int H, const void* const* p,
                           int np) {
  if (!bf16 || B < 1 || H != EB_UNITS * EC_CL || N < 32 || N % 32) return false;
  for (int i = 0; i < np; ++i)
    if ((uintptr_t)p[i] % 16) return false;
  int dev, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return bwd_cluster_smem(cluster_mt(B)) <= (size_t)optin;
}

template <int MT>
static cudaError_t bwd_cluster_config(const EncBwd& a, cudaLaunchConfig_t* cfg,
                                      cudaLaunchAttribute* attr) {
  auto kern = encoder_bwd_cluster_kernel<MT>;
  const size_t smem = bwd_cluster_smem(MT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(2 * a.NG * EC_CL);
  cfg->blockDim = dim3(EB_THREADS);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = EC_CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int MT>
static cudaError_t run_bwd_cluster_mt(const EncBwd& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bwd_cluster_config<MT>(a, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, encoder_bwd_cluster_kernel<MT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The chain in one cluster launch, then dx = dg @ wi^T per direction on the
// tensor cores: X = dg (T B, 4H), W = the first N columns of the column
// tiles, one K slice (at T B = 128 x 128 the 8 x 128 tiles fill the card
// many times over).
static cudaError_t run_bwd_cluster(const EncBwd& a, float* dxf, float* dxb,
                                   cudaStream_t s) {
  cudaError_t err;
  switch (cluster_mt(a.B)) {
    case 1: err = run_bwd_cluster_mt<1>(a, s); break;
    case 2: err = run_bwd_cluster_mt<2>(a, s); break;
    default: err = run_bwd_cluster_mt<3>(a, s);
  }
  if (err != cudaSuccess) return err;
  err = tc_product_prepare();
  if (err != cudaSuccess) return err;
  const int M = a.T * a.B, G = 4 * a.H;
  err = tc_product(a.dgf, G, M, G, a.wtf, a.N, 1,
                   TcOut{dxf, nullptr, nullptr, nullptr, 0, 0}, s);
  if (err != cudaSuccess) return err;
  return tc_product(a.dgb, G, M, G, a.wtb, a.N, 1,
                    TcOut{dxb, nullptr, nullptr, nullptr, 0, 0}, s);
}

extern "C" {

// Backward chain of both directions: the cluster kernel and the dx
// products where bwd_cluster_ok takes the shapes (run_bwd_cluster), else
// two launches a step (run_bwd). wt*: ([wi ; wh]^T) column-tiled,
// (ceil((N+H)/32), 4H, 32); g*: (T, B, 4H); c*, dh*: (T, B, H) fp32; out
// dg* (T, B, 4H), dx* (T, B, N) fp32. dc* (B, H) must hold zeros; scr* are
// (B, N+H) fp32 scratch (both for run_bwd only). Returns cudaError_t.
int encoder_lstm_bwd(int bf16, const void* wtf, const void* wtb,
                     const void* gf, const void* gb, const void* cf,
                     const void* cb, const void* dhf, const void* dhb,
                     void* dgf, void* dgb, void* dxf, void* dxb, void* dcf,
                     void* dcb, void* scrf, void* scrb, int B, int T, int N,
                     int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* ptrs[] = {wtf, wtb, gf, gb, cf, cb, dhf, dhb, dgf, dgb};
  if (bwd_cluster_ok(bf16, B, N, H, ptrs, 10)) {
    const int R = 16 * cluster_mt(B);
    typedef __nv_bfloat16 BF;   // `bf16` is the flag here
    const EncBwd a{(const BF*)wtf, (const BF*)wtb, (const BF*)gf,
                   (const BF*)gb, (const float*)cf, (const float*)cb,
                   (const float*)dhf, (const float*)dhb, (BF*)dgf, (BF*)dgb,
                   B, T, N, H, (B + R - 1) / R};
    return (int)run_bwd_cluster(a, (float*)dxf, (float*)dxb, s);
  }
#define T2_ARGS(W)                                                        \
  (const W*)wtf, (const W*)wtb, (const W*)gf, (const W*)gb,               \
      (const float*)cf, (const float*)cb, (const float*)dhf,              \
      (const float*)dhb, (W*)dgf, (W*)dgb, (float*)dxf, (float*)dxb,      \
      (float*)dcf, (float*)dcb, (float*)scrf, (float*)scrb, B, T, N, H, s
  if (bf16) return (int)run_bwd<__nv_bfloat16>(T2_ARGS(__nv_bfloat16));
  return (int)run_bwd<float>(T2_ARGS(float));
#undef T2_ARGS
}

// bf16 != 0: operands are __nv_bfloat16, else float. The cluster kernel
// where encoder_cluster_ok takes the shapes, else one launch per step.
// Returns cudaError_t.
int encoder_lstm_fwd(int bf16, const void* xf, const void* xr, const void* wf,
                     const void* bf, const void* wb, const void* bb, void* gf,
                     void* gb, void* hf, void* hb, void* cf, void* cb, int B,
                     int T, int N, int H, void* stream) {
  if (H % ENC_UNITS != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (encoder_cluster_ok(bf16, B, N, H, xf, xr, wf, wb)) {
    const EncFwd a = encoder_args(xf, xr, wf, bf, wb, bb, gf, gb, hf, hb, cf,
                                  cb, B, T, N, H);
    switch (cluster_mt(B)) {
      case 1: return (int)run_cluster<1>(a, s);
      case 2: return (int)run_cluster<2>(a, s);
      default: return (int)run_cluster<3>(a, s);
    }
  }
  if (bf16)
    return (int)run<__nv_bfloat16>(xf, xr, wf, (const float*)bf, wb,
                                   (const float*)bb, gf, gb, hf, hb,
                                   (float*)cf, (float*)cb, B, T, N, H, s);
  return (int)run<float>(xf, xr, wf, (const float*)bf, wb, (const float*)bb,
                         gf, gb, hf, hb, (float*)cf, (float*)cb, B, T, N, H,
                         s);
}

// Which design encoder_lstm_fwd takes at these shapes (inputs assumed on
// 16-byte boundaries): returns 1 for the cluster kernel, with *needed its
// clusters and *active how many the device holds at once
// (cudaOccupancyMaxActiveClusters), 0 for one launch per step; < 0 a
// device query failed (the cudaError_t, negated).
int encoder_lstm_fwd_plan(int bf16, int B, int N, int H, int* needed,
                          int* active) {
  const char* al = nullptr;  // any 16-byte aligned address
  if (!encoder_cluster_ok(bf16, B, N, H, al, al, al, al)) return 0;
  const EncFwd a = encoder_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, B, 1, N, H);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kern;
  cudaError_t err;
  switch (cluster_mt(B)) {
    case 1:
      err = cluster_config<1>(a, &cfg, &attr);
      kern = (const void*)encoder_cluster_kernel<1>;
      break;
    case 2:
      err = cluster_config<2>(a, &cfg, &attr);
      kern = (const void*)encoder_cluster_kernel<2>;
      break;
    default:
      err = cluster_config<3>(a, &cfg, &attr);
      kern = (const void*)encoder_cluster_kernel<3>;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(active, kern, &cfg);
  if (err != cudaSuccess) return -(int)err;
  *needed = 2 * a.NG;
  return 1;
}

// Which design encoder_lstm_bwd takes at these shapes (inputs assumed on
// 16-byte boundaries): 1 for the cluster kernel, with *needed its clusters
// and *active how many the device holds at once, 0 for two launches a step;
// < 0 a device query failed (the cudaError_t, negated).
int encoder_lstm_bwd_plan(int bf16, int B, int N, int H, int* needed,
                          int* active) {
  const void* al[1] = {nullptr};   // any 16-byte aligned address
  if (!bwd_cluster_ok(bf16, B, N, H, al, 1)) return 0;
  const int R = 16 * cluster_mt(B);
  EncBwd a{};
  a.B = B, a.T = 1, a.N = N, a.H = H, a.NG = (B + R - 1) / R;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* kern;
  cudaError_t err;
  switch (cluster_mt(B)) {
    case 1:
      err = bwd_cluster_config<1>(a, &cfg, &attr);
      kern = (const void*)encoder_bwd_cluster_kernel<1>;
      break;
    case 2:
      err = bwd_cluster_config<2>(a, &cfg, &attr);
      kern = (const void*)encoder_bwd_cluster_kernel<2>;
      break;
    default:
      err = bwd_cluster_config<3>(a, &cfg, &attr);
      kern = (const void*)encoder_bwd_cluster_kernel<3>;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(active, kern, &cfg);
  if (err != cudaSuccess) return -(int)err;
  *needed = 2 * a.NG;
  return 1;
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
