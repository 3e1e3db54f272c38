// Encoder BiLSTM: the forward of both directions of the text encoder's
// BiLSTM over all T steps (serving and training), and below, run_bwd, its
// backward chain (training).
//
// Replaces the TPU kernel tacotron2_tpu/kernels/encoder_lstm.py
// _make_fwd_kernel (called by _fwd_call). Same contract as that kernel:
// the forward direction scans xf, the backward direction scans xr (the
// caller's per-row length-reversed copy), each step computes
// g = [x_t ; h_{t-1}] @ [wi ; wh] + b and the cell, and the six stacks come
// back time-major: gates (T,B,4H) and h (T,B,H) in the operand type, c
// (T,B,H) in fp32.
//
// What bounds it on the H100: each step is a (B x 768) @ (768 x 1024)
// product per direction: each 2-byte bf16 weight feeds only B = 8 FMAs,
// 8 FLOP per byte, far below the ~295 FLOP/byte at which the tensor cores
// become the limit. The step is bound by reading the weights (2 x 1.5 MB,
// read again every step; they stay resident in the 50 MB L2) and, at this
// size, by the launch of each step.
//
// Design: one launch per time step covering both directions (grid.y). A
// block owns ENC_UNITS hidden units of one direction and all four of their
// gate columns over K = N + H, so the cell update stays in the block; the
// weights come block-major (kernels/lstm_layout.py), so a block's slab is
// contiguous and its loads are whole 32-byte sectors; each weight element
// read feeds T2_BT = 8 batch rows (grid.z tiles larger batches). h_{t-1} is read back from the h stack (already rounded to the
// operand type, the TPU kernel's cast point) and c_{t-1} from the fp32 c
// stack, so no state crosses a launch except through the outputs. Each
// thread keeps T2_LOADS weight loads in flight, so a step is not one chain
// of L2 latencies. 64 unit slices x 2 directions = 128 blocks at H = 256,
// one wave on 132 SMs. The host
// loop over T runs inside the C entry point, so one call from Python
// launches all T steps. Tensor cores (wgmma) and a persistent kernel that
// keeps the weights in shared memory across steps are later work.
#include "lstm_cell.cuh"

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
// gate launch reads.
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

extern "C" {

// Backward chain of both directions (see run_bwd). wt*: ([wi ; wh]^T)
// column-tiled, (ceil((N+H)/32), 4H, 32); g*: (T, B, 4H); c*, dh*:
// (T, B, H) fp32; out dg* (T, B, 4H), dx* (T, B, N) fp32. dc* (B, H) must
// hold zeros; scr* are (B, N+H) fp32 scratch. Returns cudaError_t.
int encoder_lstm_bwd(int bf16, const void* wtf, const void* wtb,
                     const void* gf, const void* gb, const void* cf,
                     const void* cb, const void* dhf, const void* dhb,
                     void* dgf, void* dgb, void* dxf, void* dxb, void* dcf,
                     void* dcb, void* scrf, void* scrb, int B, int T, int N,
                     int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define T2_ARGS(W)                                                        \
  (const W*)wtf, (const W*)wtb, (const W*)gf, (const W*)gb,               \
      (const float*)cf, (const float*)cb, (const float*)dhf,              \
      (const float*)dhb, (W*)dgf, (W*)dgb, (float*)dxf, (float*)dxb,      \
      (float*)dcf, (float*)dcb, (float*)scrf, (float*)scrb, B, T, N, H, s
  if (bf16) return (int)run_bwd<__nv_bfloat16>(T2_ARGS(__nv_bfloat16));
  return (int)run_bwd<float>(T2_ARGS(float));
#undef T2_ARGS
}

// bf16 != 0: operands are __nv_bfloat16, else float. Returns cudaError_t.
int encoder_lstm_fwd(int bf16, const void* xf, const void* xr, const void* wf,
                     const void* bf, const void* wb, const void* bb, void* gf,
                     void* gb, void* hf, void* hb, void* cf, void* cb, int B,
                     int T, int N, int H, void* stream) {
  if (H % ENC_UNITS != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)run<__nv_bfloat16>(xf, xr, wf, (const float*)bf, wb,
                                   (const float*)bb, gf, gb, hf, hb,
                                   (float*)cf, (float*)cb, B, T, N, H, s);
  return (int)run<float>(xf, xr, wf, (const float*)bf, wb, (const float*)bb,
                         gf, gb, hf, hb, (float*)cf, (float*)cb, B, T, N, H,
                         s);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
