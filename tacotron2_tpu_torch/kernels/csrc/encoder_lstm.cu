// Encoder BiLSTM forward: both directions of the text encoder's BiLSTM over
// all T steps, for the batched serving path.
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

extern "C" {

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
