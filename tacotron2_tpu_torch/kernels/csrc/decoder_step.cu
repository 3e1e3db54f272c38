// Single-utterance decoder chunk: `cs` autoregressive Tacotron 2 decoder
// steps for one row, for offline and streamed synthesis of one utterance.
//
// Replaces the TPU kernel tacotron2_tpu/kernels/decoder_step.py _make_kernel
// (called by _fused_chunk_call). The step is the batched chunk's
// (decoder_batch.cu: prenet, attention LSTM, location-sensitive attention,
// decoder LSTM, mel + gate projection, gate latch) with that TPU kernel's
// own cast points: the query, the location term (K2, w, w_cum) and the
// processed memory stay in fp32, only tanh's output is rounded to the
// operand type W before the v-product, and the context is summed from the
// fp32 memory. After the gate latches the state keeps stepping, as in the
// TPU kernel; only mel, gate, align and the length are masked.
//
// What bounds it on the H100: one row needs one multiply-add per weight
// element, so a step is the two LSTM weight matrices (1792 x 4096 and
// 2560 x 4096, 35.7 MB in bf16) read once: bytes, not operations. No SM
// holds them (227 KB of shared memory), the 50 MB L2 does. But at B = 1 a
// step barely computes: what costs is latency, seven dependent phases a
// step, each a few round trips to L2. Launched as seven kernels a step
// from a host loop they cost ~47-53 us a step on an NVIDIA H100 80GB HBM3
// at 700 W, the launches' own gaps included.
//
// Design. The bf16 chunk (the serving path) runs as ONE cooperative
// persistent launch: the batched chunk's persistent kernel
// (persistent_chunk.cuh) at B = 1 with this TPU kernel's cast points
// (AT = float: fp32 query, K2, location term, processed memory and
// memory). One block per SM; a grid barrier stands where a launch boundary
// stood; the decoder LSTM's weights stay in shared memory for the chunk,
// the attention LSTM's stream from L2 in mma.sync fragment order
// (kernels/lstm_layout.py to_mma_tiles); both LSTM products run on the
// tensor cores in swap-AB form (the row is one column of an n8 tile).
//
// The fp32 chunk, and bf16 shapes the persistent plan does not take, keep
// the first design, one launch per phase from a host loop inside the C
// entry point. There each LSTM is a
// matrix-vector product of its own (lstm_row_kernel): a block owns
// DEC_UNITS hidden units (the same block-major slabs,
// kernels/lstm_layout.py), a thread reads 8 weights (16 bytes in bf16) per
// load and keeps ROW_LOADS loads in flight, the partial sums meet by warp
// shuffles and one pass through shared memory, and the cell update stays in
// the block. The small products (prenet, query, projection) and the
// softmax + context are the batched chunk's kernels launched with one row
// (decoder_common.cuh, attention.cuh).
#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "decoder_common.cuh"
#include "lstm_cell.cuh"
#include "persistent_chunk.cuh"

#define ROW_THREADS 512  // lstm_row_kernel block: 4 gates x 128 slices of K
#define ROW_LOADS 4      // 8-weight loads each thread keeps in flight
#define ROW_COLS (4 * DEC_UNITS)
static_assert(DEC_UNITS == 8, "a thread's load is one gate of the 8 units");

// Eight consecutive weights as fp32.
template <typename W>
__device__ __forceinline__ void load8(const W* __restrict__ p, float* o);
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ p, float* o) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(u[i] << 16);
    o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void load8<float>(const float* __restrict__ p,
                                             float* o) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

// LSTM cell of one row over the input [s0 ; s1 ; s2] (fp32 sources, rounded
// to W here). w is block-major: block b's slab (K, 32), column g*8 + u
// holding gate g of the block's unit u. Thread layout: gate = tid % 4 (its
// 8 columns are that gate of the 8 units), K slice = tid / 4. c is updated
// in place, the new h written to h_out (not the buffer s2 reads: other
// blocks of the launch still read the old h).
template <typename W>
__global__ void __launch_bounds__(ROW_THREADS)
lstm_row_kernel(const float* __restrict__ s0, int L0,
                const float* __restrict__ s1, int L1,
                const float* __restrict__ s2, int L2, const W* __restrict__ w,
                const float* __restrict__ bias, float* c,
                float* __restrict__ h_out, int H) {
  constexpr int KSPLIT = ROW_THREADS / 4;
  constexpr int WARPS = ROW_THREADS / 32;
  extern __shared__ float smem[];
  const int K = L0 + L1 + L2;
  float* xs = smem;                  // K
  float* red = xs + K;               // WARPS * ROW_COLS
  float* gsm = red + WARPS * ROW_COLS;  // ROW_COLS
  for (int k = threadIdx.x; k < K; k += ROW_THREADS) {
    float v;
    if (k < L0) v = s0[k];
    else if (k < L0 + L1) v = s1[k - L0];
    else v = s2[k - L0 - L1];
    xs[k] = rnd<W>(v);
  }
  __syncthreads();
  const int gate = threadIdx.x & 3, ks = threadIdx.x >> 2;
  const W* wp = w + (size_t)blockIdx.x * K * ROW_COLS + gate * DEC_UNITS;
  float acc[DEC_UNITS];
#pragma unroll
  for (int u = 0; u < DEC_UNITS; ++u) acc[u] = 0.0f;
  // (batches of 8 loads with a predicated last batch read 11.5 us a call
  // where this loop reads 7.4, on an NVIDIA H100 80GB HBM3 at 700 W)
  int k = ks;
  for (; k + (ROW_LOADS - 1) * KSPLIT < K; k += ROW_LOADS * KSPLIT) {
    float wv[ROW_LOADS][DEC_UNITS];
#pragma unroll
    for (int j = 0; j < ROW_LOADS; ++j)
      load8<W>(wp + (size_t)(k + j * KSPLIT) * ROW_COLS, wv[j]);
#pragma unroll
    for (int j = 0; j < ROW_LOADS; ++j) {
      const float x = xs[k + j * KSPLIT];
#pragma unroll
      for (int u = 0; u < DEC_UNITS; ++u) acc[u] = fmaf(x, wv[j][u], acc[u]);
    }
  }
  for (; k < K; k += KSPLIT) {
    float wv[DEC_UNITS];
    load8<W>(wp + (size_t)k * ROW_COLS, wv);
    const float x = xs[k];
#pragma unroll
    for (int u = 0; u < DEC_UNITS; ++u) acc[u] = fmaf(x, wv[u], acc[u]);
  }
  // the warp's 8 slices of each gate meet in lanes 0..3
#pragma unroll
  for (int u = 0; u < DEC_UNITS; ++u) {
    float v = acc[u];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    acc[u] = v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < 4) {
#pragma unroll
    for (int u = 0; u < DEC_UNITS; ++u)
      red[warp * ROW_COLS + lane * DEC_UNITS + u] = acc[u];
  }
  __syncthreads();
  if (threadIdx.x < ROW_COLS) {
    float s = 0.0f;
    for (int j = 0; j < WARPS; ++j) s += red[j * ROW_COLS + threadIdx.x];
    gsm[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < DEC_UNITS) {
    const int u = threadIdx.x, unit = blockIdx.x * DEC_UNITS + u;
    const float gi = gsm[0 * DEC_UNITS + u] + bias[unit];
    const float gf = gsm[1 * DEC_UNITS + u] + bias[H + unit];
    const float gg = gsm[2 * DEC_UNITS + u] + bias[2 * H + unit];
    const float go = gsm[3 * DEC_UNITS + u] + bias[3 * H + unit];
    const float cn = sigmoid_f(gf) * c[unit] + sigmoid_f(gi) * tanhf(gg);
    c[unit] = cn;
    h_out[unit] = sigmoid_f(go) * tanhf(cn);
  }
}

struct StepChunk {
  // weights (W unless noted)
  const void *pre1, *pre2, *w1, *w2, *wq, *v, *wpe;
  const float *k2, *b1, *b2, *bpe;
  // per utterance, fp32
  const float *mem, *proc, *emask;
  const float *kp1, *kp2;  // (cs, 1, p) 0/1 keep masks, or null
  // carry (in/out)
  float *h1, *c1, *h2, *c2, *w, *wc, *ctx, *prev;
  int *fin, *len;
  // scratch
  float *a2, *q, *e;
  // outputs
  float *mel, *gate, *align;
  int T, n, p, E, A, D, datt, ks, cs, t0;
  float gate_logit;
};

// Dynamic shared memory of each kernel of the chunk, in bytes, in launch
// order; the one place these sizes are stated (decoder_step_limits reports
// them to Python).
enum { K_PRENET, K_LSTM, K_QUERY, K_ENERGY, K_SOFTMAX_CTX, K_PROJ, N_KERNELS };

static void step_smem(int T, int n, int p, int E, int A, int D, int datt,
                      int ks, size_t out[N_KERNELS]) {
  const int k_lstm = p + E + A > A + E + D ? p + E + A : A + E + D;
  out[K_PRENET] = sizeof(float) * (n + p + PRE_COLS + DEC_THREADS);
  out[K_LSTM] = sizeof(float) * (k_lstm + (ROW_THREADS / 32 + 1) * ROW_COLS);
  out[K_QUERY] = sizeof(float) * (A + DEC_THREADS + 32);
  out[K_ENERGY] = sizeof(float) * ((size_t)ks * 2 * datt + 2 * datt +
                                   2 * (E_TILE + ks - 1) + E_TILE * datt);
  out[K_SOFTMAX_CTX] = sizeof(float) * (T + SM_THREADS + CTX_COLS);
  out[K_PROJ] = sizeof(float) * (D + E + PROJ_COLS + DEC_THREADS);
}

// 0 when the chunk can run these dimensions on the current device; 1 when
// A or D is not a multiple of DEC_UNITS; 2 when ks is even; 3 + i when
// kernel i (the enum above) needs more shared memory than one block may
// opt into, with *need and *have its bytes and the device's; -1 when the
// device cannot be asked.
static int step_limits(int T, int n, int p, int E, int A, int D, int datt,
                       int ks, size_t* need, int* have) {
  if (A % DEC_UNITS || D % DEC_UNITS) return 1;
  if (ks % 2 == 0) return 2;
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(have, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  size_t sm[N_KERNELS];
  step_smem(T, n, p, E, A, D, datt, ks, sm);
  for (int i = 0; i < N_KERNELS; ++i) {
    if (sm[i] > (size_t)*have) {
      *need = sm[i];
      return 3 + i;
    }
  }
  return 0;
}

template <typename W>
static cudaError_t run(const StepChunk& c, cudaStream_t s) {
  size_t sm[N_KERNELS];
  step_smem(c.T, c.n, c.p, c.E, c.A, c.D, c.datt, c.ks, sm);
  cudaError_t err;
#define T2_SMEM(kern, bytes)                                                   \
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             (int)(bytes));                                    \
  if (err != cudaSuccess) return err;
  T2_SMEM(prenet_kernel<W>, sm[K_PRENET]);
  T2_SMEM(lstm_row_kernel<W>, sm[K_LSTM]);
  auto query = query_kernel<W, false>;    // names with a comma, for the macro
  auto energy = energy_kernel<W, float>;
  T2_SMEM(query, sm[K_QUERY]);
  T2_SMEM(energy, sm[K_ENERGY]);
  T2_SMEM(softmax_ctx_kernel<float>, sm[K_SOFTMAX_CTX]);
  T2_SMEM(proj_kernel<W>, sm[K_PROJ]);
#undef T2_SMEM
  const dim3 g_l1(c.A / DEC_UNITS), g_l2(c.D / DEC_UNITS);
  const dim3 g_q((c.datt + 31) / 32), g_e((c.T + E_TILE - 1) / E_TILE);
  const dim3 g_s((c.E + CTX_COLS - 1) / CTX_COLS);
  const dim3 g_p((c.p + PRE_COLS - 1) / PRE_COLS);
  const dim3 g_j((c.n + 1 + PROJ_COLS - 1) / PROJ_COLS);
  for (int st = 0; st < c.cs; ++st) {
    float* h1_in = c.h1 + (size_t)(st % 2) * c.A;
    float* h1_out = c.h1 + (size_t)((st + 1) % 2) * c.A;
    float* h2_in = c.h2 + (size_t)(st % 2) * c.D;
    float* h2_out = c.h2 + (size_t)((st + 1) % 2) * c.D;
    int* fin_in = c.fin + (st % 2);
    int* fin_out = c.fin + ((st + 1) % 2);
    prenet_kernel<W><<<g_p, DEC_THREADS, sm[K_PRENET], s>>>(
        c.prev, (const W*)c.pre1, (const W*)c.pre2, c.kp1, c.kp2, c.a2, st, 1,
        c.n, c.p);
    lstm_row_kernel<W><<<g_l1, ROW_THREADS, sm[K_LSTM], s>>>(
        c.a2, c.p, c.ctx, c.E, h1_in, c.A, (const W*)c.w1, c.b1, c.c1, h1_out,
        c.A);
    query<<<g_q, DEC_THREADS, sm[K_QUERY], s>>>(
        h1_out, (const W*)c.wq, c.q, c.A, c.datt);
    energy<<<g_e, SM_THREADS, sm[K_ENERGY], s>>>(
        c.q, c.w, c.wc, c.k2, (const W*)c.v, c.proc, c.e, c.T, c.datt, c.ks);
    softmax_ctx_kernel<float><<<g_s, SM_THREADS, sm[K_SOFTMAX_CTX], s>>>(
        c.e, c.emask, c.mem, c.w, c.wc, c.ctx, c.align, fin_in, st, 1, c.T,
        c.E);
    lstm_row_kernel<W><<<g_l2, ROW_THREADS, sm[K_LSTM], s>>>(
        h1_out, c.A, c.ctx, c.E, h2_in, c.D, (const W*)c.w2, c.b2, c.c2,
        h2_out, c.D);
    proj_kernel<W><<<g_j, DEC_THREADS, sm[K_PROJ], s>>>(
        h2_out, c.ctx, (const W*)c.wpe, c.bpe, c.mel, c.gate, c.prev, fin_in,
        fin_out, c.len, st, c.t0 + st, c.gate_logit, 1, c.D, c.E, c.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" {

// Runs cs decoder steps of one row. h1 / h2 / fin point at (2, A) / (2, D)
// / (2,) buffers whose slot 0 holds the incoming state; the final state
// lands in slot cs % 2. Every other carry is updated in place. k2, mem,
// proc and emask are fp32. w1f / w2f: the LSTM weights in mma fragment
// order (kernels/lstm_layout.py to_mma_tiles), or null; with them, a bf16
// chunk at the shapes persistent_plan takes runs as one cooperative launch,
// using scratch (decoder_step_scratch bytes), else the per-step launches
// of run<W>. rounds (host memory, PC_NPH ints, or null) gets the persistent
// launch's rounds of items by phase, zeros without one. Returns
// cudaError_t.
int decoder_step_chunk(int bf16, const void* pre1, const void* pre2,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* wq, const void* k2,
                       const void* v, const void* wpe, const void* bpe,
                       const void* w1f, const void* w2f,
                       const void* mem, const void* proc, const void* emask,
                       const void* kp1, const void* kp2, void* h1, void* c1,
                       void* h2, void* c2, void* w, void* wc, void* ctx,
                       void* prev, void* fin, void* len, void* a2, void* q,
                       void* e, void* mel, void* gate, void* align,
                       void* scratch, int T, int n, int p, int E, int A,
                       int D, int datt, int ks, int cs, int t0,
                       float gate_logit, void* stream, int* rounds) {
  if (rounds)
    for (int i = 0; i < PC_NPH; ++i) rounds[i] = 0;
  size_t need;
  int have;
  if (step_limits(T, n, p, E, A, D, datt, ks, &need, &have) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16 && w1f && w2f) {
    Chunk pc{pre1, pre2, w1, w2, wq, k2, v, wpe,
             (const float*)b1, (const float*)b2, (const float*)bpe,
             mem, proc, (const float*)emask, (const float*)kp1,
             (const float*)kp2,
             (float*)h1, (float*)c1, (float*)h2, (float*)c2, (float*)w,
             (float*)wc, (float*)ctx, (float*)prev, (int*)fin, (int*)len,
             (float*)a2, (float*)q, (float*)e,
             (float*)mel, (float*)gate, (float*)align,
             1, T, n, p, E, A, D, datt, ks, cs, t0, gate_logit};
    Persist P{};
    size_t smem = 0;
    const int plan = persistent_plan<float>(pc, &P, &smem, rounds);
    if (plan < 0) return (int)cudaErrorInvalidDevice;
    if (plan == 0) {
      P.w1f = (const uint4*)w1f;
      P.w2f = (const uint4*)w2f;
      return (int)run_persistent<float>(P, smem, scratch, s);
    }
  }
  StepChunk c{pre1, pre2, w1, w2, wq, v, wpe,
              (const float*)k2, (const float*)b1, (const float*)b2,
              (const float*)bpe,
              (const float*)mem, (const float*)proc, (const float*)emask,
              (const float*)kp1, (const float*)kp2,
              (float*)h1, (float*)c1, (float*)h2, (float*)c2, (float*)w,
              (float*)wc, (float*)ctx, (float*)prev, (int*)fin, (int*)len,
              (float*)a2, (float*)q, (float*)e,
              (float*)mel, (float*)gate, (float*)align,
              T, n, p, E, A, D, datt, ks, cs, t0, gate_logit};
  return (int)(bf16 ? run<__nv_bfloat16>(c, s) : run<float>(c, s));
}

// Bytes of scratch decoder_step_chunk takes at these widths. Returns 0.
int decoder_step_scratch(int p, int E, int A, int D, size_t* bytes) {
  *bytes = persistent_scratch(1, p + E + A, A + E + D);
  return 0;
}

// step_limits for Python (kernels/decoder_step.py:kernel_limits).
int decoder_step_limits(int T, int n, int p, int E, int A, int D, int datt,
                        int ks, size_t* need, int* have) {
  return step_limits(T, n, p, E, A, D, datt, ks, need, have);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
