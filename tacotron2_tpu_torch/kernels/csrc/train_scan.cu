// Teacher-forced decoder scan of the training step: the forward over all T
// steps, emitting the residual stacks, and the reverse-time data-gradient
// chain that consumes them.
//
// train_scan_fwd replaces the TPU kernel tacotron2_tpu/kernels/train_scan.py
// _make_kernel (called by _scan_call). Each step t, for every row:
//   attention LSTM  g1 = [prenet_t ; ctx_{t-1} ; h1_{t-1}] @ w1 + b1
//                   -> c1, h1, and h1d = h1 * keep_att * 1/(1-p_att)
//   query           q = h1d @ wq
//   attention       energies, masked softmax -> w_t, w_cum += w_t, ctx_t
//                   (attention.cuh, the kernels of the serving chunk)
//   decoder LSTM    g2 = [h1d ; ctx_t ; h2_{t-1}] @ w2 + b2 -> c2, h2d
// and stores ga, gd, att_h (= h1d), dec_h (= h2d) in the operand type W and
// att_c, dec_c, ctx, w in fp32 -- the eight stacks of decoder_vjp
// _Residuals. Cast points are the TPU kernel's: every product operand
// rounded to W (the LSTM inputs, h1d for q, q itself, w and w_cum, K2, the
// tanh output and v), fp32 sums, fp32 state, an additive -1e30 mask, and
// ctx = sum w(fp32) mem(W). The recurrent h is read back from the h stacks,
// already rounded to W, which is the only form the next step uses.
//
// train_scan_bwd replaces the TPU kernel _make_bwd_kernel (called by
// _bwd_scan_call) in its rematerialising form (no feat stream): per step
// t from T-1 down to 0,
//   decoder LSTM    dh2 = carry + d_dec_h[t] (x keep_dec scale), cell
//                   backward -> dgd[t]; dxd = dgd[t] @ w2^T
//   context         dctx = carry + d_ctx[t] + dxd[:, A:A+E] (fp32)
//                   dw = c_dw + c_dwc + d_align[t] + dctx . mem
//   softmax         de = w_t (dw - sum w_t dw)
//   energies        feat rebuilt from w_{t-1}, w_cum_{t-1} and q (att_h[t]
//                   @ wq) exactly as the forward built it; dm =
//                   W(de) v (1 - feat^2); d_processed += dm in fp32;
//                   d_v += feat W(de); dq = sum_t W(dm); d_K2 and the
//                   window cotangents (next c_dw, c_dwc +=) from W(dm)
//   attention LSTM  dh1 = carry + dxd[:, :A] + W(dq) @ wq^T (x keep_att
//                   scale), cell backward -> dga[t]; dxa = dga[t] @ w1^T
//                   -> d_prenet[t] and the carries.
// The LSTM and attention weight gradients are taken outside from the
// stacks (models/decoder_vjp.py), as the TPU package does.
//
// What bounds it on the H100: at B = 128 each step's LSTM products are real
// GEMMs (128 x 1792 @ 1792 x 4096 and 128 x 2560 @ 2560 x 4096 forward, the
// transposed ones backward, ~4.6 GFLOP per step), so the contract bound is
// operations on the tensor cores; below it lies a floor of bytes that every
// step must touch whatever it keeps: both LSTMs' weights (36 MB in bf16),
// mem and proc read and d_processed read and written (~38 MB at T_in 128).
//
// Forward design: five launches per step from a host loop inside the C
// entry point. At bf16 (the training path, shapes in fwd_tc_ok) the two
// LSTM products run on the tensor cores with the cell in their epilogue
// (scan_cell_kernel: one bf16 mma.sync product over all rows, a block owning
// all of them, so each weight element is read once a step), the query is
// one tc_product, and the energies are rebuilt as an im2col bf16 mma
// product (fwd_energy_kernel, the backward's attn_tiles_kernel arithmetic);
// the softmax and context stay the serving chunk's kernel (see the
// "forward, bf16" section). At fp32 (the step check) and at bf16 shapes
// outside that range, the first design stays: scan_lstm_kernel (blocks own
// TS_UNITS hidden units and all four gate columns x 8 rows, weights
// block-major, products on CUDA cores in fp32), the query, the serving
// chunk's energy and softmax/context kernels, scan_lstm_kernel.
//
// Backward design. At bf16 (the training path) the chain runs on the
// tensor cores, six launches a step (see the "backward, bf16" section):
// the two transposed LSTM products as one bf16 mma.sync product over all
// rows, the weights read once a step and K split into slices so that the
// column tiles fill the SMs (tc_product.cuh); the attention backward cut
// along T_in into (32 positions x 2 rows) blocks whose location products
// (the energy rebuild, d_K2 and the window cotangents) are bf16 mma.sync
// products; dh1's W(dq) @ wq^T one product over all rows with the cell
// backward in its epilogue. At fp32 (the step check), and at bf16 shapes
// the tensor-core kernels do not take (tc_shapes_ok), the first design
// stays: lstm_gates_bwd_kernel, tile_product_kernel (CUDA cores),
// attn_bwd_kernel (one block per row, T_in <= ~368 by its shared memory),
// the second product and the fixed-order sums of the rows' d_K2 and d_v.
// Every accumulator is deterministic: no floating-point atomics; an element
// of d_processed belongs to one thread at every step; the products' K
// slices, the tiles' partials of dq and the window cotangents, and the
// blocks' d_K2 and d_v are added in a fixed order, so two runs give the
// same bits.
#include <math.h>

#include "attention.cuh"
#include "lstm_cell.cuh"
#include "tc_product.cuh"

#define TS_UNITS 8        // hidden units per scan_lstm_kernel block
#define TS_THREADS 1024   // scan_lstm_kernel and scan_query_kernel blocks
#define AB_THREADS 512    // attn_bwd_kernel blocks

// ------------------------------------------------------------- forward

// LSTM cell of one step over the input [s0 ; s1 ; s2] (s0 and s2 in W, s1
// fp32 rounded to W; a null s1 or s2 reads as zeros, the t = 0 state), with
// the output dropout. Stores the gates (W), c (fp32) and the dropped-out h
// (W) of the step.
template <typename W>
__global__ void __launch_bounds__(TS_THREADS)
scan_lstm_kernel(const W* __restrict__ s0, int L0,
                 const float* __restrict__ s1, int L1,
                 const W* __restrict__ s2, int L2, const W* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ c_prev,
                 const unsigned char* __restrict__ keep, float scale,
                 W* __restrict__ g_out, float* __restrict__ c_out,
                 W* __restrict__ h_out, int B, int H) {
  constexpr int COLS = 4 * TS_UNITS;
  constexpr int KSPLIT = TS_THREADS / COLS;
  extern __shared__ float smem[];
  const int K = L0 + L1 + L2;
  const int u0 = blockIdx.x * TS_UNITS;
  const int b0 = blockIdx.y * T2_BT;
  float* xs = smem;
  float* red = xs + T2_BT * K;
  float* gsm = red + KSPLIT * T2_BT * COLS;
  for (int k = threadIdx.x; k < K; k += TS_THREADS) {
    float v[T2_BT];
#pragma unroll
    for (int b = 0; b < T2_BT; ++b) {
      const size_t row = b0 + b;
      float x = 0.0f;
      if (b0 + b < B) {
        if (k < L0)
          x = to_f<W>(s0[row * L0 + k]);
        else if (k < L0 + L1)
          x = s1 ? rnd<W>(s1[row * L1 + (k - L0)]) : 0.0f;
        else
          x = s2 ? to_f<W>(s2[row * L2 + (k - L0 - L1)]) : 0.0f;
      }
      v[b] = x;
    }
#pragma unroll
    for (int b = 0; b < T2_BT; ++b) xs[k * T2_BT + b] = v[b];
  }
  __syncthreads();
  gate_product<W, TS_UNITS, TS_THREADS>(
      xs, K, w + (size_t)blockIdx.x * K * COLS, red, gsm);
  for (int i = threadIdx.x; i < T2_BT * TS_UNITS; i += TS_THREADS) {
    const int b = i / TS_UNITS, u = i % TS_UNITS, row = b0 + b;
    if (row >= B) continue;
    const int unit = u0 + u;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[q] = gsm[b * COLS + q * TS_UNITS + u] + bias[q * H + unit];
    const size_t idx = (size_t)row * H + unit;
    const float cp = c_prev ? c_prev[idx] : 0.0f;
    const float cn = sigmoid_f(g[1]) * cp + sigmoid_f(g[0]) * tanhf(g[2]);
    float hn = sigmoid_f(g[3]) * tanhf(cn);
    if (keep) hn = hn * (keep[idx] ? scale : 0.0f);
    W* go = g_out + (size_t)row * 4 * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) go[q * H + unit] = from_f<W>(g[q]);
    c_out[idx] = cn;
    h_out[idx] = from_f<W>(hn);
  }
}

// q (B, D) = h (W) @ wq, rounded to W; 32 query columns of one row per block.
template <typename W>
__global__ void __launch_bounds__(TS_THREADS)
scan_query_kernel(const W* __restrict__ h, const W* __restrict__ wq,
                  float* __restrict__ q, int A, int D) {
  extern __shared__ float sm[];
  float* hs = sm;                  // A
  float* red = hs + A;             // TS_THREADS
  float* out = red + TS_THREADS;   // 32
  const int row = blockIdx.y, c0 = blockIdx.x * 32;
  const int ncols = min(32, D - c0);
  for (int i = threadIdx.x; i < A; i += TS_THREADS)
    hs[i] = to_f<W>(h[(size_t)row * A + i]);
  __syncthreads();
  block_matvec<W, TS_THREADS, 32>(hs, A, wq, D, c0, ncols, red, out);
  if (threadIdx.x < ncols)
    q[(size_t)row * D + c0 + threadIdx.x] = rnd<W>(out[threadIdx.x]);
}

struct Fwd {
  const void *w1, *w2, *wq, *wqc, *k2, *v;  // W; wqc wq column-tiled
  const float *b1, *b2;
  const void *prenet, *mem, *proc;    // W: (T, B, P), (B, Ti, E), (B, Ti, datt)
  const float* emask;                 // (B, Ti) additive
  const unsigned char *keep_a, *keep_d;  // (T, B, A), (T, B, D) or null
  float s_att, s_dec;
  void *ga, *gd, *atth, *dech;        // W stacks
  float *attc, *decc, *ctx, *wst;     // fp32 stacks
  float *q, *e, *w, *wc;              // scratch; w, wc zeroed by the caller
  int* fin;                           // (B,) zeros
  int B, T, Ti, P, E, A, D, datt, ks;
};

static size_t energy_smem(int datt, int ks) {
  return sizeof(float) * ((size_t)ks * 2 * datt + 2 * datt +
                          2 * (E_TILE + ks - 1) + E_TILE * datt);
}

template <typename W>
static cudaError_t run_fwd(const Fwd& f, cudaStream_t s) {
  const int K1 = f.P + f.E + f.A, K2 = f.A + f.E + f.D;
  const size_t sm_lstm = gate_product_smem<TS_UNITS, TS_THREADS>(K1 > K2 ? K1 : K2);
  const size_t sm_q = sizeof(float) * (f.A + TS_THREADS + 32);
  const size_t sm_e = energy_smem(f.datt, f.ks);
  const size_t sm_s = sizeof(float) * (f.Ti + SM_THREADS + CTX_COLS);
  cudaError_t err;
#define T2_SMEM(kern, bytes)                                                   \
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             (int)(bytes));                                    \
  if (err != cudaSuccess) return err;
  T2_SMEM(scan_lstm_kernel<W>, sm_lstm);
  T2_SMEM(scan_query_kernel<W>, sm_q);
  T2_SMEM(energy_kernel<W>, sm_e);
  T2_SMEM(softmax_ctx_kernel<W>, sm_s);
#undef T2_SMEM
  const int rows8 = (f.B + T2_BT - 1) / T2_BT;
  const dim3 g_l1(f.A / TS_UNITS, rows8), g_l2(f.D / TS_UNITS, rows8);
  const dim3 g_q((f.datt + 31) / 32, f.B);
  const dim3 g_e((f.Ti + E_TILE - 1) / E_TILE, f.B);
  const dim3 g_s((f.E + CTX_COLS - 1) / CTX_COLS, f.B);
  const size_t B = f.B;
  const W* pre = (const W*)f.prenet;
  W *ga = (W*)f.ga, *gd = (W*)f.gd, *atth = (W*)f.atth, *dech = (W*)f.dech;
  for (int t = 0; t < f.T; ++t) {
    const size_t ta = t * B * f.A, td = t * B * f.D, te = t * B * f.E;
    const size_t pa = ta - B * f.A, pd = td - B * f.D, pe = te - B * f.E;
    scan_lstm_kernel<W><<<g_l1, TS_THREADS, sm_lstm, s>>>(
        pre + t * B * f.P, f.P, t ? f.ctx + pe : nullptr, f.E,
        t ? atth + pa : nullptr, f.A, (const W*)f.w1, f.b1,
        t ? f.attc + pa : nullptr, f.keep_a ? f.keep_a + ta : nullptr,
        f.s_att, ga + 4 * ta, f.attc + ta, atth + ta, f.B, f.A);
    scan_query_kernel<W><<<g_q, TS_THREADS, sm_q, s>>>(
        atth + ta, (const W*)f.wq, f.q, f.A, f.datt);
    energy_kernel<W><<<g_e, SM_THREADS, sm_e, s>>>(
        f.q, f.w, f.wc, (const W*)f.k2, (const W*)f.v, (const W*)f.proc, f.e,
        f.Ti, f.datt, f.ks);
    softmax_ctx_kernel<W><<<g_s, SM_THREADS, sm_s, s>>>(
        f.e, f.emask, (const W*)f.mem, f.w, f.wc, f.ctx + te, f.wst, f.fin, t,
        f.B, f.Ti, f.E);
    scan_lstm_kernel<W><<<g_l2, TS_THREADS, sm_lstm, s>>>(
        atth + ta, f.A, f.ctx + te, f.E, t ? dech + pd : nullptr, f.D,
        (const W*)f.w2, f.b2, t ? f.decc + pd : nullptr,
        f.keep_d ? f.keep_d + td : nullptr, f.s_dec, gd + 4 * td,
        f.decc + td, dech + td, f.B, f.D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ------------------------------------------------------------ backward

// Sum of v over the NT threads of a block; every thread gets the result.
template <int NT>
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < NT / 32 ? red[lane] : 0.0f;
    r = warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// Pointers of attn_bwd_kernel at one step (row b's slices are taken inside).
template <typename W>
struct AttnBwd {
  const float* dxd;       // (B, A+E+D) this step's decoder-LSTM product
  const float* dxa_prev;  // (B, P+E+A) the later step's attention product,
                          //   or null at the chain's start
  const float* dctx_out;  // (B, E) cotangent of ctx_t from outside
  const float* dalign;    // (B, Ti) cotangent of w_t from outside
  const W* mem;           // (B, Ti, E)
  const W* proc;          // (B, Ti, datt)
  const W* atth;          // (B, A) att_h[t]
  const W* wq;            // (A, datt)
  const W* wqt;           // wq^T (datt, A), column-tiled
  const W* k2;            // (ks, 2, datt)
  const float* vf;        // (datt,) fp32 v
  const float* w_t;       // (B, Ti) w[t]
  const float* w_prev;    // (B, Ti) w[t-1], or null at t = 0
  const float* wc_prev;   // (B, Ti) w_cum before step t, or null at t = 0
  const W* ga;            // (B, 4A) attention-LSTM gates of step t
  const float* c_new;     // (B, A) att_c[t]
  const float* c_prev;    // (B, A) att_c[t-1], or null at t = 0
  const unsigned char* keep;  // (B, A) keep mask of step t, or null
  float scale;
  float *c_dw, *c_dwc, *dac;  // carries (B, Ti), (B, Ti), (B, A)
  W* dctx_st;             // out (B, E): dctx of step t, rounded to W
  float* dq_st;           // out (B, datt)
  W* dga_st;              // out (B, 4A)
  float* dproc;           // (B, Ti, datt) fp32 accumulator
  float* k2_part;         // (B, ks, 2, datt) this step's d_K2 of each row
  float* dv_part;         // (B, datt) this step's d_v of each row
  int Ti, P, E, A, D, datt, ks;
};

static size_t attn_bwd_smem(int Ti, int E, int datt, int ks) {
  return sizeof(float) * ((size_t)E + Ti + 2 * datt + 2 * (Ti + ks - 1) +
                          (size_t)ks * 2 * datt + (size_t)Ti * datt +
                          2 * AB_THREADS);
}

// One block per row: the context, softmax, energy and attention-LSTM
// backward of step t for that row (see the header). Needs
// AB_THREADS % datt == 0.
template <typename W>
__global__ void __launch_bounds__(AB_THREADS) attn_bwd_kernel(AttnBwd<W> a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int T = a.Ti, E = a.E, datt = a.datt, ks = a.ks, A = a.A;
  const int pad = (ks - 1) / 2, wl = T + ks - 1;
  float* dct = sm;                       // E: dctx, fp32
  float* dwt = dct + E;                  // T: dw, then de
  float* qs = dwt + T;                   // datt
  float* dqs = qs + datt;                // datt
  float* win0 = dqs + datt;              // wl: W(w_{t-1}) window
  float* win1 = win0 + wl;               // wl: W(w_cum_{t-1}) window
  float* k2s = win1 + wl;                // ks * 2 * datt
  float* dms = k2s + ks * 2 * datt;      // T * datt: W(dm)
  float* red = dms + (size_t)T * datt;   // AB_THREADS
  float* red2 = red + AB_THREADS;        // AB_THREADS
  const size_t rT = (size_t)b * T;
  const float* dxd = a.dxd + (size_t)b * (A + E + a.D);
  const float* dxa = a.dxa_prev ? a.dxa_prev + (size_t)b * (a.P + E + A)
                                : nullptr;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NW = AB_THREADS / 32;
  const int parts = AB_THREADS / datt;

  // context cotangent: carry + d_ctx[t] + the decoder LSTM's
  for (int e = tid; e < E; e += AB_THREADS) {
    float v = dxa ? dxa[a.P + e] : 0.0f;
    v = v + a.dctx_out[(size_t)b * E + e];
    v = v + dxd[A + e];
    dct[e] = v;
    a.dctx_st[(size_t)b * E + e] = from_f<W>(v);
  }
  for (int i = tid; i < ks * 2 * datt; i += AB_THREADS) k2s[i] = to_f<W>(a.k2[i]);
  for (int j = tid; j < wl; j += AB_THREADS) {
    const int pos = j - pad;
    const bool in = pos >= 0 && pos < T;
    win0[j] = in && a.w_prev ? rnd<W>(a.w_prev[rT + pos]) : 0.0f;
    win1[j] = in && a.wc_prev ? rnd<W>(a.wc_prev[rT + pos]) : 0.0f;
  }
  __syncthreads();
  // dw = c_dw + c_dwc + d_align + dctx . mem[t]: a warp per position
  for (int t = warp; t < T; t += NW) {
    const W* m = a.mem + (rT + t) * E;
    float s = 0.0f;
    for (int e = lane; e < E; e += 32) s = fmaf(dct[e], to_f<W>(m[e]), s);
    s = warp_sum(s);
    if (lane == 0)
      dwt[t] = a.c_dw[rT + t] + a.c_dwc[rT + t] + a.dalign[rT + t] + s;
  }
  __syncthreads();
  // softmax backward
  float part = 0.0f;
  for (int t = tid; t < T; t += AB_THREADS) part += a.w_t[rT + t] * dwt[t];
  const float ssum = block_sum<AB_THREADS>(part, red);
  for (int t = tid; t < T; t += AB_THREADS)
    dwt[t] = a.w_t[rT + t] * (dwt[t] - ssum);
  // q = W(att_h[t] @ wq), as the forward's query
  const int d = tid % datt, pg = tid / datt;
  {
    float acc = 0.0f;
    for (int k = pg; k < A; k += parts)
      acc = fmaf(to_f<W>(a.atth[(size_t)b * A + k]),
                 to_f<W>(a.wq[(size_t)k * datt + d]), acc);
    red[tid] = acc;
  }
  __syncthreads();
  if (tid < datt) {
    float q = 0.0f;
    for (int j = 0; j < parts; ++j) q += red[j * datt + tid];
    qs[tid] = rnd<W>(q);
  }
  __syncthreads();
  // energies backward, feat rebuilt with the forward's energy_kernel
  // arithmetic; thread (pg, d) owns d_processed[b, t, d] for t = pg mod parts
  {
    const float vd = a.vf[d];
    float dq = 0.0f, dv = 0.0f;
    for (int t = pg; t < T; t += parts) {
      float m = qs[d];
      for (int k = 0; k < ks; ++k) {
        m = fmaf(k2s[(2 * k) * datt + d], win0[t + k], m);
        m = fmaf(k2s[(2 * k + 1) * datt + d], win1[t + k], m);
      }
      const size_t o = (rT + t) * datt + d;
      const float f = tanhf(m + to_f<W>(a.proc[o]));
      const float de = rnd<W>(dwt[t]);
      const float dm = de * vd * (1.0f - f * f);
      dv += f * de;
#ifdef SCAN_DPROC_BF16  // the known-bad probe build (kernels/gate_probe.py)
      a.dproc[o] = rnd<__nv_bfloat16>(a.dproc[o] + dm);
#else
      a.dproc[o] += dm;
#endif
      const float dmc = rnd<W>(dm);
      dms[t * datt + d] = dmc;
      dq += dmc;
    }
    red[tid] = dq;
    red2[tid] = dv;
  }
  __syncthreads();
  if (tid < datt) {
    float q = 0.0f, v = 0.0f;
    for (int j = 0; j < parts; ++j) {
      q += red[j * datt + tid];
      v += red2[j * datt + tid];
    }
    dqs[tid] = q;
    a.dq_st[(size_t)b * datt + tid] = q;
    a.dv_part[(size_t)b * datt + tid] = v;
  }
  // this row's d_K2: sum_t W([w ; w_cum]_{t-1})[c, t+k-pad] * W(dm)[t, d],
  // the taps as the forward's energy_kernel reads them
  for (int kc = 0; kc < 2 * ks; ++kc) {
    const float* win = (kc & 1) ? win1 : win0;
    const int k = kc >> 1;
    float acc = 0.0f;
    for (int t = pg; t < T; t += parts)
      acc = fmaf(win[t + k], dms[t * datt + d], acc);
    __syncthreads();
    red[tid] = acc;
    __syncthreads();
    if (tid < datt) {
      float v = 0.0f;
      for (int j = 0; j < parts; ++j) v += red[j * datt + tid];
      a.k2_part[((size_t)b * 2 * ks + kc) * datt + tid] = v;
    }
  }
  __syncthreads();
  // window cotangents: the next c_dw, and c_dwc += (a warp per position)
  for (int j = warp; j < T; j += NW) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int k = 0; k < ks; ++k) {
      const int t = j - k + pad;
      if (t < 0 || t >= T) continue;
      const float* dmr = dms + (size_t)t * datt;
      for (int dd = lane; dd < datt; dd += 32) {
        s0 = fmaf(k2s[(2 * k) * datt + dd], dmr[dd], s0);
        s1 = fmaf(k2s[(2 * k + 1) * datt + dd], dmr[dd], s1);
      }
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      a.c_dw[rT + j] = s0;
      a.c_dwc[rT + j] += s1;
    }
  }
  // attention LSTM backward, one thread per unit
  const W* ga = a.ga + (size_t)b * 4 * A;
  W* dga = a.dga_st + (size_t)b * 4 * A;
  for (int u = tid; u < A; u += AB_THREADS) {
    float attn = 0.0f;
    for (int dd = 0; dd < datt; ++dd)
      attn = fmaf(rnd<W>(dqs[dd]),
                  to_f<W>(a.wqt[((size_t)(u >> 5) * datt + dd) * 32 + (u & 31)]),
                  attn);
    float dh = dxa ? dxa[a.P + E + u] : 0.0f;
    dh = dh + dxd[u];
    dh = dh + attn;
    const size_t idx = (size_t)b * A + u;
    if (a.keep) dh = dh * (a.keep[idx] ? a.scale : 0.0f);
    float dg[4];
    a.dac[idx] = lstm_unit_bwd(to_f<W>(ga[u]), to_f<W>(ga[A + u]),
                               to_f<W>(ga[2 * A + u]), to_f<W>(ga[3 * A + u]),
                               a.c_prev ? a.c_prev[idx] : 0.0f, a.c_new[idx],
                               dh, a.dac[idx], dg);
#pragma unroll
    for (int q = 0; q < 4; ++q) dga[q * A + u] = from_f<W>(dg[q]);
  }
}

// acc[i] += sum_p part[p][i], p in order: a fixed-order, run-to-run
// identical reduction of per-block partials.
__global__ void accumulate_parts(const float* __restrict__ part, int nparts,
                                 int n, float* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < nparts; ++p) s += part[(size_t)p * n + i];
  acc[i] += s;
}

// ------------------------------------------- backward, bf16: tensor cores
//
// The chain of W = __nv_bfloat16, per step (six launches, no atomics):
//   bwd_gates_kernel    decoder-LSTM cell backward -> dgd[t]
//   tc_product          dxd = dgd[t] @ w2^T in K slices, added in slice
//                       order by the last block of each tile (tc_product.cuh)
//   attn_rows_kernel    per row: dctx, the window cotangents of the later
//                       step (summed from its tiles' partials), dw, the
//                       softmax sum -> de
//   attn_tiles_kernel   per (32 positions, AB_RB rows): the energies
//                       rebuilt as an im2col product, dm, d_processed,
//                       the partials of dq, d_v and d_K2 and the window
//                       cotangents' partials; three bf16 mma products
//   attn_lstm_kernel    dh1 = carry + dxd[:, :A] + W(dq) @ wq^T as one
//                       tensor-core product over all rows, then the
//                       attention-LSTM cell backward -> dga[t]
//   tc_product          dxa = dga[t] @ w1^T in K slices; its first P
//                       columns go straight to d_prenet[t]
// and, once, the query of every step (att_h @ wq) before the loop and the
// fixed-order sums of the d_K2 and d_v partials after it.

#define AB_TT 32      // encoder positions per attn_tiles_kernel block
#define AB_RB 2       // rows per attn_tiles_kernel block
#define AB_KC 64      // 2 * ks taps, padded: the im2col depth
#define AB_DMAX 128   // widest attention the tiles kernel takes
#define ROW_THREADS 512
#define TILE_THREADS 256
#define LSTM_ROWS 32  // rows per attn_lstm_kernel block
#define LSTM_COLS 32  // units per attn_lstm_kernel block
#define LSTM_THREADS 128

typedef __nv_bfloat16 bf16;

struct TcChain {
  int sd, sa;      // K slices of the two products
  int nt, nrg;     // position tiles, row groups of attn_tiles_kernel
  int wl;          // window partial length, AB_TT + 2 pad
  float *dxd_p, *dxa_p, *dxd, *dxa, *q, *de, *c_dwc, *wpart, *dq, *dac,
      *ddc, *k2acc, *dvacc;
  int* count;      // the products' tile counters
};

// Carve the bf16 chain's scratch (floats) from `base` (null: count only);
// returns the number of floats.
static size_t carve_tc(TcChain* c, float* base, int sms, int B, int T,
                       int Ti, int P, int E, int A, int D, int datt, int ks) {
  const int NO_D = A + E + D, NO_A = P + E + A;
  c->sd = tc_slices(B, NO_D, 4 * D, sms);
  c->sa = tc_slices(B, NO_A, 4 * A, sms);
  c->nt = (Ti + AB_TT - 1) / AB_TT;
  c->nrg = (B + AB_RB - 1) / AB_RB;
  c->wl = AB_TT + ks - 1;
  const size_t nblk = (size_t)c->nt * c->nrg;
  const size_t ncount = tc_tiles(B, NO_D) + tc_tiles(B, NO_A);
  const size_t sizes[] = {
      (size_t)c->sd * B * NO_D, (size_t)c->sa * B * NO_A, (size_t)B * NO_D,
      (size_t)B * NO_A, (size_t)T * B * datt, (size_t)B * Ti,
      (size_t)B * Ti, (size_t)B * c->nt * 2 * c->wl,
      (size_t)B * c->nt * datt, (size_t)B * A, (size_t)B * D,
      nblk * 2 * ks * datt, nblk * datt, ncount};
  float** ptrs[] = {&c->dxd_p, &c->dxa_p, &c->dxd, &c->dxa, &c->q, &c->de,
                    &c->c_dwc, &c->wpart, &c->dq, &c->dac, &c->ddc,
                    &c->k2acc, &c->dvacc, (float**)&c->count};
  size_t off = 0;
  for (int i = 0; i < 14; ++i) {
    *ptrs[i] = base ? base + off : nullptr;
    off += (sizes[i] + 3) / 4 * 4;   // 16-byte aligned pieces
  }
  return off;
}

struct GatesTc {
  const bf16* g;            // gd[t]
  const float *c_new, *c_prev;
  const float* dh_in;       // d_dec_h[t]
  const unsigned char* keep;
  float scale;
  float* dc;
  bf16* dg;                 // dgd[t]
  const float* dxd;         // the later step's dxd, or null at the start
  int B, D, A, E;
};

// Decoder-LSTM gate backward of step t, one thread per (row, unit).
__global__ void bwd_gates_kernel(GatesTc a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int NO_D = a.A + a.E + a.D;
  if (i < a.B * a.D) {
    const int b = i / a.D, u = i % a.D;
    float dh = 0.0f;
    if (a.dxd) dh = a.dxd[(size_t)b * NO_D + a.A + a.E + u];
    dh += a.dh_in[i];
    if (a.keep) dh = dh * (a.keep[i] ? a.scale : 0.0f);
    const bf16* g = a.g + (size_t)b * 4 * a.D;
    float dg[4];
    a.dc[i] = lstm_unit_bwd(to_f<bf16>(g[u]), to_f<bf16>(g[a.D + u]),
                            to_f<bf16>(g[2 * a.D + u]),
                            to_f<bf16>(g[3 * a.D + u]),
                            a.c_prev ? a.c_prev[i] : 0.0f, a.c_new[i], dh,
                            a.dc[i], dg);
    bf16* o = a.dg + (size_t)b * 4 * a.D;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q * a.D + u] = from_f<bf16>(dg[q]);
  }
}

struct RowsTc {
  const float *dxd, *dxa;   // this step's dxd, the later step's dxa (null
                            //   at the start)
  const float* dctx_o;      // (B, E) d_ctx[t]
  const float* dalign;      // (B, Ti) d_align[t]
  const bf16* mem;          // (B, Ti, E)
  const float* w_t;         // (B, Ti) w[t]
  const float* wpart;       // later step's window partials, or null
  float* c_dwc;             // (B, Ti) carry
  float* de;                // (B, Ti) out
  bf16* dctx_st;            // (B, E) out: dctx[t] rounded
  int B, Ti, P, E, A, D, nt, wl, pad;
};

// Per row: the context cotangent, dw and the softmax backward (stage a).
__global__ void __launch_bounds__(ROW_THREADS) attn_rows_kernel(RowsTc a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NW = ROW_THREADS / 32;
  const int NO_D = a.A + a.E + a.D, NO_A = a.P + a.E + a.A;
  float* dct = sm;            // E
  float* dws = dct + a.E;     // Ti
  float* red = dws + a.Ti;    // 32
  const size_t rT = (size_t)b * a.Ti;
  for (int e = tid; e < a.E; e += ROW_THREADS) {
    float v = a.dxa ? a.dxa[(size_t)b * NO_A + a.P + e] : 0.0f;
    v = v + a.dctx_o[(size_t)b * a.E + e];
    v = v + a.dxd[(size_t)b * NO_D + a.A + e];
    dct[e] = v;
    a.dctx_st[(size_t)b * a.E + e] = from_f<bf16>(v);
  }
  // the later step's window cotangents, summed over its tiles in order
  for (int j = tid; j < a.Ti; j += ROW_THREADS) {
    float cdw = 0.0f, add = 0.0f;
    if (a.wpart) {
      for (int ti = 0; ti < a.nt; ++ti) {
        const int jl = j - (ti * AB_TT - a.pad);
        if (jl < 0 || jl >= a.wl) continue;
        const float* wp = a.wpart + ((size_t)b * a.nt + ti) * 2 * a.wl;
        cdw += wp[jl];
        add += wp[a.wl + jl];
      }
    }
    const float cdwc = a.c_dwc[rT + j] + add;
    a.c_dwc[rT + j] = cdwc;
    dws[j] = cdw + cdwc + a.dalign[rT + j];
  }
  __syncthreads();
  // + dctx . mem[t]: a warp per 4 positions at a time, 8 bf16 a load
  for (int j0 = 4 * warp; j0 < a.Ti; j0 += 4 * NW) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = 8 * lane; e < a.E; e += 256) {
      uint4 raw[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        raw[p] = j0 + p < a.Ti ? *reinterpret_cast<const uint4*>(
                                     a.mem + (rT + j0 + p) * a.E + e)
                               : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw[p]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 mv = __bfloat1622float2(h[q]);
          s[p] = fmaf(dct[e + 2 * q], mv.x, s[p]);
          s[p] = fmaf(dct[e + 2 * q + 1], mv.y, s[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float v = warp_sum(s[p]);
      if (lane == 0 && j0 + p < a.Ti) dws[j0 + p] = dws[j0 + p] + v;
    }
  }
  __syncthreads();
  float part = 0.0f;
  for (int j = tid; j < a.Ti; j += ROW_THREADS) part += a.w_t[rT + j] * dws[j];
  const float ssum = block_sum<ROW_THREADS>(part, red);
  for (int j = tid; j < a.Ti; j += ROW_THREADS)
    a.de[rT + j] = a.w_t[rT + j] * (dws[j] - ssum);
}

struct TilesTc {
  const float* q;           // (B, datt) fp32 sums of att_h[t] @ wq
  const float* de;          // (B, Ti)
  const float *w_prev, *wc_prev;   // (B, Ti), or null at t = 0
  const bf16* k2;           // (ks, 2, datt)
  const float* vf;          // (datt,)
  const bf16* proc;         // (B, Ti, datt)
  float* dproc;             // (B, Ti, datt) fp32 accumulator
  float* wpart;             // (B, nt, 2, wl) out
  float* dq;                // (B, nt, datt) out
  float *k2acc, *dvacc;     // per block, accumulated over the steps
  int B, Ti, datt, ks, nt, wl;
};

#define K2_LD (AB_DMAX + 8)   // bf16 rows of the K2 and dm tiles
#define WIN_LD (AB_KC + 8)    // bf16 rows of the window tile
#define G_LD (AB_KC + 4)      // fp32 rows of G

struct TilesSmem {
  bf16 k2[AB_KC * K2_LD];     // K2 as [2k + c][d], zero rows past 2 ks
  bf16 win[AB_TT * WIN_LD];   // im2col windows [t][2k + c]
  bf16 dm[AB_TT * K2_LD];     // W(dm) [t][d]
  float g[AB_TT * G_LD];      // G = W(dm) @ K2^T [t][2k + c]
  float fde[AB_TT * AB_DMAX]; // feat * W(de)
  float qs[AB_DMAX], vf[AB_DMAX], de[AB_TT];
};

// Stage b: the position-wise attention backward of AB_TT positions of
// AB_RB rows. Needs datt % 64 == 0, datt <= AB_DMAX and 2 ks <= AB_KC.
__global__ void __launch_bounds__(TILE_THREADS, 2)
attn_tiles_kernel(TilesTc a) {
  extern __shared__ __align__(16) unsigned char tiles_raw[];
  TilesSmem& s = *reinterpret_cast<TilesSmem*>(tiles_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const int ti = blockIdx.x, t0 = ti * AB_TT, rg = blockIdx.y;
  const int datt = a.datt, nkc = 2 * a.ks, pad = (a.ks - 1) / 2;
  {  // K2 as [2k + c][d]: 8 bf16 a load, every load before any store
    constexpr int NV = AB_KC * AB_DMAX / 8 / TILE_THREADS;
    const int row8 = datt / 8;
    uint4 v[NV];
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * TILE_THREADS, kc = i / row8;
      v[it] = kc < nkc ? reinterpret_cast<const uint4*>(a.k2)[i]
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * TILE_THREADS, kc = i / row8;
      if (kc < AB_KC)
        *reinterpret_cast<uint4*>(&s.k2[kc * K2_LD + (i % row8) * 8]) = v[it];
    }
  }
  for (int d = tid; d < datt; d += TILE_THREADS) s.vf[d] = a.vf[d];
  // d_K2 += win^T @ dm: warp (km, dn) owns taps km*16.. and columns
  // dn * datt/2 .. (nj2 n8 tiles)
  const int km = warp >> 1, dn = warp & 1, nj2 = datt / 16;
  float acc2[AB_DMAX / 16][4];
#pragma unroll
  for (int j = 0; j < AB_DMAX / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[j][e] = 0.0f;
  float dv = 0.0f;   // thread tid's column of d_v
  const int wm = warp >> 2, wn = warp & 3;   // energy and G: 2 x 4 warps
  const int nj = datt / 32;                  // energy n8 tiles a warp
  for (int r = 0; r < AB_RB; ++r) {
    const int b = rg * AB_RB + r;
    if (b >= a.B) break;
    const size_t rT = (size_t)b * a.Ti;
    __syncthreads();
    for (int d = tid; d < datt; d += TILE_THREADS)
      s.qs[d] = rnd<bf16>(a.q[(size_t)b * datt + d]);
    for (int i = tid; i < AB_TT; i += TILE_THREADS)
      s.de[i] = t0 + i < a.Ti ? rnd<bf16>(a.de[rT + t0 + i]) : 0.0f;
    {
      constexpr int NW8 = AB_TT * AB_KC / TILE_THREADS;
      float v[NW8];
#pragma unroll
      for (int it = 0; it < NW8; ++it) {
        const int i = tid + it * TILE_THREADS, tl = i / AB_KC, kc = i % AB_KC;
        const int pos = t0 + tl + (kc >> 1) - pad;
        const float* src = (kc & 1) ? a.wc_prev : a.w_prev;
        const bool in = kc < nkc && pos >= 0 && pos < a.Ti && src;
        v[it] = in ? src[rT + pos] : 0.0f;
      }
#pragma unroll
      for (int it = 0; it < NW8; ++it) {
        const int i = tid + it * TILE_THREADS;
        s.win[(i / AB_KC) * WIN_LD + i % AB_KC] = from_f<bf16>(v[it]);
      }
    }
    __syncthreads();
    // energies: loc = win (AB_TT x AB_KC) @ K2 (AB_KC x datt)
    float acc[AB_DMAX / 32][4];
#pragma unroll
    for (int j = 0; j < AB_DMAX / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    const int c0 = wn * (datt / 4);
#pragma unroll
    for (int k16 = 0; k16 < AB_KC; k16 += 16) {
      uint32_t fa[4];
      ldmatrix_x4(fa, &s.win[(wm * 16 + r8 + (mi & 1) * 8) * WIN_LD + k16 +
                             (mi >> 1) * 8]);
#pragma unroll
      for (int jj = 0; jj < AB_DMAX / 64; ++jj) {
        if (2 * jj >= nj) break;
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, &s.k2[(k16 + r8 + (mi & 1) * 8) * K2_LD + c0 +
                                    jj * 16 + (mi >> 1) * 8]);
        mma_bf16(acc[2 * jj], fa, fb);
        mma_bf16(acc[2 * jj + 1], fa, fb + 2);
      }
    }
    // feat, dm, d_processed; W(dm) and feat * W(de) to shared memory.
    // proc and d_processed are loaded for all of the thread's elements
    // before any store, so that the loads overlap
    float pv[AB_DMAX / 32][4], dp[AB_DMAX / 32][4];
#pragma unroll
    for (int j = 0; j < AB_DMAX / 32; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + wm * 16 + g + (e >> 1) * 8;
        const size_t o = (rT + t) * datt + c0 + j * 8 + 2 * t4 + (e & 1);
        pv[j][e] = t < a.Ti ? to_f<bf16>(a.proc[o]) : 0.0f;
        dp[j][e] = t < a.Ti ? a.dproc[o] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < AB_DMAX / 32; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = wm * 16 + g + (e >> 1) * 8;
        const int d = c0 + j * 8 + 2 * t4 + (e & 1);
        const int t = t0 + tl;
        float dmc = 0.0f, fde = 0.0f;
        if (t < a.Ti) {
          const size_t o = (rT + t) * datt + d;
          const float m = s.qs[d] + acc[j][e];
          const float f = tanhf(m + pv[j][e]);
          const float der = s.de[tl];
          const float dm = der * s.vf[d] * (1.0f - f * f);
#ifdef SCAN_DPROC_BF16  // the known-bad probe build (kernels/gate_probe.py)
          a.dproc[o] = rnd<bf16>(dp[j][e] + dm);
#else
          a.dproc[o] = dp[j][e] + dm;
#endif
          dmc = rnd<bf16>(dm);
          fde = f * der;
        }
        s.dm[tl * K2_LD + d] = from_f<bf16>(dmc);
        s.fde[tl * AB_DMAX + d] = fde;
      }
    }
    __syncthreads();
    for (int d = tid; d < datt; d += TILE_THREADS) {
      float q = 0.0f, v = 0.0f;
      for (int tl = 0; tl < AB_TT; ++tl) {
        q += to_f<bf16>(s.dm[tl * K2_LD + d]);
        v += s.fde[tl * AB_DMAX + d];
      }
      a.dq[((size_t)b * a.nt + ti) * datt + d] = q;
      dv += v;
    }
    // d_K2 partial: win^T (AB_KC x AB_TT) @ W(dm) (AB_TT x datt)
#pragma unroll
    for (int k16 = 0; k16 < AB_TT; k16 += 16) {
      uint32_t fa[4];
      ldmatrix_x4_trans(fa, &s.win[(k16 + r8 + (mi >> 1) * 8) * WIN_LD +
                                   km * 16 + (mi & 1) * 8]);
#pragma unroll
      for (int jj = 0; jj < AB_DMAX / 32; ++jj) {
        if (2 * jj >= nj2) break;
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, &s.dm[(k16 + r8 + (mi & 1) * 8) * K2_LD +
                                    dn * (datt / 2) + jj * 16 +
                                    (mi >> 1) * 8]);
        mma_bf16(acc2[2 * jj], fa, fb);
        mma_bf16(acc2[2 * jj + 1], fa, fb + 2);
      }
    }
    // G = W(dm) (AB_TT x datt) @ K2^T (datt x AB_KC): warp (wm, wn) owns
    // rows wm*16.. and taps wn*16..
    {
      float gacc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      for (int k16 = 0; k16 < datt; k16 += 16) {
        uint32_t fa[4], fb[4];
        ldmatrix_x4(fa, &s.dm[(wm * 16 + r8 + (mi & 1) * 8) * K2_LD + k16 +
                              (mi >> 1) * 8]);
        ldmatrix_x4(fb, &s.k2[(wn * 16 + r8 + (mi >> 1) * 8) * K2_LD + k16 +
                              (mi & 1) * 8]);
        mma_bf16(gacc[0], fa, fb);
        mma_bf16(gacc[1], fa, fb + 2);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s.g[(wm * 16 + g + (e >> 1) * 8) * G_LD + wn * 16 + j * 8 + 2 * t4 +
              (e & 1)] = gacc[j][e];
    }
    __syncthreads();
    // window cotangents of this tile: dwin_c[j] = sum_k G[j - k + pad][2k + c]
    for (int i = tid; i < 2 * a.wl; i += TILE_THREADS) {
      const int c = i / a.wl, jl = i % a.wl;
      float v = 0.0f;
      for (int k = 0; k < a.ks; ++k) {
        const int tl = jl - k;
        if (tl >= 0 && tl < AB_TT) v += s.g[tl * G_LD + 2 * k + c];
      }
      a.wpart[(((size_t)b * a.nt + ti) * 2 + c) * a.wl + jl] = v;
    }
  }
  // this block's d_K2 and d_v, accumulated over the steps in its own slot
  // (every old value loaded before any store, so that the loads overlap)
  const size_t blk = (size_t)rg * a.nt + ti;
  float old[AB_DMAX / 16][4];
#pragma unroll
  for (int j = 0; j < AB_DMAX / 16; ++j) {
    if (j >= nj2) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = km * 16 + g + (e >> 1) * 8;
      const int d = dn * (datt / 2) + j * 8 + 2 * t4 + (e & 1);
      old[j][e] = kc < nkc ? a.k2acc[(blk * nkc + kc) * datt + d] : 0.0f;
    }
  }
  const float dv_old = tid < datt ? a.dvacc[blk * datt + tid] : 0.0f;
#pragma unroll
  for (int j = 0; j < AB_DMAX / 16; ++j) {
    if (j >= nj2) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = km * 16 + g + (e >> 1) * 8;
      const int d = dn * (datt / 2) + j * 8 + 2 * t4 + (e & 1);
      if (kc < nkc) a.k2acc[(blk * nkc + kc) * datt + d] = old[j][e] + acc2[j][e];
    }
  }
  if (tid < datt) a.dvacc[blk * datt + tid] = dv_old + dv;
}

struct LstmTc {
  const float* dq_part;     // (B, nt, datt)
  float* dq_st;             // (B, datt) out: dq[t]
  const bf16* wqt;          // wq^T column-tiled (A / 32, datt, 32)
  const float *dxd, *dxa;   // this step's dxd, the later step's dxa (null
                            //   at the start)
  const bf16* ga;           // (B, 4A) ga[t]
  const float *c_new, *c_prev;
  const unsigned char* keep;
  float scale;
  float* dac;
  bf16* dga;                // (B, 4A) out
  int B, P, E, A, D, datt, nt;
};

struct LstmSmem {
  bf16 x[LSTM_ROWS * (AB_DMAX + 8)];     // W(dq) [row][d]
  bf16 w[AB_DMAX * (LSTM_COLS + 8)];     // wq^T [d][unit]
  float attn[LSTM_ROWS * (LSTM_COLS + 1)];
};

// Stage d: dh1 = carry + dxd[:, :A] + W(dq) @ wq^T for LSTM_ROWS rows and
// LSTM_COLS units (4 warps, 16 rows x 16 units each), then the
// attention-LSTM cell backward, a thread per (row, unit) along the units,
// every load made before any store so that they overlap.
__global__ void __launch_bounds__(LSTM_THREADS) attn_lstm_kernel(LstmTc a) {
  extern __shared__ __align__(16) unsigned char lstm_raw[];
  LstmSmem& s = *reinterpret_cast<LstmSmem*>(lstm_raw);
  constexpr int XLD = AB_DMAX + 8, WLD = LSTM_COLS + 8, ALD = LSTM_COLS + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const int b0 = blockIdx.y * LSTM_ROWS, u0 = blockIdx.x * LSTM_COLS;
  const int datt = a.datt;
  const int NO_D = a.A + a.E + a.D, NO_A = a.P + a.E + a.A;
  {  // dq of the block's rows: the tiles' partials, 4 columns a load
    constexpr int NQ = LSTM_ROWS * AB_DMAX / 4 / LSTM_THREADS;
    const int row4 = datt / 4;
    float4 v[NQ];
#pragma unroll
    for (int it = 0; it < NQ; ++it) v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ti = 0; ti < a.nt; ++ti) {
      float4 p[NQ];
#pragma unroll
      for (int it = 0; it < NQ; ++it) {
        const int i = tid + it * LSTM_THREADS, r = i / row4, b = b0 + r;
        p[it] = r < LSTM_ROWS && b < a.B
                    ? reinterpret_cast<const float4*>(
                          a.dq_part + ((size_t)b * a.nt + ti) * datt)[i % row4]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int it = 0; it < NQ; ++it) {
        v[it].x += p[it].x, v[it].y += p[it].y;
        v[it].z += p[it].z, v[it].w += p[it].w;
      }
    }
#pragma unroll
    for (int it = 0; it < NQ; ++it) {
      const int i = tid + it * LSTM_THREADS, r = i / row4, b = b0 + r;
      if (r >= LSTM_ROWS) continue;
      const int d = (i % row4) * 4;
      if (blockIdx.x == 0 && b < a.B)
        *reinterpret_cast<float4*>(a.dq_st + (size_t)b * datt + d) = v[it];
      bf16* x = &s.x[r * XLD + d];
      x[0] = from_f<bf16>(v[it].x), x[1] = from_f<bf16>(v[it].y);
      x[2] = from_f<bf16>(v[it].z), x[3] = from_f<bf16>(v[it].w);
    }
  }
  {  // the block's units are one 32-column tile of wq^T: 8 bf16 a load
    constexpr int NW = AB_DMAX * LSTM_COLS / 8 / LSTM_THREADS;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.wqt + (size_t)(u0 / 32) * datt * 32);
    uint4 v[NW];
#pragma unroll
    for (int it = 0; it < NW; ++it) {
      const int i = tid + it * LSTM_THREADS;
      v[it] = i < datt * 4 ? src[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < NW; ++it) {
      const int i = tid + it * LSTM_THREADS;
      if (i < datt * 4)
        *reinterpret_cast<uint4*>(&s.w[(i / 4) * WLD + (i % 4) * 8]) = v[it];
    }
  }
  __syncthreads();
  {
    const int wm = warp >> 1, wn = warp & 1;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int k16 = 0; k16 < datt; k16 += 16) {
      uint32_t fa[4], fb[4];
      ldmatrix_x4(fa, &s.x[(wm * 16 + r8 + (mi & 1) * 8) * XLD + k16 +
                           (mi >> 1) * 8]);
      ldmatrix_x4_trans(fb, &s.w[(k16 + r8 + (mi & 1) * 8) * WLD + wn * 16 +
                                 (mi >> 1) * 8]);
      mma_bf16(acc[0], fa, fb);
      mma_bf16(acc[1], fa, fb + 2);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s.attn[(wm * 16 + g + (e >> 1) * 8) * ALD + wn * 16 + j * 8 + 2 * t4 +
               (e & 1)] = acc[j][e];
  }
  __syncthreads();
  constexpr int PER = LSTM_ROWS * LSTM_COLS / LSTM_THREADS;
  float dh[PER], gv[PER][4], cp[PER], cn[PER], dc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * LSTM_THREADS;
    const int b = b0 + i / LSTM_COLS, u = u0 + i % LSTM_COLS;
    if (b >= a.B || u >= a.A) continue;
    const size_t idx = (size_t)b * a.A + u;
    dh[k] = a.dxa ? a.dxa[(size_t)b * NO_A + a.P + a.E + u] : 0.0f;
    dh[k] = dh[k] + a.dxd[(size_t)b * NO_D + u];
    const bf16* ga = a.ga + (size_t)b * 4 * a.A + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) gv[k][q] = to_f<bf16>(ga[q * a.A]);
    cp[k] = a.c_prev ? a.c_prev[idx] : 0.0f;
    cn[k] = a.c_new[idx];
    dc[k] = a.dac[idx];
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * LSTM_THREADS;
    const int r = i / LSTM_COLS, c = i % LSTM_COLS;
    const int b = b0 + r, u = u0 + c;
    if (b >= a.B || u >= a.A) continue;
    const size_t idx = (size_t)b * a.A + u;
    float d = dh[k] + s.attn[r * ALD + c];
    if (a.keep) d = d * (a.keep[idx] ? a.scale : 0.0f);
    float dg[4];
    a.dac[idx] = lstm_unit_bwd(gv[k][0], gv[k][1], gv[k][2], gv[k][3], cp[k],
                               cn[k], d, dc[k], dg);
    bf16* o = a.dga + (size_t)b * 4 * a.A + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q * a.A] = from_f<bf16>(dg[q]);
  }
}

// After the loop: the blocks' d_K2 and d_v partials in block order.
__global__ void bwd_finish_kernel(const float* __restrict__ k2acc,
                                  const float* __restrict__ dvacc, int nblk,
                                  float* __restrict__ dk2,
                                  float* __restrict__ dvo, int nk2, int datt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nk2) {
    float v = 0.0f;
    for (int k = 0; k < nblk; ++k) v += k2acc[(size_t)k * nk2 + i];
    dk2[i] += v;
  }
  if (i < datt) {
    float v = 0.0f;
    for (int k = 0; k < nblk; ++k) v += dvacc[(size_t)k * datt + i];
    dvo[i] += v;
  }
}

struct Bwd {
  const void *wta, *wtd, *wq, *wqc, *wqt, *k2;  // W; wta/wtd/wqc/wqt column-tiled
  const float* vf;
  const void *mem, *proc, *ga, *gd, *atth;  // W
  const float *attc, *decc, *wst, *wcp;     // fp32 stacks
  const float *ddh, *dctx_o, *dalign;       // cotangent stacks
  const unsigned char *keep_a, *keep_d;
  float s_att, s_dec;
  void *dga, *dgd, *dctx;                   // W out stacks
  float *dpre, *dq, *dproc, *dk2, *dv;      // fp32 outs (dproc, dk2, dv zeroed)
  int B, T, Ti, P, E, A, D, datt, ks;
};

// The CUDA-core chain's scratch: (dxd, dxa, ddc, dac, c_dw, c_dwc, dv_part,
// k2_part); returns the number of floats.
static size_t carve_cc(float** p, float* base, int B, int Ti, int P, int E,
                       int A, int D, int datt, int ks) {
  const size_t sizes[] = {(size_t)B * (A + E + D), (size_t)B * (P + E + A),
                          (size_t)B * D, (size_t)B * A, (size_t)B * Ti,
                          (size_t)B * Ti, (size_t)B * datt,
                          (size_t)B * 2 * ks * datt};
  size_t off = 0;
  for (int i = 0; i < 8; ++i) {
    p[i] = base ? base + off : nullptr;
    off += (sizes[i] + 3) / 4 * 4;
  }
  return off;
}

// The CUDA-core chain: the kernels of the first design.
template <typename W>
static cudaError_t run_bwd_cc(const Bwd& r, float* scratch, cudaStream_t s) {
  const int NO_D = r.A + r.E + r.D, NO_A = r.P + r.E + r.A;
  const int KD = 4 * r.D, KA = 4 * r.A;
  float* sc[8];
  carve_cc(sc, scratch, r.B, r.Ti, r.P, r.E, r.A, r.D, r.datt, r.ks);
  float *dxd = sc[0], *dxa = sc[1], *ddc = sc[2], *dac = sc[3];
  float *c_dw = sc[4], *c_dwc = sc[5], *dv_part = sc[6], *k2_part = sc[7];
  cudaError_t err = tile_product_prepare<W>(KD > KA ? KD : KA);
  if (err != cudaSuccess) return err;
  const size_t sm_ab = attn_bwd_smem(r.Ti, r.E, r.datt, r.ks);
  err = cudaFuncSetAttribute(attn_bwd_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm_ab);
  if (err != cudaSuccess) return err;
  const size_t B = r.B;
  const int rows8 = (r.B + T2_BT - 1) / T2_BT;
  const int nk2 = r.ks * 2 * r.datt;
  const dim3 g_gates((r.B * r.D + 255) / 256, 1);
  const dim3 g_pd((NO_D + TP_COLS - 1) / TP_COLS, rows8, 1);
  const dim3 g_pa((NO_A + TP_COLS - 1) / TP_COLS, rows8, 1);
  const W *wta = (const W*)r.wta, *wtd = (const W*)r.wtd;
  const W *ga = (const W*)r.ga, *gd = (const W*)r.gd, *atth = (const W*)r.atth;
  W *dga = (W*)r.dga, *dgd = (W*)r.dgd, *dctx = (W*)r.dctx;
  for (int t = r.T - 1; t >= 0; --t) {
    const bool start = t == r.T - 1;
    const size_t ta = t * B * r.A, td = t * B * r.D, te = t * B * r.E;
    const size_t tw = t * B * r.Ti;
    GatesBwd<W> dec{gd + 4 * td, r.decc + td,
                    t ? r.decc + td - B * r.D : nullptr,
                    start ? nullptr : dxd + r.A + r.E, NO_D, r.ddh + td,
                    r.keep_d ? r.keep_d + td : nullptr, r.s_dec, ddc,
                    dgd + 4 * td};
    lstm_gates_bwd_kernel<W><<<g_gates, 256, 0, s>>>(dec, dec, r.B, r.D);
    tile_product_kernel<W><<<g_pd, TP_THREADS, tile_product_smem(KD), s>>>(
        dgd + 4 * td, wtd, dxd, dgd + 4 * td, wtd, dxd, r.B, KD, NO_D);
    AttnBwd<W> ab{dxd, start ? nullptr : dxa, r.dctx_o + te,
                  r.dalign + tw, (const W*)r.mem, (const W*)r.proc,
                  atth + ta, (const W*)r.wq, (const W*)r.wqt, (const W*)r.k2,
                  r.vf, r.wst + tw, t ? r.wst + tw - B * r.Ti : nullptr,
                  t ? r.wcp + tw : nullptr, ga + 4 * ta, r.attc + ta,
                  t ? r.attc + ta - B * r.A : nullptr,
                  r.keep_a ? r.keep_a + ta : nullptr, r.s_att, c_dw,
                  c_dwc, dac, dctx + te, r.dq + t * B * r.datt,
                  dga + 4 * ta, r.dproc, k2_part, dv_part, r.Ti, r.P, r.E,
                  r.A, r.D, r.datt, r.ks};
    attn_bwd_kernel<W><<<r.B, AB_THREADS, sm_ab, s>>>(ab);
    tile_product_kernel<W><<<g_pa, TP_THREADS, tile_product_smem(KA), s>>>(
        dga + 4 * ta, wta, dxa, dga + 4 * ta, wta, dxa, r.B, KA, NO_A);
    accumulate_parts<<<(nk2 + 255) / 256, 256, 0, s>>>(k2_part, r.B, nk2,
                                                       r.dk2);
    accumulate_parts<<<(r.datt + 255) / 256, 256, 0, s>>>(dv_part, r.B,
                                                          r.datt, r.dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaMemcpy2DAsync(r.dpre + t * B * r.P, r.P * sizeof(float), dxa,
                            NO_A * sizeof(float), r.P * sizeof(float), r.B,
                            cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

static int device_sms() {
  int dev, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The bf16 chain on the tensor cores (see the section's header).
static cudaError_t run_bwd_tc(const Bwd& r, float* scratch, int sms,
                              cudaStream_t s) {
  TcChain c;
  carve_tc(&c, scratch, sms, r.B, r.T, r.Ti, r.P, r.E, r.A, r.D, r.datt,
           r.ks);
  const int NO_D = r.A + r.E + r.D, NO_A = r.P + r.E + r.A;
  const size_t sm_rows = sizeof(float) * ((size_t)r.E + r.Ti + 32);
  cudaError_t err = tc_product_prepare();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm_rows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_tiles_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(TilesSmem));
  if (err != cudaSuccess) return err;
  const size_t B = r.B;
  const bf16 *ga = (const bf16*)r.ga, *gd = (const bf16*)r.gd;
  const bf16* atth = (const bf16*)r.atth;
  bf16 *dga = (bf16*)r.dga, *dgd = (bf16*)r.dgd, *dctx = (bf16*)r.dctx;
  // the query of every step, q = att_h[t] @ wq, in one product
  err = tc_product(atth, r.A, r.T * r.B, r.A, (const bf16*)r.wqc, r.datt, 1,
                   TcOut{c.q, nullptr, nullptr, nullptr, 0, 0}, s);
  if (err != cudaSuccess) return err;
  int* cnt_d = c.count;
  int* cnt_a = c.count + tc_tiles(r.B, NO_D);
  const int g_gates = (r.B * r.D + 255) / 256;
  const dim3 g_tiles(c.nt, c.nrg);
  const dim3 g_lstm((r.A + LSTM_COLS - 1) / LSTM_COLS,
                    (r.B + LSTM_ROWS - 1) / LSTM_ROWS);
  for (int t = r.T - 1; t >= 0; --t) {
    const bool start = t == r.T - 1;
    const size_t ta = t * B * r.A, td = t * B * r.D, te = t * B * r.E;
    const size_t tw = t * B * r.Ti;
    GatesTc gt{gd + 4 * td, r.decc + td, t ? r.decc + td - B * r.D : nullptr,
               r.ddh + td, r.keep_d ? r.keep_d + td : nullptr, r.s_dec,
               c.ddc, dgd + 4 * td, start ? nullptr : c.dxd, r.B, r.D, r.A,
               r.E};
    bwd_gates_kernel<<<g_gates, 256, 0, s>>>(gt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = tc_product(dgd + 4 * td, 4 * r.D, r.B, 4 * r.D, (const bf16*)r.wtd,
                     NO_D, c.sd, TcOut{c.dxd, c.dxd_p, cnt_d, nullptr, 0, 0},
                     s);
    if (err != cudaSuccess) return err;
    RowsTc rt{c.dxd, start ? nullptr : c.dxa, r.dctx_o + te, r.dalign + tw,
              (const bf16*)r.mem, r.wst + tw, start ? nullptr : c.wpart,
              c.c_dwc, c.de, dctx + te, r.B, r.Ti, r.P, r.E, r.A, r.D, c.nt,
              c.wl, (r.ks - 1) / 2};
    attn_rows_kernel<<<r.B, ROW_THREADS, sm_rows, s>>>(rt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    TilesTc tt{c.q + t * B * r.datt, c.de, t ? r.wst + tw - B * r.Ti : nullptr,
               t ? r.wcp + tw : nullptr, (const bf16*)r.k2, r.vf,
               (const bf16*)r.proc, r.dproc, c.wpart, c.dq, c.k2acc, c.dvacc,
               r.B, r.Ti, r.datt, r.ks, c.nt, c.wl};
    attn_tiles_kernel<<<g_tiles, TILE_THREADS, sizeof(TilesSmem), s>>>(tt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    LstmTc lt{c.dq, r.dq + t * B * r.datt, (const bf16*)r.wqt, c.dxd,
              start ? nullptr : c.dxa, ga + 4 * ta, r.attc + ta,
              t ? r.attc + ta - B * r.A : nullptr,
              r.keep_a ? r.keep_a + ta : nullptr, r.s_att, c.dac,
              dga + 4 * ta, r.B, r.P, r.E, r.A, r.D, r.datt, c.nt};
    attn_lstm_kernel<<<g_lstm, LSTM_THREADS, sizeof(LstmSmem), s>>>(lt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = tc_product(dga + 4 * ta, 4 * r.A, r.B, 4 * r.A, (const bf16*)r.wta,
                     NO_A, c.sa,
                     TcOut{c.dxa, c.dxa_p, cnt_a, r.dpre + t * B * r.P, r.P,
                           r.P}, s);
    if (err != cudaSuccess) return err;
  }
  const int nk2 = 2 * r.ks * r.datt;
  bwd_finish_kernel<<<(nk2 + 255) / 256, 256, 0, s>>>(
      c.k2acc, c.dvacc, c.nt * c.nrg, r.dk2, r.dv, nk2, r.datt);
  return cudaGetLastError();
}

// ------------------------------------------- forward, bf16: tensor cores
//
// The forward of W = __nv_bfloat16 at the shapes fwd_tc_ok takes, per step
// (five launches, as the first design):
//   scan_cell_kernel    g1 = [prenet_t ; ctx_{t-1} ; h1_{t-1}] @ w1 as one
//                       bf16 mma.sync product over all rows (tc_product's
//                       ring, warp tiles and K slices), the attention-LSTM
//                       cell in the epilogue -> ga, att_c, att_h
//   tc_product          q = att_h[t] @ wq, fp32 sums (rounded to W where
//                       the energies read it)
//   fwd_energy_kernel   per (32 positions, FE_RB rows): the location term
//                       as an im2col bf16 mma product of [w ; w_cum] windows
//                       and K2, then e = W(tanh(q + loc + proc)) . v
//   softmax_ctx_kernel  the serving chunk's (attention.cuh)
//   scan_cell_kernel    g2 = [att_h[t] ; ctx_t ; h2_{t-1}] @ w2, the
//                       decoder-LSTM cell in the epilogue -> gd, dec_c,
//                       dec_h
// The LSTM weights are the block-major slabs of 8 units (w1, w2 of
// ScanWeights): as column tiles of 32 they are what tc_product reads, and
// in a warp's 32-column tile of the m16n8 accumulators n8 tile j is gate j,
// so each thread holds all four gates of its units 2 t4 and 2 t4 + 1 of
// rows g and g + 8: the cell runs on registers. Where K is split into
// slices, the tile's last block adds them in slice order (an integer
// counter, no floating-point atomics) and then runs the cell.

#define FE_RB 4   // rows per fwd_energy_kernel block

// One LSTM's input rows [s0 ; s1 ; s2]: s0 and s2 in W, s1 fp32 rounded to
// W on the way into shared memory; a null s1 or s2 reads as zeros (the t = 0
// state). Widths are multiples of 8, so a 16-byte piece has one source.
struct ScanSrc {
  const bf16* s0;
  const float* s1;
  const bf16* s2;
  int L0, L1, L2;
};

// Where the cell's results go: gates (M, 4H) W, c (M, H) fp32, the
// dropped-out h (M, H) W.
struct ScanCell {
  const float* bias;          // (4H,) fp32
  const float* c_prev;        // (M, H), or null at t = 0
  const unsigned char* keep;  // (M, H) keep mask, or null
  float scale;
  bf16* g_out;
  float* c_out;
  bf16* h_out;
  int H;
};

// The X rows m0 .. m0 + TC_MT of chunk k0 into ring slot `slot`.
__device__ __forceinline__ void scan_load_x(TcSmem& s, int slot,
                                            const ScanSrc& x, int M, int m0,
                                            int k0) {
  for (int i = threadIdx.x; i < TC_MT * 4; i += TC_THREADS) {
    const int r = i >> 2, k = k0 + (i & 3) * 8, m = m0 + r;
    bf16* dst = &s.x[slot][r * TC_XLD + (i & 3) * 8];
    if (k >= x.L0 && k < x.L0 + x.L1) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M && x.s1) {
        const float4* src = reinterpret_cast<const float4*>(
            x.s1 + (size_t)m * x.L1 + (k - x.L0));
        const float4 a = src[0], b = src[1];
        __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y),
                               __floats2bfloat162_rn(a.z, a.w),
                               __floats2bfloat162_rn(b.x, b.y),
                               __floats2bfloat162_rn(b.z, b.w)};
        v = *reinterpret_cast<const uint4*>(h);
      }
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bool first = k < x.L0;
      const bf16* src = first ? x.s0 : x.s2;
      const int ld = first ? x.L0 : x.L2;
      const int kk = first ? k : k - x.L0 - x.L1;
      const bool in = m < M && src != nullptr;
      cp_async16(dst, in ? (const void*)(src + (size_t)m * ld + kk)
                         : (const void*)x.s0, in ? 16 : 0);
    }
  }
}

// g = X @ w (w block-major at 8 units: column tiles of 32, N = 4H columns)
// and the LSTM cell of every (row, unit) of the block's tile. grid
// (ceil(N / TC_NT), ceil(M / TC_MT), nslice), TC_THREADS threads,
// sizeof(TcSmem) bytes of dynamic shared memory; with nslice > 1, part
// (nslice, M, N) and one zeroed counter per block tile (left zeroed).
__global__ void __launch_bounds__(TC_THREADS)
scan_cell_kernel(ScanSrc x, int M, int K, const bf16* __restrict__ w, int N,
                 float* __restrict__ part, int* count, ScanCell c) {
  extern __shared__ __align__(16) unsigned char tc_raw[];
  TcSmem& s = *reinterpret_cast<TcSmem*>(tc_raw);
  const int m0 = blockIdx.y * TC_MT, n0 = blockIdx.x * TC_NT;
  const int ntiles32 = N / 32, tile0 = n0 / 32;
  const int nch = K / TC_KC, z = blockIdx.z, nz = gridDim.z;
  const int c0 = z * nch / nz, c1 = (z + 1) * nch / nz;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const bool busy = m0 + wm * 32 < M && tile0 + wn < ntiles32;
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
    if (st < n) {
      scan_load_x(s, st, x, M, m0, (c0 + st) * TC_KC);
      tc_load_w(s, st, w, K, ntiles32, tile0, (c0 + st) * TC_KC);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    const int next = i + TC_STAGES - 1;
    if (next < n) {
      scan_load_x(s, next % TC_STAGES, x, M, m0, (c0 + next) * TC_KC);
      tc_load_w(s, next % TC_STAGES, w, K, ntiles32, tile0,
                (c0 + next) * TC_KC);
    }
    cp_async_commit();
    if (busy) tc_chunk_mma(s, i % TC_STAGES, acc);
  }
  cp_async_wait<0>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  if (nz > 1) {
    // every block stores its slice; the tile's last block adds them
    float* dst = part + (size_t)z * M * N;
    if (busy) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * 32 + i * 16 + g + h * 8;
            const int nn = n0 + wn * 32 + j * 8 + 2 * t4;
            if (m < M)
              __stcg(reinterpret_cast<float2*>(dst + (size_t)m * N + nn),
                     make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]));
          }
    }
    __shared__ int last;
    __threadfence();
    __syncthreads();
    int* cnt = count + blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == nz - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (threadIdx.x == 0) *cnt = 0;
    if (!busy) return;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    for (int zz = 0; zz < nz; ++zz) {
      const float* src = part + (size_t)zz * M * N;
      float2 p[2][4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * 32 + i * 16 + g + h * 8;
            const int nn = n0 + wn * 32 + j * 8 + 2 * t4;
            p[i][j][h] = m < M ? __ldcg(reinterpret_cast<const float2*>(
                                     src + (size_t)m * N + nn))
                               : make_float2(0.0f, 0.0f);
          }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[i][j][2 * h] += p[i][j][h].x;
            acc[i][j][2 * h + 1] += p[i][j][h].y;
          }
    }
  }
  if (!busy) return;
  // the cell: acc[i][q][2 h + u] is gate q of unit 8 tile + 2 t4 + u, row
  // m0 + 32 wm + 16 i + g + 8 h
  const int H = c.H, tile = tile0 + wn;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int unit = tile * 8 + 2 * t4 + u;
        float gq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gq[q] = acc[i][q][2 * h + u] + c.bias[q * H + unit];
        const size_t idx = (size_t)m * H + unit;
        const float cp = c.c_prev ? c.c_prev[idx] : 0.0f;
        const float cn = sigmoid_f(gq[1]) * cp + sigmoid_f(gq[0]) * tanhf(gq[2]);
        float hn = sigmoid_f(gq[3]) * tanhf(cn);
        if (c.keep) hn = hn * (c.keep[idx] ? c.scale : 0.0f);
        bf16* go = c.g_out + (size_t)m * 4 * H;
#pragma unroll
        for (int q = 0; q < 4; ++q) go[q * H + unit] = from_f<bf16>(gq[q]);
        c.c_out[idx] = cn;
        c.h_out[idx] = from_f<bf16>(hn);
      }
    }
}

struct EnergyTc {
  const float* q;            // (B, datt) fp32 sums of att_h[t] @ wq
  const float *w, *wc;       // (B, Ti) w_{t-1}, w_cum_{t-1}
  const bf16* k2;            // (ks, 2, datt)
  const bf16* v;             // (datt,)
  const bf16* proc;          // (B, Ti, datt)
  float* e;                  // (B, Ti) out
  int B, Ti, datt, ks;
};

struct EnergySmem {
  bf16 k2[AB_KC * K2_LD];     // K2 as [2k + c][d], zero rows past 2 ks
  bf16 win[AB_TT * WIN_LD];   // im2col windows [t][2k + c]
  float qs[AB_DMAX], vf[AB_DMAX];
  float red[4][AB_TT];
};

// Energies of AB_TT positions of FE_RB rows: loc = win (AB_TT x AB_KC) @ K2
// (AB_KC x datt) on bf16 mma.sync (2 x 4 warps, 16 positions x datt / 4
// columns each), then e[t] = sum_d W(tanh(q + loc + proc)) v[d], the four
// column warps' sums added in order. The cast points of energy_kernel.
// Needs datt % 64 == 0, datt <= AB_DMAX and 2 ks <= AB_KC.
__global__ void __launch_bounds__(TILE_THREADS, 2)
fwd_energy_kernel(EnergyTc a) {
  extern __shared__ __align__(16) unsigned char fe_raw[];
  EnergySmem& s = *reinterpret_cast<EnergySmem*>(fe_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, r8 = lane & 7, mi = lane >> 3;
  const int t0 = blockIdx.x * AB_TT;
  const int datt = a.datt, nkc = 2 * a.ks, pad = (a.ks - 1) / 2;
  {  // K2 as [2k + c][d]: 8 bf16 a load, every load before any store
    constexpr int NV = AB_KC * AB_DMAX / 8 / TILE_THREADS;
    const int row8 = datt / 8;
    uint4 v[NV];
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * TILE_THREADS, kc = i / row8;
      v[it] = kc < nkc ? reinterpret_cast<const uint4*>(a.k2)[i]
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * TILE_THREADS, kc = i / row8;
      if (kc < AB_KC)
        *reinterpret_cast<uint4*>(&s.k2[kc * K2_LD + (i % row8) * 8]) = v[it];
    }
  }
  for (int d = tid; d < datt; d += TILE_THREADS) s.vf[d] = to_f<bf16>(a.v[d]);
  const int wm = warp >> 2, wn = warp & 3, nj = datt / 32;
  const int c0 = wn * (datt / 4);
  for (int r = 0; r < FE_RB; ++r) {
    const int b = blockIdx.y * FE_RB + r;
    if (b >= a.B) break;
    const size_t rT = (size_t)b * a.Ti;
    __syncthreads();
    for (int d = tid; d < datt; d += TILE_THREADS)
      s.qs[d] = rnd<bf16>(a.q[(size_t)b * datt + d]);
    {
      constexpr int NW8 = AB_TT * AB_KC / TILE_THREADS;
      float v[NW8];
#pragma unroll
      for (int it = 0; it < NW8; ++it) {
        const int i = tid + it * TILE_THREADS, tl = i / AB_KC, kc = i % AB_KC;
        const int pos = t0 + tl + (kc >> 1) - pad;
        const float* src = (kc & 1) ? a.wc : a.w;
        const bool in = kc < nkc && pos >= 0 && pos < a.Ti;
        v[it] = in ? src[rT + pos] : 0.0f;
      }
#pragma unroll
      for (int it = 0; it < NW8; ++it) {
        const int i = tid + it * TILE_THREADS;
        s.win[(i / AB_KC) * WIN_LD + i % AB_KC] = from_f<bf16>(v[it]);
      }
    }
    __syncthreads();
    float acc[AB_DMAX / 32][4];
#pragma unroll
    for (int j = 0; j < AB_DMAX / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int k16 = 0; k16 < AB_KC; k16 += 16) {
      uint32_t fa[4];
      ldmatrix_x4(fa, &s.win[(wm * 16 + r8 + (mi & 1) * 8) * WIN_LD + k16 +
                             (mi >> 1) * 8]);
#pragma unroll
      for (int jj = 0; jj < AB_DMAX / 64; ++jj) {
        if (2 * jj >= nj) break;
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, &s.k2[(k16 + r8 + (mi & 1) * 8) * K2_LD + c0 +
                                    jj * 16 + (mi >> 1) * 8]);
        mma_bf16(acc[2 * jj], fa, fb);
        mma_bf16(acc[2 * jj + 1], fa, fb + 2);
      }
    }
    // proc for all of the thread's elements first, so that the loads overlap
    float pv[AB_DMAX / 32][4];
#pragma unroll
    for (int j = 0; j < AB_DMAX / 32; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + wm * 16 + g + (e >> 1) * 8;
        const int d = c0 + j * 8 + 2 * t4 + (e & 1);
        pv[j][e] = t < a.Ti ? to_f<bf16>(a.proc[(rT + t) * datt + d]) : 0.0f;
      }
    }
    float part[2] = {0.0f, 0.0f};   // positions g and g + 8 of the warp
#pragma unroll
    for (int j = 0; j < AB_DMAX / 32; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c0 + j * 8 + 2 * t4 + (e & 1);
        const float f = tanhf(s.qs[d] + acc[j][e] + pv[j][e]);
        part[e >> 1] = fmaf(rnd<bf16>(f), s.vf[d], part[e >> 1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
    }
    if (t4 == 0) {
      s.red[wn][wm * 16 + g] = part[0];
      s.red[wn][wm * 16 + g + 8] = part[1];
    }
    __syncthreads();
    if (tid < AB_TT && t0 + tid < a.Ti)
      a.e[rT + t0 + tid] =
          ((s.red[0][tid] + s.red[1][tid]) + s.red[2][tid]) + s.red[3][tid];
  }
}

// Shapes the tensor-core forward takes: LSTM widths in whole 32-column
// tiles, every input width in 16-byte pieces and each LSTM's depth in whole
// K chunks, and the attention width and taps fwd_energy_kernel takes.
// Other bf16 shapes, and fp32, take run_fwd (CUDA cores).
static bool fwd_tc_ok(int P, int E, int A, int D, int datt, int ks) {
  return A % 32 == 0 && D % 32 == 0 && P % 8 == 0 && E % 8 == 0 &&
         (P + E + A) % TC_KC == 0 && (A + E + D) % TC_KC == 0 &&
         datt % 64 == 0 && datt <= AB_DMAX && 2 * ks <= AB_KC;
}

struct FwdTc {
  int za, zd, zq;            // K slices of the three products
  float *part_a, *part_d, *part_q;
  int *cnt_a, *cnt_d, *cnt_q;
};

// Carve the tensor-core forward's scratch (floats) from `base` (null: count
// only); returns the number of floats.
static size_t carve_fwd(FwdTc* c, float* base, int sms, int B, int P, int E,
                        int A, int D, int datt) {
  c->za = tc_slices(B, 4 * A, P + E + A, sms);
  c->zd = tc_slices(B, 4 * D, A + E + D, sms);
  c->zq = tc_slices(B, datt, A, sms);
  const size_t sizes[] = {(size_t)c->za * B * 4 * A, (size_t)c->zd * B * 4 * D,
                          (size_t)c->zq * B * datt,
                          (size_t)tc_tiles(B, 4 * A), (size_t)tc_tiles(B, 4 * D),
                          (size_t)tc_tiles(B, datt)};
  float** ptrs[] = {&c->part_a, &c->part_d, &c->part_q, (float**)&c->cnt_a,
                    (float**)&c->cnt_d, (float**)&c->cnt_q};
  size_t off = 0;
  for (int i = 0; i < 6; ++i) {
    *ptrs[i] = base ? base + off : nullptr;
    off += (sizes[i] + 3) / 4 * 4;   // 16-byte aligned pieces
  }
  return off;
}

static cudaError_t run_fwd_tc(const Fwd& f, float* scratch, int sms,
                              cudaStream_t s) {
  FwdTc c;
  carve_fwd(&c, scratch, sms, f.B, f.P, f.E, f.A, f.D, f.datt);
  const size_t sm_s = sizeof(float) * (f.Ti + SM_THREADS + CTX_COLS);
  cudaError_t err = tc_product_prepare();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scan_cell_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(TcSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fwd_energy_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(EnergySmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(softmax_ctx_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm_s);
  if (err != cudaSuccess) return err;
  const int K1 = f.P + f.E + f.A, K2 = f.A + f.E + f.D;
  const int mt = (f.B + TC_MT - 1) / TC_MT;
  const dim3 g_a((4 * f.A + TC_NT - 1) / TC_NT, mt, c.za);
  const dim3 g_d((4 * f.D + TC_NT - 1) / TC_NT, mt, c.zd);
  const dim3 g_e((f.Ti + AB_TT - 1) / AB_TT, (f.B + FE_RB - 1) / FE_RB);
  const dim3 g_s((f.E + CTX_COLS - 1) / CTX_COLS, f.B);
  const size_t B = f.B;
  const bf16* pre = (const bf16*)f.prenet;
  bf16 *ga = (bf16*)f.ga, *gd = (bf16*)f.gd, *atth = (bf16*)f.atth,
       *dech = (bf16*)f.dech;
  for (int t = 0; t < f.T; ++t) {
    const size_t ta = t * B * f.A, td = t * B * f.D, te = t * B * f.E;
    const size_t pa = ta - B * f.A, pd = td - B * f.D, pe = te - B * f.E;
    ScanSrc xa{pre + t * B * f.P, t ? f.ctx + pe : nullptr,
               t ? atth + pa : nullptr, f.P, f.E, f.A};
    ScanCell ca{f.b1, t ? f.attc + pa : nullptr,
                f.keep_a ? f.keep_a + ta : nullptr, f.s_att, ga + 4 * ta,
                f.attc + ta, atth + ta, f.A};
    scan_cell_kernel<<<g_a, TC_THREADS, sizeof(TcSmem), s>>>(
        xa, f.B, K1, (const bf16*)f.w1, 4 * f.A, c.part_a, c.cnt_a, ca);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = tc_product(atth + ta, f.A, f.B, f.A, (const bf16*)f.wqc, f.datt,
                     c.zq, TcOut{f.q, c.part_q, c.cnt_q, nullptr, 0, 0}, s);
    if (err != cudaSuccess) return err;
    EnergyTc et{f.q, f.w, f.wc, (const bf16*)f.k2, (const bf16*)f.v,
                (const bf16*)f.proc, f.e, f.B, f.Ti, f.datt, f.ks};
    fwd_energy_kernel<<<g_e, TILE_THREADS, sizeof(EnergySmem), s>>>(et);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    softmax_ctx_kernel<bf16><<<g_s, SM_THREADS, sm_s, s>>>(
        f.e, f.emask, (const bf16*)f.mem, f.w, f.wc, f.ctx + te, f.wst, f.fin,
        t, f.B, f.Ti, f.E);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ScanSrc xd{atth + ta, f.ctx + te, t ? dech + pd : nullptr, f.A, f.E,
               f.D};
    ScanCell cd{f.b2, t ? f.decc + pd : nullptr,
                f.keep_d ? f.keep_d + td : nullptr, f.s_dec, gd + 4 * td,
                f.decc + td, dech + td, f.D};
    scan_cell_kernel<<<g_d, TC_THREADS, sizeof(TcSmem), s>>>(
        xd, f.B, K2, (const bf16*)f.w2, 4 * f.D, c.part_d, c.cnt_d, cd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Shapes the tensor-core chain takes: LSTM widths in whole K chunks of the
// product, an attention width of 64 or 128, at most AB_KC / 2 taps, an
// encoder width in whole 16-byte loads. Other bf16 shapes take the
// CUDA-core chain.
static bool tc_shapes_ok(int E, int A, int D, int datt, int ks) {
  return A % TC_KC == 0 && D % TC_KC == 0 && datt % 64 == 0 &&
         datt <= AB_DMAX && 2 * ks <= AB_KC && E % 8 == 0;
}

extern "C" {

// Bytes of scratch the forward scan needs at these shapes (bf16 != 0 and
// fwd_tc_ok: the tensor-core forward; else none). Returns cudaError_t.
int train_scan_fwd_scratch(int bf16, int B, int Ti, int P, int E, int A,
                           int D, int datt, int ks, size_t* bytes) {
  *bytes = 0;
  if (bf16 && fwd_tc_ok(P, E, A, D, datt, ks)) {
    const int sms = device_sms();
    if (sms == 0) return (int)cudaErrorNoDevice;
    FwdTc c;
    *bytes = sizeof(float) * carve_fwd(&c, nullptr, sms, B, P, E, A, D, datt);
  }
  return 0;
}

// The forward scan (see run_fwd, run_fwd_tc and the header). bf16 != 0: W
// is __nv_bfloat16, else float. wqc: wq column-tiled (lstm_layout.py
// to_col_tiles). Stacks are time-major (T, B, ...); w, wc (B, Ti) and fin
// (B,) must hold zeros; scratch holds train_scan_fwd_scratch's bytes and is
// cleared here. Returns cudaError_t.
int train_scan_fwd(int bf16, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* wq, const void* wqc,
                   const void* k2, const void* v, const void* prenet,
                   const void* mem, const void* proc, const void* emask,
                   const void* keep_a, const void* keep_d, float s_att,
                   float s_dec, void* ga, void* gd, void* atth, void* dech,
                   void* attc, void* decc, void* ctx, void* wst, void* q,
                   void* e, void* w, void* wc, void* fin, void* scratch, int B,
                   int T, int Ti, int P, int E, int A, int D, int datt, int ks,
                   void* stream) {
  if (A % TS_UNITS || D % TS_UNITS || ks % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Fwd f{w1, w2, wq, wqc, k2, v, (const float*)b1, (const float*)b2,
        prenet, mem, proc, (const float*)emask,
        (const unsigned char*)keep_a, (const unsigned char*)keep_d,
        s_att, s_dec, ga, gd, atth, dech, (float*)attc, (float*)decc,
        (float*)ctx, (float*)wst, (float*)q, (float*)e, (float*)w,
        (float*)wc, (int*)fin, B, T, Ti, P, E, A, D, datt, ks};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16 && fwd_tc_ok(P, E, A, D, datt, ks)) {
    size_t bytes;
    int err = train_scan_fwd_scratch(bf16, B, Ti, P, E, A, D, datt, ks,
                                     &bytes);
    if (err != 0) return err;
    cudaError_t ce = cudaMemsetAsync(scratch, 0, bytes, s);
    if (ce != cudaSuccess) return (int)ce;
    return (int)run_fwd_tc(f, (float*)scratch, device_sms(), s);
  }
  return (int)(bf16 ? run_fwd<__nv_bfloat16>(f, s) : run_fwd<float>(f, s));
}

// Bytes of scratch the backward chain needs at these shapes (bf16 != 0
// and tc_shapes_ok: the tensor-core chain). Returns cudaError_t.
int train_scan_bwd_scratch(int bf16, int B, int T, int Ti, int P, int E,
                           int A, int D, int datt, int ks, size_t* bytes) {
  if (bf16 && tc_shapes_ok(E, A, D, datt, ks)) {
    const int sms = device_sms();
    if (sms == 0) return (int)cudaErrorNoDevice;
    TcChain c;
    *bytes = sizeof(float) *
             carve_tc(&c, nullptr, sms, B, T, Ti, P, E, A, D, datt, ks);
  } else {
    float* p[8];
    *bytes = sizeof(float) * carve_cc(p, nullptr, B, Ti, P, E, A, D, datt, ks);
  }
  return 0;
}

// The backward chain (see the header and the bf16 section). wta / wtd:
// [wi ; wh]^T of each LSTM, wqc: wq (A, datt), wqt: wq^T (datt, A), all
// column-tiled (lstm_layout.py to_col_tiles); wq (A, datt) row-major; wcp
// (T, B, Ti) the exclusive prefix sums of w. dproc, dk2 and dv must hold
// zeros; scratch holds train_scan_bwd_scratch's bytes and is cleared here.
// Returns cudaError_t.
int train_scan_bwd(int bf16, const void* wta, const void* wtd, const void* wq,
                   const void* wqc, const void* wqt, const void* k2,
                   const void* vf, const void* mem, const void* proc,
                   const void* ga, const void* gd, const void* atth,
                   const void* attc, const void* decc, const void* wst,
                   const void* wcp, const void* ddh, const void* dctx_o,
                   const void* dalign, const void* keep_a, const void* keep_d,
                   float s_att, float s_dec, void* dga, void* dgd, void* dpre,
                   void* dctx, void* dq, void* dproc, void* dk2, void* dv,
                   void* scratch, int B, int T, int Ti, int P, int E, int A,
                   int D, int datt, int ks, void* stream) {
  if (ks % 2 == 0 || datt > AB_THREADS || AB_THREADS % datt)
    return (int)cudaErrorInvalidValue;
  Bwd r{wta, wtd, wq, wqc, wqt, k2, (const float*)vf, mem, proc, ga, gd,
        atth, (const float*)attc, (const float*)decc, (const float*)wst,
        (const float*)wcp, (const float*)ddh, (const float*)dctx_o,
        (const float*)dalign, (const unsigned char*)keep_a,
        (const unsigned char*)keep_d, s_att, s_dec, dga, dgd, dctx,
        (float*)dpre, (float*)dq, (float*)dproc, (float*)dk2, (float*)dv,
        B, T, Ti, P, E, A, D, datt, ks};
  cudaStream_t s = (cudaStream_t)stream;
  size_t bytes;
  int err = train_scan_bwd_scratch(bf16, B, T, Ti, P, E, A, D, datt, ks,
                                   &bytes);
  if (err != 0) return err;
  cudaError_t e = cudaMemsetAsync(scratch, 0, bytes, s);
  if (e != cudaSuccess) return (int)e;
  if (bf16 && tc_shapes_ok(E, A, D, datt, ks))
    return (int)run_bwd_tc(r, (float*)scratch, device_sms(), s);
  if (bf16) return (int)run_bwd_cc<__nv_bfloat16>(r, (float*)scratch, s);
  return (int)run_bwd_cc<float>(r, (float*)scratch, s);
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
