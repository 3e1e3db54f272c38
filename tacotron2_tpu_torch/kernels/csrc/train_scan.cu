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
// operations on the tensor cores. This first design computes them on CUDA
// cores in fp32 (gate_product: each weight element read from L2 feeds 8
// rows), two orders of magnitude above that bound; mma/wgmma tiles are
// later work.
//
// Design: a few plain launches per step from a host loop inside each C
// entry point. Forward: scan_lstm_kernel (blocks own TS_UNITS hidden units
// and all four gate columns x 8 rows, weights block-major), the query, the
// serving chunk's energy and softmax/context kernels, scan_lstm_kernel.
// Backward: lstm_gates_bwd_kernel, tile_product_kernel (transposed weights
// column-tiled), attn_bwd_kernel (one block per row does the context,
// softmax, energy and attention-LSTM backward for its row), the second
// product, and the fixed-order sums of the rows' d_K2 and d_v. Every
// accumulator is deterministic: d_processed element (b, t, d) belongs to one
// thread of row b's block at every step; d_K2 and d_v are summed from the
// rows' partials in a fixed order.
#include <math.h>

#include "attention.cuh"
#include "lstm_cell.cuh"

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
  const void *w1, *w2, *wq, *k2, *v;  // W
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
  const W* wqt;           // (datt, A)
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
      a.dproc[o] += dm;
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
      attn = fmaf(rnd<W>(dqs[dd]), to_f<W>(a.wqt[(size_t)dd * A + u]), attn);
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

struct Bwd {
  const void *wta, *wtd, *wq, *wqt, *k2;  // W; wta/wtd column-tiled
  const float* vf;
  const void *mem, *proc, *ga, *gd, *atth;  // W
  const float *attc, *decc, *wst, *wcp;     // fp32 stacks
  const float *ddh, *dctx_o, *dalign;       // cotangent stacks
  const unsigned char *keep_a, *keep_d;
  float s_att, s_dec;
  void *dga, *dgd, *dctx;                   // W out stacks
  float *dpre, *dq, *dproc, *dk2, *dv;      // fp32 outs (dproc, dk2, dv zeroed)
  float *dxd, *dxa, *ddc, *dac, *c_dw, *c_dwc, *dv_part, *k2_part;
  int B, T, Ti, P, E, A, D, datt, ks;
};

template <typename W>
static cudaError_t run_bwd(const Bwd& r, cudaStream_t s) {
  const int NO_D = r.A + r.E + r.D, NO_A = r.P + r.E + r.A;
  const int KD = 4 * r.D, KA = 4 * r.A;
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
                    start ? nullptr : r.dxd + r.A + r.E, NO_D, r.ddh + td,
                    r.keep_d ? r.keep_d + td : nullptr, r.s_dec, r.ddc,
                    dgd + 4 * td};
    lstm_gates_bwd_kernel<W><<<g_gates, 256, 0, s>>>(dec, dec, r.B, r.D);
    tile_product_kernel<W><<<g_pd, TP_THREADS, tile_product_smem(KD), s>>>(
        dgd + 4 * td, wtd, r.dxd, dgd + 4 * td, wtd, r.dxd, r.B, KD, NO_D);
    AttnBwd<W> ab{r.dxd, start ? nullptr : r.dxa, r.dctx_o + te,
                  r.dalign + tw, (const W*)r.mem, (const W*)r.proc,
                  atth + ta, (const W*)r.wq, (const W*)r.wqt, (const W*)r.k2,
                  r.vf, r.wst + tw, t ? r.wst + tw - B * r.Ti : nullptr,
                  t ? r.wcp + tw : nullptr, ga + 4 * ta, r.attc + ta,
                  t ? r.attc + ta - B * r.A : nullptr,
                  r.keep_a ? r.keep_a + ta : nullptr, r.s_att, r.c_dw,
                  r.c_dwc, r.dac, dctx + te, r.dq + t * B * r.datt,
                  dga + 4 * ta, r.dproc, r.k2_part, r.dv_part, r.Ti, r.P, r.E,
                  r.A, r.D, r.datt, r.ks};
    attn_bwd_kernel<W><<<r.B, AB_THREADS, sm_ab, s>>>(ab);
    tile_product_kernel<W><<<g_pa, TP_THREADS, tile_product_smem(KA), s>>>(
        dga + 4 * ta, wta, r.dxa, dga + 4 * ta, wta, r.dxa, r.B, KA, NO_A);
    accumulate_parts<<<(nk2 + 255) / 256, 256, 0, s>>>(r.k2_part, r.B, nk2,
                                                       r.dk2);
    accumulate_parts<<<(r.datt + 255) / 256, 256, 0, s>>>(r.dv_part, r.B,
                                                          r.datt, r.dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaMemcpy2DAsync(r.dpre + t * B * r.P, r.P * sizeof(float), r.dxa,
                            NO_A * sizeof(float), r.P * sizeof(float), r.B,
                            cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" {

// The forward scan (see run_fwd and the header). bf16 != 0: W is
// __nv_bfloat16, else float. Stacks are time-major (T, B, ...); w, wc
// (B, Ti) and fin (B,) must hold zeros. Returns cudaError_t.
int train_scan_fwd(int bf16, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* wq, const void* k2,
                   const void* v, const void* prenet, const void* mem,
                   const void* proc, const void* emask, const void* keep_a,
                   const void* keep_d, float s_att, float s_dec, void* ga,
                   void* gd, void* atth, void* dech, void* attc, void* decc,
                   void* ctx, void* wst, void* q, void* e, void* w, void* wc,
                   void* fin, int B, int T, int Ti, int P, int E, int A, int D,
                   int datt, int ks, void* stream) {
  if (A % TS_UNITS || D % TS_UNITS || ks % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Fwd f{w1, w2, wq, k2, v, (const float*)b1, (const float*)b2,
        prenet, mem, proc, (const float*)emask,
        (const unsigned char*)keep_a, (const unsigned char*)keep_d,
        s_att, s_dec, ga, gd, atth, dech, (float*)attc, (float*)decc,
        (float*)ctx, (float*)wst, (float*)q, (float*)e, (float*)w,
        (float*)wc, (int*)fin, B, T, Ti, P, E, A, D, datt, ks};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? run_fwd<__nv_bfloat16>(f, s) : run_fwd<float>(f, s));
}

// The backward chain (see run_bwd and the header). wta / wtd: [wi ; wh]^T
// of each LSTM, column-tiled; wq (A, datt), wqt (datt, A); wcp (T, B, Ti)
// the exclusive prefix sums of w. dproc, dk2, dv, ddc, dac, c_dw and c_dwc
// must hold zeros; the rest of the scratch is written before it is read.
// Returns cudaError_t.
int train_scan_bwd(int bf16, const void* wta, const void* wtd, const void* wq,
                   const void* wqt, const void* k2, const void* vf,
                   const void* mem, const void* proc, const void* ga,
                   const void* gd, const void* atth, const void* attc,
                   const void* decc, const void* wst, const void* wcp,
                   const void* ddh, const void* dctx_o, const void* dalign,
                   const void* keep_a, const void* keep_d, float s_att,
                   float s_dec, void* dga, void* dgd, void* dpre, void* dctx,
                   void* dq, void* dproc, void* dk2, void* dv, void* dxd,
                   void* dxa, void* ddc, void* dac, void* c_dw, void* c_dwc,
                   void* dv_part, void* k2_part, int B, int T,
                   int Ti, int P, int E, int A, int D, int datt, int ks,
                   void* stream) {
  if (ks % 2 == 0 || datt > AB_THREADS || AB_THREADS % datt)
    return (int)cudaErrorInvalidValue;
  Bwd r{wta, wtd, wq, wqt, k2, (const float*)vf, mem, proc, ga, gd, atth,
        (const float*)attc, (const float*)decc, (const float*)wst,
        (const float*)wcp, (const float*)ddh, (const float*)dctx_o,
        (const float*)dalign, (const unsigned char*)keep_a,
        (const unsigned char*)keep_d, s_att, s_dec, dga, dgd, dctx,
        (float*)dpre, (float*)dq, (float*)dproc, (float*)dk2, (float*)dv,
        (float*)dxd, (float*)dxa, (float*)ddc, (float*)dac, (float*)c_dw,
        (float*)c_dwc, (float*)dv_part, (float*)k2_part,
        B, T, Ti, P, E, A, D, datt, ks};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? run_bwd<__nv_bfloat16>(r, s) : run_bwd<float>(r, s));
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
