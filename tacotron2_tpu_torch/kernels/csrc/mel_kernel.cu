// Fused log-mel spectrogram of a batch of waveforms:
//   frames (centred, reflect-padded, hop apart) -> windowed DFT as two
//   products against the cos and sin bases -> magnitude -> mel product ->
//   log(max(., 1e-5)), written as (B, n_mels, T).
//
// Replaces the TPU kernel tacotron2_tpu/kernels/mel_kernel.py _mel_kernel
// (called by mel_spectrogram_pallas). What that kernel keeps out of device
// memory is kept out here too: the (frames x bins) magnitude goes from the
// product's accumulators through shared memory into the mel product. Its
// wrapper first gathers the overlapping frames into device memory (four
// times the audio at hop = n_fft / 4); this kernel reads them straight from
// the waveform and resolves the reflect padding itself.
//
// What bounds it on the H100: 2 * n_fft * n_bins multiply-adds per frame
// (2.1 M at n_fft 1024) against 1 KB of new audio per frame: operations.
// Design: the DFT runs on the tensor cores (mma.sync m16n8k8 tf32) as three
// TF32 products per product, a_lo b_hi + a_hi b_lo + a_hi b_hi, with
// x_hi = rna(x) and x_lo = rna(x - x_hi), which keeps fp32-level accuracy
// (plain TF32 keeps ~10 mantissa bits; near the 1e-5 floor the log turns
// that into errors above the tolerance). Each product is taken on frames
// folded about n_fft / 2, u[k] = x[k] + x[n - k] and v[k] = x[k] - x[n - k]
// for 0 < 2k < n (u[k] = x[k], v[k] = 0 where row k has no partner), in
// fp32 before the split, against the bases' even and odd parts Ce, Co, Se,
// So ((B[k] +- B[n - k]) / 2; the wrapper makes them):
//   Re = sum_{k <= n/2} u[k] Ce[k] + v[k] Co[k]
//   Im = sum_{k <= n/2} v[k] So[k] + u[k] Se[k].
// A window symmetric about the frame's centre (n_fft - win_length even)
// makes Co and Se zero: one pass, half the tensor-core work of frames @
// [cos | sin] for the same sums, in another order. Otherwise a second pass
// over the same depth takes the Co and Se terms (the packed bases' part 1).
//
// A block owns MEL_TF frames of the flattened (batch, frame) index, so the
// grid is ceil(B * T / 64) blocks (130 at 16 x 6 s: one wave on 132 SMs),
// and walks every bin tile of MEL_NB bins: for each, each part's folded
// depth in chunks of MEL_KC. The frames of a chunk are read from the
// waveform (L1/L2; the next chunk's loads are in flight during this one's
// products), folded, split into hi and lo and stored in padded
// [MEL_TF][MEL_KC + 4] tiles read by ldmatrix without bank conflicts. The
// folded bases, split once by the wrapper and packed per bin tile and part
// as [cos 64 | sin 64] rows (zero past n_bins and the folded depth), stream
// in by cp.async through a ring of MEL_STAGES chunks whose rows are padded
// to 136 floats (B fragments without bank conflicts); only the columns that
// hold bins are loaded. 8 warps, 2 x 4: a warp holds 32 frames x 16 bins of
// real and imaginary sums, its three products ordered so that no two in a
// row add to the same sums; octets of bins past n_bins are skipped. At the
// end of a bin tile the magnitudes go to shared memory and their mel
// product (fp32 CUDA cores, ~2% of the work) is added to per-thread mel
// sums (4 frames x 8 mels). On an NVIDIA H100 80GB HBM3 at 700 W it runs at
// ~10% of its 3xTF32 bound over the folded depth (PERF.md): mma.sync's TF32
// rate and the fragment loads from shared memory, not the bases' stream
// from L2 (halving that stream with 128-frame blocks made it slower), are
// what is left.
#include <math.h>

#include "mma.cuh"

#define MEL_TF 64        // frames per block
#define MEL_NB 64        // bins per tile
#define MEL_KC 32        // depth of one chunk
#define MEL_STAGES 3     // basis chunks in the ring
#define MEL_THREADS 256
#define MEL_PT 8         // mel columns per thread
#define MEL_MAX (16 * MEL_PT)  // most mel channels the kernel takes
#define MEL_ALD (MEL_KC + 4)       // frame tile row (floats)
#define MEL_BLD (2 * MEL_NB + 8)   // basis chunk row (floats)
#define MEL_MLD (MEL_NB + 1)       // magnitude tile row

struct MelSmem {
  float u_hi[MEL_TF * MEL_ALD], u_lo[MEL_TF * MEL_ALD];   // folded sums
  float v_hi[MEL_TF * MEL_ALD], v_lo[MEL_TF * MEL_ALD];   // folded differences
  float b_hi[MEL_STAGES][MEL_KC * MEL_BLD], b_lo[MEL_STAGES][MEL_KC * MEL_BLD];
  float mag[MEL_TF * MEL_MLD];
};

// Chunk q of the packed bases (tile q / nkp of nkp chunks; chunks are
// contiguous) into ring slot q % MEL_STAGES: 2 x MEL_KC rows of [cos | sin],
// 16 bytes per copy, only the columns of the tile's bins.
__device__ __forceinline__ void mel_load_basis(MelSmem& s, const float* bhi,
                                               const float* blo, int q,
                                               int nkp, int n_bins) {
  const size_t off = (size_t)q * MEL_KC * 2 * MEL_NB;
  constexpr int ROW = 2 * MEL_NB / 4;                  // 16-byte pieces a row
  constexpr int PER = MEL_KC * ROW;
  const int nb = min(MEL_NB, n_bins - (q / nkp) * MEL_NB);
  const int cols = (nb + 3) / 4;                       // pieces of each half
  const int slot = q % MEL_STAGES;
  for (int i = threadIdx.x; i < 2 * PER; i += MEL_THREADS) {
    const int part = i / PER, j = i % PER;
    const int row = j / ROW, piece = j % ROW;
    if (piece % (MEL_NB / 4) >= cols) continue;       // no bins there
    float* dst = (part ? s.b_lo : s.b_hi)[slot] + row * MEL_BLD + piece * 4;
    cp_async16(dst, (part ? blo : bhi) + off + (size_t)row * 2 * MEL_NB +
                        piece * 4);
  }
}

// PARTS: the parts of the packed bases (a template parameter, so that the
// one-part kernel, the common case, carries no code for the second)
template <int PARTS>
__global__ void __launch_bounds__(MEL_THREADS)
mel_kernel(const float* __restrict__ y, const float* __restrict__ bhi,
           const float* __restrict__ blo, const float* __restrict__ melT,
           float* __restrict__ out, int B, int S, int T, int n_fft, int hop,
           int n_bins, int n_mels) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  MelSmem& s = *reinterpret_cast<MelSmem*>(sm_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 32 frames x 16 bins a warp
  const int F0 = blockIdx.x * MEL_TF;
  const int half = n_fft / 2;
  const int nk = (half + 1 + MEL_KC - 1) / MEL_KC;   // folded depth
  const int ntiles = (n_bins + MEL_NB - 1) / MEL_NB;
  const int nkp = nk * PARTS;                        // chunks of a bin tile
  const int nq = nkp * ntiles;

  // the frame and the 8 folded depths this thread stages in each chunk
  const int sf = tid >> 2, sk = (tid & 3) * 8;
  const int Fs = F0 + sf;
  const bool f_in = Fs < B * T;
  const float* yb = y + (size_t)(f_in ? Fs / T : 0) * S;
  const int start = (f_in ? Fs % T : 0) * hop - half;
  auto sample = [&](int k) {            // x[k] of the frame, reflect-padded
    int j = start + k;
    if (j < 0) j = -j;                  // edge sample not repeated
    if (j >= S) j = 2 * (S - 1) - j;
    return __ldg(yb + j);
  };
  float xa[8], xb[8];                   // x[k], x[n - k]
  auto fetch = [&](int kc) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = kc * MEL_KC + sk + i;
      xa[i] = (f_in && k <= half) ? sample(k) : 0.0f;
      xb[i] = (f_in && k > 0 && 2 * k < n_fft) ? sample(n_fft - k) : 0.0f;
    }
  };

  // mel layout: 4 frames (my) x mels mx, mx + 16, ... per thread
  const int mx = tid & 15, my = tid >> 4;
  float macc[4][MEL_PT];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < MEL_PT; ++i) macc[f][i] = 0.0f;

  float acc[2][2][2][4];   // [m tile][bin octet][cos, sin][fragment]
#pragma unroll
  for (int st = 0; st < MEL_STAGES - 1; ++st) {
    if (st < nq) mel_load_basis(s, bhi, blo, st, nkp, n_bins);
    cp_async_commit();
  }
  fetch(0);
  for (int q = 0; q < nq; ++q) {
    const int qt = q % nkp, bin0 = (q / nkp) * MEL_NB;
    const bool swap = PARTS == 2 && qt >= nk;   // part 1: cos v, sin u
    if (qt == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][o][p][e] = 0.0f;
    }
    __syncthreads();   // chunk q - 1 is done with the frame tiles and a slot
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int at = sf * MEL_ALD + sk + i;
      uint32_t h, l;
      split_tf32(xa[i] + xb[i], h, l);
      s.u_hi[at] = __uint_as_float(h);
      s.u_lo[at] = __uint_as_float(l);
      split_tf32(xa[i] - xb[i], h, l);
      s.v_hi[at] = __uint_as_float(h);
      s.v_lo[at] = __uint_as_float(l);
    }
    if (q + MEL_STAGES - 1 < nq)
      mel_load_basis(s, bhi, blo, q + MEL_STAGES - 1, nkp, n_bins);
    cp_async_commit();
    if (q + 1 < nq) fetch((q + 1) % nk);
    cp_async_wait<MEL_STAGES - 1>();
    __syncthreads();
    const float* bh = s.b_hi[q % MEL_STAGES];
    const float* bl = s.b_lo[q % MEL_STAGES];
    bool oct_in[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) oct_in[o] = bin0 + wn * 16 + o * 8 < n_bins;
    const int r = lane & 7, mi = lane >> 3;
#pragma unroll
    for (int k8 = 0; k8 < MEL_KC; k8 += 8) {
      // A: [cos, sin][hi, lo][m tile]; in part 0 cos takes the sums and
      // sin the differences, in part 1 the other way round
      uint32_t a[2][2][2][4];
      const float* ac_hi = swap ? s.v_hi : s.u_hi;
      const float* ac_lo = swap ? s.v_lo : s.u_lo;
      const float* as_hi = swap ? s.u_hi : s.v_hi;
      const float* as_lo = swap ? s.u_lo : s.v_lo;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (wm * 32 + i * 16 + r + (mi & 1) * 8) * MEL_ALD + k8 +
                       (mi >> 1) * 4;
        ldmatrix_x4(a[0][0][i], ac_hi + at);
        ldmatrix_x4(a[0][1][i], ac_lo + at);
        ldmatrix_x4(a[1][0][i], as_hi + at);
        ldmatrix_x4(a[1][1][i], as_lo + at);
      }
      uint32_t b[2][2][2][2];   // [octet][cos, sin][hi, lo][fragment]
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int col = p * MEL_NB + wn * 16 + o * 8 + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* bb = h ? bl : bh;
            b[o][p][h][0] = __float_as_uint(bb[(k8 + t4) * MEL_BLD + col]);
            b[o][p][h][1] = __float_as_uint(bb[(k8 + t4 + 4) * MEL_BLD + col]);
          }
        }
      // the three passes: lo hi, hi lo, hi hi
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const int ah = pass == 0 ? 1 : 0, bhl = pass == 1 ? 1 : 0;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          if (!oct_in[o]) continue;   // warp-uniform
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              mma_tf32(acc[i][o][p], a[p][ah][i], b[o][p][bhl]);
        }
      }
    }
    if (qt != nkp - 1) continue;
    // magnitudes of the tile: cos and sin sums sit in the same registers
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = wm * 32 + i * 16 + g + (e >> 1) * 8;
          const int j = wn * 16 + o * 8 + 2 * t4 + (e & 1);
          const float re = acc[i][o][0][e], im = acc[i][o][1][e];
          s.mag[f * MEL_MLD + j] = sqrtf(re * re + im * im);
        }
    __syncthreads();
    // the mel weights come straight from global memory (a tile's rows are
    // in L1 / L2 for every block)
    const int nj = min(MEL_NB, n_bins - bin0);
    for (int j = 0; j < nj; ++j) {
      float av[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) av[f] = s.mag[(my * 4 + f) * MEL_MLD + j];
      const float* wrow = melT + (size_t)(bin0 + j) * n_mels;
#pragma unroll
      for (int i = 0; i < MEL_PT; ++i) {
        const int m = mx + 16 * i;
        const float wv = m < n_mels ? __ldg(wrow + m) : 0.0f;
#pragma unroll
        for (int f = 0; f < 4; ++f) macc[f][i] = fmaf(av[f], wv, macc[f][i]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int F = F0 + my * 4 + f;
    if (F >= B * T) continue;
    const int b = F / T, t = F % T;
#pragma unroll
    for (int i = 0; i < MEL_PT; ++i) {
      const int m = mx + 16 * i;
      if (m < n_mels)
        out[((size_t)b * n_mels + m) * T + t] = logf(fmaxf(macc[f][i], 1e-5f));
    }
  }
}

extern "C" {

// 0 when the kernel takes these dimensions on the current device; 1 when
// n_mels exceeds MEL_MAX; 2 when the block's shared memory (*need bytes)
// exceeds what a block may opt into (*have); -1 when the device cannot be
// asked.
int mel_limits(int n_mels, size_t* need, int* have) {
  if (n_mels > MEL_MAX) return 1;
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(have, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  *need = sizeof(MelSmem);
  return *need > (size_t)*have ? 2 : 0;
}

// y (B, S) fp32; bhi, blo the rows k <= n_fft / 2 of the windowed cos
// and sin bases' even and odd parts split into TF32 hi and lo parts, packed
// (ceil(n_bins / 64), parts, kpad, [cos 64 | sin 64]) with zeros past n_bins
// and past those rows (kpad = n_fft / 2 + 1 rounded up to 32): part 0
// [Ce | So], part 1 (parts = 2, a window not symmetric about n_fft / 2)
// [Co | Se]; melT (n_bins, n_mels); out (B, n_mels, T) with T = 1 + S / hop
// frames. Needs S > n_fft / 2 (reflect padding). Returns cudaError_t.
int mel_spectrogram(const void* y, const void* bhi, const void* blo,
                    const void* melT, void* out, int B, int S, int T,
                    int n_fft, int hop, int n_bins, int n_mels, int parts,
                    void* stream) {
  size_t need;
  int have;
  if (S <= n_fft / 2 || parts < 1 || parts > 2 ||
      mel_limits(n_mels, &need, &have) != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = parts == 2 ? &mel_kernel<2> : &mel_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
  if (err != cudaSuccess) return err;
  const int grid = (B * T + MEL_TF - 1) / MEL_TF;
  kernel<<<grid, MEL_THREADS, need, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)bhi, (const float*)blo,
      (const float*)melT, (float*)out, B, S, T, n_fft, hop, n_bins, n_mels);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
