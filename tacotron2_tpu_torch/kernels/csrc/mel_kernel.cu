// Fused log-mel spectrogram of a batch of waveforms:
//   frames (centred, reflect-padded, hop apart) -> windowed DFT as two
//   products against the cos and sin bases -> magnitude -> mel product ->
//   log(max(., 1e-5)), written as (B, n_mels, T).
//
// Replaces the TPU kernel tacotron2_tpu/kernels/mel_kernel.py _mel_kernel
// (called by mel_spectrogram_pallas). What that kernel keeps out of device
// memory is kept out here too: the (frames x bins) magnitude lives only in
// shared memory. Its wrapper first gathers the overlapping frames into
// device memory (four times the audio at hop = n_fft / 4); this kernel reads
// them straight from the waveform and resolves the reflect padding itself.
// fp32 throughout, products on the CUDA cores (no TF32).
//
// What bounds it on the H100: 2 * n_fft * n_bins multiply-adds per frame
// (2.1 M at n_fft 1024) against 1 KB of new audio per frame: operations, at
// the fp32 rate outside the tensor cores. Design: a block owns MEL_TF
// frames of one waveform; their samples, (MEL_TF - 1) * hop + n_fft floats,
// sit in shared memory once. A (128, 1024) frame tile, as the TPU kernel
// takes, would need 512 KB; 64 frames read in place need 69 KB, and the
// block's 102 KB in all let two blocks share an SM. The bases
// are streamed through shared memory in (MEL_KC, MEL_NB) chunks: for each
// tile of MEL_NB bins the block runs the whole depth, a thread holding 8
// frames x 2 bins of real and imaginary sums, then writes the tile's
// magnitudes to shared memory and adds their mel product to per-thread mel
// sums (4 frames x 8 mels) before the next bin tile. The last tile of
// frames and of bins is masked.
#include <cuda_runtime.h>
#include <math.h>

#define MEL_TF 64        // frames per block
#define MEL_NB 64        // bins per tile
#define MEL_KC 32        // depth of one staged chunk of the bases
#define MEL_THREADS 256
#define MEL_PT 8         // mel columns per thread
#define MEL_MAX (16 * MEL_PT)  // most mel channels the kernel takes

__global__ void __launch_bounds__(MEL_THREADS)
mel_kernel(const float* __restrict__ y, const float* __restrict__ cosb,
           const float* __restrict__ sinb, const float* __restrict__ melT,
           float* __restrict__ out, int S, int T, int n_fft, int hop,
           int n_bins, int n_mels, int seg_pad) {
  extern __shared__ float sm[];
  float* seg = sm;                          // seg_pad (>= segment, % 4 == 0)
  float* cs = seg + seg_pad;                // MEL_KC x MEL_NB
  float* ss = cs + MEL_KC * MEL_NB;         // MEL_KC x MEL_NB
  float* mag = ss + MEL_KC * MEL_NB;        // MEL_TF x (MEL_NB + 1)
  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * MEL_TF;
  const int seg_len = (MEL_TF - 1) * hop + n_fft;
  const int pad = n_fft / 2;
  const float* yb = y + (size_t)b * S;
  for (int i = tid; i < seg_pad; i += MEL_THREADS) {
    int j = f0 * hop + i - pad;      // sample of the unpadded waveform
    if (j < 0) j = -j;               // reflect, edge sample not repeated
    if (j >= S) j = 2 * (S - 1) - j;
    // zero past the segment (read against zero basis rows when n_fft is no
    // multiple of MEL_KC) and past the last frame (never stored)
    seg[i] = (i < seg_len && j >= 0 && j < S) ? yb[j] : 0.0f;
  }
  // DFT layout: 8 frames (ty) x 2 bins (tx) per thread
  const int tx = tid & 31, ty = tid >> 5;
  // mel layout: 4 frames (my) x mels mx, mx + 16, ... per thread
  const int mx = tid & 15, my = tid >> 4;
  float macc[4][MEL_PT];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < MEL_PT; ++i) macc[f][i] = 0.0f;

  for (int bin0 = 0; bin0 < n_bins; bin0 += MEL_NB) {
    float re[8][2], im[8][2];
#pragma unroll
    for (int f = 0; f < 8; ++f) re[f][0] = re[f][1] = im[f][0] = im[f][1] = 0.0f;
    for (int k0 = 0; k0 < n_fft; k0 += MEL_KC) {
      __syncthreads();  // the previous chunk (and the segment) is done with
      for (int i = tid; i < MEL_KC * MEL_NB; i += MEL_THREADS) {
        const int kk = i / MEL_NB, j = i % MEL_NB;
        const bool in = k0 + kk < n_fft && bin0 + j < n_bins;
        const size_t at = (size_t)(k0 + kk) * n_bins + bin0 + j;
        cs[i] = in ? cosb[at] : 0.0f;
        ss[i] = in ? sinb[at] : 0.0f;
      }
      __syncthreads();
      const float* xr = seg + ty * 8 * hop + k0;
#pragma unroll 4
      for (int kk = 0; kk < MEL_KC; ++kk) {
        const float2 c = *reinterpret_cast<const float2*>(cs + kk * MEL_NB + 2 * tx);
        const float2 s = *reinterpret_cast<const float2*>(ss + kk * MEL_NB + 2 * tx);
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const float x = xr[f * hop + kk];
          re[f][0] = fmaf(x, c.x, re[f][0]);
          re[f][1] = fmaf(x, c.y, re[f][1]);
          im[f][0] = fmaf(x, s.x, im[f][0]);
          im[f][1] = fmaf(x, s.y, im[f][1]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mag[(ty * 8 + f) * (MEL_NB + 1) + 2 * tx + j] =
            sqrtf(re[f][j] * re[f][j] + im[f][j] * im[f][j]);
    __syncthreads();
    // the mel weights come straight from global memory (20 KB a tile, in
    // L1 / L2 for every block): staging them would cost the shared memory
    // that lets a second block share the SM
    const int nj = min(MEL_NB, n_bins - bin0);
    for (int j = 0; j < nj; ++j) {
      float a[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) a[f] = mag[(my * 4 + f) * (MEL_NB + 1) + j];
      const float* wrow = melT + (size_t)(bin0 + j) * n_mels;
#pragma unroll
      for (int i = 0; i < MEL_PT; ++i) {
        const int m = mx + 16 * i;
        const float wv = m < n_mels ? __ldg(wrow + m) : 0.0f;
#pragma unroll
        for (int f = 0; f < 4; ++f) macc[f][i] = fmaf(a[f], wv, macc[f][i]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int t = f0 + my * 4 + f;
    if (t >= T) continue;
#pragma unroll
    for (int i = 0; i < MEL_PT; ++i) {
      const int m = mx + 16 * i;
      if (m < n_mels)
        out[((size_t)b * n_mels + m) * T + t] = logf(fmaxf(macc[f][i], 1e-5f));
    }
  }
}

static size_t mel_smem(int n_fft, int hop, int* seg_pad) {
  const int seg_len = (MEL_TF - 1) * hop + n_fft + MEL_KC;
  *seg_pad = (seg_len + 3) / 4 * 4;
  return sizeof(float) * ((size_t)*seg_pad + 2 * MEL_KC * MEL_NB +
                          MEL_TF * (MEL_NB + 1));
}

extern "C" {

// 0 when the kernel takes these dimensions on the current device; 1 when
// n_mels exceeds MEL_MAX; 2 when the block's shared memory (*need bytes)
// exceeds what a block may opt into (*have); -1 when the device cannot be
// asked.
int mel_limits(int n_fft, int hop, int n_mels, size_t* need, int* have) {
  if (n_mels > MEL_MAX) return 1;
  int dev, seg_pad;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(have, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  *need = mel_smem(n_fft, hop, &seg_pad);
  return *need > (size_t)*have ? 2 : 0;
}

// y (B, S) fp32; cosb, sinb (n_fft, n_bins) windowed bases; melT (n_bins,
// n_mels); out (B, n_mels, T) with T = 1 + S / hop frames. Needs
// S > n_fft / 2 (reflect padding). Returns cudaError_t.
int mel_spectrogram(const void* y, const void* cosb, const void* sinb,
                    const void* melT, void* out, int B, int S, int T,
                    int n_fft, int hop, int n_bins, int n_mels, void* stream) {
  size_t need;
  int have, seg_pad;
  if (S <= n_fft / 2 || mel_limits(n_fft, hop, n_mels, &need, &have) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mel_smem(n_fft, hop, &seg_pad);
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + MEL_TF - 1) / MEL_TF, B);
  mel_kernel<<<grid, MEL_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)cosb, (const float*)sinb,
      (const float*)melT, (float*)out, S, T, n_fft, hop, n_bins, n_mels,
      seg_pad);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
