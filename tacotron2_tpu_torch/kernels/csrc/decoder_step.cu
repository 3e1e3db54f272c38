// Single-utterance decoder chunk: `cs` autoregressive Tacotron 2 decoder
// steps for one row, for offline and streamed synthesis of one utterance.
//
// Replaces the TPU kernel tacotron2_tpu/kernels/decoder_step.py _make_kernel
// (called by _fused_chunk_call). The step is the batched chunk's
// (decoder_batch.cu: prenet, attention LSTM, location-sensitive attention,
// decoder LSTM, mel + gate projection, gate latch) with that TPU kernel's
// own cast points: the query, the location term (K2, w, w_cum) and the
// processed memory stay in fp32, only tanh's output is rounded to bf16
// before the v-product, and the context is summed from the fp32 memory.
// After the gate latches the state keeps stepping, as in the TPU kernel;
// only mel, gate, align and the length are masked.
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
// Design. The chunk is ONE cooperative persistent launch: the batched
// chunk's persistent kernel (persistent_chunk.cuh) at B = 1 with this TPU
// kernel's cast points (AT = float: fp32 query, K2, location term,
// processed memory and memory). One block per SM; a grid barrier stands
// where a launch boundary would; the decoder LSTM's weights stay in shared
// memory for the chunk, the attention LSTM's stream from L2 in mma.sync
// fragment order (kernels/lstm_layout.py to_mma_tiles); both LSTM products
// run on the tensor cores in swap-AB form (the row is one column of an n8
// tile). kernels/decoder_step.py runs a chunk on the CPU through the plain
// version, and refuses fp32 on the card.
#include "persistent_chunk.cuh"

extern "C" {

// The entries are decoder_batch.cu's, with its names and arguments, so
// that kernels/decoder_batch.py launches either library alike; here B is 1
// (the wrapper checks it).
//
// Runs cs decoder steps of one row at bf16. h1 / h2 / fin point at (2, A)
// / (2, D) / (2,) buffers whose slot 0 holds the incoming state; the final
// state lands in slot cs % 2. Every other carry is updated in place. k2,
// mem, proc and emask are fp32. w1f / w2f: the LSTM weights in mma
// fragment order (kernels/lstm_layout.py to_mma_tiles); scratch:
// decoder_chunk_scratch bytes. rounds (host memory, PC_NPH ints, or null)
// gets the launch's rounds of items by phase. Returns a cudaError_t, or the
// plan's refusal (< 0; error_string words it).
int decoder_chunk(const void* pre1, const void* pre2, const void* w1,
                  const void* b1, const void* w2, const void* b2,
                  const void* wq, const void* k2, const void* v,
                  const void* wpe, const void* bpe, const void* w1f,
                  const void* w2f, const void* mem, const void* proc,
                  const void* emask, const void* kp1, const void* kp2,
                  void* h1, void* c1, void* h2, void* c2, void* w, void* wc,
                  void* ctx, void* prev, void* fin, void* len, void* a2,
                  void* q, void* e, void* mel, void* gate, void* align,
                  void* scratch, int B, int T, int n, int p, int E, int A,
                  int D, int datt, int ks, int cs, int t0, float gate_logit,
                  void* stream, int* rounds) {
  const Chunk c{pre1, pre2, w1, w2, wq, k2, v, wpe,
                (const float*)b1, (const float*)b2, (const float*)bpe,
                mem, proc, (const float*)emask, (const float*)kp1,
                (const float*)kp2,
                (float*)h1, (float*)c1, (float*)h2, (float*)c2, (float*)w,
                (float*)wc, (float*)ctx, (float*)prev, (int*)fin, (int*)len,
                (float*)a2, (float*)q, (float*)e,
                (float*)mel, (float*)gate, (float*)align,
                B, T, n, p, E, A, D, datt, ks, cs, t0, gate_logit};
  return persistent_chunk<float>(c, w1f, w2f, scratch, (cudaStream_t)stream,
                                 rounds);
}

// Bytes of scratch decoder_chunk takes at these widths. Returns 0.
int decoder_chunk_scratch(int B, int p, int E, int A, int D, size_t* bytes) {
  *bytes = persistent_scratch(B, p + E + A, A + E + D);
  return 0;
}

// Whether decoder_chunk takes a chunk of min(B, *rows) rows at these
// widths, without a launch: *rows gets 1; the answer is
// persistent_limits' at one row.
int decoder_chunk_limits(int B, int T, int n, int p, int E, int A, int D,
                         int datt, int ks, int* rows, size_t* need,
                         int* have) {
  *rows = 1;
  return persistent_limits<float>(1, T, n, p, E, A, D, datt, ks, need,
                                  have);
}

const char* error_string(int err) { return pc_error_string(err); }

}  // extern "C"
