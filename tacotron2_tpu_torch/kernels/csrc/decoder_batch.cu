// Batched decoder chunk: `cs` autoregressive Tacotron 2 decoder steps for B
// rows at once, for the batched serving path.
//
// Replaces the TPU kernel tacotron2_tpu/kernels/decoder_batch.py
// _make_kernel (called by _batch_chunk_call). Each step, for every row:
//   prenet        a2 = relu(relu(prev @ pre1) [* 2 keep1] @ pre2) [* 2 keep2]
//   attention LSTM  [a2 ; ctx ; h1] @ w1 + b1 -> (h1, c1)
//   query         q = h1 @ wq
//   location attention
//                 e[t] = v . tanh(q + loc[t] + proc[t]),
//                 loc[t] = sum_k sum_c K2[k,c,:] * [w ; w_cum][c, t+k-pad]
//                 (K2 = location conv folded through location dense)
//                 w' = softmax(e + mask)  (additive -1e30 mask, so an
//                 all-masked row stays finite), ctx = sum_t w'[t] mem[t]
//   decoder LSTM  [h1 ; ctx ; h2] @ w2 + b2 -> (h2, c2)
//   projection    [h2 ; ctx] @ wpe + bpe -> n mel values and the gate logit
//   latch         finished rows emit mel 0, gate 1e3 and align 0; a row's
//                 length counts the step whose gate logit crosses the
//                 threshold, and the row latches after it.
// Cast points are the TPU kernel's: operands rounded to bf16 before each
// product, fp32 sums, fp32 h, c, w, w_cum, ctx; memory and processed
// memory in bf16.
//
// What bounds it on the H100: at B = 8 every step streams the two LSTM
// weight matrices (1792 x 4096 and 2560 x 4096, ~36 MB in bf16) for 8 rows
// of work -- 8 FLOP per weight byte, far below the ~295 FLOP/byte at which
// the tensor cores become the limit. The TPU kernel keeps these weights in
// its 128 MB VMEM for the whole chunk; no SM can (227 KB of shared memory),
// but the 50 MB L2 holds them, so each step reads them from L2.
//
// Design. The chunk is ONE cooperative persistent launch of at most 32
// rows (PC_BMAX): persistent_chunk.cuh with AT = bf16, whose header note
// gives the design. kernels/decoder_batch.py runs a batch of more rows as
// one launch per consecutive slice of rows and a chunk on the CPU through
// the plain version, and refuses fp32 on the card.
#include "persistent_chunk.cuh"

extern "C" {

// Runs cs decoder steps of B <= 32 rows at bf16. h1 / h2 / fin point at
// (2, B, A) / (2, B, D) / (2, B) buffers whose slot 0 holds the incoming
// state; the final state lands in slot cs % 2. Every other carry is
// updated in place. w1f / w2f: the LSTM weights in mma fragment order
// (kernels/lstm_layout.py to_mma_tiles); scratch: decoder_chunk_scratch
// bytes. rounds (host memory, PC_NPH ints, or null) gets the launch's
// rounds of items by phase. Returns a cudaError_t, or the plan's refusal
// (< 0; error_string words it).
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
  return persistent_chunk<bf16>(c, w1f, w2f, scratch, (cudaStream_t)stream,
                                rounds);
}

// Bytes of scratch decoder_chunk takes at these shapes. Returns 0.
int decoder_chunk_scratch(int B, int p, int E, int A, int D, size_t* bytes) {
  *bytes = persistent_scratch(B, p + E + A, A + E + D);
  return 0;
}

// Whether decoder_chunk takes a chunk of min(B, *rows) rows at these
// widths, without a launch (kernels/decoder_batch.py kernel_limits): *rows
// gets the most rows one launch takes; the answer is persistent_limits'.
int decoder_chunk_limits(int B, int T, int n, int p, int E, int A, int D,
                         int datt, int ks, int* rows, size_t* need,
                         int* have) {
  *rows = PC_BMAX;
  return persistent_limits<bf16>(B < PC_BMAX ? B : PC_BMAX, T, n, p, E, A, D,
                                 datt, ks, need, have);
}

const char* error_string(int err) { return pc_error_string(err); }

}  // extern "C"
