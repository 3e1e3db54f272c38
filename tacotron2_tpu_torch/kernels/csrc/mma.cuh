// Shared device code for the port's tensor-core kernels on sm_90a: the
// warp-level mma.sync products, ldmatrix, cp.async, and the split of an
// fp32 value into two TF32 values (3xTF32).
//
// Fragment layouts are PTX's (ISA, "Matrix fragments for mma.m16n8k8" and
// "mma.m16n8k16"): in a warp, lane l has g = l / 4 and t = l % 4.
//   m16n8k8 .tf32  A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//                  B: b0 (k = t, n = g), b1 (k = t+4, n = g)
//   m16n8k16 .bf16 A: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)   (two bf16 in each register)
//                  B: b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (both)       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; src_bytes < 16 zero-fills the
// rest (0: all zeros, the source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements (or 8 rows x 4 32-bit elements):
// lanes 8i..8i+7 give the row addresses of matrix i, which lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed on the way (the B operand of a
// bf16 product from a [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x8, tf32) @ b (8x8, tf32), fp32 sums.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16x16, bf16) @ b (16x8, bf16), fp32 sums: every product of two
// bf16 values is exact in fp32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 (10 mantissa bits; nearest, ties away from zero), as
// the bits of an fp32 value.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 of x, both TF32: the split of 3xTF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
