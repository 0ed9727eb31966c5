// mma.sync building blocks shared by the kernels that feed the tensor cores
// from ldmatrix fragments (the int8 / int4 weight-only GEMMs in
// int8_matmul.cu and the chunk-parallel SSM kernels through
// ssm_common.cuh), and cp.async, which the selective scan's forward also
// uses: cp.async copies, an acquire-release atomic, ldmatrix loads (x4 and x2, plain and transposed),
// the bf16 mma.sync m16n8k16 product with f32 accumulation, and the TF32
// m16n8k8 product with its rounding (the SSM kernels' f32 instantiations
// split each f32 operand into two TF32 values). Tiles in shared memory are
// row-major with padded rows (16 bytes of padding keep the eight 16-byte
// rows an ldmatrix reads on distinct banks).
//
// Fragment layouts of mma.sync m16n8k16 (lane = threadIdx.x % 32,
// g = lane / 4, c2 = 2 * (lane % 4)):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (row g, cols c2..), a1 (row g + 8, cols c2..),
//     a2 (row g, cols 8 + c2..), a3 (row g + 8, cols 8 + c2..);
//   C (16 x 8, f32): c0, c1 (row g, cols c2, c2 + 1), c2, c3 (row g + 8).
// and of m16n8k8 in TF32 (c = lane % 4), one f32 register each:
//   A: a0 (row g, col c), a1 (row g + 8, col c), a2 (row g, col c + 4),
//   a3 (row g + 8, col c + 4); B: b0 (row c, col g), b1 (row c + 4, col g);
//   C as above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x as it is, in a register: the compiler may not recompute it from what it
// was computed from (a loop-invariant offset stays hoisted)
__device__ __forceinline__ void opaque(int& x) { asm volatile("" : "+r"(x)); }

// *p += v at the device's scope, ordering this CTA's earlier writes (made
// this thread's by a barrier) before it and its later reads after it;
// returns the old value
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8, row) * b (8x8, col); TF32 in, f32 accumulate
__device__ __forceinline__ void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (to nearest, ties away), as the bits of an f32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

}  // namespace ptt
