// Building blocks shared by the flash attention kernels (forward in
// flash_attention.cu, backward in flash_attention_bwd.cu): cp.async copies,
// ldmatrix loads, the bf16 mma.sync m16n8k16 product with f32 accumulation,
// and the padded-row tile load. Every tile in shared memory is row-major
// with rows of D + 8 bf16 (16 bytes of padding), which keeps the eight
// 16-byte rows an ldmatrix reads on distinct banks.
//
// Fragment layouts of mma.sync m16n8k16 (lane = threadIdx.x % 32,
// g = lane / 4, c2 = 2 * (lane % 4)):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a0 (row g, cols c2..), a1 (row g + 8, cols c2..),
//     a2 (row g, cols 8 + c2..), a3 (row g + 8, cols 8 + c2..);
//   C (16 x 8, f32): c0, c1 (row g, cols c2, c2 + 1), c2, c3 (row g + 8).
// So the C fragments of two neighbouring 8-column tiles, packed to bf16,
// are the A fragment of one 16-deep k-step: a product's scores feed the
// next product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;               // rows of the tile a CTA owns
constexpr int BN = 64;               // rows of the tile streamed past it
constexpr int WARPS = BM / 16;       // each warp owns 16 rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16 x 16 block at (row0, col0) of a row-major shared
// tile with row stride LD (x4 load: lanes 0-15 address rows 0-15 at col0,
// lanes 16-31 the same rows at col0 + 8).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int row0, int col0,
                                       int lane) {
  ldmatrix_x4(r, tile + (row0 + lane % 16) * LD + col0 + (lane / 16) * 8);
}

// B fragments of two 8-wide n-tiles from a shared tile stored [n][k]
// (row n, k contiguous): r[0], r[1] for n-tile n0, r[2], r[3] for n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* tile, int n0, int k0,
                                          int lane) {
  ldmatrix_x4(r, tile + (n0 + lane % 8 + (lane / 16) * 8) * LD + k0 + ((lane / 8) % 2) * 8);
}

// B fragments of two 8-wide n-tiles from a shared tile stored [k][n]
// (row k, n contiguous), transposed on load: r[0], r[1] for n-tile n0,
// r[2], r[3] for n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* tile, int k0, int n0,
                                          int lane) {
  ldmatrix_x4_trans(r, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + n0 + (lane / 16) * 8);
}

// C fragments of 8-column tiles 2 kk and 2 kk + 1, packed to bf16: the A
// fragment of k-step kk of the next product
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows [row0, row0 + rows) of a [*, D] slab with row stride `stride`
// elements into a padded shared tile; rows at or past `limit` are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long stride, int row0,
                                          int rows, int limit, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < limit;
    const bf16* g = ok ? src + (row0 + r) * stride + c : src;
    cp_async16(dst + r * (D + 8) + c, g, ok ? 16 : 0);
  }
}

// A warp's 16 rows of f32 fragments (scaled by `mul`), staged as bf16
// through `stage` (16 padded rows) and written with 16-byte stores to rows
// [row0, row0 + 16) of a [*, D] slab with row stride `stride`; rows at or
// past `limit` are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long stride, int row0, int limit,
                                           bf16* stage, const float (&acc)[D / 8][4],
                                           float mul, int lane) {
  constexpr int LD = D + 8;
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + d * 8 + c2) =
        pack_bf16(acc[d][0] * mul, acc[d][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + d * 8 + c2) =
        pack_bf16(acc[d][2] * mul, acc[d][3] * mul);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    if (row0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
  __syncwarp();
}

}  // namespace ptt
