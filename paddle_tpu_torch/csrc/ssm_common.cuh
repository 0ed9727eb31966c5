// Building blocks of the chunk-parallel SSM kernels that run their chunk
// products on the tensor cores: the SSD forward and backward (ssd.cu) and
// the WKV backward (wkv.cu).
//
// - mma_tile: one warp's 16 x 8 NT output tiles of a product from tiles in
//   shared memory that hold the I/O type. bf16 tiles go through ldmatrix,
//   one m16n8k16 mma.sync a step. f32 tiles go as split TF32, hi hi + hi lo
//   + lo hi in m16n8k8 products: ~2^-21 of each product, where one TF32
//   product keeps ~2^-11.
// - load_rows / store_rows: CH rows of W values of one head, read from
//   device memory as 16-byte vectors (all of a thread's loads in flight at
//   once) and written to a padded tile. Pad<T> keeps each row a multiple of
//   16 bytes and the eight rows an ldmatrix reads on distinct banks.
// Inline PTX stays in flash_common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace ptt {
namespace ssm {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// two adjacent outputs (p 4-byte aligned for bf16, 8-byte for f32)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// two adjacent values (p 4-byte aligned for bf16, 8-byte for f32) as f32
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four values to p (8-byte aligned for bf16, 16-byte for f32)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T>
struct Pad {
  static constexpr int V = 16 / int(sizeof(T));   // 16 bytes per row
};

// NW warps over a [CH x X] output: WM x WN warps, each 16 rows and X / WN
// columns (8 warps at CH = 64: 4 x 2; at CH = 32: 2 x 4).
template <int CH, int NW = 8>
struct Warps {
  static constexpr int WM = CH / 16, WN = NW / WM;
};

// acc[nt] += A[m0 .. m0 + 16, k] B[k, n0 + 8 nt ..] over k < K. A is stored
// [m][k] (AT false) or [k][m] (AT true) with row stride lda, B [n][k] (BT
// false) or [k][n] (BT true) with ldb.
template <int K, int NT, bool AT, bool BT>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int m0, int n0, int lane) {
  const int r = lane % 8, mi = lane / 8, l2 = lane % 16;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    if (AT) ldmatrix_x4_trans(a, A + (k0 + r + 8 * (mi / 2)) * lda + m0 + 8 * (mi % 2));
    else ldmatrix_x4(a, A + (m0 + lane % 16) * lda + k0 + 8 * (lane / 16));
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      if (nt + 1 < NT) {
        uint32_t b[4];
        if (BT) ldmatrix_x4_trans(b, B + (k0 + r + 8 * (mi % 2)) * ldb + n0 + 8 * (nt + mi / 2));
        else ldmatrix_x4(b, B + (n0 + 8 * (nt + mi / 2) + r) * ldb + k0 + 8 * (mi % 2));
        mma16816(acc[nt], a, b[0], b[1]);
        mma16816(acc[nt + 1], a, b[2], b[3]);
      } else {
        uint32_t b[2];
        if (BT) ldmatrix_x2_trans(b, B + (k0 + l2) * ldb + n0 + 8 * nt);
        else ldmatrix_x2(b, B + (n0 + 8 * nt + l2 % 8) * ldb + k0 + 8 * (l2 / 8));
        mma16816(acc[nt], a, b[0], b[1]);
      }
    }
  }
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the f32 version: k slots c and c + 4 of an m16n8k8 product hold the k
// positions 2c and 2c + 1 (of A and B alike, so the sum is the same)
template <int K, int NT, bool AT, bool BT>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4], const float* A, int lda,
                                         const float* B, int ldb, int m0, int n0, int lane) {
  const int g = lane / 4, c2 = 2 * (lane % 4);
  auto at = [&](int m, int k) { return AT ? A[k * lda + m] : A[m * lda + k]; };
  auto bt = [&](int k, int n) { return BT ? B[k * ldb + n] : B[n * ldb + k]; };
#pragma unroll 2
  for (int k = c2; k < K; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(at(m0 + g, k), ah[0], al[0]);
    split_tf32(at(m0 + g + 8, k), ah[1], al[1]);
    split_tf32(at(m0 + g, k + 1), ah[2], al[2]);
    split_tf32(at(m0 + g + 8, k + 1), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bt(k, n0 + 8 * nt + g), bh0, bl0);
      split_tf32(bt(k + 1, n0 + 8 * nt + g), bh1, bl1);
      mma1688_tf32(acc[nt], al, bh0, bh1);
      mma1688_tf32(acc[nt], ah, bl0, bl1);
      mma1688_tf32(acc[nt], ah, bh0, bh1);
    }
  }
}

// Rows [t0, t0 + CH) of one head's W values (token stride `stride`, the
// head's first column `col0`) as 16-byte vectors, zero past `len`: vector
// `it` of a thread is vector (it NTH + tid) of the [CH][W] block, for NTH
// threads. Rows and columns must be 16-byte aligned (the wrappers copy any
// that are not).
template <int CH, int W, typename T, int NTH = 256>
struct RowVecs {
  static constexpr int E = 16 / int(sizeof(T)), VPR = W / E, TOTAL = CH * VPR;
  static constexpr int IT = (TOTAL + NTH - 1) / NTH;
  static constexpr bool EXACT = TOTAL % NTH == 0;
};

template <int CH, int W, int NTH = 256, typename T>
__device__ __forceinline__ void load_rows(uint4 (&v)[RowVecs<CH, W, T, NTH>::IT],
                                          const T* __restrict__ src, size_t row0, long stride,
                                          long col0, int len) {
  using R = RowVecs<CH, W, T, NTH>;
#pragma unroll
  for (int it = 0; it < R::IT; ++it) {
    const int i = it * NTH + threadIdx.x, t = i / R::VPR;
    v[it] = (R::EXACT || i < R::TOTAL) && t < len
                ? *reinterpret_cast<const uint4*>(src + (row0 + t) * stride + col0
                                                  + (i % R::VPR) * R::E)
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the vectors of load_rows into dst[CH][ld]
template <int CH, int W, int NTH = 256, typename T>
__device__ __forceinline__ void store_rows(T* dst, int ld,
                                           const uint4 (&v)[RowVecs<CH, W, T, NTH>::IT]) {
  using R = RowVecs<CH, W, T, NTH>;
#pragma unroll
  for (int it = 0; it < R::IT; ++it) {
    const int i = it * NTH + threadIdx.x;
    if (R::EXACT || i < R::TOTAL)
      *reinterpret_cast<uint4*>(dst + (i / R::VPR) * ld + (i % R::VPR) * R::E) = v[it];
  }
}

// sum of a o b over the elements of two vectors
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 16 / int(sizeof(T)); ++e) s += to_f(x[e]) * to_f(y[e]);
  return s;
}

}  // namespace ssm
}  // namespace ptt
