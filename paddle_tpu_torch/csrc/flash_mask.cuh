// The optional masks of the flash kernels (flash_attention.cu,
// flash_attention_bwd.cu): an additive f32 or a bool (one byte) mask of
// [b, hq | 1, sq, sk] read by strides, so that a broadcast dimension (stride
// 0) is never materialised, and int32 segment ids of q [b, sq] and kv [b,
// sk] rows, a pair in different segments being masked. They replace the
// `has_mask` / `has_seg` inputs of the Pallas kernels
// (paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`, `_bwd_fused_kernel`).
// A column that a mask hides gets a score of -inf; the kernels treat a
// pair as unseen exactly when its score is -inf (or the causal / kv_len
// rule hides it), and a row that sees nothing gives zeros and -1e30 ln 2.
// The mask's values are read straight from global memory (L2): at d = 128
// the forward's shared memory is full, and a tile of f32 mask (64 KB)
// could not take a ring stage.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

struct FlashMask {
  enum Kind : int { NONE = 0, ADDITIVE_F32 = 1, BOOL_U8 = 2 };
  const void* mask;     // null with NONE
  const int* q_seg;     // [b, sq] or null (then kv_seg is null too)
  const int* kv_seg;    // [b, sk]
  int kind;
  long long sb, sh, sr; // element strides of the mask's batch, head and row

  // whether any mask or segment ids apply: the kernels then run the
  // masked path on every tile (a separate instantiation)
  __host__ __device__ __forceinline__ bool any() const {
    return kind != NONE || q_seg != nullptr;
  }

  // the offset of the mask's row (b, h, row), in elements
  __device__ __forceinline__ long long row_at(int b, int h, int row) const {
    return b * sb + h * sh + row * sr;
  }

  // the bias of column col of a row at `at` (row_at), in base-2 units
  // (times log2 e): 0 with no mask, -inf where a bool mask is False. KIND
  // is `kind`, fixed by `dispatch`, so that a tile's loads carry no branch
  // and issue together.
  template <int KIND>
  __device__ __forceinline__ float bias2(long long at, int col) const {
    if constexpr (KIND == ADDITIVE_F32)
      return static_cast<const float*>(mask)[at + col] * 1.4426950408889634f;
    else if constexpr (KIND == BOOL_U8)
      return static_cast<const uint8_t*>(mask)[at + col] ? 0.f : -INFINITY;
    else
      return 0.f;
  }

  // the segment id of q row `row` (or kv row) of batch b; 0 without ids,
  // so that every pair matches
  __device__ __forceinline__ int q_id(int b, int sq, int row) const {
    return q_seg != nullptr ? q_seg[(long long)b * sq + row] : 0;
  }
  __device__ __forceinline__ int kv_id(int b, int sk, int col) const {
    return kv_seg != nullptr ? kv_seg[(long long)b * sk + col] : 0;
  }

  // f(kind, segs) with the mask's kind and whether segment ids apply as
  // compile-time constants (std::integral_constant): the launch-uniform
  // choice taken once a tile instead of at every element
  template <class F>
  __device__ __forceinline__ void dispatch(F&& f) const {
    using A = std::integral_constant<int, ADDITIVE_F32>;
    using B = std::integral_constant<int, BOOL_U8>;
    using N = std::integral_constant<int, NONE>;
    using S = std::true_type;
    using U = std::false_type;
    if (kind == ADDITIVE_F32) {
      if (q_seg != nullptr) f(A{}, S{}); else f(A{}, U{});
    } else if (kind == BOOL_U8) {
      if (q_seg != nullptr) f(B{}, S{}); else f(B{}, U{});
    } else {
      f(N{}, S{});   // masked without a mask: segment ids only
    }
  }
};

}  // namespace ptt
