// flash_common.cuh for tools/cpu_rehearsal.py: cp.async as a synchronous
// copy (the rest of the 16 bytes zero-filled); ldmatrix (x2, x4, plain
// and transposed), mma.sync (m16n8k16 bf16, m16n8k8 TF32) and the TF32
// rounding (to nearest, ties away) as warp collectives: each lane posts its
// operands to its warp's exchange, a barrier, each lane computes its own
// fragment, a barrier. Sums run in k order in f32.
#pragma once
#include "cuda_bf16.h"
namespace ptt {
typedef __nv_bfloat16 bf16;
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, 16 - src_bytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline uint16_t stub_elem(const StubWarp& w, int m, int row, int col) {
  return reinterpret_cast<const uint16_t*>(w.addr[8 * m + row])[col];
}
template <int M, bool TRANS>
inline void stub_ldmatrix(uint32_t* r, const void* p) {
  auto& w = stub_warp();
  const int lane = threadIdx.x % 32;
  w.addr[lane] = p;
  w.bar.arrive_and_wait();
  for (int m = 0; m < M; ++m) {
    uint16_t lo, hi;
    if (!TRANS) {
      lo = stub_elem(w, m, lane / 4, 2 * (lane % 4));
      hi = stub_elem(w, m, lane / 4, 2 * (lane % 4) + 1);
    } else {
      lo = stub_elem(w, m, 2 * (lane % 4), lane / 4);
      hi = stub_elem(w, m, 2 * (lane % 4) + 1, lane / 4);
    }
    r[m] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  w.bar.arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { stub_ldmatrix<4, false>(r, p); }
inline void ldmatrix_x2(uint32_t (&r)[2], const void* p) { stub_ldmatrix<2, false>(r, p); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { stub_ldmatrix<4, true>(r, p); }
inline void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) { stub_ldmatrix<2, true>(r, p); }

inline float stub_half(uint32_t reg, int h) {
  return __uint_as_float((h ? (reg >> 16) : (reg & 0xffffu)) << 16);
}
inline void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& w = stub_warp();
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) w.regs[lane][i] = a[i];
  w.regs[lane][4] = b0;
  w.regs[lane][5] = b1;
  w.bar.arrive_and_wait();
  const int g = lane / 4, c2 = 2 * (lane % 4);
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = c2 + e % 2;
    float s = c[e];
    for (int k = 0; k < 16; ++k) {
      const float av = stub_half(w.regs[4 * (row % 8) + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)], k % 2);
      const float bv = stub_half(w.regs[4 * col + (k % 8) / 2][4 + (k >= 8)], k % 2);
      s += av * bv;
    }
    c[e] = s;
  }
  w.bar.arrive_and_wait();
}
inline uint32_t to_tf32(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  return u & ~0x1fffu;
}
inline void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& w = stub_warp();
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) w.regs[lane][i] = a[i];
  w.regs[lane][4] = b0;
  w.regs[lane][5] = b1;
  w.bar.arrive_and_wait();
  const int g = lane / 4, c2 = 2 * (lane % 4);
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = c2 + e % 2;
    float s = c[e];
    for (int k = 0; k < 8; ++k) {
      const float av = __uint_as_float(w.regs[4 * (row % 8) + k % 4][(row >= 8) + 2 * (k >= 4)]);
      const float bv = __uint_as_float(w.regs[4 * col + k % 4][4 + (k >= 4)]);
      s += av * bv;
    }
    c[e] = s;
  }
  w.bar.arrive_and_wait();
}
}  // namespace ptt
