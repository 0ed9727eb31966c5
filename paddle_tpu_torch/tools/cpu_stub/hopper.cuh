// hopper.cuh for tools/cpu_rehearsal.py: the shared-memory opt-in,
// ex2.approx (as exp2f), and what the TMA- and wgmma-fed kernels use, on
// the stand-in's model of one std::thread per CUDA thread:
// - mbarriers as one atomic word in shared memory (pending arrivals, the
//   arrival count, pending transaction bytes, the phase bit), completing a
//   phase when both reach 0; waits yield until the phase of their parity
//   has completed;
// - 4-D TMA loads and stores as synchronous copies at issue,
//   through a map that `encode_tma` fills: elements outside the tensor
//   zero-fill a load (and still count their bytes) and are dropped by a
//   store; the 128-, 64- and 32-byte swizzles as the card's (16-byte chunk
//   bits [4, 4 + B) of the shared-memory offset XOR its bits [7, 7 + B));
// - named barriers over `count` threads (bar.arrive counted among them);
// - wgmma as a warpgroup collective: each thread computes its own
//   accumulator elements from the operands' descriptors (start, LBO, SBO
//   and swizzle decoded as the card reads them, K- or MN-major), the RS
//   form's A gathered from the warpgroup's registers through an exchange,
//   and no thread leaves before all have read their operands; sums in k
//   order in f32;
// - fences, commits, waits and setmaxnreg as no-ops (every product and copy
//   has landed when it returns).
#pragma once
#include <atomic>
#include <cassert>
#include <mutex>
#include <thread>
#include "cuda_runtime.h"
#include "cuda_bf16.h"

enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_SWIZZLE_128B };
struct alignas(64) CUtensorMap {
  const unsigned char* base;
  int rank, elem, swizzle;   // swizzle: B of the XOR (3: 128 bytes, 2: 64, 1: 32, 0: none)
  uint64_t dims[5], strides[5];   // strides in bytes, strides[0] = elem
  uint32_t box[5];
};

namespace ptt {
template <class K> inline cudaError_t allow_smem(K, int, std::atomic<uint64_t>&) { return 0; }
namespace sm90 {
inline float ex2_approx(float x) { return exp2f(x); }

inline uint32_t smem_u32(const void* p) {
  return uint32_t(static_cast<const unsigned char*>(p) - smem_raw);
}
// the swizzled shared-memory offset of byte offset `a` (B: 3, 2, 1 or 0)
inline uint32_t stub_swizzle(uint32_t a, int B) {
  return B ? a ^ (((a >> 7) & ((1u << B) - 1)) << 4) : a;
}

// ------------------------------------------------------------------ mbarrier
// bits 0-20 pending arrivals, 21-41 the count, 42-62 pending bytes, 63 phase
constexpr uint64_t STUB_M21 = (uint64_t(1) << 21) - 1;
inline std::atomic_ref<uint64_t> stub_bar(uint64_t* bar) { return std::atomic_ref<uint64_t>(*bar); }
inline void mbar_init(uint64_t* bar, uint32_t count) {
  stub_bar(bar).store(uint64_t(count) | uint64_t(count) << 21);
}
inline void mbar_fence_init() {}
// arrivals `n` (0 or 1) and transaction bytes `tx` (+ expected, - landed)
inline void stub_bar_update(uint64_t* bar, int n, long tx) {
  auto a = stub_bar(bar);
  uint64_t old = a.load();
  for (;;) {
    const uint64_t count = (old >> 21) & STUB_M21, phase = old >> 63;
    long pend = long(old & STUB_M21) - n;
    long bytes = long((old >> 42) & STUB_M21) + tx;
    if (pend < 0 || bytes < 0) {
      std::fprintf(stderr, "mbarrier: %ld arrivals, %ld bytes pending\n", pend, bytes);
      std::abort();
    }
    uint64_t nw;
    if (pend == 0 && bytes == 0)
      nw = count | count << 21 | (phase ^ 1) << 63;
    else
      nw = uint64_t(pend) | count << 21 | uint64_t(bytes) << 42 | phase << 63;
    if (a.compare_exchange_weak(old, nw)) return;
  }
}
inline void mbar_arrive(uint64_t* bar) { stub_bar_update(bar, 1, 0); }
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) { stub_bar_update(bar, 1, long(bytes)); }
inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  if ((stub_bar(bar).load() >> 63) != parity) return true;
  std::this_thread::yield();
  return false;
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ----------------------------------------------------------------------- TMA
inline cudaError_t encode_tma(CUtensorMap* map, CUtensorMapDataType, const void* base, int rank,
                              const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                              CUtensorMapL2promotion, CUtensorMapSwizzle swizzle) {
  map->base = static_cast<const unsigned char*>(base);
  map->rank = rank;
  map->elem = 2;
  map->swizzle = swizzle == CU_TENSOR_MAP_SWIZZLE_128B  ? 3
                 : swizzle == CU_TENSOR_MAP_SWIZZLE_64B ? 2
                 : swizzle == CU_TENSOR_MAP_SWIZZLE_32B ? 1
                                                        : 0;
  for (int i = 0; i < rank; ++i) {
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    map->strides[i] = i == 0 ? 2 : strides[i - 1];
  }
  // the card's rules: 16-byte strides, the inner box within the swizzle span
  for (int i = 1; i < rank; ++i)
    if (map->strides[i] % 16) return cudaErrorInvalidValue;
  if (map->swizzle && box[0] * 2 > (16u << map->swizzle)) return cudaErrorInvalidValue;
  return cudaSuccess;
}
inline cudaError_t encode_tma_bf16(CUtensorMap* map, const void* base, int rank,
                                   const uint64_t* dims, const uint64_t* strides,
                                   const uint32_t* box) {
  return encode_tma(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_SWIZZLE_128B);
}
// the box at `c` between global memory and shared memory at `smem`; `load`:
// global -> shared (zero fill outside), else shared -> global (clipped).
// Returns the box's bytes.
inline long stub_tma(const CUtensorMap* map, void* smem, const int* c, bool load) {
  const int r = map->rank;
  uint32_t n[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < r; ++i) n[i] = map->box[i];
  const uint32_t off0 = smem_u32(smem);
  long at = 0;
  for (uint32_t i4 = 0; i4 < n[4]; ++i4)
    for (uint32_t i3 = 0; i3 < n[3]; ++i3)
      for (uint32_t i2 = 0; i2 < n[2]; ++i2)
        for (uint32_t i1 = 0; i1 < n[1]; ++i1)
          for (uint32_t i0 = 0; i0 < n[0]; ++i0, at += map->elem) {
            const uint32_t idx[5] = {i0, i1, i2, i3, i4};
            bool in = true;
            long g = 0;
            for (int d = 0; d < r; ++d) {
              const long x = long(c[d]) + idx[d];
              in = in && x >= 0 && x < long(map->dims[d]);
              g += x * long(map->strides[d]);
            }
            unsigned char* s = smem_raw + stub_swizzle(off0 + uint32_t(at), map->swizzle);
            if (load) {
              if (in)
                std::memcpy(s, map->base + g, map->elem);
              else
                std::memset(s, 0, map->elem);
            } else if (in) {
              std::memcpy(const_cast<unsigned char*>(map->base) + g, s, map->elem);
            }
          }
  return at;
}
inline void tma_prefetch(const CUtensorMap*) {}
inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                        int c3) {
  const int c[4] = {c0, c1, c2, c3};
  stub_bar_update(bar, 0, -stub_tma(map, dst, c, true));
}
inline void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                         int c3) {
  const int c[4] = {c0, c1, c2, c3};
  stub_tma(map, const_cast<void*>(src), c, false);
}
inline void tma_store_commit() {}
template <int N> inline void tma_store_wait_read() {}

// ------------------------------------------------------------ fences, sync
inline void fence_proxy_async() {}
inline std::barrier<>& stub_named(int id, int threads) {
  std::lock_guard<std::mutex> g(g_block->mu);
  auto& b = g_block->named[id];
  if (!b) b = std::make_unique<std::barrier<>>(threads);
  return *b;
}
inline void named_barrier(int id, int threads) { stub_named(id, threads).arrive_and_wait(); }
inline void named_barrier_arrive(int id, int threads) { (void)stub_named(id, threads).arrive(); }
struct PingPong {
  int wg, bar;
  void start() const {
    if (wg == 1) named_barrier_arrive(bar, 256);
  }
  void begin() const { named_barrier(bar + wg, 256); }
  void end() const { named_barrier_arrive(bar + 1 - wg, 256); }
  void finish() const {
    if (wg == 0) named_barrier(bar, 256);
  }
};
template <int REGS> inline void setmaxnreg_inc() {}
template <int REGS> inline void setmaxnreg_dec() {}

// --------------------------------------------------------------------- wgmma
template <int ROW>
inline uint64_t desc_sw(const void* p, uint32_t lbo) {
  constexpr uint64_t layout = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t((8 * ROW) >> 4) << 32) | (layout << 62);
}
inline uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}
inline uint64_t desc_k_major(const void* p) { return desc_sw128(p, 16, 1024); }
inline uint64_t desc_mn_major(const void* p, uint32_t panel) { return desc_sw128(p, panel, 1024); }
inline uint64_t desc_advance(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }
inline uint64_t desc_opaque(uint64_t desc) { return desc; }
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
template <int N> inline void fence_operand(float (&)[N]) {}
template <int N> inline void fence_operand(uint32_t (&)[N][4]) {}

// element (mn, k) of a 64 x 16 (A) or 16 x N (B) operand as the card reads
// it through `desc`: K-major, row mn at column k; MN-major, row k at column
// mn (panels of ROW / 2 elements LBO bytes apart)
inline float stub_operand(uint64_t desc, bool mn_major, int mn, int k) {
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t lbo = uint32_t((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  const int layout = int(desc >> 62);
  assert(layout != 0);
  const int B = layout == 1 ? 3 : layout == 2 ? 2 : 1;
  const uint32_t row = 16u << B;
  uint32_t a;
  if (!mn_major) {
    a = start + (mn / 8) * sbo + (mn % 8) * row + 2 * k;
  } else {
    const uint32_t cols = row / 2;
    a = start + (k / 8) * sbo + (k % 8) * row + (mn / cols) * lbo + (mn % cols) * 2;
  }
  uint16_t v;
  std::memcpy(&v, smem_raw + stub_swizzle(a, B), 2);
  return __uint_as_float(uint32_t(v) << 16);
}
// this thread's elements of d (64 x N) = A B (+ d): A(row, k) from `a`
template <int N, class A>
inline void stub_wgmma(float (&d)[N / 2], A&& a, uint64_t desc_b, int tb, int scale_d) {
  const int t = threadIdx.x % 128;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2);
      const int col = 8 * j + 2 * (t % 4) + (e & 1);
      float s = scale_d ? d[4 * j + e] : 0.f;
      for (int k = 0; k < 16; ++k) s += a(row, k) * stub_operand(desc_b, tb, col, k);
      d[4 * j + e] = s;
    }
}
// Both forms end on the warpgroup's barrier: on the card the warpgroup
// issues a wgmma together and a wait returns once all its threads' operands
// are read, so a leader that frees a buffer after its wait frees it for all.
template <int N, int TA, int TB>
inline void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  stub_wgmma<N>(d, [&](int row, int k) { return stub_operand(desc_a, TA, row, k); }, desc_b, TB,
                scale_d);
  stub_group().bar.arrive_and_wait();
}
template <int N, int TB>
inline void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  StubGroup& g = stub_group();
  const int t = threadIdx.x % 128;
  for (int i = 0; i < 4; ++i) g.regs[t][i] = a[i];
  g.bar.arrive_and_wait();
  // A(row, k): row 16 w + g + 8 h, k 8 hk + 2 c + e held by thread 32 w + 4 g
  // + c in register h + 2 hk, the low half for e = 0
  stub_wgmma<N>(d, [&](int row, int k) {
    const int w = row / 16, gr = row % 8, h = (row % 16) / 8, hk = k / 8, c = (k % 8) / 2;
    const uint32_t r = g.regs[32 * w + 4 * gr + c][h + 2 * hk];
    return __uint_as_float(((k & 1) ? r >> 16 : r & 0xffffu) << 16);
  }, desc_b, TB, scale_d);
  g.bar.arrive_and_wait();
}
inline uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return uint32_t(v.x.v) | uint32_t(v.y.v) << 16;
}
template <int N>
inline void pack_a_rs(uint32_t (&a)[4], const float (&d)[N], int kk) {
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16x2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}
}  // namespace sm90
}  // namespace ptt
