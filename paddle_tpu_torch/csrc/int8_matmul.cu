// Weight-only int8 / int4 GEMMs for Hopper (sm_90a): out = (x @ dequant(w)) *
// scale, bf16 activations, f32 accumulation, the per-column scale applied
// once at the end.
//
// Replace the TPU kernels paddle_tpu/ops/pallas/int8_matmul.py
// `int8_weight_matmul` (pl.pallas_call at :143, body `_kernel` :46) and
// `int4_weight_matmul` (:197, body `_kernel_int4` :65).
//
// What they compute: x [M, K] bf16 (M <= 256, row-major), scale [N] f32 and
//   int8: w [K, N] int8, out[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n];
//   int4: w [K/2, N] int8 in the half-split layout of `pack_int4`, each
//     byte r holding q[r] in its low nibble and q[r + K/2] in its high one:
//     out[m, n] = (sum_r x[m, r] * lo(w[r, n]) + x[m, r + K/2] *
//     hi(w[r, n])) * scale[n], lo = ((b & 15) ^ 8) - 8, hi = b >> 4
//     (arithmetic shift of the signed byte).
// The accumulator is f32; it is multiplied by the f32 scale and then cast to
// the output type (bf16 or f32), in the order of `_kernel`'s store. Every
// int8 and int4 value is a bf16, so the dequantized operand is exact.
//
// Work plan, both kernels: one launch per product. The product is cut into
// column tiles and k steps (a fixed number of weight rows); its (tile,
// step) units, tile-major (u = tile * steps + step), are split evenly over
// a fixed grid of P CTAs sized from the SM count (stream-K): CTA c takes
// units [floor(c U / P), floor((c + 1) U / P)), so every SM streams the same
// weight bytes (within one step) whatever N is, with no wave tail and no
// short CTAs. The decode kernel takes a smaller grid where that makes every
// share equal and a divisor of a tile's steps (k-aligned: its CTAs stream
// the same weight rows at once, which the memory serves faster). A CTA's
// run of units inside one tile is a segment. A segment that covers its
// whole tile is scaled and stored at once. The segments of a shared tile
// (its contributors: the CTAs c_first..c_last whose ranges meet it) meet
// in one of two ways, both in the order c_first..c_last, so repeats are
// bitwise equal:
// - k-aligned shares, at most 8 to a tile (decode kernel): the
//   contributors are one thread block cluster. Each leaves its sums in its
//   own shared memory; after a cluster barrier, rank j sums registers r =
//   j, j + n, ... of every rank (distributed shared memory), scales and
//   stores them. (Llama-3-8B `out` at M = 8 on an H100: 0.0173 ms against
//   0.0188 through the fix-up; tools/weight_only_compare.py.)
// - otherwise (the last-CTA fix-up): each writes its f32 sums to a scratch
//   slot (two per CTA: the tile it starts in, the tile it ends in),
//   fences, and adds one to the tile's counter; the CTA that brings the
//   counter to the contributor count sums the slots, scales, stores, and
//   sets the counter back to 0 for the next launch.
// No CTA waits for another outside its cluster.
//
// 1. wo_gemm_kernel: the memory-bound regime (decode, M <= 64). Bounded by
//    the weight's bytes (K N, or K N / 2 for int4): 16 operations per int8
//    byte at M = 8, against the card's ~295. The design keeps every SM
//    streaming weight bytes:
//    - Warp specialisation: 4 consumer warps and 1 producer warp, two CTAs
//      an SM (the host plans the grid from the occupancy the library
//      reports). The producer keeps a ring of 3 stages full (measured
//      against 2, 4 and 8 stages at one CTA an SM: tools/
//      weight_only_variants.py): per k step (64 weight rows:
//      64 k, or 128 k of packed int4) it waits for the stage's empty
//      mbarrier, arms its full barrier with the step's bytes, issues one
//      TMA box (128 columns x 64 rows, the 128-byte swizzle) for the weight
//      and 16-byte cp.async copies of x's row segments (rows padded by 16
//      bytes), which arrive on the same barrier. The weight's tensor map is
//      encoded once per weight tensor and cached by the host (weights do
//      not move); x changes every call, so it takes no map. The consumers
//      wait on the full barrier only, never on __syncthreads. (One 1-D
//      bulk copy per 128-byte row segment instead of the box is bound by
//      the copies' issue rate, far below the memory's.)
//    - The weight is the A operand of mma.sync m16n8k16 (out^T = W^T x^T):
//      the tile's 128 columns fill A's 16-row side, the rows of x B's
//      8-wide side, so M = 8 pads nothing. Warp w owns columns [32 w, 32 w
//      + 32) of the tile; lane (g = lane / 4, t = lane % 4) loads 4 bytes,
//      columns 32 w + 4 g .. + 3, from rows 2t, 2t+1, 2t+8, 2t+9 of each
//      16-row slice (conflict-free through the swizzle). Column 4 g + 2 i
//      (+ 1) is row g (g + 8) of A tile i, so the bytes of rows k and k + 1
//      at one column are one A register
//      (k, k + 1): dequantized in registers, never through shared memory.
//      int8: a prmt puts a byte under the exponent 0x4B (the f32 2^23 +
//      byte, exact), an f32 subtract, a prmt packs two results' upper
//      halves as bf16. int4: a prmt pairs rows k and k + 1, then per pair of
//      nibbles one lop3 ((b & 0xF) ^ 8 under the bf16 exponent 0x43: 128 +
//      q + 8) and one fma.bf16x2 (x 1 - 136). A packed row p holds k = p
//      and k = p + K/2, so each loaded word feeds two k16 products, against
//      x's columns 64 s.. and K/2 + 64 s...
//      Columns 4 g + 2 i and + 1 land in one thread's C registers, so the
//      store is a pair and the permutation costs nothing.
//    - x's B fragments: ldmatrix.x2 of 8-row tiles (MT = ceil(M / 8)).
// 2. wo_gemm_wgmma_kernel: the compute-bound regime (prefill buckets, 64 <
//    M <= 256). Bounded by operations (2 M K N: 512 per int8 byte at M =
//    256). Only wgmma reaches the tensor cores' rate.
//    - 2 consumer warpgroups (232 registers, setmaxnreg) and a producer
//      warpgroup (40). One CTA takes every row of
//      x (up to 256: two 64-row blocks a warpgroup) for a 128-wide column
//      tile (a 256-wide one when M <= 128), so each weight tile is read and
//      dequantized once.
//    - One producer thread streams the step's weight rows (64 int8 rows, or
//      32 packed int4 rows = 64 k) by TMA boxes of 128 columns and x's 64 k
//      columns as two boxes of 32 (64-byte rows, the 64-byte swizzle; int8:
//      k 64 s.. and 64 s + 32..; int4: the halves' 32 s.. and K/2 + 32 s..)
//      into a 4-stage ring, rows past M zero-filled. x changes every call,
//      so the host encodes its map once per (M, K) shape, and the producer
//      warp points a copy of it at the launch's x (tensormap.replace in
//      shared memory, copied to the CTA's slot in device memory with a
//      release of the tensor-map proxy, acquired before the first load):
//      the host encodes nothing per call.
//    - The consumers dequantize the stage's weight once into a bf16 tile in
//      the 128-byte swizzle, MN-major (B with the transpose bit), double
//      buffered, and run wgmma from shared memory (x K-major as TMA wrote
//      it). The conversion of step i runs while step i - 1's wgmma group is
//      in flight; one named barrier a step orders the converted tile before
//      the products, and every warpgroup's step i - 1 products before the
//      tile they read is overwritten; a stage is released once the products
//      that read its x have completed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using ptt::bf16;
namespace hw = ptt::sm90;

// ------------------------------------------------------------- work plan
__device__ __forceinline__ long unit_begin(long U, int P, int c) { return long(c) * U / P; }
// the CTA whose units hold unit u: the largest c with unit_begin(c) <= u
__device__ __forceinline__ int cta_of(long u, long U, int P) {
  return int(((u + 1) * P - 1) / U);
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// The fix-up of a tile that several CTAs share (the note at the top). The
// NT consumer threads (ctid 0..NT-1) meet at named barrier 1; acc holds A x
// B floats a thread. Returns true in the CTA that completes the tile, whose
// acc then holds the tile's full sums. It gathers the slots G contributors
// at a time, all their loads in flight together (G x A x B <= 32 floats, so
// the fix-up does not raise the kernel's registers), so a tile of 4
// contributors at M <= 8 costs one round trip to L2, not 4.
template <int NT, int A, int B>
__device__ bool fixup(float (&acc)[A][B], float* __restrict__ ws, int* __restrict__ flags,
                      int* bcast, int tile, int steps, long U, int P, int ctid) {
  constexpr int R = A * B;
  constexpr int G = R >= 32 ? 1 : 32 / R;
  const long t0 = long(tile) * steps;
  const int first = cta_of(t0, U, P), last = cta_of(t0 + steps - 1, U, P);
  auto slot = [&](int cc) {
    return ws + (long(2 * cc + (unit_begin(U, P, cc) >= t0 ? 0 : 1)) * R) * NT + ctid;
  };
  float* mine = slot(blockIdx.x);
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b) __stcg(mine + (a * B + b) * NT, acc[a][b]);
  __threadfence();
  hw::named_barrier(1, NT);
  if (ctid == 0) *bcast = atomicAdd(flags + tile, 1);
  hw::named_barrier(1, NT);
  if (*bcast != last - first) return false;
  __threadfence();
  if (ctid == 0) flags[tile] = 0;
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[a][b] = 0.f;
  if constexpr (G == 1) {
    for (int cc = first; cc <= last; ++cc) {
      const float* p = slot(cc);
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b) acc[a][b] += __ldcg(p + (a * B + b) * NT);
    }
    return true;
  }
  for (int c0 = first; c0 <= last; c0 += G) {
    float v[G][A][B];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (c0 + i > last) break;
      const float* p = slot(c0 + i);
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b) v[i][a][b] = __ldcg(p + (a * B + b) * NT);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (c0 + i > last) break;
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < B; ++b) acc[a][b] += v[i][a][b];
    }
  }
  return true;
}

template <typename OutT>
__device__ __forceinline__ void store1(OutT* p, float a);
template <>
__device__ __forceinline__ void store1<bf16>(bf16* p, float a) {
  *p = __float2bfloat16(a);
}
template <>
__device__ __forceinline__ void store1<float>(float* p, float a) {
  *p = a;
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float a, float b);
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ------------------------------------------------------------ conversions
// byte j of r0 (row k) and of r1 (row k + 1), both already biased by 128
// (^ 0x80808080), as the bf16 pair (k, k + 1): 0x4B0000uu is the f32
// 2^23 + uu; the difference is an integer of at most 8 significant bits,
// so its upper half is its exact bf16
__device__ __forceinline__ uint32_t i8_pair(uint32_t r0, uint32_t r1, int j) {
  const float base = 8388608.f + 128.f;
  const float f0 = __uint_as_float(__byte_perm(r0, 0x4B000000u, 0x7440 + j)) - base;
  const float f1 = __uint_as_float(__byte_perm(r1, 0x4B000000u, 0x7440 + j)) - base;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// the nibbles in bits 0-3 and 16-19 of u as a bf16 pair: 0x4300 | (nibble
// ^ 8) is 128 + q + 8 (q the signed nibble), times 1 minus 136 is q
constexpr uint32_t NIB_MASK = 0x000F000Fu, NIB_MAGIC = 0x43084308u;
constexpr uint32_t BF16_ONE = 0x3F803F80u, BF16_M136 = 0xC308C308u;
__device__ __forceinline__ uint32_t nib_pair(uint32_t u) {
  return hw::fma_bf16x2((u & NIB_MASK) ^ NIB_MAGIC, BF16_ONE, BF16_M136);
}

// Columns j, j + 1 (j = 0 or 2) of words p0 (packed row p) and p1 (row
// p + 1) as four bf16 pairs (k, k + 1): the low nibbles of column j and of
// j + 1 (k = p, p + 1) and the high ones (k = K/2 + p, K/2 + p + 1).
__device__ __forceinline__ void i4_pairs(uint32_t p0, uint32_t p1, int j, uint32_t& lo0,
                                         uint32_t& lo1, uint32_t& hi0, uint32_t& hi1) {
  // bytes p0[j], p0[j + 1], p1[j], p1[j + 1]
  const uint32_t v = __byte_perm(p0, p1, j == 0 ? 0x5410 : 0x7632);
  lo0 = nib_pair(v);
  lo1 = nib_pair(v >> 8);
  hi0 = nib_pair(v >> 4);
  hi1 = nib_pair(v >> 12);
}

// Byte offset of (row r, column c) in a weight stage as TMA writes it:
// panels of 128 columns (`panel` bytes each), rows of 128 bytes, the 16-byte
// chunk j of row r at j ^ (r % 8) (the 128-byte swizzle)
__device__ __forceinline__ int wsw(int r, int c, int panel) {
  return (c / 128) * panel + r * 128 + ((((c % 128) / 16) ^ (r % 8)) * 16) + c % 16;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int BYTES>
__device__ __forceinline__ void load_cols(uint32_t (&v)[BYTES / 4], const uint8_t* p) {
  if constexpr (BYTES == 4) {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (BYTES == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

// ------------------------------------------------- 1. the decode kernel
constexpr int WROWS = 64;                  // weight rows a k step (int4: packed rows)
constexpr int D_BN = 128;                  // columns a tile
constexpr int D_CW = 4;                    // consumer warps
constexpr int D_STAGES = 3;                // the ring's depth, at most (what fits)
constexpr int D_OCC = 2;                   // CTAs per SM the ring is sized for
constexpr int D_SMEM = 232448 / D_OCC - 1024;  // shared memory a CTA may take
constexpr int D_CPG = D_BN / (D_CW * 8);   // columns (bytes) a lane group loads
constexpr int D_NT = D_CPG / 2;            // A tiles (16 columns) a warp
constexpr int W_PANEL = WROWS * 128;       // a 128-column panel of a weight stage
// the weight maps' L2 promotion: one 128-byte row of a box, no more (a
// wider promotion fetches the next tile's columns, read by another CTA
// long after they left L2)
constexpr CUtensorMapL2promotion W_L2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
constexpr int D_THREADS = (D_CW + 1) * 32;
static_assert(D_CPG == 4 || D_CPG == 8 || D_CPG == 16, "4, 8 or 16 bytes a lane group");

template <int MT, bool INT4>
struct DecodeLayout {
  static constexpr int XB = INT4 ? 256 : 128;  // bytes of an x row a step
  static constexpr int XLD = XB + 16;          // its padded stride
  static constexpr int W_BYTES = WROWS * D_BN;  // D_BN / 128 panels
  static constexpr int STAGE = W_BYTES + (8 * MT * XLD + 1023) / 1024 * 1024;
  static constexpr int FIT = (D_SMEM - 1024 - 16) / (STAGE + 16);
  static constexpr int STAGES = FIT < D_STAGES ? FIT : D_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + 16;
  static_assert(STAGES >= 2, "shared memory");
};

// One stage's products: weight rows [0, 64) of the stage against x's k
// columns (int4: the low and high halves).
template <int MT, bool INT4>
__device__ __forceinline__ void decode_stage(float (&acc)[D_NT * MT][4], const uint8_t* wst,
                                             const uint8_t* xst, int cb, int lane) {
  using L = DecodeLayout<MT, INT4>;
  const int t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < WROWS / 16; ++kk) {
    uint32_t r[4][D_CPG / 4];
    const int k = 16 * kk + 2 * t;
    load_cols<D_CPG>(r[0], wst + wsw(k, cb, W_PANEL));
    load_cols<D_CPG>(r[1], wst + wsw(k + 1, cb, W_PANEL));
    load_cols<D_CPG>(r[2], wst + wsw(k + 8, cb, W_PANEL));
    load_cols<D_CPG>(r[3], wst + wsw(k + 9, cb, W_PANEL));
    // B fragments: rows 8 mt + lane % 8, k columns 16 kk (+ 8) (int4: of the
    // low half; the high half 128 bytes further on)
    uint32_t b[MT][2], bh[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* xr = xst + (8 * mt + lane % 8) * L::XLD + (16 * kk + 8 * ((lane / 8) % 2)) * 2;
      ptt::ldmatrix_x2(b[mt], xr);
      if constexpr (INT4) ptt::ldmatrix_x2(bh[mt], xr + 128);
    }
    if constexpr (!INT4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < D_CPG / 4; ++v) r[q][v] ^= 0x80808080u;
#pragma unroll
      for (int i = 0; i < D_NT; ++i) {
        const int v = (2 * i) / 4, j = (2 * i) % 4;
        const uint32_t a[4] = {i8_pair(r[0][v], r[1][v], j), i8_pair(r[0][v], r[1][v], j + 1),
                               i8_pair(r[2][v], r[3][v], j), i8_pair(r[2][v], r[3][v], j + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ptt::mma16816(acc[i * MT + mt], a, b[mt][0], b[mt][1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < D_NT; ++i) {
        const int v = (2 * i) / 4, j = (2 * i) % 4;
        uint32_t lo[4], hi[4];
        i4_pairs(r[0][v], r[1][v], j, lo[0], lo[1], hi[0], hi[1]);
        i4_pairs(r[2][v], r[3][v], j, lo[2], lo[3], hi[2], hi[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ptt::mma16816(acc[i * MT + mt], lo, b[mt][0], b[mt][1]);
          ptt::mma16816(acc[i * MT + mt], hi, bh[mt][0], bh[mt][1]);
        }
      }
    }
  }
}

// grid: P CTAs (the plan); ws: 2 P slots of 8 MT x D_BN floats; flags:
// N / D_BN counters, all 0 between launches
template <int MT, bool INT4, typename OutT>
__global__ void __launch_bounds__(D_THREADS, D_OCC)
wo_gemm_kernel(const __grid_constant__ CUtensorMap wmap, const int8_t* __restrict__ w,
               const bf16* __restrict__ x,
               const float* __restrict__ scale, OutT* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ flags, int M, int K, int N, int steps) {
  using L = DecodeLayout<MT, INT4>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::STAGES * L::STAGE);
  uint64_t* empty = full + L::STAGES;
  int* bcast = reinterpret_cast<int*>(empty + L::STAGES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      hw::mbar_init(&full[s], 33);  // the TMA's expect_tx and each producer lane's cp.async
      hw::mbar_init(&empty[s], D_CW);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int P = gridDim.x;
  const long U = long(N / D_BN) * steps;
  const long u0 = unit_begin(U, P, blockIdx.x), u1 = unit_begin(U, P, blockIdx.x + 1);
  const uint32_t ncl = hw::cluster_size();  // > 1: the tile's contributors
  int stage = 0;
  uint32_t phase = 0;

  if (warp == D_CW) {  // producer
    if (lane == 0) hw::tma_prefetch(&wmap);
    constexpr int XC = L::XB / 16;  // 16-byte chunks of an x row a step
    for (long u = u0; u < u1; ++u) {
      const int tile = int(u / steps), s = int(u % steps);
      hw::mbar_wait(&empty[stage], phase ^ 1);
      uint64_t* bar = &full[stage];
      uint8_t* st = smem + stage * L::STAGE;
      if (lane == 0) {
        hw::mbar_expect_tx(bar, WROWS * D_BN);
#pragma unroll
        for (int j = 0; j < D_BN / 128; ++j)
          hw::tma_load_2d(st + j * W_PANEL, &wmap, bar, tile * D_BN + 128 * j, s * WROWS);
      }
      uint8_t* xd = st + L::W_BYTES;
      for (int i = lane; i < M * XC; i += 32) {
        const int r = i / XC, c = i % XC;  // int4: chunks 8.. from the high half of K
        const int k = s * 64 + (INT4 && c >= 8 ? K / 2 + 8 * (c - 8) : 8 * c);
        ptt::cp_async16(xd + r * L::XLD + 16 * c, x + long(r) * K + k, 16);
      }
      hw::cp_async_mbar_arrive(bar);
      advance(stage, phase, L::STAGES);
    }
    if (ncl > 1) {  // the consumers' two cluster barriers
      hw::cluster_sync();
      hw::cluster_sync();
    }
    return;
  }

  // consumers
  const int g = lane / 4, t = lane % 4;
  const int cb = warp * (D_BN / D_CW) + g * D_CPG;  // this lane group's first column
  float acc[D_NT * MT][4];
  for (long u = u0; u < u1;) {
    const int tile = int(u / steps);
    const long seg0 = u, seg1 = min(u1, long(tile + 1) * steps);
#pragma unroll
    for (int i = 0; i < D_NT * MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (; u < seg1; ++u) {
      hw::mbar_wait(&full[stage], phase);
      const uint8_t* st = smem + stage * L::STAGE;
      decode_stage<MT, INT4>(acc, st, st + L::W_BYTES, cb, lane);
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&empty[stage]);
      advance(stage, phase, L::STAGES);
    }
    const bool whole = seg0 == long(tile) * steps && seg1 == long(tile + 1) * steps;
    if (!whole && ncl > 1) {
      // one segment a CTA, its cluster the tile's contributors in order:
      // the sums meet in distributed shared memory (the ring is free now)
      constexpr int NT = D_CW * 32, R = D_NT * MT * 4;
      float* red = reinterpret_cast<float*>(smem);
      hw::named_barrier(1, NT);  // every consumer warp is done with the ring
#pragma unroll
      for (int r = 0; r < R; ++r) red[r * NT + threadIdx.x] = acc[r / 4][r % 4];
      hw::cluster_sync();
      // rank j: registers j, j + n, ...; a rolled loop reading every rank's
      // sums from shared memory (its own too) keeps the registers of the
      // main loop's instantiation, two CTAs an SM at M = 64 too
      const int lo = int(hw::cluster_rank());
#pragma unroll 1
      for (int r = lo; r < R; r += int(ncl)) {
        float v[8];
#pragma unroll
        for (uint32_t k = 0; k < 8; ++k)
          if (k < ncl) v[k] = hw::ld_dsmem(red + r * NT + threadIdx.x, k);
        float sum = 0.f;
#pragma unroll
        for (uint32_t k = 0; k < 8; ++k)
          if (k < ncl) sum += v[k];
        const int i = (r / 4) / MT, mt = (r / 4) % MT;
        const int n = tile * D_BN + cb + 2 * i + (r % 4) / 2;
        const int m = 8 * mt + 2 * t + r % 2;
        if (m < M) store1<OutT>(out + long(m) * N + n, sum * scale[n]);
      }
      hw::cluster_sync();  // no CTA leaves while another reads its sums
      continue;
    }
    if (!whole && !fixup<D_CW * 32>(acc, ws, flags, bcast, tile, steps, U, P, threadIdx.x))
      continue;
#pragma unroll
    for (int i = 0; i < D_NT; ++i) {
      const int n = tile * D_BN + cb + 2 * i;
      const float2 sc = *reinterpret_cast<const float2*>(scale + n);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + 2 * t;
        const float* c = acc[i * MT + mt];
        if (m < M) store2<OutT>(out + long(m) * N + n, c[0] * sc.x, c[2] * sc.y);
        if (m + 1 < M) store2<OutT>(out + long(m + 1) * N + n, c[1] * sc.x, c[3] * sc.y);
      }
    }
  }
}

// ------------------------------------------------ 2. the prefill kernel
constexpr int P_STAGES = 4;
constexpr int P_THREADS = 384;             // 2 consumer warpgroups + the producer warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PANEL = 64 * 128;            // a 64-column panel of the bf16 tile (64 k rows)

template <int MB, int BNP, bool INT4>
struct PrefillLayout {
  static constexpr int ROWS = 128 * MB;        // rows of x a CTA holds (the x box's rows)
  static constexpr int WR = INT4 ? 32 : 64;    // weight rows a step (64 k either way)
  static constexpr int W_BYTES = WR * BNP;     // BNP / 128 panels of WR x 128
  static constexpr int X_HALF = ROWS * 64;     // one x box: ROWS rows of 32 k
  static constexpr int STAGE = W_BYTES + 2 * X_HALF;  // both multiples of 1024
  static constexpr int B_BYTES = 64 * BNP * 2; // one bf16 tile: BNP / 64 panels
  // + x's map (128 bytes) and the barriers
  static constexpr int SMEM = 1024 + 2 * B_BYTES + P_STAGES * STAGE + 128 + 2 * P_STAGES * 8 + 16;
  static_assert(SMEM <= 232448, "shared memory");
};

// The stage's weight rows as the bf16 tile bt [64 k][BNP n] (MN-major, the
// 128-byte swizzle: the 16-byte chunk c of k row r of a panel at c ^ (r %
// 8)). int4: packed row p gives k row p (low nibbles) and 32 + p (high).
template <int BNP, bool INT4>
__device__ __forceinline__ void convert_tile(uint8_t* bt, const uint8_t* wst, int ctid) {
  constexpr int CH = BNP / 16;
  constexpr int WR = INT4 ? 32 : 64;
  auto put = [&](int k, int n, const uint32_t (&v)[8]) {
    uint8_t* row = bt + (n / 64) * PANEL + k * 128;
    const int c = (n % 64) / 8;
    *reinterpret_cast<uint4*>(row + ((c ^ (k % 8)) * 16)) = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (k % 8)) * 16)) =
        make_uint4(v[4], v[5], v[6], v[7]);
  };
#pragma unroll
  for (int it = 0; it < WR * CH / 256; ++it) {
    const int c = ctid + 256 * it;
    const int r = c / CH, n = (c % CH) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(wst + wsw(r, n, WR * 128));
    const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t lo[8];
    if constexpr (!INT4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t u = wd[q] ^ 0x80808080u;
        const float base = 8388608.f + 128.f;
        float f[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - base;
        lo[2 * q] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
        lo[2 * q + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
      }
      put(r, n, lo);
    } else {
      uint32_t hi[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t v0 = __byte_perm(wd[q], 0u, 0x4140);  // bytes 0, 1 at 0 and 16
        const uint32_t v1 = __byte_perm(wd[q], 0u, 0x4342);  // bytes 2, 3
        lo[2 * q] = nib_pair(v0);
        hi[2 * q] = nib_pair(v0 >> 4);
        lo[2 * q + 1] = nib_pair(v1);
        hi[2 * q + 1] = nib_pair(v1 >> 4);
      }
      put(r, n, lo);
      put(32 + r, n, hi);
    }
  }
}

template <int MB, int BNP, bool INT4, typename OutT>
__global__ void __launch_bounds__(P_THREADS, 1)
wo_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap, CUtensorMap* __restrict__ xslots,
                     const bf16* __restrict__ x, const float* __restrict__ scale,
                     OutT* __restrict__ out, float* __restrict__ ws, int* __restrict__ flags,
                     int M, int K, int N, int steps) {
  using L = PrefillLayout<MB, BNP, INT4>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* bbuf = align1024(smem_raw);
  uint8_t* stages = bbuf + 2 * L::B_BYTES;
  CUtensorMap* xtmp = reinterpret_cast<CUtensorMap*>(stages + P_STAGES * L::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(xtmp + 1);
  uint64_t* empty = full + P_STAGES;
  int* bcast = reinterpret_cast<int*>(empty + P_STAGES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 8);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int P = gridDim.x;
  const long U = long(N / BNP) * steps;
  const long u0 = unit_begin(U, P, blockIdx.x), u1 = unit_begin(U, P, blockIdx.x + 1);
  int stage = 0;
  uint32_t phase = 0;

  if (warp >= 8) {  // producer warpgroup: one thread loads the weight and x
    hw::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > 8) return;
    CUtensorMap* xm = xslots + blockIdx.x;  // this launch's x
    hw::tensormap_retarget(xm, xtmp, &xmap, x, lane);
    if (lane != 0) return;
    hw::tma_prefetch(&wmap);
    for (long u = u0; u < u1; ++u) {
      const int tile = int(u / steps), s = int(u % steps);
      hw::mbar_wait(&empty[stage], phase ^ 1);
      uint64_t* bar = &full[stage];
      uint8_t* st = stages + stage * L::STAGE;
      hw::mbar_expect_tx(bar, L::W_BYTES + 2 * L::X_HALF);
#pragma unroll
      for (int j = 0; j < BNP / 128; ++j)
        hw::tma_load_2d(st + j * L::WR * 128, &wmap, bar, tile * BNP + 128 * j, s * L::WR);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hw::tma_load_2d(st + L::W_BYTES + h * L::X_HALF, xm, bar,
                        INT4 ? h * (K / 2) + 32 * s : 64 * s + 32 * h, 0);
      advance(stage, phase, P_STAGES);
    }
    return;
  }

  // consumer warpgroups: rows [(wg MB + mb) 64, + 64) of x
  hw::setmaxnreg_inc<CONSUMER_REGS>();
  const int ctid = threadIdx.x, wg = warp / 4, tid = ctid % 128;
  float acc[MB][BNP / 2];
  int bi = 0, held = 0;  // held: the stage whose x the wgmma group in flight reads
  for (long u = u0; u < u1;) {
    const int tile = int(u / steps);
    const long seg0 = u, seg1 = min(u1, long(tile + 1) * steps);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int i = 0; i < BNP / 2; ++i) acc[mb][i] = 0.f;
      hw::fence_operand(acc[mb]);
    }
    for (; u < seg1; ++u) {
      hw::mbar_wait(&full[stage], phase);
      const uint8_t* st = stages + stage * L::STAGE;
      uint8_t* bt = bbuf + bi * L::B_BYTES;
      convert_tile<BNP, INT4>(bt, st, ctid);
      hw::wgmma_wait<0>();  // this warpgroup's products of the step before
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) hw::fence_operand(acc[mb]);
      if (u > seg0 && lane == 0) hw::mbar_arrive(&empty[held]);
      hw::fence_proxy_async();
      hw::named_barrier(1, 256);
      hw::wgmma_fence();
      const uint64_t da = hw::desc_k_major_sw64(st + L::W_BYTES + wg * MB * 4096);
      const uint64_t db = hw::desc_mn_major(bt, PANEL);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          hw::wgmma_ss<BNP, 0, 1>(acc[mb],
                                  hw::desc_advance(da, (kk / 2) * L::X_HALF + mb * 4096 +
                                                           (kk % 2) * 32),
                                  hw::desc_advance(db, kk * 2048), 1);
      hw::wgmma_commit();
      held = stage;
      bi ^= 1;
      advance(stage, phase, P_STAGES);
    }
    hw::wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) hw::fence_operand(acc[mb]);
    if (lane == 0) hw::mbar_arrive(&empty[held]);
    const bool whole = seg0 == long(tile) * steps && seg1 == long(tile + 1) * steps;
    if (!whole && !fixup<256>(acc, ws, flags, bcast, tile, steps, U, P, ctid)) continue;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int row = (wg * MB + mb) * 64 + (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
      for (int j = 0; j < BNP / 8; ++j) {
        const int col = tile * BNP + 8 * j + 2 * (tid % 4);
        const float2 sc = *reinterpret_cast<const float2*>(scale + col);
        if (row < M)
          store2<OutT>(out + long(row) * N + col, acc[mb][4 * j] * sc.x,
                       acc[mb][4 * j + 1] * sc.y);
        if (row + 8 < M)
          store2<OutT>(out + long(row + 8) * N + col, acc[mb][4 * j + 2] * sc.x,
                       acc[mb][4 * j + 3] * sc.y);
      }
    }
  }
}

// ----------------------------------------------------------------- launch
// the decode kernel's launch configuration: clusters of `cluster` CTAs
// along K (1: none)
struct DecodeLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  DecodeLaunch(int ctas, int smem, int cluster, cudaStream_t stream) {
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(D_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
  }
};

template <int MT, bool INT4, typename OutT>
cudaError_t launch_decode(const CUtensorMap& wm, const int8_t* w, const bf16* x,
                          const float* scale, OutT* out, float* ws, int* flags, int M, int K,
                          int N, int ctas, int cluster, cudaStream_t stream) {
  using L = DecodeLayout<MT, INT4>;
  auto kern = wo_gemm_kernel<MT, INT4, OutT>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = ptt::allow_smem(kern, L::SMEM, done);
  if (err != cudaSuccess) return err;
  const int steps = (INT4 ? K / 2 : K) / WROWS;
  DecodeLaunch launch(ctas, L::SMEM, cluster, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kern, wm, w, x, scale, out, ws, flags, M, K, N, steps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What the current device holds at once of the decode kernel for M rows
// (bf16 out): CTAs an SM (cluster 1) or clusters of `cluster` CTAs.
template <int MT, bool INT4>
cudaError_t decode_occupancy(int cluster, int* count) {
  using L = DecodeLayout<MT, INT4>;
  auto kern = wo_gemm_kernel<MT, INT4, bf16>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = ptt::allow_smem(kern, L::SMEM, done);
  if (err != cudaSuccess) return err;
  if (cluster == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(count, kern, D_THREADS, L::SMEM);
  DecodeLaunch launch(cluster, L::SMEM, cluster, nullptr);
  return cudaOccupancyMaxActiveClusters(count, kern, &launch.cfg);
}

// xslots: the CTAs' copies of x's map, 128 bytes each, after the scratch
template <int MB, int BNP, bool INT4, typename OutT>
cudaError_t launch_prefill(const CUtensorMap& wm, const CUtensorMap& xm, const bf16* x,
                           const float* scale, OutT* out, float* ws, int* flags, int M, int K,
                           int N, int ctas, cudaStream_t stream) {
  using L = PrefillLayout<MB, BNP, INT4>;
  auto kern = wo_gemm_wgmma_kernel<MB, BNP, INT4, OutT>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = ptt::allow_smem(kern, L::SMEM, done);
  if (err != cudaSuccess) return err;
  auto* xslots = reinterpret_cast<CUtensorMap*>(ws + 2L * ctas * L::ROWS * BNP);
  kern<<<ctas, P_THREADS, L::SMEM, stream>>>(wm, xm, xslots, x, scale, out, ws, flags, M, K, N,
                                             K / 64);
  return cudaGetLastError();
}

template <bool INT4, typename OutT>
cudaError_t launch_kind(int kind, const CUtensorMap& wm, const CUtensorMap& xm, const int8_t* w,
                        const bf16* x, const float* scale, OutT* out, float* ws, int* flags,
                        int M, int K, int N, int ctas, int cl, cudaStream_t st) {
  if (kind == 0) {
    if (M <= 8)
      return launch_decode<1, INT4>(wm, w, x, scale, out, ws, flags, M, K, N, ctas, cl, st);
    if (M <= 16)
      return launch_decode<2, INT4>(wm, w, x, scale, out, ws, flags, M, K, N, ctas, cl, st);
    if (M <= 32)
      return launch_decode<4, INT4>(wm, w, x, scale, out, ws, flags, M, K, N, ctas, cl, st);
    return launch_decode<8, INT4>(wm, w, x, scale, out, ws, flags, M, K, N, ctas, cl, st);
  }
  if (M > 128)
    return launch_prefill<2, 128, INT4>(wm, xm, x, scale, out, ws, flags, M, K, N, ctas, st);
  if (N % 256 == 0)
    return launch_prefill<1, 256, INT4>(wm, xm, x, scale, out, ws, flags, M, K, N, ctas, st);
  return launch_prefill<1, 128, INT4>(wm, xm, x, scale, out, ws, flags, M, K, N, ctas, st);
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The decode kernel's column tile, for the host's plan.
int ptt_weight_only_decode_bn() { return D_BN; }

// What the current device holds at once of the decode kernel for M rows
// (int4 or int8), into *count: its CTAs an SM (cluster = 1; registers and
// shared memory both count) or its clusters of `cluster` CTAs.
int ptt_weight_only_decode_occupancy(int M, int int4, int cluster, int* count) {
  if (M < 1 || M > 64 || cluster < 1 || cluster > 8) return int(cudaErrorInvalidValue);
  const int mt = M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
  cudaError_t err;
  if (int4)
    err = mt == 1 ? decode_occupancy<1, true>(cluster, count)
        : mt == 2 ? decode_occupancy<2, true>(cluster, count)
        : mt == 4 ? decode_occupancy<4, true>(cluster, count)
                  : decode_occupancy<8, true>(cluster, count);
  else
    err = mt == 1 ? decode_occupancy<1, false>(cluster, count)
        : mt == 2 ? decode_occupancy<2, false>(cluster, count)
        : mt == 4 ? decode_occupancy<4, false>(cluster, count)
                  : decode_occupancy<8, false>(cluster, count);
  return int(err);
}

// The tensor map of a weight w [rows, N] of bytes (int8, or packed int4)
// that the kernels read in boxes of 128 columns x box_rows rows (64, or 32
// for the int4 prefill kernel), into the 128 bytes at `map`. Encoded once
// per weight tensor by the host and passed to every launch that reads it.
int ptt_weight_only_encode(void* map, const void* w, int rows, int N, int box_rows) {
  if (rows < 1 || N % 128 != 0 || (box_rows != 32 && box_rows != 64))
    return int(cudaErrorInvalidValue);
  const uint64_t dims[2] = {uint64_t(N), uint64_t(rows)}, strides[1] = {uint64_t(N)};
  const uint32_t box[2] = {128, uint32_t(box_rows)};
  CUtensorMap m;
  const cudaError_t err = hw::encode_tma(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 2, dims, strides,
                                         box, W_L2, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) memcpy(map, &m, sizeof(m));
  return int(err);
}

// The tensor map of an x [M, K] bf16 that the prefill kernel reads (boxes
// of 32 k x 128 ceil(M / 128) rows, the 64-byte swizzle), into the 128
// bytes at `map`: encoded once per (M, K) with any 16-byte aligned x; each
// launch points its CTAs' copies at its own x.
int ptt_weight_only_encode_x(void* map, const void* x, int M, int K) {
  if (M < 1 || M > 256 || K % 128 != 0) return int(cudaErrorInvalidValue);
  const uint64_t dims[2] = {uint64_t(K), uint64_t(M)}, strides[1] = {uint64_t(K) * 2};
  const uint32_t box[2] = {32, uint32_t(128 * ((M + 127) / 128))};
  CUtensorMap m;
  const cudaError_t err =
      hw::encode_tma(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, dims, strides, box,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess) memcpy(map, &m, sizeof(m));
  return int(err);
}

// w [K, N] int8 (int4 = 0) or [K/2, N] packed (int4 = 1), x [M, K] bf16,
// scale [N] f32, out [M, N] bf16 (out_f32 = 0) or f32 (out_f32 = 1), all
// contiguous and 16-byte aligned; wmap: w's map from ptt_weight_only_encode
// (box rows 64, or 32 for kind 1 with int4); xmap: for kind 1, a map of
// this (M, K) from ptt_weight_only_encode_x (null for kind 0). kind 0: the
// decode kernel (M <= 64; 128 columns and 64 weight rows a unit); kind 1:
// the prefill kernel (the host takes it for M > 64; 128 or, for M <= 128
// and N % 256 == 0, 256 columns, 64 k a unit). ctas: the grid, 1 <= ctas
// <= the units; cluster: CTAs a cluster along K (kind 0 only; 1: none),
// dividing ctas, at most 8: with k-aligned shares, exactly the CTAs of one
// tile. ws: f32 scratch, 128-byte aligned, of 2 ctas x rows x columns
// floats (rows: 8 ceil(M / 8), rounded up to a power of two, for kind 0,
// 128 ceil(M / 128) for kind 1), then for kind 1 128 bytes a CTA for its
// copy of x's map; flags: N / 128 ints, 0 before the launch and after it.
// Needs K % 128 == 0 ((K / 2) % 128 == 0 for int4) and N % 128 == 0.
// Returns cudaGetLastError() after the launch.
int ptt_weight_only_gemm(const void* wmap, const void* xmap, const void* w, const void* x,
                         const void* scale, void* out, void* ws, void* flags, int M, int K, int N,
                         int kind, int ctas, int cluster, int int4, int out_f32, void* stream) {
  if (M < 1 || M > 256 || K % 128 != 0 || N % 128 != 0 || (int4 && (K / 2) % 128 != 0) ||
      kind < 0 || kind > 1 || (kind == 0 && M > 64) || ws == nullptr || flags == nullptr ||
      wmap == nullptr || (kind == 1 && xmap == nullptr) ||
      reinterpret_cast<uintptr_t>(ws) % 128 != 0)
    return int(cudaErrorInvalidValue);
  const int bn = kind == 0 ? D_BN : (M <= 128 && N % 256 == 0 ? 256 : 128);
  const long steps = kind == 0 ? (int4 ? K / 2 : K) / WROWS : K / 64;
  const long units = long(N / bn) * steps;
  if (ctas < 1 || ctas > units || N % bn != 0 || cluster < 1 || cluster > 8 ||
      (kind == 1 && cluster != 1))
    return int(cudaErrorInvalidValue);
  // a cluster is exactly one tile's contributors, one equal share each
  if (cluster > 1 && (units % ctas != 0 || units / ctas * cluster != steps))
    return int(cudaErrorInvalidValue);
  CUtensorMap wm, xm = {};
  memcpy(&wm, wmap, sizeof(wm));
  if (kind == 1) memcpy(&xm, xmap, sizeof(xm));
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* sc = static_cast<const float*>(scale);
  auto* f = static_cast<float*>(ws);
  auto* fl = static_cast<int*>(flags);
  const auto st = static_cast<cudaStream_t>(stream);
  if (int4) {
    if (out_f32)
      return int(launch_kind<true>(kind, wm, xm, wq, xb, sc, static_cast<float*>(out), f, fl, M,
                                   K, N, ctas, cluster, st));
    return int(launch_kind<true>(kind, wm, xm, wq, xb, sc, static_cast<bf16*>(out), f, fl, M, K,
                                 N, ctas, cluster, st));
  }
  if (out_f32)
    return int(launch_kind<false>(kind, wm, xm, wq, xb, sc, static_cast<float*>(out), f, fl, M,
                                  K, N, ctas, cluster, st));
  return int(launch_kind<false>(kind, wm, xm, wq, xb, sc, static_cast<bf16*>(out), f, fl, M, K,
                                N, ctas, cluster, st));
}

}  // extern "C"
