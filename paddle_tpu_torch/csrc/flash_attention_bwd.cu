// Flash attention backward for Hopper (sm_90a): bf16 q, k, v, out, dout and
// the forward's f32 lse in; bf16 dq, dk, dv out, accumulated in f32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py `_bwd`
// (pl.pallas_call at :453, body `_bwd_fused_kernel` at :306) on the
// training path (the autograd Function in ops/fused/flash_attention.py).
// It covers exactly the forward's subset: causal with a bottom-right
// q_offset (row r sees column c iff c <= q_offset + r), kv_len (columns >=
// kv_len masked), the optional additive f32 or bool mask and q / kv segment
// ids of csrc/flash_mask.cuh (the mask gets no gradient, as in the Pallas
// backward; the dispatch sends a mask that requires grad to the plain
// version), GQA (query head h reads kv head h / (hq / hk)), d in
// {64, 128}, BSHD layout: q, out, dout, dq [b, sq, hq, d]; k, v, dk, dv
// [b, sk, hk, d], contiguous and 16-byte aligned; lse [b, hq, sq] f32 in
// natural-log units.
//
// With z = scale * q k^T (masked), P = exp(z - lse), the gradients are
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
//
// What bounds it on the H100: tensor-core operations. The bound counts five
// products over the visible (row, column) pairs, 2.5 times the forward's
// operations, on the same bytes; this design runs seven (S and dP are
// formed in both the dK/dV and the dQ kernel), the price of determinism.
//
// Design: the FlashAttention-2 split into three kernels, each dK/dV and dQ
// warp-specialised on csrc/hopper.cuh's primitives. The Pallas kernel leans
// on a sequential grid (a partial dq per kv block, summed by XLA); here no
// atomics and no partial buffers, so the result is deterministic.
//   1. delta = rowsum(dO * O) in f32, d / 8 threads per (batch, row,
//      head), 16-byte loads; it is small and bound by bytes.
//   2. dK/dV: one CTA per (128-row kv block, kv head, batch), walked with
//      the blocks that see the most q rows first. Warpgroup 0 (24
//      registers) loads K and V once, then streams Q and dO tiles of QS q
//      rows by 4-D TMA (d, h, s, b; box depth 1 in h and b, so rows past sq
//      zero-fill) through a ring of STAGES stages; its 32 lanes copy the
//      tile's lse (times log2 e) and delta rows beside them, and each lane
//      arrives on the stage's full barrier. Warpgroups 1 and 2 (240
//      registers) own 64 kv rows each and keep dK and dV (64 x d f32) in
//      registers over the group's query heads and the q tiles the causal
//      band allows. Per tile, in three steps so that no more than one f32
//      score tile is live beside dK and dV (at d = 128 they take 128
//      registers a thread; holding S^T and dP^T together made ptxas
//      serialise the wgmmas for want of registers, C7512):
//        S^T = K Q^T (wgmma m64n{QS}k16, every operand K-major in shared
//        memory); P^T = exp2(S^T c - lse2), packed to bf16;
//        dV += P^T dO (the RS wgmma m64n{d}k16, dO read MN-major from the
//        same tile) together with dP^T = V dO^T;
//        dS^T = P^T (dP^T - delta) from the packed P^T, packed; dK += dS^T Q.
//      The two consumer warpgroups take turns at issuing (hopper.cuh
//      `PingPong`), so one's exp2 and packing run while the other's
//      products hold the tensor cores. QS = 64 (32 timed slower: PERF.md).
//   3. dQ: one CTA per (128-row q tile, query head, batch), the longest
//      first. Q and dO are loaded once, K and V tiles of KS rows stream
//      through the ring; each consumer warpgroup owns 64 q rows and the dQ
//      accumulator: S = Q K^T and dP = dO V^T (shared-memory wgmma), dS =
//      P (dP - delta), dQ += dS K (RS wgmma, K MN-major), the two
//      warpgroups taking turns as in dK/dV.
// Masks as in the forward: a tile wholly visible runs without a mask, a
// tile that straddles the causal diagonal, kv_len, or (in dK/dV) the rows
// past sq tests its elements, by a select so that an empty row's
// exp2(+huge) never reaches a product. With a mask or segment ids every
// tile tests its elements: P = exp2(s c + bias - lse2) where the pair is
// seen (the bias read straight from global memory, -inf for a False of a
// bool mask, so P = 0 there), 0 by the select where it is not; the q
// rows' segment ids ride in the dK/dV ring's stage beside lse and delta,
// the rows a thread owns read theirs once. Every warpgroup runs the products of
// every tile of its CTA, even one wholly invisible to its 64 rows (at most
// one such tile a CTA under a causal mask): a wgmma issued on a branch that
// ptxas cannot prove warpgroup-uniform makes it serialise every wgmma of
// the kernel (C7518), and so does an accumulator that a non-wgmma
// instruction rewrites (C7515): the scores are only read. dK and dV (or
// dQ) leave through the warpgroup's own rows of K and V (or Q) in shared
// memory, staged in the swizzled layout and stored by 4-D TMA, clipped at
// sk (sq). Both rings have 3 stages (2 timed slower: PERF.md);
// paddle_tpu_torch/tools/flash_variants.py times this source against edits
// of it (ring depth, step widths, ping-pong, grid order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ptt::sm90;
typedef __nv_bfloat16 bf16;

constexpr int BKV = 128;          // kv rows of a dK/dV CTA: 2 consumer warpgroups x 64
constexpr int BQ = 128;           // q rows of a dQ CTA
constexpr int STAGES = 3;         // ring depth of both kernels
constexpr int THREADS = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int PP_BAR = 1;         // named barriers 1, 2: ping-pong turns
constexpr int EPI_BAR = 3;        // 3, 4: each warpgroup's epilogue
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// rows [0, 64) of an f32 accumulator (64 x D, this warpgroup's layout) as
// bf16, times `mul`, into rows [row0, row0 + 64) of a 128-byte-swizzled
// tile of `panel` bytes per 64-wide panel
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* tile, int panel, int row0,
                                           const float (&acc)[D / 2], float mul, int tid) {
  const int t4 = tid % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
      uint8_t* at = tile + (j / 8) * panel + row * 128 + (((j % 8) ^ (row % 8)) * 16) + t4 * 4;
      *reinterpret_cast<__nv_bfloat162*>(at) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
}

// delta[b, h, r] = sum_d dO[b, r, h, d] * O[b, r, h, d] in f32: D / 8
// threads per row, 16 bytes of each tensor a thread
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int b, int sq, int hq) {
  constexpr int TPR = D / 8;   // threads per row
  const long rows = long(b) * sq * hq;
  const long row = (long(blockIdx.x) * 256 + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * D + part * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), gf = __bfloat1622float2(g2[i]);
      acc += of.x * gf.x + of.y * gf.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) {
    // row = (bi * sq + r) * hq + h  ->  delta[(bi * hq + h) * sq + r]
    const long h = row % hq, r = (row / hq) % sq, bi = row / (long(hq) * sq);
    delta[(bi * hq + h) * sq + r] = acc;
  }
}

// ------------------------------------------------------------------ dK / dV
template <int D>
struct DkdvSmem {
  static constexpr int QS = 64;                        // q rows of a step
  static constexpr int PANELS = D / 64;
  static constexpr int KV_PANEL = BKV * 128;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;   // K or V
  static constexpr int Q_PANEL = QS * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;     // one Q or dO tile
  // Q, dO, then lse2, delta [QS] f32 and the q rows' segment ids [QS]
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 1024;
  static constexpr int BYTES = 1024 + 2 * KV_BYTES + STAGES * STAGE_BYTES + (1 + 2 * STAGES) * 8;
  static_assert(Q_PANEL % 1024 == 0 && 3 * QS * 4 <= 1024, "swizzle atom alignment");
  static_assert(BYTES <= 232448, "shared memory");
};

// MASKED: a mask or segment ids apply (csrc/flash_mask.cuh); the kernels
// without them are compiled apart, so their code is the same as before masks
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_dk,
                      const __grid_constant__ CUtensorMap map_dv, const float* __restrict__ lse,
                      const float* __restrict__ delta, int sq, int sk, int hq, int hk,
                      int kv_len, int q_offset, int causal, float scale, float scale_log2,
                      const ptt::FlashMask fm) {
  using L = DkdvSmem<D>;
  constexpr int QS = L::QS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = base;
  uint8_t* sV = sK + L::KV_BYTES;
  uint8_t* ring = sV + L::KV_BYTES;   // stage s: Q, dO, lse2 [QS], delta [QS], q ids [QS]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE_BYTES);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * BKV;   // most q rows first
  const int group = hq / hk;
  const int kv_end = min(kv_len, sk);
  // q rows that can see a column of this block start at i_min
  const int i_min = causal ? max(0, n0 - q_offset) : 0;
  const int t0 = i_min / QS;
  const int nt = (n0 < kv_end && i_min < sq) ? (sq + QS - 1) / QS - t0 : 0;
  const int iters = nt * group;   // (query head of the group, q tile) pairs

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 32);   // every producer lane, one with the bytes
      hw::mbar_init(&empty[s], 2);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: warp 0 loads, lane 0 issues TMA
    hw::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32 || iters == 0) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hw::tma_prefetch(&map_q);
      hw::tma_prefetch(&map_do);
      hw::mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        hw::tma_load_4d(sK + p * L::KV_PANEL, &map_k, bar_kv, 64 * p, kvh, n0, b);
        hw::tma_load_4d(sV + p * L::KV_PANEL, &map_v, bar_kv, 64 * p, kvh, n0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < iters; ++it) {
      const int h = kvh * group + it / nt;
      const int q0 = (t0 + it % nt) * QS;
      hw::mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* st = ring + stage * L::STAGE_BYTES;
      float* st_lse = reinterpret_cast<float*>(st + 2 * L::Q_BYTES);
      int* st_seg = reinterpret_cast<int*>(st_lse + 2 * QS);
      const long row0 = (long(b) * hq + h) * sq;
      for (int r = lane; r < QS; r += 32) {
        const bool ok = q0 + r < sq;
        st_lse[r] = ok ? lse[row0 + q0 + r] * LOG2E : 0.f;
        st_lse[QS + r] = ok ? delta[row0 + q0 + r] : 0.f;
        if constexpr (MASKED) st_seg[r] = fm.q_id(b, sq, min(q0 + r, sq - 1));
      }
      if (lane == 0) {
        hw::mbar_expect_tx(&full[stage], 2 * L::Q_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          hw::tma_load_4d(st + p * L::Q_PANEL, &map_q, &full[stage], 64 * p, h, q0, b);
          hw::tma_load_4d(st + L::Q_BYTES + p * L::Q_PANEL, &map_do, &full[stage], 64 * p, h,
                          q0, b);
        }
      } else {
        hw::mbar_arrive(&full[stage]);
      }
      advance(stage, phase);
    }
    return;
  }

  // consumer warpgroups 1, 2: kv rows [j0, j0 + 64)
  hw::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const int j0 = n0 + 64 * wg;
  const int row_lo = j0 + 16 * (tid / 32) + lane / 4;   // kv rows row_lo, row_lo + 8
  const bool leader = tid == 0;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  // pinned here: zeroed later, between a wgmma's issue and its wait, the
  // accumulators would make ptxas serialise every wgmma (C7515)
  hw::fence_operand(dk);
  hw::fence_operand(dv);
  float s[QS / 2], dp[QS / 2];
  uint32_t pa[QS / 16][4], da[QS / 16][4];

  // S^T = K Q^T and dP^T = V dO^T (every operand K-major)
  const uint64_t k_desc = hw::desc_k_major(sK + wg * 64 * 128);
  const uint64_t v_desc = hw::desc_advance(k_desc, L::KV_BYTES);
  // A x B^T into acc: A this warpgroup's 64 rows of K or V, B the stage's
  // Q or dO tile (every operand K-major)
  auto issue_nt = [&](float (&acc)[QS / 2], uint64_t a_desc, const uint8_t* b_tile) {
    const uint64_t a0 = hw::desc_opaque(a_desc);
    const uint64_t b0 = hw::desc_opaque(hw::desc_k_major(b_tile));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss<QS, 0, 0>(acc, hw::desc_advance(a0, (kk / 4) * L::KV_PANEL + (kk % 4) * 32),
                             hw::desc_advance(b0, (kk / 4) * L::Q_PANEL + (kk % 4) * 32),
                             kk > 0);
  };
  // acc += A B: A (64 kv rows x QS q) from registers, B the stage's dO or Q
  // tile, MN-major
  auto issue_nn = [&](float (&acc)[D / 2], const uint32_t (&a)[QS / 16][4],
                      const uint8_t* b_tile) {
    const uint64_t b0 = hw::desc_opaque(hw::desc_mn_major(b_tile, L::Q_PANEL));
#pragma unroll
    for (int kk = 0; kk < QS / 16; ++kk) hw::wgmma_rs<D, 1>(acc, a[kk], hw::desc_advance(b0, kk * 2048), 1);
  };
  // Per tile, so that no more than one score tile is held in f32:
  //   S^T = K Q^T; P^T = exp2(S^T c - lse2), packed to bf16 (pa);
  //   dV += P^T dO together with dP^T = V dO^T;
  //   dS^T = P^T (dP^T - delta) from the packed P^T, packed (da);
  //   dK += dS^T Q.
  // S^T and dP^T are only read (an accumulator that a non-wgmma
  // instruction rewrites makes ptxas serialise the wgmmas, C7515). Column
  // i of a tile is q row q0 + i, row r the kv row row_lo + 8 r.
  // masked: every load is made (at an index kept in bounds) and the select
  // drops what is not seen
  int kvid[2], kv_at[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kv_at[r] = min(row_lo + 8 * r, sk - 1);
    kvid[r] = MASKED ? fm.kv_id(b, sk, kv_at[r]) : 0;
  }
  auto probs = [&](const float* st_lse, int q0, int hh) {
    const bool mask = MASKED || j0 + 64 > kv_end || q0 + QS > sq ||
                      (causal && j0 + 63 > q_offset + q0);
    const int* st_seg = reinterpret_cast<const int*>(st_lse + 2 * QS);
    // kv row r sees the tile's columns [lo[r], hi) (none past kv_end)
    int lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kv = row_lo + 8 * r;
      lo[r] = kv >= kv_end ? QS : causal ? kv - q_offset - q0 : 0;
    }
    const int hi = sq - q0;
    // P^T of one tile; KIND and SEGS: the mask's kind and whether segment
    // ids apply (FlashMask::dispatch), with no mask at all when !MASKED
    auto tile = [&](auto kind, auto segs) {
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 8 * kk + 2 * i + h, r = (idx % 4) / 2;
            const int col = 8 * (idx / 4) + 2 * t4 + h;
            bool seen = !mask || (col >= lo[r] && col < hi);
            if constexpr (decltype(segs)::value) seen = seen && st_seg[col] == kvid[r];
            float arg = -st_lse[col];
            if constexpr (decltype(kind)::value != ptt::FlashMask::NONE)
              arg += fm.template bias2<decltype(kind)::value>(
                  fm.row_at(b, hh, min(q0 + col, sq - 1)), kv_at[r]);
            const float e = hw::ex2_approx(fmaf(s[idx], scale_log2, arg));
            p[h] = seen ? e : 0.f;
          }
          pa[kk][i] = hw::pack_bf16x2(p[0], p[1]);
        }
    };
    if constexpr (MASKED)
      fm.dispatch(tile);
    else
      tile(std::integral_constant<int, ptt::FlashMask::NONE>{}, std::false_type{});
  };
  auto dscores = [&](const float* st_delta) {
#pragma unroll
    for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 8 * kk + 2 * i, col = 8 * (idx / 4) + 2 * t4;
        const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[kk][i]));
        da[kk][i] = hw::pack_bf16x2(p.x * (dp[idx] - st_delta[col]),
                                    p.y * (dp[idx + 1] - st_delta[col + 1]));
      }
  };

  if (iters > 0) {
    const hw::PingPong pp{wg, PP_BAR};
    pp.start();
    hw::mbar_wait(bar_kv, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < iters; ++it) {
      const uint8_t* sQ = ring + stage * L::STAGE_BYTES;
      const uint8_t* sDO = sQ + L::Q_BYTES;
      const float* st_lse = reinterpret_cast<const float*>(sQ + 2 * L::Q_BYTES);
      hw::mbar_wait(&full[stage], phase);
      pp.begin();
      hw::wgmma_fence();
      issue_nt(s, k_desc, sQ);
      hw::wgmma_commit();
      pp.end();
      hw::wgmma_wait<0>();
      hw::fence_operand(s);
      probs(st_lse, (t0 + it % nt) * QS, kvh * group + it / nt);
      pp.begin();
      hw::wgmma_fence();
      issue_nn(dv, pa, sDO);
      issue_nt(dp, v_desc, sDO);
      hw::wgmma_commit();
      pp.end();
      hw::wgmma_wait<0>();
      hw::fence_operand(dv);
      hw::fence_operand(dp);
      dscores(st_lse + QS);
      pp.begin();
      hw::wgmma_fence();
      issue_nn(dk, da, sQ);
      hw::wgmma_commit();
      pp.end();
      hw::wgmma_wait<0>();
      hw::fence_operand(dk);
      hw::fence_operand(pa);
      hw::fence_operand(da);
      if (leader) hw::mbar_arrive(&empty[stage]);   // the tile's products have landed
      advance(stage, phase);
    }
    pp.finish();
  }

  // this warpgroup's rows of K and V are its own from here: stage dK
  // (scaled once) and dV there and store them by TMA, clipped at sk
  stage_rows<D>(sK, L::KV_PANEL, 64 * wg, dk, scale, tid);
  stage_rows<D>(sV, L::KV_PANEL, 64 * wg, dv, 1.f, tid);
  hw::fence_proxy_async();
  hw::named_barrier(EPI_BAR + wg, 128);
  if (leader) {
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p) {
      hw::tma_store_4d(&map_dk, sK + p * L::KV_PANEL + wg * 64 * 128, 64 * p, kvh, j0, b);
      hw::tma_store_4d(&map_dv, sV + p * L::KV_PANEL + wg * 64 * 128, 64 * p, kvh, j0, b);
    }
    hw::tma_store_commit();
    hw::tma_store_wait_read<0>();
  }
}

// ----------------------------------------------------------------------- dQ
template <int D>
struct DqSmem {
  static constexpr int KS = 64;                        // kv rows of a step
  static constexpr int PANELS = D / 64;
  static constexpr int Q_PANEL = BQ * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;     // Q or dO
  static constexpr int KV_PANEL = KS * 128;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BYTES = 1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + (1 + 2 * STAGES) * 8;
  static_assert(KV_PANEL % 1024 == 0, "swizzle atom alignment");
  static_assert(BYTES <= 232448, "shared memory");
};

template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dq, const float* __restrict__ lse,
                    const float* __restrict__ delta, int sq, int sk, int hq, int hk, int kv_len,
                    int q_offset, int causal, float scale, float scale_log2,
                    const ptt::FlashMask fm) {
  using L = DqSmem<D>;
  constexpr int KS = L::KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;
  uint8_t* sDO = sQ + L::Q_BYTES;
  uint8_t* ring = sDO + L::Q_BYTES;   // stage s: K, V
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int t = blockIdx.z;   // from the last q tile down
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = ((sq + BQ - 1) / BQ - 1 - t) * BQ;
  const int kvh = h / (hq / hk);
  const int kv_end = min(kv_len, sk);
  const int n_end = causal ? min(kv_end, q_offset + min(q0 + BQ, sq)) : kv_end;
  const int n_tiles = n_end > 0 ? (n_end + KS - 1) / KS : 0;

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 2);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    hw::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      hw::tma_prefetch(&map_k);
      hw::tma_prefetch(&map_v);
      hw::mbar_expect_tx(bar_q, 2 * L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        hw::tma_load_4d(sQ + p * L::Q_PANEL, &map_q, bar_q, 64 * p, h, q0, b);
        hw::tma_load_4d(sDO + p * L::Q_PANEL, &map_do, bar_q, 64 * p, h, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        hw::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * L::STAGE_BYTES;
        hw::mbar_expect_tx(&full[stage], L::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          hw::tma_load_4d(st + p * L::KV_PANEL, &map_k, &full[stage], 64 * p, kvh, j * KS, b);
          hw::tma_load_4d(st + L::KV_BYTES + p * L::KV_PANEL, &map_v, &full[stage], 64 * p,
                          kvh, j * KS, b);
        }
        advance(stage, phase);
      }
    }
    return;
  }

  // consumer warpgroups 1, 2: q rows [r0, r0 + 64)
  hw::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const int r0 = q0 + 64 * wg;
  const int row_lo = r0 + 16 * (tid / 32) + lane / 4;   // q rows row_lo, row_lo + 8
  const bool leader = tid == 0;
  float lse2[2], dl[2];
  int lim[2], qid[2];
  long long mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const bool ok = row < sq;   // rows past sq are never stored
    lse2[r] = ok ? lse[(long(b) * hq + h) * sq + row] * LOG2E : 0.f;
    dl[r] = ok ? delta[(long(b) * hq + h) * sq + row] : 0.f;
    lim[r] = causal ? min(kv_end, q_offset + row + 1) : kv_end;
    qid[r] = MASKED ? fm.q_id(b, sq, min(row, sq - 1)) : 0;
    mrow[r] = fm.row_at(b, h, min(row, sq - 1));
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  hw::fence_operand(dq);   // zeroed before any wgmma is in flight
  float s[KS / 2], dp[KS / 2];
  uint32_t da[KS / 16][4];

  auto tile = [&](int stage) { return ring + stage * L::STAGE_BYTES; };
  // S = Q K^T, dP = dO V^T (every operand K-major)
  auto issue_sdp = [&](int stage) {
    const uint64_t q_desc = hw::desc_opaque(hw::desc_k_major(sQ + wg * 64 * 128));
    const uint64_t do_desc = hw::desc_advance(q_desc, L::Q_BYTES);
    const uint64_t k_desc = hw::desc_opaque(hw::desc_k_major(tile(stage)));
    const uint64_t v_desc = hw::desc_advance(k_desc, L::KV_BYTES);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * L::Q_PANEL + (kk % 4) * 32;
      const int koff = (kk / 4) * L::KV_PANEL + (kk % 4) * 32;
      hw::wgmma_ss<KS, 0, 0>(s, hw::desc_advance(q_desc, off), hw::desc_advance(k_desc, koff),
                             kk > 0);
      hw::wgmma_ss<KS, 0, 0>(dp, hw::desc_advance(do_desc, off), hw::desc_advance(v_desc, koff),
                             kk > 0);
    }
    hw::wgmma_commit();
  };
  // dS = P (dP - delta), P = exp2(S c - lse2) on visible columns, packed
  // as the A operand of dQ one k16 step at a time (S and dP only read)
  auto grads = [&](int k0) {
    const bool mask = MASKED || k0 + KS > kv_end || (causal && k0 + KS - 1 > q_offset + r0);
    // KIND and SEGS as in dK/dV's `probs`
    auto tile = [&](auto kind, auto segs) {
      const int* kv_ids = fm.kv_seg;   // of batch b: at b sk + column
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float ds[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 8 * kk + 2 * i + h, r = (idx % 4) / 2;
            const int col = k0 + 8 * (idx / 4) + 2 * t4 + h;
            const int at = min(col, sk - 1);
            bool seen = !mask || col < lim[r];
            if constexpr (decltype(segs)::value)
              seen = seen && kv_ids[(long long)b * sk + at] == qid[r];
            float arg = -lse2[r];
            if constexpr (decltype(kind)::value != ptt::FlashMask::NONE)
              arg += fm.template bias2<decltype(kind)::value>(mrow[r], at);
            const float p = hw::ex2_approx(fmaf(s[idx], scale_log2, arg));
            ds[h] = seen ? p * (dp[idx] - dl[r]) : 0.f;
          }
          da[kk][i] = hw::pack_bf16x2(ds[0], ds[1]);
        }
    };
    if constexpr (MASKED)
      fm.dispatch(tile);
    else
      tile(std::integral_constant<int, ptt::FlashMask::NONE>{}, std::false_type{});
  };
  // dQ += dS K (K MN-major)
  auto issue_dq = [&](int stage) {
    const uint64_t k_desc = hw::desc_opaque(hw::desc_mn_major(tile(stage), L::KV_PANEL));
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
      hw::wgmma_rs<D, 1>(dq, da[kk], hw::desc_advance(k_desc, kk * 2048), 1);
    hw::wgmma_commit();
  };

  if (n_tiles > 0) {
    const hw::PingPong pp{wg, PP_BAR};
    pp.start();
    hw::mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      hw::mbar_wait(&full[stage], phase);
      pp.begin();
      issue_sdp(stage);
      pp.end();
      hw::wgmma_wait<0>();
      hw::fence_operand(s);
      hw::fence_operand(dp);
      grads(j * KS);
      pp.begin();
      issue_dq(stage);
      pp.end();
      hw::wgmma_wait<0>();
      hw::fence_operand(dq);
      hw::fence_operand(da);
      if (leader) hw::mbar_arrive(&empty[stage]);   // dQ of this tile has landed
      advance(stage, phase);
    }
    pp.finish();
  }

  // this warpgroup's rows of Q are its own from here: stage dQ there
  stage_rows<D>(sQ, L::Q_PANEL, 64 * wg, dq, scale, tid);
  hw::fence_proxy_async();
  hw::named_barrier(EPI_BAR + wg, 128);
  if (leader) {
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p)
      hw::tma_store_4d(&map_dq, sQ + p * L::Q_PANEL + wg * 64 * 128, 64 * p, h, r0, b);
    hw::tma_store_commit();
    hw::tma_store_wait_read<0>();
  }
}

// A 4-D map (d, h, s, b) of a contiguous [b, s, h, d] bf16 tensor, boxes of
// 64 d x 1 head x `rows` x 1 batch.
cudaError_t bshd_map(CUtensorMap* map, const void* p, int b, int s, int h, int d, int rows) {
  const uint64_t dims[4] = {uint64_t(d), uint64_t(h), uint64_t(s), uint64_t(b)};
  const uint64_t str[3] = {uint64_t(d) * 2, uint64_t(h) * d * 2, uint64_t(s) * h * d * 2};
  const uint32_t box[4] = {64, 1, uint32_t(rows), 1};
  return hw::encode_tma_bf16(map, p, 4, dims, str, box);
}

template <int D, bool MASKED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int sq, int sk, int hq, int hk, int kv_len, int q_offset,
                   int causal, float scale, const ptt::FlashMask& fm, cudaStream_t stream) {
  using LK = DkdvSmem<D>;
  using LQ = DqSmem<D>;
  // dK/dV: Q and dO in tiles of QS rows, K and V whole blocks, stores of 64
  CUtensorMap kq, kk, kv, kdo, kdk, kdv;
  cudaError_t err = bshd_map(&kq, q, b, sq, hq, D, LK::QS);
  if (err == cudaSuccess) err = bshd_map(&kdo, dout, b, sq, hq, D, LK::QS);
  if (err == cudaSuccess) err = bshd_map(&kk, k, b, sk, hk, D, BKV);
  if (err == cudaSuccess) err = bshd_map(&kv, v, b, sk, hk, D, BKV);
  if (err == cudaSuccess) err = bshd_map(&kdk, dk, b, sk, hk, D, 64);
  if (err == cudaSuccess) err = bshd_map(&kdv, dv, b, sk, hk, D, 64);
  // dQ: Q and dO whole tiles, K and V in tiles of KS rows, stores of 64
  CUtensorMap qq, qk, qv, qdo, qdq;
  if (err == cudaSuccess) err = bshd_map(&qq, q, b, sq, hq, D, BQ);
  if (err == cudaSuccess) err = bshd_map(&qdo, dout, b, sq, hq, D, BQ);
  if (err == cudaSuccess) err = bshd_map(&qk, k, b, sk, hk, D, LQ::KS);
  if (err == cudaSuccess) err = bshd_map(&qv, v, b, sk, hk, D, LQ::KS);
  if (err == cudaSuccess) err = bshd_map(&qdq, dq, b, sq, hq, D, 64);
  if (err != cudaSuccess) return err;

  const long rows = long(b) * sq * hq;
  flash_bwd_delta_kernel<D><<<unsigned((rows * (D / 8) + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, b, sq, hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static std::atomic<uint64_t> done_kv{0}, done_q{0};
  auto kern_kv = flash_bwd_dkdv_kernel<D, MASKED>;
  err = ptt::allow_smem(kern_kv, LK::BYTES, done_kv);
  if (err != cudaSuccess) return err;
  const int nkv = (sk + BKV - 1) / BKV, ntq = (sq + BQ - 1) / BQ;
  const dim3 grid_kv(hk, b, nkv), grid_q(hq, b, ntq);
  kern_kv<<<grid_kv, THREADS, LK::BYTES, stream>>>(
      kq, kk, kv, kdo, kdk, kdv, lse, delta, sq, sk, hq, hk, kv_len, q_offset, causal, scale,
      scale * LOG2E, fm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kern_q = flash_bwd_dq_kernel<D, MASKED>;
  err = ptt::allow_smem(kern_q, LQ::BYTES, done_q);
  if (err != cudaSuccess) return err;
  kern_q<<<grid_q, THREADS, LQ::BYTES, stream>>>(
      qq, qk, qv, qdo, qdq, lse, delta, sq, sk, hq, hk, kv_len, q_offset, causal, scale,
      scale * LOG2E, fm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of the dK/dV and dQ kernels at head dim d (0 for
// another d).
int ptt_flash_bwd_smem_bytes(int d, int which) {
  if (d == 128) return which == 0 ? DkdvSmem<128>::BYTES : DqSmem<128>::BYTES;
  if (d == 64) return which == 0 ? DkdvSmem<64>::BYTES : DqSmem<64>::BYTES;
  return 0;
}

// q, out, dout, dq [b, sq, hq, d]; k, v, dk, dv [b, sk, hk, d]: contiguous,
// 16-byte aligned bf16. lse [b, hq, sq] f32 from the forward; delta [b, hq,
// sq] f32 scratch. mask, q_seg, kv_seg and the mask's kind and strides as
// the forward's (ptt_flash_fwd). Runs three kernels (delta, dK/dV, dQ) on
// `stream`; returns a CUDA error code: of the tensor maps' encoding, of a
// shared-memory opt-in, or cudaGetLastError() after a launch (0 on success).
int ptt_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                  const void* mask, const void* q_seg, const void* kv_seg, int b, int sq, int sk,
                  int hq, int hk, int d, int kv_len, int q_offset, int causal, int mask_kind,
                  long long msb, long long msh, long long msr, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hk <= 0 || hq % hk != 0 || mask_kind < 0 ||
      mask_kind > 2 || (mask_kind != 0) != (mask != nullptr) ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return int(cudaErrorInvalidValue);
  const ptt::FlashMask fm{mask, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                          mask_kind, msb, msh, msr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const bool m = fm.any();
  if (d == 128)
    return int(m ? launch<128, true>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, hq, hk,
                                     kv_len, q_offset, causal, scale, fm, s)
                 : launch<128, false>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, hq, hk,
                                      kv_len, q_offset, causal, scale, fm, s));
  if (d == 64)
    return int(m ? launch<64, true>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, hq, hk,
                                    kv_len, q_offset, causal, scale, fm, s)
                 : launch<64, false>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, hq, hk,
                                     kv_len, q_offset, causal, scale, fm, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
