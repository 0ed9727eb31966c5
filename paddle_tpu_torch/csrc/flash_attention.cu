// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py `_fwd`
// (pl.pallas_call at :266, body `_fwd_kernel` at :100) on the serving
// prefill path (fused_multi_transformer, s > 8 branch) and the training
// forward (LlamaAttention through the autograd Function).
//
// What it computes: out = softmax(scale * q k^T + mask) v, per (batch, query
// head), with
//   * GQA: query head h reads kv head h / (hq / hk) (the jnp.repeat order);
//     K/V are never repeated in memory;
//   * causal masking with a bottom-right offset: row r sees column c iff
//     c <= q_offset + r;
//   * kv_len: columns >= kv_len are masked;
//   * optionally an additive f32 or bool mask [b, hq | 1, sq, sk] read by
//     strides, and q / kv segment ids (a pair in different segments is
//     masked): csrc/flash_mask.cuh.
// Layout is BSHD: q [b, sq, hq, d], k/v [b, sk, hk, d], out [b, sq, hq, d],
// all contiguous and 16-byte aligned; d is 64 or 128. With a non-null `lse`
// it also writes the f32 row logsumexp lse [b, hq, sq] of the scaled, masked
// scores in natural-log units (JAX's lse [b, h, sq, 1] at :192), which the
// backward (flash_attention_bwd.cu) reads; a row that sees no column gets
// zeros and -1e30 * ln 2, as the JAX kernel writes. A null `lse` skips the
// write (the serving path).
//
// What bounds it on the H100: tensor-core operations (prefill at S >= 512
// does ~S*d operations per byte of q/k/v, far above the card's ~295 ops per
// byte); only wgmma reaches their full rate.
//
// Design (warp-specialised, in the manner of FlashAttention-3; the
// primitives are csrc/hopper.cuh's):
// - Work split: one CTA per (128-row q tile, query head, batch). The q
//   tile is the grid's slowest index, walked from the last tile down, so
//   under a causal mask the tiles with the most columns start first across
//   all heads. (The variant "head_major", a head's tiles next to each other
//   so that its K and V stay in L2, balances the card worse at S = 2048
//   with GQA: PERF.md.)
// - Warps: warpgroup 0 drops to 24 registers (setmaxnreg) and one of its
//   threads issues every TMA load: Q once (one 64-wide panel of 128-byte
//   swizzled rows per 64 of d), then K and V tiles of BN = 128 rows into a
//   ring of 3 stages (2 timed slower: PERF.md). K and V each have a full
//   and an empty barrier per stage, so S = Q K^T starts before V lands and
//   K's buffer is refilled as soon as both consumers' S has landed, before
//   their PV. Warpgroups 1
//   and 2 rise to 240 registers and own 64 q rows each. All loads are 4-D
//   maps (d, h, s, b) with a box of depth 1 in h and b, so a tile's rows
//   past sq or sk zero-fill and never reach the next batch.
// - S = Q K^T: wgmma m64n{BN}k16, both operands K-major in shared memory.
//   The online softmax runs on the accumulator in registers, in base 2,
//   with the row max and sum in f32 (quad shuffles), one FFMA into ex2 per
//   score; a row that has seen nothing keeps max -inf and uses 0 in its
//   exponent, so exp2 never sees -inf - -inf.
// - O += P V: the RS wgmma m64n{d}k16: P is packed from the S accumulator
//   to bf16 A fragments (hopper.cuh `pack_a_rs`), V is the MN-major B
//   (transpose bit, LBO = the step between its 64-wide panels).
// - Overlap. Within a warpgroup: S of tile j + 1 and PV of tile j are
//   issued together, the softmax of tile j + 1 runs while PV is in flight,
//   and O is rescaled once PV has landed. Between the two warpgroups
//   (hopper.cuh `PingPong`): each bracket of wgmma issues is taken in turn
//   through two named barriers, so one warpgroup's softmax runs while the
//   other's products hold the tensor cores.
// - Masks: tiles past the last visible column (q_offset + last row, or
//   kv_len) are never loaded; without a mask or segment ids, a tile wholly
//   visible to a warpgroup's 64 rows runs without a mask, and only a tile
//   that straddles the causal diagonal or kv_len tests its columns
//   (`needs_mask`). With a mask or segment ids every tile takes the
//   general path (`general_scores`): once a tile's S has landed, each score
//   becomes s c + bias (base 2) where the pair is seen (the causal / kv_len
//   rule, the segment ids, the mask) and -inf where it is not, then the
//   online softmax runs with c = 1, so a row whose every score is -inf
//   keeps max -inf as above. The mask's values and the kv columns'
//   segment ids come straight from global memory (L2) into registers: at
//   d = 128 the shared memory is full (below), and an f32 mask tile (64
//   KB) could not take a ring stage. A thread's two q rows' segment ids
//   are read once per q tile. No load is issued between a product's issue
//   and its wait: one that was (the seen bits of segment ids and a bool
//   mask, gathered while S was in flight) gave wrong outputs for segment
//   ids on the card (PERF.md, PR 14).
// - Epilogue: O / l rounded to bf16, staged in the warpgroup's own rows of
//   Q's buffer (free once its last S has landed) in the swizzled layout,
//   and stored by one 4-D TMA store per panel, clipped at sq. lse leaves
//   from registers.
// - Shared memory at d = 128, BN = 128, 3 stages: Q 32 KB + 3 x (K, V) 192
//   KB, 225 KB with the barriers and the alignment slack: one CTA per SM.
// paddle_tpu_torch/tools/flash_variants.py times this source against edits
// of it (tile width, ring depth, overlap, ping-pong, grid order; PERF.md).

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

constexpr int BM = 128;           // q rows of a CTA: 2 consumer warpgroups x 64
constexpr int STAGES = 3;         // K/V ring depth
constexpr int THREADS = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int PP_BAR = 1;         // named barriers 1, 2: ping-pong turns
constexpr int EPI_BAR = 3;        // 3, 4: each warpgroup's epilogue
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int BN = 128;                        // kv rows of a tile
  static constexpr int PANELS = D / 64;                 // 64-wide panels of d
  static constexpr int Q_PANEL = BM * 128;              // bytes of one panel of Q
  static constexpr int KV_PANEL = BN * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;    // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;      // K then V
  static constexpr int BARS = 1 + 4 * STAGES;           // Q; full and empty, K and V
  static constexpr int BYTES = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BARS * 8;
  static_assert(KV_PANEL % 1024 == 0, "tiles keep the swizzle atom's alignment");
  static_assert(BYTES <= 232448, "shared memory");
};

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// The rows of one consumer thread: g and g + 8 of its warp's 16, columns
// 8 j + 2 (t % 4) + {0, 1} of every 8-column block j of the tile.
template <int BN>
struct Softmax {
  float m[2];   // running row max of the scaled scores (base 2), -inf: none yet
  float l[2];   // this thread's share of the running row sum

  __device__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
  // s: the raw scores of one tile, turned into p = exp2(s c - m) in place
  // (c: the scale in base 2); lim: the columns [0, lim) each row sees,
  // relative to the tile (masked tiles only). The row's extreme is taken
  // on the raw scores (the max for c > 0, else the min), so each element
  // costs one compare, one FFMA into exp2 and one add. Returns the factors
  // by which O rescales.
  template <bool MASK>
  __device__ void step(float (&s)[BN / 2], float c, const int (&lim)[2], float (&alpha)[2],
                       int t4) {
    const bool pos = c > 0.f;
    const float none = pos ? -INFINITY : INFINITY;
    float ext[2] = {none, none};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, col = 8 * j + 2 * t4 + (e & 1);
        const float x = MASK && col >= lim[r] ? none : s[4 * j + e];
        ext[r] = pos ? fmaxf(ext[r], x) : fminf(ext[r], x);
      }
    float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float o1 = __shfl_xor_sync(0xffffffffu, ext[r], 1);
      ext[r] = pos ? fmaxf(ext[r], o1) : fminf(ext[r], o1);
      const float o2 = __shfl_xor_sync(0xffffffffu, ext[r], 2);
      ext[r] = pos ? fmaxf(ext[r], o2) : fminf(ext[r], o2);
      const float mx = fmaxf(m[r], ext[r] == none ? -INFINITY : ext[r] * c);
      base[r] = mx == -INFINITY ? 0.f : mx;
      alpha[r] = hw::ex2_approx(m[r] - base[r]);   // m = -inf: 0, O and l are 0 anyway
      m[r] = mx;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, col = 8 * j + 2 * t4 + (e & 1);
        float p = hw::ex2_approx(fmaf(s[4 * j + e], c, -base[r]));
        if (MASK && col >= lim[r]) p = 0.f;
        s[4 * j + e] = p;
        sum[r] += p;
      }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
  }
};

// MASKED: a mask or segment ids apply (csrc/flash_mask.cuh); the kernel
// without them is compiled apart, so its code is the same as before masks
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o, float* __restrict__ lse, int sq,
                 int sk, int hq, int hk, int kv_len, int q_offset, int causal, float scale_log2,
                 const ptt::FlashMask fm) {
  using L = Smem<D>;
  constexpr int BN = L::BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;
  uint8_t* sKV = base + L::Q_BYTES;   // stage s: K at sKV + s STAGE_BYTES, V after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sKV + STAGES * L::STAGE_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int t = blockIdx.z;   // from the last q tile down
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = ((sq + BM - 1) / BM - 1 - t) * BM;
  const int kvh = h / (hq / hk);
  const int kv_end = min(kv_len, sk);
  // columns the CTA's rows may see: [0, n_end)
  const int n_end = causal ? min(kv_end, q_offset + min(q0 + BM, sq)) : kv_end;
  const int n_tiles = n_end > 0 ? (n_end + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full_k[s], 1);
      hw::mbar_init(&full_v[s], 1);
      hw::mbar_init(&empty_k[s], 2);
      hw::mbar_init(&empty_v[s], 2);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    hw::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      hw::tma_prefetch(&map_q);
      hw::tma_prefetch(&map_k);
      hw::tma_prefetch(&map_v);
      hw::mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        hw::tma_load_4d(sQ + p * L::Q_PANEL, &map_q, bar_q, 64 * p, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        uint8_t* st = sKV + stage * L::STAGE_BYTES;
        hw::mbar_wait(&empty_k[stage], phase ^ 1);
        hw::mbar_expect_tx(&full_k[stage], L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          hw::tma_load_4d(st + p * L::KV_PANEL, &map_k, &full_k[stage], 64 * p, kvh, j * BN, b);
        hw::mbar_wait(&empty_v[stage], phase ^ 1);
        hw::mbar_expect_tx(&full_v[stage], L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          hw::tma_load_4d(st + L::KV_BYTES + p * L::KV_PANEL, &map_v, &full_v[stage], 64 * p,
                          kvh, j * BN, b);
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
  const int row_lo = 16 * (tid / 32) + lane / 4;   // in the warpgroup's 64; +8 for the other
  const bool leader = tid == 0;
  const hw::PingPong pp{wg, PP_BAR};

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  hw::fence_operand(o);   // zeroed before any wgmma is in flight
  float s[BN / 2];
  uint32_t pa[BN / 16][4];
  Softmax<BN> sm;
  sm.init();

  // the tile's columns [k0, k0 + BN) against this warpgroup's rows
  auto needs_mask = [&](int k0) {
    return k0 + BN > kv_end || (causal && k0 + BN - 1 > q_offset + r0);
  };
  auto row_limits = [&](int k0, int (&lim)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + row_lo + 8 * r;
      lim[r] = (causal ? min(kv_end, q_offset + row + 1) : kv_end) - k0;
    }
  };
  auto issue_s = [&](int stage) {
    const uint64_t q_desc = hw::desc_opaque(hw::desc_k_major(sQ + wg * 64 * 128));
    const uint64_t k_desc = hw::desc_opaque(hw::desc_k_major(sKV + stage * L::STAGE_BYTES));
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk % 4) * 32;   // k16 step within a 128-byte row
      hw::wgmma_ss<BN, 0, 0>(s, hw::desc_advance(q_desc, (kk / 4) * L::Q_PANEL + off),
                             hw::desc_advance(k_desc, (kk / 4) * L::KV_PANEL + off), kk > 0);
    }
    hw::wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
    const uint64_t v_desc = hw::desc_opaque(
        hw::desc_mn_major(sKV + stage * L::STAGE_BYTES + L::KV_BYTES, L::KV_PANEL));
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hw::wgmma_rs<D, 1>(o, pa[kk], hw::desc_advance(v_desc, kk * 2048), 1);
    hw::wgmma_commit();
  };
  // the general path: s c + bias where the pair is seen, -inf where not.
  // Every load is made (at an index kept in bounds) and the select drops
  // what is not seen, so the tile's loads issue together.
  int lim_abs[2], qid[2];
  long long mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row_lo + 8 * r;
    const int at = min(row, sq - 1);   // rows past sq are computed, never stored
    lim_abs[r] = causal ? min(kv_end, q_offset + row + 1) : kv_end;
    qid[r] = MASKED ? fm.q_id(b, sq, at) : 0;
    mrow[r] = fm.row_at(b, h, at);
  }
  auto general_scores = [&](int k0) {
    fm.dispatch([&](auto kind, auto segs) {
      const int* kv_ids = fm.kv_seg;   // of batch b: at b sk + column
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, col = k0 + 8 * j + 2 * t4 + (e & 1);
          const int at = min(col, sk - 1);
          bool seen = col < lim_abs[r];
          if constexpr (decltype(segs)::value)
            seen = seen && kv_ids[(long long)b * sk + at] == qid[r];
          const float x = fmaf(s[4 * j + e], scale_log2,
                               fm.template bias2<decltype(kind)::value>(mrow[r], at));
          s[4 * j + e] = seen ? x : -INFINITY;
        }
    });
  };
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = j * BN;
    if constexpr (MASKED) {
      general_scores(k0);
      const int lim[2] = {BN, BN};
      sm.template step<false>(s, 1.f, lim, alpha, t4);
    } else if (needs_mask(k0)) {
      int lim[2];
      row_limits(k0, lim);
      sm.template step<true>(s, scale_log2, lim, alpha, t4);
    } else {
      const int lim[2] = {BN, BN};
      sm.template step<false>(s, scale_log2, lim, alpha, t4);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hw::pack_a_rs<BN / 2>(pa[kk], s, kk);
  };

  if (n_tiles > 0) {
    pp.start();
    hw::mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    float alpha[2];
    // tile 0: S alone
    hw::mbar_wait(&full_k[stage], phase);
    pp.begin();
    issue_s(stage);
    pp.end();
    hw::wgmma_wait<0>();
    hw::fence_operand(s);
    if (leader) hw::mbar_arrive(&empty_k[stage]);
    softmax(0, alpha);
    pack_p();
    for (int j = 1; j < n_tiles; ++j) {
      int next = stage;
      uint32_t next_phase = phase;
      advance(next, next_phase);
      hw::mbar_wait(&full_k[next], next_phase);
      hw::mbar_wait(&full_v[stage], phase);
      pp.begin();
      issue_s(next);     // S of tile j
      issue_pv(stage);   // O += P V of tile j - 1
      pp.end();
      hw::wgmma_wait<1>();
      hw::fence_operand(s);
      if (leader) hw::mbar_arrive(&empty_k[next]);
      softmax(j, alpha);
      hw::wgmma_wait<0>();
      hw::fence_operand(o);
      hw::fence_operand(pa);
      if (leader) hw::mbar_arrive(&empty_v[stage]);
      rescale(alpha);
      pack_p();
      stage = next;
      phase = next_phase;
    }
    hw::mbar_wait(&full_v[stage], phase);
    pp.begin();
    issue_pv(stage);
    pp.end();
    hw::wgmma_wait<0>();
    hw::fence_operand(o);
    hw::fence_operand(pa);
    if (leader) hw::mbar_arrive(&empty_v[stage]);
    pp.finish();
  }

  // epilogue: full row sums, out = O / l (a row that saw nothing: zeros)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = sm.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
    const int row = r0 + row_lo + 8 * r;
    if (lse != nullptr && t4 == 0 && row < sq)
      // m is base 2 and scaled; a row that saw nothing gets -1e30 ln 2
      lse[(long(b) * hq + h) * sq + row] = l > 0.f ? (sm.m[r] + log2f(l)) * LN2 : -1e30f * LN2;
  }
  // stage as bf16 in this warpgroup's rows of Q's buffer, 128-byte swizzle
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * wg + row_lo + 8 * r;   // in the CTA's 128
      uint8_t* at = sQ + (j / 8) * L::Q_PANEL + row * 128 + (((j % 8) ^ (row % 8)) * 16) + t4 * 4;
      __nv_bfloat162 v = __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r],
                                               o[4 * j + 2 * r + 1] * inv[r]);
      *reinterpret_cast<__nv_bfloat162*>(at) = v;
    }
  hw::fence_proxy_async();
  hw::named_barrier(EPI_BAR + wg, 128);
  if (leader) {
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p)
      hw::tma_store_4d(&map_o, sQ + p * L::Q_PANEL + wg * 64 * 128, 64 * p, h, r0, b);
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int sq, int sk, int hq, int hk, int kv_len, int q_offset, int causal,
                   float scale, const ptt::FlashMask& fm, cudaStream_t stream) {
  using L = Smem<D>;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = bshd_map(&mq, q, b, sq, hq, D, BM);
  if (err == cudaSuccess) err = bshd_map(&mk, k, b, sk, hk, D, L::BN);
  if (err == cudaSuccess) err = bshd_map(&mv, v, b, sk, hk, D, L::BN);
  if (err == cudaSuccess) err = bshd_map(&mo, out, b, sq, hq, D, 64);
  if (err != cudaSuccess) return err;
  static std::atomic<uint64_t> done{0};
  auto kern = flash_fwd_kernel<D, MASKED>;
  err = ptt::allow_smem(kern, L::BYTES, done);
  if (err != cudaSuccess) return err;
  const int ntq = (sq + BM - 1) / BM;
  const dim3 grid(hq, b, ntq);
  kern<<<grid, THREADS, L::BYTES, stream>>>(mq, mk, mv, mo, lse, sq, sk, hq, hk, kv_len,
                                            q_offset, causal, scale * LOG2E, fm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of the forward kernel at head dim d.
int ptt_flash_fwd_smem_bytes(int d) {
  return d == 128 ? Smem<128>::BYTES : d == 64 ? Smem<64>::BYTES : 0;
}

// q [b, sq, hq, d], k/v [b, sk, hk, d], out [b, sq, hq, d]: contiguous,
// 16-byte aligned bf16; lse [b, hq, sq] f32 or null. mask (kind 0: none,
// 1: additive f32, 2: bool bytes) at element (b, h, r, c) mask[b msb + h
// msh + r msr + c]; q_seg [b, sq] and kv_seg [b, sk] int32, both or neither.
// Returns a CUDA error code: of the tensor maps' encoding, of the
// shared-memory opt-in, or cudaGetLastError() after the launch (0 on
// success).
int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
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
  float* l = static_cast<float*>(lse);
  const bool m = fm.any();
  if (d == 128)
    return int(m ? launch<128, true>(q, k, v, out, l, b, sq, sk, hq, hk, kv_len, q_offset,
                                     causal, scale, fm, s)
                 : launch<128, false>(q, k, v, out, l, b, sq, sk, hq, hk, kv_len, q_offset,
                                      causal, scale, fm, s));
  if (d == 64)
    return int(m ? launch<64, true>(q, k, v, out, l, b, sq, sk, hq, hk, kv_len, q_offset, causal,
                                    scale, fm, s)
                 : launch<64, false>(q, k, v, out, l, b, sq, sk, hq, hk, kv_len, q_offset,
                                     causal, scale, fm, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
