// Flash attention forward and backward for Hopper (sm_90a) at the head dims
// the 64 / 128 kernels (flash_attention.cu, flash_attention_bwd.cu) do not
// take: every other multiple of 16 below 128 (16, 32, 48, 80, 96, 112).
// bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py `_fwd`
// (pl.pallas_call at :266) and `_bwd` (at :453) at those head dims, which
// the Pallas kernels take as one full-extent block of d (:270-279,
// :460-466): the UNet's attention (d = 32 at sdxl-small's level 1, 16 in
// unet-tiny) and ViT-H14's (d = 80), self-attention and cross-attention
// (sq != sk) alike. The surface is the 64 / 128 kernels': BSHD layout (q,
// out, dout, dq [b, sq, hq, d]; k, v, dk, dv [b, sk, hk, d], contiguous,
// 16-byte aligned), GQA (query head h reads kv head h / (hq / hk)), causal
// with a bottom-right q_offset (row r sees column c iff c <= q_offset + r),
// kv_len (columns >= kv_len masked), the optional additive f32 or bool mask
// and q / kv segment ids of csrc/flash_mask.cuh (no gradient for the mask),
// the row logsumexp lse [b, hq, sq] in natural-log units (-1e30 ln 2 and
// zeros for a row that sees nothing), and a deterministic backward.
//
// What bounds it on the H100 at the paths' shapes: bytes. ViT-H14 (b 32, 257
// tokens, 16 heads of 80) and the UNet's level 1 (b 32, 256 tokens, 12 heads
// of 32; cross-attention over 77) do 2-4 d operations per byte of q, k, v
// and out, below the card's ~295, so the bound (PERF.md) is the bytes read
// and written once: 0.0253 ms forward / 0.0504 ms backward at ViT-H14,
// 0.0076 / 0.0151 at the UNet. What keeps a kernel from it at these short
// sequences is latency: each (q tile, head) sees 2-5 kv tiles, and every
// tile is a chain of products, a softmax and barriers whose latency only
// other warpgroups' chains can hide (timed, PERF.md: taking the exp2, the
// P V products or the K / V loads out of the forward saves 10%, 6% and 2%
// of it; the mma.sync kernels this source held before reached 14-22% of
// the bound).
//
// Design: warp-specialised wgmma fed by TMA, persistent.
// - Layout: d in panels of COLS columns of ROW-byte swizzled rows: 64
//   columns of 128 bytes (as the 64 / 128 kernels), 32 of 64 bytes at
//   d <= 32 (`row_bytes`). Every 4-D map (d, h, s, b) has d itself as its
//   extent and a box of COLS x 1 x rows x 1, so TMA zero-fills the last
//   panel past d (at d = 80: columns 80-127) and rows past sq or sk, and a
//   TMA store from a staged panel drops the columns past d and the rows past
//   sq or sk. Products whose depth is d (S = Q K^T; S^T, dP^T and dP in the
//   backward) run d / 16 k16 steps; those whose width is d (O += P V, dV,
//   dK, dQ) are wgmma m64n{d}k16 (hopper.cuh's widths 16-112).
// - Warps: NC consumer warpgroups of 64 rows each, then the producer, whose
//   first lane issues every TMA load into a ring of stages with full and
//   empty mbarriers: one warp, or in a forward that holds its SM alone a
//   warpgroup that drops to 24 registers (setmaxnreg) so that its three
//   consumers rise to 160. NC and the CTAs an SM are chosen for the most
//   warpgroups an SM holds: the forward runs three at d 80 and 96 (two at
//   112, where three leave ptxas too few registers and it serialises the
//   wgmmas) in one CTA an SM, and one at d <= 48 in two or more CTAs an SM;
//   the backward two above d = 32, which take turns at issuing wgmma
//   through hopper.cuh's PingPong so that one's exp2 runs under the other's
//   products, and one at d <= 32 in three CTAs an SM.
// - Persistent CTAs, as many as are resident, each walking a static list of
//   units (q tile or kv tile, head, batch) in head order: the tiles of one
//   (head, batch) run at once on neighbouring CTAs, so its K and V (or Q
//   and dO) are read from HBM once and from L2 after. The producer runs
//   ahead across units: Q (and dO) have two buffers, so the next unit's Q
//   and first K / V tiles land while the consumers finish this one. The
//   epilogue stages its output in the warpgroup's own rows of the unit's Q
//   buffer (or K / V buffer) in the swizzled layout and writes it by TMA
//   store; the buffer goes back to the producer once the store has read it,
//   checked after the next unit's first products are issued.
// - Forward: per unit (64 NC q rows, query head, batch), K and V tiles of
//   BN = 64 rows (257 columns cost 320) stream through STAGES stages, with
//   separate K and V barriers so S starts before V lands. S = Q K^T (wgmma
//   SS, both K-major), the online softmax in base 2 on the accumulator
//   (flash_attention.cu's), O += P V (wgmma RS, P packed from S, V
//   MN-major); S of tile j + 1 is issued with the P V of tile j.
// - Backward: the FlashAttention-2 split, three kernels.
//   1. delta = rowsum(dO * O) in f32, a power of two of threads a row, each
//      loading 16 bytes of both (bytes-bound; PERF.md gives its time);
//   2. dK/dV: per unit (64 NC kv rows, kv head, batch) K and V in one of two
//      buffers (the next unit's load lands in the other while this one's
//      epilogue stores from it), Q and dO tiles of QS rows with their lse2,
//      delta and segment ids streaming through the ring over the group's
//      query heads and the q tiles the causal band allows; per tile S^T = K
//      Q^T, P^T = exp2(S^T c - lse2), dP^T = V dO^T, dS^T = P^T (dP^T -
//      delta), dV += P^T dO, dK += dS^T Q, in two groups of products at
//      d <= 48 (S^T with dP^T, dV with dK) and three above (S^T; dV with
//      dP^T; dK), where both score tiles beside dK and dV would not fit the
//      registers; dK and dV summed over the GQA group inside the CTA, so
//      nothing is atomic;
//   3. dQ: per unit (64 NC q rows, query head, batch) Q and dO loaded once,
//      K and V tiles streaming: S and dP (SS), dS, dQ += dS K (RS).
//   A unit whose second warpgroup holds no row (257 rows in units of 128
//   leave one) runs on the first alone, without turns; the second only
//   hands the stages back and stores its zeros.
//   The products and the masked scores are flash_attention_bwd.cu's; no
//   accumulator is rewritten between a wgmma's issue and its wait, and no
//   wgmma sits on a branch a warpgroup could split on (ptxas serialises
//   every wgmma of a kernel for either, C7515 / C7518).
// Masks as in the 64 / 128 kernels: tiles past the last visible column are
// never loaded, a tile wholly visible runs without a mask, and with a mask
// or segment ids (the MASKED instantiation) each score becomes s c + bias
// where the pair is seen and -inf where not, the mask's values read straight
// from global memory (L2).
// paddle_tpu_torch/tools/flash_variants.py times this source against edits
// of its knobs (warpgroups and CTAs an SM, kv tile, persistence, unit
// order, swizzle, ring depth, q step, groups of products; PERF.md), and
// tools/cpu_rehearsal.py runs it on the CPU against the stand-ins of
// tools/cpu_stub/.

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

constexpr int PP_BAR = 1;     // named barriers 1, 2: ping-pong turns
constexpr int EPI_BAR = 3;    // 3, 4: each consumer warpgroup's epilogue
constexpr bool PERSISTENT = true;   // false: one CTA a unit
// units in head order: the q (or kv) tiles of one (head, batch) next to each
// other, so that its K and V (or Q and dO) stay in L2 while they run; else
// tile order, the longest tiles of every head first
constexpr bool HEAD_MAJOR = true;
constexpr int SMEM_MAX = 232448;    // dynamic shared memory of one CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the head dims compiled here (the 64 / 128 kernels take those two)
#define PTT_MMA_HEAD_DIMS(X) X(16) X(32) X(48) X(80) X(96) X(112)

// bytes of a row of one panel of d (the swizzle: 128, 64 or 32): 64 at
// d <= 32, which halves the zero-filled columns (timed a little faster)
template <int D>
constexpr int row_bytes() {
  return D <= 32 ? 64 : 128;
}

// d in panels of COLS columns, rows of ROW bytes in the ROW-byte swizzle
template <int D>
struct Panels {
  static_assert(D % 16 == 0 && D < 128, "head dim: a multiple of 16 below 128");
  static constexpr int ROW = row_bytes<D>();
  static constexpr int COLS = ROW / 2;
  static constexpr int N = (D + COLS - 1) / COLS;
  static constexpr int KPP = COLS / 16;   // k16 steps a panel
  // bytes from a K-major tile's start to its k16 step kk (panels `panel`
  // bytes apart)
  static __device__ __forceinline__ int koff(int kk, int panel) {
    return (kk / KPP) * panel + (kk % KPP) * 32;
  }
  // the byte of a tile (8-row atoms of 8 ROW bytes) at which byte `c` of
  // row `r` of a panel sits, swizzled
  static __device__ __forceinline__ int at(int r, int c) {
    const int a = r * ROW + c;
    return a ^ (((a >> 7) & (ROW / 16 - 1)) << 4);
  }
  // descriptors: K-major, and MN-major with panels `panel` bytes apart
  static __device__ __forceinline__ uint64_t k_major(const void* p) {
    return hw::desc_sw<ROW>(p, 16);
  }
  static __device__ __forceinline__ uint64_t mn_major(const void* p, int panel) {
    return hw::desc_sw<ROW>(p, panel);
  }
};

// the ring depth: `want`, or as many stages of `stage` bytes as fit beside
// `fixed` bytes
constexpr int fit_stages(int want, int fixed, int stage) {
  return (SMEM_MAX - fixed) / stage < want ? (SMEM_MAX - fixed) / stage : want;
}

// registers a consumer thread may rise to once a producer warpgroup has
// dropped to PRODUCER_REGS (setmaxnreg: multiples of 8, at most 240)
constexpr int PRODUCER_REGS = 24;
constexpr int consumer_regs(int nc) {
  return (65536 - 128 * PRODUCER_REGS) / (128 * nc) / 8 * 8 < 240
             ? (65536 - 128 * PRODUCER_REGS) / (128 * nc) / 8 * 8
             : 240;
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// turns of the NC consumer warpgroups at issuing wgmma (none for one, and
// none for a unit in which `on` is false for both)
template <int NC>
struct Turns {
  hw::PingPong pp;
  __device__ void start() const {
    if constexpr (NC == 2) pp.start();
  }
  __device__ void begin(bool on = true) const {
    if constexpr (NC == 2)
      if (on) pp.begin();
  }
  __device__ void end(bool on = true) const {
    if constexpr (NC == 2)
      if (on) pp.end();
  }
  __device__ void finish() const {
    if constexpr (NC == 2) pp.finish();
  }
};

// rows [0, 64) of an f32 accumulator (64 x D, this warpgroup's layout) as
// bf16, times `mul`, into rows [row0, row0 + 64) of a swizzled tile of
// `panel` bytes a panel
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* tile, int panel, int row0,
                                           const float (&acc)[D / 2], float mul, int tid) {
  using P = Panels<D>;
  const int t4 = tid % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
      uint8_t* at = tile + (j / (P::COLS / 8)) * panel +
                    P::at(row, (j % (P::COLS / 8)) * 16 + t4 * 4);
      *reinterpret_cast<__nv_bfloat162*>(at) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
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

// f(kind, segs) as FlashMask::dispatch gives them with MASKED; without, no
// mask and no segment ids
template <bool MASKED, class F>
__device__ __forceinline__ void with_mask(const ptt::FlashMask& fm, F&& f) {
  if constexpr (MASKED)
    fm.dispatch(f);
  else
    f(std::integral_constant<int, ptt::FlashMask::NONE>{}, std::false_type{});
}

// ------------------------------------------------------------------ forward
template <int D>
struct Fwd {
  using P = Panels<D>;
  // consumer warpgroups of 64 q rows and CTAs an SM that the registers must
  // allow: above d = 64, where a CTA fills an SM's shared memory, three (two
  // at 112, where three leave too few registers and ptxas serialises the
  // wgmmas) and one; else one and two or more (64-row units): the most
  // warpgroups an SM holds, whose chains of products and softmax hide each
  // other's latency
  static constexpr int NC = D > 96 ? 2 : D > 64 ? 3 : 1;
  static constexpr int MIN_BLOCKS = D > 64 ? 1 : 2;
  static constexpr int BM = 64 * NC;    // q rows of a unit
  static constexpr int BN = 64;         // kv rows of a tile
  // the producer: a whole warpgroup where one CTA holds the SM, so that it
  // can hand its registers to the consumers (setmaxnreg), else one warp (in
  // the backward always one warp: dK/dV's writes lse and delta and spills
  // at the producer's 24 registers, PERF.md)
  static constexpr bool PRODUCER_WG = MIN_BLOCKS == 1;
  static constexpr int THREADS = 128 * NC + (PRODUCER_WG ? 128 : 32);
  static constexpr int CONSUMER_REGS = consumer_regs(NC);
  static constexpr int Q_PANEL = BM * P::ROW;
  static constexpr int Q_BYTES = P::N * Q_PANEL;   // Q, then O's staging
  static constexpr int KV_PANEL = BN * P::ROW;
  static constexpr int KV_BYTES = P::N * KV_PANEL;   // one K or V tile
  // two Q buffers (this unit's and the next), their full and empty barriers
  static constexpr int FIXED = 1024 + 2 * (Q_BYTES + 2 * 8);
  static constexpr int PER_STAGE = 2 * KV_BYTES + 4 * 8;
  static constexpr int STAGES = fit_stages(3, FIXED, PER_STAGE);
  static constexpr int BYTES = FIXED + STAGES * PER_STAGE;
  static_assert(BYTES <= SMEM_MAX && KV_PANEL % 1024 == 0, "shared memory");
};

template <int D, bool MASKED>
__global__ void __launch_bounds__(Fwd<D>::THREADS, Fwd<D>::MIN_BLOCKS)
flash_mma_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o, float* __restrict__ lse, int nb,
                     int sq, int sk, int hq, int hk, int kv_len, int q_offset, int causal,
                     float scale_log2, const ptt::FlashMask fm) {
  using L = Fwd<D>;
  using P = typename L::P;
  constexpr int NC = L::NC, BM = L::BM, BN = L::BN, ST = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQs = base;   // Q buffer i at sQs + i Q_BYTES: Q, then O
  uint8_t* sKV = sQs + 2 * L::Q_BYTES;   // stage s: K at sKV + 2 s KV_BYTES, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + ST * 2 * L::KV_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full_k = q_full + 4;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;

  const int ntq = (sq + BM - 1) / BM;
  const int units = ntq * hq * nb;
  const int kv_end = min(kv_len, sk);
  // unit u: q rows [q0, q0 + BM) of head h, batch b, from the last q tile
  // down; returns the number of kv tiles its rows see
  auto unit = [&](int u, int& q0, int& h, int& b) {
    const int t = HEAD_MAJOR ? u % ntq : u / (hq * nb);
    const int r = HEAD_MAJOR ? u / ntq : u % (hq * nb);
    h = r % hq;
    b = r / hq;
    q0 = (ntq - 1 - t) * BM;
    const int n_end = causal ? min(kv_end, q_offset + min(q0 + BM, sq)) : kv_end;
    return n_end > 0 ? (n_end + BN - 1) / BN : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hw::mbar_init(&q_full[i], 1);
      hw::mbar_init(&q_empty[i], NC);
    }
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&full_k[s], 1);
      hw::mbar_init(&full_v[s], 1);
      hw::mbar_init(&empty_k[s], NC);
      hw::mbar_init(&empty_v[s], NC);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {   // the producer: lane 0 of its first warp issues every load
    if constexpr (L::PRODUCER_WG) hw::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 128 * NC) return;
    hw::tma_prefetch(&map_q);
    hw::tma_prefetch(&map_k);
    hw::tma_prefetch(&map_v);
    int stage = 0, k = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      int q0, h, b;
      const int n_tiles = unit(u, q0, h, b);
      const int kvh = h / (hq / hk);
      // Q into this unit's buffer once the unit before last has stored its
      // O from it (a unit that sees nothing still takes its turn)
      uint64_t* full = &q_full[k % 2];
      hw::mbar_wait(&q_empty[k % 2], ((k / 2) & 1) ^ 1);
      if (n_tiles > 0) {
        hw::mbar_expect_tx(full, L::Q_BYTES);
#pragma unroll
        for (int p = 0; p < P::N; ++p)
          hw::tma_load_4d(sQs + (k % 2) * L::Q_BYTES + p * L::Q_PANEL, &map_q, full, P::COLS * p,
                          h, q0, b);
      } else {
        hw::mbar_arrive(full);
      }
      for (int j = 0; j < n_tiles; ++j) {
        uint8_t* st = sKV + stage * 2 * L::KV_BYTES;
        hw::mbar_wait(&empty_k[stage], phase ^ 1);
        hw::mbar_expect_tx(&full_k[stage], L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < P::N; ++p)
          hw::tma_load_4d(st + p * L::KV_PANEL, &map_k, &full_k[stage], P::COLS * p, kvh, j * BN,
                          b);
        hw::mbar_wait(&empty_v[stage], phase ^ 1);
        hw::mbar_expect_tx(&full_v[stage], L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < P::N; ++p)
          hw::tma_load_4d(st + L::KV_BYTES + p * L::KV_PANEL, &map_v, &full_v[stage],
                          P::COLS * p, kvh, j * BN, b);
        advance(stage, phase, ST);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64) of each unit
  if constexpr (L::PRODUCER_WG) hw::setmaxnreg_inc<L::CONSUMER_REGS>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const int row_lo = 16 * (tid / 32) + lane / 4;   // in the warpgroup's 64; +8 for the other
  const bool leader = tid == 0;
  const Turns<NC> turns{{wg, PP_BAR}};

  float o[D / 2];
  float s[BN / 2];
  uint32_t pa[BN / 16][4];
  Softmax<BN> sm;
  uint8_t* sQ = sQs;   // this unit's Q buffer
  auto issue_s = [&](int stage) {
    const uint64_t q_desc = hw::desc_opaque(P::k_major(sQ + wg * 64 * P::ROW));
    const uint64_t k_desc = hw::desc_opaque(P::k_major(sKV + stage * 2 * L::KV_BYTES));
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss<BN, 0, 0>(s, hw::desc_advance(q_desc, P::koff(kk, L::Q_PANEL)),
                             hw::desc_advance(k_desc, P::koff(kk, L::KV_PANEL)), kk > 0);
    hw::wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
    const uint64_t v_desc = hw::desc_opaque(
        P::mn_major(sKV + stage * 2 * L::KV_BYTES + L::KV_BYTES, L::KV_PANEL));
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hw::wgmma_rs<D, 1>(o, pa[kk], hw::desc_advance(v_desc, kk * 16 * P::ROW), 1);
    hw::wgmma_commit();
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hw::pack_a_rs<BN / 2>(pa[kk], s, kk);
  };
  // the leader hands the last unit's Q buffer back once its O store has
  // read it: after this unit's first products are issued, so the wait is
  // not on the products' path
  int owed = -1;
  auto release = [&]() {
    if (owed >= 0 && leader) {
      hw::tma_store_wait_read<0>();
      hw::mbar_arrive(&q_empty[owed]);
    }
    owed = -1;
  };

  turns.start();
  int stage = 0, k = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    int q0, h, b;
    const int n_tiles = unit(u, q0, h, b);
    const int r0 = q0 + 64 * wg;
    sQ = sQs + (k % 2) * L::Q_BYTES;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    hw::fence_operand(o);   // zeroed while no wgmma is in flight
    sm.init();

    // the tile's columns [k0, k0 + BN) against this warpgroup's rows
    auto needs_mask = [&](int k0) {
      return k0 + BN > kv_end || (causal && k0 + BN - 1 > q_offset + r0);
    };
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
    // the general path: s c + bias where the pair is seen, -inf where not
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
        const int lim[2] = {lim_abs[0] - k0, lim_abs[1] - k0};
        sm.template step<true>(s, scale_log2, lim, alpha, t4);
      } else {
        const int lim[2] = {BN, BN};
        sm.template step<false>(s, scale_log2, lim, alpha, t4);
      }
    };

    hw::mbar_wait(&q_full[k % 2], (k / 2) & 1);   // Q has landed (or the unit sees nothing)
    if (n_tiles > 0) {
      float alpha[2];
      // tile 0: S alone
      hw::mbar_wait(&full_k[stage], phase);
      turns.begin();
      issue_s(stage);
      turns.end();
      release();
      hw::wgmma_wait<0>();
      hw::fence_operand(s);
      if (leader) hw::mbar_arrive(&empty_k[stage]);
      softmax(0, alpha);
      pack_p();
      for (int j = 1; j < n_tiles; ++j) {
        int next = stage;
        uint32_t next_phase = phase;
        advance(next, next_phase, ST);
        hw::mbar_wait(&full_k[next], next_phase);
        hw::mbar_wait(&full_v[stage], phase);
        turns.begin();
        issue_s(next);     // S of tile j
        issue_pv(stage);   // O += P V of tile j - 1
        turns.end();
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
      turns.begin();
      issue_pv(stage);
      turns.end();
      hw::wgmma_wait<0>();
      hw::fence_operand(o);
      hw::fence_operand(pa);
      if (leader) hw::mbar_arrive(&empty_v[stage]);
      advance(stage, phase, ST);
    }
    release();

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
    // this warpgroup's rows of Q are its own once its last S has landed:
    // stage O there and store it by TMA, clipped at sq and d
    rescale(inv);
    stage_rows<D>(sQ, L::Q_PANEL, 64 * wg, o, 1.f, tid);
    hw::fence_proxy_async();
    hw::named_barrier(EPI_BAR + wg, 128);
    if (leader) {
#pragma unroll
      for (int p = 0; p < P::N; ++p)
        hw::tma_store_4d(&map_o, sQ + p * L::Q_PANEL + wg * 64 * P::ROW, P::COLS * p, h, r0, b);
      hw::tma_store_commit();
    }
    owed = k % 2;
  }
  release();
  turns.finish();
}

// ------------------------------------------------------------------ backward
// delta[b, h, r] = sum_d dO[b, r, h, d] * O[b, r, h, d] in f32: TPR threads
// a row (d / 8 of them load 16 bytes of each tensor, the rest add 0), so a
// warp's loads cover 32 / TPR whole rows, and the row's sum is one fixed
// shuffle tree (the same bits every run)
template <int D>
__global__ void __launch_bounds__(256)
flash_mma_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int b, int sq, int hq) {
  constexpr int TPR = D / 8 <= 2 ? 2 : D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : 16;
  const long rows = long(b) * sq * hq;
  const long row = (long(blockIdx.x) * 256 + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows && part < D / 8) {
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
struct Dkdv {
  using P = Panels<D>;
  // consumer warpgroups of 64 kv rows and CTAs an SM that the registers
  // must allow: one and three at d <= 32, else two (taking turns) and one
  // (at 48, three CTAs leave ptxas too few registers: it serialises)
  static constexpr int NC = D <= 32 ? 1 : 2;
  static constexpr int MIN_BLOCKS = D <= 32 ? 3 : 1;
  static constexpr int BKV = 64 * NC;   // kv rows of a unit
  static constexpr int QS = D > 80 ? 32 : 64;   // q rows of a step (registers above 80)
  // S^T with dP^T, then dV with dK: two groups of products a step where the
  // registers hold both score tiles beside dK and dV, else three (S^T; dV
  // with dP^T; dK), so that one score tile is live at a time
  static constexpr bool TWO_GROUPS = D <= 48;
  // a unit whose second warpgroup holds no kv row (257 rows: the third unit
  // of 128 holds one) runs on the first alone: the second only hands the
  // stages back, and neither takes turns
  static constexpr bool SKIP_IDLE_WG = true;
  static constexpr int KV_BUFS = 2;     // K and V of this unit and the next
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int KV_PANEL = BKV * P::ROW;
  static constexpr int KV_BYTES = P::N * KV_PANEL;   // K or V
  static constexpr int Q_PANEL = QS * P::ROW;
  static constexpr int Q_BYTES = P::N * Q_PANEL;     // one Q or dO tile
  // Q, dO, then lse2, delta [QS] f32 and the q rows' segment ids [QS]
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 1024;
  static constexpr int FIXED = 1024 + KV_BUFS * (2 * KV_BYTES + 2 * 8);
  static constexpr int PER_STAGE = STAGE_BYTES + 2 * 8;
  static constexpr int STAGES = fit_stages(3, FIXED, PER_STAGE);
  static constexpr int BYTES = FIXED + STAGES * PER_STAGE;
  static_assert(Q_PANEL % 1024 == 0 && 3 * QS * 4 <= 1024, "swizzle atom alignment");
  static_assert(BYTES <= SMEM_MAX, "shared memory");
};

// MASKED: a mask or segment ids apply (csrc/flash_mask.cuh); the kernels
// without them are compiled apart
template <int D, bool MASKED>
__global__ void __launch_bounds__(Dkdv<D>::THREADS, Dkdv<D>::MIN_BLOCKS)
flash_mma_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_dk,
                      const __grid_constant__ CUtensorMap map_dv, const float* __restrict__ lse,
                      const float* __restrict__ delta, int nb, int sq, int sk, int hq, int hk,
                      int kv_len, int q_offset, int causal, float scale, float scale_log2,
                      const ptt::FlashMask fm) {
  using L = Dkdv<D>;
  using P = typename L::P;
  constexpr int NC = L::NC, QS = L::QS, ST = L::STAGES, BUFS = L::KV_BUFS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sKV = base;   // buffer i: K at sKV + 2 i KV_BYTES, V after it
  uint8_t* ring = sKV + BUFS * 2 * L::KV_BYTES;   // stage s: Q, dO, lse2, delta, q ids
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE_BYTES);
  uint64_t* kv_empty = kv_full + BUFS;
  uint64_t* full = kv_empty + BUFS;
  uint64_t* empty = full + ST;

  const int nkv = (sk + L::BKV - 1) / L::BKV;
  const int units = nkv * hk * nb;
  const int group = hq / hk;
  const int kv_end = min(kv_len, sk);
  const int ntq = (sq + QS - 1) / QS;
  // unit u: kv rows [n0, n0 + BKV) of kv head kvh, batch b, the blocks
  // that see the most q rows first; t0: its first q tile, nt its q tiles
  // (of each query head of the group)
  auto unit = [&](int u, int& n0, int& kvh, int& b, int& t0) {
    const int t = HEAD_MAJOR ? u % nkv : u / (hk * nb);
    const int r = HEAD_MAJOR ? u / nkv : u % (hk * nb);
    kvh = r % hk;
    b = r / hk;
    n0 = t * L::BKV;
    const int i_min = causal ? max(0, n0 - q_offset) : 0;   // the first q row that sees it
    t0 = i_min / QS;
    return (n0 < kv_end && i_min < sq) ? ntq - t0 : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < BUFS; ++i) {
      hw::mbar_init(&kv_full[i], 1);
      hw::mbar_init(&kv_empty[i], NC);
    }
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&full[s], 32);   // every producer lane, one with the bytes
      hw::mbar_init(&empty[s], NC);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {   // the producer warp: lane 0 issues TMA
    const int lane = threadIdx.x - 128 * NC;
    if (lane == 0) {
      hw::tma_prefetch(&map_q);
      hw::tma_prefetch(&map_do);
    }
    int stage = 0, k = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      int n0, kvh, b, t0;
      const int nt = unit(u, n0, kvh, b, t0);
      const int iters = nt * group;   // (query head of the group, q tile) pairs
      if (lane == 0) {
        // K and V into this unit's buffer once its last user has stored
        // from it (a unit that sees no q row still takes its turn)
        uint8_t* sK = sKV + (k % BUFS) * 2 * L::KV_BYTES;
        hw::mbar_wait(&kv_empty[k % BUFS], ((k / BUFS) & 1) ^ 1);
        if (iters > 0) {
          hw::mbar_expect_tx(&kv_full[k % BUFS], 2 * L::KV_BYTES);
#pragma unroll
          for (int p = 0; p < P::N; ++p) {
            hw::tma_load_4d(sK + p * L::KV_PANEL, &map_k, &kv_full[k % BUFS], P::COLS * p, kvh,
                            n0, b);
            hw::tma_load_4d(sK + L::KV_BYTES + p * L::KV_PANEL, &map_v, &kv_full[k % BUFS],
                            P::COLS * p, kvh, n0, b);
          }
        } else {
          hw::mbar_arrive(&kv_full[k % BUFS]);
        }
      }
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
          for (int p = 0; p < P::N; ++p) {
            hw::tma_load_4d(st + p * L::Q_PANEL, &map_q, &full[stage], P::COLS * p, h, q0, b);
            hw::tma_load_4d(st + L::Q_BYTES + p * L::Q_PANEL, &map_do, &full[stage],
                            P::COLS * p, h, q0, b);
          }
        } else {
          hw::mbar_arrive(&full[stage]);
        }
        advance(stage, phase, ST);
      }
    }
    return;
  }

  // consumer warpgroup wg: kv rows [n0 + 64 wg, n0 + 64 wg + 64) of each unit
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const bool leader = tid == 0;
  const Turns<NC> turns{{wg, PP_BAR}};

  float dk[D / 2], dv[D / 2];
  float s[QS / 2], dp[QS / 2];
  uint32_t pa[QS / 16][4], da[QS / 16][4];

  // A x B^T into acc: A this warpgroup's 64 rows of K or V, B the stage's
  // Q or dO tile (every operand K-major)
  auto issue_nt = [&](float (&acc)[QS / 2], const uint8_t* a_tile, const uint8_t* b_tile) {
    const uint64_t a0 = hw::desc_opaque(P::k_major(a_tile));
    const uint64_t b0 = hw::desc_opaque(P::k_major(b_tile));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hw::wgmma_ss<QS, 0, 0>(acc, hw::desc_advance(a0, P::koff(kk, L::KV_PANEL)),
                             hw::desc_advance(b0, P::koff(kk, L::Q_PANEL)), kk > 0);
  };
  // acc += A B: A (64 kv rows x QS q) from registers, B the stage's dO or Q
  // tile, MN-major
  auto issue_nn = [&](float (&acc)[D / 2], const uint32_t (&a)[QS / 16][4],
                      const uint8_t* b_tile) {
    const uint64_t b0 = hw::desc_opaque(P::mn_major(b_tile, L::Q_PANEL));
#pragma unroll
    for (int kk = 0; kk < QS / 16; ++kk)
      hw::wgmma_rs<D, 1>(acc, a[kk], hw::desc_advance(b0, kk * 16 * P::ROW), 1);
  };

  turns.start();
  int stage = 0, k = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    int n0, kvh, b, t0;
    const int nt = unit(u, n0, kvh, b, t0);
    const int iters = nt * group;
    const int j0 = n0 + 64 * wg;
    const int row_lo = j0 + 16 * (tid / 32) + lane / 4;   // kv rows row_lo, row_lo + 8
    uint8_t* sK = sKV + (k % BUFS) * 2 * L::KV_BYTES;
    uint8_t* sV = sK + L::KV_BYTES;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    // pinned here, while no wgmma is in flight (C7515)
    hw::fence_operand(dk);
    hw::fence_operand(dv);

    int kvid[2], kv_at[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kv_at[r] = min(row_lo + 8 * r, sk - 1);
      kvid[r] = MASKED ? fm.kv_id(b, sk, kv_at[r]) : 0;
    }
    // P^T of a step (column i of the tile: q row q0 + i; row r: kv row
    // row_lo + 8 r), packed; masked: every load is made (at an index kept
    // in bounds) and the select drops what is not seen
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
      auto tile = [&](auto kind, auto segs) {
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 8 * kk + 2 * i + e, r = (idx % 4) / 2;
              const int col = 8 * (idx / 4) + 2 * t4 + e;
              bool seen = !mask || (col >= lo[r] && col < hi);
              if constexpr (decltype(segs)::value) seen = seen && st_seg[col] == kvid[r];
              float arg = -st_lse[col];
              if constexpr (decltype(kind)::value != ptt::FlashMask::NONE)
                arg += fm.template bias2<decltype(kind)::value>(
                    fm.row_at(b, hh, min(q0 + col, sq - 1)), kv_at[r]);
              const float x = hw::ex2_approx(fmaf(s[idx], scale_log2, arg));
              p[e] = seen ? x : 0.f;
            }
            pa[kk][i] = hw::pack_bf16x2(p[0], p[1]);
          }
      };
      with_mask<MASKED>(fm, tile);
    };
    auto dscores = [&](const float* st_delta) {
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = 8 * kk + 2 * i, col = 8 * (idx / 4) + 2 * t4;
          const float2 p =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[kk][i]));
          da[kk][i] = hw::pack_bf16x2(p.x * (dp[idx] - st_delta[col]),
                                      p.y * (dp[idx + 1] - st_delta[col + 1]));
        }
    };

    hw::mbar_wait(&kv_full[k % BUFS], (k / BUFS) & 1);
    const uint8_t* kw = sK + wg * 64 * P::ROW;   // this warpgroup's rows of K
    const uint8_t* vw = sV + wg * 64 * P::ROW;
    const bool solo = L::SKIP_IDLE_WG && NC == 2 && n0 + 64 >= kv_end;
    for (int it = 0; it < iters; ++it) {
      const uint8_t* sQ = ring + stage * L::STAGE_BYTES;
      const uint8_t* sDO = sQ + L::Q_BYTES;
      const float* st_lse = reinterpret_cast<const float*>(sQ + 2 * L::Q_BYTES);
      hw::mbar_wait(&full[stage], phase);
      if (solo && wg == 1) {   // no kv row here: dK and dV stay 0
        if (leader) hw::mbar_arrive(&empty[stage]);
        advance(stage, phase, ST);
        continue;
      }
      if constexpr (L::TWO_GROUPS) {
        turns.begin(!solo);
        hw::wgmma_fence();
        issue_nt(s, kw, sQ);    // S^T = K Q^T
        issue_nt(dp, vw, sDO);  // dP^T = V dO^T
        hw::wgmma_commit();
        turns.end(!solo);
        hw::wgmma_wait<0>();
        hw::fence_operand(s);
        hw::fence_operand(dp);
        probs(st_lse, (t0 + it % nt) * QS, kvh * group + it / nt);
        dscores(st_lse + QS);
        turns.begin(!solo);
        hw::wgmma_fence();
        issue_nn(dv, pa, sDO);   // dV += P^T dO
        issue_nn(dk, da, sQ);    // dK += dS^T Q
        hw::wgmma_commit();
        turns.end(!solo);
        hw::wgmma_wait<0>();
        hw::fence_operand(dv);
      } else {
        turns.begin(!solo);
        hw::wgmma_fence();
        issue_nt(s, kw, sQ);   // S^T = K Q^T
        hw::wgmma_commit();
        turns.end(!solo);
        hw::wgmma_wait<0>();
        hw::fence_operand(s);
        probs(st_lse, (t0 + it % nt) * QS, kvh * group + it / nt);
        turns.begin(!solo);
        hw::wgmma_fence();
        issue_nn(dv, pa, sDO);   // dV += P^T dO
        issue_nt(dp, vw, sDO);   // dP^T = V dO^T
        hw::wgmma_commit();
        turns.end(!solo);
        hw::wgmma_wait<0>();
        hw::fence_operand(dv);
        hw::fence_operand(dp);
        dscores(st_lse + QS);
        turns.begin(!solo);
        hw::wgmma_fence();
        issue_nn(dk, da, sQ);   // dK += dS^T Q
        hw::wgmma_commit();
        turns.end(!solo);
        hw::wgmma_wait<0>();
      }
      hw::fence_operand(dk);
      hw::fence_operand(pa);
      hw::fence_operand(da);
      if (leader) hw::mbar_arrive(&empty[stage]);   // the step's products have landed
      advance(stage, phase, ST);
    }

    // this warpgroup's rows of K and V are its own from here: stage dK
    // (scaled once) and dV there and store them by TMA, clipped at sk; the
    // buffer is free for a later unit once the stores have read it
    stage_rows<D>(sK, L::KV_PANEL, 64 * wg, dk, scale, tid);
    stage_rows<D>(sV, L::KV_PANEL, 64 * wg, dv, 1.f, tid);
    hw::fence_proxy_async();
    hw::named_barrier(EPI_BAR + wg, 128);
    if (leader) {
#pragma unroll
      for (int p = 0; p < P::N; ++p) {
        hw::tma_store_4d(&map_dk, sK + p * L::KV_PANEL + wg * 64 * P::ROW, P::COLS * p, kvh, j0,
                         b);
        hw::tma_store_4d(&map_dv, sV + p * L::KV_PANEL + wg * 64 * P::ROW, P::COLS * p, kvh, j0,
                         b);
      }
      hw::tma_store_commit();
      hw::tma_store_wait_read<0>();
      hw::mbar_arrive(&kv_empty[k % BUFS]);
    }
  }
  turns.finish();
}

// ----------------------------------------------------------------------- dQ
template <int D>
struct Dq {
  using P = Panels<D>;
  // consumer warpgroups of 64 q rows and CTAs an SM, as dK/dV's
  static constexpr int NC = D <= 32 ? 1 : 2;
  static constexpr int MIN_BLOCKS = D <= 32 ? 3 : 1;
  static constexpr int BQ = 64 * NC;    // q rows of a unit
  static constexpr int KS = 64;         // kv rows of a step
  // a unit whose second warpgroup holds no q row runs on the first alone
  static constexpr bool SKIP_IDLE_WG = true;
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int Q_PANEL = BQ * P::ROW;
  static constexpr int Q_BYTES = P::N * Q_PANEL;     // Q (then dQ's staging) or dO
  static constexpr int KV_PANEL = KS * P::ROW;
  static constexpr int KV_BYTES = P::N * KV_PANEL;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // two Q and dO buffers (this unit's and the next), their barriers
  static constexpr int FIXED = 1024 + 2 * (2 * Q_BYTES + 2 * 8);
  static constexpr int PER_STAGE = STAGE_BYTES + 2 * 8;
  static constexpr int STAGES = fit_stages(3, FIXED, PER_STAGE);
  static constexpr int BYTES = FIXED + STAGES * PER_STAGE;
  static_assert(KV_PANEL % 1024 == 0 && BYTES <= SMEM_MAX, "shared memory");
};

template <int D, bool MASKED>
__global__ void __launch_bounds__(Dq<D>::THREADS, Dq<D>::MIN_BLOCKS)
flash_mma_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dq, const float* __restrict__ lse,
                    const float* __restrict__ delta, int nb, int sq, int sk, int hq, int hk,
                    int kv_len, int q_offset, int causal, float scale, float scale_log2,
                    const ptt::FlashMask fm) {
  using L = Dq<D>;
  using P = typename L::P;
  constexpr int NC = L::NC, BQ = L::BQ, KS = L::KS, ST = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQs = base;   // buffer i: Q (then dQ) at sQs + 2 i Q_BYTES, dO after it
  uint8_t* ring = sQs + 4 * L::Q_BYTES;   // stage s: K, V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_full + 4;
  uint64_t* empty = full + ST;

  const int ntq = (sq + BQ - 1) / BQ;
  const int units = ntq * hq * nb;
  const int kv_end = min(kv_len, sk);
  auto unit = [&](int u, int& q0, int& h, int& b) {
    const int t = HEAD_MAJOR ? u % ntq : u / (hq * nb);
    const int r = HEAD_MAJOR ? u / ntq : u % (hq * nb);
    h = r % hq;
    b = r / hq;
    q0 = (ntq - 1 - t) * BQ;
    const int n_end = causal ? min(kv_end, q_offset + min(q0 + BQ, sq)) : kv_end;
    return n_end > 0 ? (n_end + KS - 1) / KS : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hw::mbar_init(&q_full[i], 1);
      hw::mbar_init(&q_empty[i], NC);
    }
    for (int s = 0; s < ST; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], NC);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {   // the producer warp: lane 0 issues every load
    if (threadIdx.x != 128 * NC) return;
    hw::tma_prefetch(&map_k);
    hw::tma_prefetch(&map_v);
    int stage = 0, k = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      int q0, h, b;
      const int n_tiles = unit(u, q0, h, b);
      const int kvh = h / (hq / hk);
      uint8_t* sQ = sQs + (k % 2) * 2 * L::Q_BYTES;
      hw::mbar_wait(&q_empty[k % 2], ((k / 2) & 1) ^ 1);
      if (n_tiles > 0) {
        hw::mbar_expect_tx(&q_full[k % 2], 2 * L::Q_BYTES);
#pragma unroll
        for (int p = 0; p < P::N; ++p) {
          hw::tma_load_4d(sQ + p * L::Q_PANEL, &map_q, &q_full[k % 2], P::COLS * p, h, q0, b);
          hw::tma_load_4d(sQ + L::Q_BYTES + p * L::Q_PANEL, &map_do, &q_full[k % 2],
                          P::COLS * p, h, q0, b);
        }
      } else {
        hw::mbar_arrive(&q_full[k % 2]);
      }
      for (int j = 0; j < n_tiles; ++j) {
        hw::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * L::STAGE_BYTES;
        hw::mbar_expect_tx(&full[stage], L::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < P::N; ++p) {
          hw::tma_load_4d(st + p * L::KV_PANEL, &map_k, &full[stage], P::COLS * p, kvh, j * KS,
                          b);
          hw::tma_load_4d(st + L::KV_BYTES + p * L::KV_PANEL, &map_v, &full[stage],
                          P::COLS * p, kvh, j * KS, b);
        }
        advance(stage, phase, ST);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64) of each unit
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const bool leader = tid == 0;
  const Turns<NC> turns{{wg, PP_BAR}};

  float dq[D / 2];
  float s[KS / 2], dp[KS / 2];
  uint32_t da[KS / 16][4];
  uint8_t* sQ = sQs;   // this unit's Q buffer, dO after it
  auto tile_of = [&](int stage) { return ring + stage * L::STAGE_BYTES; };
  // S = Q K^T, dP = dO V^T (every operand K-major)
  auto issue_sdp = [&](int stage) {
    const uint64_t q_desc = hw::desc_opaque(P::k_major(sQ + wg * 64 * P::ROW));
    const uint64_t do_desc = hw::desc_advance(q_desc, L::Q_BYTES);
    const uint64_t k_desc = hw::desc_opaque(P::k_major(tile_of(stage)));
    const uint64_t v_desc = hw::desc_advance(k_desc, L::KV_BYTES);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = P::koff(kk, L::Q_PANEL), koff = P::koff(kk, L::KV_PANEL);
      hw::wgmma_ss<KS, 0, 0>(s, hw::desc_advance(q_desc, off), hw::desc_advance(k_desc, koff),
                             kk > 0);
      hw::wgmma_ss<KS, 0, 0>(dp, hw::desc_advance(do_desc, off), hw::desc_advance(v_desc, koff),
                             kk > 0);
    }
    hw::wgmma_commit();
  };
  // dQ += dS K (K MN-major)
  auto issue_dq = [&](int stage) {
    const uint64_t k_desc = hw::desc_opaque(P::mn_major(tile_of(stage), L::KV_PANEL));
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk)
      hw::wgmma_rs<D, 1>(dq, da[kk], hw::desc_advance(k_desc, kk * 16 * P::ROW), 1);
    hw::wgmma_commit();
  };
  // the leader hands the last unit's buffer back once its dQ store has read
  // it, after this unit's first products are issued
  int owed = -1;
  auto release = [&]() {
    if (owed >= 0 && leader) {
      hw::tma_store_wait_read<0>();
      hw::mbar_arrive(&q_empty[owed]);
    }
    owed = -1;
  };

  turns.start();
  int stage = 0, k = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    int q0, h, b;
    const int n_tiles = unit(u, q0, h, b);
    const int r0 = q0 + 64 * wg;
    const int row_lo = r0 + 16 * (tid / 32) + lane / 4;   // q rows row_lo, row_lo + 8
    sQ = sQs + (k % 2) * 2 * L::Q_BYTES;
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
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    hw::fence_operand(dq);   // zeroed while no wgmma is in flight

    // dS = P (dP - delta), P = exp2(S c - lse2) on visible columns, packed
    // as the A operand of dQ one k16 step at a time (S and dP only read)
    auto grads = [&](int k0) {
      const bool mask = MASKED || k0 + KS > kv_end || (causal && k0 + KS - 1 > q_offset + r0);
      auto tile = [&](auto kind, auto segs) {
        const int* kv_ids = fm.kv_seg;   // of batch b: at b sk + column
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 8 * kk + 2 * i + e, r = (idx % 4) / 2;
              const int col = k0 + 8 * (idx / 4) + 2 * t4 + e;
              const int at = min(col, sk - 1);
              bool seen = !mask || col < lim[r];
              if constexpr (decltype(segs)::value)
                seen = seen && kv_ids[(long long)b * sk + at] == qid[r];
              float arg = -lse2[r];
              if constexpr (decltype(kind)::value != ptt::FlashMask::NONE)
                arg += fm.template bias2<decltype(kind)::value>(mrow[r], at);
              const float p = hw::ex2_approx(fmaf(s[idx], scale_log2, arg));
              ds[e] = seen ? p * (dp[idx] - dl[r]) : 0.f;
            }
            da[kk][i] = hw::pack_bf16x2(ds[0], ds[1]);
          }
      };
      with_mask<MASKED>(fm, tile);
    };

    hw::mbar_wait(&q_full[k % 2], (k / 2) & 1);   // Q and dO have landed (or no tile)
    const bool solo = L::SKIP_IDLE_WG && NC == 2 && q0 + 64 >= sq;
    for (int j = 0; j < n_tiles; ++j) {
      hw::mbar_wait(&full[stage], phase);
      if (solo && wg == 1) {   // no q row here: dQ stays 0
        if (j == 0) release();
        if (leader) hw::mbar_arrive(&empty[stage]);
        advance(stage, phase, ST);
        continue;
      }
      turns.begin(!solo);
      issue_sdp(stage);
      turns.end(!solo);
      if (j == 0) release();
      hw::wgmma_wait<0>();
      hw::fence_operand(s);
      hw::fence_operand(dp);
      grads(j * KS);
      turns.begin(!solo);
      issue_dq(stage);
      turns.end(!solo);
      hw::wgmma_wait<0>();
      hw::fence_operand(dq);
      hw::fence_operand(da);
      if (leader) hw::mbar_arrive(&empty[stage]);   // dQ of this tile has landed
      advance(stage, phase, ST);
    }
    release();

    // this warpgroup's rows of Q are its own once its last S has landed:
    // stage dQ there and store it by TMA, clipped at sq
    stage_rows<D>(sQ, L::Q_PANEL, 64 * wg, dq, scale, tid);
    hw::fence_proxy_async();
    hw::named_barrier(EPI_BAR + wg, 128);
    if (leader) {
#pragma unroll
      for (int p = 0; p < P::N; ++p)
        hw::tma_store_4d(&map_dq, sQ + p * L::Q_PANEL + wg * 64 * P::ROW, P::COLS * p, h, r0,
                         b);
      hw::tma_store_commit();
    }
    owed = k % 2;
  }
  release();
  turns.finish();
}

// --------------------------------------------------------------------- host
// A 4-D map (d, h, s, b) of a contiguous [b, s, h, d] bf16 tensor, boxes of
// COLS d x 1 head x `rows` x 1 batch in the ROW-byte swizzle.
template <int D>
cudaError_t bshd_map(CUtensorMap* map, const void* p, int b, int s, int h, int rows) {
  using P = Panels<D>;
  const uint64_t dims[4] = {uint64_t(D), uint64_t(h), uint64_t(s), uint64_t(b)};
  const uint64_t str[3] = {uint64_t(D) * 2, uint64_t(h) * D * 2, uint64_t(s) * h * D * 2};
  const uint32_t box[4] = {uint32_t(P::COLS), 1, uint32_t(rows), 1};
  return hw::encode_tma(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 4, dims, str, box,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        P::ROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                        : P::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : CU_TENSOR_MAP_SWIZZLE_32B);
}

// Opts `kern` in to `bytes` of shared memory and sets `grid` to the CTAs
// that walk `units`: as many as are resident on the card (each SM's count
// asked once a kernel instantiation), one a unit without PERSISTENT.
template <class K>
cudaError_t plan(K kern, int threads, int bytes, int units, std::atomic<uint64_t>& done,
                 std::atomic<int>& resident, int& grid) {
  cudaError_t err = ptt::allow_smem(kern, bytes, done);
  if (err != cudaSuccess) return err;
  if (!PERSISTENT) {
    grid = units;
    return cudaSuccess;
  }
  int n = resident.load(std::memory_order_relaxed);
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    n = sms * per_sm;
    resident.store(n, std::memory_order_relaxed);
  }
  grid = units < n ? units : n;
  return cudaSuccess;
}

template <int D, bool MASKED>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                       int b, int sq, int sk, int hq, int hk, int kv_len, int q_offset,
                       int causal, float scale, const ptt::FlashMask& fm, cudaStream_t stream) {
  using L = Fwd<D>;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = bshd_map<D>(&mq, q, b, sq, hq, L::BM);
  if (err == cudaSuccess) err = bshd_map<D>(&mk, k, b, sk, hk, L::BN);
  if (err == cudaSuccess) err = bshd_map<D>(&mv, v, b, sk, hk, L::BN);
  if (err == cudaSuccess) err = bshd_map<D>(&mo, out, b, sq, hq, 64);
  if (err != cudaSuccess) return err;
  static std::atomic<uint64_t> done{0};
  static std::atomic<int> resident{0};
  auto kern = flash_mma_fwd_kernel<D, MASKED>;
  const int units = (sq + L::BM - 1) / L::BM * hq * b;
  int grid = 0;
  err = plan(kern, L::THREADS, L::BYTES, units, done, resident, grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(mq, mk, mv, mo, lse, b, sq, sk, hq, hk, kv_len,
                                               q_offset, causal, scale * LOG2E, fm);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int b, int sq, int sk, int hq, int hk, int kv_len, int q_offset,
                       int causal, float scale, const ptt::FlashMask& fm, cudaStream_t stream) {
  using LK = Dkdv<D>;
  using LQ = Dq<D>;
  // dK/dV: Q and dO in tiles of QS rows, K and V whole units, stores of 64
  CUtensorMap kq, kk, kv, kdo, kdk, kdv;
  cudaError_t err = bshd_map<D>(&kq, q, b, sq, hq, LK::QS);
  if (err == cudaSuccess) err = bshd_map<D>(&kdo, dout, b, sq, hq, LK::QS);
  if (err == cudaSuccess) err = bshd_map<D>(&kk, k, b, sk, hk, LK::BKV);
  if (err == cudaSuccess) err = bshd_map<D>(&kv, v, b, sk, hk, LK::BKV);
  if (err == cudaSuccess) err = bshd_map<D>(&kdk, dk, b, sk, hk, 64);
  if (err == cudaSuccess) err = bshd_map<D>(&kdv, dv, b, sk, hk, 64);
  // dQ: Q and dO whole units, K and V in tiles of KS rows, stores of 64
  CUtensorMap qq, qk, qv, qdo, qdq;
  if (err == cudaSuccess) err = bshd_map<D>(&qq, q, b, sq, hq, LQ::BQ);
  if (err == cudaSuccess) err = bshd_map<D>(&qdo, dout, b, sq, hq, LQ::BQ);
  if (err == cudaSuccess) err = bshd_map<D>(&qk, k, b, sk, hk, LQ::KS);
  if (err == cudaSuccess) err = bshd_map<D>(&qv, v, b, sk, hk, LQ::KS);
  if (err == cudaSuccess) err = bshd_map<D>(&qdq, dq, b, sq, hq, 64);
  if (err != cudaSuccess) return err;

  const long rows = long(b) * sq * hq;
  constexpr int TPR = D / 8 <= 2 ? 2 : D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : 16;
  flash_mma_delta_kernel<D><<<unsigned((rows * TPR + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, b, sq, hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static std::atomic<uint64_t> done_kv{0}, done_q{0};
  static std::atomic<int> resident_kv{0}, resident_q{0};
  auto kern_kv = flash_mma_dkdv_kernel<D, MASKED>;
  int grid = 0;
  err = plan(kern_kv, LK::THREADS, LK::BYTES, (sk + LK::BKV - 1) / LK::BKV * hk * b, done_kv,
             resident_kv, grid);
  if (err != cudaSuccess) return err;
  kern_kv<<<grid, LK::THREADS, LK::BYTES, stream>>>(kq, kk, kv, kdo, kdk, kdv, lse, delta, b, sq,
                                                    sk, hq, hk, kv_len, q_offset, causal, scale,
                                                    scale * LOG2E, fm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kern_q = flash_mma_dq_kernel<D, MASKED>;
  err = plan(kern_q, LQ::THREADS, LQ::BYTES, (sq + LQ::BQ - 1) / LQ::BQ * hq * b, done_q,
             resident_q, grid);
  if (err != cudaSuccess) return err;
  kern_q<<<grid, LQ::THREADS, LQ::BYTES, stream>>>(qq, qk, qv, qdo, qdq, lse, delta, b, sq, sk,
                                                   hq, hk, kv_len, q_offset, causal, scale,
                                                   scale * LOG2E, fm);
  return cudaGetLastError();
}

bool valid(int b, int sq, int sk, int hq, int hk, int mask_kind, const void* mask,
           const void* q_seg, const void* kv_seg) {
  return b > 0 && sq > 0 && sk > 0 && hk > 0 && hq % hk == 0 && mask_kind >= 0 &&
         mask_kind <= 2 && (mask_kind != 0) == (mask != nullptr) &&
         (q_seg == nullptr) == (kv_seg == nullptr);
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Whether head dim d is compiled here.
int ptt_flash_mma_takes(int d) {
#define PTT_TAKES(D) \
  if (d == D) return 1;
  PTT_MMA_HEAD_DIMS(PTT_TAKES)
#undef PTT_TAKES
  return 0;
}

// Dynamic shared memory of the forward (which 0), dK/dV (1) and dQ (2)
// kernels at head dim d (0 for a d not compiled here).
int ptt_flash_mma_smem_bytes(int d, int which) {
#define PTT_SMEM(D)                                              \
  if (d == D)                                                    \
    return which == 0 ? Fwd<D>::BYTES                            \
                      : which == 1 ? Dkdv<D>::BYTES : Dq<D>::BYTES;
  PTT_MMA_HEAD_DIMS(PTT_SMEM)
#undef PTT_SMEM
  return 0;
}

// The forward: arguments as ptt_flash_fwd of flash_attention.cu (q [b, sq,
// hq, d], k/v [b, sk, hk, d], out [b, sq, hq, d] contiguous 16-byte aligned
// bf16; lse [b, hq, sq] f32 or null; the mask, its kind and strides, the
// segment ids). Returns a CUDA error code (0 on success).
int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                  const void* mask, const void* q_seg, const void* kv_seg, int b, int sq, int sk,
                  int hq, int hk, int d, int kv_len, int q_offset, int causal, int mask_kind,
                  long long msb, long long msh, long long msr, float scale, void* stream) {
  if (!valid(b, sq, sk, hq, hk, mask_kind, mask, q_seg, kv_seg)) return int(cudaErrorInvalidValue);
  const ptt::FlashMask fm{mask, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                          mask_kind, msb, msh, msr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define PTT_FWD(D)                                                                            \
  if (d == D)                                                                                 \
    return int(fm.any() ? launch_fwd<D, true>(q, k, v, out, l, b, sq, sk, hq, hk, kv_len,     \
                                              q_offset, causal, scale, fm, s)                 \
                        : launch_fwd<D, false>(q, k, v, out, l, b, sq, sk, hq, hk, kv_len,    \
                                               q_offset, causal, scale, fm, s));
  PTT_MMA_HEAD_DIMS(PTT_FWD)
#undef PTT_FWD
  return int(cudaErrorInvalidValue);
}

// The backward: arguments as ptt_flash_bwd of flash_attention_bwd.cu (delta
// [b, hq, sq] f32 scratch). Runs three kernels (delta, dK/dV, dQ) on
// `stream`; returns a CUDA error code (0 on success).
int ptt_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                  const void* mask, const void* q_seg, const void* kv_seg, int b, int sq, int sk,
                  int hq, int hk, int d, int kv_len, int q_offset, int causal, int mask_kind,
                  long long msb, long long msh, long long msr, float scale, void* stream) {
  if (!valid(b, sq, sk, hq, hk, mask_kind, mask, q_seg, kv_seg)) return int(cudaErrorInvalidValue);
  const ptt::FlashMask fm{mask, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
                          mask_kind, msb, msh, msr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define PTT_BWD(D)                                                                            \
  if (d == D)                                                                                 \
    return int(fm.any() ? launch_bwd<D, true>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq,   \
                                              sk, hq, hk, kv_len, q_offset, causal, scale,    \
                                              fm, s)                                          \
                        : launch_bwd<D, false>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq,  \
                                               sk, hq, hk, kv_len, q_offset, causal, scale,   \
                                               fm, s));
  PTT_MMA_HEAD_DIMS(PTT_BWD)
#undef PTT_BWD
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
