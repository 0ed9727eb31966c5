// Flash attention forward and backward for Hopper (sm_90a) at the head dims
// the wgmma kernels (flash_attention.cu, flash_attention_bwd.cu: d = 64 and
// 128) do not take: every other multiple of 16 below 128 (16, 32, 48, 80,
// 96, 112). bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py `_fwd`
// (pl.pallas_call at :266) and `_bwd` (at :453) at those head dims, which
// the Pallas kernels take as one full-extent block of d (:270-279,
// :460-466): the UNet's attention (d = 32 at sdxl-small's level 1, 16 in
// unet-tiny) and ViT-H14's (d = 80), self-attention and cross-attention
// (sq != sk) alike. The surface is the wgmma kernels': BSHD layout (q, out,
// dout, dq [b, sq, hq, d]; k, v, dk, dv [b, sk, hk, d], contiguous, 16-byte
// aligned), GQA (query head h reads kv head h / (hq / hk)), causal with a
// bottom-right q_offset (row r sees column c iff c <= q_offset + r), kv_len
// (columns >= kv_len masked), the optional additive f32 or bool mask and
// q / kv segment ids of csrc/flash_mask.cuh (no gradient for the mask), the
// row logsumexp lse [b, hq, sq] in natural-log units (-1e30 ln 2 and zeros
// for a row that sees nothing), and a deterministic backward.
//
// What bounds it on the H100: tensor-core operations at long sequences,
// bytes at short ones (UNet cross-attention: 77 kv rows). This is the
// simple, right kernel: FlashAttention-2 on mma.sync m16n8k16 (the Ampere
// instruction, about half the wgmma rate), fed by cp.async with a double
// buffer. Panels of 16 or 32 columns would need the 32- and 64-byte TMA
// swizzles and wgmma descriptors of their own; rows padded by 16 bytes
// (ldmatrix reads eight rows on distinct banks when d is a multiple of 16)
// take every width here with one layout.
//
// Design: four warps a CTA, 16 rows each.
// - Forward: one CTA per (64-row q tile, query head, batch), the last q
//   tile first (under a causal mask the longest). Q is loaded once into
//   registers as A fragments; K and V tiles of 64 rows stream through two
//   shared-memory stages (rows past sk zero-fill). S = Q K^T (K read by
//   ldmatrix as the col-major B), scaled into base 2, masked by a select,
//   the online softmax in f32 on the accumulator (quad shuffles for the row
//   max and sum; a row that has seen nothing keeps max -inf and uses 0 in
//   its exponent), P packed to bf16 A fragments, O += P V (V by the
//   transposed ldmatrix). Tiles past the last visible column are never
//   loaded.
// - Backward, in three kernels as the wgmma backward:
//   1. delta = rowsum(dO * O) in f32, one thread a row;
//   2. dK/dV: one CTA per (64-row kv tile, kv head, batch), K and V in
//      registers as A fragments, Q and dO tiles of QT rows (with their lse
//      and delta) streaming through two stages over the group's query heads
//      and the q tiles the causal band allows: S^T = K Q^T, P^T = exp2(S^T c
//      - lse2) where seen, dP^T = V dO^T, dS^T = P^T (dP^T - delta), dV +=
//      P^T dO, dK += dS^T Q, all in registers; dK and dV summed over the
//      group inside the CTA, so nothing is atomic;
//   3. dQ: one CTA per (64-row q tile, query head, batch), Q and dO in
//      registers, K and V tiles streaming: S, P, dP, dS as above and dQ +=
//      dS K.
// Masks as in the wgmma kernels: the causal / kv_len rule by column limits,
// and with a mask or segment ids (the MASKED instantiation) each score
// becomes s c + bias where the pair is seen and -inf where not, the mask's
// values read straight from global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ptt::sm90;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;   // four warps, 16 rows each
constexpr int BM = 64;         // q rows of a forward / dQ CTA
constexpr int BN = 64;         // kv rows of a tile, and of a dK/dV CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the head dims compiled here (the wgmma kernels take 64 and 128)
#define PTT_MMA_HEAD_DIMS(X) X(16) X(32) X(48) X(80) X(96) X(112)

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D < 128, "head dim: a multiple of 16 below 128");
  static constexpr int PITCH = D + 8;   // bf16 a row in shared memory: 16 bytes of padding
  static constexpr int CHUNKS = D / 8;  // 16-byte pieces of a row
  // q rows of a dK/dV step: 32 above d = 64 keeps S^T and dP^T small beside
  // the dK and dV accumulators
  static constexpr int QT = D <= 64 ? 64 : 32;
  static constexpr int FWD_BYTES = (BM + 4 * BN) * PITCH * 2;   // Q; 2 x (K, V)
  static constexpr int DQ_BYTES = (2 * BM + 4 * BN) * PITCH * 2;   // Q, dO; 2 x (K, V)
  // K, V; 2 x (Q, dO, then lse2, delta and the q rows' segment ids)
  static constexpr int STAGE_BYTES = 2 * QT * PITCH * 2 + 3 * QT * 4;
  static constexpr int DKDV_BYTES = 2 * BN * PITCH * 2 + 2 * STAGE_BYTES;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f(kind, segs) as FlashMask::dispatch gives them with MASKED; without, no
// mask and no segment ids (bias2 is then 0 and costs nothing)
template <bool MASKED, class F>
__device__ __forceinline__ void with_mask(const ptt::FlashMask& fm, F&& f) {
  if constexpr (MASKED)
    fm.dispatch(f);
  else
    f(std::integral_constant<int, ptt::FlashMask::NONE>{}, std::false_type{});
}

// rows [r0, r0 + ROWS) of head h of a [b, s, heads, D] tensor into a
// shared tile of PITCH-element rows by cp.async; rows past s zero-fill
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* src, int b, int r0, int s,
                                          int heads, int h) {
  using S = Shape<D>;
  for (int i = threadIdx.x; i < ROWS * S::CHUNKS; i += THREADS) {
    const int r = i / S::CHUNKS, c = i % S::CHUNKS;
    const bool ok = r0 + r < s;
    const bf16* at = src + ((long(b) * s + (ok ? r0 + r : 0)) * heads + h) * D + 8 * c;
    ptt::cp_async16(tile + r * S::PITCH + 8 * c, at, ok ? 16 : 0);
  }
}

// the A fragments (16 rows x D) of this warp's rows [16 w, 16 w + 16) of a
// shared tile: a[kk] covers columns [16 kk, 16 kk + 16)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* tile, int warp,
                                       int lane) {
  const int mi = lane / 8;
  const bf16* row = tile + (16 * warp + (mi % 2) * 8 + lane % 8) * Shape<D>::PITCH + (mi / 2) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ptt::ldmatrix_x4(a[kk], row + 16 * kk);
}

// acc (16 x N) = A (16 x D, fragments) times B^T, B the N rows of a shared
// tile (N x D, row-major: the col-major B of mma.sync)
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int mi = lane / 8;
  const bf16* row = tile + ((mi / 2) * 8 + lane % 8) * Shape<D>::PITCH + (mi % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t r[4];
      ptt::ldmatrix_x4(r, row + 16 * nb * Shape<D>::PITCH + 16 * kk);
      ptt::mma16816(acc[2 * nb], a[kk], r[0], r[1]);
      ptt::mma16816(acc[2 * nb + 1], a[kk], r[2], r[3]);
    }
}

// acc (16 x D) += P (16 x K, an f32 accumulator packed to bf16) times B, B
// the K rows of a shared tile (K x D, row-major: read transposed)
template <int D, int K>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[K / 8][4],
                                       const bf16* tile, int lane) {
  const int mi = lane / 8;
  const bf16* row = tile + ((mi % 2) * 8 + lane % 8) * Shape<D>::PITCH + (mi / 2) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t r[4];
      ptt::ldmatrix_x4_trans(r, row + 16 * kk * Shape<D>::PITCH + 16 * nd);
      ptt::mma16816(acc[2 * nd], a, r[0], r[1]);
      ptt::mma16816(acc[2 * nd + 1], a, r[2], r[3]);
    }
  }
}

// rows of an accumulator (16 x D of this warp, row g and g + 8 of each
// thread) as bf16 into a [b, s, heads, D] tensor, times `mul`; rows past s
// are dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], float mul0,
                                           float mul1, int b, int row0, int s, int heads, int h,
                                           int lane) {
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= s) continue;
    const float mul = r ? mul1 : mul0;
    bf16* at = dst + ((long(b) * s + row) * heads + h) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(at + 8 * j) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

// ------------------------------------------------------------------ forward
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_mma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                     int sq, int sk, int hq, int hk, int kv_len, int q_offset, int causal,
                     float scale_log2, const ptt::FlashMask fm) {
  using S = Shape<D>;
  constexpr int P = S::PITCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + BM * P;   // stage s: K at sKV + 2 s BN P, V after it

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // the last q tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int kv_end = min(kv_len, sk);
  const int n_end = causal ? min(kv_end, q_offset + min(q0 + BM, sq)) : kv_end;
  const int n_tiles = n_end > 0 ? (n_end + BN - 1) / BN : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  load_rows<D, BM>(sQ, q, b, q0, sq, hq, h);
  if (n_tiles > 0) {
    load_rows<D, BN>(sKV, k, b, 0, sk, hk, kvh);
    load_rows<D, BN>(sKV + BN * P, v, b, 0, sk, hk, kvh);
  }
  ptt::cp_async_commit();

  // this thread's rows, g and g + 8 of the warp's 16
  int lim[2], qid[2];
  long long mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    const int at = min(row, sq - 1);   // rows past sq are computed, never stored
    lim[r] = causal ? min(kv_end, q_offset + row + 1) : kv_end;
    qid[r] = MASKED ? fm.q_id(b, sq, at) : 0;
    mrow[r] = fm.row_at(b, h, at);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qa[D / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    bf16* sK = sKV + (j % 2) * 2 * BN * P;
    if (j + 1 < n_tiles) {
      bf16* nK = sKV + ((j + 1) % 2) * 2 * BN * P;
      load_rows<D, BN>(nK, k, b, (j + 1) * BN, sk, hk, kvh);
      load_rows<D, BN>(nK + BN * P, v, b, (j + 1) * BN, sk, hk, kvh);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) load_a<D>(qa, sQ, warp, lane);

    float s[BN / 8][4];
    mma_abt<D, BN>(s, qa, sK, lane);
    const int k0 = j * BN;
    // scores in base 2 (plus the mask's bias), -inf where the pair is not seen
    with_mask<MASKED>(fm, [&](auto kind, auto segs) {
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, col = k0 + 8 * nb + 2 * t4 + (e & 1), at = min(col, sk - 1);
          bool seen = col < lim[r];
          if constexpr (decltype(segs)::value)
            seen = seen && fm.kv_seg[(long long)b * sk + at] == qid[r];
          const float x =
              fmaf(s[nb][e], scale_log2, fm.template bias2<decltype(kind)::value>(mrow[r], at));
          s[nb][e] = seen ? x : -INFINITY;
        }
    });
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      alpha[r] = hw::ex2_approx(m[r] - base);   // m = -inf: 0 (O and l are 0 anyway)
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = hw::ex2_approx(s[nb][e] - base);   // -inf: 0
          s[nb][e] = p;
          sum += p;
        }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e / 2];
    mma_pb<D, BN>(o, s, sK + BN * P, lane);
    __syncthreads();   // the stage is refilled next
  }
  ptt::cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[r] = t > 0.f ? 1.f / t : 0.f;
    const int row = q0 + 16 * warp + g + 8 * r;
    if (lse != nullptr && t4 == 0 && row < sq)
      lse[(long(b) * hq + h) * sq + row] = t > 0.f ? (m[r] + log2f(t)) * LN2 : -1e30f * LN2;
  }
  store_rows<D>(out, o, inv[0], inv[1], b, q0 + 16 * warp, sq, hq, h, lane);
}

// ------------------------------------------------------------------ backward
// delta[b, h, r] = sum_d dO[b, r, h, d] * O[b, r, h, d] in f32, one thread a
// row
template <int D>
__global__ void __launch_bounds__(256)
flash_mma_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int b, int sq, int hq) {
  const long rows = long(b) * sq * hq;
  const long row = long(blockIdx.x) * 256 + threadIdx.x;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * D + 8 * c);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * D + 8 * c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), gf = __bfloat1622float2(g2[i]);
      acc += of.x * gf.x + of.y * gf.y;
    }
  }
  // row = (bi * sq + r) * hq + h  ->  delta[(bi * hq + h) * sq + r]
  const long h = row % hq, r = (row / hq) % sq, bi = row / (long(hq) * sq);
  delta[(bi * hq + h) * sq + r] = acc;
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_mma_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int hq,
                      int hk, int kv_len, int q_offset, int causal, float scale,
                      float scale_log2, const ptt::FlashMask fm) {
  using S = Shape<D>;
  constexpr int P = S::PITCH, QT = S::QT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * P;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + BN * P);

  const int n0 = blockIdx.x * BN;   // the kv tiles that see the most q rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = hq / hk;
  const int kv_end = min(kv_len, sk);
  // q rows that can see a column of this tile start at i_min
  const int i_min = causal ? max(0, n0 - q_offset) : 0;
  const int t0 = i_min / QT;
  const int nt = (n0 < kv_end && i_min < sq) ? (sq + QT - 1) / QT - t0 : 0;
  const int iters = nt * group;   // (query head of the group, q tile) pairs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  // stage s: Q [QT], dO [QT], lse2 [QT], delta [QT], q ids [QT]
  auto stage_q = [&](int s) { return reinterpret_cast<bf16*>(ring + s * S::STAGE_BYTES); };
  auto stage_f = [&](int s) {
    return reinterpret_cast<float*>(ring + s * S::STAGE_BYTES + 2 * QT * P * 2);
  };
  auto fill = [&](int it, int s) {
    const int h = kvh * group + it / nt;
    const int q0 = (t0 + it % nt) * QT;
    bf16* st = stage_q(s);
    load_rows<D, QT>(st, q, b, q0, sq, hq, h);
    load_rows<D, QT>(st + QT * P, dout, b, q0, sq, hq, h);
    float* f = stage_f(s);
    const long row0 = (long(b) * hq + h) * sq;
    for (int r = threadIdx.x; r < QT; r += THREADS) {
      const bool ok = q0 + r < sq;
      f[r] = ok ? lse[row0 + q0 + r] * LOG2E : 0.f;
      f[QT + r] = ok ? delta[row0 + q0 + r] : 0.f;
      reinterpret_cast<int*>(f)[2 * QT + r] = MASKED ? fm.q_id(b, sq, min(q0 + r, sq - 1)) : 0;
    }
  };

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (iters > 0) {
    load_rows<D, BN>(sK, k, b, n0, sk, hk, kvh);
    load_rows<D, BN>(sV, v, b, n0, sk, hk, kvh);
    fill(0, 0);
    ptt::cp_async_commit();
  }
  // this thread's kv rows, g and g + 8 of the warp's 16
  int kv_at[2], kvid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kv_at[r] = n0 + 16 * warp + g + 8 * r;
    kvid[r] = MASKED ? fm.kv_id(b, sk, min(kv_at[r], sk - 1)) : 0;
  }
  uint32_t ka[D / 16][4], va[D / 16][4];

  for (int it = 0; it < iters; ++it) {
    const int s_now = it % 2;
    if (it + 1 < iters) {
      fill(it + 1, (it + 1) % 2);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a<D>(ka, sK, warp, lane);
      load_a<D>(va, sV, warp, lane);
    }
    const int h = kvh * group + it / nt;
    const int q0 = (t0 + it % nt) * QT;
    const bf16* sQ = stage_q(s_now);
    const bf16* sDO = sQ + QT * P;
    const float* f = stage_f(s_now);
    const int* qids = reinterpret_cast<const int*>(f) + 2 * QT;

    // P^T = exp2(S^T c - lse2) where seen, 0 where not
    float p[QT / 8][4];
    mma_abt<D, QT>(p, ka, sQ, lane);
    with_mask<MASKED>(fm, [&](auto kind, auto segs) {
#pragma unroll
      for (int nb = 0; nb < QT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, ci = 8 * nb + 2 * t4 + (e & 1), row = q0 + ci, col = kv_at[r];
          bool seen = col < kv_end && row < sq && (!causal || col <= q_offset + row);
          if constexpr (decltype(segs)::value) seen = seen && qids[ci] == kvid[r];
          const float x = fmaf(p[nb][e], scale_log2,
                               fm.template bias2<decltype(kind)::value>(
                                   fm.row_at(b, h, min(row, sq - 1)), min(col, sk - 1)));
          const float pe = hw::ex2_approx(x - f[ci]);
          p[nb][e] = seen ? pe : 0.f;
        }
    });
    // dV += P^T dO
    mma_pb<D, QT>(dva, p, sDO, lane);
    // dS^T = P^T (dP^T - delta), dP^T = V dO^T
    float ds[QT / 8][4];
    mma_abt<D, QT>(ds, va, sDO, lane);
#pragma unroll
    for (int nb = 0; nb < QT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 8 * nb + 2 * t4 + (e & 1);
        ds[nb][e] = p[nb][e] * (ds[nb][e] - f[QT + ci]);
      }
    // dK += dS^T Q
    mma_pb<D, QT>(dka, ds, sQ, lane);
    __syncthreads();   // the stage is refilled next
  }
  store_rows<D>(dk, dka, scale, scale, b, n0 + 16 * warp, sk, hk, kvh, lane);
  store_rows<D>(dv, dva, 1.f, 1.f, b, n0 + 16 * warp, sk, hk, kvh, lane);
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_mma_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int sq, int sk, int hq, int hk, int kv_len,
                    int q_offset, int causal, float scale, float scale_log2,
                    const ptt::FlashMask fm) {
  using S = Shape<D>;
  constexpr int P = S::PITCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + BM * P;
  bf16* sKV = sDO + BM * P;   // stage s: K at sKV + 2 s BN P, V after it

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int kv_end = min(kv_len, sk);
  const int n_end = causal ? min(kv_end, q_offset + min(q0 + BM, sq)) : kv_end;
  const int n_tiles = n_end > 0 ? (n_end + BN - 1) / BN : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  load_rows<D, BM>(sQ, q, b, q0, sq, hq, h);
  load_rows<D, BM>(sDO, dout, b, q0, sq, hq, h);
  if (n_tiles > 0) {
    load_rows<D, BN>(sKV, k, b, 0, sk, hk, kvh);
    load_rows<D, BN>(sKV + BN * P, v, b, 0, sk, hk, kvh);
  }
  ptt::cp_async_commit();

  int lim[2], qid[2];
  long long mrow[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    const int at = min(row, sq - 1);
    lim[r] = row < sq ? (causal ? min(kv_end, q_offset + row + 1) : kv_end) : 0;
    qid[r] = MASKED ? fm.q_id(b, sq, at) : 0;
    mrow[r] = fm.row_at(b, h, at);
    lse2[r] = lse[(long(b) * hq + h) * sq + at] * LOG2E;
    dlt[r] = delta[(long(b) * hq + h) * sq + at];
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  uint32_t qa[D / 16][4], da[D / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    bf16* sK = sKV + (j % 2) * 2 * BN * P;
    if (j + 1 < n_tiles) {
      bf16* nK = sKV + ((j + 1) % 2) * 2 * BN * P;
      load_rows<D, BN>(nK, k, b, (j + 1) * BN, sk, hk, kvh);
      load_rows<D, BN>(nK + BN * P, v, b, (j + 1) * BN, sk, hk, kvh);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      load_a<D>(qa, sQ, warp, lane);
      load_a<D>(da, sDO, warp, lane);
    }
    const int k0 = j * BN;
    float p[BN / 8][4];
    mma_abt<D, BN>(p, qa, sK, lane);
    with_mask<MASKED>(fm, [&](auto kind, auto segs) {
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, col = k0 + 8 * nb + 2 * t4 + (e & 1), at = min(col, sk - 1);
          bool seen = col < lim[r];
          if constexpr (decltype(segs)::value)
            seen = seen && fm.kv_seg[(long long)b * sk + at] == qid[r];
          const float x =
              fmaf(p[nb][e], scale_log2, fm.template bias2<decltype(kind)::value>(mrow[r], at));
          const float pe = hw::ex2_approx(x - lse2[r]);
          p[nb][e] = seen ? pe : 0.f;
        }
    });
    float ds[BN / 8][4];
    mma_abt<D, BN>(ds, da, sK + BN * P, lane);   // dP = dO V^T
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nb][e] = p[nb][e] * (ds[nb][e] - dlt[e / 2]);
    mma_pb<D, BN>(dqa, ds, sK, lane);   // dQ += dS K
    __syncthreads();
  }
  ptt::cp_async_wait<0>();
  store_rows<D>(dq, dqa, scale, scale, b, q0 + 16 * warp, sq, hq, h, lane);
}

template <int D, bool MASKED>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                       int b, int sq, int sk, int hq, int hk, int kv_len, int q_offset,
                       int causal, float scale, const ptt::FlashMask& fm, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  auto kern = flash_mma_fwd_kernel<D, MASKED>;
  cudaError_t err = ptt::allow_smem(kern, Shape<D>::FWD_BYTES, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BM - 1) / BM, hq, b);
  kern<<<grid, THREADS, Shape<D>::FWD_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, sq, sk, hq, hk, kv_len, q_offset, causal, scale * LOG2E, fm);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int b, int sq, int sk, int hq, int hk, int kv_len, int q_offset,
                       int causal, float scale, const ptt::FlashMask& fm, cudaStream_t stream) {
  using S = Shape<D>;
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *do_ = static_cast<const bf16*>(dout);
  const long rows = long(b) * sq * hq;
  auto kern_delta = flash_mma_delta_kernel<D>;
  kern_delta<<<unsigned((rows + 255) / 256), 256, 0, stream>>>(static_cast<const bf16*>(out),
                                                                do_, delta, b, sq, hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static std::atomic<uint64_t> done_kv{0}, done_q{0};
  auto kern_kv = flash_mma_dkdv_kernel<D, MASKED>;
  err = ptt::allow_smem(kern_kv, S::DKDV_BYTES, done_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((sk + BN - 1) / BN, hk, b);
  kern_kv<<<grid_kv, THREADS, S::DKDV_BYTES, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, hq,
      hk, kv_len, q_offset, causal, scale, scale * LOG2E, fm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kern_q = flash_mma_dq_kernel<D, MASKED>;
  err = ptt::allow_smem(kern_q, S::DQ_BYTES, done_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((sq + BM - 1) / BM, hq, b);
  kern_q<<<grid_q, THREADS, S::DQ_BYTES, stream>>>(q_, k_, v_, do_, lse, delta,
                                                   static_cast<bf16*>(dq), sq, sk, hq, hk,
                                                   kv_len, q_offset, causal, scale,
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
#define PTT_SMEM(D)                                                   \
  if (d == D)                                                         \
    return which == 0 ? Shape<D>::FWD_BYTES                           \
                      : which == 1 ? Shape<D>::DKDV_BYTES : Shape<D>::DQ_BYTES;
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
