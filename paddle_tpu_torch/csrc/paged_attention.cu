// Paged decode attention for Hopper (sm_90a): bf16 q, bf16 or int8 pages,
// f32 stats.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `paged_attention_pallas` with return_stats=True (pl.pallas_call at :580,
// bodies `_kernel_stats` :129 / `_kernel_body` :151), and without stats
// (:561, `_kernel` :123); the streaming seq-grid variant (:423,
// `_kernel_seq` :216) computes the same function. Its int8 variants
// (`_kernel_quant`, `_kernel_quant_stats` :136-148, `_kernel_seq_quant`
// :357) are the same kernel instantiated on int8 pages (`ptt_paged_decode_int8`).
//
// What it computes, per decode row b and query head h (one query token):
//   s_j = scale * q[b, h] . k[h / group, page_table[b, j / page], j % page]
//   for j < seq_lens[b];  out = softmax(s) v, and with stats
//   m = max_j s_j (NEG_INF = -1e30 when the row is empty, never -inf) and
//   l = sum_j exp(s_j - m). A row with seq_len 0 gives m = -1e30, l = 0,
//   out = 0 — no NaN, so the caller's online-softmax merge of the step's
//   own k/v stays exact.
// Layouts: q [B, H, D] contiguous; k/v pages [KVH, P, page, D] contiguous
// (one layer of the pool); page_table [B, pps] int32; seq_lens [B] int32;
// out [B, H, D] bf16; m, l [B, H] f32.
// int8 pages: k/v pages [KVH, P, page, D] int8 and their block-major scales
// k/v_scales [P, KVH, page] f32 (one layer of the scales pool). The per-token
// k scale multiplies the score and the v scale the softmax weight, so the
// result is "dequantize in f32, then dot" up to f32 rounding; the device
// reads int8 rows plus 8 bytes of scales per (token, kv head).
//
// What bounds it on the H100: device-memory bytes of the K/V it reads (one
// query token per row does 2 operations per byte). The design keeps the
// loads of every SM in flight, whatever the rows' lengths, in one launch:
// - Balanced work without a host sync. The work is the flat list of units,
//   32 tokens (two 16-token halves, each within one page) of one kv head,
//   ordered by (row, kv head, unit); a (row, kv head) is a segment. Each CTA
//   of a fixed grid (CTAS_PER_SM an SM) reads seq_lens, prefix-sums the
//   units of every row itself and takes an equal contiguous share of the
//   list. It looks up the page table entries of its whole share at once
//   (never an entry at or past ceil(len / page)), and rows with no unit are
//   written empty by the CTAs in turn.
// - Units staged by cp.async, STAGES of them a CTA, rows past the length
//   zero-filled, each 16-byte chunk placed by a swizzle that keeps the
//   fragment loads below on distinct banks; a segment's queries come with
//   its first unit, so no load waits on device memory inside the loop.
// - The dots on the tensor cores, mma.sync m16n8k16 (flash_common.cuh),
//   with the group's query heads as the 16-row side (padded) and a unit's
//   tokens as four 8-wide tiles: each of the 4 warps takes a quarter of the
//   head dims for q kᵀ (the warps' partial scores summed in shared memory
//   in a fixed order, so every warp holds the same scores and softmax
//   state) and for P V. The softmax weights are the A operand of P V as
//   they come out of q kᵀ (split into bf16 hi + lo: ~2^-17 of each weight);
//   the k dims of q kᵀ and the head dims of P V are permuted inside each
//   16- or 32-wide group so that each lane loads 4 adjacent values of one
//   row. int8 values become bf16 exactly in registers (a byte under the f32
//   exponent of 2^23, a subtract, the upper half).
// - Software-pipelined: an iteration runs unit i's softmax and P V beside
//   unit i + 1's partial scores, one barrier a unit; each lane's fragment
//   offsets in a stage are computed once. The loop's instructions set its
//   pace where the bytes do not (int8 pages, and bf16 pages in L2).
// - The merge in the same launch. A CTA writes a segment it holds whole
//   straight to out; a segment split across CTAs leaves one partial (m, l,
//   unnormalised acc) per CTA in a slot of its own, and the last CTA to
//   count itself in (a counter per segment, reset to 0 by that CTA, so
//   every launch finds them at 0) merges the partials in CTA order in one
//   pass. The result is the same bit for bit on every run on one card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using ptt::bf16;

constexpr int NW = 4;               // warps a CTA, each a quarter of the head dims
constexpr int THREADS = NW * 32;
constexpr int TOK = 16;             // tokens a half unit (the pages hold a multiple of 16)
constexpr int UT = 2 * TOK;         // tokens a unit
constexpr int STAGES = 4;           // units staged a CTA: the two computed and the next two
constexpr int CTAS_PER_SM = 2;      // the grid
constexpr int LIST = 2 * THREADS;   // units whose addresses a CTA looks up at once
constexpr int MAX_B = 8192;         // rows (their unit counts sit in shared memory)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(STAGES >= 3, "the unit, the next one and one in flight");

template <typename KV, int D>
constexpr int CPR = D * int(sizeof(KV)) / 16;    // 16-byte chunks a token row

template <typename KV, int D>
struct Smem {
  alignas(16) KV k[STAGES][UT * D];
  alignas(16) KV v[STAGES][UT * D];
  alignas(16) float ks[STAGES][UT];    // int8 pages: the unit's scales
  alignas(16) float vs[STAGES][UT];
  alignas(16) bf16 qs[STAGES][8 * D];  // a segment's queries, with its first unit
  alignas(16) float4 red[2][NW][2][32];   // the warps' partial scores
  long long src[LIST][2];              // element offset of each half's K / V rows
  int sc[LIST][2];                     // and of its scales
  int row[LIST], kvh[LIST], valid[LIST];
  bool head[LIST];                     // a unit that may start a segment's part
  bool tail[LIST];                     // the last unit of a segment's part
  int wsum[NW];
  int last;
};

// Where chunk c of token row r sits: K rows are read 8 at a time (bf16: 4
// rows by 2 chunks, int8: 8 rows by 1), V rows 4 at a time (rows 2t, t < 4,
// 2 chunks each), each group on distinct banks
template <typename KV, int D>
__device__ __forceinline__ int kswz(int r, int c) {
  if (sizeof(KV) == 2) return c ^ (2 * (r & 3));
  return CPR<KV, D> >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}
template <typename KV, int D>
__device__ __forceinline__ int vswz(int r, int c) {
  return c ^ ((2 * ((r >> 1) & 3)) & (CPR<KV, D> - 1));
}

// where 4 values of token row r from dim d (a multiple of 4) sit in a
// staged K (or V) tile
template <typename KV, int D, bool V>
__device__ __forceinline__ int at4(int r, int d) {
  constexpr int E = 16 / int(sizeof(KV));
  return r * D + (V ? vswz<KV, D>(r, d / E) : kswz<KV, D>(r, d / E)) * E + d % E;
}

// the 4 values at p: bf16 as they are, int8 biased by 128
template <typename KV>
__device__ __forceinline__ uint2 ld4(const KV* p) {
  if (sizeof(KV) == 2) return *reinterpret_cast<const uint2*>(p);
  return make_uint2(*reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u, 0u);
}

// bytes j, j + 1 of w (biased by 128) as a bf16 pair: 0x4B0000uu is the
// f32 2^23 + uu, the difference an integer of at most 8 significant bits,
// so its upper half is its exact bf16
__device__ __forceinline__ float i8f(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + j)) - (8388608.f + 128.f);
}
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// the B fragment (k slots 2t, 2t + 1 | 2t + 8, 2t + 9) of q kᵀ: 4 adjacent
// dims of one token
template <typename KV>
__device__ __forceinline__ void k_frag(uint2 w, uint32_t& b0, uint32_t& b1) {
  if (sizeof(KV) == 2) {
    b0 = w.x;
    b1 = w.y;
  } else {
    b0 = bf2(i8f(w.x, 0), i8f(w.x, 1));
    b1 = bf2(i8f(w.x, 2), i8f(w.x, 3));
  }
}

// dim i of 4 adjacent dims of tokens r0 and r1 as the bf16 pair (r0, r1)
template <typename KV>
__device__ __forceinline__ uint32_t v_pair(uint2 r0, uint2 r1, int i) {
  if (sizeof(KV) == 2) {
    const uint32_t a = i < 2 ? r0.x : r0.y, b = i < 2 ? r1.x : r1.y;
    return __byte_perm(a, b, i % 2 ? 0x7632 : 0x5410);
  }
  return bf2(i8f(r0.x, i), i8f(r1.x, i));
}

// e^x on the special-function unit (flushing to 0 below 2^-126)
__device__ __forceinline__ float fast_exp(float x) {
  return ptt::sm90::ex2_approx(x * 1.4426950408889634f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The parts of one segment, left by CTAs c0 .. c1 (CTA c's in its slot 0
// when the segment holds the CTA's first unit c per, else in slot 1),
// merged in CTA order into out, m and l of heads h0 .. h0 + G: 4 dims of
// one head a thread, the loads of CB parts in flight at once, each round
// rescaling the sums to its largest m (one pass, the same order every run).
template <int D, int G>
__device__ __forceinline__ void merge_parts(const float* part, bf16* out, float* m_out,
                                            float* l_out, size_t h0, int c0, int c1, int a0,
                                            int per) {
  constexpr int SLOT = G * (D + 4), CB = 16;
  const auto slot = [&](int c) { return part + (2 * size_t(c) + (a0 <= c * per ? 0 : 1)) * SLOT; };
  for (int idx = threadIdx.x; idx < G * D / 4; idx += THREADS) {
    const int gq = idx / (D / 4), dd = (idx % (D / 4)) * 4;
    float M = NEG_INF, L = 0.f;
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = c0; c <= c1; c += CB) {
      float mc[CB], lc[CB];
      float4 u[CB];
#pragma unroll
      for (int e = 0; e < CB; ++e) {
        const float* Pc = slot(min(c + e, c1));
        mc[e] = c + e <= c1 ? __ldcg(Pc + G * D + gq) : NEG_INF;
        lc[e] = __ldcg(Pc + G * D + G + gq);
        u[e] = __ldcg(reinterpret_cast<const float4*>(Pc + gq * D + dd));
      }
      float Mn = M;
#pragma unroll
      for (int e = 0; e < CB; ++e) Mn = fmaxf(Mn, mc[e]);
      const float r = fast_exp(M - Mn);
      L *= r;
      O.x *= r;
      O.y *= r;
      O.z *= r;
      O.w *= r;
#pragma unroll
      for (int e = 0; e < CB; ++e) {
        const float f = c + e <= c1 ? fast_exp(mc[e] - Mn) : 0.f;
        L += lc[e] * f;
        O.x += u[e].x * f;
        O.y += u[e].y * f;
        O.z += u[e].z * f;
        O.w += u[e].w * f;
      }
      M = Mn;
    }
    const float inv = 1.f / L;
    *reinterpret_cast<uint2*>(out + (h0 + gq) * D + dd) =
        make_uint2(pack_bf16(O.x * inv, O.y * inv), pack_bf16(O.z * inv, O.w * inv));
    if (dd == 0 && m_out != nullptr) {
      m_out[h0 + gq] = M;
      l_out[h0 + gq] = L;
    }
  }
}

// One CTA of 4 warps over its share of the units; see the header.
template <int D, int G, typename KV>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
paged_kernel(const bf16* __restrict__ q, const KV* __restrict__ kp, const KV* __restrict__ vp,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ table, const int* __restrict__ lens, bf16* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ part,
             int* __restrict__ counters, int B, int H, int KVH, int num_pages, int page, int pps,
             float scale) {
  using S = Smem<KV, D>;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int E = 16 / int(sizeof(KV)), RC = UT * CPR<KV, D>;    // RC: chunks of a tile
  constexpr int DW = D / NW;           // head dims a warp
  constexpr int KS = DW / 16;          // k steps of q kᵀ a warp
  constexpr int NTW = DW / 8;          // n tiles of P V a warp (2 or 4: one group of 32 dims)
  constexpr int SLOT = G * (D + 4);    // a partial: acc [G][D], m [G], l [G]
  constexpr int IT = 2 * RC / THREADS;  // 16-byte chunks of a unit a thread copies
  static_assert(2 * RC % THREADS == 0, "whole chunks a thread");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  int* cum = reinterpret_cast<int*>(smem_raw + sizeof(S));   // [B + 1]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int cap = pps * page;

  // 1. the units of every row, prefix-summed: cum[b] units before row b
  int run = 0;
  for (int b0 = 0; b0 < B; b0 += THREADS) {
    const int b = b0 + tid;
    int x = b < B ? (min(max(lens[b], 0), cap) + UT - 1) / UT : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s.wsum[warp] = x;
    __syncthreads();
    int before = run, total = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      before += w < warp ? s.wsum[w] : 0;
      total += s.wsum[w];
    }
    if (b < B) cum[b + 1] = before + x;
    run += total;
    __syncthreads();
  }
  if (tid == 0) cum[0] = 0;
  __syncthreads();
  const int N = KVH * run;
  const int per = (N + int(gridDim.x) - 1) / int(gridDim.x);
  const int s0 = int(blockIdx.x) * per, e0 = min(N, s0 + per);

  // rows without a unit: out = 0, m = NEG_INF, l = 0
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (cum[b + 1] != cum[b]) continue;
    for (int i = tid; i < H * D / 8; i += THREADS)
      *reinterpret_cast<uint4*>(out + size_t(b) * H * D + 8 * i) = make_uint4(0u, 0u, 0u, 0u);
    if (m_out != nullptr)
      for (int i = tid; i < H; i += THREADS) {
        m_out[size_t(b) * H + i] = NEG_INF;
        l_out[size_t(b) * H + i] = 0.f;
      }
  }
  if (s0 >= e0) return;

  // the row holding flat unit x: the last b with KVH cum[b] <= x
  auto row_of = [&](int x) {
    int lo = 0, hi = B;                // cum[lo] KVH <= x < cum[hi] KVH
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (KVH * cum[mid] <= x) lo = mid;
      else hi = mid;
    }
    return lo;
  };
  // this thread's 16-byte chunks of a unit: K or V (known at compile time
  // when a tile is whole rounds of the CTA's), its row, its offset in the
  // pool from the unit's first row and in a stage
  bool cv[IT];
  int crow[IT], cgo[IT], cso[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int c = it * THREADS + tid;
    cv[it] = RC % THREADS == 0 ? it >= RC / THREADS : c >= RC;
    const int cc = cv[it] ? c - RC : c, r = cc / CPR<KV, D>, ch = cc % CPR<KV, D>;
    crow[it] = r;                      // half r / TOK, its row r % TOK
    cgo[it] = (r % TOK) * D + ch * E;
    cso[it] = r * D + (cv[it] ? vswz<KV, D>(r, ch) : kswz<KV, D>(r, ch)) * E;
    ptt::opaque(cgo[it]);
    ptt::opaque(cso[it]);
  }
  // this lane's fragments in a stage: K rows 8 nt + g at its dims of k step
  // j, V rows 2t, 2t + 1, 2t + 8, 2t + 9 at dims 32 jg + 4 g, the first
  // half's (the second's are 16 rows on). n tile j holds the dims 32 jg + 4
  // n + cw + j
  const int jg = warp * NTW / 4, cw = (warp * NTW) % 4;
  int koff[KS][2], voff[4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      ptt::opaque(koff[j][nt] = at4<KV, D, false>(8 * nt + g, warp * DW + 16 * j + 4 * t));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    ptt::opaque(voff[k] = at4<KV, D, true>(2 * t + k % 2 + 8 * (k / 2), 32 * jg + 4 * g));
  auto issue = [&](int li, int st) {  // unit li of the list into stage st, one group
    const int val = s.valid[li];
#pragma unroll
    for (int it = 0; it < IT; ++it)
      ptt::cp_async16((cv[it] ? s.v[st] : s.k[st]) + cso[it],
                      (cv[it] ? vp : kp) + s.src[li][crow[it] / TOK] + cgo[it],
                      crow[it] < val ? 16 : 0);
    if (QUANT && tid < 2 * UT / 4) {   // k then v, each 2 halves of 4 chunks
      const bool isv = tid >= UT / 4;
      const int c = tid % (UT / 4), h = c / (TOK / 4);
      ptt::cp_async16((isv ? s.vs[st] : s.ks[st]) + 4 * c,
                      (isv ? vs : ks) + s.sc[li][h] + 4 * (c % (TOK / 4)), 4 * c < val ? 16 : 0);
    }
    // the queries of a unit that may start a segment's part
    if (s.head[li])
      for (int c = tid; c < G * D / 8; c += THREADS)
        ptt::cp_async16(s.qs[st] + 8 * c, q + (size_t(s.row[li]) * H + s.kvh[li] * G) * D + 8 * c,
                        16);
    ptt::cp_async_commit();
  };

  // the softmax state of the current segment's part: row g of the group's
  // heads, this warp's head dims
  float m = NEG_INF, l = 0.f, acc[NTW][4];
  uint32_t qa[KS][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  int done = 0;                        // units done: red[done & 1] holds the next scores
  bool fresh = true;                   // the window's first unit starts a segment's part
  for (int w0 = s0; w0 < e0; w0 += LIST) {
    const int n = min(LIST, e0 - w0);
    __syncthreads();                   // the previous window is done with the list
    for (int li = tid; li < n; li += THREADS) {
      const int x = w0 + li, b = row_of(x), nu = cum[b + 1] - cum[b];
      const int off = x - KVH * cum[b], kh = off / nu, u = off % nu;
      const int len = min(max(lens[b], 0), cap);
#pragma unroll
      for (int h = 0; h < 2; ++h) {    // a half past the length repeats the first
        const int t0 = (u * 2 + (UT * u + TOK < len ? h : 0)) * TOK;
        const long long phys = table[size_t(b) * pps + t0 / page];
        s.src[li][h] = ((static_cast<long long>(kh) * num_pages + phys) * page + t0 % page) * D;
        s.sc[li][h] = int((phys * KVH + kh) * page + t0 % page);
      }
      s.row[li] = b;
      s.kvh[li] = kh;
      s.valid[li] = min(UT, len - u * UT);
      s.head[li] = li == 0 || u == 0;
      s.tail[li] = u == nu - 1 || x == e0 - 1;
    }
    __syncthreads();
    // this warp's partial scores of unit u (its dims; tokens 8 nt + g as
    // the n side) into red[slot]
    const auto scores = [&](int u, int slot) {
      const KV* kt = s.k[u % STAGES];
      float sc[4][4] = {};
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const uint32_t a[4] = {qa[j][0], 0u, qa[j][1], 0u};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b0, b1;
          k_frag<KV>(ld4<KV>(kt + koff[j][nt % 2] + (nt / 2) * TOK * D), b0, b1);
          ptt::mma16816(sc[nt], a, b0, b1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s.red[slot][warp][h][lane] =
            make_float4(sc[2 * h][0], sc[2 * h][1], sc[2 * h + 1][0], sc[2 * h + 1][1]);
    };
    // the queries of the segment whose part starts at unit u, permuted as
    // k_frag's dims, from u's stage
    const auto queries = [&](int u) {
      const bf16* qrow = s.qs[u % STAGES] + g * D;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int d = warp * DW + 16 * j + 4 * t;
        qa[j][0] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
        qa[j][1] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + d + 2) : 0u;
      }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n) issue(i, i);
      else ptt::cp_async_commit();
    }
    ptt::cp_async_wait<STAGES - 2>();
    __syncthreads();                   // unit 0 landed
    if (fresh) queries(0);
    fresh = false;
    scores(0, done & 1);
    // unit i's softmax and P V beside unit i + 1's scores, one barrier a unit
    for (int i = 0; i < n; ++i, ++done) {
      ptt::cp_async_wait<STAGES - 3>();
      __syncthreads();                 // unit i + 1 landed, unit i's scores are in red;
                                       // unit i - 1's stage is free
      if (i + STAGES - 1 < n) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      else ptt::cp_async_commit();
      const int st = i % STAGES, val = s.valid[i];
      const bool ends = s.tail[i];
      // the scores of head g, tokens 16 h + 2t, + 1, + 8, + 9, summed in warp order
      float sv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 p = s.red[done & 1][w][h][lane];
          sv[4 * h] += p.x;
          sv[4 * h + 1] += p.y;
          sv[4 * h + 2] += p.z;
          sv[4 * h + 3] += p.w;
        }
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int tok = 8 * (e / 2) + 2 * t + e % 2;
        const float f = QUANT && tok < val ? scale * s.ks[st][tok] : scale;
        sv[e] = tok < val ? sv[e] * f : NEG_INF;
        mx = fmaxf(mx, sv[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m, mx), alpha = fast_exp(m - m_new);
      float pv[8];
      l *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int tok = 8 * (e / 2) + 2 * t + e % 2;
        const float p = tok < val ? fast_exp(sv[e] - m_new) : 0.f;
        l += p;
        pv[e] = QUANT && tok < val ? p * s.vs[st][tok] : p;
      }
      m = m_new;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        acc[j][0] *= alpha;
        acc[j][1] *= alpha;
      }
      // P V over this warp's n tiles, a k step a half: the weights as the A
      // operand (rows: heads, k: tokens), hi + lo
      const KV* vt = s.v[st];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ph[4], pl[4];
        ph[0] = pack_bf16(pv[4 * h], pv[4 * h + 1]);
        ph[2] = pack_bf16(pv[4 * h + 2], pv[4 * h + 3]);
        {
          const float2 h0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ph[0]));
          const float2 h2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ph[2]));
          pl[0] = pack_bf16(pv[4 * h] - h0.x, pv[4 * h + 1] - h0.y);
          pl[2] = pack_bf16(pv[4 * h + 2] - h2.x, pv[4 * h + 3] - h2.y);
        }
        ph[1] = ph[3] = pl[1] = pl[3] = 0u;
        const KV* vh = vt + h * TOK * D;
        const uint2 v0 = ld4<KV>(vh + voff[0]), v1 = ld4<KV>(vh + voff[1]);
        const uint2 v8 = ld4<KV>(vh + voff[2]), v9 = ld4<KV>(vh + voff[3]);
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const uint32_t b0 = v_pair<KV>(v0, v1, cw + j), b1 = v_pair<KV>(v8, v9, cw + j);
          ptt::mma16816(acc[j], ph, b0, b1);
          ptt::mma16816(acc[j], pl, b0, b1);
        }
      }
      if (i + 1 < n) {                 // the next unit's scores, with its part's queries
        if (ends) queries(i + 1);
        scores(i + 1, (done + 1) & 1);
      }
      fresh = ends;

      if (!ends) continue;
      const int b = s.row[i], kh = s.kvh[i];
      const int nu = cum[b + 1] - cum[b], a0 = KVH * cum[b] + kh * nu, z0 = a0 + nu;
      float lt = l + __shfl_xor_sync(FULL, l, 1);
      lt += __shfl_xor_sync(FULL, lt, 2);
      const size_t hq = size_t(b) * H + kh * G + g;   // this lane's head
      if (a0 >= s0 && z0 <= e0) {
        if (g < G) {
          bf16* o = out + hq * D + 32 * jg + 8 * t + cw;
          const float inv = 1.f / lt;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {   // dims 32 jg + 8 t + cw + j (+ 4)
            o[j] = __float2bfloat16(acc[j][0] * inv);
            o[j + 4] = __float2bfloat16(acc[j][1] * inv);
          }
          if (warp == 0 && t == 0 && m_out != nullptr) {
            m_out[hq] = m;
            l_out[hq] = lt;
          }
        }
      } else {
        float* P = part + (2 * size_t(blockIdx.x) + (a0 <= s0 ? 0 : 1)) * SLOT;
        if (g < G) {
          float* o = P + g * D + 32 * jg + 8 * t + cw;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            o[j] = acc[j][0];
            o[j + 4] = acc[j][1];
          }
          if (warp == 0 && t == 0) {
            P[G * D + g] = m;
            P[G * D + G + g] = lt;
          }
        }
        __syncthreads();               // the CTA's part is written: count it in
        const int c0 = a0 / per, c1 = (z0 - 1) / per;
        if (tid == 0) {
          s.last = ptt::atom_add_acq_rel(&counters[b * KVH + kh], 1) == c1 - c0;
          if (s.last) counters[b * KVH + kh] = 0;
        }
        __syncthreads();
        if (s.last) {
          merge_parts<D, G>(part, out, m_out, l_out, size_t(b) * H + kh * G, c0, c1, a0, per);
        }
      }
      m = NEG_INF;
      l = 0.f;
#pragma unroll
      for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *lens;
  void *out, *m, *l, *part, *counters;
  int grid, B, H, KVH, num_pages, page, pps;
  float scale;
  cudaStream_t stream;
};

template <int D, int G, typename KV>
cudaError_t launch(const Args& a) {
  static std::atomic<uint64_t> done{0};
  constexpr int base = int(sizeof(Smem<KV, D>));
  cudaError_t err = ptt::allow_smem(paged_kernel<D, G, KV>, base + 4 * (MAX_B + 1), done);
  if (err != cudaSuccess) return err;
  paged_kernel<D, G, KV><<<a.grid, THREADS, base + 4 * (a.B + 1), a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.table), static_cast<const int*>(a.lens),
      static_cast<bf16*>(a.out), static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.part), static_cast<int*>(a.counters), a.B, a.H, a.KVH, a.num_pages,
      a.page, a.pps, a.scale);
  return cudaGetLastError();
}

template <int D, typename KV>
cudaError_t launch_group(const Args& a) {
  switch (a.H / a.KVH) {
    case 1: return launch<D, 1, KV>(a);
    case 2: return launch<D, 2, KV>(a);
    case 4: return launch<D, 4, KV>(a);
    case 8: return launch<D, 8, KV>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
int launch_dim(const Args& a, int d) {
  if (a.B <= 0 || a.B > MAX_B || a.KVH <= 0 || a.H % a.KVH != 0 || a.page <= 0
      || a.page % TOK != 0 || a.pps <= 0 || a.grid <= 0)
    return int(cudaErrorInvalidValue);
  if (d == 128) return int(launch_group<128, KV>(a));
  if (d == 64) return int(launch_group<64, KV>(a));
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernel's grid on device `device` (CTAS_PER_SM CTAs an SM): the
// partials' scratch holds 2 slots a CTA.
int ptt_paged_grid(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return CTAS_PER_SM * sms;
}

// The most rows a launch takes.
int ptt_paged_max_rows() { return MAX_B; }

// m and l may be null (no stats). part is f32 scratch of 2 grid group (d +
// 4) floats (group = H / KVH) and counters B KVH int32 zeros, which every
// launch leaves at 0. One launch of `grid` CTAs; returns cudaGetLastError().
int ptt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* seq_lens, void* out, void* m,
                     void* l, void* part, void* counters, int grid, int B, int H, int KVH,
                     int num_pages, int page, int pps, int d, float scale, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, page_table, seq_lens, out, m, l,
               part, counters, grid, B, H, KVH, num_pages, page, pps, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_dim<bf16>(a, d);
}

// The same over int8 pages [KVH, P, page, D] with their f32 scales
// k_scales / v_scales [P, KVH, page].
int ptt_paged_decode_int8(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales, const void* page_table,
                          const void* seq_lens, void* out, void* m, void* l, void* part,
                          void* counters, int grid, int B, int H, int KVH, int num_pages,
                          int page, int pps, int d, float scale, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr) return int(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, k_scales, v_scales, page_table, seq_lens, out, m, l,
               part, counters, grid, B, H, KVH, num_pages, page, pps, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_dim<int8_t>(a, d);
}

}  // extern "C"
