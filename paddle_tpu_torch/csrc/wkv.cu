// The RWKV-5 WKV recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/wkv.py: the forward
// `_fwd_kernel` (pl.pallas_call at :301) and the backward `_bwd_kernel`
// (pl.pallas_call at :350). Per batch row and head, with the [d, d] f32
// state S (rows: the key channel i, columns: the value channel j), w =
// exp(min(logw, 0)) and the bonus u, both [h, d] f32:
//   out_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t),    S_t = diag(w) S_{t-1} + k_tᵀ v_t
// The backward gives dr, dk, dv (the inputs' type) and dlogw, du ([h, d]
// f32, summed over the batch), dlogw zero where logw >= 0 (the clamp).
//
// What bounds it on the H100: bytes at the path's shapes (b16 l1024 h12
// d64, bf16): at the tensor cores' rate the chunked matrix form, 2 b h l (c
// + 2d) d operations forward, takes a fraction of the time needed to read
// r, k, v and write y.
//
// Both directions run the chunked matrix form, every chunk in parallel.
// With a chunk of CH steps (64 at d = 64, 32 at d = 128), position j in the
// chunk, S_in the state entering it and t0 the first step of j's 16-step
// sub-chunk, the pairs s < j inside the chunk weigh v_s by
//   A[j,s] = sum_i r_j[i] w_i^(j-1-s) k_s[i].
// On the 16 x 16 diagonal sub-blocks A comes from the masked decay cube on
// the CUDA cores. Off them, w^(j-1-s) = w^(j-t0) w^(t0-1-s): both exponents
// are >= 0 steps of a non-positive log decay, so every factor is <= 1, and
// A is the product of r o w^(j-t0) and k o w^(t0-1-s) (`intra_a`). Every
// product runs on mma.sync (ssm_common.cuh): bf16 tiles through ldmatrix,
// f32 tiles as split TF32. Only non-positive numbers are exponentiated and
// an exponent of 0 gives exactly 1, so w = 0 (logw at its -1e10 floor)
// stays exact.
//
// Forward, two launches:
//  1. wkv_fwd_carry_kernel carries S_in over the chunks, S_in <- diag(w^CH)
//     S_in + (k o w^(CH-1-j))ᵀ v (`carry`, the backward's role 0), into [b,
//     nc, h, d, d] scratch in the I/O type;
//  2. wkv_fwd_chunk_kernel, one block per (chunk, head, b):
//     y_j = (r_j o w^j) S_in + sum_{s<j} A[j,s] v_s + (r_j . (u o k_j)) v_j,
//     the readout and A v as two mma.sync products.
// The forward saves nothing for the backward; y is the same bit for bit on
// every run (no atomics).
//
// Backward: the chunked matrix form of `_bwd_kernel` (:174-287), two
// launches. With dS_out the gradient of the state leaving a chunk:
//  1. wkv_bwd_carry_kernel carries both over the chunks: role 0 forward,
//     S_in <- diag(w^CH) S_in + (k o w^(CH-1-j))ᵀ v, role 1 backward,
//     dS_out <- diag(w^CH) dS_out + (r o w^j)ᵀ dy, one [d x CH] x [CH x
//     SLICE] mma.sync product a chunk on a slice of the state's columns
//     (both maps act on the columns one by one, so the slices of one head
//     are blocks of their own), carried in f32 and stored in the I/O type
//     (the chunk kernel's products take them in it) into [b, nc, h, d, d]
//     scratch each; with bf16 I/O the scaled operand's rounding remainder
//     joins the product and each state leaves with its remainder too
//     (scratch of the same shape), so the states reach the chunk kernel to
//     ~2^-17 of their size;
//  2. wkv_bwd_chunk_kernel, one block per (chunk, head, b), follows
//     `_bwd_kernel`'s chain from S_in and dS_out: the readout dr += w^j o
//     (dy S_inᵀ), the state update dk += w^(CH-1-s) o (v dS_outᵀ), dv += (k o
//     w^(CH-1-s)) dS_out, the bonus, and the pairs s < j through A and dA[j,s]
//     = dy_j . v_s, the gradients through A on the diagonal sub-blocks from
//     the decay cube, off them products of r o w^(j-t0), k o w^(t0-1-s) and
//     dA.
// dlogw: d(w^n)/dlogw = n w^n, so each factored term carries its own
// exponent (`_decay_tables`' p* tables): a (r~ o dr~) and b (k~ o dk~) with a,
// b < CH, j (readout), CH-1-s (update), CH w^CH (S_in o dS_out) summed over
// the columns, (j-1-s) on the cube. No term subtracts two sums over the
// sequence. With bf16 I/O every product whose terms feed dlogw takes its
// bf16 operands with their remainders (rt, dA, kt, S_in, dS_out: a second
// product on the remainder, kt's and the states' in their own buffer once
// the first is done): those sums cancel on slowly decaying channels, and
// one bf16 rounding of a state or of kt left dlogw up to 1% of max |dlogw|
// from float64 (PERF.md). dlogw and du come out per (b, chunk), [b, nc,
// h, d] f32, summed by the caller in a fixed order: no atomics, the same
// result on every run. The backward's scratch is 2 b nc h d² in the I/O
// type, 4 with bf16 I/O (the remainders: 100 MB at the path's shapes);
// the forward's b nc h d².

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "ssm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptt::ssm;

// ------------------------------------------------------------------ backward
constexpr int THREADS = 256;           // the chunk kernel
constexpr int CARRY_THREADS = 128;     // the carry kernel
constexpr int SLICE = 64;              // state columns a carry block
constexpr int SUB = 16;                // the decay cube's sub-chunk

template <int D>
struct Chunk {
  static constexpr int CH = D == 64 ? 64 : 32;
};

// v as T, and with LO its rounding remainder as T (bf16 hi + lo carries
// ~2^-17 of v; an f32 tile keeps v whole and needs no remainder)
template <bool LO, typename T>
__device__ __forceinline__ void split(float v, T& hi, T& lo) {
  hi = from_f<T>(v);
  if (LO) lo = from_f<T>(v - to_f(hi));
}

// dst row q (stride LDD) = src row r o w^n, (r, n) = map(q), for q < rows,
// with LO its remainder into dst_lo (a null dst: the remainder alone): 16
// bytes a thread and step; pw(n, x) gives w^n of the channels x and x + 1
template <int D, int LDD, int LDS, int NTH, bool LO, typename T, typename Map, typename Pow>
__device__ __forceinline__ void scale_rows(T* dst, T* dst_lo, const T* src, int rows, Map map,
                                           Pow pw) {
  constexpr int E = 16 / int(sizeof(T)), VPR = D / E;
  for (int i = threadIdx.x; i < rows * VPR; i += NTH) {
    const int q = i / VPR, x = (i % VPR) * E;
    int r, n;
    map(q, r, n);
    const uint4 in = *reinterpret_cast<const uint4*>(src + r * LDS + x);
    const T* e = reinterpret_cast<const T*>(&in);
    uint4 out, out_lo;
    T* o = reinterpret_cast<T*>(&out);
    T* ol = reinterpret_cast<T*>(&out_lo);
#pragma unroll
    for (int c = 0; c < E; c += 2) {
      const float2 w2 = pw(n, x + c);
      split<LO>(to_f(e[c]) * w2.x, o[c], ol[c]);
      split<LO>(to_f(e[c + 1]) * w2.y, o[c + 1], ol[c + 1]);
    }
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + q * LDD + x) = out;
    if (LO) *reinterpret_cast<uint4*>(dst_lo + q * LDD + x) = out_lo;
  }
}

// A warp's product tile t (rows m0 + g (+ 8), columns n0 + 8 nt + c2 (+ 1))
// scaled by w^n(row) into acc, and n(row) w^n o m o t summed into dlw's
// columns: the term's exponent bookkeeping for dlogw (m: r or k, the
// operand the decay multiplied). w^n = exp2(n lw2) from the columns' log2
// decays lw2 <= 0.
template <int NT, int LD, typename T, typename Exp>
__device__ __forceinline__ void decay_add(float (&acc)[NT][4], float (&dlw)[NT][2],
                                          const float (&t)[NT][4], const float2 (&lw2)[NT],
                                          const T* m, int m0, int n0, int g, int c2,
                                          Exp exponent) {
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = m0 + g + 8 * h2, n = exponent(row);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int x = n0 + 8 * nt + c2;
      const float2 v = pair(m + row * LD + x);
      const float a = exp2f(float(n) * lw2[nt].x) * t[nt][2 * h2];
      const float b = exp2f(float(n) * lw2[nt].y) * t[nt][2 * h2 + 1];
      acc[nt][2 * h2] += a;
      acc[nt][2 * h2 + 1] += b;
      dlw[nt][0] += float(n) * v.x * a;
      dlw[nt][1] += float(n) * v.y * b;
    }
  }
}

template <typename T, int D, bool EXACT>
struct CarrySmem {
  static constexpr int CH = Chunk<D>::CH, PD = Pad<T>::V;
  T a[CH][D + PD];                     // k o w^(CH-1-j) (forward) or r o w^j (backward)
  T a_lo[EXACT ? CH : 1][D + PD];      // EXACT: a's rounding remainder
  T b[CH][SLICE + PD];                 // the block's columns of v or dy
  float scale[CH][D];                  // w^(CH-1-j) or w^j
  float wc[D];                         // w^CH
};

// The state at every chunk's edge for the columns [SLICE blockIdx.x, + SLICE) of
// head blockIdx.y % H of batch row blockIdx.y / H, [b, nc, h, d, d] in the
// I/O type: fwd, S_in of every chunk from k and v; else dS_out from r and
// dy, the chunks taken from the last. Each chunk's operands are loaded
// while the previous chunk's product runs. EXACT (bf16 for the backward):
// the scaled operand's rounding remainder joins the product, and the state
// leaves as its bf16 rounding in out and the remainder in out_lo.
template <typename T, int D, bool EXACT>
__device__ __forceinline__ void carry(const T* __restrict__ src_a, const T* __restrict__ src_b,
                                      const float* __restrict__ logw, T* __restrict__ out,
                                      T* __restrict__ out_lo, bool fwd, int L, int H) {
  using S = CarrySmem<T, D, EXACT>;
  constexpr int CH = S::CH, PD = S::PD, NTH = CARRY_THREADS;
  constexpr int MT = D / 64, NT = SLICE / 8;  // a warp: D / 4 rows, the slice's columns
  using RA = RowVecs<CH, D, T, NTH>;
  using RB = RowVecs<CH, SLICE, T, NTH>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int col0 = blockIdx.x * SLICE, bi = blockIdx.y / H, hi = blockIdx.y % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4;
  const int c2 = 2 * (lane % 4), m0 = warp * (D / 4);
  const int nc = (L + CH - 1) / CH;
  for (int i = tid; i < CH * D; i += NTH) {
    const int j = i / D, x = i % D;
    const float lw = fminf(logw[hi * D + x], 0.f);
    s.scale[j][x] = expf(float(fwd ? CH - 1 - j : j) * lw);
    if (j == 0) s.wc[x] = expf(float(CH) * lw);
  }
  const long st = long(H) * D;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(acc[mt]);
  // two chunks' operands in flight: chunk step + 2 loads while steps step
  // and step + 1 are computed
  uint4 va[2][RA::IT], vb[2][RB::IT];
  auto chunk_of = [&](int step) { return fwd ? step : nc - 1 - step; };
  auto fetch = [&](uint4 (&a)[RA::IT], uint4 (&b)[RB::IT], int c) {
    const int t0 = c * CH, len = min(CH, L - t0);
    const size_t row0 = size_t(bi) * L + t0;
    load_rows<CH, D, NTH>(a, src_a, row0, st, long(hi) * D, len);
    load_rows<CH, SLICE, NTH>(b, src_b, row0, st, long(hi) * D + col0, len);
  };
  auto body = [&](uint4 (&a)[RA::IT], uint4 (&b)[RB::IT], int step) {
    const int c = chunk_of(step);
    const size_t at = ((size_t(bi) * nc + c) * H + hi) * D * D + col0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const size_t o = at + (m0 + 16 * mt + g + 4 * e) * D + 8 * nt + c2;
          const float x = acc[mt][nt][e], y = acc[mt][nt][e + 1];
          store_pair(out + o, x, y);
          if (EXACT)
            store_pair(out_lo + o, x - to_f(from_f<T>(x)), y - to_f(from_f<T>(y)));
        }
    __syncthreads();                   // the previous chunk is done with the tiles
#pragma unroll
    for (int it = 0; it < RA::IT; ++it) {
      const int i = it * NTH + tid;
      if (!RA::EXACT && i >= RA::TOTAL) continue;
      const int j = i / RA::VPR, x0 = (i % RA::VPR) * RA::E;
      const T* e = reinterpret_cast<const T*>(&a[it]);
      uint4 o, ol;
      T* oe = reinterpret_cast<T*>(&o);
      T* oel = reinterpret_cast<T*>(&ol);
#pragma unroll
      for (int q = 0; q < RA::E; q += 4) {
        const float4 w = *reinterpret_cast<const float4*>(&s.scale[j][x0 + q]);
        split<EXACT>(to_f(e[q]) * w.x, oe[q], oel[q]);
        split<EXACT>(to_f(e[q + 1]) * w.y, oe[q + 1], oel[q + 1]);
        split<EXACT>(to_f(e[q + 2]) * w.z, oe[q + 2], oel[q + 2]);
        split<EXACT>(to_f(e[q + 3]) * w.w, oe[q + 3], oel[q + 3]);
      }
      *reinterpret_cast<uint4*>(&s.a[j][x0]) = o;
      if (EXACT) *reinterpret_cast<uint4*>(&s.a_lo[j][x0]) = ol;
    }
    store_rows<CH, SLICE, NTH>(&s.b[0][0], SLICE + PD, b);
    if (step + 2 < nc) fetch(a, b, chunk_of(step + 2));
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= s.wc[m0 + 16 * mt + g + 8 * (e / 2)];
      mma_tile<CH, NT, true, true>(acc[mt], &s.a[0][0], D + PD, &s.b[0][0], SLICE + PD,
                                   m0 + 16 * mt, 0, lane);
      if (EXACT)
        mma_tile<CH, NT, true, true>(acc[mt], &s.a_lo[0][0], D + PD, &s.b[0][0], SLICE + PD,
                                     m0 + 16 * mt, 0, lane);
    }
  };
  fetch(va[0], vb[0], chunk_of(0));
  if (nc > 1) fetch(va[1], vb[1], chunk_of(1));
  for (int step = 0; step < nc; step += 2) {
    body(va[0], vb[0], step);
    if (step + 1 < nc) body(va[1], vb[1], step + 1);
  }
}

// The forward's S_in (grid (D / SLICE, b h)).
template <typename T, int D>
__global__ void __launch_bounds__(CARRY_THREADS)
wkv_fwd_carry_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ logw, T* __restrict__ s_in, int L, int H) {
  carry<T, D, false>(k, v, logw, s_in, nullptr, true, L, H);
}

// The backward's S_in (blockIdx.z = 0) and dS_out (1), grid (D / SLICE, b h,
// 2); with bf16 I/O also their remainders (s_in_lo, ds_out_lo).
template <typename T, int D>
__global__ void __launch_bounds__(CARRY_THREADS)
wkv_bwd_carry_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dy, const float* __restrict__ logw,
                     T* __restrict__ s_in, T* __restrict__ ds_out, T* __restrict__ s_in_lo,
                     T* __restrict__ ds_out_lo, int L, int H) {
  const bool fwd = blockIdx.z == 0;
  carry<T, D, (sizeof(T) == 2)>(fwd ? k : r, fwd ? v : dy, logw, fwd ? s_in : ds_out,
                                fwd ? s_in_lo : ds_out_lo, fwd, L, H);
}

// s.rt = r_j o w^(j - t0) (with LO its remainder into rtl) and the rows of
// s.kt, k_s o w^(SUB J - 1 - s) for s < SUB J, from row SUB J (J - 1) / 2,
// for each sub-chunk J > 0: the factors of A off the diagonal sub-blocks.
// table(n, x) and power(n, x) give w^n of the channels x, x + 1.
// row q of s.kt: k_r o w^n, r < SUB J, n = SUB J - 1 - r, J the sub-chunk
// whose rows start at SUB J (J - 1) / 2
struct KtRow {
  __device__ __forceinline__ void operator()(int q, int& r, int& n) const {
    int J = 1;
    while (q >= SUB * J * (J + 1) / 2) ++J;
    r = q - SUB * J * (J - 1) / 2;
    n = SUB * J - 1 - r;
  }
};

template <int CH, int D, int LD, bool LO, typename Sm, typename T, typename Table,
          typename Power>
__device__ __forceinline__ void factor_rows(Sm& s, T* rtl, Table table, Power power) {
  scale_rows<D, LD, LD, THREADS, LO>(&s.rt[0][0], rtl, &s.r[0][0], CH,
                                     [](int q, int& r, int& n) { r = q; n = q % SUB; }, table);
  scale_rows<D, LD, LD, THREADS, false>(&s.kt[0][0], static_cast<T*>(nullptr), &s.k[0][0],
                                        Sm::KT, KtRow{}, power);
}

// A[j][s] of the chunk's pairs s < j into X (rows of LX), zero on and above
// the diagonal: off the diagonal sub-blocks a product of s.rt and s.kt a
// warp, on them the decay cube of s.r, s.k and s.wp on the CUDA cores
template <int CH, int D, int LD, int LX, typename Sm, typename T>
__device__ __forceinline__ void intra_a(Sm& s, T* X, int warp, int lane) {
  constexpr int NB = CH / SUB;
  const int tid = threadIdx.x, g = lane / 4, c2 = 2 * (lane % 4);
  if (warp < NB * (NB - 1) / 2) {      // A off the diagonal: sub-chunk J's rows, Sb's columns
    int J = 1;
    while (warp >= J * (J + 1) / 2) ++J;
    const int Sb = warp - J * (J - 1) / 2;
    float t[2][4];
    zero(t);
    mma_tile<D, 2, false, false>(t, &s.rt[SUB * J][0], LD,
                                 &s.kt[SUB * J * (J - 1) / 2 + SUB * Sb][0], LD, 0, 0, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        X[(SUB * J + g + 8 * (e / 2)) * LX + SUB * Sb + 8 * nt + c2 + e % 2] = from_f<T>(t[nt][e]);
  }
  // A on the diagonal: the decay cube over the pairs s < j of each sub-chunk
  constexpr int PAIRS = SUB * (SUB - 1) / 2;
  for (int p = tid; p < NB * PAIRS; p += THREADS) {
    const int q = p % PAIRS, j0 = SUB * (p / PAIRS);
    int jj = 1;
    while (q >= jj * (jj + 1) / 2) ++jj;
    const int j = j0 + jj, sj = j0 + q - jj * (jj - 1) / 2;
    const float* w = s.wp[j - 1 - sj];
    constexpr int E = 16 / int(sizeof(T));
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int x = 0; x < D; x += E) {
      const uint4 r4 = *reinterpret_cast<const uint4*>(&s.r[j][x]);
      const uint4 k4 = *reinterpret_cast<const uint4*>(&s.k[sj][x]);
      const T *re = reinterpret_cast<const T*>(&r4), *ke = reinterpret_cast<const T*>(&k4);
#pragma unroll
      for (int c = 0; c < E; c += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + x + c);
        a[0] += to_f(re[c]) * to_f(ke[c]) * w4.x;
        a[1] += to_f(re[c + 1]) * to_f(ke[c + 1]) * w4.y;
        a[2] += to_f(re[c + 2]) * to_f(ke[c + 2]) * w4.z;
        a[3] += to_f(re[c + 3]) * to_f(ke[c + 3]) * w4.w;
      }
    }
    X[j * LX + sj] = from_f<T>((a[0] + a[1]) + (a[2] + a[3]));
  }
  for (int q = tid; q < CH * CH; q += THREADS) {    // and zero on and above it
    const int j = q / CH, sj = q % CH;
    if (sj >= j) X[j * LX + sj] = from_f<T>(0.f);
  }
}

template <typename T, int D>
struct ChunkSmem {
  static constexpr int CH = Chunk<D>::CH, PD = Pad<T>::V, NB = CH / SUB;
  static constexpr int LD = D + PD, LC = CH + PD, LX = LC > LD ? LC : LD;
  static constexpr int KT = SUB * NB * (NB - 1) / 2;
  T r[CH][LD], k[CH][LD], v[CH][LD], dy[CH][LD];
  T S[D][LD];                          // S_in, then dS_out
  T rt[CH][LD];                        // r o w^(j - t0), t0 the first step of j's sub-chunk
  T kt[KT][LD];                        // k o w^(SUB J - 1 - s), s < SUB J, from row 8 J (J - 1)
  T X[CH][LX];                         // A [j][s], then k o w^(CH - 1 - s)
  T dA[CH][LC];                        // dy_j . v_s below the diagonal
  // bf16 tiles: the remainders of rt and dA, which feed dlogw's sums (on
  // slowly decaying channels those cancel to a small part of their terms)
  static constexpr bool LO = sizeof(T) == 2;
  T rtl[LO ? CH : 1][LD], dAl[LO ? CH : 1][LC];
  float wp[SUB][D + 4];                // w^n, n < SUB (rows 4 banks apart)
  float lw2[D];                        // min(logw, 0) log2(e): w^n = exp2(n lw2)
  float u[D], sdot[D], srow[CH], ruk[CH];
  float red[Warps<CH>::WM][D];         // dlogw by warp row
};

// One block per (chunk, head, b); 8 warps, each a 16-row by d / WN-column
// tile (rows: the chunk's steps) of dr, then dv, then dk in registers.
// dlogw and du partials go to [b, nc, h, d].
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
wkv_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dy, const float* __restrict__ logw,
                     const float* __restrict__ bonus, const T* __restrict__ s_in,
                     const T* __restrict__ ds_out, const T* __restrict__ s_in_lo,
                     const T* __restrict__ ds_out_lo, T* __restrict__ dr, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dlogw_part,
                     float* __restrict__ du_part, int L, int H) {
  using S = ChunkSmem<T, D>;
  constexpr int CH = S::CH, NB = S::NB, LD = S::LD, LC = S::LC, LX = S::LX;
  constexpr bool LO = S::LO;
  constexpr int WM = Warps<CH>::WM, WN = Warps<CH>::WN;
  constexpr int NT = D / (8 * WN), NTC = CH / (8 * WN);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, c2 = 2 * (lane % 4);
  const int wm = warp % WM, wn = warp / WM, m0 = 16 * wm, n0 = wn * (D / WN);
  const int nc = (L + CH - 1) / CH, t0 = c * CH, len = min(CH, L - t0);
  const size_t row0 = size_t(bi) * L + t0;
  const long st = long(H) * D, col = long(hi) * D;
  const size_t sidx = ((size_t(bi) * nc + c) * H + hi) * D * D;
  const size_t pidx = ((size_t(bi) * nc + c) * H + hi) * D;
  {
    uint4 vr[RowVecs<CH, D, T>::IT], vk[RowVecs<CH, D, T>::IT];
    uint4 vv[RowVecs<CH, D, T>::IT], vd[RowVecs<CH, D, T>::IT];
    load_rows<CH, D>(vr, r, row0, st, col, len);
    load_rows<CH, D>(vk, k, row0, st, col, len);
    load_rows<CH, D>(vv, v, row0, st, col, len);
    load_rows<CH, D>(vd, dy, row0, st, col, len);
    if (tid < D) s.u[tid] = bonus[hi * D + tid];
    // the decay table while the tiles are in flight
    for (int i = tid; i < SUB * D; i += THREADS) {
      const int n = i / D, x = i % D;
      s.wp[n][x] = expf(float(n) * fminf(logw[hi * D + x], 0.f));
    }
    if (tid < D) s.lw2[tid] = fminf(logw[hi * D + tid], 0.f) * 1.4426950408889634f;
    {
      uint4 vs[RowVecs<D, D, T>::IT];
      load_rows<D, D>(vs, s_in + sidx, 0, D, 0, D);
      store_rows<D, D>(&s.S[0][0], LD, vs);
    }
    store_rows<CH, D>(&s.r[0][0], LD, vr);
    store_rows<CH, D>(&s.k[0][0], LD, vk);
    store_rows<CH, D>(&s.v[0][0], LD, vv);
    store_rows<CH, D>(&s.dy[0][0], LD, vd);
  }
  __syncthreads();
  {                                    // the bonus's row sums: v_j . dy_j, (r_j o u) . k_j
    constexpr int TPR = THREADS / CH, SPAN = D / TPR, E = 16 / int(sizeof(T));
    const int j = tid / TPR, x0 = (tid % TPR) * SPAN;
    float sv = 0.f, sr = 0.f;
#pragma unroll
    for (int x = x0; x < x0 + SPAN; x += E) {
      const uint4 v4 = *reinterpret_cast<const uint4*>(&s.v[j][x]);
      const uint4 d4 = *reinterpret_cast<const uint4*>(&s.dy[j][x]);
      const uint4 r4 = *reinterpret_cast<const uint4*>(&s.r[j][x]);
      const uint4 k4 = *reinterpret_cast<const uint4*>(&s.k[j][x]);
      const T *ve = reinterpret_cast<const T*>(&v4), *de = reinterpret_cast<const T*>(&d4);
      const T *re = reinterpret_cast<const T*>(&r4), *ke = reinterpret_cast<const T*>(&k4);
#pragma unroll
      for (int c = 0; c < E; ++c) {
        sv += to_f(ve[c]) * to_f(de[c]);
        sr += to_f(re[c]) * s.u[x + c] * to_f(ke[c]);
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) {
      sv += __shfl_xor_sync(FULL, sv, o);
      sr += __shfl_xor_sync(FULL, sr, o);
    }
    if (tid % TPR == 0) {
      s.srow[j] = sv;
      s.ruk[j] = sr;
    }
  }
  const auto table = [&](int n, int x) {
    return *reinterpret_cast<const float2*>(&s.wp[n][x]);
  };
  const auto power = [&](int n, int x) {
    const float2 l = *reinterpret_cast<const float2*>(&s.lw2[x]);
    return make_float2(exp2f(float(n) * l.x), exp2f(float(n) * l.y));
  };
  factor_rows<CH, D, LD, LO>(s, &s.rtl[0][0], table, power);
  __syncthreads();
  {                                    // du = sum_j (v_j . dy_j) r_j o k_j
    constexpr int JP = THREADS / (D / 2);   // threads a channel pair, over the rows
    const int x = 2 * (tid / JP), part = tid % JP;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = part; j < CH; j += JP) {
      const float2 rv = pair(&s.r[j][x]), kv = pair(&s.k[j][x]);
      acc.x += s.srow[j] * rv.x * kv.x;
      acc.y += s.srow[j] * rv.y * kv.y;
    }
#pragma unroll
    for (int o = 1; o < JP; o <<= 1) {
      acc.x += __shfl_xor_sync(FULL, acc.x, o);
      acc.y += __shfl_xor_sync(FULL, acc.y, o);
    }
    if (part == 0) *reinterpret_cast<float2*>(du_part + pidx + x) = acc;
  }
  // Each warp holds a 16-row tile of one output at a time (rows: the
  // chunk's steps j, or s for dk), with its dlogw partials by column: dr
  // first, while the state buffer holds S_in, then dv and dk from dS_out.
  float acc[NT][4], dlw[NT][2];
  zero(acc);
  zero(dlw);
  float2 lw2c[NT];                     // this thread's columns' log2 decays
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    lw2c[nt] = *reinterpret_cast<const float2*>(&s.lw2[n0 + 8 * nt + c2]);
  // with bf16 I/O the state's remainder (S - bf16(S)) takes the state
  // buffer for a second product wherever the state feeds dlogw
  const auto state_remainder = [&](const T* lo) {
    uint4 vl[RowVecs<D, D, T>::IT];
    load_rows<D, D>(vl, lo + sidx, 0, D, 0, D);
    __syncthreads();                   // every warp is done with the state's rounding
    store_rows<D, D>(&s.S[0][0], LD, vl);
    __syncthreads();
  };
  {                                    // the readout: dr += w^j o (dy S_inᵀ)
    float t[NT][4];
    zero(t);
    mma_tile<D, NT, false, false>(t, &s.dy[0][0], LD, &s.S[0][0], LD, m0, n0, lane);
    if constexpr (LO) {
      state_remainder(s_in_lo);
      mma_tile<D, NT, false, false>(t, &s.dy[0][0], LD, &s.S[0][0], LD, m0, n0, lane);
    }
    decay_add<NT, LD>(acc, dlw, t, lw2c, &s.r[0][0], m0, n0, g, c2,
                           [](int j) { return j; });
  }
  {                                    // dA = dy vᵀ below the diagonal
    float t[NTC][4];
    zero(t);
    const int nw = wn * (CH / WN);
    mma_tile<D, NTC, false, false>(t, &s.dy[0][0], LD, &s.v[0][0], LD, m0, nw, lane);
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = m0 + g + 8 * (e / 2), i = nw + 8 * nt + c2 + e % 2;
        split<LO>(i < j ? t[nt][e] : 0.f, s.dA[j][i], s.dAl[LO ? j : 0][i]);
      }
  }
  intra_a<CH, D, LD, LX>(s, &s.X[0][0], warp, lane);
  __syncthreads();
  {                                    // dr~ of sub-chunk wm against every earlier step
    float t[NT][4];
    zero(t);
    const T* kt = &s.kt[SUB * wm * (wm - 1) / 2][0];
    if (wm > 0)
      for (int kk = 0; kk < SUB * wm; kk += SUB) {
        mma_tile<SUB, NT, false, true>(t, &s.dA[0][kk], LC, kt + kk * LD, LD, m0, n0, lane);
        if (LO)
          mma_tile<SUB, NT, false, true>(t, &s.dAl[0][kk], LC, kt + kk * LD, LD, m0, n0, lane);
      }
    if constexpr (LO) {                // and kt's remainder, in kt's buffer (A is made)
      __syncthreads();
      scale_rows<D, LD, LD, THREADS, true>(static_cast<T*>(nullptr), &s.kt[0][0], &s.k[0][0],
                                           S::KT, KtRow{}, power);
      __syncthreads();
      if (wm > 0)
        for (int kk = 0; kk < SUB * wm; kk += SUB)
          mma_tile<SUB, NT, false, true>(t, &s.dA[0][kk], LC, kt + kk * LD, LD, m0, n0, lane);
    }
    if (wm > 0)
      decay_add<NT, LD>(acc, dlw, t, lw2c, &s.r[0][0], m0, n0, g, c2,
                             [m0](int j) { return j - m0; });
  }
  // the decay of this thread's columns, for the cube's Horner sums
  float2 wcol[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    wcol[nt] = *reinterpret_cast<const float2*>(&s.wp[1][n0 + 8 * nt + c2]);
  {                                    // the cube's dr inside sub-chunk wm, with its dlogw:
    // a = sum_{s < j} w^(j-1-s) k_s dA[j,s] over s ascending (Horner), q =
    // w da/dw = sum (j-1-s) w^(j-1-s) k_s dA[j,s]
    float a[NT][4], q[NT][4];
    zero(a);
    zero(q);
#pragma unroll
    for (int t = 0; t < SUB - 1; ++t) {
      const int sj = m0 + t;
      float2 kv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) kv[nt] = pair(&s.k[sj][n0 + 8 * nt + c2]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = m0 + g + 8 * h2;
        if ((h2 == 0 && t >= SUB / 2 - 1) || sj >= j) continue;   // rows 0-7: s < 7
        const float d = to_f(s.dA[j][sj]) + (LO ? to_f(s.dAl[LO ? j : 0][sj]) : 0.f);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* qq = &q[nt][2 * h2];
          float* aa = &a[nt][2 * h2];
          qq[0] = (qq[0] + aa[0]) * wcol[nt].x;
          qq[1] = (qq[1] + aa[1]) * wcol[nt].y;
          aa[0] = fmaf(aa[0], wcol[nt].x, kv[nt].x * d);
          aa[1] = fmaf(aa[1], wcol[nt].y, kv[nt].y * d);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)    // and the bonus
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = m0 + g + 8 * (e / 2), x = n0 + 8 * nt + c2 + e % 2;
        const float rj = to_f(s.r[j][x]);
        acc[nt][e] += a[nt][e] + s.srow[j] * s.u[x] * to_f(s.k[j][x]);
        dlw[nt][e % 2] += rj * q[nt][e];
      }
  }
  auto write = [&](T* out) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int j = m0 + g + 8 * h2;
      if (j >= len) continue;
      const size_t o = (row0 + j) * st + col + n0 + c2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store_pair(out + o + 8 * nt, acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
    }
  };
  write(dr);
  // dv = Aᵀ dy, while the state buffer turns from S_in into dS_out (each
  // thread rewrites the elements it reads) and sum_v S_in o dS_out is taken
  // by rows (with bf16 I/O the buffer holds S_in's remainder: the sum takes
  // both halves of each state, their two roundings from device memory)
  using RS = RowVecs<D, D, T>;         // the state as 16-byte vectors, RS::VPR lanes a row
  uint4 vd[RS::IT];
  load_rows<D, D>(vd, ds_out + sidx, 0, D, 0, D);   // in flight under the product
  zero(acc);
  mma_tile<CH, NT, true, true>(acc, &s.X[0][0], LX, &s.dy[0][0], LD, m0, n0, lane);
#pragma unroll
  for (int it = 0; it < RS::IT; ++it) {
    const int i = it * THREADS + tid, row = i / RS::VPR;
    uint4* p = reinterpret_cast<uint4*>(&s.S[row][(i % RS::VPR) * RS::E]);
    float dot = dot16<T>(*p, vd[it]);
    if constexpr (LO) {
      const size_t o = sidx + size_t(row) * D + (i % RS::VPR) * RS::E;
      const uint4 sh = *reinterpret_cast<const uint4*>(s_in + o);
      dot += dot16<T>(sh, vd[it]) + dot16<T>(sh, *reinterpret_cast<const uint4*>(ds_out_lo + o));
    }
    *p = vd[it];
#pragma unroll
    for (int o = 1; o < RS::VPR; o <<= 1) dot += __shfl_xor_sync(FULL, dot, o);
    if (lane % RS::VPR == 0) s.sdot[row] = dot;
  }
  __syncthreads();                     // A is read; the state buffer holds dS_out
  scale_rows<D, LX, LD, THREADS, false>(&s.X[0][0], static_cast<T*>(nullptr), &s.k[0][0], CH,
                                        [](int q, int& r, int& n) {
                                          r = q;
                                          n = CH - 1 - q;
                                        },
                                        power);
  __syncthreads();
  // dv += (k o w^(CH-1-s)) dS_out and the bonus
  mma_tile<D, NT, false, true>(acc, &s.X[0][0], LX, &s.S[0][0], LD, m0, n0, lane);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = m0 + g + 8 * (e / 2), x = n0 + 8 * nt + c2 + e % 2;
      acc[nt][e] += s.ruk[j] * to_f(s.dy[j][x]);
    }
  write(dv);
  zero(acc);
  {                                    // the state update: dk += w^(CH-1-s) o (v dS_outᵀ)
    float t[NT][4];
    zero(t);
    mma_tile<D, NT, false, false>(t, &s.v[0][0], LD, &s.S[0][0], LD, m0, n0, lane);
    if constexpr (LO) {
      state_remainder(ds_out_lo);
      mma_tile<D, NT, false, false>(t, &s.v[0][0], LD, &s.S[0][0], LD, m0, n0, lane);
    }
    decay_add<NT, LD>(acc, dlw, t, lw2c, &s.k[0][0], m0, n0, g, c2,
                           [](int sj) { return CH - 1 - sj; });
  }
  for (int J = wm + 1; J < NB; ++J) {  // dk~ of sub-chunk wm from each later one
    float t[NT][4];
    zero(t);
    mma_tile<SUB, NT, true, true>(t, &s.dA[SUB * J][0], LC, &s.rt[SUB * J][0], LD, m0, n0,
                                  lane);
    if (LO) {
      mma_tile<SUB, NT, true, true>(t, &s.dAl[SUB * J][0], LC, &s.rt[SUB * J][0], LD, m0, n0,
                                    lane);
      mma_tile<SUB, NT, true, true>(t, &s.dA[SUB * J][0], LC, &s.rtl[SUB * J][0], LD, m0, n0,
                                    lane);
    }
    decay_add<NT, LD>(acc, dlw, t, lw2c, &s.k[0][0], m0, n0, g, c2,
                           [J](int sj) { return SUB * J - 1 - sj; });
  }
  {                                    // the cube's dk inside sub-chunk wm (Horner over j
    // descending: b = sum_{j > s} w^(j-1-s) r_j dA[j,s]), and the bonus
    float b[NT][4];
    zero(b);
#pragma unroll
    for (int t = SUB - 1; t > 0; --t) {
      const int jj = m0 + t;
      float2 rv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) rv[nt] = pair(&s.r[jj][n0 + 8 * nt + c2]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int sj = m0 + g + 8 * h2;
        if ((h2 == 1 && t <= SUB / 2) || jj <= sj) continue;     // rows 8-15: j > 8
        const float d = to_f(s.dA[jj][sj]) + (LO ? to_f(s.dAl[LO ? jj : 0][sj]) : 0.f);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          b[nt][2 * h2] = fmaf(b[nt][2 * h2], wcol[nt].x, rv[nt].x * d);
          b[nt][2 * h2 + 1] = fmaf(b[nt][2 * h2 + 1], wcol[nt].y, rv[nt].y * d);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sj = m0 + g + 8 * (e / 2), x = n0 + 8 * nt + c2 + e % 2;
        acc[nt][e] += b[nt][e] + s.srow[sj] * s.u[x] * to_f(s.r[sj][x]);
      }
  }
  write(dk);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float w = dlw[nt][e];
      w += __shfl_xor_sync(FULL, w, 4);
      w += __shfl_xor_sync(FULL, w, 8);
      w += __shfl_xor_sync(FULL, w, 16);
      if (g == 0) s.red[wm][n0 + 8 * nt + c2 + e] = w;
    }
  __syncthreads();
  if (tid < D) {
    float tot = float(CH) * exp2f(float(CH) * s.lw2[tid]) * s.sdot[tid];
#pragma unroll
    for (int w = 0; w < WM; ++w) tot += s.red[w][tid];
    dlogw_part[pidx + tid] = logw[hi * D + tid] < 0.f ? tot : 0.f;   // the clamp min(logw, 0)
  }
}

template <typename T, int D>
struct FwdSmem {
  static constexpr int CH = Chunk<D>::CH, PD = Pad<T>::V, NB = CH / SUB;
  static constexpr int LD = D + PD, LC = CH + PD;
  static constexpr int KT = SUB * NB * (NB - 1) / 2;
  T r[CH][LD], k[CH][LD], v[CH][LD];
  T S[D][LD];                          // S_in
  T rw[CH][LD];                        // r o w^j, the readout's factor
  T rt[CH][LD];                        // r o w^(j - t0)
  T kt[KT][LD];                        // k o w^(SUB J - 1 - s), s < SUB J, from row 8 J (J - 1)
  T X[CH][LC];                         // A [j][s]
  float wp[SUB][D + 4];                // w^n, n < SUB (rows 4 banks apart)
  float lw2[D];                        // min(logw, 0) log2(e): w^n = exp2(n lw2)
  float u[D], ruk[CH];
};

// One block per (chunk, head, b); 8 warps, each a 16-row by d / WN-column
// tile of y (rows: the chunk's steps) in registers: the readout (r o w^j)
// S_in, then A v, then the bonus.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
wkv_fwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ logw, const float* __restrict__ bonus,
                     const T* __restrict__ s_in, T* __restrict__ y, int L, int H) {
  using S = FwdSmem<T, D>;
  constexpr int CH = S::CH, LD = S::LD, LC = S::LC;
  constexpr int WM = Warps<CH>::WM, WN = Warps<CH>::WN, NT = D / (8 * WN);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, c2 = 2 * (lane % 4);
  const int m0 = 16 * (warp % WM), n0 = (warp / WM) * (D / WN);
  const int nc = (L + CH - 1) / CH, t0 = c * CH, len = min(CH, L - t0);
  const size_t row0 = size_t(bi) * L + t0;
  const long st = long(H) * D, col = long(hi) * D;
  {
    uint4 vr[RowVecs<CH, D, T>::IT], vk[RowVecs<CH, D, T>::IT], vv[RowVecs<CH, D, T>::IT];
    load_rows<CH, D>(vr, r, row0, st, col, len);
    load_rows<CH, D>(vk, k, row0, st, col, len);
    load_rows<CH, D>(vv, v, row0, st, col, len);
    if (tid < D) {
      s.u[tid] = bonus[hi * D + tid];
      s.lw2[tid] = fminf(logw[hi * D + tid], 0.f) * 1.4426950408889634f;
    }
    // the decay table while the tiles are in flight
    for (int i = tid; i < SUB * D; i += THREADS) {
      const int n = i / D, x = i % D;
      s.wp[n][x] = expf(float(n) * fminf(logw[hi * D + x], 0.f));
    }
    {
      uint4 vs[RowVecs<D, D, T>::IT];
      load_rows<D, D>(vs, s_in + ((size_t(bi) * nc + c) * H + hi) * D * D, 0, D, 0, D);
      store_rows<D, D>(&s.S[0][0], LD, vs);
    }
    store_rows<CH, D>(&s.r[0][0], LD, vr);
    store_rows<CH, D>(&s.k[0][0], LD, vk);
    store_rows<CH, D>(&s.v[0][0], LD, vv);
  }
  __syncthreads();
  {                                    // the bonus's row sums (r_j o u) . k_j
    constexpr int TPR = THREADS / CH, SPAN = D / TPR, E = 16 / int(sizeof(T));
    const int j = tid / TPR, x0 = (tid % TPR) * SPAN;
    float sr = 0.f;
#pragma unroll
    for (int x = x0; x < x0 + SPAN; x += E) {
      const uint4 r4 = *reinterpret_cast<const uint4*>(&s.r[j][x]);
      const uint4 k4 = *reinterpret_cast<const uint4*>(&s.k[j][x]);
      const T *re = reinterpret_cast<const T*>(&r4), *ke = reinterpret_cast<const T*>(&k4);
#pragma unroll
      for (int e = 0; e < E; ++e) sr += to_f(re[e]) * s.u[x + e] * to_f(ke[e]);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sr += __shfl_xor_sync(FULL, sr, o);
    if (tid % TPR == 0) s.ruk[j] = sr;
  }
  const auto table = [&](int n, int x) {
    return *reinterpret_cast<const float2*>(&s.wp[n][x]);
  };
  const auto power = [&](int n, int x) {
    const float2 l = *reinterpret_cast<const float2*>(&s.lw2[x]);
    return make_float2(exp2f(float(n) * l.x), exp2f(float(n) * l.y));
  };
  scale_rows<D, LD, LD, THREADS, false>(&s.rw[0][0], static_cast<T*>(nullptr), &s.r[0][0], CH,
                                        [](int q, int& r, int& n) { r = q; n = q; }, power);
  factor_rows<CH, D, LD, false>(s, static_cast<T*>(nullptr), table, power);
  __syncthreads();
  float acc[NT][4];
  zero(acc);
  // the readout: y += (r o w^j) S_in
  mma_tile<D, NT, false, true>(acc, &s.rw[0][0], LD, &s.S[0][0], LD, m0, n0, lane);
  intra_a<CH, D, LD, LC>(s, &s.X[0][0], warp, lane);
  __syncthreads();
  // the pairs s < j: y += A v, and the bonus
  mma_tile<CH, NT, false, true>(acc, &s.X[0][0], LC, &s.v[0][0], LD, m0, n0, lane);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = m0 + g + 8 * h2;
    if (j >= len) continue;
    const size_t o = (row0 + j) * st + col + n0 + c2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 vj = pair(&s.v[j][n0 + 8 * nt + c2]);
      store_pair(y + o + 8 * nt, acc[nt][2 * h2] + s.ruk[j] * vj.x,
                 acc[nt][2 * h2 + 1] + s.ruk[j] * vj.y);
    }
  }
}

template <int D, typename T>
int launch_fwd(const void* r, const void* k, const void* v, const void* logw, const void* bonus,
               void* y, void* s_in, int batch, int L, int H, cudaStream_t st) {
  static std::atomic<uint64_t> done_carry{0}, done{0};
  const int smem_carry = int(sizeof(CarrySmem<T, D, false>));
  const int smem = int(sizeof(FwdSmem<T, D>));
  cudaError_t err = ptt::allow_smem(wkv_fwd_carry_kernel<T, D>, smem_carry, done_carry);
  if (err == cudaSuccess) err = ptt::allow_smem(wkv_fwd_chunk_kernel<T, D>, smem, done);
  if (err != cudaSuccess) return int(err);
  const auto* rr = static_cast<const T*>(r);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* lw = static_cast<const float*>(logw);
  auto* sin = static_cast<T*>(s_in);
  const int nc = (L + Chunk<D>::CH - 1) / Chunk<D>::CH;
  wkv_fwd_carry_kernel<T, D><<<dim3(D / SLICE, batch * H), CARRY_THREADS, smem_carry, st>>>(
      kk, vv, lw, sin, L, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wkv_fwd_chunk_kernel<T, D><<<dim3(nc, H, batch), THREADS, smem, st>>>(
      rr, kk, vv, lw, static_cast<const float*>(bonus), sin, static_cast<T*>(y), L, H);
  return int(cudaGetLastError());
}

struct BwdArgs {
  const void *r, *k, *v, *logw, *bonus, *dy;
  void *dr, *dk, *dv, *dlogw_part, *du_part, *s_in, *ds_out, *s_in_lo, *ds_out_lo;
  int batch, L, H;
  cudaStream_t st;
};

template <int D, typename T>
int launch_bwd(const BwdArgs& a) {
  static std::atomic<uint64_t> done_carry{0}, done{0};
  const int smem_carry = int(sizeof(CarrySmem<T, D, (sizeof(T) == 2)>));
  const int smem = int(sizeof(ChunkSmem<T, D>));
  cudaError_t err = ptt::allow_smem(wkv_bwd_carry_kernel<T, D>, smem_carry, done_carry);
  if (err == cudaSuccess) err = ptt::allow_smem(wkv_bwd_chunk_kernel<T, D>, smem, done);
  if (err != cudaSuccess) return int(err);
  const auto* r = static_cast<const T*>(a.r);
  const auto* k = static_cast<const T*>(a.k);
  const auto* v = static_cast<const T*>(a.v);
  const auto* dy = static_cast<const T*>(a.dy);
  const auto* lw = static_cast<const float*>(a.logw);
  auto* s_in = static_cast<T*>(a.s_in);
  auto* ds_out = static_cast<T*>(a.ds_out);
  auto* s_in_lo = static_cast<T*>(a.s_in_lo);
  auto* ds_out_lo = static_cast<T*>(a.ds_out_lo);
  const int nc = (a.L + Chunk<D>::CH - 1) / Chunk<D>::CH;
  wkv_bwd_carry_kernel<T, D><<<dim3(D / SLICE, a.batch * a.H, 2), CARRY_THREADS, smem_carry,
                               a.st>>>(r, k, v, dy, lw, s_in, ds_out, s_in_lo, ds_out_lo, a.L,
                                       a.H);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wkv_bwd_chunk_kernel<T, D><<<dim3(nc, a.H, a.batch), THREADS, smem, a.st>>>(
      r, k, v, dy, lw, static_cast<const float*>(a.bonus), s_in, ds_out, s_in_lo, ds_out_lo,
      static_cast<T*>(a.dr),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), static_cast<float*>(a.dlogw_part),
      static_cast<float*>(a.du_part), a.L, a.H);
  return int(cudaGetLastError());
}

bool bad_shape(int batch, int L, int H, int D) {
  return batch < 1 || L < 1 || H < 1 || (D != 64 && D != 128) || batch > 65535 || H > 65535
         || size_t(batch) * H > 65535u;
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r, k, v, y [batch, L, H, D], contiguous, f32 (bf16_io = 0) or bf16 (1);
// logw, bonus [H, D] f32; s_in [batch, nc, H, D, D] scratch in the I/O type,
// nc = ceil(L / ptt_wkv_bwd_chunk(D)). D is 64 or 128. Two launches (the
// state at the chunks' edges, then every chunk); returns cudaGetLastError().
int ptt_wkv_fwd(const void* r, const void* k, const void* v, const void* logw, const void* bonus,
                void* y, void* s_in, int batch, int L, int H, int D, int bf16_io,
                void* stream) {
  if (bad_shape(batch, L, H, D)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bf16_io ? launch_fwd<64, bf16>(r, k, v, logw, bonus, y, s_in, batch, L, H, st)
                   : launch_fwd<64, float>(r, k, v, logw, bonus, y, s_in, batch, L, H, st);
  return bf16_io ? launch_fwd<128, bf16>(r, k, v, logw, bonus, y, s_in, batch, L, H, st)
                 : launch_fwd<128, float>(r, k, v, logw, bonus, y, s_in, batch, L, H, st);
}

// The chunk of both directions at head width D: the scratch and the
// partials have ceil(L / chunk) chunks.
int ptt_wkv_bwd_chunk(int D) { return D == 64 ? Chunk<64>::CH : Chunk<128>::CH; }

// The backward of ptt_wkv_fwd for dy [batch, L, H, D] (the inputs' type), two
// launches (the carries, then the chunks): dr, dk, dv [batch, L, H, D] (that
// type); dlogw_part and du_part [batch, nc, H, D] f32, per-chunk partials
// that the caller sums over (batch, nc); scratch s_in and ds_out [batch, nc,
// H, D, D] in the I/O type, nc = ceil(L / ptt_wkv_bwd_chunk(D)), and with
// bf16 I/O s_in_lo and ds_out_lo of the same shape (each state's rounding
// remainder; null with f32 I/O).
int ptt_wkv_bwd(const void* r, const void* k, const void* v, const void* logw, const void* bonus,
                const void* dy, void* dr, void* dk, void* dv, void* dlogw_part, void* du_part,
                void* s_in, void* ds_out, void* s_in_lo, void* ds_out_lo, int batch, int L,
                int H, int D, int bf16_io, void* stream) {
  if (bad_shape(batch, L, H, D) || (bf16_io && (s_in_lo == nullptr || ds_out_lo == nullptr)))
    return int(cudaErrorInvalidValue);
  const BwdArgs a{r, k, v, logw, bonus, dy, dr, dk, dv, dlogw_part, du_part, s_in, ds_out,
                  s_in_lo, ds_out_lo, batch, L, H, static_cast<cudaStream_t>(stream)};
  if (D == 64) return bf16_io ? launch_bwd<64, bf16>(a) : launch_bwd<64, float>(a);
  return bf16_io ? launch_bwd<128, bf16>(a) : launch_bwd<128, float>(a);
}

}  // extern "C"
