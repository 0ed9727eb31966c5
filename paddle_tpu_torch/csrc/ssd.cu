// The Mamba-2 SSD recurrence, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/ssd.py: the forward
// `_fwd_kernel` (pl.pallas_call at :198) and the backward `_bwd_kernel`
// (pl.pallas_call at :243). Per batch row b and head h, with a scalar decay
// a_t = exp(A_h dt_t), the state S [P = dh, N = ds] in f32 and
//   S_t = a_t S_{t-1} + dt_t x_t^T B_t,    y_t = C_t S_t^T + D_h x_t
// in the chunked matrix form of `_chunk_pieces` (:63-81): with cum the
// inclusive cumsum of log a over a chunk of CH steps,
//   L[j,i] = exp(cum_j - cum_i) (i <= j, else 0),  W = (C B^T) o L,
//   y = W (dt x) + exp(cum) o (C S^T) + D x,
//   S <- exp(cum_last) S + (exp(cum_last - cum) o dt x)^T B.
// L is never factored as exp(cum_j) exp(-cum_i): with a strong decay cum
// reaches -1e4 within a chunk, exp(-cum_i) overflows and inf * 0 is NaN.
// Only differences of cum are exponentiated, and only where i <= j. The D
// skip is added in f32 before y's one rounding (the reference's default
// route, paddle_tpu/ops/fused/ssd.py:109); its gradients dx += D dy and
// dD = sum dy x come out of the backward here too.
//
// What bounds it on the H100: at the Mamba-2 path (b8 l1024 h24, P = N =
// 64, bf16) the forward moves ~103 MB (x, y, the 50 MB of chunk states, dt,
// B, C) and does ~4.8 GFLOP of products, the backward ~131 MB and ~14.5
// GFLOP: by the card's peaks (3.35 TB/s, 989 TFLOP/s bf16) both are bound
// by bytes. Both directions run every chunk product on the tensor cores
// (mma.sync, ssm_common.cuh) and are chunk-parallel: the state (forward) or
// its gradient (backward) crosses a chunk as an affine map, so one short
// sequential kernel carries it over the chunks of each (h, b), one [P x
// CH] x [CH x N] product a chunk, and a second kernel runs every (chunk,
// group of heads, b) in parallel from the carried values. The carries pass
// through 50 MB of f32 at the Mamba-2 path: the forward's own residual,
// the backward's scratch. What holds them back is the carry's chain and
// memory, not the products.
//
// Forward: ssd_fwd_carry_kernel writes the state entering every chunk,
// [b, nc, h, P, N] f32 (the Pallas residual), and prefetches the next
// chunk's x, B and dt while the product runs. ssd_fwd_chunk_kernel takes
// C B^T once per chunk (B and C have no head axis) and keeps it in
// registers for the group's FWD_HEADS heads; per head it builds W =
// (C B^T) o L o dt_i, then y = decay o (C S^T) + W x + D x from the saved
// state. The chunk is 64 steps at P = N = 64, 32 at the wider states.
// The backward (described above its kernels) follows `_bwd_kernel`'s chain
// (:138-185), every decay gradient through the transpose of the cumsum, a
// reverse suffix sum over the chunk.

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

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HEADS = 12;              // heads per block of the chunk backward
constexpr int FWD_HEADS = 12;          // heads per block of the chunk forward

template <int P, int N>
struct Chunk {
  static constexpr int CH = (P == 64 && N == 64) ? 64 : 32;
};

// Inclusive scan over CH values by one warp (lane l holds CH / 32
// consecutive ones): out[i] = sum_{k <= i} scale * in[k]; REV scans from the
// end, out[i] = sum_{k >= i} scale * in[k] (the transpose of the cumsum).
template <int CH, bool REV>
__device__ __forceinline__ void warp_scan(const float* in, float scale, float* out, int lane) {
  constexpr int E = CH / 32;
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = REV ? CH - 1 - (lane * E + e) : lane * E + e;
    run += scale * in[i];
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  const float excl = incl - run;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = REV ? CH - 1 - (lane * E + e) : lane * E + e;
    out[i] = excl + v[e];
  }
}

// ------------------------------------------------------------------- carries
// The carry over the chunks of one (h, b), one [P x CH] x [CH x N] product a
// chunk. FWD walks the chunks forward: S <- exp(cum_last) S + (tail o dt o
// x)^T B, tail = exp(cum_last - cum), writing the state entering each chunk.
// The backward walks them in reverse: dS <- exp(cum_last) dS + (decay o
// dy)^T C, decay = exp(cum), writing the dS_out each chunk starts from.
// `src` is x or dy (P columns of head h), `mat` B or C.
template <typename T, int P, int N>
struct CarrySmem {
  static constexpr int CH = Chunk<P, N>::CH, PD = Pad<T>::V;
  T src[CH][P + PD];                   // scale o src
  T mat[CH][N + PD];
  float dt[CH], cum[CH], scale[CH];
};

template <bool FWD, typename T, int P, int N>
__device__ __forceinline__ void carry_chain(const T* __restrict__ dt,
                                            const float* __restrict__ A,
                                            const T* __restrict__ mat, const T* __restrict__ src,
                                            float* __restrict__ out, int L, int H, long sdt,
                                            long smat, long ssrc) {
  using S = CarrySmem<T, P, N>;
  constexpr int CH = S::CH, PD = S::PD;
  constexpr int MT = P / 64, NT = N / 16;   // a warp: P / 4 rows, N / 2 columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, c2 = 2 * (lane % 4);
  const int m0 = (warp % 4) * (P / 4), n0 = (warp / 4) * (N / 2);
  const int nc = (L + CH - 1) / CH;
  const float a = A[hi];
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(acc[mt]);
  // the next chunk's dt, src and mat, loaded while this one is computed
  uint4 vs[RowVecs<CH, P, T>::IT], vm[RowVecs<CH, N, T>::IT];
  float vdt;
  auto fetch = [&](int c) {
    const int t0 = c * CH, len = min(CH, L - t0);
    const size_t row0 = size_t(bi) * L + t0;
    vdt = tid < len ? to_f(dt[(row0 + tid) * sdt + hi]) : 0.f;
    load_rows<CH, P>(vs, src, row0, ssrc, long(hi) * P, len);
    load_rows<CH, N>(vm, mat, row0, smat, 0, len);
  };
  fetch(FWD ? 0 : nc - 1);
  for (int step = 0; step < nc; ++step) {
    const int c = FWD ? step : nc - 1 - step;
    // the carry this chunk starts from
    float* dst = out + ((size_t(bi) * nc + c) * H + hi) * P * N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int p = m0 + 16 * mt + g + 4 * e, n = n0 + 8 * nt + c2;
          *reinterpret_cast<float2*>(dst + p * N + n) =
              make_float2(acc[mt][nt][e], acc[mt][nt][e + 1]);
        }
    __syncthreads();                   // the previous chunk is done with the tiles
    if (tid < CH) s.dt[tid] = vdt;
    store_rows<CH, P>(&s.src[0][0], P + PD, vs);
    store_rows<CH, N>(&s.mat[0][0], N + PD, vm);
    if (step + 1 < nc) fetch(FWD ? c + 1 : c - 1);
    __syncthreads();
    if (warp == 0) {
      warp_scan<CH, false>(s.dt, a, s.cum, lane);
      __syncwarp();
      const float last = s.cum[CH - 1];
      for (int i = lane; i < CH; i += 32)
        s.scale[i] = FWD ? expf(last - s.cum[i]) * s.dt[i] : expf(s.cum[i]);
    }
    __syncthreads();
    for (int i = tid; i < CH * P; i += THREADS) {
      const int t = i / P;
      s.src[t][i % P] = from_f<T>(s.scale[t] * to_f(s.src[t][i % P]));
    }
    __syncthreads();
    const float wce = expf(s.cum[CH - 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= wce;
      mma_tile<CH, NT, true, true>(acc[mt], &s.src[0][0], P + PD, &s.mat[0][0], N + PD,
                                   m0 + 16 * mt, n0, lane);
    }
  }
}

// the states entering every chunk, [b, nc, h, P, N] f32
template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_carry_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     float* __restrict__ states, int L, int H, long sx, long sdt, long sb) {
  carry_chain<true, T, P, N>(dt, A, Bm, x, states, L, H, sdt, sb, sx);
}

// ------------------------------------------------------------------ forward
// One block per (chunk, group of FWD_HEADS heads, b). C B^T is taken once
// and kept in registers in the warps' layout; per head the block stages x,
// dt and the saved state, scans dt into cum, writes W = (C B^T) o L o dt_i
// to shared memory and runs y = decay o (C S^T) + W x on mma.sync, then adds
// D x in f32 and rounds once.
template <typename T, int P, int N>
struct FwdSmem {
  static constexpr int CH = Chunk<P, N>::CH, PD = Pad<T>::V;
  T x[CH][P + PD], B[CH][N + PD], C[CH][N + PD];
  T S[P][N + PD];                      // the state entering the chunk
  T W[CH][CH + PD];
  float dt[CH], cum[CH], decay[CH];
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ Dv,
                     const float* __restrict__ states, T* __restrict__ y, int L, int H, long sx,
                     long sdt, long sb, long sc) {
  using S = FwdSmem<T, P, N>;
  constexpr int CH = S::CH, PD = S::PD;
  constexpr int WM = Warps<CH>::WM, WN = Warps<CH>::WN;
  constexpr int NTP = P / (8 * WN), NTC = CH / (8 * WN);
  constexpr int LP = P + PD, LN = N + PD, LC = CH + PD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int c = blockIdx.x, grp = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, c2 = 2 * (lane % 4);
  const int wm = warp % WM, wn = warp / WM, m0 = 16 * wm;
  const int nc = (L + CH - 1) / CH, t0 = c * CH, len = min(CH, L - t0);
  const size_t row0 = size_t(bi) * L + t0;
  {
    uint4 vb[RowVecs<CH, N, T>::IT], vc[RowVecs<CH, N, T>::IT];
    load_rows<CH, N>(vb, Bm, row0, sb, 0, len);
    load_rows<CH, N>(vc, Cm, row0, sc, 0, len);
    store_rows<CH, N>(&s.B[0][0], LN, vb);
    store_rows<CH, N>(&s.C[0][0], LN, vc);
  }
  __syncthreads();
  const int nw = wn * (CH / WN), np = wn * (P / WN);
  float cb[NTC][4];                    // C B^T, shared by the group's heads
  zero(cb);
  mma_tile<N, NTC, false, false>(cb, &s.C[0][0], LN, &s.B[0][0], LN, m0, nw, lane);
  const int h_end = min(H, (grp + 1) * FWD_HEADS);
  for (int hi = grp * FWD_HEADS; hi < h_end; ++hi) {
    const float a = A[hi], dskip = Dv[hi];
    const float* st = states + ((size_t(bi) * nc + c) * H + hi) * P * N;
    constexpr int IS = P * N / 4 / THREADS, RS = 4;
    uint4 vx[RowVecs<CH, P, T>::IT];
    load_rows<CH, P>(vx, x, row0, sx, long(hi) * P, len);
    const float vdt = tid < len ? to_f(dt[(row0 + tid) * sdt + hi]) : 0.f;
    __syncthreads();                   // the previous head is done with the tiles
#pragma unroll
    for (int r0 = 0; r0 < IS; r0 += RS) {
      float4 v4[RS];
#pragma unroll
      for (int j = 0; j < RS; ++j) v4[j] = reinterpret_cast<const float4*>(st)[(r0 + j) * THREADS + tid];
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int i = 4 * ((r0 + j) * THREADS + tid);
        store4(&s.S[i / N][i % N], v4[j]);
      }
    }
    store_rows<CH, P>(&s.x[0][0], LP, vx);
    if (tid < CH) s.dt[tid] = vdt;
    __syncthreads();
    if (warp == 0) {
      warp_scan<CH, false>(s.dt, a, s.cum, lane);
      __syncwarp();
      for (int i = lane; i < CH; i += 32) s.decay[i] = expf(s.cum[i]);
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = m0 + g + 8 * (e / 2), i = nw + 8 * nt + c2 + e % 2;
        s.W[j][i] = from_f<T>(i <= j ? cb[nt][e] * expf(s.cum[j] - s.cum[i]) * s.dt[i] : 0.f);
      }
    __syncthreads();
    float acc[NTP][4];
    zero(acc);
    mma_tile<N, NTP, false, false>(acc, &s.C[0][0], LN, &s.S[0][0], LN, m0, np, lane);
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= s.decay[m0 + g + 8 * (e / 2)];
    mma_tile<CH, NTP, false, true>(acc, &s.W[0][0], LC, &s.x[0][0], LP, m0, np, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = m0 + g + 8 * r;
      if (j >= len) continue;
      T* out = y + ((row0 + j) * H + hi) * P + np + c2;
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        const int p = np + 8 * nt + c2;
        store_pair(out + 8 * nt, acc[nt][2 * r] + dskip * to_f(s.x[j][p]),
                   acc[nt][2 * r + 1] + dskip * to_f(s.x[j][p + 1]));
      }
    }
  }
}

// ------------------------------------------------------------------ backward
// The gradient dS of the state crosses a chunk as an affine map, dS_in =
// exp(cum_last) dS_out + (decay o dy)^T C, and the forward saved the state
// entering every chunk, so the backward is two launches:
//   1. ssd_bwd_carry_kernel, one block per (h, b): the chunks in reverse,
//      each writing the dS_out it starts from ([b, nc, h, P, N] f32 scratch)
//      and taking one [P x CH] x [CH x N] product into it;
//   2. ssd_bwd_kernel, one block per (chunk, group of HEADS heads, b), all
//      in parallel: each head's chunk backward from its saved state and its
//      dS_out, with dB and dC (B and C have no head axis) summed over the
//      group's heads in registers and written as [ceil(h / HEADS), b, l, N]
//      f32 partials; dA and dD as [b nc, h] partials. The caller sums them
//      in a fixed order: no atomics, the same result on every run.
// x, dy, B and C are exact in either I/O type; the f32 intermediates that
// feed a product (the state, dS, W = C B^T o L, dCB, decay o dy) round to
// bf16 in the bf16 instantiation, each output once more to bf16.
// What holds it back is memory, not the products: per head and chunk it
// loads x, dy (8 KB each in bf16) and the f32 state and dS (16 KB each), and
// the carries pass through 50 MB of scratch at the Mamba-2 path. Both
// kernels hold at most 128 registers so that two blocks share an SM.

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_carry_kernel(const T* __restrict__ dt, const float* __restrict__ A,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ carry_out, int L, int H, long sdt, long sc, long sdy) {
  carry_chain<false, T, P, N>(dt, A, Cm, dy, carry_out, L, H, sdt, sc, sdy);
}

template <typename T, int P, int N>
struct BwdSmem {
  static constexpr int CH = Chunk<P, N>::CH, PD = Pad<T>::V;
  T x[CH][P + PD], dy[CH][P + PD], B[CH][N + PD], C[CH][N + PD];
  T S[P][N + PD], dS[P][N + PD];       // the state entering the chunk, dL/dS at its end
  T W[CH][CH + PD], dCB[CH][CH + PD];
  float dt[CH], cum[CH], decay[CH], tail[CH], dcum[CH], dloga[CH], dtail[CH], rowx[CH];
  float cumdt[CH];                     // inclusive prefix sums of dt: d cum / dA
  float dstate[CH];                    // dstate_t: the decay and tail terms' dA
  float part[5][4][CH];                // per-warp-column (or -row) partial sums
  float red[2][WARPS];                 // per-warp sums of S o dS and x o dy
  float pair[WARPS];                   // per-warp sums of dL o L (cumdt_j - cumdt_i)
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ states, const float* __restrict__ carry,
               const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ ddt,
               float* __restrict__ dA_part, float* __restrict__ dD_part,
               float* __restrict__ dB_part, float* __restrict__ dC_part, int batch, int L, int H,
               long sx, long sdt, long sb, long sc, long sdy) {
  using S = BwdSmem<T, P, N>;
  constexpr int CH = S::CH, PD = S::PD;
  constexpr int WM = Warps<CH>::WM, WN = Warps<CH>::WN;
  constexpr int NTP = P / (8 * WN), NTN = N / (8 * WN), NTC = CH / (8 * WN);
  constexpr int LP = P + PD, LN = N + PD, LC = CH + PD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int c = blockIdx.x, grp = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, c2 = 2 * (lane % 4);
  const int wm = warp % WM, wn = warp / WM, m0 = 16 * wm;
  const int nc = (L + CH - 1) / CH, t0 = c * CH, len = min(CH, L - t0);
  const size_t row0 = size_t(bi) * L + t0;
  {
    uint4 vb[RowVecs<CH, N, T>::IT], vc[RowVecs<CH, N, T>::IT];
    load_rows<CH, N>(vb, Bm, row0, sb, 0, len);
    load_rows<CH, N>(vc, Cm, row0, sc, 0, len);
    store_rows<CH, N>(&s.B[0][0], LN, vb);
    store_rows<CH, N>(&s.C[0][0], LN, vc);
  }
  float dBacc[NTN][4], dCacc[NTN][4];  // dB and dC summed over the group's heads
  zero(dBacc);
  zero(dCacc);
  const int h_end = min(H, (grp + 1) * HEADS);
  for (int hi = grp * HEADS; hi < h_end; ++hi) {
    const float a = A[hi], dskip = Dv[hi];
    const size_t sidx = ((size_t(bi) * nc + c) * H + hi) * P * N;
    // this head's loads, all in flight at once (the state and its gradient
    // in rounds of 4 float4 a thread)
    constexpr int IS = P * N / 4 / THREADS, RS = 4;
    uint4 vx[RowVecs<CH, P, T>::IT], vdy[RowVecs<CH, P, T>::IT];
    load_rows<CH, P>(vx, x, row0, sx, long(hi) * P, len);
    load_rows<CH, P>(vdy, dy, row0, sdy, long(hi) * P, len);
    const float vdt = tid < len ? to_f(dt[(row0 + tid) * sdt + hi]) : 0.f;
    __syncthreads();                   // the previous head is done with the tiles
    float dwce = 0.f, xdy = 0.f;       // sums of S o dS and of x o dy
#pragma unroll
    for (int r0 = 0; r0 < IS; r0 += RS) {
      float4 vs[RS], vd[RS];
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int idx = (r0 + j) * THREADS + tid;
        vs[j] = reinterpret_cast<const float4*>(states + sidx)[idx];
        vd[j] = reinterpret_cast<const float4*>(carry + sidx)[idx];
      }
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int i = 4 * ((r0 + j) * THREADS + tid), r = i / N, col = i % N;
        dwce += vs[j].x * vd[j].x + vs[j].y * vd[j].y + vs[j].z * vd[j].z + vs[j].w * vd[j].w;
        T* ds = &s.S[r][col];
        T* dd = &s.dS[r][col];
        ds[0] = from_f<T>(vs[j].x); ds[1] = from_f<T>(vs[j].y);
        ds[2] = from_f<T>(vs[j].z); ds[3] = from_f<T>(vs[j].w);
        dd[0] = from_f<T>(vd[j].x); dd[1] = from_f<T>(vd[j].y);
        dd[2] = from_f<T>(vd[j].z); dd[3] = from_f<T>(vd[j].w);
      }
    }
#pragma unroll
    for (int it = 0; it < RowVecs<CH, P, T>::IT; ++it) xdy += dot16<T>(vx[it], vdy[it]);
    store_rows<CH, P>(&s.x[0][0], LP, vx);
    store_rows<CH, P>(&s.dy[0][0], LP, vdy);
    if (tid < CH) s.dt[tid] = vdt;
    xdy = warp_sum(xdy);
    dwce = warp_sum(dwce);
    if (lane == 0) {
      s.red[0][warp] = dwce;
      s.red[1][warp] = xdy;
    }
    __syncthreads();
    if (warp == 0) warp_scan<CH, false>(s.dt, a, s.cum, lane);
    if (warp == 1) warp_scan<CH, false>(s.dt, 1.f, s.cumdt, lane);
    __syncthreads();
    const float last = s.cum[CH - 1], wce = expf(last);
    if (tid < CH) {
      s.decay[tid] = expf(s.cum[tid]);
      s.tail[tid] = expf(last - s.cum[tid]);
    }
    // --- W = (C B^T) o L and dCB = (dy x^T o dt_i) o L, with dL o L summed
    // over rows (part 0) and columns (part 1), and each pair's share of dA,
    // dL o L times d(cum_j - cum_i) / dA = cumdt_j - cumdt_i (pair): summed
    // pair by pair, not as the rows' and columns' sums weighted by cumdt,
    // which cancel to a small dA and leave it their rounding
    {
      float cb[NTC][4], dw[NTC][4];
      zero(cb);
      zero(dw);
      const int n0 = wn * (CH / WN);
      mma_tile<N, NTC, false, false>(cb, &s.C[0][0], LN, &s.B[0][0], LN, m0, n0, lane);
      mma_tile<P, NTC, false, false>(dw, &s.dy[0][0], LP, &s.x[0][0], LP, m0, n0, lane);
      float rsum[2] = {0.f, 0.f}, csum[NTC][2], pair = 0.f;
#pragma unroll
      for (int nt = 0; nt < NTC; ++nt) {
        csum[nt][0] = csum[nt][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = m0 + g + 8 * (e / 2), i = n0 + 8 * nt + c2 + e % 2;
          float w = 0.f, dcb = 0.f, dll = 0.f;
          if (i <= j) {
            const float Lv = expf(s.cum[j] - s.cum[i]);
            w = cb[nt][e] * Lv;
            dcb = dw[nt][e] * s.dt[i] * Lv;
            dll = dcb * cb[nt][e];
          }
          s.W[j][i] = from_f<T>(w);
          s.dCB[j][i] = from_f<T>(dcb);
          rsum[e / 2] += dll;
          csum[nt][e % 2] += dll;
          pair += dll * (s.cumdt[j] - s.cumdt[i]);
        }
      }
      pair = warp_sum(pair);
      if (lane == 0) s.pair[warp] = pair;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(FULL, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(FULL, rsum[r], 2);
      }
      if (lane % 4 == 0) {
        s.part[0][wn][m0 + g] = rsum[0];
        s.part[0][wn][m0 + g + 8] = rsum[1];
      }
#pragma unroll
      for (int nt = 0; nt < NTC; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = csum[nt][e];
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          if (g == 0) s.part[1][wm][n0 + 8 * nt + c2 + e] = v;
        }
    }
    __syncthreads();                   // W, dCB, decay, tail are in place
    const int np = wn * (P / WN), nn = wn * (N / WN);
    // --- y = ... + decay o (C S^T): dDecay summed over columns (part 2)
    {
      float cs[NTP][4];
      zero(cs);
      mma_tile<N, NTP, false, false>(cs, &s.C[0][0], LN, &s.S[0][0], LN, m0, np, lane);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rsum[e / 2] += cs[nt][e] * to_f(s.dy[m0 + g + 8 * (e / 2)][np + 8 * nt + c2 + e % 2]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(FULL, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(FULL, rsum[r], 2);
      }
      if (lane % 4 == 0) {
        s.part[2][wn][m0 + g] = rsum[0];
        s.part[2][wn][m0 + g + 8] = rsum[1];
      }
    }
    // --- dC += decay o (dy S) + dCB B
    {
      float t[NTN][4];
      zero(t);
      mma_tile<P, NTN, false, true>(t, &s.dy[0][0], LP, &s.S[0][0], LN, m0, nn, lane);
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dCacc[nt][e] += s.decay[m0 + g + 8 * (e / 2)] * t[nt][e];
      mma_tile<CH, NTN, false, true>(dCacc, &s.dCB[0][0], LC, &s.B[0][0], LN, m0, nn, lane);
    }
    // --- dB += (tail dt) o (x dS) + dCB^T C
    {
      float t[NTN][4];
      zero(t);
      mma_tile<P, NTN, false, true>(t, &s.x[0][0], LP, &s.dS[0][0], LN, m0, nn, lane);
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + g + 8 * (e / 2);
          dBacc[nt][e] += s.tail[i] * s.dt[i] * t[nt][e];
        }
      mma_tile<CH, NTN, true, true>(dBacc, &s.dCB[0][0], LC, &s.C[0][0], LN, m0, nn, lane);
    }
    // --- ddx = tail o (B dS^T) + W^T dy: dtail (part 3), sum_p ddx x (part
    // 4), dx = dt ddx + D dy
    {
      float ddx[NTP][4];
      zero(ddx);
      mma_tile<N, NTP, false, false>(ddx, &s.B[0][0], LN, &s.dS[0][0], LN, m0, np, lane);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + g + 8 * (e / 2);
          rsum[e / 2] += ddx[nt][e] * to_f(s.x[i][np + 8 * nt + c2 + e % 2]);
          ddx[nt][e] *= s.tail[i];
        }
      mma_tile<CH, NTP, true, true>(ddx, &s.W[0][0], LC, &s.dy[0][0], LP, m0, np, lane);
      float xsum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + g + 8 * (e / 2);
          xsum[e / 2] += ddx[nt][e] * to_f(s.x[i][np + 8 * nt + c2 + e % 2]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          rsum[r] += __shfl_xor_sync(FULL, rsum[r], o);
          xsum[r] += __shfl_xor_sync(FULL, xsum[r], o);
        }
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = m0 + g + 8 * r;
          s.part[3][wn][i] = rsum[r] * s.dt[i];
          s.part[4][wn][i] = xsum[r];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = m0 + g + 8 * r;
        if (i >= len) continue;
        const float dti = s.dt[i];
        T* out = dx + ((row0 + i) * H + hi) * P + np + c2;
#pragma unroll
        for (int nt = 0; nt < NTP; ++nt) {
          const int p = np + 8 * nt + c2;
          out[8 * nt] = from_f<T>(dti * ddx[nt][2 * r] + dskip * to_f(s.dy[i][p]));
          out[8 * nt + 1] = from_f<T>(dti * ddx[nt][2 * r + 1] + dskip * to_f(s.dy[i][p + 1]));
        }
      }
    }
    __syncthreads();
    if (tid < CH) {                    // dcum from L's rows and columns
      float rows = 0.f, cols = 0.f, dDecay = 0.f, dtail = 0.f, rowx = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        rows += s.part[0][w][tid];
        dDecay += s.part[2][w][tid];
        dtail += s.part[3][w][tid];
        rowx += s.part[4][w][tid];
      }
#pragma unroll
      for (int w = 0; w < WM; ++w) cols += s.part[1][w][tid];
      s.dcum[tid] = rows - cols + dDecay * s.decay[tid] - dtail * s.tail[tid];
      // cum_t reaches y through decay_t (d / dA = cumdt_t) and S_out
      // through tail_t (cumdt_last - cumdt_t): each term with its own weight
      s.dstate[tid] = dDecay * s.decay[tid] * s.cumdt[tid]
                      + dtail * s.tail[tid] * (s.cumdt[CH - 1] - s.cumdt[tid]);
      s.dtail[tid] = dtail;
      s.rowx[tid] = rowx;
    }
    __syncthreads();
    if (warp == 0) {
      // cum_last also reaches every tail and the state's decay wce
      float part = 0.f;
      for (int i = lane; i < CH; i += 32) part += s.dtail[i] * s.tail[i];
      part = warp_sum(part);
      float dwce = 0.f, dD = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        dwce += s.red[0][w];
        dD += s.red[1][w];
      }
      if (lane == 0) s.dcum[CH - 1] += part + dwce * wce;
      __syncwarp();
      warp_scan<CH, true>(s.dcum, 1.f, s.dloga, lane);
      __syncwarp();
      // dA = sum_i dloga_i dt_i = sum_t dcum_t cumdt_t, summed by where
      // cum reaches the loss (pairs, decay and tail terms, the state's
      // decay wce) so that no two large sums cancel, in double
      double dA = 0.0;
      for (int i = lane; i < CH; i += 32) {
        dA += s.dstate[i];
        if (i < len) ddt[(row0 + i) * H + hi] = from_f<T>(a * s.dloga[i] + s.rowx[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dA += __shfl_xor_sync(FULL, dA, o);
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) dA += s.pair[w];
        dA += double(dwce) * wce * s.cumdt[CH - 1];
        dA_part[(size_t(bi) * nc + c) * H + hi] = float(dA);
        dD_part[(size_t(bi) * nc + c) * H + hi] = dD;
      }
    }
  }
  const int nn = wn * (N / WN);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = m0 + g + 8 * r;
    if (i >= len) continue;
    const size_t off = ((size_t(grp) * batch + bi) * L + t0 + i) * N + nn + c2;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      *reinterpret_cast<float2*>(dB_part + off + 8 * nt) =
          make_float2(dBacc[nt][2 * r], dBacc[nt][2 * r + 1]);
      *reinterpret_cast<float2*>(dC_part + off + 8 * nt) =
          make_float2(dCacc[nt][2 * r], dCacc[nt][2 * r + 1]);
    }
  }
}

struct Args {
  const void *x, *dt, *A, *B, *C, *D, *states, *dy;
  void *y, *out_states, *dx, *ddt, *dA, *dD, *dB, *dC, *carry;
  int batch, L, H;
  long sx, sdt, sb, sc, sdy;
  cudaStream_t st;
};

template <typename T, int P, int N>
int launch_fwd(const Args& g) {
  static std::atomic<uint64_t> done_carry{0}, done{0};
  const int smem_carry = int(sizeof(CarrySmem<T, P, N>)), smem = int(sizeof(FwdSmem<T, P, N>));
  cudaError_t err = ptt::allow_smem(ssd_fwd_carry_kernel<T, P, N>, smem_carry, done_carry);
  if (err == cudaSuccess) err = ptt::allow_smem(ssd_fwd_chunk_kernel<T, P, N>, smem, done);
  if (err != cudaSuccess) return int(err);
  const int nc = (g.L + Chunk<P, N>::CH - 1) / Chunk<P, N>::CH;
  ssd_fwd_carry_kernel<T, P, N><<<dim3(g.H, g.batch), THREADS, smem_carry, g.st>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.dt), static_cast<const float*>(g.A),
      static_cast<const T*>(g.B), static_cast<float*>(g.out_states), g.L, g.H, g.sx, g.sdt, g.sb);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_fwd_chunk_kernel<T, P, N>
      <<<dim3(nc, (g.H + FWD_HEADS - 1) / FWD_HEADS, g.batch), THREADS, smem, g.st>>>(
          static_cast<const T*>(g.x), static_cast<const T*>(g.dt), static_cast<const float*>(g.A),
          static_cast<const T*>(g.B), static_cast<const T*>(g.C), static_cast<const float*>(g.D),
          static_cast<const float*>(g.out_states), static_cast<T*>(g.y), g.L, g.H, g.sx, g.sdt,
          g.sb, g.sc);
  return int(cudaGetLastError());
}

template <typename T, int P, int N>
int launch_bwd(const Args& g) {
  static std::atomic<uint64_t> done_carry{0}, done{0};
  const int smem_carry = int(sizeof(CarrySmem<T, P, N>)), smem = int(sizeof(BwdSmem<T, P, N>));
  cudaError_t err = ptt::allow_smem(ssd_bwd_carry_kernel<T, P, N>, smem_carry, done_carry);
  if (err == cudaSuccess) err = ptt::allow_smem(ssd_bwd_kernel<T, P, N>, smem, done);
  if (err != cudaSuccess) return int(err);
  const int nc = (g.L + Chunk<P, N>::CH - 1) / Chunk<P, N>::CH;
  ssd_bwd_carry_kernel<T, P, N><<<dim3(g.H, g.batch), THREADS, smem_carry, g.st>>>(
      static_cast<const T*>(g.dt), static_cast<const float*>(g.A), static_cast<const T*>(g.C),
      static_cast<const T*>(g.dy), static_cast<float*>(g.carry), g.L, g.H, g.sdt, g.sc, g.sdy);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_bwd_kernel<T, P, N><<<dim3(nc, (g.H + HEADS - 1) / HEADS, g.batch), THREADS, smem, g.st>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.dt), static_cast<const float*>(g.A),
      static_cast<const T*>(g.B), static_cast<const T*>(g.C), static_cast<const float*>(g.D),
      static_cast<const float*>(g.states), static_cast<const float*>(g.carry),
      static_cast<const T*>(g.dy), static_cast<T*>(g.dx), static_cast<T*>(g.ddt),
      static_cast<float*>(g.dA), static_cast<float*>(g.dD), static_cast<float*>(g.dB),
      static_cast<float*>(g.dC), g.batch, g.L, g.H, g.sx, g.sdt, g.sb, g.sc, g.sdy);
  return int(cudaGetLastError());
}

// one instantiation per (I/O type, P, N)
template <bool BWD>
int dispatch(const Args& g, int P, int N, int bf16_io) {
#define PTT_SSD_CASE(T, PP, NN)                                              \
  if (P == PP && N == NN) return BWD ? launch_bwd<T, PP, NN>(g) : launch_fwd<T, PP, NN>(g);
  if (bf16_io) {
    PTT_SSD_CASE(bf16, 64, 64)
    PTT_SSD_CASE(bf16, 64, 128)
    PTT_SSD_CASE(bf16, 128, 64)
    PTT_SSD_CASE(bf16, 128, 128)
  } else {
    PTT_SSD_CASE(float, 64, 64)
    PTT_SSD_CASE(float, 64, 128)
    PTT_SSD_CASE(float, 128, 64)
    PTT_SSD_CASE(float, 128, 128)
  }
#undef PTT_SSD_CASE
  return int(cudaErrorInvalidValue);
}

bool bad_shape(int batch, int L, int H) {
  return batch < 1 || batch > 65535 || L < 1 || H < 1 || H > 65535;
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [batch, L, H, P] (token stride sx, elements), dt [batch, L, H] (sdt), B,
// C [batch, L, N] (sb, sc): the token (b, t) starts at (b L + t) * stride;
// x, B and C rows 16-byte aligned. All in f32 (bf16_io = 0) or bf16 (1); A,
// D [H] f32. Two launches (the states over the chunks, then the chunks).
// Writes y [batch, L, H, P] contiguous (the I/O type) and the f32 state
// entering each chunk, states [batch, ceil(L / CH), H, P, N] (CH = 64 at P =
// N = 64, else 32). Needs P, N in {64, 128}. Returns cudaGetLastError()
// after the launches.
int ptt_ssd_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                const void* D, void* y, void* states, int batch, int L, int H, int P, int N,
                int sx, int sdt, int sb, int sc, int bf16_io, void* stream) {
  if (bad_shape(batch, L, H)) return int(cudaErrorInvalidValue);
  Args g{};
  g.x = x; g.dt = dt; g.A = A; g.B = B; g.C = C; g.D = D;
  g.y = y; g.out_states = states;
  g.batch = batch; g.L = L; g.H = H;
  g.sx = sx; g.sdt = sdt; g.sb = sb; g.sc = sc;
  g.st = static_cast<cudaStream_t>(stream);
  return dispatch<false>(g, P, N, bf16_io);
}

// The heads summed into one slice of the backward's dB and dC partials.
int ptt_ssd_bwd_heads_per_block() { return HEADS; }

// The backward of ptt_ssd_fwd from its states and dy [batch, L, H, P] (token
// stride sdy); two launches (the carries of dS, the chunks' backward).
// Writes dx [batch, L, H, P] and ddt [batch, L, H] contiguous (the I/O type)
// and f32 partials that the caller sums over their first axis: dA and dD
// [batch nc, H], dB and dC [ceil(H / ptt_ssd_bwd_heads_per_block()), batch,
// L, N]. Scratch: carry, f32 and shaped as the states.
int ptt_ssd_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                const void* D, const void* states, const void* dy, void* dx, void* ddt,
                void* dA_part, void* dD_part, void* dB_part, void* dC_part, void* carry,
                int batch, int L, int H, int P, int N, int sx, int sdt, int sb, int sc, int sdy,
                int bf16_io, void* stream) {
  if (bad_shape(batch, L, H)) return int(cudaErrorInvalidValue);
  Args g{};
  g.x = x; g.dt = dt; g.A = A; g.B = B; g.C = C; g.D = D; g.states = states; g.dy = dy;
  g.dx = dx; g.ddt = ddt; g.dA = dA_part; g.dD = dD_part; g.dB = dB_part; g.dC = dC_part;
  g.carry = carry;
  g.batch = batch; g.L = L; g.H = H;
  g.sx = sx; g.sdt = sdt; g.sb = sb; g.sc = sc; g.sdy = sdy;
  g.st = static_cast<cudaStream_t>(stream);
  return dispatch<true>(g, P, N, bf16_io);
}

}  // extern "C"
