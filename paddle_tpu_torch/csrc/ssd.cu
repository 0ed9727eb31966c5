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
// by bytes. These kernels do their products as f32 FMAs on the CUDA cores
// (67 TFLOP/s), so the operations bound them here; tensor cores (mma.sync /
// wgmma on bf16 or TF32 tiles) are the next step.
//
// Design (simple first): one block of 256 threads per (b, h) walks its
// chunks in order (the backward in reverse), so no state crosses blocks.
// A chunk's x, B, C (and dy) are staged in shared memory as f32, rows
// padded to an odd length so that every product below reads without bank
// conflicts; the block runs each product as a 16 x 16 grid of threads,
// each owning a (rows / 16) x (cols / 16) register tile, rows ty + 16 r and
// columns tx + 16 q. The chunk is 64 steps at P = N = 64 (83 KB of shared
// memory forward, 135 KB backward) and 32 at the wider states (up to 207 KB
// backward: the tiles, S_in and dS at 128 x 128).
// The forward writes the state entering each chunk, [b, nc, h, P, N] f32
// (the Pallas residual), keeps its own tile of S in registers and the
// whole S in shared memory for the read-out C S^T.
// The backward replays each chunk from that state, carries dS in f32
// (registers and shared memory) and follows `_bwd_kernel`'s chain
// (:138-185): every decay gradient goes through the transpose of the
// cumsum, a reverse suffix sum over the chunk. dB and dC (B and C have no
// head axis) are written as per-head f32 partials [h, b, l, N], dA and dD
// as [b, h] partials; the caller sums them in a fixed order: no atomics,
// the result is the same on every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TG = 16;                 // a product's threads: a TG x TG grid
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

template <int P, int N>
struct Chunk {
  static constexpr int CH = (P == 64 && N == 64) ? 64 : 32;
};

// acc[r][q] += sum_k X(m, k) Y(k, n) (times ks[k] when given), m = ty + TG r,
// n = tx + TG q. X is stored [m][k] (XT: [k][m]) with row length ldx, Y
// [k][n] (YT: [n][k]) with row length ldy. With odd row lengths, the X reads
// of a warp (two m) and the Y reads (16 consecutive n) hit distinct banks.
template <int RM, int RN, int K, bool XT, bool YT>
__device__ __forceinline__ void tile_mm(float (&acc)[RM][RN], const float* __restrict__ X, int ldx,
                                        const float* __restrict__ Y, int ldy, int ty, int tx,
                                        const float* __restrict__ ks = nullptr) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xv[RM], yv[RN];
    const float s = ks ? ks[k] : 1.f;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = ty + TG * r;
      xv[r] = (XT ? X[k * ldx + m] : X[m * ldx + k]) * s;
    }
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int n = tx + TG * q;
      yv[q] = YT ? Y[n * ldy + k] : Y[k * ldy + n];
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(xv[r], yv[q], acc[r][q]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = 0.f;
}

// the sum over the 16 threads of one row group (tx = 0..15, one half-warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

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

// rows [t0, t0 + CH) of one head's [W] values (token stride `stride`, the
// head's first column `col0`) into dst[CH][W + 1] as f32, zero past `len`
// (the loads of a thread are all in flight together)
template <int CH, int W, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, size_t row0,
                                      long stride, int col0, int len) {
  constexpr int IT = CH * W / THREADS;
  float v[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * THREADS + threadIdx.x, t = i / W, p = i % W;
    v[it] = t < len ? to_f(src[(row0 + t) * stride + col0 + p]) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * THREADS + threadIdx.x;
    dst[(i / W) * (W + 1) + i % W] = v[it];
  }
}

template <int P, int N>
struct FwdSmem {
  static constexpr int CH = Chunk<P, N>::CH;
  float x[CH][P + 1], B[CH][N + 1], C[CH][N + 1];
  float W[CH][CH + 1];                 // (C B^T) o L o dt_i
  float S[P][N + 1];                   // the state entering the chunk
  float dt[CH], cum[CH], decay[CH], g[CH];
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
               T* __restrict__ y, float* __restrict__ states, int L, int H, long sx, long sdt,
               long sb, long sc) {
  constexpr int CH = Chunk<P, N>::CH;
  constexpr int RC = CH / TG, RP = P / TG, RN = N / TG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<P, N>& s = *reinterpret_cast<FwdSmem<P, N>*>(smem_raw);
  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % TG, ty = tid / TG, lane = tid % 32, warp = tid / 32;
  const int nc = (L + CH - 1) / CH;
  const float a = A[hi], dskip = Dv[hi];
  float sr[RP][RN];                    // this thread's tile of S
  zero(sr);
  for (int i = tid; i < P * (N + 1); i += THREADS) (&s.S[0][0])[i] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CH, len = min(CH, L - t0);
    const size_t row0 = size_t(bi) * L + t0;
    float* st = states + ((size_t(bi) * nc + c) * H + hi) * P * N;
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) st[(ty + TG * r) * N + tx + TG * q] = sr[r][q];
    __syncthreads();                   // the previous chunk is done with the tiles
    stage<CH, P>(&s.x[0][0], x, row0, sx, hi * P, len);
    stage<CH, N>(&s.B[0][0], Bm, row0, sb, 0, len);
    stage<CH, N>(&s.C[0][0], Cm, row0, sc, 0, len);
    if (tid < CH) s.dt[tid] = tid < len ? to_f(dt[(row0 + tid) * sdt + hi]) : 0.f;
    __syncthreads();
    if (warp == 0) warp_scan<CH, false>(s.dt, a, s.cum, lane);
    __syncthreads();
    const float last = s.cum[CH - 1];
    if (tid < CH) {
      s.decay[tid] = expf(s.cum[tid]);
      s.g[tid] = expf(last - s.cum[tid]) * s.dt[tid];
    }
    {
      float cb[RC][RC];
      zero(cb);
      tile_mm<RC, RC, N, false, true>(cb, &s.C[0][0], N + 1, &s.B[0][0], N + 1, ty, tx);
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const int j = ty + TG * r, i = tx + TG * q;
          s.W[j][i] = i <= j ? cb[r][q] * expf(s.cum[j] - s.cum[i]) * s.dt[i] : 0.f;
        }
    }
    __syncthreads();
    {
      float acc[RC][RP];
      zero(acc);
      tile_mm<RC, RP, N, false, true>(acc, &s.C[0][0], N + 1, &s.S[0][0], N + 1, ty, tx);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float d = s.decay[ty + TG * r];
#pragma unroll
        for (int q = 0; q < RP; ++q) acc[r][q] *= d;
      }
      tile_mm<RC, RP, CH, false, false>(acc, &s.W[0][0], CH + 1, &s.x[0][0], P + 1, ty, tx);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const int j = ty + TG * r;
        if (j >= len) continue;
        T* out = y + ((row0 + j) * H + hi) * P;
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          const int p = tx + TG * q;
          out[p] = from_f<T>(acc[r][q] + dskip * s.x[j][p]);
        }
      }
    }
    {
      const float wce = expf(last);
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) sr[r][q] *= wce;
      tile_mm<RP, RN, CH, true, false>(sr, &s.x[0][0], P + 1, &s.B[0][0], N + 1, ty, tx, s.g);
    }
    __syncthreads();                   // every read of the old S is done
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) s.S[ty + TG * r][tx + TG * q] = sr[r][q];
  }
}

template <int P, int N>
struct BwdSmem {
  static constexpr int CH = Chunk<P, N>::CH;
  static constexpr int SQ = P * (N + 1) > CH * (CH + 1) ? P * (N + 1) : CH * (CH + 1);
  float x[CH][P + 1], dy[CH][P + 1], B[CH][N + 1], C[CH][N + 1];
  float sq[SQ];                        // S_in [P][N + 1], then dLL [CH][CH + 1]
  float dS[P][N + 1];                  // dL/dS at the chunk's end
  float W[CH][CH + 1], dCB[CH][CH + 1];
  float dt[CH], cum[CH], decay[CH], tail[CH], dDecay[CH], dtail[CH], rowx[CH], dcum[CH];
  float dloga[CH];
  float red[WARPS];
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ states, const T* __restrict__ dy, T* __restrict__ dx,
               T* __restrict__ ddt, float* __restrict__ dA_part, float* __restrict__ dD_part,
               float* __restrict__ dB_part, float* __restrict__ dC_part, int batch, int L, int H,
               long sx, long sdt, long sb, long sc, long sdy) {
  constexpr int CH = Chunk<P, N>::CH;
  constexpr int RC = CH / TG, RP = P / TG, RN = N / TG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<P, N>& s = *reinterpret_cast<BwdSmem<P, N>*>(smem_raw);
  float (*Sin)[N + 1] = reinterpret_cast<float (*)[N + 1]>(s.sq);
  float (*dLL)[CH + 1] = reinterpret_cast<float (*)[CH + 1]>(s.sq);
  const int hi = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % TG, ty = tid / TG, lane = tid % 32, warp = tid / 32;
  const int nc = (L + CH - 1) / CH;
  const float a = A[hi], dskip = Dv[hi];
  float dsr[RP][RN];                   // this thread's tile of dS
  zero(dsr);
  for (int i = tid; i < P * (N + 1); i += THREADS) (&s.dS[0][0])[i] = 0.f;
  float dA_acc = 0.f, dD_acc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CH, len = min(CH, L - t0);
    const size_t row0 = size_t(bi) * L + t0;
    __syncthreads();                   // the previous chunk is done with the tiles
    stage<CH, P>(&s.x[0][0], x, row0, sx, hi * P, len);
    stage<CH, P>(&s.dy[0][0], dy, row0, sdy, hi * P, len);
    stage<CH, N>(&s.B[0][0], Bm, row0, sb, 0, len);
    stage<CH, N>(&s.C[0][0], Cm, row0, sc, 0, len);
    {
      const float* st = states + ((size_t(bi) * nc + c) * H + hi) * P * N;
#pragma unroll 16
      for (int i = tid; i < P * N; i += THREADS) Sin[i / N][i % N] = st[i];
    }
    if (tid < CH) s.dt[tid] = tid < len ? to_f(dt[(row0 + tid) * sdt + hi]) : 0.f;
    __syncthreads();
    if (warp == 0) warp_scan<CH, false>(s.dt, a, s.cum, lane);
    __syncthreads();
    const float last = s.cum[CH - 1], wce = expf(last);
    if (tid < CH) {
      s.decay[tid] = expf(s.cum[tid]);
      s.tail[tid] = expf(last - s.cum[tid]);
    }
    __syncthreads();

    // --- y = W (dt x) + decay o (C S_in^T): dDecay, dC (first part), dwce
    {
      float cs[RC][RP];                // C S_in^T
      zero(cs);
      tile_mm<RC, RP, N, false, true>(cs, &s.C[0][0], N + 1, &Sin[0][0], N + 1, ty, tx);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const int j = ty + TG * r;
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < RP; ++q) part += cs[r][q] * s.dy[j][tx + TG * q];
        part = row_sum(part);
        if (tx == 0) s.dDecay[j] = part;
      }
    }
    float dCa[RC][RN];                 // dC of this chunk and head
    zero(dCa);
    tile_mm<RC, RN, P, false, false>(dCa, &s.dy[0][0], P + 1, &Sin[0][0], N + 1, ty, tx);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float d = s.decay[ty + TG * r];
#pragma unroll
      for (int q = 0; q < RN; ++q) dCa[r][q] *= d;
    }
    {
      float part = 0.f;                // dwce = sum S_in o dS
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) part += dsr[r][q] * Sin[ty + TG * r][tx + TG * q];
      part = warp_sum(part);
      if (lane == 0) s.red[warp] = part;
    }

    // --- S_out = wce S_in + (tail o dt x)^T B: ddx (tail part), dtail, dB
    float ddx[RC][RP];                 // dL/d(dt x)
    zero(ddx);
    tile_mm<RC, RP, N, false, true>(ddx, &s.B[0][0], N + 1, &s.dS[0][0], N + 1, ty, tx);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int i = ty + TG * r;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < RP; ++q) part += ddx[r][q] * s.x[i][tx + TG * q];
      part = row_sum(part) * s.dt[i];
      if (tx == 0) s.dtail[i] = part;
      const float tl = s.tail[i];
#pragma unroll
      for (int q = 0; q < RP; ++q) ddx[r][q] *= tl;
    }
    float dBa[RC][RN];                 // dB of this chunk and head
    zero(dBa);
    tile_mm<RC, RN, P, false, false>(dBa, &s.x[0][0], P + 1, &s.dS[0][0], N + 1, ty, tx);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int i = ty + TG * r;
      const float gi = s.tail[i] * s.dt[i];
#pragma unroll
      for (int q = 0; q < RN; ++q) dBa[r][q] *= gi;
    }
    // dS_in = wce dS + (decay o dy)^T C, kept in registers until the tiles'
    // readers are done
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) dsr[r][q] *= wce;
    tile_mm<RP, RN, CH, true, false>(dsr, &s.dy[0][0], P + 1, &s.C[0][0], N + 1, ty, tx,
                                     s.decay);
    __syncthreads();                   // S_in and the old dS are read
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) s.dS[ty + TG * r][tx + TG * q] = dsr[r][q];

    // --- W = (C B^T) o L: dW, dCB, dL o L
    {
      float cb[RC][RC], dw[RC][RC];
      zero(cb);
      zero(dw);
      tile_mm<RC, RC, N, false, true>(cb, &s.C[0][0], N + 1, &s.B[0][0], N + 1, ty, tx);
      tile_mm<RC, RC, P, false, true>(dw, &s.dy[0][0], P + 1, &s.x[0][0], P + 1, ty, tx);
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const int j = ty + TG * r, i = tx + TG * q;
          float w = 0.f, dcb = 0.f, dll = 0.f;
          if (i <= j) {
            const float Lv = expf(s.cum[j] - s.cum[i]);
            const float dW = dw[r][q] * s.dt[i];
            w = cb[r][q] * Lv;
            dcb = dW * Lv;
            dll = dcb * cb[r][q];
          }
          s.W[j][i] = w;
          s.dCB[j][i] = dcb;
          dLL[j][i] = dll;
        }
    }
    __syncthreads();
    tile_mm<RC, RP, CH, true, false>(ddx, &s.W[0][0], CH + 1, &s.dy[0][0], P + 1, ty, tx);
    tile_mm<RC, RN, CH, false, false>(dCa, &s.dCB[0][0], CH + 1, &s.B[0][0], N + 1, ty, tx);
    tile_mm<RC, RN, CH, true, false>(dBa, &s.dCB[0][0], CH + 1, &s.C[0][0], N + 1, ty, tx);
    if (tid < CH) {                    // dcum from L's rows and columns
      float rows = 0.f, cols = 0.f;
      for (int i = 0; i < CH; ++i) {
        rows += dLL[tid][i];
        cols += dLL[i][tid];
      }
      s.dcum[tid] = rows - cols + s.dDecay[tid] * s.decay[tid] - s.dtail[tid] * s.tail[tid];
    }
#pragma unroll
    for (int r = 0; r < RC; ++r) {     // sum_p ddx x, for ddt
      const int i = ty + TG * r;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        const int p = tx + TG * q;
        part += ddx[r][q] * s.x[i][p];
        dD_acc += s.dy[i][p] * s.x[i][p];
      }
      part = row_sum(part);
      if (tx == 0) s.rowx[i] = part;
    }
    __syncthreads();
    if (warp == 0) {
      // cum_last also reaches every tail and the state's decay wce
      float part = 0.f;
      for (int i = lane; i < CH; i += 32) part += s.dtail[i] * s.tail[i];
      part = warp_sum(part);
      float dwce = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) dwce += s.red[w];
      if (lane == 0) s.dcum[CH - 1] += part + dwce * wce;
      __syncwarp();
      warp_scan<CH, true>(s.dcum, 1.f, s.dloga, lane);
      __syncwarp();
      for (int i = lane; i < CH; i += 32) {
        dA_acc += s.dloga[i] * s.dt[i];
        if (i < len) ddt[(row0 + i) * H + hi] = from_f<T>(a * s.dloga[i] + s.rowx[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int i = ty + TG * r;
      if (i >= len) continue;
      const float dti = s.dt[i];
      T* out = dx + ((row0 + i) * H + hi) * P;
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        const int p = tx + TG * q;
        out[p] = from_f<T>(dti * ddx[r][q] + dskip * s.dy[i][p]);
      }
      const size_t off = ((size_t(hi) * batch + bi) * L + t0 + i) * N;
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        dB_part[off + tx + TG * q] = dBa[r][q];
        dC_part[off + tx + TG * q] = dCa[r][q];
      }
    }
  }
  __syncthreads();
  dD_acc = warp_sum(dD_acc);
  if (lane == 0) s.red[warp] = dD_acc;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += s.red[w];
    dD_part[size_t(bi) * H + hi] = sum;
  }
  if (warp == 0) {
    dA_acc = warp_sum(dA_acc);
    if (lane == 0) dA_part[size_t(bi) * H + hi] = dA_acc;
  }
}

struct Args {
  const void *x, *dt, *A, *B, *C, *D, *states, *dy;
  void *y, *out_states, *dx, *ddt, *dA, *dD, *dB, *dC;
  int batch, L, H;
  long sx, sdt, sb, sc, sdy;
  cudaStream_t st;
};

template <typename T, int P, int N>
int launch_fwd(const Args& g) {
  static std::atomic<uint64_t> done{0};
  const int smem = int(sizeof(FwdSmem<P, N>));
  cudaError_t err = ptt::allow_smem(ssd_fwd_kernel<T, P, N>, smem, done);
  if (err != cudaSuccess) return int(err);
  ssd_fwd_kernel<T, P, N><<<dim3(g.H, g.batch), THREADS, smem, g.st>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.dt), static_cast<const float*>(g.A),
      static_cast<const T*>(g.B), static_cast<const T*>(g.C), static_cast<const float*>(g.D),
      static_cast<T*>(g.y), static_cast<float*>(g.out_states), g.L, g.H, g.sx, g.sdt, g.sb, g.sc);
  return int(cudaGetLastError());
}

template <typename T, int P, int N>
int launch_bwd(const Args& g) {
  static std::atomic<uint64_t> done{0};
  const int smem = int(sizeof(BwdSmem<P, N>));
  cudaError_t err = ptt::allow_smem(ssd_bwd_kernel<T, P, N>, smem, done);
  if (err != cudaSuccess) return int(err);
  ssd_bwd_kernel<T, P, N><<<dim3(g.H, g.batch), THREADS, smem, g.st>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.dt), static_cast<const float*>(g.A),
      static_cast<const T*>(g.B), static_cast<const T*>(g.C), static_cast<const float*>(g.D),
      static_cast<const float*>(g.states), static_cast<const T*>(g.dy), static_cast<T*>(g.dx),
      static_cast<T*>(g.ddt), static_cast<float*>(g.dA), static_cast<float*>(g.dD),
      static_cast<float*>(g.dB), static_cast<float*>(g.dC), g.batch, g.L, g.H, g.sx, g.sdt, g.sb,
      g.sc, g.sdy);
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
// C [batch, L, N] (sb, sc): the token (b, t) starts at (b L + t) * stride.
// All in f32 (bf16_io = 0) or bf16 (1); A, D [H] f32. Writes y [batch, L,
// H, P] contiguous (the I/O type) and the f32 state entering each chunk,
// states [batch, ceil(L / CH), H, P, N] (CH = 64 at P = N = 64, else 32).
// Needs P, N in {64, 128}. Returns cudaGetLastError() after the launch.
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

// The backward of ptt_ssd_fwd from its states and dy [batch, L, H, P] (token
// stride sdy). Writes dx [batch, L, H, P] and ddt [batch, L, H] contiguous
// (the I/O type), and f32 partials: dA and dD [batch, H], dB and dC [H,
// batch, L, N], which the caller sums over their first axis.
int ptt_ssd_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                const void* D, const void* states, const void* dy, void* dx, void* ddt,
                void* dA_part, void* dD_part, void* dB_part, void* dC_part, int batch, int L,
                int H, int P, int N, int sx, int sdt, int sb, int sc, int sdy, int bf16_io,
                void* stream) {
  if (bad_shape(batch, L, H)) return int(cudaErrorInvalidValue);
  Args g{};
  g.x = x; g.dt = dt; g.A = A; g.B = B; g.C = C; g.D = D; g.states = states; g.dy = dy;
  g.dx = dx; g.ddt = ddt; g.dA = dA_part; g.dD = dD_part; g.dB = dB_part; g.dC = dC_part;
  g.batch = batch; g.L = L; g.H = H;
  g.sx = sx; g.sdt = sdt; g.sb = sb; g.sc = sc; g.sdy = sdy;
  g.st = static_cast<cudaStream_t>(stream);
  return dispatch<true>(g, P, N, bf16_io);
}

}  // extern "C"
