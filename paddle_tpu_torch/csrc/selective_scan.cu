// The selective scan (S6, Mamba-1) forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/selective_scan.py: the
// forward `_fwd_kernel` (pl.pallas_call at :217) and the backward
// `_bwd_kernel` (pl.pallas_call at :284). Per batch row b and channel d,
// with n states and A = [d, n]:
//   h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t,    y_t = C_t . h_t
// in f32 whatever the input type; the skip u * D stays outside, as there.
// The backward gives du, ddelta, dA (summed over b and t), dB and dC (summed
// over d), the formulas of `_bwd_kernel` (:120-195).
//
// What bounds it on the H100: neither bytes nor the tensor cores. The
// per-channel decay exp(delta A) is elementwise (no product form), so the
// work is f32 FMAs and one exponential per (b, t, d, n), and the recurrence
// runs l steps one after the other. The bound is max(bytes / 3.35 TB/s,
// 10 (forward) or 25 (backward) ops per (b, l, d, n) / 67 TFLOP/s f32).
//
// Forward (simple first): one thread per (b, channel) holds the n <= 16
// states in registers and walks the sequence; a block is 64 channels of one
// batch row. B_t and C_t (shared by every channel) are staged in shared
// memory a chunk of 64 steps at a time; u, delta (and dy) come into
// registers 8 steps at a time, their loads in flight together, so the walk
// does not wait on memory at every step. The forward writes y and the state
// entering every chunk of 64 steps, [b, ceil(l/64), n, d] f32 (the Pallas
// design's residual, 25 MB per layer at b16 l1024 d1536 n16, where the whole
// history would be 1.6 GB).
// The backward (described above its kernels) is chunk-parallel: the
// gradient carry crosses a chunk as an elementwise affine map, so a local
// sweep, a short pass over the chunks and the chunks' own backward each
// run over (b, chunk, channels), 16 times the forward's parallelism at
// l = 1024. It computes three exponentials per (t, n), so beside the
// bound its floor on the special-function unit is 3 b l d n / (132 SMs x
// 16 a clock).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int N = 16;          // states held per thread (n <= N; the rest are zero)
constexpr int CHUNK = 64;      // steps between saved states
constexpr int SUB = 8;         // backward replay sub-chunk
constexpr int NSUB = CHUNK / SUB;
constexpr int THREADS = 64;    // channels per block
constexpr int WARPS = THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// B and C of one chunk, [CHUNK][N] f32, zero past the sequence end and past n
template <typename T>
__device__ __forceinline__ void stage_bc(float (*sB)[N], float (*sC)[N], const T* __restrict__ B,
                                         const T* __restrict__ C, size_t row0, int len, int n) {
#pragma unroll
  for (int it = 0; it < CHUNK * N / THREADS; ++it) {   // every load in flight at once
    const int i = it * THREADS + threadIdx.x;
    const int t = i / N, k = i % N;
    float bv = 0.f, cv = 0.f;
    if (t < len && k < n) {
      const size_t off = (row0 + t) * n + k;
      bv = to_f(B[off]);
      cv = to_f(C[off]);
    }
    sB[t][k] = bv;
    sC[t][k] = cv;
  }
}

// S steps from t0 of one channel's [b, l, d] values, in registers: the loads
// are all in flight together (zero past the sequence end)
template <int S, typename T>
__device__ __forceinline__ void load_steps(float (&dst)[S], const T* __restrict__ src,
                                           size_t row0, int t0, int len, int D, int ch,
                                           bool active) {
#pragma unroll
  for (int i = 0; i < S; ++i)
    dst[i] = (active && t0 + i < len) ? to_f(src[(row0 + t0 + i) * D + ch]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta, const float* __restrict__ A,
                const T* __restrict__ B, const T* __restrict__ C, T* __restrict__ y,
                float* __restrict__ bounds, int L, int D, int n) {
  __shared__ float sB[CHUNK][N], sC[CHUNK][N];
  const int bi = blockIdx.y, tid = threadIdx.x;
  const int ch = blockIdx.x * THREADS + tid;
  const bool active = ch < D;
  const int nc = (L + CHUNK - 1) / CHUNK;
  float a[N], h[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a[k] = (active && k < n) ? A[size_t(ch) * n + k] * LOG2E : 0.f;
    h[k] = 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CHUNK;
    const int len = min(CHUNK, L - t0);
    const size_t row0 = size_t(bi) * L + t0;
    if (active) {
      float* dst = bounds + (size_t(bi) * nc + c) * n * D + ch;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < n) dst[size_t(k) * D] = h[k];
    }
    __syncthreads();                       // the previous chunk is done with smem
    stage_bc(sB, sC, B, C, row0, len, n);
    __syncthreads();
    for (int j0 = 0; j0 < len; j0 += SUB) {
      float dts[SUB], us[SUB];
      load_steps(dts, delta, row0, j0, len, D, ch, active);
      load_steps(us, u, row0, j0, len, D, ch, active);
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j0 + j >= len) break;
        const int t = j0 + j;
        const float dtu = dts[j] * us[j];
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int k = 0; k < N; k += 2) {
          h[k] = exp2f(dts[j] * a[k]) * h[k] + dtu * sB[t][k];
          h[k + 1] = exp2f(dts[j] * a[k + 1]) * h[k + 1] + dtu * sB[t][k + 1];
          acc0 += sC[t][k] * h[k];
          acc1 += sC[t][k + 1] * h[k + 1];
        }
        if (active) y[(row0 + t) * D + ch] = from_f<T>(acc0 + acc1);
      }
    }
  }
}

// ------------------------------------------------------------------ backward
// The reverse carry g (dL/dh_t times exp(delta_t A), per (b, channel,
// state)) crosses a chunk as an elementwise affine map: walking chunk c
// right to left from g_out gives g_in = local(c) + P(c) o g_out, with
//   local(c) = sum_t (prod_{s <= t} a_s) C_t dy_t,   P(c) = exp(A sum_t delta_t)
// over the chunk's steps (a_s = exp(delta_s A)). So the backward is three
// launches:
//   1. scan_bwd_local_kernel, over (channel tile, chunk, b): local(c) in one
//      forward sweep (one exponential per (t, n)) and sum_t delta_t;
//   2. scan_bwd_pass_kernel, over (channel, state, b): the carries, right to
//      left over the chunks, g_out(c) = local(c+1) + P(c+1) o g_out(c+1),
//      written in place of local (nc steps per element, tiny);
//   3. scan_bwd_kernel, over (TILES channel tiles, chunk, b): the chunk's
//      backward from its saved state and its true g_out.
// Stage 3 replays h over the chunk once, keeping the state entering each
// sub-chunk of BSUB steps in shared memory, then per sub-chunk in reverse
// replays BSUB steps keeping h_t and a_t in registers and walks them
// backwards: two exponentials per (t, n) there, three over the backward.
// A thread holds NS = 4 of a channel's 16 states (4 lanes a channel, 64
// channels per 256 threads). A tile's u, delta and dy for the chunk are
// staged in shared memory by rows at the start; du and ddelta are summed
// over the 4 lanes by shuffles, take the places of the spent u and delta
// and go out by rows at the end. dB and dC (sums over channels) are reduced
// by a reduce-scatter over the warp's 8 channels, then over the 8 warps in
// shared memory into a per-block sum of TILES channel tiles, written as
// [ceil(D / (TILES TD)), b, l, n] partials; dA as [b nc, D, n] partials.
// The caller sums the partials in a fixed order: no atomics, the same
// result on every run. What bounds the chunk kernel is the instructions it
// runs (~180 a thread and step, a fifth of them the channel reductions) at two
// blocks an SM (128 registers, 108 KB of shared memory in bf16).

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int NS = 4;                        // states per thread
constexpr int LPC = N / NS;                  // lanes per channel
constexpr int TD = BWD_THREADS / LPC;        // channels per tile: 64
constexpr int TILES = 1;                     // channel tiles per block
constexpr int BSUB = 4;                      // steps replayed in registers
constexpr int BNSUB = CHUNK / BSUB;
constexpr int PASS_THREADS = 256;
constexpr int PASS_DEPTH = 8;                // carries loaded at once

using ptt::sm90::ex2_approx;

// rows [0, len) of one chunk of a [b, l, n] tensor into dst[CHUNK][N] as
// f32, zero past len and past n
template <typename T>
__device__ __forceinline__ void stage_rows(float (*dst)[N], const T* __restrict__ src,
                                           size_t row0, int len, int n) {
#pragma unroll
  for (int it = 0; it < CHUNK * N / BWD_THREADS; ++it) {
    const int i = it * BWD_THREADS + threadIdx.x;
    const int t = i / N, k = i % N;
    dst[t][k] = (t < len && k < n) ? to_f(src[(row0 + t) * n + k]) : 0.f;
  }
}

// rows [0, len) of one chunk of a [b, l, D] tensor, channels [ch0, ch0 +
// TD), into dst[CHUNK][TD] as they are, zero past len and past D (the loads
// of a thread are all in flight together)
template <typename T>
__device__ __forceinline__ void stage_cols(T (*dst)[TD], const T* __restrict__ src, size_t row0,
                                           int len, int D, int ch0) {
  constexpr int IT = CHUNK * TD / BWD_THREADS;
  T v[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * BWD_THREADS + threadIdx.x, t = i / TD, c = ch0 + i % TD;
    v[it] = (t < len && c < D) ? src[(row0 + t) * D + c] : from_f<T>(0.f);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = it * BWD_THREADS + threadIdx.x;
    dst[i / TD][i % TD] = v[it];
  }
}

// the inverse of stage_cols: src[CHUNK][TD] into rows [0, len) and channels
// [ch0, ch0 + TD) of a [b, l, D] tensor, nothing past len or D
template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ dst, const T (*src)[TD], size_t row0,
                                           int len, int D, int ch0) {
#pragma unroll
  for (int it = 0; it < CHUNK * TD / BWD_THREADS; ++it) {
    const int i = it * BWD_THREADS + threadIdx.x, t = i / TD, c = ch0 + i % TD;
    if (t < len && c < D) dst[(row0 + t) * D + c] = src[i / TD][i % TD];
  }
}

// One round of a warp reduce-scatter: of the 2 H values v[0, 2H), the lanes
// with `bit` set keep the upper H, the others the lower, each adding its
// partner's copy (H a constant, so `v` stays in registers).
template <int H>
__device__ __forceinline__ void scatter_round(float* v, int lane, int bit) {
  const bool upper = (lane & bit) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

// the state of this thread's slot i: k = q NS + i
__device__ __forceinline__ int state_of(int q, int i) { return q * NS + i; }

template <typename T>
struct LocalSmem {
  float C[CHUNK][N];
  T delta[CHUNK][TD], dy[CHUNK][TD];
};

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
scan_bwd_local_kernel(const T* __restrict__ delta, const float* __restrict__ A,
                      const T* __restrict__ C, const T* __restrict__ dy,
                      float* __restrict__ carry, float* __restrict__ dsum, int L, int D, int n) {
  __shared__ LocalSmem<T> s;
  const int tile = blockIdx.x, c = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int q = tid % LPC, cl = tid / LPC, ch = tile * TD + cl;
  const bool active = ch < D;
  const int nc = (L + CHUNK - 1) / CHUNK, t0 = c * CHUNK, len = min(CHUNK, L - t0);
  const size_t row0 = size_t(bi) * L + t0;
  stage_rows(s.C, C, row0, len, n);
  stage_cols(s.delta, delta, row0, len, D, tile * TD);
  stage_cols(s.dy, dy, row0, len, D, tile * TD);
  float a[NS], R[NS], gl[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int k = state_of(q, i);
    a[i] = (active && k < n) ? A[size_t(ch) * n + k] * LOG2E : 0.f;
    R[i] = 1.f;
    gl[i] = 0.f;
  }
  __syncthreads();
  float sd = 0.f;
  for (int t = 0; t < len; ++t) {
    const float dt = to_f(s.delta[t][cl]), dyv = to_f(s.dy[t][cl]);
    sd += dt;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      R[i] *= ex2_approx(dt * a[i]);
      gl[i] = fmaf(R[i] * s.C[t][state_of(q, i)], dyv, gl[i]);
    }
  }
  if (!active) return;
  const size_t base = (size_t(bi) * nc + c) * n;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int k = state_of(q, i);
    if (k < n) carry[(base + k) * D + ch] = gl[i];
  }
  if (q == 0) dsum[(size_t(bi) * nc + c) * D + ch] = sd;
}

__global__ void __launch_bounds__(PASS_THREADS)
scan_bwd_pass_kernel(const float* __restrict__ A, float* __restrict__ carry,
                     const float* __restrict__ dsum, int nc, int D, int n) {
  const int ch = blockIdx.x * PASS_THREADS + threadIdx.x, k = blockIdx.y, bi = blockIdx.z;
  if (ch >= D) return;
  const float a = A[size_t(ch) * n + k] * LOG2E;
  float g = 0.f;
  for (int hi = nc - 1; hi >= 0; hi -= PASS_DEPTH) {
    float loc[PASS_DEPTH], dec[PASS_DEPTH];
#pragma unroll
    for (int j = 0; j < PASS_DEPTH; ++j) {
      const int c = hi - j;
      if (c >= 0) {
        loc[j] = carry[((size_t(bi) * nc + c) * n + k) * D + ch];
        dec[j] = ex2_approx(a * dsum[(size_t(bi) * nc + c) * D + ch]);
      }
    }
#pragma unroll
    for (int j = 0; j < PASS_DEPTH; ++j) {
      const int c = hi - j;
      if (c >= 0) {
        carry[((size_t(bi) * nc + c) * n + k) * D + ch] = g;
        g = fmaf(dec[j], g, loc[j]);
      }
    }
  }
}

template <typename T>
struct BwdSmem {
  float B[CHUNK][N], C[CHUNK][N];
  T u[CHUNK][TD], delta[CHUNK][TD], dy[CHUNK][TD];   // this channel tile's (u and
                                                     // delta become du and ddelta)
  float start[BNSUB][NS][BWD_THREADS];  // state entering each sub-chunk
  float red[BWD_WARPS][BSUB][32];       // per-warp sums of dB and dC
  float acc[CHUNK][2 * N];              // the block's dB (0..N) and dC (N..2N)
};

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 2)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta, const float* __restrict__ A,
                const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ bounds, const float* __restrict__ carry,
                const T* __restrict__ dy, T* __restrict__ du, T* __restrict__ ddelta,
                float* __restrict__ dA_part, float* __restrict__ dB_part,
                float* __restrict__ dC_part, int batch, int L, int D, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<T>& s = *reinterpret_cast<BwdSmem<T>*>(smem_raw);
  const int st = blockIdx.x, c = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, q = tid % LPC, cl = tid / LPC;
  const int nc = (L + CHUNK - 1) / CHUNK, t0 = c * CHUNK, len = min(CHUNK, L - t0);
  const size_t row0 = size_t(bi) * L + t0;
  const size_t cbase = (size_t(bi) * nc + c) * n;
  stage_rows(s.B, B, row0, len, n);
  stage_rows(s.C, C, row0, len, n);
  for (int i = tid; i < CHUNK * 2 * N; i += BWD_THREADS) (&s.acc[0][0])[i] = 0.f;
  const int nsub = (len + BSUB - 1) / BSUB;
  for (int tt = 0; tt < TILES; ++tt) {
    const int ch0 = (st * TILES + tt) * TD, ch = ch0 + cl;
    const bool active = ch < D;
    if (tt > 0) __syncthreads();           // the previous tile is done with u, delta, dy
    stage_cols(s.u, u, row0, len, D, ch0);
    stage_cols(s.delta, delta, row0, len, D, ch0);
    stage_cols(s.dy, dy, row0, len, D, ch0);
    float a[NS], g[NS], dA[NS], h[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int k = state_of(q, i);
      const bool on = active && k < n;
      a[i] = on ? A[size_t(ch) * n + k] * LOG2E : 0.f;
      g[i] = on ? carry[(cbase + k) * D + ch] : 0.f;
      h[i] = on ? bounds[(cbase + k) * D + ch] : 0.f;
      dA[i] = 0.f;
    }
    __syncthreads();                       // B, C and the tile's u, delta, dy staged
    // replay the chunk from its saved state, keeping each sub-chunk's start
    for (int sb = 0; sb < nsub; ++sb) {
      const int j0 = sb * BSUB;
#pragma unroll
      for (int i = 0; i < NS; ++i) s.start[sb][i][tid] = h[i];
#pragma unroll
      for (int j = 0; j < BSUB; ++j) {
        const int t = j0 + j;
        const float dt = to_f(s.delta[t][cl]), dtu = dt * to_f(s.u[t][cl]);
#pragma unroll
        for (int i = 0; i < NS; ++i)
          h[i] = fmaf(ex2_approx(dt * a[i]), h[i], dtu * s.B[t][state_of(q, i)]);
      }
    }
    for (int sb = nsub - 1; sb >= 0; --sb) {
      const int j0 = sb * BSUB;
      const int slen = min(BSUB, len - j0);
      float dts[BSUB], us[BSUB], dys[BSUB];
#pragma unroll
      for (int j = 0; j < BSUB; ++j) {
        dts[j] = to_f(s.delta[j0 + j][cl]);
        us[j] = to_f(s.u[j0 + j][cl]);
        dys[j] = to_f(s.dy[j0 + j][cl]);
      }
      // replay the sub-chunk, keeping every h_t and a_t
      float h0[NS], hist[BSUB][NS], dah[BSUB][NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        h0[i] = s.start[sb][i][tid];
        h[i] = h0[i];
      }
#pragma unroll
      for (int j = 0; j < BSUB; ++j) {
        const float dtu = dts[j] * us[j];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          dah[j][i] = ex2_approx(dts[j] * a[i]);
          h[i] = fmaf(dah[j][i], h[i], dtu * s.B[j0 + j][state_of(q, i)]);
          hist[j][i] = h[i];
        }
      }
      // walk it backwards (steps past len were staged as zeros: they leave g
      // as it is and add nothing)
#pragma unroll
      for (int j = BSUB - 1; j >= 0; --j) {
        const int t = j0 + j;
        const float dt = dts[j], dtu = dt * us[j], dyv = dys[j];
        float s1 = 0.f, s2 = 0.f, vals[2 * NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int k = state_of(q, i);
          const float dh = fmaf(s.C[t][k], dyv, g[i]);
          const float hp = j > 0 ? hist[j - 1][i] : h0[i];
          const float common = dh * hp * dah[j][i];
          s1 = fmaf(common, a[i], s1);
          s2 = fmaf(dh, s.B[t][k], s2);
          dA[i] = fmaf(common, dt, dA[i]);
          vals[i] = dh * dtu;                 // dB_t (this channel's share)
          vals[NS + i] = hist[j][i] * dyv;    // dC_t
          g[i] = dah[j][i] * dh;
        }
        // du, ddelta: sums over the channel's LPC lanes
#pragma unroll
        for (int o = 1; o < LPC; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        // u_t and delta_t are spent (in registers since the sub-chunk began;
        // the other lanes of the channel took theirs before the shuffles
        // above): du and ddelta take their places, written out by rows
        // after the tile
        if (q == 0) s.u[t][cl] = from_f<T>(dt * s2);
        if (q == 1) s.delta[t][cl] = from_f<T>(fmaf(s1, LN2, s2 * us[j]));   // a = A log2(e)
        // dB, dC over the warp's 32 / LPC channels (the lane bits from LPC
        // up): lane L ends with value L / LPC of the 2 NS, for states
        // (L % LPC) NS ..
        scatter_round<NS>(vals, lane, 16);
        if constexpr (LPC <= 8) scatter_round<NS / 2>(vals, lane, 8);
        if constexpr (LPC <= 4) scatter_round<NS / 4>(vals, lane, 4);
        if constexpr (LPC <= 2) scatter_round<NS / 8>(vals, lane, 2);
        s.red[warp][j][lane] = vals[0];
      }
      __syncthreads();
      for (int i = tid; i < slen * 32; i += BWD_THREADS) {
        const int j = i / 32, x = i % 32, v = x / LPC;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < BWD_WARPS; ++w) sum += s.red[w][j][x];
        s.acc[j0 + j][(v < NS ? 0 : N) + state_of(x % LPC, v % NS)] += sum;
      }
      __syncthreads();                     // red is reused
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int k = state_of(q, i);
        if (k < n) dA_part[((size_t(bi) * nc + c) * D + ch) * n + k] = dA[i];
      }
    }
    // (the last sub-chunk's __syncthreads: every du, ddelta is in place)
    store_cols(du, s.u, row0, len, D, ch0);
    store_cols(ddelta, s.delta, row0, len, D, ch0);
  }
  for (int i = tid; i < len * 2 * N; i += BWD_THREADS) {
    const int j = i / (2 * N), x = i % (2 * N), k = x % N;
    if (k >= n) continue;
    float* dst = x < N ? dB_part : dC_part;
    dst[((size_t(st) * batch + bi) * L + t0 + j) * n + k] = s.acc[j][x];
  }
}

template <typename T>
int launch_fwd(const void* u, const void* delta, const void* A, const void* B, const void* C,
               void* y, void* bounds, int batch, int L, int D, int n, cudaStream_t st) {
  const dim3 grid((D + THREADS - 1) / THREADS, batch);
  scan_fwd_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(bounds), L, D, n);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* u, const void* delta, const void* A, const void* B, const void* C,
               const void* bounds, const void* dy, void* du, void* ddelta, void* dA_part,
               void* dB_part, void* dC_part, void* carry, void* dsum, int batch, int L, int D,
               int n, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const int smem = int(sizeof(BwdSmem<T>));
  cudaError_t err = ptt::allow_smem(scan_bwd_kernel<T>, smem, done);
  if (err != cudaSuccess) return int(err);
  const int nc = (L + CHUNK - 1) / CHUNK;
  const auto* Ap = static_cast<const float*>(A);
  scan_bwd_local_kernel<T><<<dim3((D + TD - 1) / TD, nc, batch), BWD_THREADS, 0, st>>>(
      static_cast<const T*>(delta), Ap, static_cast<const T*>(C), static_cast<const T*>(dy),
      static_cast<float*>(carry), static_cast<float*>(dsum), L, D, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  scan_bwd_pass_kernel<<<dim3((D + PASS_THREADS - 1) / PASS_THREADS, n, batch), PASS_THREADS, 0,
                         st>>>(Ap, static_cast<float*>(carry), static_cast<const float*>(dsum),
                               nc, D, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  scan_bwd_kernel<T><<<dim3((D + TILES * TD - 1) / (TILES * TD), nc, batch), BWD_THREADS, smem,
                       st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), Ap, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(bounds),
      static_cast<const float*>(carry), static_cast<const T*>(dy), static_cast<T*>(du),
      static_cast<T*>(ddelta), static_cast<float*>(dA_part), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), batch, L, D, n);
  return int(cudaGetLastError());
}

bool bad_shape(int batch, int L, int D, int n) {
  return batch < 1 || batch > 65535 || L < 1 || D < 1 || n < 1 || n > N;
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// u, delta, y [batch, L, D]; B, C [batch, L, n]; all contiguous, f32
// (bf16 = 0) or bf16 (bf16 = 1). A [D, n] f32. bounds [batch, ceil(L/64),
// n, D] f32: the state entering each chunk of 64 steps. Needs 1 <= n <= 16.
// Returns cudaGetLastError() after the launch.
int ptt_selective_scan_fwd(const void* u, const void* delta, const void* A, const void* B,
                           const void* C, void* y, void* bounds, int batch, int L, int D, int n,
                           int bf16_io, void* stream) {
  if (bad_shape(batch, L, D, n)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch_fwd<bf16>(u, delta, A, B, C, y, bounds, batch, L, D, n, st)
                 : launch_fwd<float>(u, delta, A, B, C, y, bounds, batch, L, D, n, st);
}

// The channels summed into one slice of the backward's dB and dC partials.
int ptt_selective_scan_bwd_channels() { return TILES * TD; }

// The backward of ptt_selective_scan_fwd from its bounds and dy [batch, L,
// D] (the type of u); three launches (local carries, the carry pass, the
// chunks' backward). Writes du, ddelta [batch, L, D] (the type of u) and f32
// partials that the caller sums over their first axis: dA_part [batch nc, D,
// n], dB_part and dC_part [ceil(D / ptt_selective_scan_bwd_channels()),
// batch, L, n] (nc = ceil(L / 64)). Scratch: carry [batch, nc, n, D] and
// dsum [batch, nc, D], f32.
int ptt_selective_scan_bwd(const void* u, const void* delta, const void* A, const void* B,
                           const void* C, const void* bounds, const void* dy, void* du,
                           void* ddelta, void* dA_part, void* dB_part, void* dC_part,
                           void* carry, void* dsum, int batch, int L, int D, int n, int bf16_io,
                           void* stream) {
  if (bad_shape(batch, L, D, n)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch_bwd<bf16>(u, delta, A, B, C, bounds, dy, du, ddelta, dA_part, dB_part,
                                    dC_part, carry, dsum, batch, L, D, n, st)
                 : launch_bwd<float>(u, delta, A, B, C, bounds, dy, du, ddelta, dA_part,
                                     dB_part, dC_part, carry, dsum, batch, L, D, n, st);
}

}  // extern "C"
