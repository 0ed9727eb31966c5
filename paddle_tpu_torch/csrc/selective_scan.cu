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
// Forward: a walk over the sequence per (b, channel) that keeps one
// exponential per (b, t, d, n), split over lanes and fed from shared memory.
// - Lanes: FWD_LPC = 2 lanes a channel, each holding FWD_NS = 8 of its 16
//   states; a block is 64 channels of one batch row (128 threads), so the
//   path's b16 d1536 runs 384 blocks, three an SM. y_t's sum over the
//   states takes one shuffle; lane 0 of the channel writes it.
// - Loads ahead of the walk: each chunk of 64 steps (u and delta as [64
//   steps x 64 channels] tiles, B and C as [64 x 16] rows) lands in shared
//   memory by 16-byte cp.async, zero-filled past l and past the row, while
//   the previous chunk is walked (two stages). Each thread widens the bf16
//   B and C vectors it copied to f32 once they land, so no lane converts
//   them at every step. The walk reads shared memory only, and a chunk
//   needs one barrier. Steps past l walk on zeros (delta 0: the state stays
//   as it is) and are not stored.
// - Out: each chunk's y is staged in shared memory and stored by rows (16
//   bytes a thread) while the next chunk is walked; the state entering each
//   chunk of 64 steps, [b, ceil(l/64), n, d] f32, goes straight from the
//   lanes' registers (the backward's residual, 25 MB per layer at b16
//   l1024 d1536 n16, where the whole history would be 1.6 GB).
// - What bounds it: the instructions a step issues (~70 a thread: the 8
//   exponentials and state updates, y's sum, the loads of u, delta and the
//   f32 B and C rows), beside the special-function unit's floor of one
//   exponential per (b, t, d, n) (b l d n / (132 SMs x 16 a clock)); the
//   bytes (~177 MB at the path) take a third of that. Measured against
//   variants (tools/ssm_variants.py, PERF.md): 1 or 4 lanes a channel, B and
//   C converted at every step, TMA staging and the chunk-parallel form
//   (three launches, two exponentials per element) were each slower.
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

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptt::sm90::ex2_approx;

constexpr int N = 16;          // states a channel at most (n <= N; the rest are zero)
constexpr int CHUNK = 64;      // steps between saved states
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// ------------------------------------------------------------------ forward
constexpr int FWD_NS = 8;                        // states a thread
constexpr int FWD_LPC = N / FWD_NS;              // lanes a channel
constexpr int FWD_TD = 64;                       // channels a block
constexpr int FWD_THREADS = FWD_TD * FWD_LPC;

// One chunk of the forward's inputs: this block's channels of u and delta,
// and B and C as rows of N (the wrapper pads n to N).
template <typename T>
struct FwdStage {
  T u[CHUNK][FWD_TD], delta[CHUNK][FWD_TD];
  T B[CHUNK][N], C[CHUNK][N];
};

// B and C of one chunk as f32 (bf16 I/O: widened once a chunk, not by every
// lane at every step)
struct FwdBC {
  float B[CHUNK][N], C[CHUNK][N];
};

template <typename T>
struct FwdSmem {
  FwdStage<T> in[2];        // chunk c in in[c % 2] while chunk c + 1 lands in the other
  T y[2][CHUNK][FWD_TD];    // chunk c's y in y[c % 2], stored during chunk c + 1
  FwdBC bc[2];              // chunk c's B and C in bc[c % 2] (bf16 I/O)
};

// Chunk rows [0, len) from row0 into `st` by 16-byte cp.async: channels
// [ch0, ch0 + FWD_TD) of u and delta (rows of ld values, ld a multiple of
// a vector), whole rows of B and C; zero past len and past ld. One group.
template <typename T>
__device__ __forceinline__ void stage_chunk(FwdStage<T>& st, const T* __restrict__ u,
                                            const T* __restrict__ delta, const T* __restrict__ B,
                                            const T* __restrict__ C, size_t row0, int len, int ld,
                                            int ch0) {
  constexpr int V = 16 / int(sizeof(T));         // values a vector
  constexpr int VR = FWD_TD / V, VB = N / V;     // vectors a row
#pragma unroll
  for (int it = 0; it < CHUNK * VR / FWD_THREADS; ++it) {
    const int i = it * FWD_THREADS + threadIdx.x, t = i / VR, c = (i % VR) * V;
    const bool ok = t < len && ch0 + c < ld;
    const size_t off = ok ? (row0 + t) * ld + ch0 + c : 0;
    ptt::cp_async16(&st.u[t][c], u + off, ok ? 16 : 0);
    ptt::cp_async16(&st.delta[t][c], delta + off, ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < CHUNK * VB; i += FWD_THREADS) {
    const int t = i / VB, k = (i % VB) * V;
    const size_t off = t < len ? (row0 + t) * N + k : 0;
    ptt::cp_async16(&st.B[t][k], B + off, t < len ? 16 : 0);
    ptt::cp_async16(&st.C[t][k], C + off, t < len ? 16 : 0);
  }
  ptt::cp_async_commit();
}

// The B and C vectors this thread staged for a chunk (stage_chunk's
// order), widened to f32 once its copies have landed: the barrier that
// starts the chunk's walk then shows them to the block.
__device__ __forceinline__ void widen_bc(FwdBC& dst, const FwdStage<bf16>& st) {
  constexpr int V = 8, VB = N / V;
  for (int i = threadIdx.x; i < CHUNK * VB; i += FWD_THREADS) {
    const int t = i / VB, k = (i % VB) * V;
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&st.B[t][k + j]));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&st.C[t][k + j]));
      *reinterpret_cast<float2*>(&dst.B[t][k + j]) = b;
      *reinterpret_cast<float2*>(&dst.C[t][k + j]) = c;
    }
  }
}
__device__ __forceinline__ void widen_bc(FwdBC&, const FwdStage<float>&) {}

// the f32 B and C rows the walk of a chunk reads: f32 I/O's as staged
__device__ __forceinline__ const FwdBC& walk_bc(const FwdBC& bc, const FwdStage<bf16>&) {
  return bc;
}
__device__ __forceinline__ const FwdBC& walk_bc(const FwdBC&, const FwdStage<float>& st) {
  return *reinterpret_cast<const FwdBC*>(&st.B[0][0]);
}

// this thread's FWD_NS values of an f32 row of N
__device__ __forceinline__ void load_states(float (&v)[FWD_NS], const float* p) {
#pragma unroll
  for (int i = 0; i < FWD_NS; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
  }
}

// One chunk's y (rows [0, len) of src) into channels [ch0, ch0 + FWD_TD) of
// rows of D values, nothing past len or D: 16-byte stores where D is a
// multiple of a vector.
template <typename T>
__device__ __forceinline__ void store_y(T* __restrict__ y, const T (*src)[FWD_TD], size_t row0,
                                        int len, int D, int ch0) {
  constexpr int V = 16 / int(sizeof(T)), VR = FWD_TD / V;
  if (D % V == 0) {
    for (int i = threadIdx.x; i < len * VR; i += FWD_THREADS) {
      const int t = i / VR, c = (i % VR) * V;
      if (ch0 + c < D)
        *reinterpret_cast<uint4*>(y + (row0 + t) * D + ch0 + c) =
            *reinterpret_cast<const uint4*>(&src[t][c]);
    }
  } else {
    for (int i = threadIdx.x; i < len * FWD_TD; i += FWD_THREADS) {
      const int t = i / FWD_TD, c = i % FWD_TD;
      if (ch0 + c < D) y[(row0 + t) * D + ch0 + c] = src[t][c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, 3)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta, const float* __restrict__ A,
                const T* __restrict__ B, const T* __restrict__ C, T* __restrict__ y,
                float* __restrict__ bounds, int L, int D, int ld, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<T>& s = *reinterpret_cast<FwdSmem<T>*>(smem_raw);
  const int tid = threadIdx.x, q = tid % FWD_LPC, cl = tid / FWD_LPC;
  const int ch0 = blockIdx.x * FWD_TD, ch = ch0 + cl, bi = blockIdx.y;
  const bool active = ch < D;
  const int nc = (L + CHUNK - 1) / CHUNK;
  float a[FWD_NS], h[FWD_NS];
#pragma unroll
  for (int i = 0; i < FWD_NS; ++i) {
    const int k = q * FWD_NS + i;
    a[i] = (active && k < n) ? A[size_t(ch) * n + k] * LOG2E : 0.f;
    h[i] = 0.f;
  }
  stage_chunk(s.in[0], u, delta, B, C, size_t(bi) * L, min(CHUNK, L), ld, ch0);
  ptt::cp_async_wait<0>();
  widen_bc(s.bc[0], s.in[0]);
  for (int c = 0; c < nc; ++c) {
    const size_t row0 = size_t(bi) * L + c * CHUNK;
    if (active) {                          // the state entering chunk c
      float* dst = bounds + (size_t(bi) * nc + c) * n * D + ch;
#pragma unroll
      for (int i = 0; i < FWD_NS; ++i)
        if (q * FWD_NS + i < n) dst[size_t(q * FWD_NS + i) * D] = h[i];
    }
    __syncthreads();   // chunk c staged and widened; every thread is done with chunk c - 1
    if (c + 1 < nc)
      stage_chunk(s.in[(c + 1) & 1], u, delta, B, C, row0 + CHUNK, min(CHUNK, L - (c + 1) * CHUNK),
                  ld, ch0);
    if (c > 0) store_y(y, s.y[(c - 1) & 1], row0 - CHUNK, CHUNK, D, ch0);
    // the walk reads shared memory only; steps past the sequence end were
    // staged as zeros (delta 0: h stays as it is; C 0: y 0, not stored)
    const FwdStage<T>& st = s.in[c & 1];
    const FwdBC& bc = walk_bc(s.bc[c & 1], st);
    T (*yc)[FWD_TD] = s.y[c & 1];
#pragma unroll 4
    for (int t = 0; t < CHUNK; ++t) {
      const float dt = to_f(st.delta[t][cl]), dtu = dt * to_f(st.u[t][cl]);
      float bv[FWD_NS], cv[FWD_NS];
      load_states(bv, &bc.B[t][q * FWD_NS]);
      load_states(cv, &bc.C[t][q * FWD_NS]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < FWD_NS; ++i) {
        h[i] = fmaf(ex2_approx(dt * a[i]), h[i], dtu * bv[i]);
        acc = fmaf(cv[i], h[i], acc);
      }
#pragma unroll
      for (int o = 1; o < FWD_LPC; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (q == 0) yc[t][cl] = from_f<T>(acc);
    }
    if (c + 1 < nc) {      // chunk c + 1 landed: its B and C widened for its walk
      ptt::cp_async_wait<0>();
      widen_bc(s.bc[(c + 1) & 1], s.in[(c + 1) & 1]);
    }
  }
  __syncthreads();
  store_y(y, s.y[(nc - 1) & 1], size_t(bi) * L + (nc - 1) * CHUNK, L - (nc - 1) * CHUNK, D, ch0);
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
               void* y, void* bounds, int batch, int L, int D, int ld, int n, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const int smem = int(sizeof(FwdSmem<T>));
  cudaError_t err = ptt::allow_smem(scan_fwd_kernel<T>, smem, done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((D + FWD_TD - 1) / FWD_TD, batch);
  scan_fwd_kernel<T><<<grid, FWD_THREADS, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(bounds), L, D, ld, n);
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

// u, delta [batch, L, ld] (channels [0, D) used; ld * the value size a
// multiple of 16 bytes), B, C [batch, L, 16] (states [0, n) used; the rest
// zero), y [batch, L, D]; f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous and
// 16-byte aligned. A [D, n] f32. bounds [batch, ceil(L/64), n, D] f32: the
// state entering each chunk of 64 steps. Needs 1 <= n <= 16. Returns
// cudaGetLastError() after the launch.
int ptt_selective_scan_fwd(const void* u, const void* delta, const void* A, const void* B,
                           const void* C, void* y, void* bounds, int batch, int L, int D, int ld,
                           int n, int bf16_io, void* stream) {
  if (bad_shape(batch, L, D, n) || ld < D || ld % (bf16_io ? 8 : 4) != 0)
    return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch_fwd<bf16>(u, delta, A, B, C, y, bounds, batch, L, D, ld, n, st)
                 : launch_fwd<float>(u, delta, A, B, C, y, bounds, batch, L, D, ld, n, st);
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
