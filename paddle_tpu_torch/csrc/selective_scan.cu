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
// The log-depth variant of both (`logdepth=True`, FLAGS_mamba_logdepth_scan:
// `_replay_h`'s Hillis-Steele scan, :57-98, and the backward's suffix scan,
// :148-170) is the second pair of kernels, described above them.
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
//   them at every step, and sums B_t . C_t in double for each step. The
//   walk reads shared memory only, and a chunk needs one barrier.
// - y_t = C_t . (exp(delta_t A) h_{t-1}) + delta_t u_t (B_t . C_t): the
//   carried state's share summed by the lanes in f32, the step's own share
//   from the exact dot. Where B_t . C_t cancels (at t = 0, h_{-1} = 0, it is
//   all of y) an f32 sum of the rounded terms h_t C_t would lie far from
//   y_t against max |y|; the plain f32 version's does. Steps past l walk on zeros (delta 0: the state stays
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
#include <type_traits>

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
  float bcdot[2][CHUNK];    // chunk c's B_t . C_t in bcdot[c % 2]
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

// B_t . C_t for each step of a chunk, from the vectors this thread staged
// (stage_chunk's order) once they have landed: the products exact in
// double, the row's parts (adjacent lanes) added by shuffles, rounded to
// f32 once. y_t's share from step t's own input is delta_t u_t (B_t . C_t),
// and that sum over the states can cancel: an f32 sum of rounded terms
// would then lie far from y_t against max |y|.
template <typename T>
__device__ __forceinline__ void dot_bc(float* dst, const FwdStage<T>& st) {
  constexpr int V = 16 / int(sizeof(T)), VB = N / V;
  for (int i = threadIdx.x; i < CHUNK * VB; i += FWD_THREADS) {
    const int t = i / VB, k = (i % VB) * V;
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < V; ++j)
      sum = fma(double(to_f(st.B[t][k + j])), double(to_f(st.C[t][k + j])), sum);
#pragma unroll
    for (int o = 1; o < VB; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (i % VB == 0) dst[t] = float(sum);
  }
}

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
  dot_bc(s.bcdot[0], s.in[0]);
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
    const float* bcdot = s.bcdot[c & 1];
    T (*yc)[FWD_TD] = s.y[c & 1];
#pragma unroll 4
    for (int t = 0; t < CHUNK; ++t) {
      const float dt = to_f(st.delta[t][cl]), dtu = dt * to_f(st.u[t][cl]);
      float bv[FWD_NS], cv[FWD_NS];
      load_states(bv, &bc.B[t][q * FWD_NS]);
      load_states(cv, &bc.C[t][q * FWD_NS]);
      // y_t = C_t . (exp(dt A) h_{t-1}) + dtu (B_t . C_t): the carried
      // state's share here, the step's own from the chunk's exact dots
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < FWD_NS; ++i) {
        const float carried = ex2_approx(dt * a[i]) * h[i];
        h[i] = fmaf(dtu, bv[i], carried);
        acc = fmaf(cv[i], carried, acc);
      }
#pragma unroll
      for (int o = 1; o < FWD_LPC; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (q == 0) yc[t][cl] = from_f<T>(fmaf(dtu, bcdot[t], acc));
    }
    if (c + 1 < nc) {      // chunk c + 1 landed: its B and C widened for its walk
      ptt::cp_async_wait<0>();
      widen_bc(s.bc[(c + 1) & 1], s.in[(c + 1) & 1]);
      dot_bc(s.bcdot[(c + 1) & 1], s.in[(c + 1) & 1]);
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
  float bcdot[CHUNK];                   // B_t . C_t
};

// B_t . C_t of row `row` of [b l, n] B and C, the products exact in double,
// rounded to f32 once (see dot_bc)
template <typename T>
__device__ __forceinline__ float row_dot(const T* __restrict__ B, const T* __restrict__ C,
                                         size_t row, int n) {
  double sum = 0.0;
  for (int k = 0; k < n; ++k)
    sum = fma(double(to_f(B[row * n + k])), double(to_f(C[row * n + k])), sum);
  return float(sum);
}

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
  for (int t = tid; t < CHUNK; t += BWD_THREADS)
    s.bcdot[t] = t < len ? row_dot(B, C, row0 + t, n) : 0.f;
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
          s2 = fmaf(g[i], s.B[t][k], s2);       // the carried gradient's share
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
        // B_t . dh_t = dy_t (B_t . C_t) + B_t . g: the step's own share from
        // the exact dot, as y_t's in the forward
        s2 = fmaf(dyv, s.bcdot[t], s2);
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

// ------------------------------------------------------------- log-depth
// The log-depth variant of both kernels (FLAGS_mamba_logdepth_scan):
// `_replay_h(logdepth=True)` and the suffix branch of `_bwd_kernel`
// (paddle_tpu/ops/pallas/selective_scan.py:57-98, :148-170). The sequence
// is cut into spans of S steps (S = 8, 16, 32 or 64: JAX's chunk), and
// inside a span the recurrence runs as an inclusive scan of the pairs
// (a_t, b_t) = (exp(delta_t A), delta_t B_t u_t) instead of a walk:
// - forward: the state entering the span is folded into step 0 (b_0 +=
//   a_0 h_in), then h_t = a_t h_{t-1} + b_t by Hillis-Steele rounds, and the
//   last step's h enters the next span;
// - backward: the span's states replayed so from its saved entering state,
//   then dh_t = C_t dy_t + a_{t+1} dh_{t+1} as a suffix scan with the
//   carry from the span to the right on the last step; the carry to the
//   left is a_0 dh_0.
// The epilogues are the sequential kernels': y_t = C_t . (a_t h_{t-1}) +
// delta_t u_t (B_t . C_t), and du, ddelta, dB, dC, dA from dh_t, h_{t-1}
// and the step's carried gradient a_{t+1} dh_{t+1}, B_t . dh_t's own share
// from the exact dot.
// Layout: lanes run along time, one step a lane, each lane holding all N
// states of one channel; a segment of S lanes scans one channel's span in
// log2(S) rounds of __shfl_up_sync (__shfl_down_sync for the suffix). A
// span of 64 is two warps: each scans its 32 steps, then warp 1 folds in
// warp 0's last state (the suffix: warp 0 folds in warp 1's first dh)
// through shared memory. A block of 256 threads is 256 / S segments and
// walks 64 channels of one batch row, S / 4 channel groups a span, and the
// spans in order (the backward from the last); u, delta (dy), B and C of
// a span are staged in shared memory by rows first. dB and dC (sums over
// channels) go to the block's partial through shared memory in a fixed
// order, dA stays in shared memory until the end: no atomics, the same
// result on every run.
// What bounds it: like the sequential kernels, the instructions (log2 S
// rounds of two shuffles and two multiplies a state, against one FMA a
// state in the walk) beside one exponential per (b, t, d, n) forward and
// two backward; the bytes are the sequential kernels'.
constexpr int LD_THREADS = 256;
constexpr int LD_TILE = 64;                      // channels a block
constexpr unsigned FULL = 0xffffffffu;

template <int S>
struct LdGeom {
  static constexpr int W = S < 32 ? S : 32;      // lanes of a warp's scan
  static constexpr int G = LD_THREADS / S;       // segments (channels) a group
  static constexpr int GROUPS = LD_TILE / G;     // channel groups a span
  static_assert(S == 8 || S == 16 || S == 32 || S == 64, "span");
};

template <typename T, int S>
struct LdFwdSmem {
  T u[S][LD_TILE + 1], delta[S][LD_TILE + 1], y[S][LD_TILE + 1];
  float B[S][N + 1], C[S][N + 1];
  float bcdot[S];
  float A2[LD_TILE][N + 1];                      // A log2(e)
  float h[LD_TILE][N + 1];                       // the state entering the span
  float x[2][LdGeom<S>::G][N];                   // S = 64: h_31, by group parity
};

template <typename T, int S>
struct LdBwdSmem {
  T u[S][LD_TILE + 1], delta[S][LD_TILE + 1], dy[S][LD_TILE + 1];   // u and delta
                                                                    // become du, ddelta
  float B[S][N + 1], C[S][N + 1];
  float bcdot[S];
  float A2[LD_TILE][N + 1];
  float g[LD_TILE][N + 1];                       // the carry from the span to the right
  float dA[LD_TILE][N + 1];
  float red[LD_THREADS][2 * N + 1];              // each lane's dB_t, dC_t shares
  float acc[S][2 * N];                           // the block's dB (0..N), dC (N..2N)
  float x[4][LdGeom<S>::G][N];                   // S = 64: h_31, a_32, dh_32, warp 1's dA
};

// rows [0, len) of one span of a [b, l, D] tensor, channels [ch0, ch0 +
// LD_TILE), into dst as they are; zero past len and D
template <typename T, int S>
__device__ __forceinline__ void ld_stage_cols(T (*dst)[LD_TILE + 1], const T* __restrict__ src,
                                              size_t row0, int len, int D, int ch0) {
  for (int i = threadIdx.x; i < S * LD_TILE; i += LD_THREADS) {
    const int t = i / LD_TILE, c = i % LD_TILE;
    dst[t][c] = (t < len && ch0 + c < D) ? src[(row0 + t) * D + ch0 + c] : from_f<T>(0.f);
  }
}

template <typename T, int S>
__device__ __forceinline__ void ld_store_cols(T* __restrict__ dst, const T (*src)[LD_TILE + 1],
                                              size_t row0, int len, int D, int ch0) {
  for (int i = threadIdx.x; i < len * LD_TILE; i += LD_THREADS) {
    const int t = i / LD_TILE, c = i % LD_TILE;
    if (ch0 + c < D) dst[(row0 + t) * D + ch0 + c] = src[t][c];
  }
}

// rows [0, len) of one span of a [b, l, n] tensor into dst as f32, zero past
// len and n; B_t . C_t of each row (row_dot) into bcdot
template <typename T, int S>
__device__ __forceinline__ void ld_stage_bc(float (*dB)[N + 1], float (*dC)[N + 1], float* bcdot,
                                            const T* __restrict__ B, const T* __restrict__ C,
                                            size_t row0, int len, int n) {
  for (int i = threadIdx.x; i < S * N; i += LD_THREADS) {
    const int t = i / N, k = i % N;
    const bool ok = t < len && k < n;
    dB[t][k] = ok ? to_f(B[(row0 + t) * n + k]) : 0.f;
    dC[t][k] = ok ? to_f(C[(row0 + t) * n + k]) : 0.f;
  }
  for (int t = threadIdx.x; t < S; t += LD_THREADS)
    bcdot[t] = t < len ? row_dot(B, C, row0 + t, n) : 0.f;
}

// A log2(e) of this block's channels, zero past D and n
__device__ __forceinline__ void ld_stage_a(float (*A2)[N + 1], const float* __restrict__ A, int D,
                                           int n, int ch0) {
  for (int i = threadIdx.x; i < LD_TILE * N; i += LD_THREADS) {
    const int c = i / N, k = i % N;
    A2[c][k] = (ch0 + c < D && k < n) ? A[size_t(ch0 + c) * n + k] * LOG2E : 0.f;
  }
}

// The forward replay of one lane's step t of a span: a0 = exp(delta_t A),
// h_t by the inclusive scan (the state entering the span, hp on lane 0,
// folded into step 0), and hp = h_{t-1}. `xh` is shared-memory room for N
// values of this segment (S = 64: warp 0's last state).
template <int S>
__device__ __forceinline__ void ld_replay(float (&a0)[N], float (&h)[N], float (&hp)[N],
                                          const float* A2, const float* Bt, float dt, float dtu,
                                          int t, float* xh) {
  constexpr int W = LdGeom<S>::W;
  const int tw = t % W;
  float a[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a0[k] = ex2_approx(dt * A2[k]);
    a[k] = a0[k];
    h[k] = dtu * Bt[k];
    if (t == 0) h[k] = fmaf(a0[k], hp[k], h[k]);
  }
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float au = __shfl_up_sync(FULL, a[k], off);
      const float hu = __shfl_up_sync(FULL, h[k], off);
      if (tw >= off) {
        h[k] = fmaf(a[k], hu, h[k]);
        a[k] *= au;
      }
    }
  }
  if constexpr (S == 64) {
    if (t == 31) {
#pragma unroll
      for (int k = 0; k < N; ++k) xh[k] = h[k];
    }
    __syncthreads();
    if (t >= 32) {
#pragma unroll
      for (int k = 0; k < N; ++k) h[k] = fmaf(a[k], xh[k], h[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float up = __shfl_up_sync(FULL, h[k], 1);
    if (t != 0) hp[k] = (S == 64 && t == 32) ? xh[k] : up;
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(LD_THREADS)
scan_ld_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                   const float* __restrict__ A, const T* __restrict__ B, const T* __restrict__ C,
                   T* __restrict__ y, float* __restrict__ bounds, int L, int D, int n) {
  using Gm = LdGeom<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LdFwdSmem<T, S>& s = *reinterpret_cast<LdFwdSmem<T, S>*>(smem_raw);
  const int tid = threadIdx.x, t = tid % S, seg = tid / S;
  const int ch0 = blockIdx.x * LD_TILE, bi = blockIdx.y;
  const int nc = (L + S - 1) / S;
  ld_stage_a(s.A2, A, D, n, ch0);
  for (int i = tid; i < LD_TILE * N; i += LD_THREADS) s.h[i / N][i % N] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int len = min(S, L - c * S);
    const size_t row0 = size_t(bi) * L + size_t(c) * S;
    __syncthreads();                       // span c - 1's y is out, its states in place
    ld_stage_cols<T, S>(s.u, u, row0, len, D, ch0);
    ld_stage_cols<T, S>(s.delta, delta, row0, len, D, ch0);
    ld_stage_bc<T, S>(s.B, s.C, s.bcdot, B, C, row0, len, n);
    for (int i = tid; i < n * LD_TILE; i += LD_THREADS) {     // the state entering span c
      const int k = i / LD_TILE, cl = i % LD_TILE;
      if (ch0 + cl < D) bounds[((size_t(bi) * nc + c) * n + k) * D + ch0 + cl] = s.h[cl][k];
    }
    __syncthreads();
    for (int gr = 0; gr < Gm::GROUPS; ++gr) {
      const int cl = gr * Gm::G + seg;
      const float dt = to_f(s.delta[t][cl]), dtu = dt * to_f(s.u[t][cl]);
      float a0[N], h[N], hp[N];
#pragma unroll
      for (int k = 0; k < N; ++k) hp[k] = t == 0 ? s.h[cl][k] : 0.f;
      ld_replay<S>(a0, h, hp, s.A2[cl], s.B[t], dt, dtu, t, s.x[gr & 1][seg]);
      // y_t = C_t . (a_t h_{t-1}) + dtu (B_t . C_t)
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) acc = fmaf(s.C[t][k], a0[k] * hp[k], acc);
      s.y[t][cl] = from_f<T>(fmaf(dtu, s.bcdot[t], acc));
      if (t == S - 1) {                    // the state entering span c + 1
#pragma unroll
        for (int k = 0; k < N; ++k) s.h[cl][k] = h[k];
      }
    }
    __syncthreads();
    ld_store_cols<T, S>(y, s.y, row0, len, D, ch0);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(LD_THREADS)
scan_ld_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                   const float* __restrict__ A, const T* __restrict__ B, const T* __restrict__ C,
                   const float* __restrict__ bounds, const T* __restrict__ dy, T* __restrict__ du,
                   T* __restrict__ ddelta, float* __restrict__ dA_part, float* __restrict__ dB_part,
                   float* __restrict__ dC_part, int batch, int L, int D, int n) {
  using Gm = LdGeom<S>;
  constexpr int W = Gm::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LdBwdSmem<T, S>& s = *reinterpret_cast<LdBwdSmem<T, S>*>(smem_raw);
  const int tid = threadIdx.x, t = tid % S, seg = tid / S, tw = t % W;
  const int tile = blockIdx.x, ch0 = tile * LD_TILE, bi = blockIdx.y;
  const int nc = (L + S - 1) / S;
  ld_stage_a(s.A2, A, D, n, ch0);
  for (int i = tid; i < LD_TILE * N; i += LD_THREADS) {
    s.g[i / N][i % N] = 0.f;
    s.dA[i / N][i % N] = 0.f;
  }
  for (int i = tid; i < S * 2 * N; i += LD_THREADS) (&s.acc[0][0])[i] = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int len = min(S, L - c * S);
    const size_t row0 = size_t(bi) * L + size_t(c) * S;
    __syncthreads();                       // span c + 1's outputs are out
    ld_stage_cols<T, S>(s.u, u, row0, len, D, ch0);
    ld_stage_cols<T, S>(s.delta, delta, row0, len, D, ch0);
    ld_stage_cols<T, S>(s.dy, dy, row0, len, D, ch0);
    ld_stage_bc<T, S>(s.B, s.C, s.bcdot, B, C, row0, len, n);
    __syncthreads();
    for (int gr = 0; gr < Gm::GROUPS; ++gr) {
      const int cl = gr * Gm::G + seg, ch = ch0 + cl;
      const float dt = to_f(s.delta[t][cl]), uv = to_f(s.u[t][cl]), dtu = dt * uv;
      const float dyv = to_f(s.dy[t][cl]);
      float a0[N], h[N], hp[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        hp[k] = (t == 0 && ch < D && k < n) ? bounds[((size_t(bi) * nc + c) * n + k) * D + ch] : 0.f;
      ld_replay<S>(a0, h, hp, s.A2[cl], s.B[t], dt, dtu, t, s.x[0][seg]);
      // the suffix scan: dh_t = s_t + m_t dh_{t+1}, m_t = a_{t+1} (1 past
      // the span), the carry from the right on the last step
      float m0[N], m[N], dh[N];
      if constexpr (S == 64) {
        if (t == 32) {
#pragma unroll
          for (int k = 0; k < N; ++k) s.x[1][seg][k] = a0[k];
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float an = __shfl_down_sync(FULL, a0[k], 1);
        m0[k] = t == S - 1 ? 1.f : (S == 64 && t == 31) ? s.x[1][seg][k] : an;
        m[k] = m0[k];
        dh[k] = s.C[t][k] * dyv;
        if (t == S - 1) dh[k] += s.g[cl][k];
      }
#pragma unroll
      for (int off = 1; off < W; off <<= 1) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float dd = __shfl_down_sync(FULL, dh[k], off);
          const float md = __shfl_down_sync(FULL, m[k], off);
          if (tw + off < W) {
            dh[k] = fmaf(m[k], dd, dh[k]);
            m[k] *= md;
          }
        }
      }
      if constexpr (S == 64) {
        if (t == 32) {
#pragma unroll
          for (int k = 0; k < N; ++k) s.x[2][seg][k] = dh[k];
        }
        __syncthreads();
        if (t < 32) {
#pragma unroll
          for (int k = 0; k < N; ++k) dh[k] = fmaf(m[k], s.x[2][seg][k], dh[k]);
        }
      }
      // the epilogue, with the step's carried gradient m0 dh_{t+1}
      float s1 = 0.f, s2 = 0.f, dAl[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float dn = __shfl_down_sync(FULL, dh[k], 1);
        const float carried = t == S - 1 ? s.g[cl][k]
                              : m0[k] * ((S == 64 && t == 31) ? s.x[2][seg][k] : dn);
        const float common = dh[k] * hp[k] * a0[k];
        s1 = fmaf(common, s.A2[cl][k], s1);
        s2 = fmaf(carried, s.B[t][k], s2);
        dAl[k] = common * dt;
        s.red[tid][k] = dh[k] * dtu;                // dB_t, this channel's share
        s.red[tid][N + k] = h[k] * dyv;             // dC_t
      }
      s2 = fmaf(dyv, s.bcdot[t], s2);               // B_t . dh_t
      s.u[t][cl] = from_f<T>(dt * s2);
      s.delta[t][cl] = from_f<T>(fmaf(s1, LN2, s2 * uv));   // A2 = A log2(e)
      // dA: the segment's sum over its steps
#pragma unroll
      for (int k = 0; k < N; ++k) {
#pragma unroll
        for (int o = 1; o < W; o <<= 1) dAl[k] += __shfl_xor_sync(FULL, dAl[k], o);
      }
      if constexpr (S == 64) {
        if (t == 32) {
#pragma unroll
          for (int k = 0; k < N; ++k) s.x[3][seg][k] = dAl[k];
        }
      }
      __syncthreads();                     // red is complete; x[3] is in place
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          s.dA[cl][k] += S == 64 ? dAl[k] + s.x[3][seg][k] : dAl[k];
          s.g[cl][k] = a0[k] * dh[k];      // the carry into span c - 1
        }
      }
      for (int i = tid; i < S * 2 * N; i += LD_THREADS) {
        const int tt = i / (2 * N), xx = i % (2 * N);
        float sum = 0.f;
#pragma unroll
        for (int sg = 0; sg < Gm::G; ++sg) sum += s.red[sg * S + tt][xx];
        s.acc[tt][xx] += sum;
      }
      __syncthreads();                     // red, x are reused by the next group
    }
    ld_store_cols<T, S>(du, s.u, row0, len, D, ch0);
    ld_store_cols<T, S>(ddelta, s.delta, row0, len, D, ch0);
    for (int i = tid; i < S * 2 * N; i += LD_THREADS) {
      const int tt = i / (2 * N), xx = i % (2 * N), k = xx % N;
      if (tt < len && k < n) {
        float* dst = xx < N ? dB_part : dC_part;
        dst[((size_t(tile) * batch + bi) * L + size_t(c) * S + tt) * n + k] = s.acc[tt][xx];
      }
      s.acc[tt][xx] = 0.f;
    }
  }
  __syncthreads();
  for (int i = tid; i < LD_TILE * n; i += LD_THREADS) {
    const int cl = i / n, k = i % n;
    if (ch0 + cl < D) dA_part[(size_t(bi) * D + ch0 + cl) * n + k] = s.dA[cl][k];
  }
}

template <typename T, int S>
int launch_ld_fwd(const void* u, const void* delta, const void* A, const void* B, const void* C,
                  void* y, void* bounds, int batch, int L, int D, int n, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const int smem = int(sizeof(LdFwdSmem<T, S>));
  cudaError_t err = ptt::allow_smem(scan_ld_fwd_kernel<T, S>, smem, done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((D + LD_TILE - 1) / LD_TILE, batch);
  scan_ld_fwd_kernel<T, S><<<grid, LD_THREADS, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(bounds), L, D, n);
  return int(cudaGetLastError());
}

template <typename T, int S>
int launch_ld_bwd(const void* u, const void* delta, const void* A, const void* B, const void* C,
                  const void* bounds, const void* dy, void* du, void* ddelta, void* dA_part,
                  void* dB_part, void* dC_part, int batch, int L, int D, int n, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const int smem = int(sizeof(LdBwdSmem<T, S>));
  cudaError_t err = ptt::allow_smem(scan_ld_bwd_kernel<T, S>, smem, done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((D + LD_TILE - 1) / LD_TILE, batch);
  scan_ld_bwd_kernel<T, S><<<grid, LD_THREADS, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(bounds),
      static_cast<const T*>(dy), static_cast<T*>(du), static_cast<T*>(ddelta),
      static_cast<float*>(dA_part), static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      batch, L, D, n);
  return int(cudaGetLastError());
}

// one of the four spans, as the template argument
template <typename F>
int by_span(int span, F&& f) {
  switch (span) {
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    default: return int(cudaErrorInvalidValue);
  }
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


// The log-depth variant (FLAGS_mamba_logdepth_scan) over spans of `span`
// steps (8, 16, 32 or 64): u, delta, y [batch, L, D] in the I/O type, B, C
// [batch, L, n], A [D, n] f32, bounds [batch, ceil(L / span), n, D] f32 (the
// state entering each span). One launch each way. The backward writes du,
// ddelta [batch, L, D] and f32 partials that the caller sums over their
// first axis: dA_part [batch, D, n], dB_part and dC_part [ceil(D /
// ptt_selective_scan_logdepth_channels()), batch, L, n].
int ptt_selective_scan_logdepth_fwd(const void* u, const void* delta, const void* A,
                                    const void* B, const void* C, void* y, void* bounds,
                                    int batch, int L, int D, int n, int span, int bf16_io,
                                    void* stream) {
  if (bad_shape(batch, L, D, n)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return by_span(span, [&](auto sp) {
    constexpr int S = decltype(sp)::value;
    return bf16_io ? launch_ld_fwd<bf16, S>(u, delta, A, B, C, y, bounds, batch, L, D, n, st)
                   : launch_ld_fwd<float, S>(u, delta, A, B, C, y, bounds, batch, L, D, n, st);
  });
}

int ptt_selective_scan_logdepth_channels() { return LD_TILE; }

int ptt_selective_scan_logdepth_bwd(const void* u, const void* delta, const void* A,
                                    const void* B, const void* C, const void* bounds,
                                    const void* dy, void* du, void* ddelta, void* dA_part,
                                    void* dB_part, void* dC_part, int batch, int L, int D, int n,
                                    int span, int bf16_io, void* stream) {
  if (bad_shape(batch, L, D, n)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return by_span(span, [&](auto sp) {
    constexpr int S = decltype(sp)::value;
    return bf16_io ? launch_ld_bwd<bf16, S>(u, delta, A, B, C, bounds, dy, du, ddelta, dA_part,
                                            dB_part, dC_part, batch, L, D, n, st)
                   : launch_ld_bwd<float, S>(u, delta, A, B, C, bounds, dy, du, ddelta,
                                             dA_part, dB_part, dC_part, batch, L, D, n, st);
  });
}

}  // extern "C"
