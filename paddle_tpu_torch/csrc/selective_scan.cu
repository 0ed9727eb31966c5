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
// Design (simple first): one thread per (b, channel) holds the n <= 16
// states in registers and walks the sequence; a block is 64 channels of one
// batch row. B_t and C_t (shared by every channel) are staged in shared
// memory a chunk of 64 steps at a time; u, delta (and dy) come into
// registers 8 steps at a time, their loads in flight together, so the walk
// does not wait on memory at every step. The forward writes y and the state
// entering every chunk of 64 steps, [b, ceil(l/64), n, d] f32 (the Pallas
// design's residual, 25 MB per layer at b16 l1024 d1536 n16, where the whole
// history would be 1.6 GB).
// The backward walks the chunks in reverse. In each, it replays h from the
// saved state, keeping the state entering each sub-chunk of 8 steps in
// shared memory; then, sub-chunk by sub-chunk in reverse, it replays the 8
// states into shared memory and walks them backwards carrying
// g = exp(delta_{t+1} A) dh_{t+1} in registers. du and ddelta are stored per
// step; dA accumulates in registers per (b, channel) and is written as a
// [b, d, n] partial; dB and dC (sums over channels) are reduced across the
// warp by a reduce-scatter (lane L ends with value L of the 32), the two
// warps' sums added in shared memory and written as [d/64, b, l, n]
// partials. The partials are summed afterwards in a fixed order: no atomics,
// the result is the same on every run.

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

// One round of a warp reduce-scatter of 32 values: the lanes whose bit O is
// set keep the upper O of the 2 O values still held, the others the lower,
// each adding its partner's copy (O a constant, so `v` stays in registers).
template <int O>
__device__ __forceinline__ void scatter_round(float (&v)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

struct BwdSmem {
  float B[CHUNK][N], C[CHUNK][N];
  float start[NSUB][N][THREADS];   // state entering each sub-chunk
  float hist[SUB][N][THREADS];     // h_t of the sub-chunk being walked
  float red[WARPS][SUB][32];       // per-warp sums of dB (0..15) and dC (16..31)
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta, const float* __restrict__ A,
                const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ bounds, const T* __restrict__ dy, T* __restrict__ du,
                T* __restrict__ ddelta, float* __restrict__ dA_part, float* __restrict__ dB_part,
                float* __restrict__ dC_part, int batch, int L, int D, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int bi = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ch = tile * THREADS + tid;
  const bool active = ch < D;
  const int nc = (L + CHUNK - 1) / CHUNK;
  float a[N], g[N], dA[N], h[N], h0[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a[k] = (active && k < n) ? A[size_t(ch) * n + k] * LOG2E : 0.f;
    g[k] = 0.f;
    dA[k] = 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CHUNK;
    const int len = min(CHUNK, L - t0);
    const size_t row0 = size_t(bi) * L + t0;
    __syncthreads();                       // the previous chunk is done with smem
    stage_bc(s.B, s.C, B, C, row0, len, n);
    __syncthreads();
    // replay the chunk from its saved state, keeping each sub-chunk's start
    const float* src = bounds + (size_t(bi) * nc + c) * n * D + ch;
#pragma unroll
    for (int k = 0; k < N; ++k) h[k] = (active && k < n) ? src[size_t(k) * D] : 0.f;
    const int nsub = (len + SUB - 1) / SUB;
    for (int sb = 0; sb < nsub; ++sb) {
      const int j0 = sb * SUB;
#pragma unroll
      for (int k = 0; k < N; ++k) s.start[sb][k][tid] = h[k];
      float dts[SUB], us[SUB];
      load_steps(dts, delta, row0, j0, len, D, ch, active);
      load_steps(us, u, row0, j0, len, D, ch, active);
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j0 + j >= len) break;
        const float dtu = dts[j] * us[j];
#pragma unroll
        for (int k = 0; k < N; ++k) h[k] = exp2f(dts[j] * a[k]) * h[k] + dtu * s.B[j0 + j][k];
      }
    }
    for (int sb = nsub - 1; sb >= 0; --sb) {
      const int j0 = sb * SUB;
      const int slen = min(SUB, len - j0);
      float dts[SUB], us[SUB], dys[SUB];
      load_steps(dts, delta, row0, j0, len, D, ch, active);
      load_steps(us, u, row0, j0, len, D, ch, active);
      load_steps(dys, dy, row0, j0, len, D, ch, active);
      // replay the sub-chunk, keeping every h_t
#pragma unroll
      for (int k = 0; k < N; ++k) {
        h0[k] = s.start[sb][k][tid];
        h[k] = h0[k];
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        if (j >= slen) break;
        const float dtu = dts[j] * us[j];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          h[k] = exp2f(dts[j] * a[k]) * h[k] + dtu * s.B[j0 + j][k];
          s.hist[j][k][tid] = h[k];
        }
      }
      // walk it backwards
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        if (j >= slen) continue;
        const int t = j0 + j;
        const float dt = dts[j], uu = us[j], dyv = dys[j];
        const float dtu = dt * uu;
        float s1 = 0.f, s2 = 0.f;
        float vals[32];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float da = exp2f(dt * a[k]);
          const float dh = g[k] + s.C[t][k] * dyv;
          const float hp = j > 0 ? s.hist[j - 1][k][tid] : h0[k];
          const float common = dh * hp * da;
          s1 += common * a[k];
          s2 += dh * s.B[t][k];
          dA[k] += common * dt;
          vals[k] = dh * dtu;                       // dB_t (this channel's share)
          vals[N + k] = s.hist[j][k][tid] * dyv;    // dC_t
          g[k] = da * dh;
        }
        if (active) {
          const size_t off = (row0 + t) * D + ch;
          du[off] = from_f<T>(dt * s2);
          ddelta[off] = from_f<T>(s1 * LN2 + s2 * uu);   // a = A log2(e)
        }
        // reduce-scatter over the warp: lane L ends with the sum of vals[L]
        scatter_round<16>(vals, lane);
        scatter_round<8>(vals, lane);
        scatter_round<4>(vals, lane);
        scatter_round<2>(vals, lane);
        scatter_round<1>(vals, lane);
        s.red[warp][j][lane] = vals[0];
      }
      __syncthreads();
      for (int i = tid; i < SUB * 32; i += THREADS) {
        const int j = i / 32, x = i % 32, k = x % N;
        if (j < slen && k < n) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += s.red[w][j][x];
          float* dst = x < N ? dB_part : dC_part;
          dst[((size_t(tile) * batch + bi) * L + t0 + j0 + j) * n + k] = sum;
        }
      }
      __syncthreads();                     // red and hist are reused
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) dA_part[(size_t(bi) * D + ch) * n + k] = dA[k];
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
               void* dB_part, void* dC_part, int batch, int L, int D, int n, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const int smem = int(sizeof(BwdSmem));
  cudaError_t err = ptt::allow_smem(scan_bwd_kernel<T>, smem, done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((D + THREADS - 1) / THREADS, batch);
  scan_bwd_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(bounds),
      static_cast<const T*>(dy), static_cast<T*>(du), static_cast<T*>(ddelta),
      static_cast<float*>(dA_part), static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      batch, L, D, n);
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

// The backward of ptt_selective_scan_fwd from its bounds and dy [batch, L,
// D] (the type of u). Writes du, ddelta [batch, L, D] (the type of u),
// dA_part [batch, D, n], dB_part and dC_part [ceil(D/64), batch, L, n], all
// f32 partials that the caller sums over their first axis.
int ptt_selective_scan_bwd(const void* u, const void* delta, const void* A, const void* B,
                           const void* C, const void* bounds, const void* dy, void* du,
                           void* ddelta, void* dA_part, void* dB_part, void* dC_part, int batch,
                           int L, int D, int n, int bf16_io, void* stream) {
  if (bad_shape(batch, L, D, n)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch_bwd<bf16>(u, delta, A, B, C, bounds, dy, du, ddelta, dA_part, dB_part,
                                    dC_part, batch, L, D, n, st)
                 : launch_bwd<float>(u, delta, A, B, C, bounds, dy, du, ddelta, dA_part,
                                     dB_part, dC_part, batch, L, D, n, st);
}

}  // extern "C"
