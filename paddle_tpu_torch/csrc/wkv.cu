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
// d64, bf16): at the tensor cores' rate the Pallas kernel's chunked matrix
// form, 2 b h l (c + 2d) d operations forward, takes a fraction of the time
// needed to read r, k, v and write y. This kernel does not take the matrix
// form (the TPU's sub-chunk factoring exists for its MXU): it runs the
// recurrence as it is written, 4 d² FMAs per step and head, on the CUDA
// cores.
//
// Design (simple first): one block per (b, head). Forward: thread j owns
// column j of S, d/64 threads a column when d = 128 (64 rows each, their
// partial outputs added by a shuffle); r, k, v of 2048 / d steps at a time
// are staged in shared memory (the loads in flight together) and read as
// broadcasts. w = 0 (logw at its
// -1e10 floor) is exact and harmless: nothing divides by w.
// Backward: three roles, one block each per (b, head), launched together:
//  - role 0 walks forward with thread i owning row i of S and of
//    Dw = dS/dw_i (forward-mode: Dw_t = S_{t-1} + w Dw_{t-1}), which gives
//    dr_t[i] = (S_{t-1} + u_i k_t[i] v_t) . dy_t,
//    dw_i = Σ_t r_t[i] (Dw_{t-1}[i] . dy_t) and du_i = Σ_t r_t[i] k_t[i] (v_t . dy_t);
//  - role 1 walks backward with thread i owning row i of G_t = dL/dS_t
//    (G_{t-1} = diag(w) G_t + r_tᵀ dy_t): dk_t[i] = G_t[i] . v_t + u_i r_t[i] (v_t . dy_t);
//  - role 2 walks backward with thread j owning column j of G:
//    dv_t[j] = G_t[:, j] . k_t + dy_t[j] (r_t . (u k_t)).
// Nothing is saved by the forward beyond its inputs. dlogw = w dw and du
// come out per batch row, [b, h, d] f32, summed afterwards in a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int SEG = 64;        // rows (or columns) of S a thread holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// sum over the SEGS adjacent lanes that share a row or column
template <int SEGS>
__device__ __forceinline__ float seg_sum(float x) {
#pragma unroll
  for (int o = 1; o < SEGS; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// TC steps of COUNT [b, l, h, d] tensors into shared memory as f32, zero
// past the sequence end; eight iterations' loads in flight together
template <int D, int TC, int NT, int COUNT, typename T>
__device__ __forceinline__ void stage(float (*dst)[TC][D], const T* const* src, size_t base,
                                      size_t stride_t, int t0, int len) {
#pragma unroll 8
  for (int it = 0; it < TC * D / NT; ++it) {
    const int x = it * NT + threadIdx.x;
    const int tt = x / D, c = x % D;
    const size_t off = base + size_t(t0 + tt) * stride_t + c;
#pragma unroll
    for (int q = 0; q < COUNT; ++q) dst[q][tt][c] = tt < len ? to_f(src[q][off]) : 0.f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(D * (D / SEG))
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ logw, const float* __restrict__ bonus,
               T* __restrict__ y, int L, int H) {
  constexpr int SEGS = D / SEG, NT = D * SEGS, TC = 2048 / D;
  __shared__ __align__(16) float sbuf[3][TC][D];
  __shared__ __align__(16) float sw[D], su[D];
  const int bi = blockIdx.x / H, hh = blockIdx.x % H;
  const int j = threadIdx.x / SEGS, i0 = (threadIdx.x % SEGS) * SEG;
  for (int x = threadIdx.x; x < D; x += NT) {
    sw[x] = expf(fminf(logw[hh * D + x], 0.f));
    su[x] = bonus[hh * D + x];
  }
  const size_t stride_t = size_t(H) * D;
  const size_t base = size_t(bi) * L * stride_t + size_t(hh) * D;
  const T* srcs[3] = {r, k, v};
  float S[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) S[i] = 0.f;
  for (int t0 = 0; t0 < L; t0 += TC) {
    const int len = min(TC, L - t0);
    __syncthreads();
    stage<D, TC, NT, 3>(sbuf, srcs, base, stride_t, t0, len);
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float vj = sbuf[2][tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < SEG; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sbuf[0][tt][i0 + i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sbuf[1][tt][i0 + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[i0 + i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i0 + i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w}, uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = kk[q] * vj;
          acc[q] += rr[q] * (uu[q] * kv + S[i + q]);
          S[i + q] = S[i + q] * ww[q] + kv;
        }
      }
      const float out = seg_sum<SEGS>((acc[0] + acc[1]) + (acc[2] + acc[3]));
      if (i0 == 0) y[base + size_t(t0 + tt) * stride_t + j] = from_f<T>(out);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(D * (D / SEG))
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ logw, const float* __restrict__ bonus,
               const T* __restrict__ dy, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ dlogw_part, float* __restrict__ du_part,
               int L, int H) {
  constexpr int SEGS = D / SEG, NT = D * SEGS, TC = 2048 / D;
  // r, k, v, dy of TC steps
  __shared__ __align__(16) float sbuf[4][TC][D];
  __shared__ __align__(16) float sw[D], su[D];
  const int role = blockIdx.y;
  const int bi = blockIdx.x / H, hh = blockIdx.x % H;
  const int own = threadIdx.x / SEGS, c0 = (threadIdx.x % SEGS) * SEG;
  for (int x = threadIdx.x; x < D; x += NT) {
    sw[x] = expf(fminf(logw[hh * D + x], 0.f));
    su[x] = bonus[hh * D + x];
  }
  __syncthreads();
  const float w_own = sw[own], u_own = su[own];
  const size_t stride_t = size_t(H) * D;
  const size_t base = size_t(bi) * L * stride_t + size_t(hh) * D;
  const T* srcs[4] = {r, k, v, dy};
  const int nchunks = (L + TC - 1) / TC;
  float X[SEG], Y[SEG];       // role 0: S and Dw rows; roles 1, 2: G row or column
#pragma unroll
  for (int i = 0; i < SEG; ++i) X[i] = Y[i] = 0.f;
  float gw = 0.f, gu = 0.f;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int chunk = role == 0 ? ci : nchunks - 1 - ci;
    const int t0 = chunk * TC;
    const int len = min(TC, L - t0);
    __syncthreads();
    stage<D, TC, NT, 4>(sbuf, srcs, base, stride_t, t0, len);
    __syncthreads();
    for (int step = 0; step < len; ++step) {
      const int tt = role == 0 ? step : len - 1 - step;
      const float* rt = sbuf[0][tt];
      const float* kt = sbuf[1][tt];
      const float* vt = sbuf[2][tt];
      const float* dyt = sbuf[3][tt];
      const size_t out = base + size_t(t0 + tt) * stride_t + own;
      if (role == 0) {
        // row `own` of S_{t-1} and Dw_{t-1}, columns c0 .. c0 + 63
        const float ri = rt[own], ki = kt[own];
        float sdy = 0.f, ddy = 0.f, vdy = 0.f;
#pragma unroll
        for (int c = 0; c < SEG; ++c) {
          const float dyc = dyt[c0 + c], vc = vt[c0 + c];
          sdy += X[c] * dyc;
          ddy += Y[c] * dyc;
          vdy += vc * dyc;
          Y[c] = X[c] + w_own * Y[c];
          X[c] = w_own * X[c] + ki * vc;
        }
        sdy = seg_sum<SEGS>(sdy);
        ddy = seg_sum<SEGS>(ddy);
        vdy = seg_sum<SEGS>(vdy);
        gw += ri * ddy;
        gu += ri * ki * vdy;
        if (c0 == 0) dr[out] = from_f<T>(sdy + u_own * ki * vdy);
      } else if (role == 1) {
        // row `own` of G_t, columns c0 .. c0 + 63
        const float ri = rt[own];
        float gv = 0.f, vdy = 0.f;
#pragma unroll
        for (int c = 0; c < SEG; ++c) {
          const float dyc = dyt[c0 + c], vc = vt[c0 + c];
          gv += X[c] * vc;
          vdy += vc * dyc;
          X[c] = w_own * X[c] + ri * dyc;
        }
        gv = seg_sum<SEGS>(gv);
        vdy = seg_sum<SEGS>(vdy);
        if (c0 == 0) dk[out] = from_f<T>(gv + u_own * ri * vdy);
      } else {
        // column `own` of G_t, rows c0 .. c0 + 63
        const float dyj = dyt[own];
        float gk = 0.f, ruk = 0.f;
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const float ri = rt[c0 + i], ki = kt[c0 + i];
          gk += X[i] * ki;
          ruk += ri * su[c0 + i] * ki;
          X[i] = sw[c0 + i] * X[i] + ri * dyj;
        }
        gk = seg_sum<SEGS>(gk);
        ruk = seg_sum<SEGS>(ruk);
        if (c0 == 0) dv[out] = from_f<T>(gk + ruk * dyj);
      }
    }
  }
  if (role == 0 && c0 == 0) {
    const float lw = logw[hh * D + own];
    const size_t o = (size_t(bi) * H + hh) * D + own;
    dlogw_part[o] = lw < 0.f ? w_own * gw : 0.f;   // the clamp min(logw, 0)
    du_part[o] = gu;
  }
}

template <int D, typename T>
int launch(bool bwd, const void* r, const void* k, const void* v, const void* logw,
           const void* bonus, const void* dy, void* out0, void* out1, void* out2, void* part0,
           void* part1, int batch, int L, int H, cudaStream_t st) {
  constexpr int NT = D * (D / SEG);
  const auto* rr = static_cast<const T*>(r);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* lw = static_cast<const float*>(logw);
  const auto* bu = static_cast<const float*>(bonus);
  if (!bwd) {
    wkv_fwd_kernel<D, T><<<batch * H, NT, 0, st>>>(rr, kk, vv, lw, bu, static_cast<T*>(out0),
                                                   L, H);
  } else {
    wkv_bwd_kernel<D, T><<<dim3(batch * H, 3), NT, 0, st>>>(
        rr, kk, vv, lw, bu, static_cast<const T*>(dy), static_cast<T*>(out0),
        static_cast<T*>(out1), static_cast<T*>(out2), static_cast<float*>(part0),
        static_cast<float*>(part1), L, H);
  }
  return int(cudaGetLastError());
}

int dispatch(bool bwd, const void* r, const void* k, const void* v, const void* logw,
             const void* bonus, const void* dy, void* out0, void* out1, void* out2, void* part0,
             void* part1, int batch, int L, int H, int D, int bf16_io, void* stream) {
  if (batch < 1 || L < 1 || H < 1 || (D != 64 && D != 128) || size_t(batch) * H > 2147483647u)
    return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define PTT_WKV(DD, TT) \
  launch<DD, TT>(bwd, r, k, v, logw, bonus, dy, out0, out1, out2, part0, part1, batch, L, H, st)
  if (D == 64) return bf16_io ? PTT_WKV(64, bf16) : PTT_WKV(64, float);
  return bf16_io ? PTT_WKV(128, bf16) : PTT_WKV(128, float);
#undef PTT_WKV
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r, k, v, y [batch, L, H, D], contiguous, f32 (bf16_io = 0) or bf16 (1);
// logw, bonus [H, D] f32. D is 64 or 128. Returns cudaGetLastError().
int ptt_wkv_fwd(const void* r, const void* k, const void* v, const void* logw, const void* bonus,
                void* y, int batch, int L, int H, int D, int bf16_io, void* stream) {
  return dispatch(false, r, k, v, logw, bonus, nullptr, y, nullptr, nullptr, nullptr, nullptr,
                  batch, L, H, D, bf16_io, stream);
}

// The backward of ptt_wkv_fwd for dy [batch, L, H, D] (the inputs' type):
// dr, dk, dv [batch, L, H, D] (that type), dlogw_part and du_part [batch,
// H, D] f32, per-row partials that the caller sums over the batch.
int ptt_wkv_bwd(const void* r, const void* k, const void* v, const void* logw, const void* bonus,
                const void* dy, void* dr, void* dk, void* dv, void* dlogw_part, void* du_part,
                int batch, int L, int H, int D, int bf16_io, void* stream) {
  return dispatch(true, r, k, v, logw, bonus, dy, dr, dk, dv, dlogw_part, du_part, batch, L, H,
                  D, bf16_io, stream);
}

}  // extern "C"
