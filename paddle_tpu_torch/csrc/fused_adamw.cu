// One AdamW step over flat f32 buffers for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_adamw.py
// `fused_adamw_flat` (pl.pallas_call at :100, body `_kernel` at :39) behind
// the FusedAdamW optimizer (optimizer/fused.py). Same arithmetic, operation
// for operation:
//   m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g g
//   p = p (1 - lr wd) - lr (m / bc1) / (sqrt(v / bc2) + eps)
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t computed on the host in f32.
// p, m and v are updated in place; g is read. Any n: no padding to a tile.
//
// GradScaler's skip: `found_inf` is a device pointer to one int, or null.
// When it points at a non-zero value the step is skipped: each block reads
// the flag once, from the device, and returns before it writes p, m or v.
// The host never syncs for it, so the scaler's flag stays on the device
// from unscale_ to the step (the JAX package keeps the old buffers with a
// select after its kernel, paddle_tpu/optimizer/fused.py:88-94; a select
// after this in-place kernel would first need a copy of p, m and v).
//
// What bounds it on the H100: bytes. Each parameter reads p, g, m and v
// and writes p, m and v, 28 bytes, for about 15 flops: n = 1.07e9 needs
// 9 ms at 3.35 TB/s. The design streams 16-byte vectors (four floats of
// each buffer per thread and step) through a grid-stride loop, enough
// independent loads in flight to cover the memory latency; the last n % 4
// elements go through a scalar tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Scalars {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v, const Scalars& s) {
  m = s.b1 * m + (1.f - s.b1) * g;
  v = s.b2 * v + (1.f - s.b2) * g * g;
  const float mhat = m / s.bc1;
  const float vhat = v / s.bc2;
  p = p * (1.f - s.lr * s.wd) - s.lr * mhat / (sqrtf(vhat) + s.eps);
}

__global__ void __launch_bounds__(256)
fused_adamw_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                   float* __restrict__ v, long n, Scalars s, const int* __restrict__ found_inf) {
  if (found_inf != nullptr) {
    __shared__ int skip;
    if (threadIdx.x == 0) skip = *found_inf;
    __syncthreads();
    if (skip) return;
  }
  const long stride = long(gridDim.x) * blockDim.x;
  const long start = long(blockIdx.x) * blockDim.x + threadIdx.x;
  const long n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long i = start; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    adamw(pp.x, gg.x, mm.x, vv.x, s);
    adamw(pp.y, gg.y, mm.y, vv.y, s);
    adamw(pp.z, gg.z, mm.z, vv.z, s);
    adamw(pp.w, gg.w, mm.w, vv.w, s);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (long i = n4 * 4 + start; i < n; i += stride) adamw(p[i], g[i], m[i], v[i], s);
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p, g, m, v: [n] f32 on the card, 16-byte aligned; found_inf: one int on
// the card, or null (never skip). One launch on `stream`; returns
// cudaGetLastError() (0 on success).
int ptt_fused_adamw(void* p, const void* g, void* m, void* v, long n, float lr, float b1,
                    float b2, float eps, float wd, float bc1, float bc2, const void* found_inf,
                    void* stream) {
  if (n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const long vec_blocks = (n / 4 + 255) / 256;
  const long blocks = vec_blocks < 1 ? 1 : (vec_blocks < 8L * sms ? vec_blocks : 8L * sms);
  fused_adamw_kernel<<<unsigned(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, Scalars{lr, b1, b2, eps, wd, bc1, bc2},
      static_cast<const int*>(found_inf));
  return int(cudaGetLastError());
}

}  // extern "C"
