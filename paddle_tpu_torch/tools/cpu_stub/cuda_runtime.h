// A CPU stand-in for the CUDA runtime, for tools/cpu_rehearsal.py: each
// CUDA thread is a std::thread, blocks run one at a time, __syncthreads and
// the warp and warpgroup collectives (shuffles here, ldmatrix and mma.sync
// in flash_common.cuh, wgmma in hopper.cuh) meet on std::barrier, named
// barriers are made at first use, and the dynamic shared memory is one
// global buffer (1024-byte aligned, as a kernel aligns its swizzled tiles)
// filled with 0xff before each block, so a read of an unset value shows as
// NaN. Atomics act on the host's memory. A card of 4 SMs, each taking one
// CTA above 113 KB of shared memory and two below.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#include <math.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "stub error"; }
template <class K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// a card of 4 SMs: grids sized by the SM count stay small
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 4; return 0; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t smem) {
  *n = smem <= 115712 ? 2 : 1;
  return 0;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline float __expf(float x) { return expf(x); }
// byte n of the result is byte (s >> 4 n) & 7 of y:x (x bytes 0-3)
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = uint64_t(y) << 32 | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) r |= uint32_t((v >> (8 * ((s >> (4 * n)) & 7))) & 0xffu) << (8 * n);
  return r;
}
template <class T> inline T __ldcg(const T* p) { return *p; }

struct StubWarp {
  std::barrier<> bar{32};
  const void* addr[32];
  uint32_t regs[32][8];
  float f[32];
};
struct StubGroup {
  std::barrier<> bar{128};
  uint32_t regs[128][4];
};
struct StubBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<StubWarp>> warps;
  std::vector<std::unique_ptr<StubGroup>> groups;
  std::mutex mu;   // guards `named`
  std::unique_ptr<std::barrier<>> named[16];
};
inline dim3 blockIdx, blockDim, gridDim;
inline thread_local dim3 threadIdx;
inline StubBlock* g_block = nullptr;
alignas(1024) inline unsigned char smem_raw[232448];

inline StubWarp& stub_warp() { return *g_block->warps[threadIdx.x / 32]; }
inline StubGroup& stub_group() { return *g_block->groups[threadIdx.x / 128]; }
inline void __syncthreads() { g_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { stub_warp().bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  auto& w = stub_warp();
  const int lane = threadIdx.x % 32;
  w.f[lane] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[lane ^ o];
  w.bar.arrive_and_wait();
  return r;
}
inline double __shfl_xor_sync(unsigned m, double v, int o) {
  uint64_t u;
  std::memcpy(&u, &v, 8);
  const uint64_t lo = __float_as_uint(__shfl_xor_sync(m, __uint_as_float(uint32_t(u)), o));
  const uint64_t hi = __float_as_uint(__shfl_xor_sync(m, __uint_as_float(uint32_t(u >> 32)), o));
  u = hi << 32 | lo;
  std::memcpy(&v, &u, 8);
  return v;
}
inline float __shfl_up_sync(unsigned, float v, int o) {
  auto& w = stub_warp();
  const int lane = threadIdx.x % 32;
  w.f[lane] = v;
  w.bar.arrive_and_wait();
  const float r = lane >= o ? w.f[lane - o] : v;
  w.bar.arrive_and_wait();
  return r;
}
inline float __shfl_down_sync(unsigned, float v, int o) {
  auto& w = stub_warp();
  const int lane = threadIdx.x % 32;
  w.f[lane] = v;
  w.bar.arrive_and_wait();
  const float r = lane + o < 32 ? w.f[lane + o] : v;
  w.bar.arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  auto& w = stub_warp();
  const int lane = threadIdx.x % 32;
  w.f[lane] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[src % 32];
  w.bar.arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned m, int v, int src) {
  return __float_as_uint(__shfl_sync(m, __uint_as_float(uint32_t(v)), src));
}
inline int __shfl_up_sync(unsigned m, int v, int o) {
  return __float_as_uint(__shfl_up_sync(m, __uint_as_float(uint32_t(v)), o));
}

inline void stub_launch(dim3 grid, dim3 block, std::function<void()> fn) {
  const int nt = block.x * block.y * block.z;
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        std::memset(smem_raw, 0xff, sizeof(smem_raw));   // unset reads show as NaN
        StubBlock b;
        b.bar = std::make_unique<std::barrier<>>(nt);
        for (int w = 0; w < (nt + 31) / 32; ++w) b.warps.push_back(std::make_unique<StubWarp>());
        for (int w = 0; w < (nt + 127) / 128; ++w) b.groups.push_back(std::make_unique<StubGroup>());
        g_block = &b;
        std::vector<std::thread> th;
        for (int t = 0; t < nt; ++t)
          th.emplace_back([t, &fn] { threadIdx = dim3(t); fn(); });
        for (auto& t : th) t.join();
      }
}
