// Grouped (ragged) GEMMs of the MoE expert FFN for Hopper (sm_90a): bf16
// operands, f32 accumulation in registers, the rows of one matrix grouped by
// expert.
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/grouped_gemm.py:
//   gmm         `_gmm_call`        (pl.pallas_call at :236, body `_gmm_kernel` :122)
//   tgmm        `_tgmm_call`       (:290, body `_tgmm_kernel` :158)
//   gmm_swiglu  `_gmm_swiglu_call` (:487, body `_gmm_swiglu_kernel` :388)
//
// What they compute. lhs [M, K] holds the rows of group g in [offs[g],
// offs[g + 1]), offs being the prefix sums of sizes [G] (int32, on the card,
// each clamped so that offs <= M); rows [offs[G], M) form the trash group
// (dropped tokens, padding).
//   gmm:  out [M, N]; a row of group g < G is lhs[r] @ rhs[g] (+ bias[g]),
//         rhs [G, K, N]; with transpose_rhs rhs is [G, N, K] and the row is
//         lhs[r] @ rhs[g]^T. Trash rows are exact zeros, bias included.
//   tgmm: out [G, K, N], out[g] = lhs_g^T @ dout_g (dout [M, N]); an empty
//         group gives exact zeros; trash rows take no part.
//   gmm_swiglu: w1 [G, K, 2N] (gate columns, then up columns), b1 [G, 2N]:
//         g = lhs[r] @ w1[g][:, :N] + b1[g][:N], u = the same on [N, 2N),
//         out [M, N] = silu(g) * u, and optionally g and u themselves (the
//         backward's residuals). Trash rows are zeros in all three.
// Every epilogue works in f32 and rounds to bf16 once.
//
// What bounds them on the H100: operations. At the MoE layer's shapes (M =
// 32768 routed rows, K and N from 1024 to 5632) each product does 2 K N
// operations per row against 2 (K + N) bytes, about 900 per byte, three
// times the card's ~295.
//
// The design, and what it does about the TPU kernel's assumptions:
// - The TPU grid runs in order, so the Pallas kernel visits a row tile once
//   per group that overlaps it and merges its rows into the out tile with a
//   read-modify-write. On the GPU two blocks would race on such a tile.
//   Here every group's row tiles start at the group's own first row (the
//   scheme of CUTLASS's grouped GEMM): no two blocks touch one output row,
//   and rows of a tile outside its group are zero-filled on load and never
//   stored.
// - The sizes are made on the card by the router and are never read on the
//   host. The grid is static, (N tiles, ceil(M / BM) + G + 1), an upper
//   bound on the row tiles of the G + 1 groups; each block reads the sizes,
//   forms the prefix sums of rows and of row tiles in shared memory, finds
//   its (group, row range), and returns if it lies past the last tile.
// - The trash group's tiles run no K loop and store zeros, so the combine,
//   which multiplies dropped rows by a gate weight of 0, never meets
//   uninitialised memory (0 * NaN is NaN).
// - tgmm reduces over rows, which the TPU did across sequential grid visits;
//   here one block per (K tile, N tile, group) loops over its group's rows.
//   At the layer's shapes that is 1408 to 2816 blocks for 132 SMs, so no
//   split of the rows is needed, and the sum is deterministic.
// - Tiles: a cp.async ring of STAGES stages of BK = 32 deep slices in
//   shared memory (rows padded by 16 bytes, so ldmatrix reads distinct
//   banks), mma.sync m16n8k16 with fragments from ldmatrix. The weight's B
//   fragments come with ldmatrix.trans from a [k][n] tile (rhs [G, K, N],
//   w1) or without it from an [n][k] tile (transpose_rhs); tgmm's A
//   fragments (lhs_g^T) come with ldmatrix.trans from a [row][k] tile.
//   gmm and tgmm use 128 x 128 output tiles over 8 warps (64 x 32 each);
//   gmm_swiglu keeps two accumulators (gate and up), so 128 x 64 tiles
//   (32 x 32 per warp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using ptt::bf16;

constexpr int MAX_GROUPS = 256;  // G + 1 groups at most, the trash group included
constexpr int BK = 32;           // contraction depth of one pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;     // 8 warps

// The grid's row-tile table: offs[0..G+1] (rows) and tstart[0..G+1] (row
// tiles), built by thread 0 from sizes. Returns false for a block past the
// last tile; else sets its group and row range [r0, r1).
template <int BM>
__device__ bool find_row_tile(const int* __restrict__ sizes, int G, int M, int t, int* offs,
                              int* tstart, int& group, int& r0, int& r1) {
  if (threadIdx.x == 0) {
    int off = 0, tiles = 0;
    offs[0] = 0;
    tstart[0] = 0;
    for (int g = 0; g <= G; ++g) {
      const int end = g < G ? min(M, off + max(sizes[g], 0)) : M;
      tiles += (end - off + BM - 1) / BM;
      off = end;
      offs[g + 1] = off;
      tstart[g + 1] = tiles;
    }
  }
  __syncthreads();
  if (t >= tstart[G + 1]) return false;
  int g = 0;
  while (tstart[g + 1] <= t) ++g;  // empty groups own no tile
  group = g;
  r0 = offs[g] + (t - tstart[g]) * BM;
  r1 = min(r0 + BM, offs[g + 1]);
  return true;
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------- gmm, swiglu
template <int BM, int BN, bool B_NK, int NB>
struct GmmSmem {
  static constexpr int LDA = BK + 8;
  static constexpr int BROWS = B_NK ? BN : BK;
  static constexpr int LDB = B_NK ? BK + 8 : BN + 8;
  bf16 a[STAGES][BM][LDA];
  bf16 b[NB][STAGES][BROWS][LDB];
  int offs[MAX_GROUPS + 1];
  int tstart[MAX_GROUPS + 1];
};

// grid (ceil(N / BN), ceil(M / BM) + G + 1). NB = 1: gmm (B_NK: rhs is
// [G, N, K]); NB = 2: gmm_swiglu (w1 [G, K, 2N], two accumulators).
template <int BM, int BN, int WM, int WN, bool B_NK, int NB>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const bf16* __restrict__ bias, const int* __restrict__ sizes, bf16* __restrict__ out,
           bf16* __restrict__ gres, bf16* __restrict__ ures, int M, int K, int N, int G) {
  using S = GmmSmem<BM, BN, B_NK, NB>;
  constexpr int LDA = S::LDA, LDB = S::LDB;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's tile
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WM * WN * 32 == THREADS && NT % 2 == 0, "warp layout");
  static_assert(!B_NK || NB == 1, "swiglu reads w1 as [k][n]");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  int g, r0, r1;
  if (!find_row_tile<BM>(sizes, G, M, blockIdx.y, sm.offs, sm.tstart, g, r0, r1)) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const long ldb = long(NB) * N;  // row stride of rhs[g] ([k][n] layouts)
  const bf16* rhs_g = rhs + long(min(g, G - 1)) * K * ldb;

  float acc[NB][MT][NT][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][mt][nt][e] = 0.f;

  if (g < G) {  // the trash group stores zeros without a K loop
    auto load_stage = [&](int stage, int kt) {
      const int k0 = kt * BK;
      constexpr int KCH = BK / 8;  // 16-byte chunks across BK
      for (int i = tid; i < BM * KCH; i += THREADS) {
        const int r = i / KCH, c = (i % KCH) * 8;
        const bool ok = r0 + r < r1 && k0 + c < K;
        ptt::cp_async16(&sm.a[stage][r][c], ok ? lhs + long(r0 + r) * K + k0 + c : lhs,
                        ok ? 16 : 0);
      }
      if constexpr (B_NK) {
        for (int i = tid; i < BN * KCH; i += THREADS) {
          const int r = i / KCH, c = (i % KCH) * 8;
          const bool ok = n0 + r < N && k0 + c < K;
          ptt::cp_async16(&sm.b[0][stage][r][c], ok ? rhs_g + long(n0 + r) * K + k0 + c : rhs_g,
                          ok ? 16 : 0);
        }
      } else {
        constexpr int NCH = BN / 8;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          for (int i = tid; i < BK * NCH; i += THREADS) {
            const int r = i / NCH, c = (i % NCH) * 8;
            const bool ok = k0 + r < K && n0 + c < N;
            ptt::cp_async16(&sm.b[j][stage][r][c],
                            ok ? rhs_g + long(k0 + r) * ldb + long(j) * N + n0 + c : rhs_g,
                            ok ? 16 : 0);
          }
      }
    };

    const int nkt = (K + BK - 1) / BK;
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nkt) load_stage(st, st);
      ptt::cp_async_commit();
    }
    for (int kt = 0; kt < nkt; ++kt) {
      ptt::cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed; every warp is done with kt - 1
      const int nxt = kt + STAGES - 1;
      if (nxt < nkt) load_stage(nxt % STAGES, nxt);
      ptt::cp_async_commit();
      const int s = kt % STAGES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ptt::load_a<LDA>(a[mt], &sm.a[s][0][0], wm * WTM + mt * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            if constexpr (B_NK)
              ptt::load_b_nk<LDB>(b, &sm.b[j][s][0][0], wn * WTN + np * 16, kk * 16, lane);
            else
              ptt::load_b_kn<LDB>(b, &sm.b[j][s][0][0], kk * 16, wn * WTN + np * 16, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              ptt::mma16816(acc[j][mt][2 * np], a[mt], b[0], b[1]);
              ptt::mma16816(acc[j][mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
      }
    }
    ptt::cp_async_wait<0>();
  }

  // epilogue in f32: the bias (none for the trash group), swiglu, one
  // rounding to bf16; only rows of this tile's group are stored
  const bool has_bias = bias != nullptr && g < G;
  const bf16* bias_g = has_bias ? bias + long(g) * NB * N : bias;
  const int gr = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WTN + nt * 8 + c2;
      if (col >= N) continue;
      float b0[NB], b1[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        b0[j] = has_bias ? __bfloat162float(bias_g[j * N + col]) : 0.f;
        b1[j] = has_bias ? __bfloat162float(bias_g[j * N + col + 1]) : 0.f;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + wm * WTM + mt * 16 + gr + hf * 8;
        if (row >= r1) continue;
        const long at = long(row) * N + col;
        const float x0 = acc[0][mt][nt][2 * hf] + b0[0];
        const float x1 = acc[0][mt][nt][2 * hf + 1] + b1[0];
        if constexpr (NB == 1) {
          store_bf16x2(out + at, x0, x1);
        } else {
          const float u0 = acc[1][mt][nt][2 * hf] + b0[1];
          const float u1 = acc[1][mt][nt][2 * hf + 1] + b1[1];
          const float y0 = x0 * (1.f / (1.f + expf(-x0))) * u0;
          const float y1 = x1 * (1.f / (1.f + expf(-x1))) * u1;
          store_bf16x2(out + at, y0, y1);
          if (gres != nullptr) {
            store_bf16x2(gres + at, x0, x1);
            store_bf16x2(ures + at, u0, u1);
          }
        }
      }
    }
}

// ---------------------------------------------------------------------- tgmm
template <int BM, int BN>
struct TgmmSmem {
  static constexpr int LDA = BM + 8;
  static constexpr int LDB = BN + 8;
  bf16 a[STAGES][BK][LDA];  // lhs rows x k columns
  bf16 b[STAGES][BK][LDB];  // dout rows x n columns
  int lo, hi;
};

// grid (ceil(K / BM), ceil(N / BN), G): out[g][k0:k0+BM, n0:n0+BN]
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ dout,
            const int* __restrict__ sizes, bf16* __restrict__ out, int M, int K, int N, int G) {
  using S = TgmmSmem<BM, BN>;
  constexpr int LDA = S::LDA, LDB = S::LDB;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WM * WN * 32 == THREADS && NT % 2 == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int g = blockIdx.z;
  if (threadIdx.x == 0) {
    int off = 0, lo = 0;
    for (int i = 0; i <= g; ++i) {
      lo = off;
      off = min(M, off + max(sizes[i], 0));
    }
    sm.lo = lo;
    sm.hi = off;
  }
  __syncthreads();
  const int lo = sm.lo, hi = sm.hi;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto load_stage = [&](int stage, int rt) {
    const int row0 = lo + rt * BK;
    constexpr int KCH = BM / 8, NCH = BN / 8;
    for (int i = tid; i < BK * KCH; i += THREADS) {
      const int r = i / KCH, c = (i % KCH) * 8;
      const bool ok = row0 + r < hi && k0 + c < K;
      ptt::cp_async16(&sm.a[stage][r][c], ok ? lhs + long(row0 + r) * K + k0 + c : lhs,
                      ok ? 16 : 0);
    }
    for (int i = tid; i < BK * NCH; i += THREADS) {
      const int r = i / NCH, c = (i % NCH) * 8;
      const bool ok = row0 + r < hi && n0 + c < N;
      ptt::cp_async16(&sm.b[stage][r][c], ok ? dout + long(row0 + r) * N + n0 + c : dout,
                      ok ? 16 : 0);
    }
  };

  const int nrt = (hi - lo + BK - 1) / BK;  // 0 for an empty group: zeros stored
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nrt) load_stage(st, st);
    ptt::cp_async_commit();
  }
  for (int rt = 0; rt < nrt; ++rt) {
    ptt::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = rt + STAGES - 1;
    if (nxt < nrt) load_stage(nxt % STAGES, nxt);
    ptt::cp_async_commit();
    const int s = rt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A = lhs_g^T: a 16 (k) x 16 (rows) block of the [row][k] tile,
        // transposed by ldmatrix.trans (matrices: k 0-7 / 8-15 by rows
        // 0-7 / 8-15, in the order of the mma's A fragment)
        const bf16* p = &sm.a[s][0][0] + (kk * 16 + lane % 8 + (lane / 16) * 8) * LDA +
                        wm * WTM + mt * 16 + ((lane / 8) % 2) * 8;
        ptt::ldmatrix_x4_trans(a[mt], p);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ptt::load_b_kn<LDB>(b, &sm.b[s][0][0], kk * 16, wn * WTN + np * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ptt::mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          ptt::mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  ptt::cp_async_wait<0>();

  bf16* out_g = out + long(g) * K * N;
  const int gr = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WTN + nt * 8 + c2;
      if (col >= N) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = k0 + wm * WTM + mt * 16 + gr + hf * 8;
        if (k < K)
          store_bf16x2(out_g + long(k) * N + col, acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
    }
}

// Raise the dynamic shared-memory limit of `kern` once per device (bit d of
// `done`: done on device d), not on every launch.
template <typename Kern>
cudaError_t smem_limit(Kern kern, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t(1) << dev) : 0;
  if (bit == 0 || !(done.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <int BM, int BN, int WM, int WN, bool B_NK, int NB>
cudaError_t launch_gmm(const bf16* lhs, const bf16* rhs, const bf16* bias, const int* sizes,
                       bf16* out, bf16* gres, bf16* ures, int M, int K, int N, int G,
                       cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  auto kern = gmm_kernel<BM, BN, WM, WN, B_NK, NB>;
  const int smem = int(sizeof(GmmSmem<BM, BN, B_NK, NB>));
  cudaError_t err = smem_limit(kern, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + G + 1);
  kern<<<grid, THREADS, smem, stream>>>(lhs, rhs, bias, sizes, out, gres, ures, M, K, N, G);
  return cudaGetLastError();
}

bool dims_ok(int M, int K, int N, int G) {
  return M >= 0 && K > 0 && N > 0 && K % 8 == 0 && N % 8 == 0 && G >= 1 && G + 1 <= MAX_GROUPS;
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// lhs [M, K] bf16, rhs [G, K, N] bf16 ([G, N, K] when transpose_rhs), bias
// [G, N] bf16 or null, sizes [G] int32, out [M, N] bf16; all contiguous and
// 16-byte aligned, on the current device. Needs K % 8 == 0, N % 8 == 0 and
// 1 <= G <= 255. Returns cudaGetLastError() after the launch.
int ptt_gmm(const void* lhs, const void* rhs, const void* bias, const void* sizes, void* out,
            int M, int K, int N, int G, int transpose_rhs, void* stream) {
  if (!dims_ok(M, K, N, G)) return int(cudaErrorInvalidValue);
  const auto* a = static_cast<const bf16*>(lhs);
  const auto* b = static_cast<const bf16*>(rhs);
  const auto* bs = static_cast<const bf16*>(bias);
  const auto* sz = static_cast<const int*>(sizes);
  auto* o = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (transpose_rhs)
    return int(launch_gmm<128, 128, 2, 4, true, 1>(a, b, bs, sz, o, nullptr, nullptr, M, K, N, G,
                                                   st));
  return int(
      launch_gmm<128, 128, 2, 4, false, 1>(a, b, bs, sz, o, nullptr, nullptr, M, K, N, G, st));
}

// lhs [M, K] bf16, w1 [G, K, 2N] bf16, b1 [G, 2N] bf16, sizes [G] int32;
// out, gres, ures [M, N] bf16 (gres and ures both null: out only). Same
// needs as ptt_gmm.
int ptt_gmm_swiglu(const void* lhs, const void* w1, const void* b1, const void* sizes,
                   void* out, void* gres, void* ures, int M, int K, int N, int G,
                   void* stream) {
  if (!dims_ok(M, K, N, G) || (gres == nullptr) != (ures == nullptr) || b1 == nullptr)
    return int(cudaErrorInvalidValue);
  return int(launch_gmm<128, 64, 4, 2, false, 2>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const int*>(sizes), static_cast<bf16*>(out), static_cast<bf16*>(gres),
      static_cast<bf16*>(ures), M, K, N, G, static_cast<cudaStream_t>(stream)));
}

// lhs [M, K] bf16, dout [M, N] bf16, sizes [G] int32, out [G, K, N] bf16.
// Same needs as ptt_gmm.
int ptt_tgmm(const void* lhs, const void* dout, const void* sizes, void* out, int M, int K,
             int N, int G, void* stream) {
  if (!dims_ok(M, K, N, G)) return int(cudaErrorInvalidValue);
  constexpr int BM = 128, BN = 128;
  static std::atomic<uint64_t> done{0};
  auto kern = tgmm_kernel<BM, BN, 2, 4>;
  const int smem = int(sizeof(TgmmSmem<BM, BN>));
  cudaError_t err = smem_limit(kern, smem, done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, G);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout),
      static_cast<const int*>(sizes), static_cast<bf16*>(out), M, K, N, G);
  return int(cudaGetLastError());
}

}  // extern "C"
