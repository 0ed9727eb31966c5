// Grouped (ragged) GEMMs of the MoE expert FFN for Hopper (sm_90a): bf16
// operands, f32 accumulation, the rows of one matrix grouped by expert.
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
//         group gives exact zeros; rows outside the group take no part, even
//         when they hold inf or NaN.
//   gmm_swiglu: w1 [G, K, 2N] (gate columns, then up columns), b1 [G, 2N]:
//         g = lhs[r] @ w1[g][:, :N] + b1[g][:N], u = the same on [N, 2N),
//         out [M, N] = silu(g) * u, and optionally g and u themselves (the
//         backward's residuals). Trash rows are zeros in all three.
// Every epilogue works in f32 and rounds to bf16 once. No atomics and no
// split of a sum, so every result is deterministic.
//
// What bounds them on the H100: operations. At the MoE layer's shapes (M =
// 32768 routed rows, K and N from 1024 to 5632) each product does 2 K N
// operations per row against 2 (K + N) bytes, about 900 per byte, three
// times the card's ~295. Only wgmma reaches the tensor cores' full rate.
//
// gmm and tgmm: one persistent, warp-specialised kernel family.
// - Grid: one block per SM, or per tile where there are fewer; a block
//   walks the output tiles t = blockIdx.x, + gridDim.x, ...
// - Block: 3 warpgroups. Warpgroup 0 keeps 40 registers (setmaxnreg) and
//   one of its threads issues the TMA loads of every K slice (64 deep: one
//   128-byte swizzle row of bf16) into a ring of 3 stages, each with a full
//   and an empty mbarrier. Warpgroups 1 and 2 take 232 registers and each
//   owns 64 rows of the 128 x 256 output tile: per slice four wgmma
//   m64n256k16, one group kept in flight, the stage released to the
//   producer when the next group is issued. The ring's stage index and
//   parity run on across tiles, so the producer loads the next tile's
//   slices while the consumers store this one's.
// - Epilogue: the f32 sums (plus bias) go to shared memory as bf16, in the
//   layout the output's TMA map reads, and one thread stores them by TMA;
//   the stores drain while the consumers run the next tile's slices.
//   Shared memory: 3 stages of 48 KB and the 64 KB output tile, 211 KB in
//   all (a fourth stage leaves no room for the output tile).
// - Measured against variants of this source on an H100
//   (paddle_tpu_torch/tools/grouped_gemm_variants.py): every gmm tile
//   stored from registers, waiting for each slice's wgmma group before the
//   next, a 128 x 128 tile, and tgmm's n tiles innermost for dW1 were each
//   slower on the MoE layer's products (PERF.md, section 6).
// - Group table: each block forms it once, in shared memory, with one warp
//   (warp-shuffle prefix sums of the clamped sizes), not per tile.
// - gmm, ragged groups on an out-of-order grid. The TPU grid runs in order
//   and merges a row tile shared by two groups with a read-modify-write;
//   here two blocks would race on such a tile. So every group's row tiles
//   start at the group's own first row (tile i of group g covers rows
//   offs[g] + 128 i ..): TMA takes any row coordinate. Rows of the tile
//   past the group's end belong to the next group: they are loaded and
//   multiplied (an output row depends on its own input row only) but never
//   stored. A tile of 128 rows of its own group is stored by TMA; a
//   group's last, shorter tile from registers, rows [r0, r1) only (a TMA
//   box would overwrite the next group's rows). Tiles walk row-tile-major
//   with the N tiles innermost, so a row panel and the group's weight are
//   reused from L2. The trash group's tiles skip the mainloop and store
//   zeros. The row tiles of the G + 1 groups number at most ceil(M / 128)
//   + G + 1 and are found on the card: the sizes are never read on the
//   host.
// - gmm operands: lhs through a 2-D map [M, K] (box 64 x 128, K-major A);
//   rhs through a 3-D map [G, K, N] (box 64 n x 64 k x 1: MN-major B, 4
//   boxes) or [G, N, K] with transpose_rhs (box 64 k x 256 n x 1: K-major
//   B). The box's depth of 1 in G makes the K edge of expert g zero-fill
//   instead of reading expert g + 1.
// - tgmm: output tiles (g, 128 k, 256 n) of out [G, K, N]; the reduction
//   runs over the group's rows in 64-row slices from offs[g]. A is the lhs
//   slice [rows][k] (MN-major A, two 64 x 64 boxes), B the dout slice
//   [rows][n] (MN-major B), both by TMA from [M, K] and [M, N]. The last
//   slice overhangs into the next group or the trash rows: the consumers
//   zero those rows in both operands in shared memory (whole 128-byte lines,
//   so the swizzle does not matter), fence the generic stores against the
//   async proxy, meet at a named barrier and only then run wgmma, so inf or
//   NaN outside the group never reaches the sum. An empty group stores
//   zeros. Each output tile is owned whole, so it is stored by TMA through
//   a 3-D map of out (clipped at K and N). Groups are walked largest first
//   (ranks sorted on the card), a group's tiles with the shorter of its two
//   tile axes innermost (k for dW1: 8 x 22 tiles); the tile count (704 /
//   1408 tiles of 128 x 256 for dW2 / dW1 of the MoE layer) keeps 132 SMs
//   busy without splitting the rows, and each tile's sum runs in one fixed
//   order.

// gmm_swiglu keeps its first design: mma.sync m16n8k16 with fragments from
// ldmatrix, a 4-stage cp.async ring of 32-deep slices, 128 x 64 tiles over
// 8 warps with two accumulators (gate and up), a grid of (N / 64,
// ceil(M / 128) + G + 1) blocks, each finding its row tile with one thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using ptt::bf16;
namespace hw = ptt::sm90;

constexpr int MAX_GROUPS = 256;  // G + 1 groups at most, the trash group included

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------ wgmma gmm and tgmm
constexpr int WG_BM = 128;          // output tile rows: 2 consumer warpgroups x 64
constexpr int WG_BN = 256;          // output tile columns: one wgmma m64n256 per k16
constexpr int WG_BK = 64;           // depth of a slice: 128 bytes of bf16
constexpr int STAGES_WG = 3;        // the ring's stages (48 KB each)
constexpr int WG_THREADS = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PANEL = 64 * 128;     // bytes of one 64-row box of 128-byte lines
constexpr int OUT_PANEL = WG_BM * 128;  // bytes of one 64-column panel of an output tile
constexpr int A_BYTES = WG_BM * WG_BK * 2;    // 2 panels
constexpr int B_BYTES = WG_BK * WG_BN * 2;    // 4 panels
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_BYTES = WG_BM * WG_BN * 2;  // 4 output panels
// the ring and the staged output tile (1024-byte aligned by hand), full and
// empty barriers, two tables of MAX_GROUPS + 1 ints
constexpr int WG_SMEM =
    1024 + STAGES_WG * STAGE_BYTES + OUT_BYTES + 2 * STAGES_WG * 8 + 2 * (MAX_GROUPS + 1) * 4;
static_assert(STAGE_BYTES % 1024 == 0, "stages keep the swizzle atom's alignment");
static_assert(WG_SMEM <= 232448, "shared memory");

struct Ring {
  uint8_t* stage0;
  uint8_t* outbuf;
  uint64_t* full;
  uint64_t* empty;
  int* tab0;
  int* tab1;
  __device__ explicit Ring(uint8_t* raw) {
    stage0 = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                        ~uintptr_t(1023));
    outbuf = stage0 + STAGES_WG * STAGE_BYTES;
    full = reinterpret_cast<uint64_t*>(outbuf + OUT_BYTES);
    empty = full + STAGES_WG;
    tab0 = reinterpret_cast<int*>(empty + STAGES_WG);
    tab1 = tab0 + MAX_GROUPS + 1;
  }
  __device__ uint8_t* stage(int s) const { return stage0 + s * STAGE_BYTES; }
};

// One thread: full barriers wait for the producer's one arrival and the
// stage's bytes, empty barriers for one arrival per consumer warpgroup.
__device__ void init_ring(const Ring& ring) {
  for (int s = 0; s < STAGES_WG; ++s) {
    hw::mbar_init(&ring.full[s], 1);
    hw::mbar_init(&ring.empty[s], 2);
  }
  hw::mbar_fence_init();
}

// One warp: offs[0..G] = 0 and the prefix sums of the sizes, each clamped
// to [0, M] (the running clamp min(M, off + max(s, 0)) of the plain version
// equals min(M, prefix sum of max(s, 0))), and offs[G + 1] = M.
__device__ void build_offsets(const int* __restrict__ sizes, int G, int M, int* offs, int lane) {
  long long carry = 0;
  if (lane == 0) offs[0] = 0;
  for (int c = 0; c < G; c += 32) {
    const int g = c + lane;
    long long s = g < G ? max(sizes[g], 0) : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    s += carry;
    if (g < G) offs[g + 1] = int(min(s, (long long)M));
    carry = __shfl_sync(0xffffffffu, s, 31);
  }
  if (lane == 0) offs[G + 1] = M;
  __syncwarp();
}

// One warp: tstart[0..G+1], the prefix sums of the row tiles of the G + 1
// groups (the trash group last).
__device__ void build_row_tiles(const int* offs, int G, int* tstart, int lane) {
  int carry = 0;
  if (lane == 0) tstart[0] = 0;
  for (int c = 0; c <= G; c += 32) {
    const int g = c + lane;
    int s = g <= G ? (offs[g + 1] - offs[g] + WG_BM - 1) / WG_BM : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    s += carry;
    if (g <= G) tstart[g + 1] = s;
    carry = __shfl_sync(0xffffffffu, s, 31);
  }
  __syncwarp();
}

// One warp: order[0..G) = the groups by size, largest first (ties by index).
__device__ void build_order(const int* offs, int G, int* order, int lane) {
  for (int g = lane; g < G; g += 32) {
    const int sg = offs[g + 1] - offs[g];
    int rank = 0;
    for (int h = 0; h < G; ++h) {
      const int sh = offs[h + 1] - offs[h];
      rank += sh > sg || (sh == sg && h < g);
    }
    order[rank] = g;
  }
  __syncwarp();
}

// Row tile rt of the gmm walk: its group g (G: trash) and rows [r0, r1).
__device__ __forceinline__ void locate_row_tile(const int* offs, const int* tstart, int G, int rt,
                                                int& g, int& r0, int& r1) {
  int lo = 0, hi = G;  // the last g with tstart[g] <= rt owns the tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tstart[mid] <= rt)
      lo = mid;
    else
      hi = mid - 1;
  }
  g = lo;
  r0 = offs[g] + (rt - tstart[g]) * WG_BM;
  r1 = min(r0 + WG_BM, offs[g + 1]);
}

// The consumers' side of one slice: wait for the stage, four k16 steps,
// commit; then release the stage before (whose group has finished) and
// keep this one's group in flight. A/B_STEP: descriptor steps per k16 in
// 16-byte units (2 for 32 bytes along a K-major row, 128 for 16 rows of an
// MN-major panel).
template <int TA, int TB, int A_STEP, int B_STEP>
__device__ __forceinline__ void consume_slice(float (&acc)[WG_BN / 2], uint64_t da, uint64_t db,
                                              const Ring& ring, int stage, int& prev,
                                              bool leader) {
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk)
    hw::wgmma_m64n256<TA, TB>(acc, da + kk * A_STEP, db + kk * B_STEP, 1);
  hw::wgmma_commit();
  hw::wgmma_wait<1>();
  if (prev >= 0 && leader) hw::mbar_arrive(&ring.empty[prev]);
  prev = stage;
}

__device__ __forceinline__ void finish_tile(float (&acc)[WG_BN / 2], const Ring& ring, int& prev,
                                            bool leader) {
  hw::wgmma_wait<0>();
  hw::fence_operand(acc);
  if (prev >= 0 && leader) hw::mbar_arrive(&ring.empty[prev]);
  prev = -1;
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES_WG) {
    stage = 0;
    phase ^= 1;
  }
}

// The consumers' half of a TMA-stored output tile: once the previous
// tile's stores have read the staging tile (the issuer, consumer thread 0,
// waits for its bulk groups), each warpgroup writes its 64 rows, plus
// bias_g (null: none) in f32, as bf16 into 4 panels of 128 lines in
// the 128-byte swizzle (conflict-free: the 8 rows a store instruction
// touches sit in 8 distinct 16-byte chunks), then fences them for the
// async proxy. The issuer then stores the panels and commits; the stores
// run on while the consumers start the next tile.
__device__ __forceinline__ void stage_out(uint8_t* outbuf, const float (&acc)[WG_BN / 2],
                                          const bf16* bias_g, int n0, int N, int wg, int tid,
                                          bool issuer) {
  if (issuer) hw::tma_store_wait_read<0>();
  hw::named_barrier(1, 256);
  const int r = wg * 64 + (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j) {
    float b0 = 0.f, b1 = 0.f;
    const int col = n0 + 8 * j + 2 * (tid % 4);
    if (bias_g != nullptr && col < N) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias_g + col);
      b0 = __low2float(b);
      b1 = __high2float(b);
    }
    uint8_t* at = outbuf + (j / 8) * OUT_PANEL + ((j % 8) ^ (r % 8)) * 16 + (tid % 4) * 4;
    *reinterpret_cast<uint32_t*>(at + r * 128) =
        ptt::pack_bf16(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<uint32_t*>(at + (r + 8) * 128) =
        ptt::pack_bf16(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  hw::fence_proxy_async();
  hw::named_barrier(1, 256);
}

// Tile `rem` of a tgmm group's ntk x ntn output tiles: the shorter axis
// runs innermost, so the blocks in flight share the longer axis's panels
// from L2.
__device__ __forceinline__ void tgmm_tile(int rem, int ntk, int ntn, int& k0, int& n0) {
  const bool k_inner = ntk <= ntn;
  k0 = (k_inner ? rem % ntk : rem / ntn) * WG_BM;
  n0 = (k_inner ? rem / ntk : rem % ntn) * WG_BN;
}

// out rows [r0, r1) of a gmm tile; TRANS_B: rhs is [G, N, K]
template <bool TRANS_B>
__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                 const __grid_constant__ CUtensorMap map_rhs,
                 const __grid_constant__ CUtensorMap map_out, const bf16* __restrict__ bias,
                 const int* __restrict__ sizes, bf16* __restrict__ out, int M, int K, int N,
                 int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Ring ring(smem_raw);
  int* offs = ring.tab0;
  int* tstart = ring.tab1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    build_offsets(sizes, G, M, offs, lane);
    build_row_tiles(offs, G, tstart, lane);
  } else if (threadIdx.x == 32) {
    init_ring(ring);
  }
  __syncthreads();

  const int ntn = (N + WG_BN - 1) / WG_BN;
  const int ntiles = tstart[G + 1] * ntn;
  const int nk = (K + WG_BK - 1) / WG_BK;

  if (warp < 4) {  // producer warpgroup: one thread issues every load
    hw::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hw::tma_prefetch(&map_lhs);
      hw::tma_prefetch(&map_rhs);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int g, r0, r1;
        locate_row_tile(offs, tstart, G, t / ntn, g, r0, r1);
        if (g == G) continue;  // trash tiles load nothing
        const int n0 = (t % ntn) * WG_BN;
        for (int kt = 0; kt < nk; ++kt) {
          hw::mbar_wait(&ring.empty[stage], phase ^ 1);
          uint8_t* st = ring.stage(stage);
          uint64_t* bar = &ring.full[stage];
          hw::mbar_expect_tx(bar, STAGE_BYTES);
          hw::tma_load_2d(st, &map_lhs, bar, kt * WG_BK, r0);
          if constexpr (TRANS_B) {
            hw::tma_load_3d(st + A_BYTES, &map_rhs, bar, kt * WG_BK, n0, g);
          } else {
#pragma unroll
            for (int j = 0; j < WG_BN / 64; ++j)
              hw::tma_load_3d(st + A_BYTES + j * PANEL, &map_rhs, bar, n0 + 64 * j,
                              kt * WG_BK, g);
          }
          advance(stage, phase);
        }
      }
    }
  } else {  // consumer warpgroups 1, 2: rows [64 wg, 64 wg + 64) of a tile
    hw::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4 - 1;
    const int tid = threadIdx.x % 128;
    const bool leader = tid == 0, issuer = threadIdx.x == 128;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    float acc[WG_BN / 2];
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int g, r0, r1;
      locate_row_tile(offs, tstart, G, t / ntn, g, r0, r1);
      const int n0 = (t % ntn) * WG_BN;
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) acc[i] = 0.f;
      hw::fence_operand(acc);
      if (g < G) {
        for (int kt = 0; kt < nk; ++kt) {
          hw::mbar_wait(&ring.full[stage], phase);
          const uint8_t* st = ring.stage(stage);
          const uint64_t da = hw::desc_k_major(st + wg * PANEL);
          if constexpr (TRANS_B)
            consume_slice<0, 0, 2, 2>(acc, da, hw::desc_k_major(st + A_BYTES), ring,
                                          stage, prev, leader);
          else
            consume_slice<0, 1, 2, 128>(acc, da, hw::desc_mn_major(st + A_BYTES, PANEL),
                                            ring, stage, prev, leader);
          advance(stage, phase);
        }
        finish_tile(acc, ring, prev, leader);
      }
      // epilogue: bias in f32 (none for the trash group), one rounding. A
      // tile of 128 rows of its group goes out by TMA, staged; a shorter
      // one (a group's last) from registers, rows [r0, r1) only
      const bf16* bias_g = bias != nullptr && g < G ? bias + long(g) * N : nullptr;
      if (r1 - r0 == WG_BM) {
        stage_out(ring.outbuf, acc, bias_g, n0, N, wg, tid, issuer);
        if (issuer) {
#pragma unroll
          for (int j = 0; j < WG_BN / 64; ++j)
            if (n0 + 64 * j < N)
              hw::tma_store_2d(&map_out, ring.outbuf + j * OUT_PANEL, n0 + 64 * j, r0);
          hw::tma_store_commit();
        }
        continue;
      }
      const int row = r0 + wg * 64 + (tid / 32) * 16 + (tid % 32) / 4;
      const int c2 = 2 * (tid % 4);
#pragma unroll
      for (int j = 0; j < WG_BN / 8; ++j) {
        const int col = n0 + 8 * j + c2;
        if (col >= N) continue;
        float b0 = 0.f, b1 = 0.f;
        if (bias_g != nullptr) {
          const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias_g + col);
          b0 = __low2float(b);
          b1 = __high2float(b);
        }
        if (row < r1) store_bf16x2(out + long(row) * N + col, acc[4 * j] + b0, acc[4 * j + 1] + b1);
        if (row + 8 < r1)
          store_bf16x2(out + long(row + 8) * N + col, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
    }
    if (issuer) hw::tma_store_wait<0>();
  }
}

// out[g][k0:k0+128, n0:n0+256] = lhs_g^T dout_g
__global__ void __launch_bounds__(WG_THREADS, 1)
tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                  const __grid_constant__ CUtensorMap map_dout,
                  const __grid_constant__ CUtensorMap map_out, const int* __restrict__ sizes,
                  int M, int K, int N, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Ring ring(smem_raw);
  int* offs = ring.tab0;
  int* order = ring.tab1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    build_offsets(sizes, G, M, offs, lane);
    build_order(offs, G, order, lane);
  } else if (threadIdx.x == 32) {
    init_ring(ring);
  }
  __syncthreads();

  const int ntk = (K + WG_BM - 1) / WG_BM, ntn = (N + WG_BN - 1) / WG_BN;
  const int per_group = ntk * ntn;
  const int ntiles = G * per_group;

  if (warp < 4) {  // producer warpgroup
    hw::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hw::tma_prefetch(&map_lhs);
      hw::tma_prefetch(&map_dout);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int g = order[t / per_group];
        int k0, n0;
        tgmm_tile(t % per_group, ntk, ntn, k0, n0);
        const int lo = offs[g], hi = offs[g + 1];
        for (int row = lo; row < hi; row += WG_BK) {
          hw::mbar_wait(&ring.empty[stage], phase ^ 1);
          uint8_t* st = ring.stage(stage);
          uint64_t* bar = &ring.full[stage];
          hw::mbar_expect_tx(bar, STAGE_BYTES);
          hw::tma_load_2d(st, &map_lhs, bar, k0, row);
          hw::tma_load_2d(st + PANEL, &map_lhs, bar, k0 + 64, row);
#pragma unroll
          for (int j = 0; j < WG_BN / 64; ++j)
            hw::tma_load_2d(st + A_BYTES + j * PANEL, &map_dout, bar, n0 + 64 * j, row);
          advance(stage, phase);
        }
      }
    }
  } else {  // consumer warpgroups: k rows [64 wg, 64 wg + 64) of a tile
    hw::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4 - 1;
    const int tid = threadIdx.x % 128;
    const int ctid = threadIdx.x - 128;  // 0..255 over both consumer warpgroups
    const bool leader = tid == 0, issuer = ctid == 0;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    float acc[WG_BN / 2];
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int g = order[t / per_group];
      int k0, n0;
      tgmm_tile(t % per_group, ntk, ntn, k0, n0);
      const int lo = offs[g], hi = offs[g + 1];
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) acc[i] = 0.f;
      hw::fence_operand(acc);
      for (int row = lo; row < hi; row += WG_BK) {
        hw::mbar_wait(&ring.full[stage], phase);
        uint8_t* st = ring.stage(stage);
        const int valid = hi - row;
        if (valid < WG_BK) {
          // the slice overhangs the group: zero lines [valid, 64) of every
          // panel (2 of lhs, 4 of dout) before any wgmma reads them
          constexpr int PANELS = 2 + WG_BN / 64;
          const int lines = WG_BK - valid;
          for (int i = ctid; i < PANELS * lines * 8; i += 256) {
            const int line = i / 8, panel = line / lines;
            const int r = valid + line % lines;
            *reinterpret_cast<uint4*>(st + panel * PANEL + r * 128 + (i % 8) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          hw::fence_proxy_async();
          hw::named_barrier(1, 256);
        }
        consume_slice<1, 1, 128, 128>(acc, hw::desc_mn_major(st + wg * PANEL, PANEL),
                                          hw::desc_mn_major(st + A_BYTES, PANEL), ring, stage,
                                          prev, leader);
        advance(stage, phase);
      }
      finish_tile(acc, ring, prev, leader);
      // the tile is owned whole: staged, stored by TMA (clipped at K, N)
      stage_out(ring.outbuf, acc, nullptr, n0, N, wg, tid, issuer);
      if (issuer) {
#pragma unroll
        for (int j = 0; j < WG_BN / 64; ++j)
          if (n0 + 64 * j < N)
            hw::tma_store_3d(&map_out, ring.outbuf + j * OUT_PANEL, n0 + 64 * j, k0, g);
        hw::tma_store_commit();
      }
    }
    if (issuer) hw::tma_store_wait<0>();
  }
}

template <bool TRANS_B>
cudaError_t launch_gmm(const CUtensorMap& ml, const CUtensorMap& mr, const CUtensorMap& mo,
                       const bf16* bias, const int* sizes, bf16* out, int M, int K, int N, int G,
                       int grid, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  auto kern = gmm_wgmma_kernel<TRANS_B>;
  cudaError_t err = ptt::allow_smem(kern, WG_SMEM, done);
  if (err != cudaSuccess) return err;
  kern<<<grid, WG_THREADS, WG_SMEM, stream>>>(ml, mr, mo, bias, sizes, out, M, K, N,
                                                      G);
  return cudaGetLastError();
}

cudaError_t launch_tgmm(const CUtensorMap& ml, const CUtensorMap& md, const CUtensorMap& mo,
                        const int* sizes, int M, int K, int N, int G, int grid,
                        cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  auto kern = tgmm_wgmma_kernel;
  cudaError_t err = ptt::allow_smem(kern, WG_SMEM, done);
  if (err != cudaSuccess) return err;
  kern<<<grid, WG_THREADS, WG_SMEM, stream>>>(ml, md, mo, sizes, M, K, N, G);
  return cudaGetLastError();
}

// --------------------------------------------------- gmm_swiglu (mma.sync)
constexpr int BK = 32;           // contraction depth of one pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;     // 8 warps
constexpr int NB = 2;            // two accumulators: gate and up

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

template <int BM, int BN>
struct GmmSmem {
  static constexpr int LDA = BK + 8;
  static constexpr int LDB = BN + 8;
  bf16 a[STAGES][BM][LDA];
  bf16 b[NB][STAGES][BK][LDB];
  int offs[MAX_GROUPS + 1];
  int tstart[MAX_GROUPS + 1];
};

// grid (ceil(N / BN), ceil(M / BM) + G + 1); w1 [G, K, 2N], two accumulators
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const bf16* __restrict__ bias, const int* __restrict__ sizes, bf16* __restrict__ out,
           bf16* __restrict__ gres, bf16* __restrict__ ures, int M, int K, int N, int G) {
  using S = GmmSmem<BM, BN>;
  constexpr int LDA = S::LDA, LDB = S::LDB;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's tile
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WM * WN * 32 == THREADS && NT % 2 == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  int g, r0, r1;
  if (!find_row_tile<BM>(sizes, G, M, blockIdx.y, sm.offs, sm.tstart, g, r0, r1)) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const long ldb = long(NB) * N;  // row stride of rhs[g]
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

bool dims_ok(int M, int K, int N, int G) {
  return M >= 0 && K > 0 && N > 0 && K % 8 == 0 && N % 8 == 0 && G >= 1 && G + 1 <= MAX_GROUPS;
}

// The persistent grid: one block per SM of the current device, at most one
// per tile of `tiles`, an upper bound on the tiles of the launch.
cudaError_t persistent_grid(long tiles, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = int(tiles < sms ? (tiles > 0 ? tiles : 1) : sms);
  return err;
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of the wgmma kernels (gmm and tgmm).
int ptt_wgmma_smem_bytes() { return WG_SMEM; }

// lhs [M, K] bf16, rhs [G, K, N] bf16 ([G, N, K] when transpose_rhs), bias
// [G, N] bf16 or null, sizes [G] int32, out [M, N] bf16; all contiguous and
// 16-byte aligned, on the current device. Needs K % 8 == 0, N % 8 == 0 and
// 1 <= G <= 255. Returns a CUDA error code: of the device query, of the
// tensor maps' encoding, or cudaGetLastError() after the launch.
int ptt_gmm(const void* lhs, const void* rhs, const void* bias, const void* sizes, void* out,
            int M, int K, int N, int G, int transpose_rhs, void* stream) {
  if (!dims_ok(M, K, N, G)) return int(cudaErrorInvalidValue);
  if (M == 0) return int(cudaSuccess);
  // the row tiles of the G + 1 groups number at most ceil(M / 128) + G + 1
  // whatever the sizes (each group starts its own tiles)
  int grid = 0;
  cudaError_t err = persistent_grid(
      long((M + WG_BM - 1) / WG_BM + G + 1) * ((N + WG_BN - 1) / WG_BN), &grid);
  if (err != cudaSuccess) return int(err);
  CUtensorMap ml, mr, mo;
  const uint64_t ldims[2] = {uint64_t(K), uint64_t(M)}, lstr[1] = {uint64_t(K) * 2};
  const uint64_t odims[2] = {uint64_t(N), uint64_t(M)}, ostr[1] = {uint64_t(N) * 2};
  const uint32_t lbox[2] = {WG_BK, WG_BM}, obox[2] = {64, WG_BM};
  err = hw::encode_tma_bf16(&ml, lhs, 2, ldims, lstr, lbox);
  if (err == cudaSuccess) err = hw::encode_tma_bf16(&mo, out, 2, odims, ostr, obox);
  if (err != cudaSuccess) return int(err);
  if (transpose_rhs) {
    const uint64_t dims[3] = {uint64_t(K), uint64_t(N), uint64_t(G)};
    const uint64_t str[2] = {uint64_t(K) * 2, uint64_t(N) * K * 2};
    const uint32_t box[3] = {WG_BK, WG_BN, 1};
    err = hw::encode_tma_bf16(&mr, rhs, 3, dims, str, box);
  } else {
    const uint64_t dims[3] = {uint64_t(N), uint64_t(K), uint64_t(G)};
    const uint64_t str[2] = {uint64_t(N) * 2, uint64_t(K) * N * 2};
    const uint32_t box[3] = {64, WG_BK, 1};
    err = hw::encode_tma_bf16(&mr, rhs, 3, dims, str, box);
  }
  if (err != cudaSuccess) return int(err);
  const auto* bs = static_cast<const bf16*>(bias);
  const auto* sz = static_cast<const int*>(sizes);
  auto* o = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return int(transpose_rhs ? launch_gmm<true>(ml, mr, mo, bs, sz, o, M, K, N, G, grid, st)
                           : launch_gmm<false>(ml, mr, mo, bs, sz, o, M, K, N, G, grid, st));
}

// lhs [M, K] bf16, w1 [G, K, 2N] bf16, b1 [G, 2N] bf16, sizes [G] int32;
// out, gres, ures [M, N] bf16 (gres and ures both null: out only). Needs K %
// 8 == 0, N % 8 == 0 and 1 <= G <= 255.
int ptt_gmm_swiglu(const void* lhs, const void* w1, const void* b1, const void* sizes,
                   void* out, void* gres, void* ures, int M, int K, int N, int G,
                   void* stream) {
  if (!dims_ok(M, K, N, G) || (gres == nullptr) != (ures == nullptr) || b1 == nullptr)
    return int(cudaErrorInvalidValue);
  constexpr int BM = 128, BN = 64;
  static std::atomic<uint64_t> done{0};
  auto kern = gmm_kernel<BM, BN, 4, 2>;
  const int smem = int(sizeof(GmmSmem<BM, BN>));
  cudaError_t err = ptt::allow_smem(kern, smem, done);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + G + 1);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const int*>(sizes), static_cast<bf16*>(out), static_cast<bf16*>(gres),
      static_cast<bf16*>(ures), M, K, N, G);
  return int(cudaGetLastError());
}

// lhs [M, K] bf16, dout [M, N] bf16, sizes [G] int32, out [G, K, N] bf16.
// Same needs as ptt_gmm.
int ptt_tgmm(const void* lhs, const void* dout, const void* sizes, void* out, int M, int K,
             int N, int G, void* stream) {
  if (!dims_ok(M, K, N, G)) return int(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (M == 0)  // every group is empty
    return int(cudaMemsetAsync(out, 0, size_t(G) * K * N * 2, st));
  int grid = 0;
  cudaError_t err = persistent_grid(
      long(G) * ((K + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN), &grid);
  if (err != cudaSuccess) return int(err);
  CUtensorMap ml, md, mo;
  const uint64_t ldims[2] = {uint64_t(K), uint64_t(M)}, lstr[1] = {uint64_t(K) * 2};
  const uint64_t ddims[2] = {uint64_t(N), uint64_t(M)}, dstr[1] = {uint64_t(N) * 2};
  const uint64_t odims[3] = {uint64_t(N), uint64_t(K), uint64_t(G)};
  const uint64_t ostr[2] = {uint64_t(N) * 2, uint64_t(K) * N * 2};
  const uint32_t box[2] = {64, WG_BK}, obox[3] = {64, WG_BM, 1};
  err = hw::encode_tma_bf16(&ml, lhs, 2, ldims, lstr, box);
  if (err == cudaSuccess) err = hw::encode_tma_bf16(&md, dout, 2, ddims, dstr, box);
  if (err == cudaSuccess) err = hw::encode_tma_bf16(&mo, out, 3, odims, ostr, obox);
  if (err != cudaSuccess) return int(err);
  const auto* sz = static_cast<const int*>(sizes);
  return int(launch_tgmm(ml, md, mo, sz, M, K, N, G, grid, st));
}

}  // extern "C"
