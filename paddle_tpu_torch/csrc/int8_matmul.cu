// Weight-only int8 / int4 GEMM for Hopper (sm_90a): out = (x @ dequant(w)) *
// scale, bf16 activations, f32 accumulation, the per-column scale applied
// once at the end.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/int8_matmul.py
// `int8_weight_matmul` (pl.pallas_call at :143, body `_kernel` :46) and
// `int4_weight_matmul` (:197, body `_kernel_int4` :65).
//
// What it computes: x [M, K] bf16 (M <= 256, row-major), scale [N] f32 and
//   int8: w [K, N] int8, out[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n];
//   int4: w [K/2, N] int8 in the half-split layout of `pack_int4`, each
//     byte r holding q[r] in its low nibble and q[r + K/2] in its high one:
//     out[m, n] = (sum_r x[m, r] * lo(w[r, n]) + x[m, r + K/2] *
//     hi(w[r, n])) * scale[n], lo = ((b & 15) ^ 8) - 8, hi = b >> 4
//     (arithmetic shift of the signed byte).
// The accumulator is f32; it is multiplied by the f32 scale and then cast to
// the output type (bf16 or f32), in the order of `_kernel`'s store.
//
// What bounds it on the H100: device-memory bytes of the weight (K * N, or
// K * N / 2 for int4). At decode (M = 8) the products do 16 operations per
// weight byte, far below the card's ~295 per byte, so the design is about
// keeping weight loads in flight on every SM:
// - One CTA takes 128 output columns and up to 64 rows of x (16 when M <=
//   16), and walks its share of K in steps of 64 logical k. A four-stage
//   cp.async ring keeps three steps of weight bytes (16 bytes a thread) and
//   the matching x columns in flight while one step computes.
// - Each step converts its int8 tile to bf16 in shared memory (exact: every
//   int8 and int4 value is a bf16) with the float magic-number trick
//   (0x4B000000 | biased byte - (2^23 + bias)), and the warps multiply with
//   mma.sync m16n8k16 (ldmatrix for x, ldmatrix.trans for the [k][n] weight
//   tile). Each of the 8 warps owns 16 columns.
// - Few column tiles (N = 4096 gives 32 CTAs for 132 SMs) would leave most
//   SMs idle, so the host splits K across CTAs (blockIdx.z): each split
//   writes an f32 partial [M, N] and a second kernel sums the splits in a
//   fixed order, scales and casts. No atomics, so the result is
//   deterministic. With one split the first kernel scales and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using ptt::bf16;

constexpr int BN = 128;        // output columns per CTA
constexpr int KT = 64;         // logical k per pipeline step
constexpr int STAGES = 4;
constexpr int WARPS = 8;       // each warp owns 16 of the BN columns
constexpr int THREADS = WARPS * 32;
constexpr int XLD = KT + 8;    // bf16 row stride of the x tile
constexpr int WLD = BN + 8;    // bf16 row stride of the converted weight tile

template <int MT, bool INT4>
struct Smem {
  static constexpr int WROWS = INT4 ? KT / 2 : KT;  // int8 weight rows per step
  bf16 x[STAGES][MT * 16][XLD];
  int8_t w[STAGES][WROWS][BN];
  bf16 wb[KT][WLD];
};

// four bytes, each an unsigned value biased by BIAS, to four bf16 (exact):
// 0x4B0000uu is the float 2^23 + uu
template <int BIAS>
__device__ __forceinline__ void biased_bytes_to_bf16(uint32_t u, uint32_t& lo, uint32_t& hi) {
  const float base = 8388608.f + float(BIAS);
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - base;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - base;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - base;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - base;
  lo = ptt::pack_bf16(f0, f1);
  hi = ptt::pack_bf16(f2, f3);
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float a, float b);
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// grid (N / BN, ceil(M / (16 MT)), splits); split z takes k steps
// [z * steps_per_split, min(K / KT, (z + 1) * steps_per_split))
template <int MT, bool INT4, typename OutT>
__global__ void __launch_bounds__(THREADS)
wo_gemm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, OutT* __restrict__ out,
               float* __restrict__ part, int M, int K, int N, int steps_per_split) {
  using S = Smem<MT, INT4>;
  constexpr int ROWS = MT * 16;
  constexpr int WROWS = S::WROWS;
  constexpr int WCH = BN / 16;   // 16-byte chunks in a weight row
  constexpr int XCH = KT / 8;    // 16-byte chunks in an x row of the tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * ROWS;
  const int s_begin = blockIdx.z * steps_per_split;
  const int nsteps = min(K / KT, s_begin + steps_per_split) - s_begin;
  const int half = K / 2;

  auto load_stage = [&](int stage, int s) {
    for (int i = tid; i < WROWS * WCH; i += THREADS) {
      const int r = i / WCH, c = (i % WCH) * 16;
      ptt::cp_async16(&sm.w[stage][r][c], w + long(s * WROWS + r) * N + n0 + c, 16);
    }
    for (int i = tid; i < ROWS * XCH; i += THREADS) {
      const int r = i / XCH, c = (i % XCH) * 8;
      // int4: the tile's first KT/2 columns meet the low nibbles (k in the
      // first half of K), the rest the high nibbles (k + K/2)
      const int k = INT4 ? (c < KT / 2 ? s * (KT / 2) + c : half + s * (KT / 2) + c - KT / 2)
                         : s * KT + c;
      const bool ok = m0 + r < M;
      ptt::cp_async16(&sm.x[stage][r][c], ok ? x + long(m0 + r) * K + k : x, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load_stage(st, s_begin + st);
    ptt::cp_async_commit();
  }

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    ptt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with step i - 1
    const int nxt = i + STAGES - 1;
    if (nxt < nsteps) load_stage(nxt % STAGES, s_begin + nxt);
    ptt::cp_async_commit();
    const int stage = i % STAGES;

    // int8 (or packed int4) tile -> bf16 tile [KT][BN]
    for (int c = tid; c < WROWS * WCH; c += THREADS) {
      const int r = c / WCH, col = (c % WCH) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(&sm.w[stage][r][col]);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[8];
      if constexpr (!INT4) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          biased_bytes_to_bf16<128>(words[j] ^ 0x80808080u, o[2 * j], o[2 * j + 1]);
        *reinterpret_cast<uint4*>(&sm.wb[r][col]) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(&sm.wb[r][col + 8]) = make_uint4(o[4], o[5], o[6], o[7]);
      } else {
        uint32_t h[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          biased_bytes_to_bf16<8>((words[j] & 0x0F0F0F0Fu) ^ 0x08080808u, o[2 * j],
                                  o[2 * j + 1]);
          biased_bytes_to_bf16<8>(((words[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, h[2 * j],
                                  h[2 * j + 1]);
        }
        *reinterpret_cast<uint4*>(&sm.wb[r][col]) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(&sm.wb[r][col + 8]) = make_uint4(o[4], o[5], o[6], o[7]);
        *reinterpret_cast<uint4*>(&sm.wb[KT / 2 + r][col]) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(&sm.wb[KT / 2 + r][col + 8]) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t b[4];
      ptt::load_b_kn<WLD>(b, &sm.wb[0][0], kk * 16, warp * 16, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ptt::load_a<XLD>(a, &sm.x[stage][0][0], mt * 16, kk * 16, lane);
        ptt::mma16816(acc[mt][0], a, b[0], b[1]);
        ptt::mma16816(acc[mt][1], a, b[2], b[3]);
      }
    }
  }
  ptt::cp_async_wait<0>();

  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + mt * 16 + g + hf * 8;
        if (row >= M) continue;
        const int col = n0 + warp * 16 + nt * 8 + c2;
        const float v0 = acc[mt][nt][2 * hf], v1 = acc[mt][nt][2 * hf + 1];
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + (long(blockIdx.z) * M + row) * N + col) =
              make_float2(v0, v1);
        } else {
          store2<OutT>(out + long(row) * N + col, v0 * scale[col], v1 * scale[col + 1]);
        }
      }
}

// out[i] = (sum over splits, in order, of part[s, i]) * scale[i % N]
template <typename OutT>
__global__ void wo_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                 OutT* __restrict__ out, long MN, int N, int splits) {
  const long i = long(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * MN + i];
  store1(out + i, s * scale[i % N]);
}

template <int MT, bool INT4, typename OutT>
cudaError_t launch(const bf16* x, const int8_t* w, const float* scale, OutT* out, float* part,
                   int M, int K, int N, int splits, int steps_per_split, cudaStream_t stream) {
  constexpr int ROWS = MT * 16;
  const int smem = int(sizeof(Smem<MT, INT4>));
  auto kern = wo_gemm_kernel<MT, INT4, OutT>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = ptt::allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, (M + ROWS - 1) / ROWS, splits);
  kern<<<grid, THREADS, smem, stream>>>(x, w, scale, out, splits > 1 ? part : nullptr, M, K, N,
                                        steps_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long MN = long(M) * N;
  wo_reduce_kernel<OutT><<<int((MN + 255) / 256), 256, 0, stream>>>(part, scale, out, MN, N,
                                                                    splits);
  return cudaGetLastError();
}

template <bool INT4, typename OutT>
cudaError_t launch_rows(const bf16* x, const int8_t* w, const float* scale, OutT* out,
                        float* part, int M, int K, int N, int splits, int steps_per_split,
                        cudaStream_t stream) {
  if (M <= 16)
    return launch<1, INT4, OutT>(x, w, scale, out, part, M, K, N, splits, steps_per_split,
                                 stream);
  return launch<4, INT4, OutT>(x, w, scale, out, part, M, K, N, splits, steps_per_split,
                               stream);
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [M, K] bf16, w [K, N] int8 (int4 = 0) or [K/2, N] packed (int4 = 1),
// scale [N] f32, out [M, N] bf16 (out_f32 = 0) or f32 (out_f32 = 1), all
// contiguous and 16-byte aligned. part: f32 scratch [splits, M, N] (unused
// when splits == 1). The k steps (K / 64) are cut into splits of
// steps_per_split; splits * steps_per_split must cover them and every split
// must hold at least one. Needs 1 <= M <= 256, K % 128 == 0 ((K / 2) % 128
// == 0 for int4) and N % 128 == 0. Returns cudaGetLastError() after the
// launches.
int ptt_weight_only_gemm(const void* x, const void* w, const void* scale, void* out,
                         void* part, int M, int K, int N, int splits, int steps_per_split,
                         int int4, int out_f32, void* stream) {
  const int steps = K / KT;
  if (M < 1 || M > 256 || K % 128 != 0 || N % 128 != 0 || (int4 && (K / 2) % 128 != 0) ||
      splits < 1 || steps_per_split < 1 || (splits - 1) * steps_per_split >= steps ||
      splits * steps_per_split < steps || (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  auto* pf = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  if (int4) {
    if (out_f32)
      return int(launch_rows<true, float>(xb, wq, sc, static_cast<float*>(out), pf, M, K, N,
                                          splits, steps_per_split, st));
    return int(launch_rows<true, bf16>(xb, wq, sc, static_cast<bf16*>(out), pf, M, K, N,
                                       splits, steps_per_split, st));
  }
  if (out_f32)
    return int(launch_rows<false, float>(xb, wq, sc, static_cast<float*>(out), pf, M, K, N,
                                         splits, steps_per_split, st));
  return int(launch_rows<false, bf16>(xb, wq, sc, static_cast<bf16*>(out), pf, M, K, N, splits,
                                      steps_per_split, st));
}

}  // extern "C"
