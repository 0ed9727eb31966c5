// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py `_fwd`
// (pl.pallas_call at :266, body `_fwd_kernel` at :100) on the serving
// prefill path (fused_multi_transformer, s > 8 branch) and the training
// forward (LlamaAttention through the autograd Function).
//
// What it computes: out = softmax(scale * q k^T + mask) v, per (batch, query
// head), with
//   * GQA: query head h reads kv head h / (hq / hk) (the jnp.repeat order);
//     K/V are never repeated in memory;
//   * causal masking with a bottom-right offset: row r sees column c iff
//     c <= q_offset + r;
//   * kv_len: columns >= kv_len are masked.
// Layout is BSHD: q [b, sq, hq, d], k/v [b, sk, hk, d], out [b, sq, hq, d],
// all contiguous; d is 64 or 128. With a non-null `lse` it also writes the
// f32 row logsumexp lse [b, hq, sq] of the scaled, masked scores in
// natural-log units (JAX's lse [b, h, sq, 1] at :192), which the backward
// (flash_attention_bwd.cu) reads; a row that sees no column gets
// -1e30 * ln 2, as the JAX kernel writes, and the backward gives it zero
// gradients. A null `lse` skips the write (the serving path).
//
// What bounds it on the H100: tensor-core operations (prefill at S >= 512
// does ~S*d operations per byte of q/k/v, far above the card's ~295 ops per
// byte). The design is FlashAttention-2 on mma.sync: one CTA per (64-row q
// tile, head, batch), four warps of 16 q rows each. The scores, the
// probabilities and the output accumulator stay in registers (the score
// fragment of Q K^T is reused as the A operand of P V), the running max and
// sum are f32 in the base-2 domain, and K/V tiles of 64 rows stream through
// a two-stage cp.async ring in shared memory (padded rows, ldmatrix loads),
// so the next tile's loads overlap this tile's products. Tiles past the
// last visible column (q_offset + last row, or kv_len) are skipped, not
// masked. wgmma, TMA and warp specialisation are later work.

#include "flash_common.cuh"

namespace {

using namespace ptt;

template <int D>
struct Layout {
  static constexpr int LD = D + 8;                   // padded row, bf16
  static constexpr int TILE = BN * LD;               // one K or V tile
  static constexpr size_t BYTES = size_t(BM * LD + 4 * TILE) * 2;  // Q + 2 x (K, V)
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int sq, int sk, int hq, int hk, int kv_len, int q_offset, int causal,
                 float scale_log2) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int NT = BN / 8;   // 8-column score tiles
  constexpr int OT = D / 8;    // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BM * LD;    // stage s: K at sKV + 2 s TILE, V right after

  // causal tiles further down do more work: launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long q_stride = long(hq) * D, kv_stride = long(hk) * D;
  const bf16* qb = q + long(b) * sq * q_stride + long(h) * D;
  const bf16* kb = k + long(b) * sk * kv_stride + long(kvh) * D;
  const bf16* vb = v + long(b) * sk * kv_stride + long(kvh) * D;
  bf16* ob = out + long(b) * sq * q_stride + long(h) * D;

  // columns this tile's rows may see: [0, n_end)
  int n_end = min(kv_len, sk);
  if (causal) n_end = min(n_end, q_offset + min(q0 + BM, sq));
  const int n_tiles = n_end > 0 ? (n_end + BN - 1) / BN : 0;

  load_tile<D>(sQ, qb, q_stride, q0, BM, sq, tid);
  if (n_tiles > 0) {
    load_tile<D>(sKV, kb, kv_stride, 0, BN, n_end, tid);
    load_tile<D>(sKV + L::TILE, vb, kv_stride, 0, BN, n_end, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's Q rows as A fragments, one per k-step
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qa[ks], sQ + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);

  // thread owns rows g and g + 8 of the warp's 16, columns 2 * (lane % 4) + {0, 1}
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const int lim_a = causal ? min(n_end, q_offset + row_a + 1) : n_end;
  const int lim_b = causal ? min(n_end, q_offset + row_b + 1) : n_end;
  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_a = NEG_BIG, m_b = NEG_BIG, l_a = 0.f, l_b = 0.f;  // l: this thread's columns

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      bf16* nk = sKV + ((t + 1) % 2) * 2 * L::TILE;
      load_tile<D>(nk, kb, kv_stride, (t + 1) * BN, BN, n_end, tid);
      load_tile<D>(nk + L::TILE, vb, kv_stride, (t + 1) * BN, BN, n_end, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sKV + (t % 2) * 2 * L::TILE;
    const bf16* sV = sK + L::TILE;
    const int k0 = t * BN;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + ks * 16 +
                            ((lane / 8) % 2) * 8);
        mma16816(s[2 * np], qa[ks], kf[0], kf[1]);
        mma16816(s[2 * np + 1], qa[ks], kf[2], kf[3]);
      }
    }

    // online softmax (base 2) on rows a and b; masked columns get p = 0
    float mx_a = NEG_BIG, mx_b = NEG_BIG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + c2 + e;
        s[j][e] = col < lim_a ? s[j][e] * scale_log2 : NEG_BIG;
        s[j][2 + e] = col < lim_b ? s[j][2 + e] * scale_log2 : NEG_BIG;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + c2 + e;
        s[j][e] = col < lim_a ? exp2f(s[j][e] - mn_a) : 0.f;
        s[j][2 + e] = col < lim_b ? exp2f(s[j][2 + e] - mn_b) : 0.f;
        sum_a += s[j][e];
        sum_b += s[j][2 + e];
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int d = 0; d < OT; ++d) {
      o[d][0] *= al_a;
      o[d][1] *= al_a;
      o[d][2] *= al_b;
      o[d][3] *= al_b;
    }

    // O += P V: the score fragments of columns 16 kk .. 16 kk + 15 are the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                  dp * 16 + (lane / 16) * 8);
        mma16816(o[2 * dp], pa, vf[0], vf[1]);
        mma16816(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is reloaded two tiles from now
  }
  cp_async_wait<0>();

  // full row sums, then out = O / l (rows that saw nothing write zeros),
  // staged through this warp's rows of sQ for 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  if (lse != nullptr && lane % 4 == 0) {
    // m is base 2 and scaled; lse = (m + log2 l) ln 2, l = 0 read as 1
    float* lb = lse + (long(b) * hq + h) * sq;
    if (row_a < sq) lb[row_a] = (m_a + log2f(l_a > 0.f ? l_a : 1.f)) * LN2;
    if (row_b < sq) lb[row_b] = (m_b + log2f(l_b > 0.f ? l_b : 1.f)) * LN2;
  }
#pragma unroll
  for (int d = 0; d < OT; ++d) {
    o[d][0] *= inv_a;
    o[d][1] *= inv_a;
    o[d][2] *= inv_b;
    o[d][3] *= inv_b;
  }
  store_rows<D>(ob, q_stride, q0 + warp * 16, sq, sQ + warp * 16 * LD, o, 1.f, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int sq, int sk, int hq, int hk, int kv_len, int q_offset, int causal,
                   float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BM - 1) / BM, hq, b);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, sq, sk, hq, hk, kv_len, q_offset, causal, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [b, sq, hq, d], k/v [b, sk, hk, d], out [b, sq, hq, d]: contiguous bf16;
// lse [b, hq, sq] f32 or null. Returns cudaGetLastError() after the launch
// (0 on success).
int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int b,
                  int sq, int sk, int hq, int hk, int d, int kv_len, int q_offset, int causal,
                  float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hk <= 0 || hq % hk != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return int(launch<128>(q, k, v, out, static_cast<float*>(lse), b, sq, sk, hq, hk, kv_len,
                           q_offset, causal, scale, s));
  if (d == 64)
    return int(launch<64>(q, k, v, out, static_cast<float*>(lse), b, sq, sk, hq, hk, kv_len,
                          q_offset, causal, scale, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
