// Flash attention backward for Hopper (sm_90a): bf16 q, k, v, out, dout and
// the forward's f32 lse in; bf16 dq, dk, dv out, accumulated in f32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py `_bwd`
// (pl.pallas_call at :453, body `_bwd_fused_kernel` at :306) on the
// training path (the autograd Function in ops/fused/flash_attention.py).
// It covers exactly the forward's subset: causal with a bottom-right
// q_offset (row r sees column c iff c <= q_offset + r), kv_len (columns >=
// kv_len masked), GQA (query head h reads kv head h / (hq / hk)), d in
// {64, 128}, BSHD layout: q, out, dout, dq [b, sq, hq, d]; k, v, dk, dv
// [b, sk, hk, d]; lse [b, hq, sq] f32 in natural-log units.
//
// With z = scale * q k^T (masked), P = exp(z - lse), the gradients are
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
//
// What bounds it on the H100: tensor-core operations. It does five
// products over the visible (row, column) pairs, 2.5 times the forward's
// operations, on the same bytes.
//
// Design: the FlashAttention-2 split, not the TPU kernel's. The Pallas
// kernel leans on a sequential grid: it writes a partial dq per kv block
// ([b, h, nk, sq, d] f32, summed by XLA) and dk/dv per query head, summed
// over the GQA group by XLA. With Hopper-sized tiles that partial dq alone
// would be gigabytes. Here three kernels run in order:
//   1. delta = rowsum(dO * O) in f32, one warp per (batch, row, head);
//   2. dK/dV: one CTA per (64-row kv block, kv head, batch). Four warps own
//      16 kv rows each and keep their dK and dV accumulators in registers;
//      the CTA loops over the group's query heads and the q blocks the
//      causal band allows, streaming Q, dO, lse and delta through a
//      two-stage cp.async ring. It computes S^T = K Q^T and dP^T = V dO^T
//      directly, so P^T and dS^T are already A fragments of dV += P^T dO
//      and dK += dS^T Q;
//   3. dQ: one CTA per (64-row q block, query head, batch), four warps of
//      16 q rows holding Q's fragments and the dQ accumulator in registers,
//      looping over the visible kv blocks (two-stage ring of K and V) with
//      dS = P (dP - delta) fed straight into dQ += dS K.
// No atomics and no partial buffers, so the result is deterministic. P is
// recomputed in both kernels from lse. At d = 128 the dK/dV kernel takes
// 32 q rows per step (BMQ) to keep its two 16 x 128 f32 accumulators and
// two score tiles in registers without spills; at d = 64 it takes 64.
// mma.sync m16n8k16 and cp.async as in the forward; wgmma, TMA and warp
// specialisation are later work.

#include "flash_common.cuh"

namespace {

using namespace ptt;

template <int D>
constexpr int dkdv_rows() {
  return D == 128 ? 32 : 64;
}

template <int D>
struct BwdLayout {
  static constexpr int LD = D + 8;
  static constexpr int BMQ = dkdv_rows<D>();   // q rows per step of the dK/dV loop
  static constexpr int KV_TILE = BN * LD;
  static constexpr int Q_TILE = BMQ * LD;
  // dK/dV: K, V, then 2 stages x (Q, dO) bf16, then 2 stages x (lse, delta) f32
  static constexpr size_t DKDV_BYTES = size_t(2 * KV_TILE + 4 * Q_TILE) * 2 + size_t(4 * BMQ) * 4;
  // dQ: Q, dO, then 2 stages x (K, V)
  static constexpr size_t DQ_BYTES = size_t(2 * BM * LD + 4 * KV_TILE) * 2;
};

// delta[b, h, r] = sum_d dO[b, r, h, d] * O[b, r, h, d] in f32; one warp per row
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int b, int sq, int hq) {
  const long rows = long(b) * sq * hq;
  const long row = long(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* o = out + row * D;
  const bf16* g = dout + row * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 2; c < D; c += 64) {
    const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + c));
    acc += of.x * gf.x + of.y * gf.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (bi * sq + r) * hq + h  ->  delta[(bi * hq + h) * sq + r]
    const long h = row % hq, r = (row / hq) % sq, bi = row / (long(hq) * sq);
    delta[(bi * hq + h) * sq + r] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int hq,
                      int hk, int kv_len, int q_offset, int causal, float scale,
                      float scale_log2) {
  using L = BwdLayout<D>;
  constexpr int LD = L::LD;
  constexpr int BMQ = L::BMQ;
  constexpr int KS = D / 16;     // k-steps over the head dim
  constexpr int NT = BMQ / 8;    // 8-column tiles of S^T (q columns)
  constexpr int OT = D / 8;      // 8-column tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + L::KV_TILE;
  bf16* sQ = sV + L::KV_TILE;    // stage s: Q at sQ + 2 s Q_TILE, dO right after
  float* sStat = reinterpret_cast<float*>(sQ + 4 * L::Q_TILE);  // stage s: lse, delta

  const int n0 = blockIdx.x * BN;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = hq / hk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long q_stride = long(hq) * D, kv_stride = long(hk) * D;
  const bf16* kb = k + long(b) * sk * kv_stride + long(kvh) * D;
  const bf16* vb = v + long(b) * sk * kv_stride + long(kvh) * D;

  // q rows that can see a column of this block start at i_min
  const int kv_end = min(kv_len, sk);
  const int i_min = causal ? max(0, n0 - q_offset) : 0;
  const int t0 = i_min / BMQ;
  const int nt = (n0 < kv_end && i_min < sq) ? (sq + BMQ - 1) / BMQ - t0 : 0;
  const int iters = nt * group;   // (query head of the group, q block) pairs

  auto fetch = [&](int it, int stage) {
    const int h = kvh * group + it / nt;
    const int q0 = (t0 + it % nt) * BMQ;
    const long off = long(b) * sq * q_stride + long(h) * D;
    bf16* dst = sQ + stage * 2 * L::Q_TILE;
    load_tile<D>(dst, q + off, q_stride, q0, BMQ, sq, tid);
    load_tile<D>(dst + L::Q_TILE, dout + off, q_stride, q0, BMQ, sq, tid);
    const float* lb = lse + (long(b) * hq + h) * sq;
    const float* eb = delta + (long(b) * hq + h) * sq;
    float* st = sStat + stage * 2 * BMQ;
    for (int r = tid; r < BMQ; r += THREADS) {
      const bool ok = q0 + r < sq;
      st[r] = ok ? lb[q0 + r] * LOG2E : 0.f;
      st[BMQ + r] = ok ? eb[q0 + r] : 0.f;
    }
  };

  load_tile<D>(sK, kb, kv_stride, n0, BN, kv_end, tid);
  load_tile<D>(sV, vb, kv_stride, n0, BN, kv_end, tid);
  if (iters > 0) fetch(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // thread owns kv rows j_a, j_b (= j_a + 8) of the warp's 16, and q
  // columns c2, c2 + 1 of each 8-column tile
  const int gq = lane / 4, c2 = 2 * (lane % 4);
  const int j_a = n0 + warp * 16 + gq, j_b = j_a + 8;
  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) fetch(it + 1, (it + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ + (it % 2) * 2 * L::Q_TILE;
    const bf16* cO = cQ + L::Q_TILE;
    const float* cL = sStat + (it % 2) * 2 * BMQ;   // lse in base 2
    const float* cD = cL + BMQ;
    const int q0 = (t0 + it % nt) * BMQ;

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 kv rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, sK, warp * 16, ks * 16, lane);
      load_a<LD>(va, sV, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t qf[4], of[4];
        load_b_nk<LD>(qf, cQ, np * 16, ks * 16, lane);
        load_b_nk<LD>(of, cO, np * 16, ks * 16, lane);
        mma16816(s[2 * np], ka, qf[0], qf[1]);
        mma16816(s[2 * np + 1], ka, qf[2], qf[3]);
        mma16816(dp[2 * np], va, of[0], of[1]);
        mma16816(dp[2 * np + 1], va, of[2], of[3]);
      }
    }

    // P^T = exp(z - lse) on visible pairs, else 0; dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + c2 + e, i = q0 + col;
        const bool ok = i < sq;
        const bool vis_a = ok && j_a < kv_end && (!causal || j_a <= q_offset + i);
        const bool vis_b = ok && j_b < kv_end && (!causal || j_b <= q_offset + i);
        const float p_a = vis_a ? exp2f(s[j][e] * scale_log2 - cL[col]) : 0.f;
        const float p_b = vis_b ? exp2f(s[j][2 + e] * scale_log2 - cL[col]) : 0.f;
        s[j][e] = p_a;
        s[j][2 + e] = p_b;
        dp[j][e] = p_a * (dp[j][e] - cD[col]);
        dp[j][2 + e] = p_b * (dp[j][2 + e] - cD[col]);
      }
    }

    // dV += P^T dO, dK += dS^T Q: k-steps over the q rows of the block
#pragma unroll
    for (int kk = 0; kk < BMQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pack_a<NT>(pa, s, kk);
      pack_a<NT>(da, dp, kk);
#pragma unroll
      for (int dd = 0; dd < OT / 2; ++dd) {
        uint32_t of[4], qf[4];
        load_b_kn<LD>(of, cO, kk * 16, dd * 16, lane);
        load_b_kn<LD>(qf, cQ, kk * 16, dd * 16, lane);
        mma16816(dv_acc[2 * dd], pa, of[0], of[1]);
        mma16816(dv_acc[2 * dd + 1], pa, of[2], of[3]);
        mma16816(dk_acc[2 * dd], da, qf[0], qf[1]);
        mma16816(dk_acc[2 * dd + 1], da, qf[2], qf[3]);
      }
    }
    __syncthreads();  // this stage is reloaded two steps from now
  }
  cp_async_wait<0>();
  __syncthreads();

  // each warp stages its own 16 rows through its rows of sK / sV
  bf16* dkb = dk + long(b) * sk * kv_stride + long(kvh) * D;
  bf16* dvb = dv + long(b) * sk * kv_stride + long(kvh) * D;
  store_rows<D>(dkb, kv_stride, n0 + warp * 16, sk, sK + warp * 16 * LD, dk_acc, scale, lane);
  store_rows<D>(dvb, kv_stride, n0 + warp * 16, sk, sV + warp * 16 * LD, dv_acc, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int sq, int sk, int hq, int hk, int kv_len,
                    int q_offset, int causal, float scale, float scale_log2) {
  using L = BwdLayout<D>;
  constexpr int LD = L::LD;
  constexpr int KS = D / 16;   // k-steps over the head dim
  constexpr int NT = BN / 8;   // 8-column score tiles
  constexpr int OT = D / 8;    // 8-column tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + BM * LD;
  bf16* sKV = sO + BM * LD;    // stage s: K at sKV + 2 s KV_TILE, V right after

  // causal blocks further down do more work: launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long q_stride = long(hq) * D, kv_stride = long(hk) * D;
  const long qoff = long(b) * sq * q_stride + long(h) * D;
  const bf16* kb = k + long(b) * sk * kv_stride + long(kvh) * D;
  const bf16* vb = v + long(b) * sk * kv_stride + long(kvh) * D;

  int n_end = min(kv_len, sk);
  if (causal) n_end = min(n_end, q_offset + min(q0 + BM, sq));
  const int n_tiles = n_end > 0 ? (n_end + BN - 1) / BN : 0;

  load_tile<D>(sQ, q + qoff, q_stride, q0, BM, sq, tid);
  load_tile<D>(sO, dout + qoff, q_stride, q0, BM, sq, tid);
  if (n_tiles > 0) {
    load_tile<D>(sKV, kb, kv_stride, 0, BN, n_end, tid);
    load_tile<D>(sKV + L::KV_TILE, vb, kv_stride, 0, BN, n_end, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a<LD>(qa[ks], sQ, warp * 16, ks * 16, lane);

  // thread owns rows a and a + 8 of the warp's 16, columns c2, c2 + 1 of
  // each 8-column tile; rows past sq see nothing
  const int gq = lane / 4, c2 = 2 * (lane % 4);
  const int row_a = q0 + warp * 16 + gq, row_b = row_a + 8;
  const bool ok_a = row_a < sq, ok_b = row_b < sq;
  const int lim_a = !ok_a ? 0 : causal ? min(n_end, q_offset + row_a + 1) : n_end;
  const int lim_b = !ok_b ? 0 : causal ? min(n_end, q_offset + row_b + 1) : n_end;
  const float* lb = lse + (long(b) * hq + h) * sq;
  const float* eb = delta + (long(b) * hq + h) * sq;
  const float lse_a = ok_a ? lb[row_a] * LOG2E : 0.f, lse_b = ok_b ? lb[row_b] * LOG2E : 0.f;
  const float dl_a = ok_a ? eb[row_a] : 0.f, dl_b = ok_b ? eb[row_b] : 0.f;
  float acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      bf16* nk = sKV + ((t + 1) % 2) * 2 * L::KV_TILE;
      load_tile<D>(nk, kb, kv_stride, (t + 1) * BN, BN, n_end, tid);
      load_tile<D>(nk + L::KV_TILE, vb, kv_stride, (t + 1) * BN, BN, n_end, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sKV + (t % 2) * 2 * L::KV_TILE;
    const bf16* sV = sK + L::KV_TILE;
    const int k0 = t * BN;

    // S = Q K^T and dP = dO V^T over this warp's 16 q rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t oa[4];
      load_a<LD>(oa, sO, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4], vf[4];
        load_b_nk<LD>(kf, sK, np * 16, ks * 16, lane);
        load_b_nk<LD>(vf, sV, np * 16, ks * 16, lane);
        mma16816(s[2 * np], qa[ks], kf[0], kf[1]);
        mma16816(s[2 * np + 1], qa[ks], kf[2], kf[3]);
        mma16816(dp[2 * np], oa, vf[0], vf[1]);
        mma16816(dp[2 * np + 1], oa, vf[2], vf[3]);
      }
    }

    // dS = P (dP - delta), P = exp(z - lse) on visible columns, else 0
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + c2 + e;
        const float p_a = col < lim_a ? exp2f(s[j][e] * scale_log2 - lse_a) : 0.f;
        const float p_b = col < lim_b ? exp2f(s[j][2 + e] * scale_log2 - lse_b) : 0.f;
        s[j][e] = p_a * (dp[j][e] - dl_a);
        s[j][2 + e] = p_b * (dp[j][2 + e] - dl_b);
      }
    }

    // dQ += dS K: k-steps over the kv rows of the tile
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t da[4];
      pack_a<NT>(da, s, kk);
#pragma unroll
      for (int dd = 0; dd < OT / 2; ++dd) {
        uint32_t kf[4];
        load_b_kn<LD>(kf, sK, kk * 16, dd * 16, lane);
        mma16816(acc[2 * dd], da, kf[0], kf[1]);
        mma16816(acc[2 * dd + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();  // this stage is reloaded two tiles from now
  }
  cp_async_wait<0>();

  // each warp read only its own rows of sQ: stage dQ through them
  store_rows<D>(dq + qoff, q_stride, q0 + warp * 16, sq, sQ + warp * 16 * LD, acc, scale, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int sq, int sk, int hq, int hk, int kv_len, int q_offset,
                   int causal, float scale, cudaStream_t stream) {
  using L = BwdLayout<D>;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(dout);
  const long rows = long(b) * sq * hq;
  flash_bwd_delta_kernel<D><<<unsigned((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(out), gp, delta, b, sq, hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(L::DKDV_BYTES));
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<dim3((sk + BN - 1) / BN, hk, b), THREADS, L::DKDV_BYTES, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, hq,
      hk, kv_len, q_offset, causal, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::DQ_BYTES));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3((sq + BM - 1) / BM, hq, b), THREADS, L::DQ_BYTES, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<bf16*>(dq), sq, sk, hq, hk, kv_len, q_offset,
      causal, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out, dout, dq [b, sq, hq, d]; k, v, dk, dv [b, sk, hk, d]: contiguous
// bf16. lse [b, hq, sq] f32 from the forward; delta [b, hq, sq] f32 scratch.
// Runs three kernels (delta, dK/dV, dQ) on `stream`; returns
// cudaGetLastError() after the launches (0 on success).
int ptt_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                  int b, int sq, int sk, int hq, int hk, int d, int kv_len, int q_offset,
                  int causal, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hk <= 0 || hq % hk != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (d == 128)
    return int(launch<128>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, hq, hk, kv_len,
                           q_offset, causal, scale, s));
  if (d == 64)
    return int(launch<64>(q, k, v, out, dout, l, dl, dq, dk, dv, b, sq, sk, hq, hk, kv_len,
                          q_offset, causal, scale, s));
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
