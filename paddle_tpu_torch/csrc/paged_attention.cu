// Paged decode attention for Hopper (sm_90a): bf16 q, bf16 or int8 pages,
// f32 stats.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `paged_attention_pallas` with return_stats=True (pl.pallas_call at :580,
// bodies `_kernel_stats` :129 / `_kernel_body` :151), and without stats
// (:561, `_kernel` :123); the streaming seq-grid variant (:423,
// `_kernel_seq` :216) computes the same function. Its int8 variants
// (`_kernel_quant`, `_kernel_quant_stats` :136-148, `_kernel_seq_quant`
// :357) are the same kernel instantiated on int8 pages (`ptt_paged_decode_int8`).
//
// What it computes, per decode row b and query head h (one query token):
//   s_j = scale * q[b, h] . k[h / group, page_table[b, j / page], j % page]
//   for j < seq_lens[b];  out = softmax(s) v, and with stats
//   m = max_j s_j (NEG_INF = -1e30 when the row is empty, never -inf) and
//   l = sum_j exp(s_j - m). A row with seq_len 0 gives m = -1e30, l = 0,
//   out = 0 — no NaN, so the caller's online-softmax merge of the step's
//   own k/v stays exact.
// Layouts: q [B, H, D] contiguous; k/v pages [KVH, P, page, D] contiguous
// (one layer of the pool); page_table [B, pps] int32; seq_lens [B] int32;
// out [B, H, D] bf16; m, l [B, H] f32.
// int8 pages: k/v pages [KVH, P, page, D] int8 and their block-major scales
// k/v_scales [P, KVH, page] f32 (one layer of the scales pool). Each K/V
// element is dequantized in f32 as float(q) * scale[phys, kv head, slot]
// right before the dot, as `_kernel_body` does (:175-182), so the device
// reads int8 rows plus 8 bytes of scales per (token, kv head).
//
// What bounds it on the H100: device-memory bytes of the K/V it reads (one
// query token per row does 2 operations per byte). The simple design reads
// each valid K/V row exactly once. A decode batch has few (row, kv head)
// pairs (8 x 8 on the serving path), too few CTAs to keep the card's loads
// in flight, so each row is also split into ranges of `pages_per_split`
// pages (flash-decoding): one CTA per (row, kv head, range) loads its own
// page-table row and length and walks only the valid pages of its range
// (never a table entry past ceil(len / page)); the `group` query heads of
// that kv head share every K/V load. Its 8 warps take pages in turn, each
// lane holding D/32 dims of a token in registers with 8 tokens' loads in
// flight, and keep an f32 online softmax per head; the warps' states merge
// in shared memory and the CTA writes one partial (m, l, unnormalised acc)
// per head. A second kernel merges a row's ranges into out, m and l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 8;  // tokens whose loads are in flight together
constexpr float NEG_INF = -1e30f;

template <int N>
__device__ __forceinline__ void load_kv(const bf16* p, float (&out)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 dims per lane");
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    out[0] = a.x; out[1] = a.y;
  }
}

template <int N>
__device__ __forceinline__ void load_kv(const int8_t* p, float (&out)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 dims per lane");
  if constexpr (N == 4) {
    const char4 raw = *reinterpret_cast<const char4*>(p);
    out[0] = float(raw.x); out[1] = float(raw.y); out[2] = float(raw.z); out[3] = float(raw.w);
  } else {
    const char2 raw = *reinterpret_cast<const char2*>(p);
    out[0] = float(raw.x); out[1] = float(raw.y);
  }
}

// partial state of (row b, head h, range s) at [(b * H + h) * splits + s].
// KV is bf16 or int8; with int8, ks/vs are the layer's [P, KVH, page] scales.
template <int D, int G, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_partial_kernel(const bf16* __restrict__ q, const KV* __restrict__ kp,
                     const KV* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ table,
                     const int* __restrict__ lens, float* __restrict__ part_m,
                     float* __restrict__ part_l, float* __restrict__ part_acc,
                     int H, int num_pages, int page, int pps, int pages_per_split,
                     float scale) {
  constexpr int DPL = D / 32;  // dims per lane
  constexpr bool QUANT = sizeof(KV) == 1;
  __shared__ float s_m[WARPS][G];
  __shared__ float s_l[WARPS][G];
  __shared__ float s_acc[WARPS][G][D];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lens[b];
  const int p_begin = split * pages_per_split;
  const int p_end = min((len + page - 1) / page, p_begin + pages_per_split);

  float qf[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_kv<DPL>(q + (long(b) * H + kh * G + g) * D + lane * DPL, qf[g]);
#pragma unroll
    for (int e = 0; e < DPL; ++e) qf[g][e] *= scale;
  }
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  const long page_elems = long(page) * D;
  const KV* kbase = kp + long(kh) * num_pages * page_elems + lane * DPL;
  const KV* vbase = vp + long(kh) * num_pages * page_elems + lane * DPL;
  const int* trow = table + long(b) * pps;
  const int KVH = gridDim.y;

  for (int p = p_begin + warp; p < p_end; p += WARPS) {
    const long phys = trow[p];
    const KV* kpage = kbase + phys * page_elems;
    const KV* vpage = vbase + phys * page_elems;
    // this page's scale row of this kv head (block-major scales)
    const long srow = (phys * KVH + kh) * page;
    const int t_end = min(page, len - p * page);
    for (int t0 = 0; t0 < t_end; t0 += CHUNK) {
      const int n = min(CHUNK, t_end - t0);
      float kr[CHUNK][DPL], vr[CHUNK][DPL];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        if (c < n) {
          load_kv<DPL>(kpage + long(t0 + c) * D, kr[c]);
          load_kv<DPL>(vpage + long(t0 + c) * D, vr[c]);
          if constexpr (QUANT) {
            const float sk = ks[srow + t0 + c], sv = vs[srow + t0 + c];
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              kr[c][e] *= sk;
              vr[c][e] *= sv;
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          float d = 0.f;
          if (c < n) {
#pragma unroll
            for (int e = 0; e < DPL; ++e) d += qf[g][e] * kr[c][e];
          }
          s[c] = d;
        }
        // all-reduce the CHUNK partial dots across the warp
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int c = 0; c < CHUNK; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
        }
        float cmax = NEG_INF;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < n) cmax = fmaxf(cmax, s[c]);
        const float m_new = fmaxf(m[g], cmax);
        const float alpha = __expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          if (c < n) {
            const float pc = __expf(s[c] - m_new);
            psum += pc;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[g][e] += pc * vr[c][e];
          }
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) s_acc[warp][g][lane * DPL + e] = acc[g][e];
  }
  __syncthreads();

  // merge the warps' softmax states; a warp that saw no page holds
  // (NEG_INF, 0, 0) and contributes nothing
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(s_m[w][g] - M);
      Lsum += s_l[w][g] * f;
      O += s_acc[w][g][d] * f;
    }
    const long slot = (long(b) * H + kh * G + g) * splits + split;
    part_acc[slot * D + d] = O;
    if (d == 0) {
      part_m[slot] = M;
      part_l[slot] = Lsum;
    }
  }
}

// One CTA per (row, head), D threads: merge the row's ranges. A row with
// no valid page anywhere ends with m = NEG_INF, l = 0 and out = 0.
template <int D>
__global__ void __launch_bounds__(D)
paged_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, bf16* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int splits) {
  const long row = blockIdx.x;  // b * H + h
  const int d = threadIdx.x;
  const float* pm = part_m + row * splits;
  const float* pl = part_l + row * splits;
  float M = NEG_INF;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[s]);
  float Lsum = 0.f, O = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float f = __expf(pm[s] - M);
    Lsum += pl[s] * f;
    O += part_acc[(row * splits + s) * D + d] * f;
  }
  out[row * D + d] = __float2bfloat16(Lsum > 0.f ? O / Lsum : 0.f);
  if (d == 0 && m_out != nullptr) {
    m_out[row] = M;
    l_out[row] = Lsum;
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *lens;
  void *out, *m, *l, *part_m, *part_l, *part_acc;
  int B, H, KVH, num_pages, page, pps, pages_per_split;
  float scale;
  cudaStream_t stream;
};

template <int D, int G, typename KV>
cudaError_t launch(const Args& a) {
  const int splits = (a.pps + a.pages_per_split - 1) / a.pages_per_split;
  paged_partial_kernel<D, G, KV><<<dim3(a.B, a.KVH, splits), THREADS, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.lens), static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.H, a.num_pages,
      a.page, a.pps, a.pages_per_split, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<D><<<a.B * a.H, D, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<bf16*>(a.out),
      static_cast<float*>(a.m), static_cast<float*>(a.l), splits);
  return cudaGetLastError();
}

template <int D, typename KV>
cudaError_t launch_group(const Args& a) {
  switch (a.H / a.KVH) {
    case 1: return launch<D, 1, KV>(a);
    case 2: return launch<D, 2, KV>(a);
    case 4: return launch<D, 4, KV>(a);
    case 8: return launch<D, 8, KV>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
int launch_dim(const Args& a, int d) {
  if (a.B <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 || a.page <= 0 || a.pps <= 0 ||
      a.pages_per_split <= 0)
    return int(cudaErrorInvalidValue);
  if (d == 128) return int(launch_group<128, KV>(a));
  if (d == 64) return int(launch_group<64, KV>(a));
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// m and l may be null (no stats). part_m, part_l [B, H, splits] and
// part_acc [B, H, splits, D] are f32 scratch, splits = ceil(pps /
// pages_per_split). Returns cudaGetLastError() after the launches.
int ptt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* seq_lens, void* out, void* m,
                     void* l, void* part_m, void* part_l, void* part_acc, int B, int H,
                     int KVH, int num_pages, int page, int pps, int pages_per_split, int d,
                     float scale, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, page_table, seq_lens, out, m, l,
               part_m, part_l, part_acc, B, H, KVH, num_pages, page, pps, pages_per_split,
               scale, static_cast<cudaStream_t>(stream)};
  return launch_dim<bf16>(a, d);
}

// The same over int8 pages [KVH, P, page, D] with their f32 scales
// k_scales / v_scales [P, KVH, page].
int ptt_paged_decode_int8(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales, const void* page_table,
                          const void* seq_lens, void* out, void* m, void* l, void* part_m,
                          void* part_l, void* part_acc, int B, int H, int KVH, int num_pages,
                          int page, int pps, int pages_per_split, int d, float scale,
                          void* stream) {
  if (k_scales == nullptr || v_scales == nullptr) return int(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, k_scales, v_scales, page_table, seq_lens, out, m, l,
               part_m, part_l, part_acc, B, H, KVH, num_pages, page, pps, pages_per_split,
               scale, static_cast<cudaStream_t>(stream)};
  return launch_dim<int8_t>(a, d);
}

}  // extern "C"
