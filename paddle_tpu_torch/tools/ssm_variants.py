"""Time variants of the chunk-parallel SSM kernels (``csrc/selective_scan.cu``,
``csrc/ssd.cu``, ``csrc/wkv.cu``) against the sources as they are, on one
CUDA card:

    python3 -m paddle_tpu_torch.tools.ssm_variants [VARIANT ...]

Each variant is the sources with a few lines replaced (``VARIANTS``; "a+b"
applies the edits of both), built by nvcc into ``build/ssm_variants/`` and
loaded beside the others (``tools/_variants.py``). Every build runs, in
bf16 at the shapes of ``chip_smoke.py`` phase 3, each call whose source a
named variant edits (every call when none is named): the scan forward and
backward at phase 9's b16 l1024 d1536 n16, the SSD backward and forward at phase 11's
b8 l1024 h24 dh64 ds64 with x, B and C strided as the model's, the WKV
forward (its base also against the plain version) and backward at phase
10's b16 l1024 h12 d64; a backward's residual comes from the sources as
they are. Prints per call the mean device ms of each build,
the source as it is first and last: each call alone after the 50 MB L2 was
flushed ("cold", as ``chip_smoke.py`` times) and ten calls back to back
("warm"), then each build's ms per kernel of a call (``torch.profiler``).
A call is what the wrapper does: the kernels and the sums of their
partials. Every variant's outputs but the diagnostic ones'
(``DIAGNOSTIC``: each takes work out, to show what holds a kernel back) are
held against the source's (max |diff| <= 1e-2 of max |source|, the bf16
gate of ``chip_smoke.py``). Ends with the card's name, power limit and
clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch
import torch.nn.functional as F

from ..ops.cuda import _build
from . import _variants

SCAN, SSD, WKV = "selective_scan", "ssd", "wkv"


def _const(src, name, old, new):
    return (src, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


def _no_products(src):
    """Every mma_tile of ``src`` made a no-op (a diagnostic)."""
    return [(src, "using namespace ptt::ssm;",
             "using namespace ptt::ssm;\n"
             "template <int K, int NT, bool AT, bool BT, typename T>\n"
             "__device__ __forceinline__ void skip_tile(float (&)[NT][4], "
             "const T*, int, const T*, int, int, int, int) {}"),
            (src, "mma_tile<", "skip_tile<")]


# The scan forward as three launches over (channel tile, chunk, b): each
# chunk's end state from zero and its sum of delta; a pass over the chunks
# (the state entering chunk c + 1 is exp(A sum delta) o h_in(c) + local(c)),
# which writes the chunk states; each chunk's y from its true start state.
# Two exponentials per (b, t, d, n). The sums of delta borrow y's memory
# (b nc d f32 fits in b l d values while l >= 2 nc), as they are read before
# y is written.
_CHUNKED = r"""
__device__ __forceinline__ void load_raw(float (&v)[FWD_NS], const float* p) {
  load_states(v, p);
}
__device__ __forceinline__ void load_raw(float (&v)[FWD_NS], const bf16* p) {
#pragma unroll
  for (int i = 0; i < FWD_NS; ++i) v[i] = __bfloat162float(p[i]);
}

template <typename T, bool LOCAL>
__global__ void __launch_bounds__(FWD_THREADS, 3)
scan_fwd_chunk_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ C, T* __restrict__ y, float* __restrict__ bounds,
                      float* __restrict__ dsum, int L, int D, int ld, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<T>& s = *reinterpret_cast<FwdSmem<T>*>(smem_raw);
  const int tid = threadIdx.x, q = tid % FWD_LPC, cl = tid / FWD_LPC;
  const int ch0 = blockIdx.x * FWD_TD, ch = ch0 + cl, c = blockIdx.y, bi = blockIdx.z;
  const bool active = ch < D;
  const int nc = (L + CHUNK - 1) / CHUNK, len = min(CHUNK, L - c * CHUNK);
  const size_t row0 = size_t(bi) * L + c * CHUNK;
  stage_chunk(s.in[0], u, delta, B, C, row0, len, ld, ch0);
  float* sc = bounds + (size_t(bi) * nc + c) * n * D + ch;
  float a[FWD_NS], h[FWD_NS];
#pragma unroll
  for (int i = 0; i < FWD_NS; ++i) {
    const int k = q * FWD_NS + i;
    const bool on = active && k < n;
    a[i] = on ? A[size_t(ch) * n + k] * LOG2E : 0.f;
    h[i] = !LOCAL && on ? sc[size_t(k) * D] : 0.f;
  }
  ptt::cp_async_wait<0>();
  __syncthreads();
  const FwdStage<T>& st = s.in[0];
  float sd = 0.f;
#pragma unroll 4
  for (int t = 0; t < CHUNK; ++t) {
    const float dt = to_f(st.delta[t][cl]), dtu = dt * to_f(st.u[t][cl]);
    float bv[FWD_NS], cv[FWD_NS];
    load_raw(bv, &st.B[t][q * FWD_NS]);
    sd += dt;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < FWD_NS; ++i) h[i] = fmaf(ex2_approx(dt * a[i]), h[i], dtu * bv[i]);
    if (!LOCAL) {
      load_raw(cv, &st.C[t][q * FWD_NS]);
#pragma unroll
      for (int i = 0; i < FWD_NS; ++i) acc = fmaf(cv[i], h[i], acc);
#pragma unroll
      for (int o = 1; o < FWD_LPC; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (q == 0) s.y[0][t][cl] = from_f<T>(acc);
    }
  }
  if (LOCAL) {
    if (active && c + 1 < nc) {
#pragma unroll
      for (int i = 0; i < FWD_NS; ++i)
        if (q * FWD_NS + i < n) sc[size_t(n + q * FWD_NS + i) * D] = h[i];
    }
    if (active && q == 0) dsum[(size_t(bi) * nc + c) * D + ch] = sd;
  } else {
    __syncthreads();
    store_y(y, s.y[0], row0, len, D, ch0);
  }
}

__global__ void __launch_bounds__(256)
scan_fwd_pass_kernel(const float* __restrict__ A, float* __restrict__ bounds,
                     const float* __restrict__ dsum, int nc, int D, int n) {
  const int ch = blockIdx.x * 256 + threadIdx.x, k = blockIdx.y, bi = blockIdx.z;
  if (ch >= D) return;
  const float a = A[size_t(ch) * n + k] * LOG2E;
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    float* p = bounds + ((size_t(bi) * nc + c) * n + k) * D + ch;
    if (c > 0) h = fmaf(ex2_approx(a * dsum[(size_t(bi) * nc + c - 1) * D + ch]), h, *p);
    *p = h;
  }
}

"""
_CHUNKED_LAUNCH = r"""  static std::atomic<uint64_t> d1{0}, d3{0};
  if ((err = ptt::allow_smem(scan_fwd_chunk_kernel<T, true>, smem, d1)) != cudaSuccess ||
      (err = ptt::allow_smem(scan_fwd_chunk_kernel<T, false>, smem, d3)) != cudaSuccess)
    return int(err);
  const int nc = (L + CHUNK - 1) / CHUNK;
  const dim3 grid((D + FWD_TD - 1) / FWD_TD, nc, batch);
  float* dsum = static_cast<float*>(y);
  scan_fwd_chunk_kernel<T, true><<<grid, FWD_THREADS, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(bounds), dsum, L, D, ld, n);
  scan_fwd_pass_kernel<<<dim3((D + 255) / 256, n, batch), 256, 0, st>>>(
      static_cast<const float*>(A), static_cast<float*>(bounds), dsum, nc, D, n);
  scan_fwd_chunk_kernel<T, false><<<grid, FWD_THREADS, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(bounds), dsum, L, D, ld, n);
"""

# The scan forward's chunks staged by TMA (3-D maps of u, delta [b, l, ld]
# and of B, C [b, l, 16], boxes of 64 steps, no swizzle) into the same
# stages, each completing on an mbarrier, instead of cp.async.
_TMA_STAGE = r"""
template <typename T>
__device__ __forceinline__ void tma_chunk(FwdStage<T>& st, uint64_t* bar,
                                          const CUtensorMap* mu, const CUtensorMap* md,
                                          const CUtensorMap* mb, const CUtensorMap* mc, int t0,
                                          int bi, int ch0) {
  if (threadIdx.x != 0) return;
  ptt::sm90::mbar_expect_tx(bar, sizeof(FwdStage<T>));
  ptt::sm90::tma_load_3d(&st.u[0][0], mu, bar, ch0, t0, bi);
  ptt::sm90::tma_load_3d(&st.delta[0][0], md, bar, ch0, t0, bi);
  ptt::sm90::tma_load_3d(&st.B[0][0], mb, bar, 0, t0, bi);
  ptt::sm90::tma_load_3d(&st.C[0][0], mc, bar, 0, t0, bi);
}

template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, 3)
scan_fwd_kernel("""
_TMA_MAPS = r"""  CUtensorMap mu, md, mb, mc;
  const auto ty = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint64_t dd[3] = {uint64_t(ld), uint64_t(L), uint64_t(batch)};
  const uint64_t ds[2] = {uint64_t(ld) * sizeof(T), uint64_t(ld) * L * sizeof(T)};
  const uint64_t bd[3] = {uint64_t(N), uint64_t(L), uint64_t(batch)};
  const uint64_t bs[2] = {N * sizeof(T), uint64_t(N) * L * sizeof(T)};
  const uint32_t dbox[3] = {FWD_TD, CHUNK, 1}, bbox[3] = {N, CHUNK, 1};
  const auto l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_NONE;
  if ((err = ptt::sm90::encode_tma(&mu, ty, u, 3, dd, ds, dbox, l2, sw)) != cudaSuccess ||
      (err = ptt::sm90::encode_tma(&md, ty, delta, 3, dd, ds, dbox, l2, sw)) != cudaSuccess ||
      (err = ptt::sm90::encode_tma(&mb, ty, B, 3, bd, bs, bbox, l2, sw)) != cudaSuccess ||
      (err = ptt::sm90::encode_tma(&mc, ty, C, 3, bd, bs, bbox, l2, sw)) != cudaSuccess)
    return int(err);
  const dim3 grid((D + FWD_TD - 1) / FWD_TD, batch);
"""

#: name: (what it changes, [(source, text, replacement), ...])
VARIANTS = {
    "fwd_lanes1": ("scan forward: 1 lane a channel (16 states a thread, "
                   "64 threads a block)", [_const(SCAN, "FWD_NS", 8, 16)]),
    "fwd_lanes8": ("scan forward: 8 lanes a channel (2 states a thread, "
                   "512 threads a block)",
                   [_const(SCAN, "FWD_NS", 8, 2),
                    (SCAN, "  for (int i = 0; i < FWD_NS; i += 4) {\n"
                     "    const float4 x = *reinterpret_cast<const float4*>"
                     "(p + i);\n    v[i] = x.x, v[i + 1] = x.y, v[i + 2] = "
                     "x.z, v[i + 3] = x.w;", "  for (int i = 0; i < FWD_NS; "
                     "i += 2) {\n    const float2 x = *reinterpret_cast<const "
                     "float2*>(p + i);\n    v[i] = x.x, v[i + 1] = x.y;")]),
    "fwd_lanes4": ("scan forward: 4 lanes a channel (4 states a thread, "
                   "256 threads a block)", [_const(SCAN, "FWD_NS", 8, 4)]),
    "fwd_bc_raw": ("scan forward: B and C read as staged, every lane "
                   "widening its bf16 values at every step",
                   [(SCAN, "// this thread's FWD_NS values of an f32 row of N",
                     "__device__ __forceinline__ void load_states(float (&v)"
                     "[FWD_NS], const bf16* p) {\n#pragma unroll\n  for (int "
                     "i = 0; i < FWD_NS; i += 2) {\n    const float2 x = "
                     "__bfloat1622float2(*reinterpret_cast<const "
                     "__nv_bfloat162*>(p + i));\n    v[i] = x.x, v[i + 1] = "
                     "x.y;\n  }\n}\n// this thread's FWD_NS values of an f32 "
                     "row of N"),
                    (SCAN, "const FwdBC& bc = walk_bc(s.bc[c & 1], st);",
                     "const FwdStage<T>& bc = st;"),
                    (SCAN, "  widen_bc(s.bc[0], s.in[0]);", ""),
                    (SCAN, "      widen_bc(s.bc[(c + 1) & 1], s.in[(c + 1) & 1]);",
                     "")]),
    "fwd_chunked": ("scan forward: chunk-parallel, three launches (local "
                    "end states, a pass over the chunks, each chunk's y; "
                    "two ex2 per (b, t, d, n))",
                    [(SCAN, "template <typename T>\nint launch_fwd(",
                      _CHUNKED + "template <typename T>\nint launch_fwd("),
                     (SCAN, """  const dim3 grid((D + FWD_TD - 1) / FWD_TD, batch);
  scan_fwd_kernel<T><<<grid, FWD_THREADS, smem, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(bounds), L, D, ld, n);
""", _CHUNKED_LAUNCH)]),
    "fwd_tma": ("scan forward: chunks staged by TMA (3-D maps, an mbarrier "
                "a stage) instead of cp.async",
                [(SCAN, "template <typename T>\n__global__ void "
                  "__launch_bounds__(FWD_THREADS, 3)\nscan_fwd_kernel(",
                  _TMA_STAGE),
                 (SCAN, "float* __restrict__ bounds, int L, int D, int ld, "
                  "int n) {\n  extern __shared__ __align__(16) unsigned char "
                  "smem_raw[];\n  FwdSmem<T>& s = *reinterpret_cast"
                  "<FwdSmem<T>*>(smem_raw);",
                  "float* __restrict__ bounds, int L, int D, int ld, int n,\n"
                  "                const __grid_constant__ CUtensorMap mu, "
                  "const __grid_constant__ CUtensorMap md,\n"
                  "                const __grid_constant__ CUtensorMap mb, "
                  "const __grid_constant__ CUtensorMap mc) {\n"
                  "  extern __shared__ __align__(16) unsigned char "
                  "smem_raw[];\n  FwdSmem<T>& s = *reinterpret_cast"
                  "<FwdSmem<T>*>((reinterpret_cast<uintptr_t>(smem_raw) + "
                  "127) & ~uintptr_t(127));\n  uint64_t* bars = "
                  "reinterpret_cast<uint64_t*>(&s + 1);\n  if (threadIdx.x "
                  "== 0) {\n    ptt::sm90::mbar_init(&bars[0], 1);\n    "
                  "ptt::sm90::mbar_init(&bars[1], 1);\n    "
                  "ptt::sm90::mbar_fence_init();\n  }\n  __syncthreads();"),
                 (SCAN, "stage_chunk(s.in[0], u, delta, B, C, size_t(bi) * L, "
                  "min(CHUNK, L), ld, ch0);",
                  "tma_chunk(s.in[0], &bars[0], &mu, &md, &mb, &mc, 0, bi, "
                  "ch0);"),
                 (SCAN, "      stage_chunk(s.in[(c + 1) & 1], u, delta, B, C, "
                  "row0 + CHUNK, min(CHUNK, L - (c + 1) * CHUNK),\n"
                  "                  ld, ch0);",
                  "      tma_chunk(s.in[(c + 1) & 1], &bars[(c + 1) & 1], &mu, "
                  "&md, &mb, &mc, (c + 1) * CHUNK, bi, ch0);"),
                 (SCAN, "  ptt::cp_async_wait<0>();\n  widen_bc(s.bc[0], "
                  "s.in[0]);", "  ptt::sm90::mbar_wait(&bars[0], 0);\n  "
                  "widen_bc(s.bc[0], s.in[0]);"),
                 (SCAN, "      ptt::cp_async_wait<0>();\n      widen_bc(",
                  "      ptt::sm90::mbar_wait(&bars[(c + 1) & 1], ((c + 1) >> "
                  "1) & 1);\n      widen_bc("),
                 (SCAN, "  const int smem = int(sizeof(FwdSmem<T>));\n"
                  "  cudaError_t err = ptt::allow_smem(scan_fwd_kernel<T>, "
                  "smem, done);\n  if (err != cudaSuccess) return int(err);\n"
                  "  const dim3 grid((D + FWD_TD - 1) / FWD_TD, batch);\n",
                  "  const int smem = int(sizeof(FwdSmem<T>)) + 128 + 16;\n"
                  "  cudaError_t err = ptt::allow_smem(scan_fwd_kernel<T>, "
                  "smem, done);\n  if (err != cudaSuccess) return int(err);\n"
                  + _TMA_MAPS),
                 (SCAN, "      static_cast<float*>(bounds), L, D, ld, n);\n"
                  "  return int(cudaGetLastError());\n}\n\ntemplate "
                  "<typename T>\nint launch_bwd(",
                  "      static_cast<float*>(bounds), L, D, ld, n, mu, md, mb, "
                  "mc);\n  return int(cudaGetLastError());\n}\n\ntemplate "
                  "<typename T>\nint launch_bwd(")]),
    "fwd_carried_mul": ("scan forward: the state's update as one FMA on "
                        "its chain (exp(dt A) h + dtu B), the carried share "
                        "exp(dt A) h a product beside it",
                        [(SCAN, "        const float carried = ex2_approx(dt "
                          "* a[i]) * h[i];\n        h[i] = fmaf(dtu, bv[i], "
                          "carried);", "        const float e = ex2_approx(dt"
                          " * a[i]), carried = e * h[i];\n        h[i] = "
                          "fmaf(e, h[i], dtu * bv[i]);")]),
    "fwd_y_sum": ("scan forward: y as the f32 sum of C h over the states, "
                  "no B . C dot (the forward before the exact dot)",
                  [(SCAN, "        const float carried = ex2_approx(dt * "
                    "a[i]) * h[i];\n        h[i] = fmaf(dtu, bv[i], carried);"
                    "\n        acc = fmaf(cv[i], carried, acc);", "        h[i]"
                    " = fmaf(ex2_approx(dt * a[i]), h[i], dtu * bv[i]);\n     "
                    "   acc = fmaf(cv[i], h[i], acc);"),
                   (SCAN, "yc[t][cl] = from_f<T>(fmaf(dtu, bcdot[t], acc));",
                    "yc[t][cl] = from_f<T>(acc);"),
                   (SCAN, "  dot_bc(s.bcdot[0], s.in[0]);\n", ""),
                   (SCAN, "      dot_bc(s.bcdot[(c + 1) & 1], s.in[(c + 1) & "
                    "1]);\n", "")]),
    "fwd_dot_f32": ("scan forward: B . C summed in f32, not double",
                    [(SCAN, "    double sum = 0.0;\n#pragma unroll\n    for "
                      "(int j = 0; j < V; ++j)\n      sum = fma(double(to_f("
                      "st.B[t][k + j])), double(to_f(st.C[t][k + j])), sum);",
                      "    float sum = 0.f;\n#pragma unroll\n    for (int j = "
                      "0; j < V; ++j)\n      sum = fmaf(to_f(st.B[t][k + j]), "
                      "to_f(st.C[t][k + j]), sum);")]),
    "fwd_no_dot": ("scan forward: B . C not summed (y wrong; diagnostic)",
                   [(SCAN, "  dot_bc(s.bcdot[0], s.in[0]);\n", ""),
                    (SCAN, "      dot_bc(s.bcdot[(c + 1) & 1], s.in[(c + 1) & "
                     "1]);\n", "")]),
    "fwd_unroll8": ("scan forward: the walk unrolled 8 steps deep",
                    [(SCAN, "#pragma unroll 4\n    for (int t = 0; t < CHUNK; "
                      "++t) {", "#pragma unroll 8\n    for (int t = 0; t < "
                      "CHUNK; ++t) {")]),
    "fwd_no_exp": ("scan forward: exp(delta A) replaced by an FMA "
                   "(diagnostic)",
                   [(SCAN, "const float carried = ex2_approx(dt * a[i]) * "
                     "h[i];", "const float carried = fmaf(dt, a[i], 1.f) * "
                     "h[i];")]),
    "fwd_no_load": ("scan forward: only the first chunk is staged, the "
                    "walk never waits on a load (diagnostic)",
                    [(SCAN, "    if (c + 1 < nc)\n      stage_chunk(",
                      "    if (c + 1 < 1)\n      stage_chunk(")]),
    "tiles2": ("scan: two 64-channel tiles a block (dB, dC partials per "
               "128 channels)", [_const(SCAN, "TILES", 1, 2)]),
    "tiles4": ("scan: four channel tiles a block", [_const(SCAN, "TILES", 1,
                                                           4)]),
    "ns2": ("scan: 2 states a thread (8 lanes a channel, 32-channel tiles)",
            [_const(SCAN, "NS", 4, 2)]),
    "scan_1block": ("scan: the chunks' kernel without the 2-blocks-an-SM "
                    "register cap",
                    [(SCAN, "__launch_bounds__(BWD_THREADS, 2)",
                      "__launch_bounds__(BWD_THREADS)")]),
    "dah_exp": ("scan: the walk back recomputes exp(delta A) instead of "
                "holding the sub-chunk's (4 ex2 per (b, l, d, n), 16 "
                "registers fewer)",
                [(SCAN, "float h0[NS], hist[BSUB][NS], dah[BSUB][NS];",
                  "float h0[NS], hist[BSUB][NS];"),
                 (SCAN, "dah[j][i] = ex2_approx(dts[j] * a[i]);\n"
                  "          h[i] = fmaf(dah[j][i], h[i],",
                  "h[i] = fmaf(ex2_approx(dts[j] * a[i]), h[i],"),
                 (SCAN, "const float common = dh * hp * dah[j][i];",
                  "const float da = ex2_approx(dt * a[i]);\n"
                  "          const float common = dh * hp * da;"),
                 (SCAN, "g[i] = dah[j][i] * dh;", "g[i] = da * dh;")]),
    "no_scatter": ("scan: no dB, dC reduction over the channels "
                   "(diagnostic)",
                   [(SCAN, "scatter_round<NS>(vals, lane, 16);", ""),
                    (SCAN, "if constexpr (LPC <= 8) scatter_round<NS / 2>"
                     "(vals, lane, 8);", ""),
                    (SCAN, "if constexpr (LPC <= 4) scatter_round<NS / 4>"
                     "(vals, lane, 4);", "")]),
    "bsub2": ("scan: sub-chunks of 2 steps replayed in registers",
              [_const(SCAN, "BSUB", 4, 2)]),
    "bsub8": ("scan: sub-chunks of 8 steps replayed in registers",
              [_const(SCAN, "BSUB", 4, 8)]),
    "heads4": ("ssd: 4 heads a block of the chunk backward",
               [_const(SSD, "HEADS", 12, 4)]),
    "heads6": ("ssd: 6 heads a block", [_const(SSD, "HEADS", 12, 6)]),
    "heads8": ("ssd: 8 heads a block", [_const(SSD, "HEADS", 12, 8)]),
    "heads24": ("ssd: 24 heads a block (one block per batch row and chunk)",
                [_const(SSD, "HEADS", 12, 24)]),
    "ssd_1block": ("ssd: every kernel without the 2-blocks-an-SM register "
                   "cap", [(SSD, "__launch_bounds__(THREADS, 2)",
                            "__launch_bounds__(THREADS)")]),
    "fwd_heads4": ("ssd: 4 heads a block of the chunk forward",
                   [_const(SSD, "FWD_HEADS", 12, 4)]),
    "fwd_heads6": ("ssd: 6 heads a block of the chunk forward",
                   [_const(SSD, "FWD_HEADS", 12, 6)]),
    "fwd_heads24": ("ssd: 24 heads a block of the chunk forward",
                    [_const(SSD, "FWD_HEADS", 12, 24)]),
    "ssd_no_mma": ("ssd: no chunk products in any kernel (diagnostic)",
                   _no_products(SSD)),
    "ssd_fwd_no_load": ("ssd: the chunk forward loads neither x nor the "
                        "states (diagnostic)",
                        [(SSD, "load_rows<CH, P>(vx, x, row0, sx, long(hi) "
                          "* P, len);", "load_rows<CH, P>(vx, x, row0, sx, "
                          "long(hi) * P, 0);"),
                         (SSD, "v4[j] = reinterpret_cast<const float4*>(st)"
                          "[(r0 + j) * THREADS + tid];",
                          "v4[j] = make_float4(0.f, 0.f, 0.f, 0.f);")]),
    "wkv_fwd_3blocks": ("wkv: the forward chunk kernel's A in the readout "
                        "factor's tile, 3 blocks an SM",
                        [(WKV, "  T X[CH][LC];                         "
                          "// A [j][s]\n", ""),
                         (WKV, "  intra_a<CH, D, LD, LC>(s, &s.X[0][0], warp, "
                          "lane);", "  __syncthreads();\n  intra_a<CH, D, LD, "
                          "LC>(s, &s.rw[0][0], warp, lane);"),
                         (WKV, "mma_tile<CH, NT, false, true>(acc, &s.X[0][0], "
                          "LC, &s.v[0][0]", "mma_tile<CH, NT, false, true>(acc, "
                          "&s.rw[0][0], LC, &s.v[0][0]"),
                         (WKV, "__launch_bounds__(THREADS, 2)\n"
                          "wkv_fwd_chunk_kernel", "__launch_bounds__(THREADS, "
                          "3)\nwkv_fwd_chunk_kernel")]),
    "wkv_chunk32": ("wkv: chunks of 32 at d = 64 (twice the carries and "
                    "scratch, a quarter of the shared memory)",
                    [(WKV, "static constexpr int CH = D == 64 ? 64 : 32;",
                      "static constexpr int CH = 32;")]),
    "wkv_slice16": ("wkv: 16 state columns a carry block (both directions)",
                    [_const(WKV, "SLICE", 64, 16)]),
    "wkv_slice32": ("wkv: 32 state columns a carry block (both directions)",
                    [_const(WKV, "SLICE", 64, 32)]),
    "wkv_1block": ("wkv: the chunk kernel without the 2-blocks-an-SM "
                   "register cap", [(WKV, "__launch_bounds__(THREADS, 2)",
                                     "__launch_bounds__(THREADS)")]),
    "wkv_no_mma": ("wkv: no chunk products in either backward kernel "
                   "(diagnostic)", _no_products(WKV)),
    "wkv_no_cube": ("wkv: no decay cube on the diagonal sub-blocks "
                    "(diagnostic)",
                    [(WKV, "for (int p = tid; p < NB * PAIRS; p += THREADS)",
                      "for (int p = tid; p < 0; p += THREADS)"),
                     (WKV, "if ((h2 == 0 && t >= SUB / 2 - 1) || sj >= j) "
                      "continue;", "continue;"),
                     (WKV, "if ((h2 == 1 && t <= SUB / 2) || jj <= sj) "
                      "continue;", "continue;")]),
    "wkv_no_acube": ("wkv: no decay cube for A on the diagonal sub-blocks "
                     "(diagnostic)",
                     [(WKV, "for (int p = tid; p < NB * PAIRS; p += THREADS)",
                       "for (int p = tid; p < 0; p += THREADS)")]),
    "wkv_no_gcube": ("wkv: no decay cube for the gradients on the diagonal "
                     "sub-blocks (diagnostic)",
                     [(WKV, "if ((h2 == 0 && t >= SUB / 2 - 1) || sj >= j) "
                       "continue;", "continue;"),
                      (WKV, "if ((h2 == 1 && t <= SUB / 2) || jj <= sj) "
                       "continue;", "continue;")]),
    "wkv_no_scale": ("wkv: the factored operands r~, k~ and k o w^(CH-1-s) "
                     "left unscaled (diagnostic)",
                     [(WKV, "  scale_rows<D, LD, LD, THREADS, LO>(",
                       "  if (false) scale_rows<D, LD, LD, THREADS, LO>("),
                      (WKV, "  scale_rows<D, LD, LD, THREADS, false>(",
                       "  if (false) scale_rows<D, LD, LD, THREADS, false>("),
                      (WKV, "  scale_rows<D, LX, LD, THREADS, false>(",
                       "  if (false) scale_rows<D, LX, LD, THREADS, false>(")]),
    "wkv_no_load": ("wkv: the chunk kernel loads neither r, k, v, dy nor "
                    "the carried states (diagnostic)",
                    [(WKV, "row0, st, col, len);", "row0, st, col, 0);"),
                     (WKV, "s_in + sidx, 0, D, 0, D);",
                      "s_in + sidx, 0, D, 0, 0);"),
                     (WKV, "ds_out + sidx, 0, D, 0, D);",
                      "ds_out + sidx, 0, D, 0, 0);")]),
}
#: variants that take work out on purpose: their outputs are not checked
DIAGNOSTIC = {"fwd_no_exp", "fwd_no_load", "fwd_no_dot", "no_scatter", "ssd_no_mma", "ssd_fwd_no_load", "wkv_no_mma",
              "wkv_no_cube", "wkv_no_acube", "wkv_no_gcube", "wkv_no_scale",
              "wkv_no_load"}


def build(names):
    """{name: ctypes.CDLL per source} of the sources ("base") and each
    variant, compiled in parallel."""
    libs = _variants.build(names, VARIANTS, (SCAN, SSD, WKV), "ssm_variants")
    out = {}
    for name in ["base", *names]:
        scan, ssd, wkv = (libs[(name, src)] for src in (SCAN, SSD, WKV))
        scan.ptt_selective_scan_fwd.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        scan.ptt_selective_scan_bwd.argtypes = [ctypes.c_void_p] * 14 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        ssd.ptt_ssd_fwd.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        ssd.ptt_ssd_bwd.argtypes = [ctypes.c_void_p] * 15 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        wkv.ptt_wkv_bwd.argtypes = [ctypes.c_void_p] * 15 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        wkv.ptt_wkv_fwd.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        out[name] = (scan, ssd, wkv)
    return out


def scan_case(libs, gen):
    """``run(name)``: the scan backward of build ``name`` at phase 9's
    shape, its gradients as the wrapper returns them."""
    b, l, d, n = 16, 1024, 1536, 16
    dev, bf = "cuda", torch.bfloat16
    u = torch.randn(b, l, d, generator=gen, device=dev).to(bf)
    delta = F.softplus(torch.randn(b, l, d, generator=gen, device=dev)).to(bf)
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).expand(d, n).contiguous()
    B, C = (torch.randn(b, l, n, generator=gen, device=dev).to(bf)
            for _ in range(2))
    dy = torch.randn(b, l, d, generator=gen, device=dev).to(bf)
    nc = -(-l // 64)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty_like(u)
    bounds = torch.empty((b, nc, n, d), **f32)
    st = _build.stream(u)
    assert libs["base"][0].ptt_selective_scan_fwd(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), bounds.data_ptr(), b, l, d, d, n, 1,
        st) == 0

    def run(name):
        lib = libs[name][0]
        tiles = -(-d // lib.ptt_selective_scan_bwd_channels())
        du, ddelta = torch.empty_like(u), torch.empty_like(u)
        dA = torch.empty((b * nc, d, n), **f32)
        dBC = torch.empty((2, tiles, b, l, n), **f32)
        dB, dC = dBC
        carry = torch.empty((b, nc, n, d), **f32)
        dsum = torch.empty((b, nc, d), **f32)
        rc = lib.ptt_selective_scan_bwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), bounds.data_ptr(), dy.data_ptr(), du.data_ptr(),
            ddelta.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            carry.data_ptr(), dsum.data_ptr(), b, l, d, n, 1, st)
        assert rc == 0, (name, rc)
        return (du, ddelta, dA.sum(0), *dBC.sum(1).to(bf))

    return f"scan bwd b{b} l{l} d{d} n{n}", run, r"scan_bwd_\w*kernel"


def scan_fwd_case(libs, gen):
    """``run(name)``: the scan forward of build ``name`` at phase 9's
    shape, y and the chunk states."""
    b, l, d, n = 16, 1024, 1536, 16
    dev, bf = "cuda", torch.bfloat16
    u = torch.randn(b, l, d, generator=gen, device=dev).to(bf)
    delta = F.softplus(torch.randn(b, l, d, generator=gen, device=dev)).to(bf)
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).expand(d, n).contiguous()
    B, C = (torch.randn(b, l, n, generator=gen, device=dev).to(bf)
            for _ in range(2))
    nc = -(-l // 64)
    st = _build.stream(u)

    def run(name):
        y = torch.empty_like(u)
        bounds = torch.empty((b, nc, n, d), dtype=torch.float32, device=dev)
        rc = libs[name][0].ptt_selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), bounds.data_ptr(), b, l, d, d, n, 1,
            st)
        assert rc == 0, (name, rc)
        return y, bounds

    return f"scan fwd b{b} l{l} d{d} n{n}", run, r"scan_fwd_\w*kernel"


def ssd_case(libs, gen):
    """``run(name)``: the SSD backward of build ``name`` at phase 11's
    shape, x, B and C strided views of one conv output as the model's."""
    b, l, h, p, n = 8, 1024, 24, 64, 64
    dev, bf = "cuda", torch.bfloat16
    width = h * p + 2 * n
    xc = torch.randn(b, l, width, generator=gen, device=dev).to(bf)
    x, B, C = xc[..., :h * p], xc[..., h * p:h * p + n], xc[..., h * p + n:]
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device=dev)).to(bf)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    D = torch.randn(h, generator=gen, device=dev)
    dy = torch.randn(b, l, h, p, generator=gen, device=dev).to(bf)
    nc = -(-l // 64)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty_like(dy)
    states = torch.empty((b, nc, h, p, n), **f32)
    st = _build.stream(dy)
    ins = (x, dt, A, B, C, D)
    assert libs["base"][1].ptt_ssd_fwd(
        *(t.data_ptr() for t in ins), y.data_ptr(), states.data_ptr(), b, l,
        h, p, n, width, h, width, width, 1, st) == 0

    def run(name):
        lib = libs[name][1]
        ptrs = [t.data_ptr() for t in ins]
        groups = -(-h // lib.ptt_ssd_bwd_heads_per_block())
        dx, ddt = torch.empty_like(dy), torch.empty_like(dt)
        dAD = torch.empty((2, b * nc, h), **f32)
        dBC = torch.empty((2, groups, b, l, n), **f32)
        (dA, dD), (dB, dC) = dAD, dBC
        carry = torch.empty_like(states)
        rc = lib.ptt_ssd_bwd(
            *ptrs, states.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dD.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), carry.data_ptr(), b, l, h, p, n, width, h, width,
            width, h * p, 1, st)
        assert rc == 0, (name, rc)
        return (dx, ddt, *dAD.sum(1), *dBC.sum(1).to(bf))

    return f"ssd bwd b{b} l{l} h{h} dh{p} ds{n}", run, r"ssd_bwd_\w*kernel"


def ssd_fwd_case(libs, gen):
    """``run(name)``: the SSD forward of build ``name`` at phase 11's shape,
    x, B and C strided views of one conv output as the model's."""
    b, l, h, p, n = 8, 1024, 24, 64, 64
    dev, bf = "cuda", torch.bfloat16
    width = h * p + 2 * n
    xc = torch.randn(b, l, width, generator=gen, device=dev).to(bf)
    x, B, C = xc[..., :h * p], xc[..., h * p:h * p + n], xc[..., h * p + n:]
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device=dev)).to(bf)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    D = torch.randn(h, generator=gen, device=dev)
    ins = (x, dt, A, B, C, D)
    st = _build.stream(dt)

    def run(name):
        lib = libs[name][1]
        ptrs = [t.data_ptr() for t in ins]
        nc = -(-l // 64)
        y = torch.empty((b, l, h, p), dtype=bf, device=dev)
        states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                             device=dev)
        rc = lib.ptt_ssd_fwd(*ptrs, y.data_ptr(), states.data_ptr(), b, l, h,
                             p, n, width, h, width, width, 1, st)
        assert rc == 0, (name, rc)
        return y, states

    return f"ssd fwd b{b} l{l} h{h} dh{p} ds{n}", run, r"ssd_fwd_\w*kernel"


def wkv_case(libs, gen):
    """``run(name)``: the WKV backward of build ``name`` at phase 10's
    shape, its gradients as the wrapper returns them."""
    b, l, h, d = 16, 1024, 12, 64
    dev, bf = "cuda", torch.bfloat16
    r, k, v = (0.5 * torch.randn(b, l, h, d, generator=gen, device=dev)
               .to(bf) for _ in range(3))
    logw = -5 * torch.rand(h, d, generator=gen, device=dev) - 0.02
    u = 0.5 + 0.1 * torch.randn(h, d, generator=gen, device=dev)
    dy = torch.randn(b, l, h, d, generator=gen, device=dev).to(bf)
    ins = (r, k, v, logw, u, dy)
    st = _build.stream(dy)
    f32 = dict(dtype=torch.float32, device=dev)

    def run(name):
        lib = libs[name][2]
        ptrs = [t.data_ptr() for t in ins]
        nc = -(-l // lib.ptt_wkv_bwd_chunk(d))
        dr, dk, dv = (torch.empty_like(dy) for _ in range(3))
        parts = torch.empty((2, b * nc, h, d), **f32)
        # S_in, dS_out and, with bf16 I/O, their rounding remainders
        scratch = torch.empty((4, b, nc, h, d, d), dtype=bf, device=dev)
        rc = lib.ptt_wkv_bwd(*ptrs, dr.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), parts[0].data_ptr(),
                             parts[1].data_ptr(),
                             *(scratch[i].data_ptr() for i in range(4)), b, l,
                             h, d, 1, st)
        assert rc == 0, (name, rc)
        return (dr, dk, dv, *parts.sum(1))

    return f"wkv bwd b{b} l{l} h{h} d{d}", run, r"wkv_bwd_\w*kernel"


def wkv_fwd_case(libs, gen):
    """``run(name)``: the WKV forward of build ``name`` at phase 10's
    shape, its y; the base build's y held to the plain version first
    (within 1e-2 of max |plain|, the bf16 gate of ``chip_smoke.py``)."""
    from ..ops.cuda.wkv import wkv_reference

    b, l, h, d = 16, 1024, 12, 64
    dev, bf = "cuda", torch.bfloat16
    r, k, v = (0.5 * torch.randn(b, l, h, d, generator=gen, device=dev)
               .to(bf) for _ in range(3))
    logw = -5 * torch.rand(h, d, generator=gen, device=dev) - 0.02
    u = 0.5 + 0.1 * torch.randn(h, d, generator=gen, device=dev)
    ins = (r, k, v, logw, u)
    st = _build.stream(r)

    def run(name):
        lib = libs[name][2]
        y = torch.empty_like(r)
        s_in = torch.empty((b, -(-l // lib.ptt_wkv_bwd_chunk(d)), h, d, d),
                           dtype=bf, device=dev)
        rc = lib.ptt_wkv_fwd(*(t.data_ptr() for t in ins), y.data_ptr(),
                             s_in.data_ptr(), b, l, h, d, 1, st)
        assert rc == 0, (name, rc)
        return (y,)

    ref = wkv_reference(*(t.float() for t in ins))
    got = run("base")[0].float()
    diff = (got - ref).abs().max().item()
    peak = ref.abs().max().item()
    print(f"wkv fwd base against the plain version: max |diff| / max |plain|"
          f" = {diff / peak:.3e}")
    assert diff <= 1e-2 * peak, (diff, peak)
    return f"wkv fwd b{b} l{l} h{h} d{d}", run, r"wkv_fwd_\w*kernel"


#: (the call's runner, the source whose variants it times)
CASES = ((scan_fwd_case, SCAN), (scan_case, SCAN), (ssd_case, SSD),
         (ssd_fwd_case, SSD), (wkv_fwd_case, WKV), (wkv_case, WKV))


def main(argv):
    argv = _variants.names_of(argv, VARIANTS)
    libs = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    edited = {e[0] for v in argv for part in v.split("+")
              for e in VARIANTS[part][1]}
    for make, src in CASES:
        if argv and src not in edited:
            continue
        what, run, pattern = make(libs, gen)
        ref = run("base")
        times, split = [], {}
        for name in ["base", *argv, "base"]:
            got = run(name)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if set(name.split("+")) & DIAGNOSTIC:
                    break
                peak = r.float().abs().max().item()
                diff = (g.float() - r.float()).abs().max().item()
                assert diff <= 1e-2 * peak, (what, name, diff, peak)
            times.append(f"{name} {_variants.cold_ms(lambda: run(name)):.4f}"
                         f" / {_variants.warm_ms(lambda: run(name)):.4f}")
            split[name] = _variants.kernel_ms(lambda: run(name), pattern)
        print(f"{what} (ms, cold / warm): {', '.join(times)}", flush=True)
        for name, per in split.items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                            per.items()))
    print(_variants.card())


if __name__ == "__main__":
    main(sys.argv[1:])
