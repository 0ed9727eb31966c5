"""Time variants of the wgmma grouped GEMMs (``csrc/grouped_gemm.cu``)
against the source as it is, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.grouped_gemm_variants [VARIANT ...]

Each variant is the source with a few lines replaced (``VARIANTS``),
built by nvcc into ``build/grouped_gemm_variants/`` and loaded beside the
others (``tools/_variants.py``). The six products of one MoE layer of
``chip_smoke.py`` phase 8 (M = 32768 routed rows over 8 experts, hidden
1024, intermediate 2816) run on every build: gmm (w2 forward + bias, the
dlhs through w2 and w1), tgmm (dW2, dW1) and the fused gate + up + swiglu
with b1 (with its residuals, and y alone). Prints per product the mean
device ms of each build (CUDA events, the 50 MB L2 flushed before every
launch; the source as it is timed first and last) and of the library
yardstick (``torch._grouped_mm``; for the swiglu, over w1 plus the
activation), and checks every variant but the diagnostic ones
(``DIAGNOSTIC``) bit for bit against the source as it is. Ends with the
card's name, power limit and clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops.cuda import _build
from . import _variants

GG = "grouped_gemm"

# The swiglu's epilogue of a whole tile as it is: g and u staged together,
# then y in place of g (the text the epilogue variants replace)
_SW_EPILOGUE = r"""      if (r1 - r0 == WG_BM) {
        // g and u staged together, then y computed in place of g and
        // staged once g's store has read its half
        if (residuals) {
          if (issuer) hw::tma_store_wait_read<0>();
          hw::named_barrier(1, 256);
          stage_swiglu(ring.outbuf, wg, tid, [&](int j, int e) { return acc[4 * j + e]; });
          stage_swiglu(ring.outbuf + SW_OUT, wg, tid,
                       [&](int j, int e) { return acc[SW_UP + 4 * j + e]; });
          hw::fence_proxy_async();
          hw::named_barrier(1, 256);
          if (issuer) {
            store_staged(&map_g, ring.outbuf, n0, r0, N);
            store_staged(&map_u, ring.outbuf + SW_OUT, n0, r0, N);
          }
        }
#pragma unroll
        for (int i = 0; i < SW_UP; ++i) acc[i] = swiglu(acc[i], acc[SW_UP + i]);
        if (issuer) {
          if (residuals)
            hw::tma_store_wait_read<1>();
          else
            hw::tma_store_wait_read<0>();
        }
        hw::named_barrier(1, 256);
        stage_swiglu(ring.outbuf, wg, tid, [&](int j, int e) { return acc[4 * j + e]; });
        hw::fence_proxy_async();
        hw::named_barrier(1, 256);
        if (issuer) store_staged(&map_y, ring.outbuf, n0, r0, N);
        continue;
      }
"""
# Earlier epilogues, each given the outputs [0, staged) that go out by TMA
# (y, g, u; the rest from registers): y, g and u staged in turn, each
# behind two named barriers, alternating the halves of the buffer
_SW_ROUNDS = r"""      if (staged > 0) {
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          if (o == staged) break;
          uint8_t* buf = ring.outbuf + (slot++ % 2) * SW_OUT;
          if (issuer) hw::tma_store_wait_read<1>();  // the store before last read buf
          hw::named_barrier(1, 256);
          stage_swiglu(buf, wg, tid, [&](int j, int e) { return value(o, j, e); });
          hw::fence_proxy_async();
          hw::named_barrier(1, 256);
          if (issuer) {
            const CUtensorMap* map = o == 0 ? &map_y : o == 1 ? &map_g : &map_u;
#pragma unroll
            for (int j = 0; j < SW_PANELS; ++j)
              if (n0 + 64 * j < N) hw::tma_store_2d(map, buf + j * OUT_PANEL, n0 + 64 * j, r0);
            hw::tma_store_commit();
          }
        }
      }
"""
# y and g staged together into the two buffers (one pair of barriers),
# then u into y's buffer once y's store has read it
_SW_PAIR = r"""      if (staged > 0) {
        if (issuer) hw::tma_store_wait_read<0>();
        hw::named_barrier(1, 256);
        stage_swiglu(ring.outbuf, wg, tid, [&](int j, int e) { return value(0, j, e); });
        if (staged > 1)
          stage_swiglu(ring.outbuf + SW_OUT, wg, tid, [&](int j, int e) { return value(1, j, e); });
        hw::fence_proxy_async();
        hw::named_barrier(1, 256);
        if (issuer) {
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            if (o == staged) break;
            const CUtensorMap* map = o == 0 ? &map_y : &map_g;
#pragma unroll
            for (int j = 0; j < SW_PANELS; ++j)
              if (n0 + 64 * j < N)
                hw::tma_store_2d(map, ring.outbuf + o * SW_OUT + j * OUT_PANEL, n0 + 64 * j, r0);
            hw::tma_store_commit();
          }
        }
        if (staged > 2) {
          if (issuer) hw::tma_store_wait_read<1>();
          hw::named_barrier(1, 256);
          stage_swiglu(ring.outbuf, wg, tid, [&](int j, int e) { return value(2, j, e); });
          hw::fence_proxy_async();
          hw::named_barrier(1, 256);
          if (issuer) {
#pragma unroll
            for (int j = 0; j < SW_PANELS; ++j)
              if (n0 + 64 * j < N)
                hw::tma_store_2d(&map_u, ring.outbuf + j * OUT_PANEL, n0 + 64 * j, r0);
            hw::tma_store_commit();
          }
        }
      }
"""



def _sw_epilogue(block, counter=False):
    """Edits that put ``block`` (one of the earlier epilogues) in place of
    the swiglu's, with its ``staged`` count and, with ``counter``, the
    running count of staged outputs that picks a buffer half."""
    edits = [(GG, _SW_EPILOGUE, "      const int staged = r1 - r0 == WG_BM ? "
              "outs : 0;\n" + block + "      if (staged == outs) continue;\n"),
             (GG, "          if (o == outs) break;\n          bf16* dst",
              "          if (o == outs) break;\n          if (o < staged) "
              "continue;\n          bf16* dst")]
    if counter:
        edits.append((GG, "const bool residuals = gres != nullptr;",
                       "const bool residuals = gres != nullptr;\n    int "
                       "slot = 0;"))
    return edits


#: name: (what it changes, [(source, text, replacement), ...])
VARIANTS = {
    "regstore": ("gmm and the swiglu store every tile from registers (no "
                 "TMA store)",
                 [(GG, "if (r1 - r0 == WG_BM) {", "if (M < 0) {")]),
    "nostore": ("no output store at all: mainloop and staging only "
                "(diagnostic)",
                [(GG, "store_bf16x2(out", "if (N < 0) store_bf16x2(out"),
                 (GG, "store_bf16x2(dst", "if (N < 0) store_bf16x2(dst"),
                 (GG, "hw::tma_store_2d(", "if (N < 0) hw::tma_store_2d("),
                 (GG, "hw::tma_store_3d(", "if (N < 0) hw::tma_store_3d(")]),
    "sw_rounds3": ("swiglu: y, g and u staged in turn, y computed as it is "
                   "staged (with sw_one_buffer, sw_reg_res, sw_regstore, "
                   "sw_2stage: their earlier forms)",
                   _sw_epilogue(_SW_ROUNDS, counter=True)),
    "sw_one_buffer": ("swiglu (with sw_rounds3): its three outputs staged "
                      "through one 32 KB buffer, each store's read awaited "
                      "before the next",
                      [(GG, "uint8_t* buf = ring.outbuf + (slot++ % 2) * "
                        "SW_OUT;", "uint8_t* buf = ring.outbuf;"),
                       (GG, "hw::tma_store_wait_read<1>();  // the store "
                        "before last read buf",
                        "hw::tma_store_wait_read<0>();")]),
    "sw_reg_res": ("swiglu (with sw_rounds3): y staged and stored by TMA, g "
                   "and u stored from registers",
                   [(GG, "const int staged = r1 - r0 == WG_BM ? outs : 0;",
                     "const int staged = r1 - r0 == WG_BM ? 1 : 0;")]),
    "sw_regstore": ("swiglu (with sw_rounds3): every output stored from "
                    "registers",
                    [(GG, "const int staged = r1 - r0 == WG_BM ? outs : 0;",
                      "const int staged = 0;")]),
    "sw_pair": ("swiglu: y and g staged together, then u, y computed as "
                "it is staged", _sw_epilogue(_SW_PAIR)),
    "sw_2stage": ("two stages (every kernel) and, with sw_rounds3, three "
                  "32 KB output buffers: the swiglu stages its outputs at "
                  "once",
                  [(GG, "STAGES_WG = 3", "STAGES_WG = 2"),
                   (GG, "constexpr int OUT_BYTES = WG_BM * WG_BN * 2;",
                    "constexpr int OUT_BYTES = WG_BM * WG_BN * 3;"),
                   (GG, "static_assert(2 * SW_OUT == OUT_BYTES",
                    "static_assert(3 * SW_OUT == OUT_BYTES"),
                   (GG, "(slot++ % 2) * SW_OUT", "(slot++ % 3) * SW_OUT"),
                   (GG, "hw::tma_store_wait_read<1>();",
                    "hw::tma_store_wait_read<2>();")]),
    "wait0": ("each slice's wgmma group waited for before the next",
              [(GG, "hw::wgmma_wait<1>();", "hw::wgmma_wait<0>();")]),
    "r240": ("producer 24 registers, consumers 240",
             [(GG, "PRODUCER_REGS = 40", "PRODUCER_REGS = 24"),
              (GG, "CONSUMER_REGS = 232", "CONSUMER_REGS = 240")]),
    "r224": ("producer 56 registers, consumers 224",
             [(GG, "PRODUCER_REGS = 40", "PRODUCER_REGS = 56"),
              (GG, "CONSUMER_REGS = 232", "CONSUMER_REGS = 224")]),
    "tgmm_n_inner": ("tgmm walks a group's n tiles innermost, whatever the "
                     "shape", [(GG, "const bool k_inner = ntk <= ntn;",
                                "const bool k_inner = false;")]),
    "n128": ("128 x 128 output tiles (wgmma m64n128), 5 stages",
             [(GG, "WG_BN = 256", "WG_BN = 128"),
              (GG, "STAGES_WG = 3", "STAGES_WG = 5"),
              (GG, "hw::wgmma_m64n256<TA, TB>(acc",
               "hw::wgmma_m64n128<TA, TB>(acc")]),
}
#: variants that take work out on purpose: their outputs are not checked
DIAGNOSTIC = {"nostore"}


def build(names):
    """{name: (ptt_gmm, ptt_tgmm, ptt_gmm_swiglu)} of the source ("base")
    and each variant, compiled in parallel."""
    fns = {}
    libs = _variants.build(names, VARIANTS, [GG], "grouped_gemm_variants")
    for (name, _), lib in libs.items():
        lib.ptt_gmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.ptt_tgmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.ptt_gmm_swiglu.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fns[name] = (lib.ptt_gmm, lib.ptt_tgmm, lib.ptt_gmm_swiglu)
    return fns


def main(argv):
    argv = _variants.names_of(argv, VARIANTS)
    fns = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()

    def gmm(v, lhs, rhs, sizes, bias, trans):
        G = rhs.shape[0]
        k, n = (rhs.shape[2], rhs.shape[1]) if trans else rhs.shape[1:]
        out = torch.empty((lhs.shape[0], n), dtype=torch.bfloat16,
                          device="cuda")
        rc = fns[v][0](lhs.data_ptr(), rhs.data_ptr(),
                       None if bias is None else bias.data_ptr(),
                       sizes.data_ptr(), out.data_ptr(), lhs.shape[0], k, n,
                       G, int(trans), _build.stream(lhs))
        assert rc == 0, rc
        return out

    def tgmm(v, lhs, dout, sizes):
        G, (m, k), n = sizes.shape[0], lhs.shape, dout.shape[1]
        out = torch.empty((G, k, n), dtype=torch.bfloat16, device="cuda")
        rc = fns[v][1](lhs.data_ptr(), dout.data_ptr(), sizes.data_ptr(),
                       out.data_ptr(), m, k, n, G, _build.stream(lhs))
        assert rc == 0, rc
        return out

    def swiglu(v, lhs, w1, sizes, b1, residuals):
        (m, k), n = lhs.shape, w1.shape[2] // 2
        outs = [torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                for _ in range(3 if residuals else 1)]
        res = [o.data_ptr() for o in outs[1:]] or [None, None]
        rc = fns[v][2](lhs.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                       sizes.data_ptr(), outs[0].data_ptr(), *res, m, k, n,
                       sizes.shape[0], _build.stream(lhs))
        assert rc == 0, rc
        return outs

    def act(h2):            # chip_smoke.py's swiglu_pair
        return torch.nn.functional.silu(h2[:, :h]) * h2[:, h:]

    M, d, h, E = 32768, 1024, 2816, 8
    sizes = torch.tensor([4100, 4000, 4200, 3900, 4096, 4050, 4150, 3800],
                         dtype=torch.int32, device="cuda")
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    hs, dy, xs, dh = rnd(M, h), rnd(M, d), rnd(M, d), rnd(M, 2 * h)
    w2, w1 = rnd(E, h, d, scale=h ** -0.5), rnd(E, d, 2 * h, scale=d ** -0.5)
    b2, b1 = rnd(E, d, scale=0.1), rnd(E, 2 * h, scale=0.1)
    products = {
        "gmm w2 forward + b2": (
            lambda v: gmm(v, hs, w2, sizes, b2, False),
            lambda: torch._grouped_mm(hs, w2, offs=offs)),
        "gmm dlhs through w2": (
            lambda v: gmm(v, dy, w2, sizes, None, True),
            lambda: torch._grouped_mm(dy, w2.transpose(1, 2), offs=offs)),
        "gmm dlhs through w1": (
            lambda v: gmm(v, dh, w1, sizes, None, True),
            lambda: torch._grouped_mm(dh, w1.transpose(1, 2), offs=offs)),
        "tgmm dW2": (lambda v: tgmm(v, hs, dy, sizes),
                     lambda: torch._grouped_mm(hs.t(), dy, offs=offs)),
        "tgmm dW1": (lambda v: tgmm(v, xs, dh, sizes),
                     lambda: torch._grouped_mm(xs.t(), dh, offs=offs)),
        "swiglu + b1, residuals": (
            lambda v: swiglu(v, xs, w1, sizes, b1, True),
            lambda: act(torch._grouped_mm(xs, w1, offs=offs))),
        "swiglu + b1, y only": (
            lambda v: swiglu(v, xs, w1, sizes, b1, False),
            lambda: act(torch._grouped_mm(xs, w1, offs=offs))),
    }
    for what, (fn, lib) in products.items():
        ref = fn("base")
        times = []
        for v in ["base", *argv, "base"]:
            if not set(v.split("+")) & DIAGNOSTIC:
                out = fn(v)
                torch.cuda.synchronize()
                same = all(map(torch.equal, out, ref)) \
                    if isinstance(out, list) else torch.equal(out, ref)
                assert same, (what, v)
            times.append(f"{v} {_variants.cold_ms(lambda: fn(v)):.4f}")
        print(f"{what} (ms): {', '.join(times)}, torch._grouped_mm "
              f"{_variants.cold_ms(lib):.4f}")
    print(_variants.card())


if __name__ == "__main__":
    main(sys.argv[1:])
