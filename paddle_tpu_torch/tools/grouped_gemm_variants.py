"""Time variants of the wgmma grouped GEMMs (``csrc/grouped_gemm.cu``)
against the source as it is, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.grouped_gemm_variants [VARIANT ...]

Each variant is the source with a few lines replaced (``VARIANTS``),
built by nvcc into ``build/grouped_gemm_variants/`` and loaded beside the
others (``tools/_variants.py``). The five products of one MoE layer of
``chip_smoke.py`` phase 8 (M = 32768 routed rows over 8 experts, hidden
1024, intermediate 2816) run on every build: gmm (w2 forward + bias, the
dlhs through w2 and w1) and tgmm (dW2, dW1). Prints per product the mean
device ms of each build (CUDA events, the 50 MB L2 flushed before every
launch; the source as it is timed first and last) and of
``torch._grouped_mm``, and checks every variant but ``nostore`` bit for bit
against the source as it is. Ends with the card's name, power limit and
clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops.cuda import _build
from . import _variants

GG = "grouped_gemm"

#: name: (what it changes, [(source, text, replacement), ...])
VARIANTS = {
    "regstore": ("gmm stores every tile from registers (no TMA store)",
                 [(GG, "if (r1 - r0 == WG_BM) {", "if (M < 0) {")]),
    "nostore": ("no output store at all: mainloop and staging only",
                [(GG, "store_bf16x2(out", "if (M < 0) store_bf16x2(out"),
                 (GG, "hw::tma_store_2d(", "if (M < 0) hw::tma_store_2d("),
                 (GG, "hw::tma_store_3d(", "if (M < 0) hw::tma_store_3d(")]),
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


def build(names):
    """{name: (ptt_gmm, ptt_tgmm)} of the source ("base") and each
    variant, compiled in parallel."""
    fns = {}
    libs = _variants.build(names, VARIANTS, [GG], "grouped_gemm_variants")
    for (name, _), lib in libs.items():
        lib.ptt_gmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.ptt_tgmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fns[name] = (lib.ptt_gmm, lib.ptt_tgmm)
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

    M, d, h, E = 32768, 1024, 2816, 8
    sizes = torch.tensor([4100, 4000, 4200, 3900, 4096, 4050, 4150, 3800],
                         dtype=torch.int32, device="cuda")
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    hs, dy, xs, dh = rnd(M, h), rnd(M, d), rnd(M, d), rnd(M, 2 * h)
    w2, w1 = rnd(E, h, d, scale=h ** -0.5), rnd(E, d, 2 * h, scale=d ** -0.5)
    b2 = rnd(E, d, scale=0.1)
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
    }
    for what, (fn, lib) in products.items():
        ref = fn("base")
        times = []
        for v in ["base", *argv, "base"]:
            if v != "nostore":
                out = fn(v)
                torch.cuda.synchronize()
                assert torch.equal(out, ref), (what, v)
            times.append(f"{v} {_variants.cold_ms(lambda: fn(v)):.4f}")
        print(f"{what} (ms): {', '.join(times)}, torch._grouped_mm "
              f"{_variants.cold_ms(lib):.4f}")
    print(_variants.card())


if __name__ == "__main__":
    main(sys.argv[1:])
