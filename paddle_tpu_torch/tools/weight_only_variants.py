"""Time variants of the weight-only GEMMs (``csrc/int8_matmul.cu``) against
the source as it is, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.weight_only_variants [--warm] [NAME ...]

Each variant is the source with a few lines replaced (``VARIANTS``): the
decode kernel's ring depth, column-tile width, consumer warps, CTAs per SM,
the weight maps' L2 promotion, the weight by cp.async instead of TMA, and
``nocompute`` (a diagnostic: the streaming ceiling). All are built by nvcc
into ``build/weight_only_variants/`` and loaded beside each other
(``tools/_variants.py``); each build's plan takes its column tile, CTAs per
SM and cluster occupancy from the library itself. Every build runs
Llama-3-8B's four products of one layer (``chip_smoke.py`` phase 3) for
both kinds at m = 8, 32, 64 and 256, each checked against the plain
version (1e-2 of max |plain|), and prints the mean device ms (CUDA events,
the 50 MB L2 flushed before every launch; the source as it is timed first
and last; ``--warm`` adds each product's warm ms in parentheses: back to
back, L2 kept). The source as it is then runs under other grids, no source
edit: its own plan, the same grid with the last-CTA fix-up where the plan
takes clusters (cluster reduction against the fix-up), half its CTAs
where its shares are k-aligned and twice them still divide a tile's steps
(longer shares against more CTAs), one CTA per slot with shares within
one unit (stream-K against k-aligned shares), whole tiles (the largest grid that divides the
tiles: no fix-up, idle SMs) and the wgmma kernel at m <= 64 (where the
compute-bound kernel should take over, and wgmma against mma.sync at
decode). Ends with the card's name, power limit and clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops.cuda import int8_matmul as wo
from . import _variants

WO = "int8_matmul"

# the decode producer's weight copy: one TMA box a 128 columns, or 16-byte
# cp.async copies from every lane into the same swizzled stage
_TMA_ISSUE = """      if (lane == 0) {
        hw::mbar_expect_tx(bar, WROWS * D_BN);
#pragma unroll
        for (int j = 0; j < D_BN / 128; ++j)
          hw::tma_load_2d(st + j * W_PANEL, &wmap, bar, tile * D_BN + 128 * j, s * WROWS);
      }"""
_LSU_ISSUE = """      for (int i = lane; i < WROWS * D_BN / 16; i += 32) {
        const int r = i / (D_BN / 16), c = 16 * (i % (D_BN / 16));
        ptt::cp_async16(st + wsw(r, c, W_PANEL),
                        w + (long(s) * WROWS + r) * N + long(tile) * D_BN + c, 16);
      }
      if (lane == 0) hw::mbar_arrive(bar);"""

#: name: (what it changes, [(source, text, replacement), ...])
VARIANTS = {
    "occ1": ("one decode CTA per SM, its ring as deep as fits up to 8 "
             "stages (2 CTAs, 3 stages)",
             [(WO, "D_OCC = 2;", "D_OCC = 1;"),
              (WO, "D_STAGES = 3;", "D_STAGES = 8;")]),
    "occ3": ("three decode CTAs per SM (shared memory allowing)",
             [(WO, "D_OCC = 2;", "D_OCC = 3;")]),
    "stages2": ("decode rings of 2 stages (3)",
                [(WO, "D_STAGES = 3;", "D_STAGES = 2;")]),
    "stages4": ("decode rings of up to 4 stages, as fits (3)",
                [(WO, "D_STAGES = 3;", "D_STAGES = 4;")]),
    "bn256": ("256-column decode tiles, 8 consumer warps",
              [(WO, "D_BN = 128;", "D_BN = 256;"),
               (WO, "D_CW = 4;", "D_CW = 8;")]),
    "bn256w4": ("256-column decode tiles, 4 consumer warps (8 bytes a "
                "lane)", [(WO, "D_BN = 128;", "D_BN = 256;")]),
    "l2_256": ("the weight maps promote L2 fetches to 256 bytes",
               [(WO, "W_L2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                 "W_L2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B")]),
    "lsu": ("the decode producer copies the weight by cp.async, 16 bytes a "
            "lane, into the same swizzled stage (no TMA)",
            [(WO, _TMA_ISSUE, _LSU_ISSUE)]),
    "nocompute": ("diagnostic: the decode consumers take each stage and "
                  "compute nothing (the streaming ceiling; no output check)",
                  [(WO, "      decode_stage<MT, INT4>(acc,",
                    "      if (M < 0) decode_stage<MT, INT4>(acc,")]),
    "p_noconv": ("diagnostic: the wgmma kernel's consumers convert no "
                 "weight tile (no output check)",
                 [(WO, "      convert_tile<BNP, INT4>(bt, st, ctid);",
                   "      if (M < 0) convert_tile<BNP, INT4>(bt, st, "
                   "ctid);")]),
    "p_nomma": ("diagnostic: the wgmma kernel issues no wgmma (no output "
                "check)",
                [(WO, "          hw::wgmma_ss<BNP, 0, 1>(acc[mb],",
                  "          if (M < 0) hw::wgmma_ss<BNP, 0, 1>(acc[mb],")]),
    "p_nox": ("diagnostic: the wgmma kernel's producer loads no x (no output "
              "check)",
              [(WO, "hw::mbar_expect_tx(bar, L::W_BYTES + 2 * L::X_HALF);",
                "hw::mbar_expect_tx(bar, L::W_BYTES);"),
               (WO, "        hw::tma_load_2d(st + L::W_BYTES + h * L::X_HALF,",
                "        if (M < 0) hw::tma_load_2d(st + L::W_BYTES + h * "
                "L::X_HALF,")]),
}
#: variants that take work out on purpose: their outputs are not checked
DIAGNOSTIC = {"nocompute", "p_noconv", "p_nomma", "p_nox"}

WARM = False   # also print each product's warm ms (back to back, L2 kept)
SHAPES = (("qkv", 4096, 6144), ("out", 4096, 4096), ("ffn1", 4096, 28672),
          ("ffn2", 14336, 4096))


class Build:
    """One build's entries and geometry."""

    def __init__(self, lib):
        self.gemm = lib.ptt_weight_only_gemm
        self.gemm.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        self.encode = lib.ptt_weight_only_encode
        self.encode.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
        self.encode_x = lib.ptt_weight_only_encode_x
        self.encode_x.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
        self.bn = lib.ptt_weight_only_decode_bn()
        self.occupancy = lib.ptt_weight_only_decode_occupancy
        self.occupancy.argtypes = [ctypes.c_int] * 3 \
            + [ctypes.POINTER(ctypes.c_int)]
        self.maps = {}
        self.ws = torch.empty(0, dtype=torch.float32, device="cuda")
        self.flags = torch.zeros(512, dtype=torch.int32, device="cuda")

    def resident(self, m, int4, n):
        """The decode kernel's CTAs an SM (n = 1) or clusters of n the
        card holds at once for m rows."""
        count = ctypes.c_int(0)
        assert self.occupancy(min(m, wo.DECODE_MAX_ROWS), int(int4), n,
                              ctypes.byref(count)) == 0
        return count.value

    def plan(self, m, K, N, int4, sms, wgmma=False, whole=False,
             fixup=False, stream_k=False, half=False):
        occ = min(wo.DECODE_OCC, self.resident(m, int4, 1))
        p = wo.wgmma_plan(m, K, N, int4, sms) if wgmma else wo.plan(
            m, K, N, int4, sms, self.bn, occ,
            lambda n: self.resident(m, int4, n))
        if fixup:   # the same grid, the shared tiles summed through L2
            p = p._replace(cluster=1)
        share = p.units // p.ctas
        if half and p.kind == 0 and p.units % p.ctas == 0 \
                and p.steps % (2 * share) == 0:   # k-aligned, twice as long
            p = p._replace(ctas=p.ctas // 2, cluster=max(1, p.cluster // 2))
        if stream_k:   # one CTA per slot, shares within one unit
            p = p._replace(ctas=min(p.units, sms * (occ if p.kind == 0
                                                    else 1)), cluster=1)
        if whole:   # the largest grid that gives every CTA whole tiles
            p = p._replace(ctas=max(d for d in range(1, min(p.tiles, sms) + 1)
                                    if p.tiles % d == 0), cluster=1)
        return p

    def map(self, key, fn, *args):
        if key not in self.maps:
            buf = ctypes.create_string_buffer(128)
            assert fn(buf, *args) == 0
            self.maps[key] = buf
        return self.maps[key]

    def run(self, p, x, w, scale, int4):
        m, K = x.shape
        N = w.shape[1]
        wmap = self.map(("w", w.data_ptr(), *w.shape, p.wrows), self.encode,
                        w.data_ptr(), w.shape[0], N, p.wrows)
        xmap = self.map(("x", m, K), self.encode_x, x.data_ptr(), m, K) \
            if p.kind else None
        # the counters stay 0 between launches; the scratch only grows
        if self.ws.numel() < p.ws_floats:
            self.ws = torch.empty(p.ws_floats, dtype=torch.float32,
                                  device="cuda")
        out = torch.empty(m, N, dtype=torch.bfloat16, device="cuda")
        rc = self.gemm(wmap, xmap, w.data_ptr(), x.data_ptr(),
                       scale.data_ptr(), out.data_ptr(), self.ws.data_ptr(),
                       self.flags.data_ptr(), m, K, N, p.kind, p.ctas,
                       p.cluster, int(int4), 0,
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out


def main(argv):
    global WARM
    if "--warm" in argv:
        argv = [a for a in argv if a != "--warm"]
        WARM = True
    argv = _variants.names_of(argv, VARIANTS)
    libs = _variants.build(argv, VARIANTS, [WO], "weight_only_variants")
    builds = {name: Build(lib) for (name, _), lib in libs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = ["base", *argv, "base"]
    failures = 0

    def timed(label, runs):
        """runs: {column: (build, plan kwargs)}; prints one line per kind
        and row count with each column's ms per product and their sum."""
        nonlocal failures
        for int4 in (False, True):
            kind = "int4" if int4 else "int8"
            for m in (8, 32, 64, 256):
                sums = {c: 0.0 for c in runs}
                cells = []
                for name, K, N in SHAPES:
                    rows = K // 2 if int4 else K
                    w = torch.randint(-128, 128, (rows, N), dtype=torch.int8,
                                      device="cuda", generator=gen)
                    scale = torch.rand(N, generator=gen, device="cuda") \
                        * 2e-3 + 1e-4
                    x = torch.randn(m, K, generator=gen,
                                    device="cuda").bfloat16()
                    plain = (wo.int4_weight_matmul_reference if int4 else
                             wo.int8_weight_matmul_reference)(x, w, scale)
                    peak = plain.float().abs().max().item()
                    ms = []
                    for col, (b, kw) in runs.items():
                        kw = dict(kw)
                        if m in kw.pop("skip_m", ()):
                            ms.append("-")
                            continue
                        p = b.plan(m, K, N, int4, sms, **kw)
                        out = b.run(p, x, w, scale, int4)
                        torch.cuda.synchronize()
                        err = (out.float() - plain.float()).abs().max().item()
                        if not err <= 1e-2 * peak and not any(
                                d in col.split("#")[0].split("+")
                                for d in DIAGNOSTIC):
                            failures += 1
                            print(f"  FAIL {col} {kind} {name} m={m}: max "
                                  f"|diff| {err:.3e}, peak {peak:.3e}")
                        t = _variants.cold_ms(
                            lambda: b.run(p, x, w, scale, int4), reps=10)
                        warm = _variants.warm_ms(
                            lambda: b.run(p, x, w, scale, int4), reps=20)
                        sums[col] += t
                        ms.append(f"{t:.4f}" + (f" ({warm:.4f})" if WARM
                                                else ""))
                    cells.append(f"{name} " + " / ".join(ms))
                print(f"  {label} {kind} m={m}: " + "; ".join(cells)
                      + "; sum " + " / ".join(f"{sums[c]:.4f}" for c in runs))

    print("== builds (columns: " + " / ".join(order) + ")")
    timed("builds", {f"{n}#{i}": (builds[n], {}) for i, n in
                     enumerate(order)})
    base = builds["base"]
    print("== plans of the source as it is (columns: its own plan / the "
          "same grid with the last-CTA fix-up for clusters / half the CTAs, "
          "twice the k-aligned shares / stream-K / whole tiles / wgmma "
          "kernel)")
    timed("plans", {"own": (base, {}),
                    "fixup": (base, {"fixup": True}),
                    "half": (base, {"half": True}),
                    "stream-K": (base, {"stream_k": True}),
                    "whole": (base, {"whole": True}),
                    "wgmma": (base, {"wgmma": True, "skip_m": (256,)})})
    print(f"== {failures} failures; card: {_variants.card()}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
