"""Time variants of the selective-scan and SSD backward kernels
(``csrc/selective_scan.cu``, ``csrc/ssd.cu``) against the sources as they
are, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.ssm_variants [VARIANT ...]

Each variant is the sources with a few lines replaced (``VARIANTS``; "a+b"
applies the edits of both), built by nvcc into ``build/ssm_variants/`` and
loaded beside the others (``tools/_variants.py``). Every build runs the
backward at the shapes of ``chip_smoke.py`` phase 3 in bf16: the scan at
phase 9's b16 l1024 d1536 n16, the SSD at phase 11's b8 l1024 h24 dh64 ds64
with x, B and C strided as the model's; the forward (the residual) from the
sources as they are. Prints per shape the mean device ms of each build, the
source as it is first and last: each call alone after the 50 MB L2 was
flushed ("cold", as ``chip_smoke.py`` times) and ten calls back to back
("warm"), then each build's ms per kernel of a call (``torch.profiler``).
A call is what the wrapper does: the kernels and the sums of their
partials. Every variant's gradients but the diagnostic ones'
(``DIAGNOSTIC``: each takes work out, to show what holds a kernel back)
are held against the source's (max |diff| <= 1e-2 of max |source|, the
bf16 gate of ``chip_smoke.py``). Ends with the card's name, power limit and
clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch
import torch.nn.functional as F

from ..ops.cuda import _build
from . import _variants

SCAN, SSD = "selective_scan", "ssd"


def _const(src, name, old, new):
    return (src, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


#: name: (what it changes, [(source, text, replacement), ...])
VARIANTS = {
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
    "ssd_1block": ("ssd: both kernels without the 2-blocks-an-SM register "
                   "cap", [(SSD, "__launch_bounds__(THREADS, 2)",
                            "__launch_bounds__(THREADS)")]),
}
#: variants that take work out on purpose: their gradients are not checked
DIAGNOSTIC = {"no_scatter"}


def build(names):
    """{name: ctypes.CDLL per source} of the sources ("base") and each
    variant, compiled in parallel."""
    libs = _variants.build(names, VARIANTS, (SCAN, SSD), "ssm_variants")
    out = {}
    for name in ["base", *names]:
        scan, ssd = libs[(name, SCAN)], libs[(name, SSD)]
        scan.ptt_selective_scan_fwd.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        scan.ptt_selective_scan_bwd.argtypes = [ctypes.c_void_p] * 14 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        ssd.ptt_ssd_fwd.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        ssd.ptt_ssd_bwd.argtypes = [ctypes.c_void_p] * 15 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        out[name] = (scan, ssd)
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
        C.data_ptr(), y.data_ptr(), bounds.data_ptr(), b, l, d, n, 1,
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


def main(argv):
    argv = _variants.names_of(argv, VARIANTS)
    libs = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for make in (scan_case, ssd_case):
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
