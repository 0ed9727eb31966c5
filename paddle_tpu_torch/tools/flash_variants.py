"""Time variants of the flash attention kernels against the sources as they
are, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.flash_variants [VARIANT ...]

Each variant is the sources with a few lines replaced (``VARIANTS``; "a+b"
applies the edits of both), built by nvcc into ``build/flash_variants/``
and loaded beside the others (``tools/_variants.py``). Two families of
shapes, each run when a named variant edits its sources (both when none is
named):

- the d = 64 / 128 kernels (``csrc/flash_attention.cu``,
  ``csrc/flash_attention_bwd.cu``) at ``chip_smoke.py`` phase 3's shapes:
  the forward with lse at the training shape (b 2, S 2048, 32 / 32 heads,
  d 128, causal), the serving forward at S 2048 with GQA 32 / 8 and no lse,
  the forward with lse at d 64 (b 2, S 2048, 64 / 64 heads) and the
  backward at the training shape and at d 64;
- the head-dim kernels (``csrc/flash_attention_mma.cu``) at the vision
  paths' shapes, non-causal: ViT-H14 (b 32, S 257, 16 heads of 80), the
  UNet's level 1 (b 32, S 256, 12 heads of 32) self-attention and
  cross-attention (256 x 77), and d 16 (b 16, S 1024, 8 heads), each
  forward with lse and backward.

Prints per shape the mean device ms of each build, the source as it is
first and last: each launch alone after the 50 MB L2 was flushed ("cold",
as ``chip_smoke.py`` times) and ten launches back to back ("warm"), and the
same two for ``scaled_dot_product_attention`` (forward, or its backward);
for the backward also each build's ms per kernel (delta, dK/dV, dQ) by
``torch.profiler``.
Every variant's outputs but the diagnostic ones' (``DIAGNOSTIC``: each
takes one kind of work out of the forward, to show what holds it back) are
held against the source's (max |diff| <= 2e-2 for out, <= 2e-2 of max |out|
for dq, dk, dv). Ends with the card's name, power limit and clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops.cuda import _build
from . import _variants

FWD, BWD = "flash_attention", "flash_attention_bwd"
MMA = "flash_attention_mma"
#: the sources of each family of kernels (the head-dim source holds both
#: entries)
FAMILIES = {"wgmma": (FWD, BWD), "mma": (MMA, MMA)}

#: the block-index decoding of a grid ordered by q tile, batch, head
_TILE_MAJOR = ("const int t = blockIdx.z;   // from the last q tile down\n"
               "  const int h = blockIdx.x;\n  const int b = blockIdx.y;")
_HEAD_MAJOR = ("const int t = blockIdx.x;   // from the last q tile down\n"
               "  const int h = blockIdx.y;\n  const int b = blockIdx.z;")
_NO_TURNS = [(src, f"pp.{step}();", "") for src in (FWD, BWD)
             for step in ("start", "begin", "end", "finish")]

#: name: (what it changes, [(source, text, replacement), ...])
VARIANTS = {
    "bn192_d64": ("forward kv tiles of 192 rows at d = 64 (m64n192 scores)",
                  [(FWD, "static constexpr int BN = 128;",
                    "static constexpr int BN = D == 64 ? 192 : 128;")]),
    "fwd_stages2": ("forward ring of 2 K/V stages",
                    [(FWD, "constexpr int STAGES = 3;",
                      "constexpr int STAGES = 2;")]),
    "no_overlap": ("forward: the softmax of tile j waits for the PV of tile "
                   "j - 1 as well (no softmax under a product)",
                   [(FWD, "hw::wgmma_wait<1>();", "hw::wgmma_wait<0>();")]),
    "no_pingpong": ("forward consumers issue wgmma without taking turns",
                    [e for e in _NO_TURNS if e[0] == FWD]),
    "bwd_no_pingpong": ("backward consumers issue wgmma without taking turns",
                        [e for e in _NO_TURNS if e[0] == BWD]),
    "head_major": ("grids ordered by head and batch, the tiles of one head "
                   "next to each other",
                   [(FWD, _TILE_MAJOR, _HEAD_MAJOR),
                    (FWD, "const dim3 grid(hq, b, ntq);",
                     "const dim3 grid(ntq, hq, b);"),
                    (BWD, _TILE_MAJOR, _HEAD_MAJOR),
                    (BWD, "const int kvh = blockIdx.x;\n  const int b = "
                     "blockIdx.y;\n  const int n0 = blockIdx.z * BKV;",
                     "const int kvh = blockIdx.y;\n  const int b = "
                     "blockIdx.z;\n  const int n0 = blockIdx.x * BKV;"),
                    (BWD, "const dim3 grid_kv(hk, b, nkv), grid_q(hq, b, ntq);",
                     "const dim3 grid_kv(nkv, hk, b), grid_q(ntq, hq, b);")]),
    "dkdv_q32": ("dK/dV steps of 32 q rows at d = 128 (m64n32 scores)",
                 [(BWD, "static constexpr int QS = 64;",
                   "static constexpr int QS = D == 128 ? 32 : 64;")]),
    "bwd_stages2": ("backward rings of 2 stages",
                    [(BWD, "constexpr int STAGES = 3;",
                      "constexpr int STAGES = 2;")]),
    "dq_kv128": ("dQ steps of 128 kv rows, rings of 2 stages (3 do not fit "
                 "at d = 128)",
                 [(BWD, "static constexpr int KS = 64;",
                   "static constexpr int KS = 128;"),
                  (BWD, "constexpr int STAGES = 3;",
                   "constexpr int STAGES = 2;")]),
    # what holds the forward back: each takes one kind of work away, so its
    # output is wrong and is not checked
    "no_exp": ("forward without exp2: p = s c - m (diagnostic)",
               [(FWD, "float p = hw::ex2_approx(fmaf(s[4 * j + e], c, "
                 "-base[r]));", "float p = fmaf(s[4 * j + e], c, -base[r]);")]),
    "no_pv": ("forward without the O += P V products (diagnostic)",
              [(FWD, "hw::wgmma_rs<D, 1>(o, pa[kk], hw::desc_advance(v_desc, "
                "kk * 2048), 1);", "")]),
    "no_load": ("forward K and V loaded into each stage once, later tiles "
                "reuse them (diagnostic: no HBM or L2 traffic in the loop)",
                [(FWD, "hw::mbar_expect_tx(&full_k[stage], L::KV_BYTES);",
                  "if (j >= STAGES) hw::mbar_arrive(&full_k[stage]);\n"
                  "        else hw::mbar_expect_tx(&full_k[stage], "
                  "L::KV_BYTES);"),
                 (FWD, "hw::mbar_expect_tx(&full_v[stage], L::KV_BYTES);",
                  "if (j >= STAGES) hw::mbar_arrive(&full_v[stage]);\n"
                  "        else hw::mbar_expect_tx(&full_v[stage], "
                  "L::KV_BYTES);"),
                 (FWD, "hw::tma_load_4d(st + p * L::KV_PANEL, &map_k",
                  "if (j < STAGES) hw::tma_load_4d(st + p * L::KV_PANEL, "
                  "&map_k"),
                 (FWD, "hw::tma_load_4d(st + L::KV_BYTES + p * L::KV_PANEL, "
                  "&map_v", "if (j < STAGES) hw::tma_load_4d(st + L::KV_BYTES"
                  " + p * L::KV_PANEL, &map_v")]),
}
# the head-dim kernels' knobs (csrc/flash_attention_mma.cu)
_FWD_KNOBS = ("static constexpr int NC = D > 96 ? 2 : D > 64 ? 3 : 1;\n  "
              "static constexpr int MIN_BLOCKS = D > 64 ? 1 : 2;")
# the backward kernels' knobs (dK/dV's and dQ's lines read alike)
_BWD_KNOBS = ("static constexpr int NC = D <= 32 ? 1 : 2;\n  static constexpr "
              "int MIN_BLOCKS = D <= 32 ? 3 : 1;")


def _bwd(nc, min_blocks):
    return [(MMA, _BWD_KNOBS, f"static constexpr int NC = {nc};\n  static "
             f"constexpr int MIN_BLOCKS = {min_blocks};")]


def _fwd(nc, min_blocks):
    return [(MMA, _FWD_KNOBS, f"static constexpr int NC = {nc};\n  static "
             f"constexpr int MIN_BLOCKS = {min_blocks};")]


_HD = {
    "hd_fwd_nc2": ("head-dim forward: two consumer warpgroups at every d "
                   "(128-row units), one CTA an SM",
                   _fwd(2, 1)),
    "hd_small_nc2x2": ("head-dim forward at d <= 48: two consumer "
                       "warpgroups a CTA (128-row units), registers for two "
                       "CTAs an SM", _fwd("D > 96 ? 2 : D > 64 ? 3 : 2", "D > 64 ? 1 : 2")),
    "hd_bn128": ("head-dim forward: kv tiles of 128 rows",
                 [(MMA, "static constexpr int BN = 64;         // kv rows of "
                   "a tile", "static constexpr int BN = 128;")]),
    "hd_one_cta": ("head-dim kernels: one CTA a unit (not persistent)",
                   [(MMA, "constexpr bool PERSISTENT = true;",
                     "constexpr bool PERSISTENT = false;")]),
    "hd_tile_major": ("head-dim kernels: units in tile order (the longest "
                      "tiles of every head first)",
                      [(MMA, "constexpr bool HEAD_MAJOR = true;",
                        "constexpr bool HEAD_MAJOR = false;")]),
    "hd_sw128": ("head-dim kernels: the 128-byte swizzle (64-column "
                 "panels) at every d",
                 [(MMA, "return D <= 32 ? 64 : 128;", "return 128;")]),
    "hd_bwd_three_groups": ("head-dim dK/dV at d <= 48: three groups of "
                            "products a step (S^T; dV with dP^T; dK), as "
                            "above d = 48",
                            [(MMA, "static constexpr bool TWO_GROUPS = D <= 48;",
                              "static constexpr bool TWO_GROUPS = false;")]),
    "hd_no_turns": ("head-dim kernels: two consumer warpgroups issue "
                    "without taking turns",
                    [(MMA, "if constexpr (NC == 2) pp.",
                      "if constexpr (false) pp.")]),
    "hd_stages4": ("head-dim kernels: rings of up to 4 stages",
                   [(MMA, "fit_stages(3, FIXED, PER_STAGE)",
                     "fit_stages(4, FIXED, PER_STAGE)")]),
    "hd_dkdv_qs32": ("head-dim dK/dV: steps of 32 q rows",
                     [(MMA, "static constexpr int QS = D > 80 ? 32 : 64;",
                       "static constexpr int QS = 32;")]),
    "hd_bwd_nc2": ("head-dim dK/dV and dQ: two consumer warpgroups a CTA "
                   "(taking turns), one CTA an SM, at every d",
                   _bwd(2, 1)),
    "hd_bwd_small_nc1x4": ("head-dim dK/dV and dQ at d <= 32: registers for "
                           "four CTAs an SM",
                           _bwd("D <= 32 ? 1 : 2", "D <= 32 ? 4 : 1")),
    "hd_bwd_nc3": ("head-dim dK/dV and dQ above d = 32: three consumer "
                   "warpgroups a CTA, no turns, one K / V buffer above d = 64",
                   _bwd("D <= 32 ? 1 : 3", "D <= 32 ? 3 : 1") + [
                       (MMA, "static constexpr int KV_BUFS = 2;",
                        "static constexpr int KV_BUFS = D > 64 ? 1 : 2;")]),
    "hd_producer_warp": ("head-dim forward: a producer warp and no "
                         "setmaxnreg at d > 64 too",
                         [(MMA, "static constexpr bool PRODUCER_WG = "
                           "MIN_BLOCKS == 1;", "static constexpr bool "
                           "PRODUCER_WG = false;")]),
    "hd_no_skip": ("head-dim dK/dV and dQ: a unit's idle second warpgroup "
                   "runs its products too",
                   [(MMA, "static constexpr bool SKIP_IDLE_WG = true;",
                     "static constexpr bool SKIP_IDLE_WG = false;")]),
    # diagnostics of the head-dim forward (outputs wrong, not checked)
    "hd_no_exp": ("head-dim forward without exp2 (diagnostic)",
                  [(MMA, "float p = hw::ex2_approx(fmaf(s[4 * j + e], c, "
                    "-base[r]));", "float p = fmaf(s[4 * j + e], c, "
                    "-base[r]);")]),
    "hd_no_pv": ("head-dim forward without the O += P V products "
                 "(diagnostic)",
                 [(MMA, "hw::wgmma_rs<D, 1>(o, pa[kk], hw::desc_advance("
                   "v_desc, kk * 16 * P::ROW), 1);", "")]),
    "hd_no_load": ("head-dim forward: K and V loaded into each stage once, "
                   "later tiles reuse them (diagnostic: no L2 or HBM "
                   "traffic for K and V)",
                   [(MMA, "hw::mbar_expect_tx(&full_k[stage], L::KV_BYTES);",
                     "if (k > 0 || j >= ST) hw::mbar_arrive(&full_k[stage]);"
                     "\n        else hw::mbar_expect_tx(&full_k[stage], "
                     "L::KV_BYTES);"),
                    (MMA, "hw::mbar_expect_tx(&full_v[stage], L::KV_BYTES);",
                     "if (k > 0 || j >= ST) hw::mbar_arrive(&full_v[stage]);"
                     "\n        else hw::mbar_expect_tx(&full_v[stage], "
                     "L::KV_BYTES);"),
                    (MMA, "hw::tma_load_4d(st + p * L::KV_PANEL, &map_k, "
                     "&full_k[stage]", "if (k == 0 && j < ST) hw::tma_load_4d"
                     "(st + p * L::KV_PANEL, &map_k, &full_k[stage]"),
                    (MMA, "hw::tma_load_4d(st + L::KV_BYTES + p * L::KV_PANEL,"
                     " &map_v, &full_v[stage]", "if (k == 0 && j < ST) "
                     "hw::tma_load_4d(st + L::KV_BYTES + p * L::KV_PANEL, "
                     "&map_v, &full_v[stage]")]),
}
VARIANTS.update(_HD)
DIAGNOSTIC = {"no_exp", "no_pv", "no_load", "hd_no_exp", "hd_no_pv",
              "hd_no_load"}
# the C entries' mask arguments when there is no mask and no segment ids
NO_MASK_PTRS, NO_MASK_INTS = (None, None, None), (0, 0, 0, 0)


def build(names):
    """{name: (ptt_flash_fwd, ptt_flash_bwd)} of the sources ("base") and
    each variant, compiled in parallel."""
    libs = _variants.build(names, VARIANTS, (FWD, BWD, MMA), "flash_variants")
    fns = {}
    for name in ["base", *names]:
        for family, (f_src, b_src) in FAMILIES.items():
            fwd = libs[(name, f_src)].ptt_flash_fwd
            fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
                + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
            bwd = libs[(name, b_src)].ptt_flash_bwd
            bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 \
                + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
            fns[(name, family)] = (fwd, bwd)
    return fns


#: name: (family, (b, sq, sk, hq, hk, d, causal), "fwd" (with lse) / "fwd
#: no lse" / "bwd")
CASES = {
    "fwd+lse b2 S2048 32/32 d128": ("wgmma", (2, 2048, 2048, 32, 32, 128, 1),
                                    "fwd"),
    "fwd S2048 32/8 d128": ("wgmma", (1, 2048, 2048, 32, 8, 128, 1),
                            "fwd no lse"),
    "fwd+lse b2 S2048 64/64 d64": ("wgmma", (2, 2048, 2048, 64, 64, 64, 1),
                                   "fwd"),
    "bwd b2 S2048 32/32 d128": ("wgmma", (2, 2048, 2048, 32, 32, 128, 1),
                                "bwd"),
    "bwd b2 S2048 64/64 d64": ("wgmma", (2, 2048, 2048, 64, 64, 64, 1), "bwd"),
    "ViT-H14 fwd+lse b32 S257 16/16 d80": ("mma", (32, 257, 257, 16, 16, 80,
                                                   0), "fwd"),
    "ViT-H14 bwd b32 S257 16/16 d80": ("mma", (32, 257, 257, 16, 16, 80, 0),
                                       "bwd"),
    "UNet l1 fwd+lse b32 S256 12/12 d32": ("mma", (32, 256, 256, 12, 12, 32,
                                                   0), "fwd"),
    "UNet l1 bwd b32 S256 12/12 d32": ("mma", (32, 256, 256, 12, 12, 32, 0),
                                       "bwd"),
    "UNet l1 cross fwd+lse b32 256x77 12/12 d32": ("mma", (32, 256, 77, 12,
                                                           12, 32, 0), "fwd"),
    "UNet l1 cross bwd b32 256x77 12/12 d32": ("mma", (32, 256, 77, 12, 12,
                                                       32, 0), "bwd"),
    "d16 fwd+lse b16 S1024 8/8": ("mma", (16, 1024, 1024, 8, 8, 16, 0),
                                  "fwd"),
    "d16 bwd b16 S1024 8/8": ("mma", (16, 1024, 1024, 8, 8, 16, 0), "bwd"),
}


def main(argv):
    import torch.nn.functional as F

    argv = _variants.names_of(argv, VARIANTS)
    fns = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cold_ms, warm_ms = _variants.cold_ms, _variants.warm_ms
    edited = {e[0] for v in argv for p in v.split("+") for e in VARIANTS[p][1]}
    families = {f for f, srcs in FAMILIES.items() if set(srcs) & edited} \
        or set(FAMILIES)

    def fwd(name, family, q, k, v, causal, with_lse):
        b, sq, hq, d = q.shape
        sk = k.shape[1]
        out = torch.empty_like(q)
        lse = torch.empty(b, hq, sq, device="cuda") if with_lse else None
        rc = fns[(name, family)][0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), *NO_MASK_PTRS, b, sq, sk,
            hq, k.shape[2], d, sk, sk - sq, causal, *NO_MASK_INTS, d ** -0.5,
            _build.stream(q))
        assert rc == 0, rc
        return out, lse

    def bwd(name, family, q, k, v, out, lse, do, causal):
        b, sq, hq, d = q.shape
        sk = k.shape[1]
        dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                      torch.empty_like(v))
        delta = torch.empty(b, hq, sq, device="cuda")
        rc = fns[(name, family)][1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *NO_MASK_PTRS, b, sq, sk, hq,
            k.shape[2], d, sk, sk - sq, causal, *NO_MASK_INTS, d ** -0.5,
            _build.stream(q))
        assert rc == 0, rc
        return dq, dk, dv

    for what, (family, dims, kind) in CASES.items():
        if family not in families:
            continue
        b, sq, sk, hq, hk, d, causal = dims
        q, do = (torch.randn(b, sq, hq, d, generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, sk, hk, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        out, lse = fwd("base", family, q, k, v, causal, True)
        if kind.startswith("fwd"):
            run = lambda name: fwd(name, family, q, k, v, causal,  # noqa: E731
                                   kind == "fwd")
        else:
            run = lambda name: bwd(name, family, q, k, v, out,  # noqa: E731
                                   lse, do, causal)
        ref = run("base")
        times, split = [], {}
        for name in ["base", *argv, "base"]:
            got = run(name)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if g is None or set(name.split("+")) & DIAGNOSTIC:
                    continue
                diff = (g.float() - r.float()).abs().max().item()
                lim = 2e-2 if kind != "bwd" \
                    else 2e-2 * r.float().abs().max().item()
                assert diff <= lim, (what, name, diff, lim)
            times.append(f"{name} {cold_ms(lambda: run(name)):.4f} / "
                         f"{warm_ms(lambda: run(name)):.4f}")
            if kind == "bwd":
                split[name] = _variants.kernel_ms(lambda: run(name),
                                                  r"flash_\w+?_kernel")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        gqa = dict(enable_gqa=True) if hk != hq else {}
        if kind != "bwd":
            def lib():
                with torch.no_grad():
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=bool(causal),
                                                   **gqa)
        else:
            so = F.scaled_dot_product_attention(qt, kt, vt,
                                                is_causal=bool(causal))
            dot = do.transpose(1, 2)

            def lib():
                torch.autograd.grad(so, (qt, kt, vt), dot, retain_graph=True)
        print(f"{what} (ms, cold / warm): {', '.join(times)}, sdpa "
              f"{cold_ms(lib):.4f} / {warm_ms(lib):.4f}", flush=True)
        for name, per in split.items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                            per.items()))
        del q, k, v, do, out, lse, ref
    print(_variants.card())


if __name__ == "__main__":
    main(sys.argv[1:])
