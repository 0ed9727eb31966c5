"""Time variants of the wgmma flash attention kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) against the
sources as they are, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.flash_variants [VARIANT ...]

Each variant is the sources with a few lines replaced (``VARIANTS``; "a+b"
applies the edits of both), built by nvcc into ``build/flash_variants/``
and loaded beside the others (``tools/_variants.py``). Every
build runs the shapes of ``chip_smoke.py`` phase 3: the forward with lse at
the training shape (b 2, S 2048, 32 / 32 heads, d 128, causal), the serving
forward at S 2048 with GQA 32 / 8 and no lse, the forward with lse at d 64
(b 2, S 2048, 64 / 64 heads: the same width, where the tile-width variant
applies) and the backward at the training shape and at d 64. Prints per
shape the mean device ms of each build, the source as it is first and last:
each launch alone after the 50 MB L2 was flushed ("cold", as
``chip_smoke.py`` times) and ten launches back to back ("warm"), and the
same two for ``scaled_dot_product_attention`` (forward, or its backward);
for the backward also each build's ms per kernel (delta, dK/dV, dQ) by
``torch.profiler``.
Every variant's outputs but the diagnostic ones' (``DIAGNOSTIC``: each
takes one kind of work out of the forward, to show what holds it back) are
held against the source's (max |diff| <= 2e-2 for out, <= 2e-2 of max |out|
for dq, dk, dv). Ends with the card's name,
power limit and clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops.cuda import _build
from . import _variants

FWD, BWD = "flash_attention", "flash_attention_bwd"

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
DIAGNOSTIC = {"no_exp", "no_pv", "no_load"}
# the C entries' mask arguments when there is no mask and no segment ids
NO_MASK_PTRS, NO_MASK_INTS = (None, None, None), (0, 0, 0, 0)


def build(names):
    """{name: (ptt_flash_fwd, ptt_flash_bwd)} of the sources ("base") and
    each variant, compiled in parallel."""
    libs = _variants.build(names, VARIANTS, (FWD, BWD), "flash_variants")
    fns = {}
    for name in ["base", *names]:
        fwd = libs[(name, FWD)].ptt_flash_fwd
        fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
        bwd = libs[(name, BWD)].ptt_flash_bwd
        bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fns[name] = (fwd, bwd)
    return fns


def main(argv):
    import torch.nn.functional as F

    argv = _variants.names_of(argv, VARIANTS)
    fns = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cold_ms, warm_ms = _variants.cold_ms, _variants.warm_ms

    def shape(b, s, hq, hk, d):
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, hk, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, hk, d, generator=gen, device="cuda").bfloat16()
        do = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        return q, k, v, do

    def fwd(name, q, k, v, with_lse):
        b, s, hq, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty(b, hq, s, device="cuda") if with_lse else None
        rc = fns[name][0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), None if lse is None else lse.data_ptr(),
                          *NO_MASK_PTRS, b, s, s, hq, k.shape[2], d, s, 0, 1,
                          *NO_MASK_INTS, d ** -0.5, _build.stream(q))
        assert rc == 0, rc
        return out, lse

    def bwd(name, q, k, v, out, lse, do):
        b, s, hq, d = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(b, hq, s, device="cuda")
        rc = fns[name][1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), *NO_MASK_PTRS, b, s, s, hq,
                          k.shape[2], d, s, 0, 1, *NO_MASK_INTS, d ** -0.5,
                          _build.stream(q))
        assert rc == 0, rc
        return dq, dk, dv

    cases = {
        "fwd+lse b2 S2048 32/32 d128": ((2, 2048, 32, 32, 128), "fwd", True),
        "fwd S2048 32/8 d128": ((1, 2048, 32, 8, 128), "fwd", False),
        "fwd+lse b2 S2048 64/64 d64": ((2, 2048, 64, 64, 64), "fwd", True),
        "bwd b2 S2048 32/32 d128": ((2, 2048, 32, 32, 128), "bwd", True),
        "bwd b2 S2048 64/64 d64": ((2, 2048, 64, 64, 64), "bwd", True),
    }
    for what, (dims, kind, with_lse) in cases.items():
        q, k, v, do = shape(*dims)
        out, lse = fwd("base", q, k, v, True)
        if kind == "fwd":
            run = lambda name: fwd(name, q, k, v, with_lse)  # noqa: E731
        else:
            run = lambda name: bwd(name, q, k, v, out, lse, do)  # noqa: E731
        ref = run("base")
        times, split = [], {}
        for name in ["base", *argv, "base"]:
            got = run(name)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if g is None or set(name.split("+")) & DIAGNOSTIC:
                    continue
                diff = (g.float() - r.float()).abs().max().item()
                lim = 2e-2 if kind == "fwd" else 2e-2 * r.float().abs().max().item()
                assert diff <= lim, (what, name, diff, lim)
            times.append(f"{name} {cold_ms(lambda: run(name)):.4f} / "
                         f"{warm_ms(lambda: run(name)):.4f}")
            if kind == "bwd":
                split[name] = _variants.kernel_ms(lambda: run(name),
                                                  r"flash_\w+?_kernel")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        gqa = dict(enable_gqa=True) if k.shape[2] != q.shape[2] else {}
        if kind == "fwd":
            def lib():
                with torch.no_grad():
                    F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   **gqa)
        else:
            so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
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
