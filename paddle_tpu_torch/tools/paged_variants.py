"""Time variants of the paged decode kernel (``csrc/paged_attention.cu``)
against the source as it is, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.paged_variants [VARIANT ...]

Each variant is the source with a few lines replaced (``VARIANTS``; "a+b"
applies the edits of both), built by nvcc into ``build/paged_variants/``
and loaded beside the others (``tools/_variants.py``). Every build runs the
calls of ``chip_smoke.py`` phase 3 on bf16 and on int8 pages: q [8, 32,
128], one layer's pool [8, 1025, 16, 128] (int8: with its block-major
scales), rows of 0, 1, 16, 17, 1000, 2048, 700 and 1532 tokens on shuffled
blocks with null table tails. Each build's out, m and l are held to the
plain version (out within 2e-2, m and l within 1e-3 of max(|plain|, 1),
the gates of ``chip_smoke.py``) and its second call to its first (bitwise
equal), but those of the variants in ``DIAGNOSTIC``, which take work out
to show what holds the kernel back. First prints the same timers' floor:
one launch that writes an output of the calls' size. Prints per call the mean device ms of each build, the source as it
is first and last: each call alone after the 50 MB L2 was flushed
("cold", as ``chip_smoke.py`` times) and ten calls back to back ("warm"),
with each build's launches a call (``torch.profiler``). Ends with the
card's name, power limit and clocks.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..models.kv_cache import quantize_kv
from ..ops.cuda import _build
from ..ops.cuda.paged_attention import paged_attention_reference
from . import _variants

SRC = "paged_attention"
LENS = (0, 1, 16, 17, 1000, 2048, 700, 1532)


def _const(name, old, new):
    return (SRC, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


VARIANTS = {
    "stages3": ("3 units staged a CTA", [_const("STAGES", 4, 3)]),
    "stages6": ("6 units staged a CTA", [_const("STAGES", 4, 6)]),
    "ctas1": ("a grid of 1 CTA an SM", [_const("CTAS_PER_SM", 2, 1)]),
    "ctas3": ("a grid of 3 CTAs an SM", [_const("CTAS_PER_SM", 2, 3)]),
    "ctas4": ("a grid of 4 CTAs an SM", [_const("CTAS_PER_SM", 2, 4)]),
    # the alternative to the even shares: a fixed share of 8 units and a
    # grid of 16 CTAs an SM, the CTAs past the list leaving at once
    "fixed_split": ("a fixed share of 8 units a CTA, 16 CTAs an SM",
                    [(SRC, "const int per = (N + int(gridDim.x) - 1) / "
                      "int(gridDim.x);", "const int per = 8;"),
                     _const("CTAS_PER_SM", 2, 16)]),
    "no_load": ("the units' copies zero-fill, reading nothing (diagnostic)",
                [(SRC, "crow[it] < val ? 16 : 0", "0")]),
    "no_math": ("no scores of the next unit and no P V products "
                "(diagnostic)",
                [(SRC, "      if (i + 1 < n) {                 // the next unit's "
                  "scores, with its part's queries", "      if (false) {"),
                 (SRC, "          ptt::mma16816(acc[j], ph, b0, b1);\n"
                  "          ptt::mma16816(acc[j], pl, b0, b1);\n", "")]),
    "no_merge": ("no merge of the split rows (diagnostic)",
                 [(SRC, "if (s.last) {", "if (false) {")]),
    # thread 0 of each CTA stamps the card's clock (ns): 0 at its start, 1
    # after the lengths' sum, 2 when its first unit landed, 3 + i after unit
    # i's products and 16 + i after the end of a segment's part there (i <
    # 12, the first window), 31 at its end: where a call's time goes
    # (printed by main)
    "timeline": ("each CTA's clock at its start, prefix sum, first unit, "
                 "each unit and end of segment, and its end (diagnostic)",
                 [(SRC, "  const int cap = pps * page;",
                   "  const int cap = pps * page;\n"
                   "  float* dbg = part + 2 * size_t(gridDim.x) * SLOT + 32 * "
                   "blockIdx.x;\n  auto stamp = [&](int k) {\n    if (threadIdx.x "
                   "== 0) {\n      unsigned c;\n      asm volatile(\"mov.u32 %0, "
                   "%%globaltimer_lo;\" : \"=r\"(c));\n      dbg[k] = "
                   "__uint_as_float(c);\n    }\n  };\n  stamp(0);"),
                  (SRC, "  const int s0 = int(blockIdx.x) * per, e0 = min(N, "
                   "s0 + per);", "  const int s0 = int(blockIdx.x) * per, e0 = "
                   "min(N, s0 + per);\n  stamp(1);"),
                  (SRC, "    __syncthreads();                   // unit 0 landed\n",
                   "    __syncthreads();                   // unit 0 landed\n"
                   "    if (w0 == s0) stamp(2);\n"),
                  (SRC, "      if (!ends) continue;", "      if (w0 == s0 && i < 12) "
                   "stamp(3 + i);\n      if (!ends) continue;"),
                  (SRC, "      m = NEG_INF;\n      l = 0.f;",
                   "      if (w0 == s0 && i < 12) stamp(16 + i);\n"
                   "      m = NEG_INF;\n      l = 0.f;"),
                  (SRC, "acc[j][3] = 0.f;\n    }\n  }\n}",
                   "acc[j][3] = 0.f;\n    }\n  }\n  stamp(31);\n}")]),
}
#: variants that take work out on purpose: their outputs are not checked
DIAGNOSTIC = {"no_merge", "no_load", "no_math"}


def build(names):
    """{name: ctypes.CDLL} of the source ("base") and each variant."""
    libs = _variants.build(names, VARIANTS, (SRC,), "paged_variants")
    out = {}
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    for name in ["base", *names]:
        lib = libs[(name, SRC)]
        lib.ptt_paged_decode.argtypes = [ptr] * 10 + [c_int] * 8 \
            + [ctypes.c_float, ptr]
        lib.ptt_paged_decode_int8.argtypes = [ptr] * 12 + [c_int] * 8 \
            + [ctypes.c_float, ptr]
        lib.ptt_paged_grid.argtypes = [c_int]
        out[name] = lib
    return out


def inputs(gen, quant, kvh=8, h=32, d=128, blocks=1025, page=16, pps=128):
    """q, the pool, table, lens and the scales (None on bf16 pages), as
    ``chip_smoke.py``'s ``paged_inputs`` draws them."""
    dev, B = "cuda", len(LENS)
    k, v = (torch.randn(kvh, blocks, page, d, generator=gen, device=dev)
            for _ in range(2))
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        ks, vs = ks.transpose(0, 1).contiguous(), vs.transpose(0, 1).contiguous()
    else:
        k, v = k.bfloat16(), v.bfloat16()
    q = torch.randn(B, h, d, generator=gen, device=dev).bfloat16()
    perm = torch.randperm(blocks - 1, generator=gen, device=dev) + 1
    table = torch.zeros(B, pps, dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(LENS):
        used = -(-n // page)
        table[i, :used] = perm[at:at + used].int()
        at += used
    lens = torch.tensor(LENS, dtype=torch.int32, device=dev)
    return q, k, v, table, lens, ks, vs


def runner(libs, ins):
    """``run(name)``: one call of build ``name`` on ``ins``, (out, m, l)."""
    q, k, v, table, lens, ks, vs = ins
    b, h, d = q.shape
    kvh, num_pages, page, _ = k.shape
    st = _build.stream(q)
    scratch = {}

    def run(name):
        lib = libs[name]
        if name not in scratch:
            grid = lib.ptt_paged_grid(q.get_device())
            scratch[name] = (grid, torch.empty(
                2 * grid * (h // kvh) * (d + 4) + 32 * grid,
                dtype=torch.float32,
                device=q.device), torch.zeros(b * kvh, dtype=torch.int32,
                                              device=q.device))
        grid, part, counters = scratch[name]
        part[2 * grid * (h // kvh) * (d + 4):].zero_()
        out = torch.empty_like(q)
        m, l = (torch.empty((b, h), dtype=torch.float32, device=q.device)
                for _ in range(2))
        rest = (table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                m.data_ptr(), l.data_ptr(), part.data_ptr(),
                counters.data_ptr(), grid, b, h, kvh, num_pages, page,
                table.shape[1], d, d ** -0.5, st)
        if ks is None:
            rc = lib.ptt_paged_decode(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), *rest)
        else:
            rc = lib.ptt_paged_decode_int8(q.data_ptr(), k.data_ptr(),
                                           v.data_ptr(), ks.data_ptr(),
                                           vs.data_ptr(), *rest)
        assert rc == 0, (name, rc)
        return out, m, l

    run.scratch = scratch
    return run


def print_timeline(name, run, q, k, cold):
    """The ``timeline`` variant's stamps of one call (``cold``: after the
    L2 was flushed): µs from the earliest CTA start, and per CTA with work
    the µs of each phase, min / median / max over the CTAs: the sum, the
    lookups with the first unit's wait, its first four units (each from the
    previous stamp: its wait and products), the end of a segment's part where one ended (the write,
    fence, count and any merge of the CTAs' parts) and the end."""
    import statistics

    if cold:
        _variants.cold_ms(lambda: run(name), reps=1)
    else:
        _variants.warm_ms(lambda: run(name), reps=1)
    torch.cuda.synchronize()
    b, h, d = q.shape
    grid, part, _ = run.scratch[name]
    base = 2 * grid * (h // k.shape[0]) * (d + 4)
    st = part[base:base + 32 * grid].view(torch.int32).view(grid, 32)
    rows = [[x & 0xFFFFFFFF for x in r] for r in st.cpu().long().tolist()
            if r[31] != 0]
    t0 = min(r[0] for r in rows)

    def us(v):
        v = [x / 1e3 for x in v]
        return (f"{min(v):.2f} / {statistics.median(v):.2f} / "
                f"{max(v):.2f}") if v else "-"

    cols = [("start", [(r[0] - t0) % 2**32 for r in rows]),
            ("sum", [(r[1] - r[0]) % 2**32 for r in rows]),
            ("lookups and first unit", [(r[2] - r[1]) % 2**32 for r in rows])]
    units, ends = [[] for _ in range(4)], []
    for r in rows:
        prev, k = r[2], 0
        for i in range(12):
            if r[3 + i] == 0:
                continue
            if k < len(units):
                units[k].append((r[3 + i] - prev) % 2**32)
            k += 1
            prev = r[3 + i]
            if r[16 + i]:
                ends.append((r[16 + i] - r[3 + i]) % 2**32)
                prev = r[16 + i]
    cols += [(f"unit {k}", v) for k, v in enumerate(units)]
    cols += [("ends of segments", ends),
             ("total", [(r[31] - t0) % 2**32 for r in rows])]
    print(f"  {name} {'cold' if cold else 'warm'}, {len(rows)} CTAs with "
          f"work, µs min / median / max: "
          + "; ".join(f"{nm} {us(v)}" for nm, v in cols))


def main(argv):
    argv = _variants.names_of(argv, VARIANTS)
    libs = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiny = torch.empty(8 * 32 * 128, dtype=torch.bfloat16, device="cuda")
    print(f"one launch that writes 64 KB (the timer's floor), ms cold / warm: "
          f"{_variants.cold_ms(tiny.zero_):.4f} / "
          f"{_variants.warm_ms(tiny.zero_):.4f}")
    for quant in (False, True):
        ins = inputs(gen, quant)
        q, k, v, table, lens, ks, vs = ins
        ref = paged_attention_reference(q, k, v, table, lens,
                                        return_stats=True, k_scales=ks,
                                        v_scales=vs)
        run = runner(libs, ins)
        what = f"paged decode, {'int8' if quant else 'bf16'} pages"
        times, kernels = [], {}
        for name in ["base", *argv, "base"]:
            got, again = run(name), run(name)
            torch.cuda.synchronize()
            if set(name.split("+")) & DIAGNOSTIC:
                got = again = ref
            err = (got[0].float() - ref[0].float()).abs().max().item()
            stats = max(((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
                        for a, r in zip(got[1:], ref[1:]))
            assert err <= 2e-2 and stats <= 1e-3, (what, name, err, stats)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                (what, name, "not bitwise equal")
            times.append(f"{name} {_variants.cold_ms(lambda: run(name)):.4f}"
                         f" / {_variants.warm_ms(lambda: run(name)):.4f}")
            kernels[name] = _variants.kernel_ms(lambda: run(name),
                                                r"paged_\w*kernel")
        print(f"{what} (ms, cold / warm; out, m, l within their gates, "
              f"bitwise repeats): {', '.join(times)}", flush=True)
        for name in argv:
            if "timeline" in name.split("+"):
                print_timeline(name, run, q, k, cold=True)
                print_timeline(name, run, q, k, cold=False)
        for name, per in kernels.items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                            per.items()))
    print(_variants.card())


if __name__ == "__main__":
    main(sys.argv[1:])
