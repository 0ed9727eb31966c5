"""Run the chunk-parallel SSM kernels', the paged decode kernel's and the
flash kernels' CUDA sources on the CPU and hold them to their plain
versions, before their first call on a card:

    python3 -m paddle_tpu_torch.tools.cpu_rehearsal [wkv] [ssd] [selective_scan] [paged_attention]
        [flash_attention_mma] [flash_attention]

Each named source of ``paddle_tpu_torch/csrc/`` is turned into C++ by
:func:`prep` (the dynamic shared-memory declaration dropped for the
stand-in's one global buffer, static shared arrays made function statics,
each ``kern<<<grid, block, smem, stream>>>(args)`` a synchronous
``stub_launch``) and built with ``g++ -std=c++20`` into
``build/cpu_rehearsal/`` against the stand-in headers of ``tools/cpu_stub/``
(one std::thread per CUDA thread, a block at a time; ldmatrix, mma.sync and
the shuffles as warp collectives; wgmma, read through its descriptors, as a
warpgroup collective; TMA loads and stores with zero fill and the 128-,
64- and 32-byte swizzles, mbarriers and named barriers as the card runs
them). ``flash_attention`` builds the d = 64 / 128 sources, which the card
has run, as a check of that model. The libraries take the place of the nvcc
builds in ``ops/cuda/_build`` with ``device_of`` answering "cuda", so the
wrappers launch the kernels on CPU tensors. Every case prints each output's
max |kernel - plain| / max |plain| against 1e-4 (f32 I/O) or 1e-2 (bf16),
the gates of ``chip_smoke.py`` (the scan's f32 cases against float64,
as there), and that every output is finite; the
paged decode's out within 2e-2 and m, l within 1e-3 of max(|plain|, 1),
the empty rows exact. Exits 1 if a case fails.

The cases are the WKV forward and backward (``wkv``), the SSD forward and
backward (``ssd``), the selective scan's forward and backward
(``selective_scan``, with its log-depth variant over spans of 8, 16,
32 and 64 steps) and the paged decode on bf16 and int8 pages
(``paged_attention``, also on the contiguous layout of
``fused_multi_transformer_paged``) at their edges, cut to sizes the CPU runs in
seconds: lengths around the sub-chunks and chunks, d = 64 and 128 (the
scan's d = 100 and 72, off its 64-channel blocks and, in bf16, off its
16-byte rows; n = 5 and 16; B . C cancelling at every step), a strong
decay, logw >= 0 (dlogw exactly
0); rows of 0 to 257 tokens around the kernel's 16-token halves on
shuffled blocks with null table tails, groups of 1, 2, 4 and 8 query
heads, pages of 16 and 32 tokens, 24 rows at once, shares of the stand-in
card's 8 CTAs longer than the addresses a CTA looks up at once, run twice
(bitwise equal). cp.async is a synchronous copy there, and atomics act on
the host's memory (blocks run one at a time). The inline PTX of the
sources stays in ``flash_common.cuh`` and ``hopper.cuh``, which the
stand-ins replace; what
the stand-ins do not model (timing, occupancy, the compiler's register
allocation) only a card shows.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.cuda import _build

STUB_DIR = Path(__file__).resolve().parent / "cpu_stub"
OUT_DIR = _build.BUILD_DIR.parent / "cpu_rehearsal"
F32_RTOL, BF16_RTOL = 1e-4, 1e-2
OUT_ATOL, STATS_RTOL = 2e-2, 1e-3


def _split_top(text):
    """``text`` split at the commas outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def prep(src: str) -> str:
    """A CUDA source as C++ for the stand-in headers."""
    src = re.sub(r"extern __shared__[^;]*smem_raw\[\];", "", src)
    src = re.sub(r"__shared__\s+__align__\((\d+)\)", r"alignas(\1) static",
                 src)

    def launch(m):
        grid, block = _split_top(m.group(2))[:2]
        return (f"stub_launch({grid}, {block}, [&] {{ {m.group(1)}"
                f"({m.group(3)}); }});")

    return re.sub(r"([A-Za-z_]\w*(?:<[^;<>]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  launch, src, flags=re.S)


def build(names):
    """``{name: ctypes.CDLL}``: each ``csrc/<name>.cu`` built with g++
    against the stand-ins, one process per source, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    # the shared headers that need no stand-in sit beside the C++, so that
    # their own includes find the stand-ins, not the real headers (each
    # replaced whole: rehearsals of other sources may run at once)
    for h in _build.SRC_DIR.glob("*.cuh"):
        if not (STUB_DIR / h.name).exists():
            tmp = OUT_DIR / f"{h.name}.{os.getpid()}.tmp"
            tmp.write_text(h.read_text())
            os.replace(tmp, OUT_DIR / h.name)
    procs = {}
    for name in [s for n in names for s in SOURCES.get(n, (n,))]:
        cpp = OUT_DIR / f"{name}.cpp"
        cpp.write_text(prep((_build.SRC_DIR / f"{name}.cu").read_text()))
        so = OUT_DIR / f"lib{name}.so"
        cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
               "-w", "-I", str(STUB_DIR), "-o", str(so), str(cpp)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: g++ failed\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def install(libs):
    """The stand-in libraries in place of the nvcc builds: CPU tensors then
    launch the kernels (the flash wrappers' CUDA-tensor check is lifted)."""
    from ..ops.cuda import flash_attention as fa

    _build._LIBS.update(libs)
    fa._check_tensors = lambda *args, **kw: None
    _build._ENTRIES.clear()
    _build.device_of = lambda what, *tensors: "cuda"
    _build.stream = lambda t: 0


def _report(what, outs, refs, names, tol):
    worst, ok = [], True
    for name, a, r in zip(names, outs, refs):
        a, r = a.double(), r.double()
        fin = bool(torch.isfinite(a).all())
        rel = ((a - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        ok = ok and fin and rel <= tol
        worst.append(f"{name} {rel:.1e}" + ("" if fin else " (not finite)"))
    print(f"  {'ok ' if ok else 'BAD'} {what}: {', '.join(worst)} (<= {tol})",
          flush=True)
    return ok


def wkv_case(b, l, h, d, dt, strong=False, clamp=False, seed=0):
    """The WKV forward's y and the backward against the plain version and
    its gradients."""
    from ..ops.cuda import wkv

    g = torch.Generator().manual_seed(seed)
    r, k, v = (0.5 * torch.randn(b, l, h, d, generator=g) for _ in range(3))
    logw = -5 * torch.rand(h, d, generator=g) - 0.02
    if strong:
        logw[0, :3] = -1e10
        logw[-1, -2:] = -1e10
    if clamp:
        logw[0, 3:6] = torch.tensor([0.0, 0.5, 2.0])
    u = 0.5 + 0.1 * torch.randn(h, d, generator=g)
    dy = torch.randn(b, l, h, d, generator=g).to(dt)
    ins = (r.to(dt), k.to(dt), v.to(dt), logw, u)
    y = wkv.wkv_fwd(*ins)
    got = wkv.wkv_bwd(*ins, dy)
    xs = [t.detach().float().requires_grad_() for t in ins]
    y_ref = wkv.wkv_reference(*xs)
    ref = torch.autograd.grad(y_ref, xs, dy.float())
    ref = [a.to(t.dtype) for a, t in zip(ref, ins)]
    what = (f"b{b} l{l} h{h} d{d} {str(dt)[6:]}"
            + (" strong decay" if strong else "")
            + (" logw >= 0" if clamp else ""))
    tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
    ok = _report("wkv forward " + what, (y,), (y_ref.detach().to(dt),),
                 ("y",), tol)
    what = "wkv backward " + what
    ok = _report(what, got, ref, ("dr", "dk", "dv", "dlogw", "du"),
                 tol) and ok
    if clamp and not bool((got[3][0, 3:6] == 0).all()):
        print(f"  BAD {what}: dlogw is not 0 where logw >= 0")
        ok = False
    return ok


def ssd_case(b, l, h, dh, ds, dt_io, strong=False, seed=0):
    """The SSD forward (y, the chunk states) and backward against the plain
    version, x, B and C strided views of one conv output as the model's."""
    import torch.nn.functional as F

    from ..ops.cuda import ssd

    g = torch.Generator().manual_seed(seed)
    xc = torch.randn(b, l, h * dh + 2 * ds, generator=g).to(dt_io)
    x = xc[..., :h * dh].unflatten(-1, (h, dh))
    B, C = xc[..., h * dh:h * dh + ds], xc[..., h * dh + ds:]
    dt = F.softplus(torch.randn(b, l, h, generator=g))
    A = -torch.linspace(1.0, 16.0, h)
    if strong:
        A[0] = -16.0
        dt[:, l // 4:l // 2] = 10.0
    D = torch.randn(h, generator=g)
    dy = torch.randn(b, l, h, dh, generator=g).to(dt_io)
    ins = (x, dt.to(dt_io), A.to(dt_io), B, C, D.to(dt_io))
    y, states = ssd.ssd_fwd(*ins)
    grads = ssd.ssd_bwd(*ins, states, dy)
    chunk = ssd.kernel_chunk(dh, ds)
    xs = [t.detach().float().requires_grad_() for t in ins]
    y_ref, s_ref = ssd.ssd_chunked_reference(*xs, chunk, True)
    g_ref = torch.autograd.grad(y_ref, xs, dy.float())
    tol = F32_RTOL if dt_io == torch.float32 else BF16_RTOL
    what = (f"ssd b{b} l{l} h{h} dh{dh} ds{ds} {str(dt_io)[6:]}"
            + (" strong decay" if strong else ""))
    ok = _report(what + " forward", (y, states),
                 (y_ref.detach().to(dt_io), s_ref.detach()), ("y", "states"),
                 tol)
    return _report(what + " backward", grads,
                   [a.to(t.dtype) for a, t in zip(g_ref, ins)],
                   ("dx", "ddt", "dA", "dB", "dC", "dD"), tol) and ok


def scan_case(b, l, d, n, dt, strong=False, seed=0, cancel=False):
    """The selective scan's forward (y, the chunk states) and backward
    against the plain version (evaluated in float64 for f32 I/O, as
    ``chip_smoke.py`` holds them), inputs as its ``scan_inputs`` draws
    them. ``cancel``: C's last state set so that every step's B . C
    cancels to about 1e-4 of its terms (``chip_smoke.cancel_bc``)."""
    import torch.nn.functional as F

    from ..ops.cuda import selective_scan as ss

    g = torch.Generator().manual_seed(seed)
    u = torch.randn(b, l, d, generator=g)
    delta = F.softplus(torch.randn(b, l, d, generator=g))
    A = -torch.arange(1, n + 1, dtype=torch.float32).expand(d, n).contiguous()
    if strong:
        A[:3] = -1e4
        delta[:, l // 3:l // 2 + 1] = 20.0
    B, C = torch.randn(b, l, n, generator=g), torch.randn(b, l, n, generator=g)
    dy = torch.randn(b, l, d, generator=g).to(dt)
    if cancel:
        C = _cancel_bc(B, C)
    ins = (u.to(dt), delta.to(dt), A, B.to(dt), C.to(dt))
    y, bounds = ss.selective_scan_fwd(*ins)
    grads = ss.selective_scan_bwd(*ins, bounds, dy)
    ref_dt = torch.float64 if dt == torch.float32 else torch.float32
    xs = [t.detach().to(ref_dt).requires_grad_() for t in ins]
    y_ref, b_ref = ss.selective_scan_reference(*xs, ss.KERNEL_CHUNK, True,
                                               ref_dt)
    g_ref = torch.autograd.grad(y_ref, xs, dy.to(ref_dt))
    tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
    what = (f"selective scan b{b} l{l} d{d} n{n} {str(dt)[6:]}"
            + (" strong decay" if strong else "")
            + (" B . C cancels" if cancel else ""))
    ok = _report(what + " forward", (y, bounds),
                 (y_ref.detach().to(dt), b_ref.detach()),
                 ("y", "chunk states"), tol)
    return _report(what + " backward", grads,
                   [a.to(t.dtype) for a, t in zip(g_ref, ins)],
                   ("du", "ddelta", "dA", "dB", "dC"), tol) and ok


def scan_logdepth_case(b, l, d, n, dt, span, strong=False, seed=0,
                       cancel=False):
    """The log-depth scan's forward (y, the span states) and backward
    kernels over spans of ``span`` steps against their plain versions
    (float64 for f32 I/O), inputs as :func:`scan_case` draws them."""
    import torch.nn.functional as F

    from ..ops.cuda import selective_scan as ss

    g = torch.Generator().manual_seed(seed)
    u = torch.randn(b, l, d, generator=g)
    delta = F.softplus(torch.randn(b, l, d, generator=g))
    A = -torch.arange(1, n + 1, dtype=torch.float32).expand(d, n).contiguous()
    if strong:
        A[:3] = -1e4
        delta[:, l // 3:l // 2 + 1] = 20.0
    B, C = torch.randn(b, l, n, generator=g), torch.randn(b, l, n, generator=g)
    dy = torch.randn(b, l, d, generator=g).to(dt)
    if cancel:
        C = _cancel_bc(B, C)
    ins = (u.to(dt), delta.to(dt), A, B.to(dt), C.to(dt))
    y, bounds = ss.selective_scan_logdepth_fwd(*ins, span)
    grads = ss.selective_scan_logdepth_bwd(*ins, bounds, dy, span)
    ref_dt = torch.float64 if dt == torch.float32 else torch.float32
    xs = [t.to(ref_dt) for t in ins]
    y_ref, b_ref = ss.selective_scan_logdepth_reference(*xs, span, ref_dt)
    g_ref = ss.selective_scan_logdepth_bwd_reference(
        *xs, b_ref, dy.to(ref_dt), span, ref_dt)
    tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
    what = (f"log-depth scan span {span} b{b} l{l} d{d} n{n} "
            f"{str(dt)[6:]}" + (" strong decay" if strong else "")
            + (" B . C cancels" if cancel else ""))
    ok = _report(what + " forward", (y, bounds),
                 (y_ref.to(dt), b_ref.float()), ("y", "span states"), tol)
    return _report(what + " backward", grads,
                   [a.to(t.dtype) for a, t in zip(g_ref, ins)],
                   ("du", "ddelta", "dA", "dB", "dC"), tol) and ok


def _cancel_bc(B, C):
    """C with its last state set so that each step's B . C is about 1e-4 of
    its terms (computed in float64)."""
    C = C.clone()
    part = (B[..., :-1].double() * C[..., :-1].double()).sum(-1)
    C[..., -1] = (-part / B[..., -1].double() * (1 - 1e-4)).to(C.dtype)
    return C


def paged_case(group, d, quant, lens=(0, 1, 15, 16, 17, 100, 257), kvh=2,
               page=16, seed=0, contiguous=False):
    """The paged decode on bf16 (or int8) pages against its plain version:
    rows of ``lens`` tokens on shuffled blocks, null table tails; or, with
    ``contiguous``, the contiguous layout of ``fused_multi_transformer_paged``
    (row b owns blocks ``[b * pps, (b + 1) * pps)``, row 0 block 0, every
    page a block of some row)."""
    from ..incubate.nn.functional.fused_transformer import (
        contiguous_page_table)
    from ..models.kv_cache import quantize_kv
    from ..ops.cuda import paged_attention as pa

    g = torch.Generator().manual_seed(seed)
    B = len(lens)
    used = [-(-n // page) for n in lens]
    if contiguous:
        pps = max(used) + 1
        blocks = B * pps
        table = contiguous_page_table(B, pps)
    else:
        pps, blocks = max(used) + 2, sum(used) + 3
        perm = torch.randperm(blocks - 1, generator=g) + 1
        table = torch.zeros(B, pps, dtype=torch.int32)
        at = 0
        for i, n in enumerate(used):
            table[i, :n] = perm[at:at + n].int()
            at += n
    k, v = (torch.randn(kvh, blocks, page, d, generator=g) for _ in range(2))
    kw = dict(return_stats=True)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw.update(k_scales=ks.transpose(0, 1).contiguous(),
                  v_scales=vs.transpose(0, 1).contiguous())
    else:
        k, v = k.bfloat16(), v.bfloat16()
    q = torch.randn(B, kvh * group, d, generator=g).bfloat16()
    seq = torch.tensor(lens, dtype=torch.int32)
    args = (q, k, v, table, seq)
    out, m, l = pa.paged_attention(*args, **kw)
    again = pa.paged_attention(*args, **kw)
    rout, rm, rl = pa.paged_attention_reference(*args, **kw)
    err = (out.float() - rout.float()).abs().max().item()
    stats = [((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
             for a, r in ((m, rm), (l, rl))]
    empty = torch.tensor(lens) == 0
    ok = (err <= OUT_ATOL and max(stats) <= STATS_RTOL
          and bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
                   and (out[empty] == 0).all())
          and all(torch.equal(a, r) for a, r in zip(again, (out, m, l))))
    what = (f"paged {'int8' if quant else 'bf16'} pages B{B} group {group} "
            f"d{d} page {page}" + (" contiguous" if contiguous else ""))
    print(f"  {'ok ' if ok else 'BAD'} {what}: out {err:.1e} (<= {OUT_ATOL})"
          f", m {stats[0]:.1e}, l {stats[1]:.1e} (<= {STATS_RTOL}), empty "
          f"rows exact, run twice bitwise", flush=True)
    return ok


def flash_case(b, sq, sk, hq, hk, d, causal=False, q_offset=None,
               kv_len=None, mask=None, seed=0):
    """The flash forward (out, lse) and backward (dq, dk, dv) against the
    plain versions, the backward run twice (bitwise equal).
    ``mask``: None, "additive", "bool" or "segments"."""
    from ..ops.cuda import flash_attention as fa
    from ..ops.fused.flash_attention import (flash_attn_bwd_reference,
                                             flash_attn_reference)

    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, sq, hq, d, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, sk, hk, d, generator=g).bfloat16()
            for _ in range(2))
    scale = d ** -0.5
    kv_len = sk if kv_len is None else kv_len
    q_offset = kv_len - sq if q_offset is None else q_offset
    kw = {}
    if mask == "additive":
        m = torch.randn(b, 1, sq, sk, generator=g)
        m[:, :, :, : sk // 3] = float("-inf")
        kw["attn_mask"] = m
    elif mask == "bool":
        kw["attn_mask"] = torch.rand(b, sq, sk, generator=g) > 0.3
    elif mask == "segments":
        kw["q_segment_ids"] = (torch.arange(sq) * 3 // sq).repeat(b, 1)
        kw["kv_segment_ids"] = (torch.arange(sk) * 3 // sk).repeat(b, 1)
    args = (causal, scale, q_offset, kv_len)
    out, lse = fa.flash_attention_cuda(q, k, v, *args, return_lse=True,
                                       **kw)
    rout, rlse = flash_attn_reference(q, k, v, causal, scale, kv_len,
                                      q_offset, True, kw.get("attn_mask"),
                                      kw.get("q_segment_ids"),
                                      kw.get("kv_segment_ids"))
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, *args, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, *args, **kw)
    refs = flash_attn_bwd_reference(q, k, v, out, lse, do, causal, scale,
                                    kv_len, q_offset, kw.get("attn_mask"),
                                    kw.get("q_segment_ids"),
                                    kw.get("kv_segment_ids"))
    err = (out.float() - rout.float()).abs().max().item()
    stat = ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max().item()
    what = (f"flash d{d} b{b} sq{sq} sk{sk} heads {hq}/{hk}"
            + (" causal" if causal else "") + f" q_offset {q_offset}"
            + f" kv_len {kv_len}" + (f" {mask}" if mask else ""))
    ok = err <= OUT_ATOL and stat <= STATS_RTOL
    print(f"  {'ok ' if ok else 'BAD'} {what} forward: out {err:.1e} (<= "
          f"{OUT_ATOL}), lse {stat:.1e} (<= {STATS_RTOL})", flush=True)
    if kv_len == 1:
        # one column: P = 1 and dS = P (dP - delta) = 0 exactly, so dq and
        # dk are rounding noise on both sides; held against max |dv|
        scale_of = refs[2].float().abs().max()
        tol = 2 * BF16_RTOL * scale_of
        bad = [n for n, a, r in zip(("dq", "dk"), grads, refs)
               if (a.float() - r.float()).abs().max() > tol]
        print(f"  {'BAD' if bad else 'ok '} {what} backward: dq, dk within "
              f"{2 * BF16_RTOL} of max |dv| (dS = 0 exactly)", flush=True)
        ok = not bad and _report(what + " backward", grads[2:], refs[2:],
                                 ("dv",), BF16_RTOL * 2) and ok
    else:
        ok = _report(what + " backward", grads, refs, ("dq", "dk", "dv"),
                     BF16_RTOL * 2) and ok
    if not all(torch.equal(a, r) for a, r in zip(again, grads)):
        print(f"  BAD {what}: a second backward differs")
        ok = False
    return ok


#: the sources a name of ``CASES`` builds, where they are not the name's own
SOURCES = {"flash_attention": ("flash_attention", "flash_attention_bwd")}

CASES = {
    "wkv": lambda f32, bf16: [
        wkv_case(1, 1, 1, 64, f32), wkv_case(1, 17, 1, 64, bf16, clamp=True),
        wkv_case(2, 65, 3, 64, f32, strong=True, clamp=True),
        wkv_case(1, 150, 1, 64, bf16, strong=True),
        wkv_case(1, 33, 2, 128, f32, clamp=True),
        wkv_case(1, 70, 1, 128, bf16, strong=True)],
    "ssd": lambda f32, bf16: [
        ssd_case(2, 1, 3, 64, 64, f32), ssd_case(2, 65, 4, 64, 64, f32),
        ssd_case(1, 130, 13, 64, 64, bf16, strong=True),
        ssd_case(2, 150, 3, 64, 128, f32),
        ssd_case(1, 77, 2, 128, 128, bf16, strong=True)],
    "selective_scan": lambda f32, bf16: [
        scan_case(1, 1, 100, 5, f32), scan_case(2, 63, 72, 16, bf16),
        scan_case(1, 64, 100, 16, f32), scan_case(2, 65, 100, 5, bf16,
                                                  strong=True),
        scan_case(1, 150, 72, 5, f32, strong=True),
        scan_case(1, 130, 100, 16, bf16), scan_case(1, 1, 100, 5, f32,
                                                    cancel=True),
        scan_case(2, 70, 100, 16, f32, cancel=True),
        # the log-depth kernels: spans 8, 16, 32 and 64, one step, lengths
        # off the span, a strong decay, B . C cancelling
        scan_logdepth_case(1, 1, 100, 5, f32, 8),
        scan_logdepth_case(2, 65, 72, 16, bf16, 16),
        scan_logdepth_case(1, 150, 100, 5, f32, 64, strong=True),
        scan_logdepth_case(2, 65, 100, 16, f32, 64),
        scan_logdepth_case(1, 150, 72, 16, bf16, 64, strong=True),
        scan_logdepth_case(1, 70, 100, 5, f32, 32),
        scan_logdepth_case(1, 65, 100, 16, f32, 8, cancel=True)],
    "flash_attention_mma": lambda f32, bf16: [
        flash_case(1, 70, 77, 2, 1, 16),
        flash_case(2, 100, 100, 4, 2, 32, causal=True),
        flash_case(1, 65, 1, 2, 2, 80),
        flash_case(1, 1, 77, 2, 2, 32),
        flash_case(1, 80, 64, 2, 2, 80, causal=True, q_offset=-16),
        flash_case(1, 70, 130, 2, 1, 48, causal=True, q_offset=37,
                   kv_len=100),
        flash_case(1, 64, 77, 2, 2, 96),
        flash_case(1, 40, 70, 1, 1, 112, causal=True),
        flash_case(1, 70, 77, 2, 1, 32, mask="additive"),
        flash_case(1, 66, 66, 2, 2, 16, causal=True, mask="bool"),
        flash_case(2, 70, 70, 2, 1, 80, mask="segments"),
        flash_case(2, 150, 140, 4, 2, 112, causal=True, kv_len=130)],
    # the d = 64 / 128 kernels, which the card has run: a check of the
    # stand-ins' TMA, mbarrier and wgmma model
    "flash_attention": lambda f32, bf16: [
        flash_case(1, 70, 77, 2, 1, 64), flash_case(1, 130, 130, 2, 2, 128,
                                                     causal=True),
        flash_case(1, 65, 70, 2, 1, 64, mask="segments")],
    "paged_attention": lambda f32, bf16: [
        paged_case(g, d, quant) for quant in (False, True)
        for g, d in ((1, 64), (4, 128), (8, 64), (8, 128))] + [
        paged_case(2, 128, False, page=32),
        paged_case(4, 64, True, page=32, seed=1),
        paged_case(4, 128, True, lens=tuple(range(0, 480, 20)), seed=2),
        paged_case(1, 64, False, lens=(8400, 8222, 8400, 8194), seed=3),
        paged_case(4, 128, False, lens=(100,) * 4, seed=4, contiguous=True),
        paged_case(1, 64, False, lens=(33,) * 8, seed=5, contiguous=True),
        paged_case(4, 128, True, lens=(17,) * 3, seed=6, contiguous=True)],
}


def main(argv):
    names = list(argv) or list(CASES)
    unknown = [n for n in names if n not in CASES]
    if unknown:
        raise SystemExit(f"usage: [{' '.join(CASES)}] (unknown: {unknown})")
    torch.set_num_threads(2)
    install(build(names))
    results = []
    for name in names:
        results += CASES[name](torch.float32, torch.bfloat16)
    bad = results.count(False)
    print(f"{len(results) - bad} cases agree, {bad} disagree")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
