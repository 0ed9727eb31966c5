"""Run the chunk-parallel SSM kernels' CUDA sources on the CPU and hold them
to their plain versions, before their first call on a card:

    python3 -m paddle_tpu_torch.tools.cpu_rehearsal [wkv] [ssd] [selective_scan]

Each named source of ``paddle_tpu_torch/csrc/`` is turned into C++ by
:func:`prep` (the dynamic shared-memory declaration dropped for the
stand-in's one global buffer, static shared arrays made function statics,
each ``kern<<<grid, block, smem, stream>>>(args)`` a synchronous
``stub_launch``) and built with ``g++ -std=c++20`` into
``build/cpu_rehearsal/`` against the stand-in headers of ``tools/cpu_stub/``
(one std::thread per CUDA thread, a block at a time; ldmatrix, mma.sync and
the shuffles as warp collectives). The libraries take the place of the nvcc
builds in ``ops/cuda/_build`` with ``device_of`` answering "cuda", so the
wrappers launch the kernels on CPU tensors. Every case prints each output's
max |kernel - plain| / max |plain| against 1e-4 (f32 I/O) or 1e-2 (bf16),
the gates of ``chip_smoke.py``, and that every output is finite. Exits 1 if
a case fails.

The cases are the WKV backward (``wkv``), the SSD forward and backward
(``ssd``) and the selective scan's forward and backward
(``selective_scan``) at their edges, cut to sizes the CPU runs in
seconds: lengths around the sub-chunks and chunks, d = 64 and 128 (the
scan's d = 100 and 72, off its 64-channel blocks and, in bf16, off its
16-byte rows; n = 5 and 16), a strong decay, logw >= 0 (dlogw exactly
0). cp.async is a synchronous copy there. The inline PTX of the sources stays in
``flash_common.cuh`` and ``hopper.cuh``, which the stand-ins replace; what
the stand-ins do not model (timing, occupancy, the compiler's register
allocation) only a card shows.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.cuda import _build

STUB_DIR = Path(__file__).resolve().parent / "cpu_stub"
OUT_DIR = _build.BUILD_DIR.parent / "cpu_rehearsal"
F32_RTOL, BF16_RTOL = 1e-4, 1e-2


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
    # their own includes find the stand-ins, not the real headers
    for h in _build.SRC_DIR.glob("*.cuh"):
        if not (STUB_DIR / h.name).exists():
            (OUT_DIR / h.name).write_text(h.read_text())
    procs = {}
    for name in names:
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
    launch the kernels."""
    _build._LIBS.update(libs)
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
    """The WKV backward against the plain version's gradients."""
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
    got = wkv.wkv_bwd(*ins, dy)
    xs = [t.detach().float().requires_grad_() for t in ins]
    ref = torch.autograd.grad(wkv.wkv_reference(*xs), xs, dy.float())
    ref = [a.to(t.dtype) for a, t in zip(ref, ins)]
    what = (f"wkv backward b{b} l{l} h{h} d{d} {str(dt)[6:]}"
            + (" strong decay" if strong else "")
            + (" logw >= 0" if clamp else ""))
    ok = _report(what, got, ref, ("dr", "dk", "dv", "dlogw", "du"),
                 F32_RTOL if dt == torch.float32 else BF16_RTOL)
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


def scan_case(b, l, d, n, dt, strong=False, seed=0):
    """The selective scan's forward (y, the chunk states) and backward
    against the plain version, inputs as ``chip_smoke.py``'s
    ``scan_inputs`` draws them."""
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
    ins = (u.to(dt), delta.to(dt), A, B.to(dt), C.to(dt))
    y, bounds = ss.selective_scan_fwd(*ins)
    grads = ss.selective_scan_bwd(*ins, bounds, dy)
    xs = [t.detach().float().requires_grad_() for t in ins]
    y_ref, b_ref = ss.selective_scan_reference(*xs, ss.KERNEL_CHUNK, True)
    g_ref = torch.autograd.grad(y_ref, xs, dy.float())
    tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
    what = (f"selective scan b{b} l{l} d{d} n{n} {str(dt)[6:]}"
            + (" strong decay" if strong else ""))
    ok = _report(what + " forward", (y, bounds),
                 (y_ref.detach().to(dt), b_ref.detach()),
                 ("y", "chunk states"), tol)
    return _report(what + " backward", grads,
                   [a.to(t.dtype) for a, t in zip(g_ref, ins)],
                   ("du", "ddelta", "dA", "dB", "dC"), tol) and ok


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
        scan_case(1, 130, 100, 16, bf16)],
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
