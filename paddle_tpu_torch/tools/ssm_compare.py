"""Time the SSM wrappers and the fused swiglu of checkouts of this repo
against each other at the training paths' shapes, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.ssm_compare ROOT [ROOT ...]

A ROOT is a directory that holds a checkout's ``paddle_tpu_torch/`` (this
one: ``.``; an earlier commit: ``git archive COMMIT | tar -x -C
build/NAME``). Each ROOT runs in a process of its own, in the order given
(name a root twice to bracket the others: A B B A), which imports that
checkout's ``ops.cuda`` wrappers (built into the checkout's own
``build/``) and times ``wkv_bwd`` at phase 10's b16 l1024 h12 d64,
``ssd_fwd`` at phase 11's b8 l1024 h24 dh64 ds64 (x, B and C strided as
the model's), ``selective_scan_fwd`` at phase 9's b16 l1024 d1536 n16 and
``gmm_swiglu`` at phase 8's MoE layer (M = 32768 rows, 472 of them trash,
K 1024, N 2816, 8 experts, b1, with residuals), bf16, on inputs made from
one seed, each output held against the plain version (1e-2 of max
|plain|): the mean device ms
of 20 calls, each alone after the 50 MB L2 was flushed (``cold_ms`` of
``tools/_variants.py``, the timer of ``chip_smoke.py``), and the wrapper's
host µs a call (median of 5 rounds of 32 calls, as ``chip_smoke.py``'s
``host_us_per_call``). Prints
every run's numbers, each root's best and its ratio to the first root's,
and the card's name and power limit. Exits 1 if an output disagrees.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

RTOL = 1e-2


def _host_us(torch, fn, calls=32, reps=5):
    """Median host µs to enqueue one call of ``fn`` (rounds of ``calls``
    back to back, the device drained before each)."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return statistics.median(out)


def _inputs(torch):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, bf = "cuda", torch.bfloat16
    b, l, h, d = 16, 1024, 12, 64
    r, k, v = (0.5 * torch.randn(b, l, h, d, generator=gen, device=dev)
               .to(bf) for _ in range(3))
    logw = -5 * torch.rand(h, d, generator=gen, device=dev) - 0.02
    u = 0.5 + 0.1 * torch.randn(h, d, generator=gen, device=dev)
    dy = torch.randn(b, l, h, d, generator=gen, device=dev).to(bf)
    wkv = ((r, k, v, logw, u), dy)
    b, l, h, p, n = 8, 1024, 24, 64, 64
    xc = torch.randn(b, l, h * p + 2 * n, generator=gen, device=dev).to(bf)
    x = xc[..., :h * p].unflatten(-1, (h, p))
    B, C = xc[..., h * p:h * p + n], xc[..., h * p + n:]
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device=dev)).to(bf)
    A = -torch.linspace(1.0, 16.0, h, device=dev).to(bf)
    D = torch.randn(h, generator=gen, device=dev).to(bf)
    b, l, d, n = 16, 1024, 1536, 16
    scan = (torch.randn(b, l, d, generator=gen, device=dev).to(bf),
            F.softplus(torch.randn(b, l, d, generator=gen, device=dev)).to(bf),
            -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(d, n).contiguous(),
            torch.randn(b, l, n, generator=gen, device=dev).to(bf),
            torch.randn(b, l, n, generator=gen, device=dev).to(bf))
    m, k, h2, e = 32768, 1024, 2 * 2816, 8
    swiglu = (torch.randn(m, k, generator=gen, device=dev).to(bf),
              (torch.randn(e, k, h2, generator=gen, device=dev)
               * k ** -0.5).to(bf),
              torch.tensor([4100, 4000, 4200, 3900, 4096, 4050, 4150, 3800],
                           dtype=torch.int32, device=dev),
              (0.1 * torch.randn(e, h2, generator=gen, device=dev)).to(bf))
    return wkv, (x, dt, A, B, C, D), scan, swiglu


def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def worker(root):
    """Times the checkout at ``root``; prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from paddle_tpu_torch.ops.cuda import grouped_gemm as gg
    from paddle_tpu_torch.ops.cuda import selective_scan as ss
    from paddle_tpu_torch.ops.cuda import ssd, wkv
    from paddle_tpu_torch.tools._variants import cold_ms

    (wins, dy), sins, scins, swins = _inputs(torch)
    bad, ms, host = [], {}, {}
    grads = wkv.wkv_bwd(*wins, dy)
    xs = [t.detach().float().requires_grad_() for t in wins]
    refs = torch.autograd.grad(wkv.wkv_reference(*xs), xs, dy.float())
    for name, g, ref in zip(("dr", "dk", "dv", "dlogw", "du"), grads, refs):
        err = _rel(g, ref.to(g.dtype))
        if not err <= RTOL:
            bad.append(f"wkv_bwd {name}: {err:.3e} of max |plain|")
    del grads, xs, refs
    y, states = ssd.ssd_fwd(*sins)
    with torch.no_grad():
        y_ref, s_ref = ssd.ssd_chunked_reference(
            *(t.float() for t in sins), ssd.kernel_chunk(64, 64), True)
    for name, a, ref in (("y", y, y_ref.to(y.dtype)), ("states", states,
                                                        s_ref)):
        err = _rel(a, ref)
        if not err <= RTOL:
            bad.append(f"ssd_fwd {name}: {err:.3e} of max |plain|")
    del y, states, y_ref, s_ref
    y, bounds = ss.selective_scan_fwd(*scins)
    with torch.no_grad():
        y_ref, b_ref = ss.selective_scan_reference(
            *(t.float() for t in scins), ss.KERNEL_CHUNK, True)
    for name, a, ref in (("y", y, y_ref.to(y.dtype)), ("bounds", bounds,
                                                        b_ref)):
        err = _rel(a, ref)
        if not err <= RTOL:
            bad.append(f"selective_scan_fwd {name}: {err:.3e} of max |plain|")
    del y, bounds, y_ref, b_ref
    for name, a, ref in zip("ygu", gg.gmm_swiglu(*swins),
                            gg.gmm_swiglu_reference(*swins)):
        err = _rel(a, ref)
        if not err <= RTOL:
            bad.append(f"gmm_swiglu {name}: {err:.3e} of max |plain|")
    torch.cuda.empty_cache()
    for key, fn in (("wkv_bwd", lambda: wkv.wkv_bwd(*wins, dy)),
                    ("ssd_fwd", lambda: ssd.ssd_fwd(*sins)),
                    ("scan_fwd", lambda: ss.selective_scan_fwd(*scins)),
                    ("gmm_swiglu", lambda: gg.gmm_swiglu(*swins))):
        ms[key] = cold_ms(fn, reps=20)
        host[key] = _host_us(torch, fn)
    print(json.dumps({"root": root, "ms": ms, "host": host, "bad": bad}))


def main(roots):
    if not roots:
        raise SystemExit(__doc__)
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    distinct = list(dict.fromkeys(roots))
    print("== each run, in order: " + " / ".join(roots))
    for key in runs[0]["ms"]:
        print(f"  {key}: device ms " + " / ".join(
            f"{r['ms'][key]:.4f}" for r in runs) + "; host us a call "
            + " / ".join(f"{r['host'][key]:.1f}" for r in runs))
    print("== best of each root (ratio to " + distinct[0] + "; > 1: slower)")
    for key in runs[0]["ms"]:
        best = {d: min(r["ms"][key] for r in runs if r["root"] == d)
                for d in distinct}
        print(f"  {key}: " + " / ".join(
            f"{d} {best[d]:.4f} ({best[d] / best[distinct[0]]:.3f})"
            for d in distinct))
    bad = [f"{r['root']}: {b}" for r in runs for b in r["bad"]]
    for b in bad:
        print(f"  FAIL {b}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"== {len(bad)} failures; card: {card.stdout.strip()}")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
