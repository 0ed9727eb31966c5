"""Time the weight-only GEMM wrappers of checkouts of this repo against each
other at the serving path's shapes, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.weight_only_compare ROOT [ROOT ...]

A ROOT is a directory that holds a checkout's ``paddle_tpu_torch/`` (this
one: ``.``; an earlier commit: ``git archive COMMIT | tar -x -C
build/NAME``). Each ROOT runs in a process of its own, in the order given
(name a root twice to bracket the others: A B B A), which imports that
checkout's ``paddle_tpu_torch.ops.cuda.int8_matmul`` (built into the
checkout's own ``build/``) and times its ``int8_weight_matmul`` and
``int4_weight_matmul`` at Llama-3-8B's four products (``chip_smoke.py``
phase 3) for m = 8, 32, 64 and 256 on operands made from one seed, each
output held against the plain version (1e-2 of max |plain|): the mean
device ms of 20 launches, each alone after the 50 MB L2 was flushed (CUDA
events, the timer of ``chip_smoke.py``); and the host ms to enqueue one
decode step's 128 wrapper calls (the four m = 8 products x 32 layers, at
best of 7, as ``chip_smoke.py`` phase 3) beside 128 bf16 ``torch.matmul``
calls at the same shapes in the same process. Prints every run's ms per
shape, then per shape and per layer (the four products) each root's best,
its ratio to the first root's, every run's host ms, and the card's name
and power limit. Exits 1 if an output disagrees.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SHAPES = (("qkv", 4096, 6144), ("out", 4096, 4096), ("ffn1", 4096, 28672),
          ("ffn2", 14336, 4096))
ROWS = (8, 32, 64, 256)
RTOL = 1e-2


def _time_ms(torch, fn, flush, reps=20):
    """Mean device ms of ``fn``, each launch alone after ``flush`` evicted
    the L2, a device-side sleep keeping the card busy while the host
    queues it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _host_ms(torch, calls, layers=32, reps=7):
    """Best host ms to enqueue ``layers`` rounds of ``calls`` (the device
    drained before each round), after two warm-up rounds."""
    best = float("inf")
    for rep in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(layers):
            for c in calls:
                c()
        t = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if rep >= 2:
            best = min(best, t)
    return best


def worker(root):
    """Times the checkout at ``root``; prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from paddle_tpu_torch.ops.cuda import int8_matmul as wo

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ms, bad, host = {}, [], {}
    for int4 in (False, True):
        kind = "int4" if int4 else "int8"
        fn = wo.int4_weight_matmul if int4 else wo.int8_weight_matmul
        plain_fn = wo.int4_weight_matmul_reference if int4 \
            else wo.int8_weight_matmul_reference
        decode = []
        for m in ROWS:
            for name, K, N in SHAPES:
                w = torch.randint(-128, 128, (K // 2 if int4 else K, N),
                                  dtype=torch.int8, device="cuda",
                                  generator=gen)
                if not int4:
                    w.clamp_(-127, 127)
                scale = torch.rand(N, generator=gen, device="cuda") * 2e-3 \
                    + 1e-4
                x = torch.randn(m, K, generator=gen, device="cuda").bfloat16()
                out, ref = fn(x, w, scale), plain_fn(x, w, scale)
                err = (out.float() - ref.float()).abs().max().item()
                label = f"{kind} m={m} {name}"
                if not err <= RTOL * ref.float().abs().max().item():
                    bad.append(f"{label}: max |kernel - plain| {err:.3e}")
                ms[label] = _time_ms(torch, lambda: fn(x, w, scale), flush)
                if m == 8:
                    wb = (wo.unpack_int4_packed(w) if int4 else w).bfloat16()
                    decode.append((x, w, scale, wb))
                del w, x, scale, out, ref
        host[kind] = _host_ms(torch, [lambda a=a: fn(*a[:3]) for a in decode])
        host[kind + " bf16"] = _host_ms(
            torch, [lambda a=a: torch.matmul(a[0], a[3]) for a in decode])
        del decode
    print(json.dumps({"root": root, "ms": ms, "bad": bad, "host": host}))


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
    print("== device ms of each run, in order: " + " / ".join(roots))
    labels = list(runs[0]["ms"])
    for label in labels:
        print(f"  {label}: " + " / ".join(f"{r['ms'][label]:.4f}"
                                          for r in runs))
    best = {d: {lab: min(r["ms"][lab] for r in runs if r["root"] == d)
                for lab in labels} for d in distinct}
    print("== best of each root (ratio to " + distinct[0] + "; > 1: slower)")
    for label in labels:
        print(f"  {label}: " + " / ".join(
            f"{d} {best[d][label]:.4f} ({best[d][label] / best[distinct[0]][label]:.3f})"
            for d in distinct))
    print("== layers (the four products, best of each)")
    for key in sorted({lab.rsplit(" ", 1)[0] for lab in labels},
                      key=lambda k: (k[:4], int(k.split("=")[1]))):
        sums = {d: sum(best[d][lab] for lab in labels
                       if lab.rsplit(" ", 1)[0] == key) for d in distinct}
        print(f"  {key} layer: " + " / ".join(
            f"{d} {sums[d]:.4f} ({sums[d] / sums[distinct[0]]:.3f})"
            for d in distinct))
    print("== host ms to enqueue 128 m = 8 calls at best, each run in order "
          "(the wrapper; bf16 torch.matmul at the same shapes)")
    for kind in ("int8", "int4"):
        print(f"  {kind}: " + " / ".join(
            f"{r['root']} {r['host'][kind]:.3f} ({r['host'][kind + ' bf16']:.3f})"
            for r in runs))
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
