"""Time the flash attention wrappers of checkouts of this repo against each
other at the training and serving paths' shapes, on one CUDA card:

    python3 -m paddle_tpu_torch.tools.flash_compare ROOT [ROOT ...]

A ROOT is a directory that holds a checkout's ``paddle_tpu_torch/`` (this
one: ``.``; an earlier commit: ``git archive COMMIT | tar -x -C
build/NAME``). Each ROOT runs in a process of its own, in the order given
(name a root twice to bracket the others: A B B A), which imports that
checkout's ``ops.cuda.flash_attention`` (built into the checkout's own
``build/``) and times, bf16, on inputs made from one seed: causal, the
forward with lse and the backward at the training shape (b2 S2048 32/32
d128), the serving forward without lse (b1 S2048 32/8 d128), and the
forward with lse and the backward at d64 (b2 S2048 64/64); where the
checkout's wrappers take head dims off 64 and 128, non-causal, the forward
with lse and the backward at the UNet's level 1 (b32 S256 12/12 d32, and
its cross-attention over 77 columns), ViT-H14 (b32 S257 16/16 d80), a d16
case (b16 S1024 8/8) and a causal d112 case (b4 S1024 16/16); and, where
the checkout's wrappers take masks, the training-shape forward and
backward with an additive f32 mask ``[b, 1, S, S]``, a bool mask ``[b, S,
S]`` and packed segment ids (``chip_smoke.py``'s ``flash_mask_case``).
Each output is held against the plain version (2e-2 absolute forward,
2e-2 of max |plain| backward); the numbers are the mean device ms of 20
calls, each alone after the 50 MB L2 was flushed (``cold_ms`` of
``tools/_variants.py``, the timer of ``chip_smoke.py``), and the host µs a
call of the unmasked training forward (median of 5 rounds of 32 calls).
Prints every run's numbers, each root's best and its ratio to the first
root's, and the card's name and power limit. Exits 1 if an output
disagrees.
"""

from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import sys
import time

# (name, b, sq, sk, hq, hk, d, causal, lse, backward)
SHAPES = (("train fwd+lse", 2, 2048, 2048, 32, 32, 128, True, True, False),
          ("train bwd", 2, 2048, 2048, 32, 32, 128, True, True, True),
          ("serving fwd", 1, 2048, 2048, 32, 8, 128, True, False, False),
          ("d64 fwd+lse", 2, 2048, 2048, 64, 64, 64, True, True, False),
          ("d64 bwd", 2, 2048, 2048, 64, 64, 64, True, True, True))
# the head-dim kernels' shapes (non-causal but the d112 case)
HEAD_DIM_SHAPES = tuple(
    (f"{name} {kind}", b, sq, sk, hq, hk, d, causal, True, kind == "bwd")
    for name, b, sq, sk, hq, hk, d, causal in (
        ("UNet l1 d32", 32, 256, 256, 12, 12, 32, False),
        ("UNet l1 cross d32", 32, 256, 77, 12, 12, 32, False),
        ("ViT-H14 d80", 32, 257, 257, 16, 16, 80, False),
        ("d16 b16 S1024", 16, 1024, 1024, 8, 8, 16, False),
        ("d112 b4 S1024 causal", 4, 1024, 1024, 16, 16, 112, True))
    for kind in ("fwd+lse", "bwd"))
MASKS = ("additive", "bool", "segments")


def _host_us(torch, fn, calls=32, reps=5):
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


def _mask(torch, gen, kind, b, s):
    """The keyword arguments of a masked case, as ``chip_smoke.py`` makes
    them (finite biases and -inf blocks; a bool mask; 3-6 segments)."""
    if kind == "additive":
        mask = torch.randn(b, 1, s, s, generator=gen, device="cuda") * 2
        mask[..., 256:512, 128:384] = float("-inf")
        return dict(attn_mask=mask)
    if kind == "bool":
        return dict(attn_mask=torch.rand(b, s, s, generator=gen,
                                         device="cuda") > 0.3)
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    for i in range(b):
        cuts = torch.randperm(s - 1, generator=gen, device="cuda")[:3] + 1
        seg[i] = torch.searchsorted(cuts.sort().values,
                                    torch.arange(s, device="cuda"),
                                    right=True).int()
    return dict(q_segment_ids=seg, kv_segment_ids=seg)


def worker(root):
    """Times the checkout at ``root``; prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.fused import flash_attention as ff
    from paddle_tpu_torch.tools._variants import cold_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    masked = "attn_mask" in inspect.signature(fa.flash_attention_cuda).parameters
    cases = [(name, dims, {}) for name, *dims in SHAPES]
    if 80 in getattr(fa, "HEAD_DIMS", ()):
        cases += [(name, dims, {}) for name, *dims in HEAD_DIM_SHAPES]
    if masked:
        cases += [(f"{kind} {name}", dims, _mask(torch, gen, kind, 2, 2048))
                  for kind in MASKS for name, *dims in SHAPES[:2]]
    bad, ms, host = [], {}, None
    for name, (b, sq, s, hq, hk, d, causal, lse, bwd), kw in cases:
        q, do = (torch.randn(b, sq, hq, d, generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, s, hk, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        sc, off = d ** -0.5, s - sq
        out, lse_t = fa.flash_attention_cuda(q, k, v, causal, sc, off, s,
                                             True, **kw)
        if bwd:
            fn = lambda: fa.flash_attention_bwd_cuda(  # noqa: E731
                q, k, v, out, lse_t, do, causal, sc, off, s, **kw)
            refs = ff.flash_attn_bwd_reference(q, k, v, out, lse_t, do,
                                               causal, sc, s, off, **kw)
            for g, r in zip(fn(), refs):
                err = ((g.float() - r.float()).abs().max()
                       / r.float().abs().max()).item()
                if not err <= 2e-2:
                    bad.append(f"{name}: {err:.3e} of max |plain|")
        else:
            fn = lambda: fa.flash_attention_cuda(  # noqa: E731
                q, k, v, causal, sc, off, s, lse, **kw)
            ref = ff.flash_attn_reference(q, k, v, causal, sc, s, off, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= 2e-2:
                bad.append(f"{name}: max |kernel - plain| {err:.3e}")
        torch.cuda.empty_cache()
        ms[name] = cold_ms(fn, reps=20)
        if name == "train fwd+lse":
            host = _host_us(torch, fn)
        del q, k, v, do, out, lse_t
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
    keys = list(dict.fromkeys(k for r in runs for k in r["ms"]))
    print("== each run, in order: " + " / ".join(roots))
    for key in keys:
        print(f"  {key}: device ms " + " / ".join(
            f"{r['ms'][key]:.4f}" if key in r["ms"] else "-" for r in runs))
    print("  train fwd+lse host us a call " + " / ".join(
        f"{r['host']:.1f}" for r in runs))
    print("== best of each root (ratio to " + distinct[0] + "; > 1: slower)")
    for key in keys:
        best = {d: min(r["ms"][key] for r in runs
                       if r["root"] == d and key in r["ms"])
                for d in distinct if any(r["root"] == d and key in r["ms"]
                                         for r in runs)}
        first = best.get(distinct[0])
        print(f"  {key}: " + " / ".join(
            f"{d} {t:.4f}" + (f" ({t / first:.3f})" if first else "")
            for d, t in best.items()))
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
