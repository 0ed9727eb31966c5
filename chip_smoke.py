#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: CUDA must be available; prints the torch, CUDA and nvcc
   versions, whether ``triton`` imports, and the card's name and power
   limit;
2. build: compiles every ``paddle_tpu_torch/csrc/*.cu`` with nvcc (one
   process per source, in parallel) into ``build/paddle_tpu_torch/``;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serving path's shapes (bf16 out: max abs <= 2e-2;
   paged m, l: |diff| <= 1e-3 * max(|ref|, 1)), with its time, its bound
   (H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense), the plain version's
   time and a library yardstick (``scaled_dot_product_attention``, timed
   here only, never called by the port);
4. slice: Llama-3-8B at full width and depth (random weights from a seeded
   generator, drawn on the card) behind ``ServingEngine(max_seq_len=2048)``
   serves 8 requests of 32 new tokens; checks the tokens, the kernels'
   launch counts (L x prefill chunks, L x decode steps), a clean drain, and
   teacher-forced agreement with the dense forward.

The last lines are the kernels' JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core bf16
OUT_ATOL = 2e-2                  # bf16 outputs vs the f32 plain version
STATS_RTOL = 1e-3                # paged (m, l) vs the plain version
AGREE_MIN = 0.90                 # teacher-forced greedy agreement (bf16 ties)
LOGITS_REL_L2 = 0.1              # first-token logits, engine vs dense
PROMPT_LENS = (17, 64, 200, 333, 511, 700, 1024, 1500)
NEW_TOKENS = 32


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, reps=10, flush=None):
    """Mean device ms of ``fn`` over ``reps`` launches, each timed alone
    with CUDA events after ``flush`` evicted the 50 MB L2 (the serving
    path meets each layer's K/V and weights cold). A device-side sleep
    queued before the start event keeps the card busy while the host
    enqueues ``fn``, so host overhead stays out of the interval."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(4_000_000)     # ~2 ms at H100 clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(flops, nbytes):
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def perturbed_logits(torch, model, ids, gen):
    """The dense forward with every input embedding moved by about one bf16
    ulp (relative Gaussian noise of 2^-8): how far bf16 rounding alone
    moves this model's logits. Returns f32 logits ``[s, vocab]``."""
    from paddle_tpu_torch.models import lm_head_tail

    m, s = model.model, ids.shape[1]
    x = m.embed_tokens(ids)
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    x = (x.float() * (1 + 2.0 ** -8 * noise)).to(x.dtype)
    for layer in m.layers:
        x = layer(x, m.rope_cos[:s], m.rope_sin[:s])
    return lm_head_tail(x[0], m.norm.weight, model.lm_head.weight.t(),
                        model.config.rms_norm_eps)


def phase_environment(torch):
    print("== phase 1: environment")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False")
    from paddle_tpu_torch.ops.cuda import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, triton {triton_v}")
    print(f"  nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"  card: {smi()} ({torch.cuda.device_count()} visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    print("== phase 2: build")
    from paddle_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
          f"(per source: "
          f"{json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    for name in sorted(secs):
        for line in (_build.ptxas_report(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_kernels(torch, gen, flush):
    print("== phase 3: kernels against their plain versions")
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_attention, paged_attention_reference)
    from paddle_tpu_torch.ops.fused.flash_attention import (
        flash_attention, flash_attn_reference)

    rows = {}
    dev = "cuda"
    hq, hk, d = 32, 8, 128
    flash_cases = [("one-shot S=512", 512, 512, 0),
                   ("one-shot S=2048", 2048, 2048, 0),
                   ("carry S=512 at offset 1024", 512, 1536, 1024)]
    # correctness only, off the timed set: the smallest prefill bucket, a
    # ragged tile with kv_len, and head_dim 64
    for label, sq, sk, nq, nk, dd, causal, off, kv_len in (
            ("S=16", 16, 16, hq, hk, d, True, 0, None),
            ("ragged sq=49 kv_len=70", 49, 96, hq, hk, d, True, 21, 70),
            ("d=64 non-causal kv_len=100", 100, 128, 8, 2, 64, False, None,
             100)):
        q = torch.randn(2, sq, nq, dd, generator=gen, device=dev).bfloat16()
        k = torch.randn(2, sk, nk, dd, generator=gen, device=dev).bfloat16()
        v = torch.randn(2, sk, nk, dd, generator=gen, device=dev).bfloat16()
        kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
        diff = (flash_attention(q, k, v, **kw).float()
                - flash_attn_reference(q, k, v, **kw).float())
        err = diff.abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash {label}: max |kernel - plain| = {err:.3e} <= {OUT_ATOL}")
    flash_err, flash_row = 0.0, None
    for label, sq, sk, off in flash_cases:
        q = torch.randn(1, sq, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(1, sk, hk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(1, sk, hk, d, generator=gen, device=dev).bfloat16()
        out = flash_attention(q, k, v, causal=True, q_offset=off)
        ref = flash_attn_reference(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash {label}: max |kernel - plain| = {err:.3e} <= {OUT_ATOL}")
        flash_err = max(flash_err, err)
        ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True,
                                                    q_offset=off), flush=flush)
        plain = time_ms(torch, lambda: flash_attn_reference(
            q, k, v, causal=True, q_offset=off), reps=3, flush=flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if sq == sk and off == 0:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            mask = (torch.arange(sk, device=dev)[None, :]
                    <= torch.arange(sq, device=dev)[:, None] + off)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_ms = time_ms(torch, lib, flush=flush)
        pairs = sum(min(sk, off + r + 1) for r in range(sq))
        flops = 4 * d * hq * pairs
        nbytes = 2 * (2 * sq * hq * d + 2 * sk * hk * d)
        b_ms, b_by = bound(flops, nbytes)
        print(f"  flash {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
              f"sdpa {lib_ms:.4f} ms")
        if sq == 512 and off == 0:
            flash_row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)
        del q, k, v, out, ref
    flash_row["max_abs_err"] = flash_err
    rows["flash_attention"] = flash_row

    # paged decode at the path's shapes: q [8, 32, 128], one layer's pool
    # [8, 1025, 16, 128], table [8, 128]; empty rows, page boundaries and
    # null table tails
    B, page, pps, blocks = 8, 16, 128, 1025
    lens_list = [0, 1, 16, 17, 1000, 2048, 700, 1532]
    kp = torch.randn(hk, blocks, page, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(hk, blocks, page, d, generator=gen, device=dev).bfloat16()
    q = torch.randn(B, hq, d, generator=gen, device=dev).bfloat16()
    perm = torch.randperm(blocks - 1, generator=gen, device=dev) + 1
    table = torch.zeros(B, pps, dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(lens_list):
        used = -(-n // page)
        table[i, :used] = perm[at:at + used].int()
        at += used
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    out, m, l = paged_attention(q, kp, vp, table, lens, return_stats=True)
    rout, rm, rl = paged_attention_reference(q, kp, vp, table, lens,
                                             return_stats=True)
    torch.cuda.synchronize()
    err = (out.float() - rout.float()).abs().max().item()
    check(math.isfinite(err) and err <= OUT_ATOL,
          f"paged out: max |kernel - plain| = {err:.3e} <= {OUT_ATOL}")
    for name, a, r in (("m", m, rm), ("l", l, rl)):
        rel = ((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
        check(rel <= STATS_RTOL, f"paged {name}: max |diff|/max(|ref|,1) = "
                                 f"{rel:.3e} <= {STATS_RTOL}")
    check(bool((m[0] == -1e30).all() and (l[0] == 0).all()
               and (out[0] == 0).all()),
          "paged empty row: m = -1e30, l = 0, out = 0")
    ms = time_ms(torch, lambda: paged_attention(q, kp, vp, table, lens,
                                                return_stats=True),
                 reps=20, flush=flush)
    plain = time_ms(torch, lambda: paged_attention_reference(
        q, kp, vp, table, lens, return_stats=True), reps=5, flush=flush)
    tokens = sum(lens_list)
    flops = 4 * hq * d * tokens
    nbytes = (2 * tokens * hk * d * 2            # K and V rows read once
              + 2 * 2 * B * hq * d               # q in, out back
              + 4 * (B * pps + B) + 2 * 4 * B * hq)  # table, lens, m, l
    b_ms, b_by = bound(flops, nbytes)
    print(f"  paged decode (lens {lens_list}): {ms:.4f} ms (bound "
          f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it), plain "
          f"{plain:.3f} ms, library: none")
    rows["paged_attention"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None,
                                   max_abs_err=err)
    return rows


def phase_slice(torch, seed):
    print("== phase 4: Llama-3-8B through the serving engine")
    import numpy as np

    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LLAMA_PRESETS["llama3-8b"]
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    print(f"  model: {cfg.num_params() / 1e9:.2f} B params, {L} layers, "
          f"built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, ServingConfig(max_seq_len=2048))
    torch.cuda.synchronize()
    print(f"  engine: fused weights + pool {engine.pool.k_pages.shape} "
          f"x2; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    fa.launches = 0
    pa.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_n, paged_n = fa.launches, pa.launches
    s = engine.stats()

    for r in reqs:
        check(r.status == "finished" and len(r.tokens) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{r.rid} (prompt {r.prompt_len}) finished with "
              f"{len(r.tokens)} in-vocab tokens")
    check(flash_n > 0 and flash_n == L * s["prefill_chunks"],
          f"flash launches {flash_n} == L x prefill chunks "
          f"({L} x {s['prefill_chunks']})")
    check(paged_n > 0 and paged_n == L * s["decode_steps"],
          f"paged launches {paged_n} == L x decode steps "
          f"({L} x {s['decode_steps']})")
    drained = engine.drain()["pool"]
    check(drained["free_blocks"] == drained["num_blocks"],
          f"drain: pool free {drained['free_blocks']} == total "
          f"{drained['num_blocks']}")

    generated = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_ms for r in reqs]
    tpot = [r.decode_ms_per_token for r in reqs]
    card = smi()
    print(f"  served {len(reqs)} requests, {sum(PROMPT_LENS)} prompt + "
          f"{generated} generated tokens in {wall:.3f} s "
          f"({s['iterations']} iterations, {s['prefill_chunks']} prefill "
          f"chunks, {s['decode_steps']} decode steps, {s['preemptions']} "
          f"preemptions) on {card}")
    print(f"  TTFT ms: mean {np.mean(ttft):.1f}, min {min(ttft):.1f}, max "
          f"{max(ttft):.1f}; decode ms/token: mean {np.mean(tpot):.2f}; "
          f"generated tokens/s: {generated / wall:.1f}")

    # teacher-forced agreement with the dense forward on two requests, and
    # the first token's logits through the engine's prefill step. Random
    # weights give near-flat logits over 128k tokens, so bf16 rounding
    # alone flips some argmaxes: the run measures that noise as the largest
    # logit change that moving every input embedding by one bf16 ulp causes
    # in the dense forward, and a mismatch whose logit deficit lies within
    # it counts as a bf16 tie.
    strict = ties = total = 0
    noise = 0.0
    gen = make_generator(seed, model.device)
    for r in (reqs[0], reqs[-1]):
        ids = torch.from_numpy(np.concatenate(
            [r.prompt, np.asarray(r.tokens, np.int32)])).long().cuda()[None]
        p = r.prompt_len
        with torch.inference_mode():
            logits = model(ids)[0, p - 1:-1]
            moved = perturbed_logits(torch, model, ids, gen)[p - 1:-1]
        noise = max(noise, (logits - moved).abs().max().item())
        toks = torch.tensor(r.tokens, device=logits.device)
        best = logits.max(dim=-1)
        deficit = best.values - logits.gather(1, toks[:, None])[:, 0]
        match = best.indices == toks
        strict += int(match.sum())
        total += len(r.tokens)
        deficits = deficit[~match].tolist()
        ties += sum(d <= noise for d in deficits)
        print(f"  {r.rid}: {int(match.sum())}/{len(r.tokens)} argmax "
              f"matches; mismatch logit deficits "
              f"{[round(d, 4) for d in deficits]}")
        S = engine._bucket_for(p)
        padded = np.zeros((S,), np.int32)
        padded[:p] = r.prompt
        null_row = np.zeros_like(engine.pool.table[0])
        _, first = engine._prefill(padded, p, 0, null_row)
        dense = logits[0]
        rel = ((first[0] - dense).norm() / dense.norm()).item()
        rel_moved = ((moved[0] - dense).norm() / dense.norm()).item()
        check(rel <= LOGITS_REL_L2,
              f"{r.rid} first-token logits: ||engine - dense|| / ||dense|| "
              f"= {rel:.3e} <= {LOGITS_REL_L2} (dense with inputs moved one "
              f"ulp: {rel_moved:.3e}; max |engine - dense| "
              f"{(first[0] - dense).abs().max().item():.3e})")
    print(f"  bf16 noise: max |logit change| of the dense forward with its "
          f"inputs moved one ulp = {noise:.4f}; strict argmax agreement "
          f"{strict}/{total} "
          f"= {strict / total:.1%}")
    check((strict + ties) / total >= AGREE_MIN,
          f"teacher-forced greedy agreement (argmax, or a tie within the "
          f"bf16 noise) {strict + ties}/{total} = "
          f"{(strict + ties) / total:.1%} >= {AGREE_MIN:.0%}")
    profile_decode(torch, engine, cfg.vocab_size, seed)
    return {"flash_attention": flash_n, "paged_attention": paged_n}


def profile_decode(torch, engine, vocab, seed, steps=8):
    """Where a full decode step's time goes: ``steps`` decode iterations
    over ``max_batch`` rows timed on the host clock, then ``steps`` more
    under ``torch.profiler`` for the device time by kernel and the
    device's idle share."""
    print("== phase 5: where a decode step's time goes")
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(seed + 1)
    reqs = [engine.submit(rng.randint(0, vocab, (64,)), 2 * steps + 4)
            for _ in range(engine.config.max_batch)]
    while engine.scheduler.has_queued() or engine.stats()["prefilling"]:
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    engine.run_until_complete()
    check(all(len(r.tokens) == 2 * steps + 4 for r in reqs),
          f"profiled batch of {len(reqs)} finished")
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3 / steps
    busy = sum(kernels.values())
    if busy == 0:
        print(f"  decode step, batch {len(reqs)}: {step_ms:.2f} ms on the "
              f"host clock; the profiler recorded no device time (device "
              f"breakdown not measured)")
        return
    groups = {"paged_attention": ("paged_partial", "paged_merge"),
              "matmul": ("gemm", "gemv", "nvjet", "cutlass", "xmma")}
    by_group = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in low for k in keys)), "other")
        by_group[group] += ms
    print(f"  decode step, batch {len(reqs)}: {step_ms:.2f} ms on the host "
          f"clock ({prof_ms:.2f} ms under the profiler); device busy "
          f"{busy:.2f} ms per step: idle share {1 - busy / step_ms:.1%} of "
          f"the plain step ({1 - busy / prof_ms:.1%} of the profiled one)")
    print("  device ms per step by group: " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in by_group.items()))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch

    try:
        phase_environment(torch)
        phase_build()
        from paddle_tpu_torch.core.device import make_generator

        gen = make_generator(args.seed, "cuda")
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
        rows = phase_kernels(torch, gen, flush)
        del flush
        torch.cuda.empty_cache()
        launches = phase_slice(torch, args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    meta = {
        "flash_attention": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:266"),
        "paged_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/ops/pallas/paged_attention.py:580"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
