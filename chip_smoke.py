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
   the card at its path's shapes (bf16 out: max abs <= 2e-2; paged m, l
   and flash lse: |diff| <= 1e-3 * max(|ref|, 1); flash backward dq, dk,
   dv: max |diff| <= 2e-2 * max |ref|; fused AdamW p, m, v: max |diff| <=
   1e-6 * max(|ref|, 1); int8 / int4 weight-only GEMMs: max |diff| <=
   1e-2 * max |plain|, the bf16 output's rounding, at Llama-3-8B's four
   products for m = 8, 32, 64 and 256 (each timed) and at the kernels'
   edges (m from 1 to 256 around every 8-row tile and the decode / wgmma
   boundary at K = 14336, N = 384, where the decode grid takes stream-K
   shares that do not divide a tile's steps; one column tile at the
   smallest K; f32 out), ffn2 twice bitwise equal, with each kernel's
   ptxas line and local-memory accesses; int8 paged as the bf16 one; the grouped GEMMs of the MoE layer, gmm
   in both orientations with and without bias, tgmm and the fused gate +
   up + swiglu with its residuals: max |diff| <= 1e-2 * max |plain| at M =
   32768 routed rows for a router draw and a skewed set with an empty
   group, an 8192-row group and trash rows, whose output rows and
   empty-group dW must be exact zeros, and all three at their tiles'
   edges (M = 8200 in groups of 1, 127, 129, 0, 4095, 63, 65 and 1000
   rows, at the layer's widths and at K = 1000, N = 520; NaN and inf in
   the trash rows of lhs and dout; tgmm and the swiglu twice, bitwise
   equal; the swiglu with and without its residuals, the same y bit for
   bit), the swiglu split by kernel with its host µs a call, with the
   ptxas line of each wgmma kernel (the grouped GEMMs' and the flash
   forward, dK/dV and dQ kernels', with their local-memory accesses in the
   built code); the flash forward and backward also at their wgmma tiles'
   edges (b = 2, sq = 200, sk = 333; q_offset = 37 with kv_len = 300; GQA
   32/8 and 16/4 at d = 64, causal and non-causal), the backward twice at
   the training shape (bitwise equal), and each timed flash shape's ratio
   to SDPA and its wrapper's host µs per call; the selective scan's
   forward (y and the chunk states) and backward (du, ddelta, dA, dB, dC)
   at b16 l1024 d1536 n16 and at the chunk-parallel backward's edges
   (lengths 1, 63, 64, 65, 150 and 1001, d = 100 and 200, n = 5, a strong
   decay, each in f32 and bf16), the WKV
   forward (y) and backward (dr, dk, dv, dlogw, du) at b16 l1024 h12 d64
   with the model's decay ramp and at the chunk-parallel backward's edges
   (lengths 1, 15, 16, 17, 63, 64, 65, 150 and 1001, d = 64 and 128, 1, 3
   and 13 heads, a strong decay, logw = -1e10 (w = 0), and logw >= 0 on
   three channels, whose dlogw must be exactly 0, each in f32 and bf16),
   and the SSD forward (y, the chunk states) and backward
   (dx, ddt, dA, dB, dC, dD) at b8 l1024 h24 dh64 ds64 with x, B and C
   strided as the model's and at its edges (lengths 1, 63, 64, 65, 150
   and 1001, 3, 4, 7 and 13 heads, every dh, ds in {64, 128}, a strong
   decay, a_t = 0, in bf16); every output finite, each within 1e-4 of max
   |plain| in f32 I/O and 1e-2 in bf16 I/O, all computing in f32, the
   three backwards and the SSD forward twice at the path's shape (bitwise
   equal; the scan forward too, y and the chunk states), the scan
   forward's and the chunk-parallel kernels' ptxas lines and local-memory
   accesses, their ms split by kernel (``torch.profiler``), the host µs a
   call of the scan, WKV backward and SSD forward wrappers, and, for the scan,
   the special-function unit's floor for its exponentials beside the
   bound), with its time, its bound (H100
   SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense; the scan 67 TFLOP/s f32
   non-tensor, its decay is elementwise), the plain version's time
   and a library yardstick (``scaled_dot_product_attention`` forward or
   backward, ``torch.optim.AdamW(fused=True)``, a bf16 ``torch.matmul`` of
   the same shape, ``torch._grouped_mm``; timed here only, never called by
   the port), and the host ms of one decode step's 128 weight-only wrapper
   calls;
4. serving: Llama-3-8B at full width and depth (random weights from a
   seeded generator, drawn on the card) behind
   ``ServingEngine(max_seq_len=2048)`` serves 8 requests of 32 new tokens;
   checks the tokens, the kernels' launch counts (L x prefill chunks, L x
   decode steps), a clean drain, and teacher-forced agreement with the
   dense forward;
5. where a decode step's time goes (host clock, ``torch.profiler``);
5b. quantized serving: the same requests through two engines, one at a
   time: A (``quantize="int8"``, ``kv_cache_dtype="int8"``) and B
   (``quantize="int4"``); checks the tokens, the launch counts (int8 paged
   = L x decode steps and no bf16 paged launch in A, the reverse in B;
   weight-only GEMMs = 4 L x (decode steps + prefill chunks of bucket <=
   256); flash = L x prefill chunks), a clean drain, and first-token
   logits and teacher-forced agreement against the dense forward over the
   run's dequantized weights, ties within the bf16 noise (run A: or within
   the int8 pool's own first-token logit change against a bf16 pool, which
   must stay <= 1.0); profiles a decode step of each (one weight-only
   kernel a product at most, none of a second pass);
5c. decode steps of bf16, int8 and int4 engines (bf16 pools) over one
   model, alternated round by round: host ms per step, paired;
6. training: the Llama-2-7B widths (``bench.py``'s 7B proxy: vocab 32000,
   hidden 4096, intermediate 11008, 32 heads, bf16, fused loss) at 4
   layers, batch 2 x 2048 seeded tokens, 10 ``TrainStep`` steps with AdamW
   (lr 3e-4, weight decay 0.1, bf16 moments) and clip 1.0; checks finite,
   falling losses and L flash forward + L flash backward launches per
   step; times the step at 4 and 2 layers and profiles one;
7. eager: the same model rebuilt, 5 steps of ``loss.backward();
   FusedAdamW.step()``; checks falling losses and one fused AdamW launch
   per step;
8. MoE training: ``bench.py``'s MoE-Llama (vocab 32000, hidden 1024,
   intermediate 2816, 12 layers, 8 heads, 8 experts top-2 every 2nd
   layer, capacity factor 2.0, bf16, fused loss) at full width and depth,
   batch 8 x 2048 seeded tokens, 10 ``TrainStep`` steps with AdamW (lr
   3e-4, bf16 moments) and clip 1.0; checks finite, falling losses, a
   fresh-batch loss above ln(vocab) / 2, and per step 6 fused swiglu, 18
   gmm and 12 tgmm launches, 12 flash forward and 12 flash backward, no
   fused AdamW or paged launch; prints the experts' loads, the step time,
   tokens/s, the model-FLOP share, peak memory and a profiled step;
9. Mamba training: ``bench.py``'s Mamba-130m (vocab 32000, hidden 768, 24
   layers, state 16, conv 4, expand 2, dt_rank 48, scan chunk 64, bf16) at
   full width and depth, batch 16 x 1024 seeded tokens, 10 ``TrainStep``
   steps with AdamW (lr 3e-4, bf16 moments) and clip 1.0; checks finite,
   falling losses, a fresh-batch loss above ln(vocab) / 2 and per step 24
   scan forward and 24 scan backward launches and no other kernel of the
   port; prints the step time, tokens/s, the model-FLOP share (``6 N``),
   peak memory and a profiled step;
10. RWKV training: ``bench.py``'s RWKV-169m (vocab 32000, hidden 768, 12
   layers, head_dim 64, intermediate 2688, bf16) at full width and depth,
   as phase 9, with 12 WKV forward and 12 WKV backward launches per step;
11. Mamba-2 training: ``bench.py``'s Mamba-2 (vocab 32000, hidden 768, 24
   layers, state 64, head_dim 64, 24 heads, SSD chunk 128, bf16, untied
   head) at full width and depth, batch 8 x 1024 seeded tokens, as phase
   9, with 24 SSD forward and 24 SSD backward launches per step; its
   profiled step is grouped into SSD forward, SSD backward, conv, cuBLAS,
   copies, the AdamW span and the rest.

The last lines are the kernels' JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core bf16
F32_FLOP_PER_S = 67e12           # f32 outside the tensor cores
OUT_ATOL = 2e-2                  # bf16 outputs vs the f32 plain version
STATS_RTOL = 1e-3                # paged (m, l), flash lse vs the plain version
BWD_RTOL = 2e-2                  # flash dq/dk/dv: max |diff| / max |plain| (bf16)
ADAMW_TOL = 1e-6                 # fused AdamW: max |diff| / max(|plain|, 1)
AGREE_MIN = 0.90                 # teacher-forced greedy agreement (bf16 ties)
LOGITS_REL_L2 = 0.1              # first-token logits, engine vs dense
WO_RTOL = 1e-2                   # weight-only GEMM: max |diff| / max |plain|
KV_NOISE_MAX = 1.0               # int8 vs bf16 pool, max first-token logit change
PROMPT_LENS = (17, 64, 200, 333, 511, 700, 1024, 1500)
NEW_TOKENS = 32
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, EAGER_STEPS = 10, 5
GG_RTOL = 1e-2                   # grouped GEMMs: max |diff| / max |plain|
# group starts off every 64- and 128-row boundary, a one-row group, an
# empty group and 2720 trash rows at M = 8200
GG_RAGGED = (1, 127, 129, 0, 4095, 63, 65, 1000)
GG_RAGGED_M = 8200
MOE_BATCH, MOE_SEQ, MOE_STEPS = 8, 2048, 10
SSM_F32_RTOL = 1e-4              # scan, WKV in f32 I/O: max |diff| / max |plain|
SSM_BF16_RTOL = 1e-2             # the same in bf16 I/O (one bf16 rounding)
SSM_STEPS = 10
H100_SMS, SFU_EX2_PER_CLOCK = 132, 16   # H100 SXM: SMs, ex2 per clock per SM


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


def bound(flops, nbytes, flop_per_s=BF16_FLOP_PER_S):
    t_ops, t_bytes = flops / flop_per_s, nbytes / HBM_BYTES_PER_S
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
        host = host_us_per_call(torch, lambda: flash_attention(
            q, k, v, causal=True, q_offset=off))
        print(f"  flash {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
              f"sdpa {lib_ms:.4f} ms ({ms / lib_ms:.2f}x sdpa); wrapper "
              f"{host:.1f} us a call on the host")
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
    lens_list = PAGED_LENS
    kp = torch.randn(hk, blocks, page, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(hk, blocks, page, d, generator=gen, device=dev).bfloat16()
    q = torch.randn(B, hq, d, generator=gen, device=dev).bfloat16()
    table, lens = paged_inputs(torch, gen)
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
    del kp, vp, q, out, m, l, rout, rm, rl
    rows["paged_attention_int8"] = check_paged_int8(torch, gen, flush)
    print_weight_only_ptxas()
    rows["int8_matmul"] = check_weight_only(torch, gen, flush, int4=False)
    rows["int4_matmul"] = check_weight_only(torch, gen, flush, int4=True)
    torch.cuda.empty_cache()
    rows["flash_attention_bwd"] = check_flash_backward(torch, gen, flush)
    torch.cuda.empty_cache()
    rows["fused_adamw"] = check_fused_adamw(torch, gen)
    torch.cuda.empty_cache()
    rows.update(check_grouped_gemm(torch, gen, flush))
    torch.cuda.empty_cache()
    print_ssm_ptxas()
    rows.update(check_selective_scan(torch, gen, flush))
    torch.cuda.empty_cache()
    rows.update(check_wkv(torch, gen, flush))
    torch.cuda.empty_cache()
    rows.update(check_ssd(torch, gen, flush))
    torch.cuda.empty_cache()
    return rows


PAGED_LENS = [0, 1, 16, 17, 1000, 2048, 700, 1532]


def paged_inputs(torch, gen, blocks=1025, B=8, page=16, pps=128):
    """The serving path's decode table: rows of PAGED_LENS tokens on
    distinct shuffled blocks, null table tails."""
    perm = torch.randperm(blocks - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(B, pps, dtype=torch.int32, device="cuda")
    at = 0
    for i, n in enumerate(PAGED_LENS):
        used = -(-n // page)
        table[i, :used] = perm[at:at + used].int()
        at += used
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device="cuda")
    return table, lens


def check_paged_int8(torch, gen, flush):
    """The int8-page paged kernel against its plain version at the path's
    shapes: q [8, 32, 128], one layer's int8 pool [8, 1025, 16, 128] with
    its block-major scales [1025, 8, 16], lens PAGED_LENS."""
    from paddle_tpu_torch.models.kv_cache import quantize_kv
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_attention, paged_attention_reference)

    hq, hk, d, blocks, page = 32, 8, 128, 1025, 16
    B = len(PAGED_LENS)
    kq, ks = quantize_kv(torch.randn(hk, blocks, page, d, generator=gen,
                                     device="cuda"))
    vq, vs = quantize_kv(torch.randn(hk, blocks, page, d, generator=gen,
                                     device="cuda"))
    ks, vs = ks.transpose(0, 1).contiguous(), vs.transpose(0, 1).contiguous()
    q = torch.randn(B, hq, d, generator=gen, device="cuda").bfloat16()
    table, lens = paged_inputs(torch, gen)
    args = (q, kq, vq, table, lens)
    kw = dict(return_stats=True, k_scales=ks, v_scales=vs)
    out, m, l = paged_attention(*args, **kw)
    rout, rm, rl = paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - rout.float()).abs().max().item()
    check(math.isfinite(err) and err <= OUT_ATOL,
          f"paged int8 out: max |kernel - plain| = {err:.3e} <= {OUT_ATOL}")
    for name, a, r in (("m", m, rm), ("l", l, rl)):
        rel = ((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
        check(rel <= STATS_RTOL, f"paged int8 {name}: max |diff|/max(|ref|,"
                                 f"1) = {rel:.3e} <= {STATS_RTOL}")
    check(bool((m[0] == -1e30).all() and (l[0] == 0).all()
               and (out[0] == 0).all()),
          "paged int8 empty row: m = -1e30, l = 0, out = 0")
    ms = time_ms(torch, lambda: paged_attention(*args, **kw), reps=20,
                 flush=flush)
    plain = time_ms(torch, lambda: paged_attention_reference(*args, **kw),
                    reps=5, flush=flush)
    tokens = sum(PAGED_LENS)
    flops = 4 * hq * d * tokens
    nbytes = (tokens * hk * (2 * d + 2 * 4)      # int8 K, V rows + 2 scales
              + 2 * 2 * B * hq * d               # q in, out back
              + 4 * (table.numel() + B) + 2 * 4 * B * hq)  # table, lens, m, l
    b_ms, b_by = bound(flops, nbytes)
    print(f"  paged decode, int8 pages (lens {PAGED_LENS}): {ms:.4f} ms "
          f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it), plain "
          f"{plain:.3f} ms, library: none")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err)


# Llama-3-8B's four decode products of one layer: (name, K, N)
WO_SHAPES = (("qkv", 4096, 6144), ("out", 4096, 4096),
             ("ffn1", 4096, 28672), ("ffn2", 14336, 4096))


def library_int8pack(torch, x, w, scale, int4):
    """PyTorch's own weight-only product at the same shape, timed as a
    yardstick only: ``_weight_int8pack_mm`` (int8, per-channel scales) or
    ``_weight_int4pack_mm`` (int4 in its own packing, group 128 with zero
    points, on random codes)."""
    K, N = x.shape[1], scale.shape[0]
    if not int4:
        wt, sc = w.t().contiguous(), scale.bfloat16()
        return lambda: torch._weight_int8pack_mm(x, wt, sc)
    raw = torch.randint(0, 256, (N, K // 2), dtype=torch.uint8,
                        device=x.device)
    packed = torch._convert_weight_to_int4pack(raw, 8)
    sz = torch.ones(K // 128, N, 2, dtype=torch.bfloat16, device=x.device)
    return lambda: torch._weight_int4pack_mm(x, packed, 128, sz)


# the weight-only kernels' edges: rows around each 8-row tile and the
# decode / wgmma boundary (64 | 65), one column tile (N = 128), N = 384 at K
# = 14336 (at m = 8 the decode grid takes stream-K shares that do not divide
# a tile's steps; checked on the plan the wrapper launches), the smallest K
# of the rule
WO_EDGE_M = (1, 7, 8, 9, 16, 17, 33, 63, 64, 65, 128, 255, 256)


def check_weight_only(torch, gen, flush, int4):
    """The int8 (int4) weight-only GEMM against its plain version: the four
    products of Llama-3-8B at every row count the serving path gives the
    kernels (m = 8 decode; the prefill buckets m = 32, 64 and 256), each
    timed beside its bound, the plain version, a bf16 ``torch.matmul``,
    ``torch._weight_{int8,int4}pack_mm`` and the wrapper's host µs a call;
    the kernels' edges (``WO_EDGE_M`` at K = 14336, N = 384; m in {1, 8, 64,
    65, 256} at N = 128 and the smallest K the rule admits, bf16 and f32
    out; f32 out at ``out`` for m = 8 and 256); ffn2 at m = 8 twice, bitwise
    equal. The kernels line's numbers sum one layer's four m = 8 products.
    Then the host cost of one decode step's 128 wrapper calls."""
    from paddle_tpu_torch.ops.cuda import int8_matmul as wo

    kind = "int4" if int4 else "int8"
    fn = wo.int4_weight_matmul if int4 else wo.int8_weight_matmul
    plain_fn = wo.int4_weight_matmul_reference if int4 \
        else wo.int8_weight_matmul_reference
    dev = torch.cuda.current_device()
    row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               max_abs_err=0.0)
    by = set()

    def operands(m, K, N):
        w = torch.randint(-128, 128, (K // 2 if int4 else K, N),
                          dtype=torch.int8, device="cuda", generator=gen)
        if not int4:
            w.clamp_(-127, 127)
        scale = torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4
        x = torch.randn(m, K, generator=gen, device="cuda").bfloat16()
        return x, w, scale

    def held(label, x, w, scale, out_dtype=torch.bfloat16):
        m, K = x.shape
        N = w.shape[1]
        out = fn(x, w, scale, out_dtype)
        ref = plain_fn(x, w, scale, out_dtype)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        p = wo._plan(m, K, N, int4, dev)   # the grid the wrapper launched
        grid = (f"{'wgmma' if p.kind else 'decode'} kernel, {p.ctas} CTAs "
                f"x {p.units / p.ctas:.2f} of {p.units} units")
        check(out.dtype == out_dtype and math.isfinite(err)
              and err <= WO_RTOL * peak,
              f"{kind} GEMM {label} m={m} K={K} N={N} "
              f"{str(out_dtype).split('.')[1]} ({grid}): max |kernel - "
              f"plain| = {err:.3e} = {err / peak:.2e} of max |plain| <= "
              f"{WO_RTOL}")
        row["max_abs_err"] = max(row["max_abs_err"], err)

    decode = []     # the four m = 8 products, kept for the host timing
    for m in (8, 32, 64, 256):
        for name, K, N in WO_SHAPES:
            x, w, scale = operands(m, K, N)
            held(name, x, w, scale)
            ms = time_ms(torch, lambda: fn(x, w, scale), reps=20, flush=flush)
            plain = time_ms(torch, lambda: plain_fn(x, w, scale), reps=5,
                            flush=flush)
            wb = (wo.unpack_int4_packed(w) if int4 else w).bfloat16()
            lib = time_ms(torch, lambda: torch.matmul(x, wb), reps=20,
                          flush=flush)
            nbytes = w.numel() + 2 * m * K + 2 * m * N + 4 * N
            b_ms, b_by = bound(2 * m * K * N, nbytes)
            pack = time_ms(torch, library_int8pack(torch, x, w, scale, int4),
                           reps=20 if m == 8 else 3, flush=flush)
            host = host_us_per_call(torch, lambda: fn(x, w, scale))
            print(f"  {kind} GEMM {name} m={m} K={K} N={N}: {ms:.4f} ms "
                  f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it), "
                  f"plain {plain:.3f} ms, bf16 torch.matmul {lib:.4f} ms, "
                  f"torch._weight_{kind}pack_mm {pack:.4f} ms; wrapper "
                  f"{host:.1f} us a call on the host")
            if m == 8:
                row["ms"] += ms
                row["plain_ms"] += plain
                row["bound_ms"] += b_ms
                row["library_ms"] += lib
                by.add(b_by)
                decode.append((x, w, scale, wb))
            del w, x, wb
    kmin = 256 if int4 else 128
    stream_k = wo._plan(8, 14336, 384, int4, dev)
    check(stream_k.units % stream_k.ctas != 0,
          f"{kind} edge K=14336 N=384 at m=8 takes stream-K shares that do "
          f"not divide a tile's {stream_k.steps} steps ({stream_k.units} "
          f"units over {stream_k.ctas} CTAs)")
    for m in WO_EDGE_M:
        held("edge", *operands(m, 14336, 384))
    for m in (1, 8, 64, 65, 256):
        x, w, scale = operands(m, kmin, 128)
        for out_dtype in (torch.bfloat16, torch.float32):
            held("edge, one column tile", x, w, scale, out_dtype)
    for m in (8, 256):
        held("out", *operands(m, 4096, 4096), torch.float32)
    x, w, scale = operands(8, 14336, 4096)
    first, second = fn(x, w, scale), fn(x, w, scale)
    torch.cuda.synchronize()
    check(torch.equal(first, second),
          f"{kind} GEMM ffn2 m=8 twice (split tiles summed in a fixed "
          f"order): bitwise equal")
    del x, w, scale, first, second
    row["bound_by"] = "bytes" if by == {"bytes"} else "operations"
    print(f"  {kind} GEMMs of one decode layer (4 products, m = 8): "
          f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.3f} ms, bf16 torch.matmul "
          f"{row['library_ms']:.4f} ms")
    wrapper = host_ms_per_step(torch, [lambda a=a: fn(*a[:3])
                                       for a in decode])
    bf16 = host_ms_per_step(torch, [lambda a=a: torch.matmul(a[0], a[3])
                                    for a in decode])
    print(f"  {kind} host ms to enqueue one decode step's 128 products "
          f"(32 layers x 4, m = 8), runs {fmt_ms(wrapper)}: "
          f"{1e3 * min(wrapper) / 128:.1f} us per wrapper call at best; "
          f"bf16 torch.matmul at the same shapes {fmt_ms(bf16)}")
    return row


def print_weight_only_ptxas():
    """ptxas's line and the SASS's local accesses of each weight-only
    kernel: the decode kernel per 8-row tiles of x (MT), kind and output
    type, the wgmma kernel per 64-row blocks a warpgroup (MB) and column
    tile."""
    import re

    pattern = re.compile(r"(wo_gemm_kernel|wo_gemm_wgmma_kernel)I((?:Li\d+E)+)"
                         r"Lb([01])E(13__nv_bfloat16|f)E")

    def label(m):
        dims = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
        kind = "int4" if m.group(3) == "1" else "int8"
        out = "bf16" if m.group(4) != "f" else "f32"
        return f"{m.group(1)}<{dims}, {kind}, {out} out>"

    print_ptxas(("int8_matmul",), pattern, label)


def host_ms_per_step(torch, calls, layers=32, reps=7):
    """Host ms to enqueue ``layers`` rounds of ``calls`` back to back (the
    device drained before each round, so no launch waits for a full
    queue), one number per rep after two warm-up reps."""
    out = []
    for rep in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(layers):
            for c in calls:
                c()
        t = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if rep >= 2:
            out.append(t)
    return out


def fmt_ms(ts):
    return "[" + ", ".join(f"{t:.3f}" for t in ts) + "] ms"


def host_us_per_call(torch, fn, calls=32, reps=5):
    """Host µs to enqueue one call of ``fn`` (the median of ``reps`` rounds
    of ``calls`` calls back to back, the device drained before each
    round): what a wrapper costs the host, tensor-map encoding included."""
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


def check_flash_backward(torch, gen, flush):
    """The forward's lse and the backward against their plain versions: the
    slice's shape (timed; the backward run twice, bitwise equal),
    Llama-3-8B's GQA heads, a ragged tile with ``q_offset`` and ``kv_len``,
    head_dim 64 (non-causal and causal GQA), rows that see no column, and
    the wgmma tiles' edges (b = 2, sq = 200, sk = 333; q_offset = 37 and
    kv_len = 300; GQA 32/8 and 16/4 at d = 64, causal and non-causal)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from paddle_tpu_torch.ops.fused.flash_attention import (
        flash_attn_bwd_reference, flash_attn_reference)

    dev, row, err_max = "cuda", None, 0.0
    # (label, b, sq, sk, hq, hk, d, causal, q_offset, kv_len, timed)
    cases = [("slice b=2 S=2048 heads 32/32 d=128", TRAIN_BATCH, TRAIN_SEQ,
              TRAIN_SEQ, 32, 32, 128, True, 0, TRAIN_SEQ, True),
             ("GQA S=2048 heads 32/8", 1, 2048, 2048, 32, 8, 128, True, 0,
              2048, False),
             ("ragged sq=49 q_offset=21 kv_len=70", 2, 49, 96, 32, 8, 128,
              True, 21, 70, False),
             ("d=64 non-causal kv_len=100", 2, 100, 128, 8, 2, 64, False, 0,
              100, False),
             ("d=64 causal S=512 heads 16/4", 2, 512, 512, 16, 4, 64, True,
              0, 512, False),
             ("rows 0-15 see nothing (q_offset=-16)", 1, 80, 64, 8, 8, 128,
              True, -16, 64, False),
             # the wgmma tiles' edges: sq, sk off every multiple of 64 and
             # 128 (a load or store spilling into the next batch's rows),
             # a diagonal and a kv_len edge inside a tile
             ("b=2 sq=200 sk=333 (bottom-right)", 2, 200, 333, 32, 8, 128,
              True, 133, 333, False),
             ("b=2 sq=200 sk=333 q_offset=37 kv_len=300", 2, 200, 333, 32, 8,
              128, True, 37, 300, False),
             ("d=64 GQA 32/8 causal q_offset=37 kv_len=300", 2, 200, 333, 32,
              8, 64, True, 37, 300, False),
             ("d=64 GQA 32/8 non-causal kv_len=300", 2, 200, 333, 32, 8, 64,
              False, 0, 300, False),
             ("d=64 GQA 16/4 non-causal S=256", 2, 256, 256, 16, 4, 64, False,
              0, 256, False)]
    for label, b, sq, sk, hq, hk, d, causal, off, kv_len, timed in cases:
        scale = d ** -0.5
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, sk, hk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, sk, hk, d, generator=gen, device=dev).bfloat16()
        do = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
        fwd = lambda: flash_attention_cuda(  # noqa: E731
            q, k, v, causal, scale, off, kv_len, return_lse=True)
        bwd = lambda: flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, out, lse, do, causal, scale, off, kv_len)
        plain_bwd = lambda: flash_attn_bwd_reference(  # noqa: E731
            q, k, v, out, lse, do, causal, scale, kv_len, off)
        out, lse = fwd()
        rout, rlse = flash_attn_reference(q, k, v, causal, scale, kv_len, off,
                                          return_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - rout.float()).abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash fwd {label}: max |kernel - plain| = {err:.3e} <= "
              f"{OUT_ATOL}")
        rel = ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max().item()
        check(rel <= STATS_RTOL, f"flash fwd {label} lse: max |diff| / "
                                 f"max(|ref|, 1) = {rel:.3e} <= {STATS_RTOL}")
        del rout, rlse
        grads, refs = bwd(), plain_bwd()
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            diff = (g.float() - r.float()).abs().max().item()
            peak = r.float().abs().max().item()
            check(math.isfinite(diff) and diff <= BWD_RTOL * peak,
                  f"flash bwd {label} {name}: max |kernel - plain| = "
                  f"{diff:.3e} = {diff / peak:.3e} of max |plain| <= "
                  f"{BWD_RTOL}")
            err_max = max(err_max, diff)
        if timed:
            again = bwd()
            torch.cuda.synchronize()
            check(all(torch.equal(a, g) for a, g in zip(again, grads)),
                  f"flash bwd {label}: a second run is bitwise equal")
            del again
        del grads, refs
        if timed:
            fwd_ms = time_ms(torch, fwd, flush=flush)
            fwd_plain = time_ms(torch, lambda: flash_attn_reference(
                q, k, v, causal, scale, kv_len, off, return_lse=True),
                reps=3, flush=flush)
            ms = time_ms(torch, bwd, flush=flush)
            plain = time_ms(torch, plain_bwd, reps=3, flush=flush)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            with torch.no_grad():
                fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), flush=flush)
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
            dot = do.transpose(1, 2)
            lib = time_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True), flush=flush)
            del qt, kt, vt, sdpa_out
            pairs = b * sum(min(kv_len, off + r + 1) for r in range(sq))
            flops = 10 * d * hq * pairs          # 5 products, 2.5 x forward
            nbytes = (2 * b * (3 * sq * hq * d + 2 * sk * hk * d)  # q,o,dO,k,v
                      + 4 * b * hq * sq                            # lse
                      + 2 * b * (sq * hq * d + 2 * sk * hk * d))   # dq,dk,dv
            b_ms, b_by = bound(flops, nbytes)
            # the forward with lse: q, k, v in, out and lse back
            f_ms, f_by = bound(
                4 * d * hq * pairs,
                2 * b * (2 * sq * hq * d + 2 * sk * hk * d) + 4 * b * hq * sq)
            print(f"  flash bwd {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
                  f"{b_by}, {b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
                  f"sdpa backward {lib:.4f} ms ({ms / lib:.2f}x sdpa), "
                  f"wrapper {host_us_per_call(torch, bwd):.1f} us a call on "
                  f"the host; the forward with lse {fwd_ms:.4f} ms (bound "
                  f"{f_ms:.4f} ms by {f_by}, {f_ms / fwd_ms:.1%} of it), "
                  f"plain "
                  f"{fwd_plain:.3f} ms, sdpa forward {fwd_lib:.4f} ms "
                  f"({fwd_ms / fwd_lib:.2f}x sdpa), wrapper "
                  f"{host_us_per_call(torch, fwd):.1f} us a call on the host")
            row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
        del q, k, v, do, out, lse
    row["max_abs_err"] = err_max
    return row


def check_fused_adamw(torch, gen):
    """The fused AdamW kernel against its plain version at the slice's
    parameter count and at an unaligned n = 1000."""
    from paddle_tpu_torch.ops.cuda.fused_adamw import (fused_adamw,
                                                       fused_adamw_reference)

    dev, hyper, step = "cuda", (3e-4, 0.9, 0.95, 1e-8, 0.1), 10
    row, err_max = None, 0.0
    for n in (train_config(4).num_params(), 1000):
        p = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        m = torch.randn(n, generator=gen, device=dev) * 1e-3
        v = torch.rand(n, generator=gen, device=dev) * 1e-5
        refs = fused_adamw_reference(p, g, m, v, *hyper, step)
        fused_adamw(p, g, m, v, *hyper, step)
        torch.cuda.synchronize()
        for name, a, r in zip(("p", "m", "v"), (p, m, v), refs):
            err = (a - r).abs().max().item()
            tol = ADAMW_TOL * max(r.abs().max().item(), 1.0)
            check(math.isfinite(err) and err <= tol,
                  f"fused_adamw n={n} {name}: max |kernel - plain| = "
                  f"{err:.3e} <= {tol:.3e}")
            err_max = max(err_max, err)
        del refs
        if row is None:
            ms = time_ms(torch, lambda: fused_adamw(p, g, m, v, *hyper, step))
            plain = time_ms(torch, lambda: fused_adamw_reference(
                p, g, m, v, *hyper, step), reps=3)
            param = torch.nn.Parameter(p)
            param.grad = g
            opt = torch.optim.AdamW([param], lr=hyper[0],
                                    betas=hyper[1:3], eps=hyper[3],
                                    weight_decay=hyper[4], fused=True)
            lib = time_ms(torch, opt.step)
            del opt, param
            b_ms, b_by = bound(15 * n, 28 * n)
            print(f"  fused_adamw n={n}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
                  f"{b_by}, {b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
                  f"torch.optim.AdamW(fused=True) {lib:.4f} ms")
            row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
        del p, g, m, v
    row["max_abs_err"] = err_max
    return row


def moe_config(layers=12):
    """``bench.py``'s MoE-Llama (``bench.py:216-233``) at ``layers``."""
    from paddle_tpu_torch.models import MoELlamaConfig

    return MoELlamaConfig(vocab_size=32000, hidden_size=1024,
                          intermediate_size=2816, num_hidden_layers=layers,
                          num_attention_heads=8, num_key_value_heads=8,
                          max_position_embeddings=MOE_SEQ, dtype="bfloat16",
                          moe_num_experts=8, moe_topk=2, moe_every=2,
                          moe_capacity_factor=2.0, aux_loss_alpha=0.01,
                          fused_loss=True)


def router_sizes(torch, gen):
    """Kept rows per expert of one ``GShardGate`` draw (bf16, seeded
    Xavier weights) over phase 8's 16384 tokens of unit-variance hidden
    states."""
    from paddle_tpu_torch.parallel import GShardGate

    cfg = moe_config()
    gate = GShardGate(cfg.hidden_size, cfg.moe_num_experts,
                      capacity_factor=cfg.moe_capacity_factor, device="cuda",
                      dtype=torch.bfloat16)
    x = torch.randn(MOE_BATCH * MOE_SEQ, cfg.hidden_size, generator=gen,
                    device="cuda").bfloat16()
    with torch.no_grad():
        idx, slot, _, _ = gate._route_sparse(x)
    kept = (slot < gate.capacity(x.shape[0])).int()
    return torch.zeros(cfg.moe_num_experts, dtype=torch.int32,
                       device="cuda").scatter_add_(0, idx.long(), kept)


def check_grouped_gemm(torch, gen, flush):
    """The three grouped-GEMM kernels against their plain versions at one
    MoE layer's products of phase 8 (M = 32768 routed rows, hidden 1024,
    intermediate 2816, 8 experts): gmm (the w2 forward, and the dlhs through
    w2 and w1 with ``transpose_rhs``, each orientation also with the other
    bias setting), tgmm (dW2, dW1) and the fused swiglu with its residuals,
    for a router draw's sizes (timed) and a skewed set with an empty group,
    an 8192-row group and trash rows. The kernels line sums each kernel's
    products of one layer: gmm 3, tgmm 2, swiglu 1."""
    from paddle_tpu_torch.ops.cuda.grouped_gemm import (
        gmm, gmm_reference, gmm_swiglu, gmm_swiglu_reference, tgmm,
        tgmm_reference)

    print_wgmma_ptxas()
    cfg = moe_config()
    d, h, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    M = 2 * MOE_BATCH * MOE_SEQ

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()

    w1, b1 = rnd(E, d, 2 * h, scale=d ** -0.5), rnd(E, 2 * h, scale=0.1)
    w2, b2 = rnd(E, h, d, scale=h ** -0.5), rnd(E, d, scale=0.1)
    bh = rnd(E, h, scale=0.1)
    xs, hs, dy, dh = rnd(M, d), rnd(M, h), rnd(M, d), rnd(M, 2 * h)
    sets = {"router draw": router_sizes(torch, gen),
            "skewed": torch.tensor([8192, 0, 4000, 4096, 3000, 4096, 4096,
                                    4000], dtype=torch.int32, device="cuda")}
    names = ("grouped_gemm", "grouped_gemm_tgmm", "grouped_gemm_swiglu")
    rows = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                    max_abs_err=0.0) for k in names}
    by = {k: set() for k in names}
    for label, sizes in sets.items():
        kept = int(sizes.sum())           # the host reads the sizes here only
        offs_host = [0] + torch.cumsum(sizes, 0).tolist()
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        empty = [g for g in range(E) if offs_host[g + 1] == offs_host[g]]
        print(f"  grouped GEMM sizes ({label}): {sizes.tolist()}, "
              f"{M - kept} trash rows")

        def loop(fn):
            return lambda: [fn(g, offs_host[g], offs_host[g + 1])
                            for g in range(E)]

        # (row, label, kernel, plain, flops, bytes, library call, the
        #  per-group torch.matmul loop); library None: not timed
        products = [
            ("grouped_gemm", "gmm w2 forward + b2 [M,2816]x[8,2816,1024]",
             lambda: gmm(hs, w2, sizes, b2),
             lambda: gmm_reference(hs, w2, sizes, b2), 2 * kept * h * d,
             2 * (kept * h + E * h * d + E * d + M * d),
             lambda: torch._grouped_mm(hs, w2, offs=offs),
             loop(lambda g, a, b: hs[a:b] @ w2[g])),
            ("grouped_gemm", "gmm w2 forward, no bias", lambda: gmm(
                hs, w2, sizes), lambda: gmm_reference(hs, w2, sizes),
             0, 0, None, None),
            ("grouped_gemm", "gmm dlhs through w2 [M,1024]x[8,2816,1024]^T",
             lambda: gmm(dy, w2, sizes, None, True),
             lambda: gmm_reference(dy, w2, sizes, None, True),
             2 * kept * h * d, 2 * (kept * d + E * h * d + M * h),
             lambda: torch._grouped_mm(dy, w2.transpose(1, 2), offs=offs),
             loop(lambda g, a, b: dy[a:b] @ w2[g].t())),
            ("grouped_gemm", "gmm transpose_rhs + bias", lambda: gmm(
                dy, w2, sizes, bh, True),
             lambda: gmm_reference(dy, w2, sizes, bh, True), 0, 0, None,
             None),
            ("grouped_gemm", "gmm dlhs through w1 [M,5632]x[8,1024,5632]^T",
             lambda: gmm(dh, w1, sizes, None, True),
             lambda: gmm_reference(dh, w1, sizes, None, True),
             4 * kept * h * d, 2 * (2 * kept * h + 2 * E * h * d + M * d),
             lambda: torch._grouped_mm(dh, w1.transpose(1, 2), offs=offs),
             loop(lambda g, a, b: dh[a:b] @ w1[g].t())),
            ("grouped_gemm_tgmm", "tgmm dW2 [M,2816]^T x [M,1024]",
             lambda: tgmm(hs, dy, sizes),
             lambda: tgmm_reference(hs, dy, sizes), 2 * kept * h * d,
             2 * (kept * h + kept * d + E * h * d),
             lambda: torch._grouped_mm(hs.t(), dy, offs=offs),
             loop(lambda g, a, b: hs[a:b].t() @ dy[a:b])),
            ("grouped_gemm_tgmm", "tgmm dW1 [M,1024]^T x [M,5632]",
             lambda: tgmm(xs, dh, sizes),
             lambda: tgmm_reference(xs, dh, sizes), 4 * kept * h * d,
             2 * (kept * d + 2 * kept * h + 2 * E * h * d),
             lambda: torch._grouped_mm(xs.t(), dh, offs=offs),
             loop(lambda g, a, b: xs[a:b].t() @ dh[a:b])),
            ("grouped_gemm_swiglu", "swiglu [M,1024]x[8,1024,5632] + b1",
             lambda: gmm_swiglu(xs, w1, sizes, b1),
             lambda: gmm_swiglu_reference(xs, w1, sizes, b1),
             4 * kept * h * d,
             2 * (kept * d + 2 * E * d * h + 2 * E * h + 3 * M * h),
             lambda: swiglu_pair(torch._grouped_mm(xs, w1, offs=offs), h),
             loop(lambda g, a, b: swiglu_pair(xs[a:b] @ w1[g], h))),
        ]
        for row, what, fn, plain_fn, flops, nbytes, lib, per_group in \
                products:
            outs, refs = fn(), plain_fn()
            torch.cuda.synchronize()
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = refs if isinstance(refs, tuple) else (refs,)
            for i, (o, r) in enumerate(zip(outs, refs)):
                err = (o.float() - r.float()).abs().max().item()
                peak = r.float().abs().max().item()
                check(o.dtype == torch.bfloat16 and math.isfinite(err)
                      and err <= GG_RTOL * peak,
                      f"{what} ({label}) out {i}: max |kernel - plain| = "
                      f"{err:.3e} = {err / peak:.2e} of max |plain| <= "
                      f"{GG_RTOL}")
                rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"],
                                               err)
                if row == "grouped_gemm_tgmm":
                    check(all(bool((o[g] == 0).all()) for g in empty),
                          f"{what} ({label}): dW of the empty groups "
                          f"{empty} exact zeros")
                else:
                    check(bool((o[kept:] == 0).all()),
                          f"{what} ({label}) out {i}: the {M - kept} trash "
                          f"rows exact zeros")
            if row == "grouped_gemm_swiglu":
                y_only = gmm_swiglu(xs, w1, sizes, b1, emit_residuals=False)
                check(bool((y_only[0] == outs[0]).all()),
                      f"swiglu ({label}) without residuals: the same y")
            if row == "grouped_gemm_tgmm":
                check(torch.equal(fn(), outs[0]),
                      f"{what} ({label}) run twice: bitwise equal")
            del outs, refs
            if label != "router draw" or not flops:
                continue
            ms = time_ms(torch, fn, flush=flush)
            plain = time_ms(torch, plain_fn, reps=3, flush=flush)
            loop_ms = time_ms(torch, per_group, flush=flush)
            lib_ms = None
            if lib is not None:
                try:
                    lib_ms = time_ms(torch, lib, flush=flush)
                except (RuntimeError, TypeError, AttributeError) as e:
                    print(f"    torch._grouped_mm refused it: {e}")
            b_ms, b_by = bound(flops, nbytes)
            by[row].add(b_by)
            ratio = "" if lib_ms is None else f" ({ms / lib_ms:.2f}x)"
            print(f"  {what}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
                  f"{b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
                  f"torch._grouped_mm "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  f"{ratio}, per-group torch.matmul loop {loop_ms:.4f} ms")
            if row == "grouped_gemm_swiglu":
                split = kernel_split(torch, fn, ("swiglu_wgmma",))
                print(f"    by kernel (ms a call): {split}; wrapper "
                      f"{host_us_per_call(torch, fn):.1f} us a call on the "
                      f"host")
            r = rows[row]
            r["ms"] += ms
            r["plain_ms"] += plain
            r["bound_ms"] += b_ms
            r["library_ms"] = None if lib_ms is None or r["library_ms"] \
                is None else r["library_ms"] + lib_ms
    for k in names:
        rows[k]["bound_by"] = "bytes" if by[k] == {"bytes"} else "operations"
    # the swiglu yardstick is a product plus the activation: no one call
    rows["grouped_gemm_swiglu"]["library_ms"] = None
    for k in ("grouped_gemm", "grouped_gemm_tgmm"):
        r, lib = rows[k], rows[k]["library_ms"]
        if lib:
            print(f"  {k} sum: {r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} "
                  f"of its bound, {r['ms'] / lib:.2f}x torch._grouped_mm "
                  f"({lib:.4f} ms)")
    torch.cuda.synchronize()
    del w1, b1, w2, b2, bh, xs, hs, dy, dh
    for k, err in check_grouped_gemm_edges(torch, gen).items():
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], err)
    return rows


def print_ptxas(sources, pattern, label):
    """Each kernel of ``sources`` whose mangled name matches ``pattern``:
    what ptxas reported (registers at entry, spills, any wgmma
    serialisation message) and the local-memory loads and stores in the
    built code (``cuobjdump -sass``: ptxas counts spills before a
    ``setmaxnreg`` budget applies); ``label`` names a match."""
    import re

    from paddle_tpu_torch.ops.cuda import _build

    for src in sources:
        name = None
        for line in (_build.ptxas_report(src) or "").splitlines():
            if "Compiling entry function" in line:
                m = pattern.search(line)
                name = None if m is None else label(m)
            elif name is not None and ("spill" in line or "registers" in line):
                print(f"  ptxas {name}: "
                      f"{line.replace('ptxas info    :', '').strip()}")
            if "Performance Loss" in line and pattern.search(line):
                # wgmma serialised; the message names its kernel
                what = re.split(r" (?:for|in) the function", line)[0]
                print(f"  ptxas {label(pattern.search(line))}: "
                      f"{what.split(':', 1)[1].strip()}")
        sass = _build.sass_local_accesses(_build.library_path(src))
        for symbol, (st, ld) in sass.items():
            m = pattern.search(symbol)
            if m is not None:
                print(f"  sass {label(m)}: {st} local stores, {ld} local "
                      f"loads")


def print_wgmma_ptxas():
    """What ptxas reported for each wgmma kernel (the gmm, tgmm and fused
    swiglu of ``csrc/grouped_gemm.cu``, the flash forward, dK/dV and dQ
    kernels), with the local-memory accesses in the built code, and the
    dynamic shared memory they launch with."""
    import re

    from paddle_tpu_torch.ops.cuda import _build

    pattern = re.compile(r"(t?gmm_wgmma_kernel|swiglu_wgmma_kernel|"
                         r"flash_fwd_kernel|flash_bwd_dkdv_kernel|"
                         r"flash_bwd_dq_kernel)"
                         r"(?:ILb([01])E|ILi(\d+)E)?")

    def label(m):
        if m.group(2) is not None:
            return f"{m.group(1)}<transpose_rhs {m.group(2)}>"
        return m.group(1) + ("" if m.group(3) is None else f"<{m.group(3)}>")

    print_ptxas(("grouped_gemm", "flash_attention", "flash_attention_bwd"),
                pattern, label)
    smem = _build.load("grouped_gemm").ptt_wgmma_smem_bytes()
    fwd = _build.load("flash_attention").ptt_flash_fwd_smem_bytes
    bwd = _build.load("flash_attention_bwd").ptt_flash_bwd_smem_bytes
    print(f"  wgmma kernels' dynamic shared memory: gmm, tgmm and swiglu {smem} "
          f"bytes; flash forward {fwd(64)} / {fwd(128)} (d = 64 / 128), dK/dV "
          f"{bwd(64, 0)} / {bwd(128, 0)}, dQ {bwd(64, 1)} / {bwd(128, 1)}. "
          f"The producer warpgroups drop to 40 (grouped GEMMs) or 24 "
          f"(flash) registers and the consumers rise to 232 or 240 "
          f"(setmaxnreg)")


def print_ssm_ptxas():
    """ptxas's line and the SASS's local accesses of the scan forward and
    of each chunk-parallel SSM kernel: the scan backward's three, the SSD
    forward's and backward's two each and the WKV backward's two (per I/O
    type; the SSD's per head and state width, the WKV's per head width)."""
    import re

    pattern = re.compile(r"(scan_fwd_kernel|scan_bwd_local_kernel|"
                         r"scan_bwd_pass_kernel|scan_bwd_kernel|ssd_fwd_carry_kernel|"
                         r"ssd_fwd_chunk_kernel|ssd_bwd_carry_kernel|"
                         r"ssd_bwd_kernel|wkv_bwd_carry_kernel|"
                         r"wkv_bwd_chunk_kernel)(I(f|13__nv_bfloat16)"
                         r"(?:Li(\d+)E(?:Li(\d+)E)?)?E)?")

    def label(m):
        if m.group(2) is None:
            return m.group(1)
        dt = "f32" if m.group(3) == "f" else "bf16"
        dims = "".join(f", {d}" for d in m.group(4, 5) if d is not None)
        return f"{m.group(1)}<{dt}{dims}>"

    print_ptxas(("selective_scan", "ssd", "wkv"), pattern, label)


def kernel_split(torch, fn, keys, reps=5):
    """Device ms per call of each kernel ``fn`` launches (``torch.profiler``,
    warm): those whose names hold one of ``keys`` by name, the others (the
    wrapper's sums of partials and casts) together."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, rest = {}, 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) / 1e3 / reps
        if t <= 0:
            continue
        m = re.search(r"\w*(?:%s)\w*" % "|".join(keys), e.key)
        if m is None:
            rest += t
        else:
            name = re.search(r"(\w+_kernel)", m.group(0))
            name = name.group(1) if name else m.group(0)
            out[name] = out.get(name, 0.0) + t
    if not out and rest == 0:
        return "not measured (the profiler recorded no device time)"
    return ", ".join(f"{k} {v:.4f}" for k, v in out.items()) \
        + f", the wrapper's sums and casts {rest:.4f} ms"


def sfu_floor_ms(exps):
    """The least ms for ``exps`` ex2 on the special-function units: 16 a
    clock on each of the 132 SMs at the card's top SM clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return exps / (H100_SMS * SFU_EX2_PER_CLOCK * mhz * 1e6) * 1e3, mhz


def check_grouped_gemm_edges(torch, gen):
    """The three wgmma grouped GEMMs at their edges against their plain
    versions: M = 8200 rows in the ``GG_RAGGED`` groups (starts off every
    64- and 128-row boundary, a one-row group, an empty group, 2720 trash
    rows). gmm in both orientations with and without bias, and tgmm, at the
    MoE layer's w2 widths (K = 2816, N = 1024); the fused swiglu with and
    without its residuals at its widths (K = 1024, N = 2816); each also at
    an odd width (K = 1000, N = 520: multiples of 8, not of 64 or 128).
    Then NaN and inf in the trash rows (of lhs for gmm and the swiglu, of
    lhs and dout for tgmm): the kept rows and every dW equal the plain
    version's and, bit for bit, the NaN-free run's. Every output within
    ``GG_RTOL`` of max |plain|, trash rows and the empty group's dW exact
    zeros, tgmm and the swiglu twice bitwise equal, the swiglu's y without
    residuals bit for bit its y with them. Returns the largest |kernel -
    plain| per kernel row."""
    from paddle_tpu_torch.ops.cuda.grouped_gemm import (
        gmm, gmm_reference, gmm_swiglu, gmm_swiglu_reference, tgmm,
        tgmm_reference)

    M, E = GG_RAGGED_M, len(GG_RAGGED)
    sizes = torch.tensor(GG_RAGGED, dtype=torch.int32, device="cuda")
    kept = sum(GG_RAGGED)
    empty = [g for g, s in enumerate(GG_RAGGED) if s == 0]
    errs = {"grouped_gemm": 0.0, "grouped_gemm_tgmm": 0.0,
            "grouped_gemm_swiglu": 0.0}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()

    def held(row, what, out, ref, same=None):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        zeros = [out[g] for g in empty] if row == "grouped_gemm_tgmm" \
            else [out[kept:]]
        check(math.isfinite(err) and err <= GG_RTOL * peak
              and all(bool((z == 0).all()) for z in zeros)
              and (same is None or torch.equal(out, same)),
              f"{what}: max |kernel - plain| = {err:.3e} = "
              f"{err / peak:.2e} of max |plain| <= {GG_RTOL}, "
              + ("empty-group dW" if row == "grouped_gemm_tgmm"
                 else f"the {M - kept} trash rows") + " exact zeros"
              + ("" if same is None else ", bitwise equal to the NaN-free "
                 "run"))
        errs[row] = max(errs[row], err)

    def poisoned(t):
        t = t.clone()
        t[kept::2] = float("nan")
        t[kept + 1::2] = float("inf")
        return t

    print(f"  grouped GEMM edges: M = {M}, sizes {list(GG_RAGGED)}")
    for label, K, N in (("layer widths", 2816, 1024), ("odd width", 1000,
                                                        520)):
        x, xt, dout = rnd(M, K), rnd(M, N), rnd(M, N)
        w = rnd(E, K, N, scale=K ** -0.5)
        bn, bk = rnd(E, N, scale=0.1), rnd(E, K, scale=0.1)
        for tr, lhs, bias in ((False, x, None), (False, x, bn),
                              (True, xt, None), (True, xt, bk)):
            held("grouped_gemm", f"gmm K={K} N={N} transpose_rhs={tr} "
                 f"bias={bias is not None} ({label})",
                 gmm(lhs, w, sizes, bias, tr),
                 gmm_reference(lhs, w, sizes, bias, tr))
        dw = tgmm(x, dout, sizes)
        held("grouped_gemm_tgmm", f"tgmm [{M},{K}]^T x [{M},{N}] ({label})",
             dw, tgmm_reference(x, dout, sizes))
        check(torch.equal(tgmm(x, dout, sizes), dw),
              f"tgmm ({label}) run twice: bitwise equal")
        xn, doutn = poisoned(x), poisoned(dout)
        for tr, lhs, lhs_n, bias in ((False, x, xn, bn),
                                     (True, xt, poisoned(xt), None)):
            held("grouped_gemm", f"gmm with NaN/inf trash rows, "
                 f"transpose_rhs={tr} ({label})",
                 gmm(lhs_n, w, sizes, bias, tr),
                 gmm_reference(lhs_n, w, sizes, bias, tr),
                 same=gmm(lhs, w, sizes, bias, tr))
        held("grouped_gemm_tgmm", f"tgmm with NaN/inf trash rows in lhs "
             f"and dout ({label})", tgmm(xn, doutn, sizes),
             tgmm_reference(xn, doutn, sizes), same=dw)
        del x, xt, dout, w, xn, doutn, dw
    for label, K, N in (("swiglu widths", 1024, 2816), ("odd width", 1000,
                                                         520)):
        x = rnd(M, K)
        w1, b1 = rnd(E, K, 2 * N, scale=K ** -0.5), rnd(E, 2 * N, scale=0.1)
        outs = gmm_swiglu(x, w1, sizes, b1)
        for name, o, r in zip("ygu", outs, gmm_swiglu_reference(x, w1, sizes,
                                                                b1)):
            held("grouped_gemm_swiglu", f"swiglu {name} [{M},{K}]x[{E},{K},"
                 f"{2 * N}] + b1 ({label})", o, r)
        y_only = gmm_swiglu(x, w1, sizes, b1, emit_residuals=False)
        again = gmm_swiglu(x, w1, sizes, b1)
        torch.cuda.synchronize()
        check(y_only[1] is None and torch.equal(y_only[0], outs[0]),
              f"swiglu ({label}) without residuals: y bit for bit y with "
              f"them")
        check(all(torch.equal(a, o) for a, o in zip(again, outs)),
              f"swiglu ({label}) run twice: bitwise equal")
        xn = poisoned(x)
        for name, o, r, same in zip(
                "ygu", gmm_swiglu(xn, w1, sizes, b1),
                gmm_swiglu_reference(xn, w1, sizes, b1), outs):
            held("grouped_gemm_swiglu", f"swiglu {name} with NaN/inf trash "
                 f"rows ({label})", o, r, same=same)
        del x, w1, b1, outs, y_only, again, xn
    return errs


SSM_B, SSM_L = 16, 1024          # phases 9 and 10: batch 16 x 1024 tokens


def mamba_config():
    """``bench.py``'s Mamba-130m (``bench.py:298-306``)."""
    from paddle_tpu_torch.models import MambaConfig

    return MambaConfig(vocab_size=32000, hidden_size=768,
                       num_hidden_layers=24, state_size=16,
                       conv_kernel=4, expand=2, scan_chunk=64,
                       dtype="bfloat16")


def rwkv_config():
    """``bench.py``'s RWKV-169m (``bench.py:401-405``)."""
    from paddle_tpu_torch.models import RwkvConfig

    return RwkvConfig(vocab_size=32000, hidden_size=768,
                      num_hidden_layers=12, head_dim=64, wkv_chunk=32,
                      wkv_subchunk=16, dtype="bfloat16")


def rel_err(a, ref):
    """``(max |a - ref|, max |a - ref| / max |ref|)`` in f32."""
    diff = (a.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def check_pair(what, outs, refs, names, tol):
    """Each kernel output against the plain version's within ``tol`` of
    max |plain|; returns the largest max |diff|."""
    worst = 0.0
    for name, a, r in zip(names, outs, refs):
        diff, rel = rel_err(a, r)
        check(math.isfinite(diff) and rel <= tol,
              f"{what} {name}: max |kernel - plain| / max |plain| = "
              f"{rel:.3e} <= {tol}")
        worst = max(worst, diff)
    return worst


def plain_vjp(torch, fn, ins, dy, dtype=None):
    """The plain version's forward and its autograd gradients in f32 (or
    ``dtype``)."""
    xs = [t.detach().to(dtype or torch.float32).requires_grad_() for t in ins]
    y = fn(*xs)
    return y.detach(), torch.autograd.grad(y, xs, dy.to(xs[0].dtype))


SCAN_CASES = (                   # b, l, d, n, strong decay
    (1, 1, 100, 5, False), (2, 63, 100, 5, False), (2, 64, 100, 16, False),
    (2, 65, 100, 5, True), (2, 150, 100, 5, False), (2, 1001, 200, 16, True))


def scan_inputs(torch, gen, b, l, d, n, dt, strong):
    """u, delta = softplus of seeded normals, A from the S4D init (-1 .. -n
    per channel), B, C and a cotangent dy. ``strong``: A = -1e4 on three
    channels and delta = 20 on a stretch of the sequence, so that
    exp(delta A) is exactly 0 in f32 there."""
    import torch.nn.functional as F

    dev = "cuda"
    u = torch.randn(b, l, d, generator=gen, device=dev).to(dt)
    delta = F.softplus(torch.randn(b, l, d, generator=gen, device=dev))
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).expand(d, n).contiguous()
    if strong:
        A[:3] = -1e4
        delta[:, l // 3:l // 2 + 1] = 20.0
    B = torch.randn(b, l, n, generator=gen, device=dev).to(dt)
    C = torch.randn(b, l, n, generator=gen, device=dev).to(dt)
    dy = torch.randn(b, l, d, generator=gen, device=dev).to(dt)
    return (u, delta.to(dt), A, B, C), dy


def check_selective_scan(torch, gen, flush):
    """The scan's forward and backward kernels against their plain version
    at phase 9's shape (b16 l1024 d1536 n16; A from the S4D init, delta =
    softplus of seeded normals) in f32 I/O within SSM_F32_RTOL and in the
    path's bf16 within SSM_BF16_RTOL, the forward's chunk states too; and at
    the backward's edges (``SCAN_CASES``, each in f32 and bf16): one step, a
    chunk less one, one, one more, lengths off every tile, d = 100 and 200
    (off the 64-channel tile and the 128 channels of a partial; d = 100 in
    bf16 also off the forward's 16-byte rows), n = 5, and a strong decay
    (exp(delta A) = 0). The forward (y and the chunk states) and the
    backward twice at the path's shape, each bitwise equal. Timed in bf16,
    each split by kernel, with each wrapper's host µs a call; the bound
    counts the JAX audit's
    10 / 25 ops per (b, l, d, n) at the f32 non-tensor rate; beside it the
    special-function unit's floor for the exponentials (one per (b, l, d, n)
    forward, three backward)."""
    from paddle_tpu_torch.ops.cuda import selective_scan as ss

    names = ("du", "ddelta", "dA", "dB", "dC")
    rows, errs = {}, [0.0, 0.0]
    cases = [(*c, dt) for c in SCAN_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(SSM_B, SSM_L, 1536, 16, False, torch.float32),
              (SSM_B, SSM_L, 1536, 16, False, torch.bfloat16)]
    for b, l, d, n, strong, dt in cases:
        tol = SSM_F32_RTOL if dt == torch.float32 else SSM_BF16_RTOL
        what = (f"selective scan b{b} l{l} d{d} n{n} {str(dt)[6:]}"
                + (" strong decay" if strong else ""))
        ins, dy = scan_inputs(torch, gen, b, l, d, n, dt, strong)
        y, bounds = ss.selective_scan_fwd(*ins)
        grads = ss.selective_scan_bwd(*ins, bounds, dy)
        torch.cuda.synchronize()
        with torch.no_grad():
            y_ref, b_ref = ss.selective_scan_reference(
                *(t.float() for t in ins), ss.KERNEL_CHUNK, True)
        errs[0] = max(errs[0], check_pair(
            what, (y.float(), bounds), (y_ref.to(dt), b_ref),
            ("y", "chunk states"), tol))
        _, g_ref = plain_vjp(torch, lambda *a: ss.selective_scan_reference(
            *a, ss.KERNEL_CHUNK), ins, dy)
        errs[1] = max(errs[1], check_pair(
            what, grads, [g.to(t.dtype) for g, t in zip(g_ref, ins)],
            names, tol))
        del y, grads, y_ref, b_ref, g_ref
    # timing at the path's shape and dtype (the last case)
    torch.cuda.empty_cache()
    ms = time_ms(torch, lambda: ss.selective_scan_fwd(*ins), flush=flush)
    y, bounds = ss.selective_scan_fwd(*ins)
    y2, bounds2 = ss.selective_scan_fwd(*ins)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(bounds, bounds2),
          f"selective scan forward b{b} l{l} d{d} n{n} run twice: y and the "
          f"chunk states bitwise equal")
    del y, y2, bounds2
    fwd_split = kernel_split(torch, lambda: ss.selective_scan_fwd(*ins),
                             ("scan_fwd_",))
    fwd_host = host_us_per_call(torch, lambda: ss.selective_scan_fwd(*ins))
    grads = ss.selective_scan_bwd(*ins, bounds, dy)
    again = ss.selective_scan_bwd(*ins, bounds, dy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(again, grads)),
          f"selective scan backward b{b} l{l} d{d} n{n} run twice: bitwise "
          f"equal")
    del grads, again
    bwd_ms = time_ms(torch, lambda: ss.selective_scan_bwd(*ins, bounds, dy),
                     flush=flush)
    split = kernel_split(torch, lambda: ss.selective_scan_bwd(
        *ins, bounds, dy), ("scan_bwd_",))
    bwd_host = host_us_per_call(torch, lambda: ss.selective_scan_bwd(
        *ins, bounds, dy))
    xs = [t.float() for t in ins]
    with torch.no_grad():
        plain = time_ms(torch, lambda: ss.selective_scan_reference(*xs),
                        reps=3)
    xg = [t.requires_grad_() for t in xs]
    plain_both = time_ms(torch, lambda: torch.autograd.grad(
        ss.selective_scan_reference(*xg), xg, dy.float()), reps=3)
    nc = -(-l // ss.KERNEL_CHUNK)
    io = 2                                   # bf16 bytes per element
    fwd_bytes = (3 * b * l * d * io + 2 * b * l * n * io + 4 * d * n
                 + 4 * b * nc * n * d)
    bwd_bytes = (5 * b * l * d * io + 4 * b * l * n * io + 8 * d * n
                 + 4 * b * nc * n * d)
    for key, t, plain_t, ops, nbytes, exps in (
            ("selective_scan", ms, plain, 10, fwd_bytes, 1),
            ("selective_scan_bwd", bwd_ms, plain_both - plain, 25,
             bwd_bytes, 3)):
        b_ms, b_by = bound(ops * b * l * d * n, nbytes, F32_FLOP_PER_S)
        sfu, mhz = sfu_floor_ms(exps * b * l * d * n)
        print(f"  {key} (b{b} l{l} d{d} n{n}, bf16): {t:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by} at 67 TFLOP/s f32 and 3.35 TB/s, "
              f"{b_ms / t:.1%} of it; special-function floor {sfu:.4f} ms "
              f"for {exps} ex2 per (b, l, d, n) at 16 a clock on 132 SMs, "
              f"{mhz:.0f} MHz), plain {plain_t:.3f} ms, library: none")
        rows[key] = dict(ms=t, plain_ms=plain_t, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    print(f"  selective_scan by kernel (ms a call): {fwd_split}; wrapper "
          f"{fwd_host:.1f} us a call on the host")
    print(f"  selective_scan_bwd by kernel (ms a call): {split}; wrapper "
          f"{bwd_host:.1f} us a call on the host")
    print(f"  (plain fwd + bwd {plain_both:.3f} ms; the backward's plain ms "
          f"is that minus the forward's)")
    rows["selective_scan"]["max_abs_err"] = errs[0]
    rows["selective_scan_bwd"]["max_abs_err"] = errs[1]
    return rows


WKV_CASES = (                    # b, l, h, d, strong decay, logw >= 0
    (2, 1, 3, 64, False, False), (2, 15, 1, 64, False, True),
    (2, 16, 3, 64, True, False), (1, 17, 13, 64, True, True),
    (2, 63, 3, 64, False, True), (2, 64, 1, 64, True, False),
    (2, 65, 3, 64, True, True), (2, 150, 13, 64, False, False),
    (1, 1001, 3, 64, True, True), (2, 1, 1, 128, False, True),
    (2, 17, 3, 128, True, True), (2, 33, 13, 128, False, False),
    (1, 150, 3, 128, True, False), (1, 1001, 1, 128, False, True))


def wkv_inputs(torch, gen, b, l, h, d, dt, strong, clamp, ramp=None):
    """r, k, v (0.5 x seeded normals), logw (``ramp``: the model's decay
    ramp through ``rwkv_log_decay``; else uniform in -5.02 .. -0.02), the
    bonus 0.5 plus noise and a cotangent dy. ``strong``: logw = -1e10 (w =
    0) on five channels; ``clamp``: logw = 0, 0.5 and 2 on three channels,
    whose dlogw must be exactly 0."""
    from paddle_tpu_torch.ops.fused.rwkv import rwkv_log_decay

    dev = "cuda"
    r, k, v = (0.5 * torch.randn(b, l, h, d, generator=gen, device=dev)
               for _ in range(3))
    if ramp is not None:
        logw = rwkv_log_decay(ramp.expand(h, d).bfloat16()).float()
    else:
        logw = -5 * torch.rand(h, d, generator=gen, device=dev) - 0.02
    if strong:
        logw[0, :3] = -1e10
        logw[-1, -2:] = -1e10
    if clamp:
        logw[0, 3:6] = torch.tensor([0.0, 0.5, 2.0], device=dev)
    u = 0.5 + 0.1 * torch.randn(h, d, generator=gen, device=dev)
    dy = torch.randn(b, l, h, d, generator=gen, device=dev).to(dt)
    return (r.to(dt), k.to(dt), v.to(dt), logw.contiguous(), u), dy


def check_wkv(torch, gen, flush):
    """The WKV forward and backward kernels against their plain version at
    phase 10's shape (b16 l1024 h12 d64; logw from the model's decay ramp
    through ``rwkv_log_decay``, the bonus 0.5 plus noise), in f32 I/O within
    SSM_F32_RTOL and in the path's bf16 within SSM_BF16_RTOL; and at the
    chunk-parallel backward's edges (``WKV_CASES``, each in f32 and bf16):
    one step, a sub-chunk less one, one, one more, a chunk less one, one,
    one more, lengths off every chunk (150, 1001), d = 64 and 128 (chunks
    of 64 and 32), 1, 3 and 13 heads, a strong decay (logw = -1e10, w = 0)
    and logw >= 0 on three channels (dlogw exactly 0 there). Every case
    checks all outputs for finite values. The backward twice at the path's
    shape, bitwise equal. Timed in bf16; the bound is the JAX audit's 2 b h
    l (c + 2d) d operations (c = 64, the JAX route's kernel chunk at b >=
    16; x 3 for the backward) at 989 TFLOP/s against the bytes."""
    from paddle_tpu_torch.ops.cuda import wkv as wk

    dev = "cuda"
    names = ("dr", "dk", "dv", "dlogw", "du")
    hd = 64
    ramp = torch.tensor([-6.0 + 5.0 * (i / (hd - 1)) ** 0.7
                         for i in range(hd)], device=dev)
    rows, errs = {}, [0.0, 0.0]
    types = (torch.float32, torch.bfloat16)
    cases = [(*c, dt, False) for c in WKV_CASES for dt in types]
    cases += [(SSM_B, SSM_L, 12, hd, False, False, dt, True) for dt in types]
    for b, l, h, d, strong, clamp, dt, path in cases:
        tol = SSM_F32_RTOL if dt == torch.float32 else SSM_BF16_RTOL
        what = (f"wkv b{b} l{l} h{h} d{d} {str(dt)[6:]}"
                + (" strong decay" if strong else "")
                + (" logw >= 0" if clamp else ""))
        ins, dy = wkv_inputs(torch, gen, b, l, h, d, dt, strong, clamp,
                             ramp if path else None)
        y = wk.wkv_fwd(*ins)
        grads = wk.wkv_bwd(*ins, dy)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all())
                  for t in (y, *grads)),
              f"{what}: y and every gradient finite")
        if clamp:
            check(bool((grads[3][0, 3:6] == 0).all()),
                  f"{what}: dlogw exactly 0 where logw >= 0")
        y_ref, g_ref = plain_vjp(torch, wk.wkv_reference, ins, dy)
        errs[0] = max(errs[0], check_pair(what, (y,),
                                          (y_ref.to(dt),), ("y",), tol))
        errs[1] = max(errs[1], check_pair(
            what, grads, [g.to(t.dtype) for g, t in zip(g_ref, ins)],
            names, tol))
        del y, grads, y_ref, g_ref
    # timing at the path's shape and dtype (the last case)
    torch.cuda.empty_cache()
    grads = wk.wkv_bwd(*ins, dy)
    again = wk.wkv_bwd(*ins, dy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(again, grads)),
          f"wkv backward b{b} l{l} h{h} d{d} run twice: bitwise equal")
    del grads, again
    ms = time_ms(torch, lambda: wk.wkv_fwd(*ins), flush=flush)
    bwd_ms = time_ms(torch, lambda: wk.wkv_bwd(*ins, dy), flush=flush)
    split = kernel_split(torch, lambda: wk.wkv_bwd(*ins, dy), ("wkv_bwd_",))
    host = host_us_per_call(torch, lambda: wk.wkv_bwd(*ins, dy))
    xs = [t.float() for t in ins]
    with torch.no_grad():
        plain = time_ms(torch, lambda: wk.wkv_reference(*xs), reps=3)
    xg = [t.requires_grad_() for t in xs]
    plain_both = time_ms(torch, lambda: torch.autograd.grad(
        wk.wkv_reference(*xg), xg, dy.float()), reps=3)
    flops = 2 * b * h * l * (64 + 2 * d) * d
    act = b * l * h * d * 2                  # one bf16 [b, l, h, d] tensor
    for key, t, plain_t, ops, nbytes in (
            ("wkv", ms, plain, flops, 4 * act + 8 * h * d),
            ("wkv_bwd", bwd_ms, plain_both - plain, 3 * flops,
             7 * act + 16 * h * d)):
        b_ms, b_by = bound(ops, nbytes)
        print(f"  {key} (b{b} l{l} h{h} d{d}, bf16): {t:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / t:.1%} of it), plain "
              f"{plain_t:.3f} ms, library: none")
        rows[key] = dict(ms=t, plain_ms=plain_t, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    print(f"  wkv_bwd by kernel (ms a call): {split}; wrapper {host:.1f} us "
          f"a call on the host")
    print(f"  (plain fwd + bwd {plain_both:.3f} ms; the backward's plain ms "
          f"is that minus the forward's)")
    rows["wkv"]["max_abs_err"] = errs[0]
    rows["wkv_bwd"]["max_abs_err"] = errs[1]
    return rows


MAMBA2_B, MAMBA2_L = 8, 1024     # phase 11: batch 8 x 1024 tokens


def mamba2_config():
    """``bench.py``'s Mamba-2 (``bench.py:370-372``)."""
    from paddle_tpu_torch.models import Mamba2Config

    return Mamba2Config(vocab_size=32000, hidden_size=768,
                        num_hidden_layers=24, state_size=64, head_dim=64,
                        ssd_chunk=128, dtype="bfloat16")


def ssd_inputs(torch, gen, b, l, h, dh, ds, dt_io, strong):
    """x, B and C as the model hands them over (strided views of one conv
    output ``[b, l, h dh + 2 ds]``), dt = softplus of normals, A from the
    model's init ``-linspace(1, 16, h)``, D and a cotangent dy. ``strong``:
    A = -16 on head 0 and dt = 10 on a quarter of the sequence, so that
    a_t = exp(A dt) is exactly 0 in f32."""
    import torch.nn.functional as F

    dev = "cuda"
    xc = torch.randn(b, l, h * dh + 2 * ds, generator=gen,
                     device=dev).to(dt_io)
    x = xc[..., :h * dh].unflatten(-1, (h, dh))
    B, C = xc[..., h * dh:h * dh + ds], xc[..., h * dh + ds:]
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    if strong:
        A[0] = -16.0
        dt[:, l // 4:l // 2] = 10.0
    D = torch.randn(h, generator=gen, device=dev)
    dy = torch.randn(b, l, h, dh, generator=gen, device=dev).to(dt_io)
    return (x, dt.to(dt_io), A.to(dt_io), B, C, D.to(dt_io)), dy


SSD_CASES = (                    # b, l, h, dh, ds, I/O type, strong decay
    (2, 1, 3, 64, 64, "f32", False), (2, 63, 3, 64, 64, "f32", False),
    (1, 64, 7, 64, 64, "bf16", False), (2, 65, 4, 64, 64, "f32", False),
    (2, 65, 4, 64, 64, "bf16", True), (2, 150, 3, 64, 128, "f32", False),
    (2, 150, 3, 64, 128, "bf16", True), (1, 100, 2, 128, 64, "f32", False),
    (1, 77, 2, 128, 128, "f32", False), (1, 77, 2, 128, 128, "bf16", True),
    (2, 300, 4, 64, 64, "bf16", True), (1, 1001, 13, 64, 64, "f32", False),
    (1, 1001, 13, 64, 64, "bf16", True))
# A strong decay is held in bf16 only: there (log a = -160 a step) the f32
# plain version's own chunk cumsums lose ~1e-4 in exp(cum_j - cum_i), and
# its dA lies 2.6e-4 of max |dA| from a float64 evaluation.


def check_ssd(torch, gen, flush):
    """The SSD forward (y, the chunk states) and backward (dx, ddt, dA, dB,
    dC, dD) kernels against their plain version ``ssd_chunked_reference``
    at phase 11's shape (b8 l1024 h24 dh64 ds64, x, B and C strided as the
    model's), in f32 I/O within SSM_F32_RTOL of the plain version evaluated
    in float64 (its f32 evaluation's own dA lies up to 3.3e-4 of max |dA|
    from float64 at these edges: dA sums the chunks' reverse cumsums, which
    cancel) and in the path's bf16 within SSM_BF16_RTOL; and at the chunk-parallel kernels' edges (``SSD_CASES``):
    one step, a chunk less one, one, one more, lengths off every chunk (150,
    1001), head counts off the groups of 12, every (dh, ds) in {64, 128}^2
    (chunk 32 but at 64 x 64), a strong decay (a_t = 0 exactly, bf16).
    Every case checks all outputs for finite values. The forward and the
    backward twice at the path's shape, bitwise equal. Timed in bf16, each
    split by kernel, with the wrapper's host µs of the forward; the bound
    counts the bytes each input and output moves once, with the f32 chunk
    states at the reference route's chunk c = 128 whatever the kernel's own,
    against the JAX audit's 2 b h l (c + 2 ds) dh operations (x 3 for the
    backward) at 989 TFLOP/s."""
    from paddle_tpu_torch.ops.cuda import ssd

    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    rows, errs = {}, [0.0, 0.0]
    b, l, h, dh, ds = MAMBA2_B, MAMBA2_L, 24, 64, 64
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = [(*c[:5], types[c[5]], c[6]) for c in SSD_CASES]
    cases += [(b, l, h, dh, ds, torch.float32, False),
              (b, l, h, dh, ds, torch.bfloat16, False)]
    for cb, cl, ch, cdh, cds, dt_io, strong in cases:
        tol = SSM_F32_RTOL if dt_io == torch.float32 else SSM_BF16_RTOL
        what = (f"ssd b{cb} l{cl} h{ch} dh{cdh} ds{cds} {str(dt_io)[6:]}"
                + (" strong decay" if strong else ""))
        ins, dy = ssd_inputs(torch, gen, cb, cl, ch, cdh, cds, dt_io, strong)
        y, states = ssd.ssd_fwd(*ins)
        grads = ssd.ssd_bwd(*ins, states, dy)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all())
                  for t in (y, states, *grads)),
              f"{what}: y, the states and every gradient finite")
        chunk = ssd.kernel_chunk(cdh, cds)
        ref_dt = torch.float64 if dt_io == torch.float32 else torch.float32
        with torch.no_grad():
            y_ref, s_ref = ssd.ssd_chunked_reference(
                *(t.to(ref_dt) for t in ins), chunk, True)
        errs[0] = max(errs[0], check_pair(
            what, (y.float(), states), (y_ref.to(dt_io), s_ref),
            ("y", "chunk states"), tol))
        _, g_ref = plain_vjp(torch, lambda *a: ssd.ssd_chunked_reference(
            *a, chunk), ins, dy, ref_dt)
        errs[1] = max(errs[1], check_pair(
            what, grads, [g.to(t.dtype) for g, t in zip(g_ref, ins)],
            names, tol))
        del y, states, grads, y_ref, s_ref, g_ref
    # timing at the path's shape and dtype (the last case)
    torch.cuda.empty_cache()
    y, states = ssd.ssd_fwd(*ins)
    y2, states2 = ssd.ssd_fwd(*ins)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(states, states2),
          f"ssd forward b{b} l{l} h{h} run twice: y and states bitwise equal")
    del y, y2, states2
    ms = time_ms(torch, lambda: ssd.ssd_fwd(*ins), flush=flush)
    fwd_split = kernel_split(torch, lambda: ssd.ssd_fwd(*ins), ("ssd_fwd_",))
    host = host_us_per_call(torch, lambda: ssd.ssd_fwd(*ins))
    grads = ssd.ssd_bwd(*ins, states, dy)
    again = ssd.ssd_bwd(*ins, states, dy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(again, grads)),
          f"ssd backward b{b} l{l} h{h} run twice: bitwise equal")
    del grads, again
    bwd_ms = time_ms(torch, lambda: ssd.ssd_bwd(*ins, states, dy),
                     flush=flush)
    split = kernel_split(torch, lambda: ssd.ssd_bwd(*ins, states, dy),
                         ("ssd_bwd_",))
    xs = [t.float() for t in ins]
    with torch.no_grad():
        plain = time_ms(torch, lambda: ssd.ssd_chunked_reference(*xs),
                        reps=3)
    xg = [t.requires_grad_() for t in xs]
    plain_both = time_ms(torch, lambda: torch.autograd.grad(
        ssd.ssd_chunked_reference(*xg), xg, dy.float()), reps=3)
    # the function's work, whatever the kernel's own chunk: the residual
    # and the products at the reference route's chunk (the model's
    # ssd_chunk, 128)
    chunk = mamba2_config().ssd_chunk
    nc = -(-l // chunk)
    io = 2                                   # bf16 bytes per element
    act = b * l * h * dh * io                # x, y, dy or dx
    seq = b * l * h * io + 2 * b * l * ds * io + 8 * h   # dt, B, C, A, D
    st = b * nc * h * dh * ds * 4            # the f32 chunk states
    flops = 2 * b * h * l * (chunk + 2 * ds) * dh
    for key, t, plain_t, ops, nbytes in (
            ("ssd", ms, plain, flops, 2 * act + seq + st),
            ("ssd_bwd", bwd_ms, plain_both - plain, 3 * flops,
             3 * act + 2 * seq + st)):
        b_ms, b_by = bound(ops, nbytes)
        print(f"  {key} (b{b} l{l} h{h} dh{dh} ds{ds}, bound at chunk "
              f"{chunk}, bf16): {t:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / t:.1%} of it), plain {plain_t:.3f} ms, library: none")
        rows[key] = dict(ms=t, plain_ms=plain_t, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    print(f"  ssd by kernel (ms a call): {fwd_split}; wrapper {host:.1f} us "
          f"a call on the host")
    print(f"  ssd_bwd by kernel (ms a call): {split}")
    print(f"  (plain fwd + bwd {plain_both:.3f} ms; the backward's plain ms "
          f"is that minus the forward's)")
    rows["ssd"]["max_abs_err"] = errs[0]
    rows["ssd_bwd"]["max_abs_err"] = errs[1]
    return rows


def swiglu_pair(h2, n):
    """``silu(gate) * up`` of ``h2 = [gate | up]``: the swiglu yardstick's
    activation after its product."""
    import torch.nn.functional as F

    return F.silu(h2[:, :n]) * h2[:, n:]


def phase_slice(torch, seed):
    print("== phase 4: Llama-3-8B through the serving engine")
    import numpy as np

    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
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
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    flash_n, paged_n = counts["flash_attention"], counts["paged_attention"]
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
    return {"flash_attention": flash_n, "paged_attention": paged_n}, noise


def profile_decode(torch, engine, vocab, seed, steps=8,
                   title="phase 5: where a decode step's time goes",
                   launches=None, absent=()):
    """Where a full decode step's time goes: ``steps`` decode iterations
    over ``max_batch`` rows timed on the host clock, then ``steps`` more
    under ``torch.profiler`` for the device time by kernel and the
    device's idle share. ``launches`` ({name part: kernels a step, at
    most}) and ``absent`` (name parts) are checked against the profiled
    kernels."""
    print(f"== {title}")
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
    kernels, calls = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3 / steps
            calls[e.key] = calls.get(e.key, 0) + e.count
    busy = sum(kernels.values())
    if busy == 0:
        print(f"  decode step, batch {len(reqs)}: {step_ms:.2f} ms on the "
              f"host clock; the profiler recorded no device time (device "
              f"breakdown and kernel counts not measured)")
        return

    def launched(part):
        return sum(c for k, c in calls.items() if part in k.lower())

    # the profiler may drop activity records, never add any: the exact
    # launches are the wrappers' counts; the profile shows no more kernels
    # than products, and most of them
    for part, per_step in (launches or {}).items():
        check(0.9 * per_step * steps <= launched(part) <= per_step * steps,
              f"profiled decode steps: {launched(part)} {part} kernels "
              f"recorded, at most one a product ({per_step} a step x "
              f"{steps} steps) and at least 90% of them")
    for part in absent:
        check(launched(part) == 0,
              f"profiled decode steps: no {part} kernel ({launched(part)})")
    groups = {"paged_attention": ("paged_partial", "paged_merge"),
              "weight_only_gemm": ("wo_gemm", "wo_reduce"),
              "matmul": ("gemm", "gemv", "nvjet", "cutlass", "xmma")}
    by_group = dict.fromkeys(list(groups) + ["other"], 0.0)
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


def chunked_first_logits(engine, prompt):
    """The f32 logits ``[vocab]`` of the first token after ``prompt``
    through the engine's own prefill steps, in chunks of the prefill
    budget (chunk 2 onwards carries the prefix from the pool), in a slot it
    admits and releases. The engine must be idle."""
    import numpy as np

    pool, budget = engine.pool, engine.config.prefill_token_budget
    slot = pool.admit(len(prompt), 1)
    if slot is None:
        raise SmokeFailure("chunked_first_logits: the engine is not idle")
    offset = 0
    while offset < len(prompt):
        chunk = min(len(prompt) - offset, budget)
        ids = np.zeros((engine._bucket_for(chunk),), np.int32)
        ids[:chunk] = prompt[offset:offset + chunk]
        _, logits = engine._prefill(ids, chunk, offset, pool.table[slot])
        offset += chunk
    pool.release(slot)
    return logits[0]


def dequantize_into(torch, model, weights, int4):
    """Overwrite the model's decoder projections in place with the engine's
    dequantized weights, bf16(q x scale): the dense reference of a
    quantized run."""
    from paddle_tpu_torch.ops.cuda.int8_matmul import unpack_int4_packed
    from paddle_tpu_torch.ops.quant_ops import weight_dequantize

    with torch.no_grad():
        for i, layer in enumerate(model.model.layers):
            at, mlp = layer.self_attn, layer.mlp
            for stack, scale, projs in (
                    (weights.qkv_w, weights.qkv_scale,
                     (at.q_proj, at.k_proj, at.v_proj)),
                    (weights.out_w, weights.out_scale, (at.o_proj,)),
                    (weights.ffn1_w, weights.ffn1_scale,
                     (mlp.gate_proj, mlp.up_proj)),
                    (weights.ffn2_w, weights.ffn2_scale, (mlp.down_proj,))):
                q = unpack_int4_packed(stack[i]) if int4 else stack[i]
                full = weight_dequantize(q, scale[i], torch.bfloat16)
                col = 0
                for p in projs:
                    n = p.out_features
                    p.weight.copy_(full[:, col:col + n].t())
                    col += n
                del full


def dense_agreement(torch, model, reqs, firsts, noise, what):
    """First-token logits of the engine (``firsts[i]``) within
    LOGITS_REL_L2 of the dense forward, and teacher-forced agreement >=
    AGREE_MIN where a mismatch within ``noise`` counts as a tie, on the
    first and the last request."""
    import numpy as np

    strict = ties = total = 0
    for i in (0, len(reqs) - 1):
        r = reqs[i]
        ids = torch.from_numpy(np.concatenate(
            [r.prompt, np.asarray(r.tokens, np.int32)])).long().cuda()[None]
        p = r.prompt_len
        with torch.inference_mode():
            logits = model(ids)[0, p - 1:-1]
        toks = torch.tensor(r.tokens, device=logits.device)
        best = logits.max(dim=-1)
        deficit = best.values - logits.gather(1, toks[:, None])[:, 0]
        match = best.indices == toks
        strict += int(match.sum())
        total += len(r.tokens)
        deficits = deficit[~match].tolist()
        ties += sum(d <= noise for d in deficits)
        print(f"  {what} {r.rid}: {int(match.sum())}/{len(r.tokens)} argmax "
              f"matches; mismatch logit deficits "
              f"{[round(d, 4) for d in deficits]}")
        dense = logits[0]
        rel = ((firsts[i] - dense).norm() / dense.norm()).item()
        check(rel <= LOGITS_REL_L2,
              f"{what} {r.rid} first-token logits: ||engine - dense|| / "
              f"||dense|| = {rel:.3e} <= {LOGITS_REL_L2} (max |engine - "
              f"dense| {(firsts[i] - dense).abs().max().item():.3e})")
    print(f"  {what}: strict argmax agreement {strict}/{total} = "
          f"{strict / total:.1%}; ties counted within {noise:.4f}")
    check((strict + ties) / total >= AGREE_MIN,
          f"{what} teacher-forced greedy agreement (argmax, or a tie within "
          f"the noise) {strict + ties}/{total} = "
          f"{(strict + ties) / total:.1%} >= {AGREE_MIN:.0%}")


def serve_quantized(torch, model, prompts, quant, kv_dtype, chunked, seed):
    """One quantized run: an engine over ``model`` serves ``prompts`` with
    its launch counts, drain and timings checked, gives its first-token
    logits (``firsts``, by prompt index) and a profiled decode step, then
    writes its dequantized weights into ``model``. The engine is freed on
    return. Returns ``(reqs, firsts, launch counts)``."""
    import numpy as np

    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = model.config
    L = cfg.num_hidden_layers
    what = f"run {'A' if kv_dtype else 'B'} (quantize={quant!r}, " \
           f"kv_cache_dtype={kv_dtype!r})"
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, ServingConfig(
        max_seq_len=2048, quantize=quant, kv_cache_dtype=kv_dtype))
    torch.cuda.synchronize()
    w = engine.weights
    wbytes = sum(t.numel() * t.element_size()
                 for t in (w.qkv_w, w.out_w, w.ffn1_w, w.ffn2_w))
    print(f"  {what}: pool {tuple(engine.pool.k_pages.shape)} "
          f"{engine.pool.k_pages.dtype} x2, {engine.spec.bytes_per_block} "
          f"bytes per block; decoder weight stacks {wbytes / 1e9:.2f} GB")
    buckets = []
    prefill = engine._prefill

    def recorded(ids, *a):
        buckets.append(ids.shape[0])
        return prefill(ids, *a)

    engine._prefill = recorded
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counts()
    del engine._prefill
    s = engine.stats()
    for r in reqs:
        check(r.status == "finished" and len(r.tokens) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{what} {r.rid} (prompt {r.prompt_len}) finished with "
              f"{len(r.tokens)} in-vocab tokens")
    steps, chunks = s["decode_steps"], s["prefill_chunks"]
    small = sum(b <= 256 for b in buckets)
    paged, idle = (("paged_attention_int8", "paged_attention") if kv_dtype
                   else ("paged_attention", "paged_attention_int8"))
    gemm, other = (("int4_matmul", "int8_matmul") if quant == "int4"
                   else ("int8_matmul", "int4_matmul"))
    check(n[paged] == L * steps > 0 and n[idle] == 0,
          f"{what} {paged} launches {n[paged]} == L x decode steps "
          f"({L} x {steps}); {idle} {n[idle]} == 0")
    check(n[gemm] == 4 * L * (steps + small) and n[other] == 0,
          f"{what} {gemm} launches {n[gemm]} == 4 L x (decode steps + "
          f"chunks of bucket <= 256) = 4 x {L} x ({steps} + {small}); "
          f"{other} {n[other]} == 0 (chunk buckets {buckets})")
    check(n["flash_attention"] == L * chunks > 0,
          f"{what} flash launches {n['flash_attention']} == L x prefill "
          f"chunks ({L} x {chunks})")
    drained = engine.drain()["pool"]
    check(drained["free_blocks"] == drained["num_blocks"],
          f"{what} drain: pool free {drained['free_blocks']} == total "
          f"{drained['num_blocks']}")
    generated = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_ms for r in reqs]
    tpot = [r.decode_ms_per_token for r in reqs]
    print(f"  {what}: {generated} tokens in {wall:.3f} s ({steps} decode "
          f"steps, {chunks} prefill chunks); TTFT ms mean "
          f"{np.mean(ttft):.1f}, min {min(ttft):.1f}, max {max(ttft):.1f}; "
          f"decode ms/token mean {np.mean(tpot):.2f}; generated tokens/s "
          f"{generated / wall:.1f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi()}")
    firsts = {i: chunked_first_logits(engine, prompts[i])
              for i in sorted({0, len(prompts) - 1, *chunked})}
    # one weight-only kernel a product: 4 a layer, no second pass
    profile_decode(torch, engine, cfg.vocab_size, seed,
                   title=f"phase 5b: where a decode step of {what} goes",
                   launches={"wo_gemm": 4 * L}, absent=("wo_reduce",))
    dequantize_into(torch, model, engine.weights, quant == "int4")
    return reqs, firsts, n


def phase_quant_serving(torch, seed, noise_bf16):
    """Runs A (int8 weights, int8 KV pool) and B (int4 weights, bf16 pool)
    of Llama-3-8B, one engine at a time, each held against a dense forward
    over its dequantized weights. Returns the int8 paged kernel's and the
    weight-only GEMMs' launches: run A's for the int8 kernels, run B's for
    the int4 GEMM."""
    print("== phase 5b: quantized serving, Llama-3-8B")
    import numpy as np

    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LLAMA_PRESETS["llama3-8b"]
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    budget = ServingConfig().resolve().prefill_token_budget
    chunked = [i for i, n in enumerate(PROMPT_LENS) if n > budget]
    launches = {}
    for quant, kv_dtype in (("int8", "int8"), ("int4", "")):
        model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
        noise = noise_bf16
        if kv_dtype:
            # the int8 pool's own noise: the chunked prompts' first-token
            # logits over a bf16 pool with the same int8 weights
            aux = ServingEngine(model, ServingConfig(max_seq_len=2048,
                                                     quantize=quant))
            bf16_kv = {i: chunked_first_logits(aux, prompts[i])
                       for i in chunked}
            del aux
            free_cuda(torch)
        reqs, firsts, n = serve_quantized(torch, model, prompts, quant,
                                          kv_dtype, chunked, seed)
        free_cuda(torch)
        what = f"run {'A' if kv_dtype else 'B'}"
        if kv_dtype:
            kv_noise = max((firsts[i] - bf16_kv[i]).abs().max().item()
                           for i in chunked)
            # checked against a fixed bound before it may widen the window
            # that judges the same int8 scatter and carry
            check(kv_noise <= KV_NOISE_MAX,
                  f"{what}: largest first-token logit change, int8 vs bf16 "
                  f"pool, over the chunked prompts "
                  f"{[PROMPT_LENS[i] for i in chunked]}: {kv_noise:.4f} <= "
                  f"{KV_NOISE_MAX} (bf16 noise {noise_bf16:.4f})")
            noise = max(noise, kv_noise)
        dense_agreement(torch, model, reqs, firsts, noise, what)
        # run A's int8 paged and int8 GEMM counts, run B's int4 GEMM's
        launches.update({k: n[k] for k in (
            ("paged_attention_int8", "int8_matmul") if kv_dtype
            else ("int4_matmul",))})
        del model
        free_cuda(torch)
    return launches


def phase_paired_decode(torch, seed, rounds=5, steps=8):
    """Decode steps of three engines over one Llama-3-8B model (bf16, int8
    and int4 weights; bf16 pools, batch 8), alternated round by round in
    one process so that the host's drift falls on all three alike. Prints
    the host ms per step of each round."""
    print("== phase 5c: decode step host ms, bf16 vs int8 / int4 weights, "
          "paired")
    import numpy as np

    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LLAMA_PRESETS["llama3-8b"]
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, cfg.vocab_size, (64,)) for _ in range(8)]
    new = rounds * steps + 4
    engines = {}
    for quant in (False, "int8", "int4"):
        eng = ServingEngine(model, ServingConfig(max_seq_len=2048,
                                                 quantize=quant))
        reqs = [eng.submit(p, new) for p in prompts]
        while eng.scheduler.has_queued() or eng.stats()["prefilling"]:
            eng.step()
        engines[quant or "bf16"] = (eng, reqs)
    times = {k: [] for k in engines}
    for _ in range(rounds):
        for k, (eng, _) in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3 / steps)
    for k, (eng, reqs) in engines.items():
        eng.run_until_complete()
        check(all(len(r.tokens) == new for r in reqs),
              f"paired {k}: {len(reqs)} requests finished with {new} tokens")
        drained = eng.drain()["pool"]
        check(drained["free_blocks"] == drained["num_blocks"],
              f"paired {k} drain: pool free {drained['free_blocks']} == "
              f"total {drained['num_blocks']}")
    for k, ts in times.items():
        print(f"  {k}: host ms per decode step by round {fmt_ms(ts)}, "
              f"median {statistics.median(ts):.2f}")
    print(f"  on {smi()}")
    del engines, model
    free_cuda(torch)


def train_config(layers):
    """``bench.py``'s Llama-2-7B proxy widths at ``layers`` layers."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=layers,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=TRAIN_SEQ, dtype="bfloat16",
                       fused_loss=True)


def train_tokens(torch, seed, shape=(TRAIN_BATCH, TRAIN_SEQ)):
    import numpy as np

    ids = np.random.RandomState(seed).randint(0, 32000, shape)
    return torch.from_numpy(ids).cuda()


def reset_counts():
    from paddle_tpu_torch.ops.cuda import fused_adamw as fw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import grouped_gemm as gg
    from paddle_tpu_torch.ops.cuda import int8_matmul as wo
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import selective_scan as ss
    from paddle_tpu_torch.ops.cuda import ssd
    from paddle_tpu_torch.ops.cuda import wkv as wk

    fa.launches = fa.bwd_launches = pa.launches = fw.launches = 0
    pa.int8_launches = wo.launches = wo.int4_launches = 0
    gg.launches = gg.tgmm_launches = gg.swiglu_launches = 0
    ss.launches = ss.bwd_launches = wk.launches = wk.bwd_launches = 0
    ssd.launches = ssd.bwd_launches = 0


def read_counts():
    from paddle_tpu_torch.ops.cuda import fused_adamw as fw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import grouped_gemm as gg
    from paddle_tpu_torch.ops.cuda import int8_matmul as wo
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import selective_scan as ss
    from paddle_tpu_torch.ops.cuda import ssd
    from paddle_tpu_torch.ops.cuda import wkv as wk

    return {"selective_scan": ss.launches,
            "selective_scan_bwd": ss.bwd_launches,
            "ssd": ssd.launches, "ssd_bwd": ssd.bwd_launches,
            "wkv": wk.launches, "wkv_bwd": wk.bwd_launches,
            "flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "paged_attention": pa.launches,
            "paged_attention_int8": pa.int8_launches,
            "int8_matmul": wo.launches, "int4_matmul": wo.int4_launches,
            "fused_adamw": fw.launches, "grouped_gemm": gg.launches,
            "grouped_gemm_tgmm": gg.tgmm_launches,
            "grouped_gemm_swiglu": gg.swiglu_launches}


def check_losses(losses, what):
    print(f"  {what} losses: {[round(x, 4) for x in losses]}")
    check(all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] - 0.1,
          f"{what}: losses finite, last {losses[-1]:.4f} < first "
          f"{losses[0]:.4f} - 0.1")


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


def run_train_steps(torch, layers, steps, seed):
    """A fresh model of ``layers`` layers and ``steps`` TrainStep calls;
    returns the model, the step, the losses and each step's host ms."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(train_config(layers), seed=seed)
    step = TrainStep(model, None, AdamW(
        learning_rate=3e-4, weight_decay=0.1, moment_dtype="bfloat16",
        parameters=model.parameters()), clip_norm=1.0)
    ids = train_tokens(torch, seed)
    torch.cuda.synchronize()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        times.append((time.perf_counter() - t0) * 1e3)
    return model, step, ids, losses, times


def phase_train(torch, seed):
    print("== phase 6: training the Llama-2-7B widths with TrainStep + AdamW")
    L = 4
    cfg = train_config(L)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model, step, ids, losses, times = run_train_steps(torch, L, TRAIN_STEPS,
                                                      seed)
    n = read_counts()
    print(f"  model: {cfg.num_params() / 1e9:.3f} B params, {L} layers, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}; step host ms "
          f"{[round(t, 1) for t in times]}")
    check_losses(losses, f"TrainStep x {TRAIN_STEPS}")
    # a fixed batch is memorised within a few steps; a fresh batch must
    # stay near ln(vocab), or attention saw the tokens it predicts
    with torch.no_grad():
        fresh = train_tokens(torch, seed + 1)
        held = model(fresh, labels=fresh)[0].item()
    check(math.isfinite(held) and held > 0.5 * math.log(cfg.vocab_size),
          f"loss on a fresh batch {held:.3f} > ln(vocab) / 2 = "
          f"{0.5 * math.log(cfg.vocab_size):.3f} (no causal leak)")
    check(n["flash_attention"] == L * TRAIN_STEPS
          and n["flash_attention_bwd"] == L * TRAIN_STEPS
          and n["paged_attention"] == 0 and n["fused_adamw"] == 0,
          f"launches over {TRAIN_STEPS} steps: flash fwd "
          f"{n['flash_attention']}, flash bwd {n['flash_attention_bwd']} "
          f"(L x steps = {L * TRAIN_STEPS} each), paged "
          f"{n['paged_attention']}, fused_adamw {n['fused_adamw']} (0 each)")
    step_ms4 = sum(times[2:]) / len(times[2:])
    profile_train_step(torch, step, ids, step_ms4)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {peak:.1f} GiB")
    del model, step
    free_cuda(torch)
    _, _, _, _, times2 = run_train_steps(torch, 2, 4, seed)
    free_cuda(torch)
    step_ms2 = sum(times2[2:]) / len(times2[2:])
    per_layer = (step_ms4 - step_ms2) / 2
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens / (step_ms4 / 1e3)
    # bench.py:56-59: 6 N + the causal attention term, per token
    flops_tok = 6 * cfg.num_params() + 12 * L * TRAIN_SEQ \
        * cfg.hidden_size * 0.5
    mfu = flops_tok * tps / BF16_FLOP_PER_S
    print(f"  step host ms: {step_ms4:.1f} at 4 layers, {step_ms2:.1f} at 2 "
          f"layers: {per_layer:.1f} ms per layer, "
          f"{step_ms2 - 2 * per_layer:.1f} ms of embedding, head, loss and "
          f"update; {tps:.0f} tokens/s, model-FLOP share {mfu:.1%} of "
          f"989 TFLOP/s at 4 layers on {smi()}")
    return n


TRAIN_GROUPS = {"flash fwd": ("flash_fwd",), "flash bwd": ("flash_bwd",),
                "matmul": ("gemm", "gemv", "nvjet", "cutlass", "xmma")}


def profile_train_step(torch, step, ids, step_ms, groups=None, top=8):
    """One TrainStep under ``torch.profiler``: device ms by group (kernel
    names containing a group's keys; the first group that matches takes
    it) and the device's idle share of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    opt = step._opt
    apply = opt.apply_gradients

    def traced(*args, **kw):
        with record_function("ptt::apply_gradients"):
            return apply(*args, **kw)

    opt.apply_gradients = traced
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids, ids).item()
    del opt.apply_gradients
    # the annotation shows up as a device range too: its span is the
    # optimizer's device time, and it is no kernel
    kernels, adamw = {}, 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if e.key == "ptt::apply_gradients":
            adamw = max(adamw, t / 1e3)
        elif t > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3
    busy = sum(kernels.values())
    if busy == 0:
        print(f"  train step {step_ms:.1f} ms on the host clock; the profiler "
              f"recorded no device time (device breakdown not measured)")
        return
    groups = groups or TRAIN_GROUPS
    by_group = dict.fromkeys(groups, 0.0)
    rest = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in low for k in keys)), None)
        if group is None:
            rest += ms
        else:
            by_group[group] += ms
    if 0 < adamw <= rest:
        by_group["AdamW elementwise (its device span)"] = adamw
        by_group["other"] = rest - adamw
    elif adamw > 0:
        # the span outlasts the ungrouped kernels: it holds gaps, and is not
        # taken out of them
        by_group["AdamW span (gaps included)"] = adamw
        by_group["other (AdamW's kernels included)"] = rest
    else:
        by_group["AdamW elementwise"] = "not measured"
        by_group["other"] = rest
    print(f"  train step: {step_ms:.1f} ms on the host clock, device busy "
          f"{busy:.1f} ms: idle share {1 - busy / step_ms:.1%}")
    print("  device ms per step by group: " + ", ".join(
        f"{g} {ms:.2f}" if isinstance(ms, float) else f"{g} {ms}"
        for g, ms in by_group.items()))
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:8.3f} ms  {name[:100]}")


def phase_eager(torch, seed):
    print("== phase 7: the eager loop with FusedAdamW")
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import FusedAdamW

    L = 4
    model = LlamaForCausalLM(train_config(L), seed=seed)
    opt = FusedAdamW(learning_rate=3e-4, weight_decay=0.1,
                     parameters=model.parameters())
    ids = train_tokens(torch, seed)
    torch.cuda.synchronize()
    reset_counts()
    losses, times = [], []
    for _ in range(EAGER_STEPS):
        t0 = time.perf_counter()
        loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    check_losses(losses, f"FusedAdamW x {EAGER_STEPS}")
    check(n["fused_adamw"] == EAGER_STEPS
          and n["flash_attention"] == n["flash_attention_bwd"]
          == L * EAGER_STEPS,
          f"launches over {EAGER_STEPS} steps: fused_adamw "
          f"{n['fused_adamw']} (1 per step), flash fwd "
          f"{n['flash_attention']} and bwd {n['flash_attention_bwd']} "
          f"({L * EAGER_STEPS} each)")
    print(f"  eager step host ms {[round(t, 1) for t in times]}; flat "
          f"master + moments {3 * opt._flat.numel() * 4 / 2**30:.1f} GiB")
    del model, opt
    free_cuda(torch)
    return n


# gmm_kernel: the fused swiglu; gmm_wgmma_kernel: gmm and tgmm_wgmma_kernel
MOE_GROUPS = {"grouped GEMM": ("swiglu_wgmma_kernel", "gmm_wgmma_kernel"),
              **TRAIN_GROUPS}


def phase_moe_train(torch, seed):
    print("== phase 8: MoE-Llama training (8 experts, top-2) with TrainStep "
          "+ AdamW")
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MoELlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = moe_config()
    L = cfg.num_hidden_layers
    n_moe = L // cfg.moe_every
    total, activated = cfg.param_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MoELlamaForCausalLM(cfg, seed=seed)
    step = TrainStep(model, None, AdamW(
        learning_rate=3e-4, moment_dtype="bfloat16",
        parameters=model.parameters()), clip_norm=1.0)
    ids = train_tokens(torch, seed, (MOE_BATCH, MOE_SEQ))
    torch.cuda.synchronize()
    print(f"  model: {total / 1e6:.1f} M params ({activated / 1e6:.1f} M "
          f"activated per token), {L} layers ({n_moe} MoE), built in "
          f"{time.perf_counter() - t0:.1f} s; batch {MOE_BATCH} x {MOE_SEQ}")
    reset_counts()
    losses, times = [], []
    for _ in range(MOE_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    print(f"  step host ms {[round(t, 1) for t in times]}")
    check_losses(losses, f"MoE TrainStep x {MOE_STEPS}")
    routed = cfg.moe_topk * MOE_BATCH * MOE_SEQ
    for i, moe in enumerate(model.moe_layers()):
        load = moe.expert_load.tolist()
        print(f"  MoE layer {2 * i + 1}: kept rows per expert {load}, drop "
              f"share {1 - sum(load) / routed:.2%} (last step)")
    steps = MOE_STEPS
    check(n["grouped_gemm_swiglu"] == n_moe * steps
          and n["grouped_gemm"] == 3 * n_moe * steps
          and n["grouped_gemm_tgmm"] == 2 * n_moe * steps
          and n["flash_attention"] == L * steps
          and n["flash_attention_bwd"] == L * steps
          and n["fused_adamw"] == 0 and n["paged_attention"] == 0
          and n["paged_attention_int8"] == 0,
          f"launches over {steps} steps: swiglu "
          f"{n['grouped_gemm_swiglu']} ({n_moe} x steps), gmm "
          f"{n['grouped_gemm']} (3 x {n_moe} x steps), tgmm "
          f"{n['grouped_gemm_tgmm']} (2 x {n_moe} x steps), flash fwd "
          f"{n['flash_attention']} and bwd {n['flash_attention_bwd']} "
          f"({L} x steps), fused_adamw {n['fused_adamw']}, paged "
          f"{n['paged_attention'] + n['paged_attention_int8']} (0 each)")
    with torch.no_grad():
        fresh = train_tokens(torch, seed + 1, (MOE_BATCH, MOE_SEQ))
        held = model(fresh, labels=fresh)[0].item()
    check(math.isfinite(held) and held > 0.5 * math.log(cfg.vocab_size),
          f"MoE loss on a fresh batch {held:.3f} > ln(vocab) / 2 = "
          f"{0.5 * math.log(cfg.vocab_size):.3f} (no causal leak)")
    step_ms = sum(times[2:]) / len(times[2:])
    tokens = MOE_BATCH * MOE_SEQ
    tps = tokens / (step_ms / 1e3)
    # bench.py:244: 6 x activated params + the causal attention term
    flops_tok = 6 * activated + 12 * L * MOE_SEQ * cfg.hidden_size * 0.5
    print(f"  step host ms {step_ms:.1f} (mean of steps 3-{steps}): "
          f"{tps:.0f} tokens/s, model-FLOP share "
          f"{flops_tok * tps / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s "
          f"({flops_tok * tokens / 1e12:.1f} TFLOP per step, bound "
          f"{flops_tok * tokens / BF16_FLOP_PER_S * 1e3:.1f} ms); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB on {smi()}")
    profile_train_step(torch, step, ids, step_ms, MOE_GROUPS, top=16)
    del model, step
    free_cuda(torch)
    return n


SSM_GROUPS = {
    "selective scan fwd": ("scan_fwd_",),
    "selective scan bwd": ("scan_bwd_",),
    "wkv fwd": ("wkv_fwd_kernel",), "wkv bwd": ("wkv_bwd_",),
    **TRAIN_GROUPS}
# the conv group first: cuDNN's implicit-GEMM convolutions are xmma kernels;
# "copies": PyTorch's same-dtype copies (layout changes and .contiguous())
MAMBA2_GROUPS = {
    "SSD fwd": ("ssd_fwd_",), "SSD bwd": ("ssd_bwd_",),
    "conv": ("conv", "fprop", "dgrad", "wgrad"),
    "cuBLAS": TRAIN_GROUPS["matmul"], "copies": ("direct_copy",)}


def phase_ssm_train(torch, seed, family):
    """Phase 9 (``family="mamba"``), 10 (``"rwkv"``) or 11 (``"mamba2"``):
    the model at ``bench.py``'s full width and depth and batch (16 x 1024
    seeded tokens; Mamba-2 8 x 1024), ``SSM_STEPS`` TrainStep steps with
    AdamW (lr 3e-4, bf16 moments) and clip 1.0 as ``bench.py`` trains it.
    Checks finite, falling losses, a fresh-batch loss above ln(vocab) / 2,
    and one forward and one backward launch of the family's kernel per
    layer and step and no other kernel of the port; prints the step time,
    tokens/s, the model-FLOP share by ``bench.py``'s ``6 N`` (the
    recurrence's operations excluded, as there), peak memory and a profiled
    step. Returns the launch counts."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (Mamba2ForCausalLM,
                                         MambaForCausalLM, RwkvForCausalLM)
    from paddle_tpu_torch.optimizer import AdamW

    shape, groups = (SSM_B, SSM_L), SSM_GROUPS
    if family == "mamba":
        phase, title, cfg, cls = 9, "Mamba-130m", mamba_config(), \
            MambaForCausalLM
        fwd, bwd = "selective_scan", "selective_scan_bwd"
    elif family == "rwkv":
        phase, title, cfg, cls = 10, "RWKV-169m", rwkv_config(), \
            RwkvForCausalLM
        fwd, bwd = "wkv", "wkv_bwd"
    else:
        phase, title, cfg, cls = 11, "Mamba-2", mamba2_config(), \
            Mamba2ForCausalLM
        fwd, bwd = "ssd", "ssd_bwd"
        shape, groups = (MAMBA2_B, MAMBA2_L), MAMBA2_GROUPS
    print(f"== phase {phase}: {title} training with TrainStep + AdamW")
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cls(cfg, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    step = TrainStep(model, None, AdamW(
        learning_rate=3e-4, moment_dtype="bfloat16",
        parameters=model.parameters()), clip_norm=1.0)
    ids = train_tokens(torch, seed, shape)
    torch.cuda.synchronize()
    print(f"  model: {n_params / 1e6:.1f} M params, {L} layers, hidden "
          f"{cfg.hidden_size}, built in {time.perf_counter() - t0:.1f} s; "
          f"batch {shape[0]} x {shape[1]}")
    reset_counts()
    losses, times = [], []
    for _ in range(SSM_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    print(f"  step host ms {[round(t, 1) for t in times]}")
    check_losses(losses, f"{title} TrainStep x {SSM_STEPS}")
    others = {k: v for k, v in n.items() if k not in (fwd, bwd) and v}
    check(n[fwd] == L * SSM_STEPS and n[bwd] == L * SSM_STEPS
          and not others,
          f"launches over {SSM_STEPS} steps: {fwd} {n[fwd]}, {bwd} "
          f"{n[bwd]} ({L} x steps each), other kernels {others or 0}")
    with torch.no_grad():
        fresh = train_tokens(torch, seed + 1, shape)
        held = model(fresh, labels=fresh)[0].item()
    check(math.isfinite(held) and held > 0.5 * math.log(cfg.vocab_size),
          f"{title} loss on a fresh batch {held:.3f} > ln(vocab) / 2 = "
          f"{0.5 * math.log(cfg.vocab_size):.3f} (no causal leak)")
    step_ms = sum(times[2:]) / len(times[2:])
    tokens = shape[0] * shape[1]
    tps = tokens / (step_ms / 1e3)
    flops_tok = 6 * n_params             # bench.py:313, :384, :415
    print(f"  step host ms {step_ms:.1f} (mean of steps 3-{SSM_STEPS}): "
          f"{tps:.0f} tokens/s, model-FLOP share "
          f"{flops_tok * tps / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s "
          f"({flops_tok * tokens / 1e12:.1f} TFLOP per step, bound "
          f"{flops_tok * tokens / BF16_FLOP_PER_S * 1e3:.1f} ms); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB on {smi()}")
    profile_train_step(torch, step, ids, step_ms, groups, top=12)
    del model, step
    free_cuda(torch)
    return n


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
        free_cuda(torch)
        launches, noise = phase_slice(torch, args.seed)
        free_cuda(torch)
        launches.update(phase_quant_serving(torch, args.seed, noise))
        free_cuda(torch)
        phase_paired_decode(torch, args.seed)
        launches["flash_attention_bwd"] = \
            phase_train(torch, args.seed)["flash_attention_bwd"]
        launches["fused_adamw"] = phase_eager(torch, args.seed)["fused_adamw"]
        moe = phase_moe_train(torch, args.seed)
        launches.update({k: moe[k] for k in (
            "grouped_gemm", "grouped_gemm_tgmm", "grouped_gemm_swiglu")})
        mamba = phase_ssm_train(torch, args.seed, "mamba")
        rwkv = phase_ssm_train(torch, args.seed, "rwkv")
        mamba2 = phase_ssm_train(torch, args.seed, "mamba2")
        launches.update({k: mamba[k] for k in ("selective_scan",
                                               "selective_scan_bwd")})
        launches.update({k: rwkv[k] for k in ("wkv", "wkv_bwd")})
        launches.update({k: mamba2[k] for k in ("ssd", "ssd_bwd")})
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the serving kernels' counts on the serving run, the int8
    # paged and int8 GEMM's on quantized run A, the int4 GEMM's on run B,
    # the flash backward's on the TrainStep run, fused AdamW's on the eager
    # run, the grouped GEMMs' on the MoE TrainStep run, the scan's on the
    # Mamba run, the WKV's on the RWKV run and the SSD's on the Mamba-2 run
    meta = {
        "flash_attention": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:266"),
        "flash_attention_bwd": (
            "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:453"),
        "paged_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/ops/pallas/paged_attention.py:580"),
        "paged_attention_int8": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/paged_attention.py:580"),
        "int8_matmul": ("paddle_tpu_torch/csrc/int8_matmul.cu",
                        "paddle_tpu/ops/pallas/int8_matmul.py:143"),
        "int4_matmul": ("paddle_tpu_torch/csrc/int8_matmul.cu",
                        "paddle_tpu/ops/pallas/int8_matmul.py:197"),
        "fused_adamw": ("paddle_tpu_torch/csrc/fused_adamw.cu",
                        "paddle_tpu/ops/pallas/fused_adamw.py:100"),
        "grouped_gemm": ("paddle_tpu_torch/csrc/grouped_gemm.cu",
                         "paddle_tpu/ops/pallas/grouped_gemm.py:236"),
        "grouped_gemm_tgmm": ("paddle_tpu_torch/csrc/grouped_gemm.cu",
                              "paddle_tpu/ops/pallas/grouped_gemm.py:290"),
        "grouped_gemm_swiglu": ("paddle_tpu_torch/csrc/grouped_gemm.cu",
                                "paddle_tpu/ops/pallas/grouped_gemm.py:487"),
        "selective_scan": ("paddle_tpu_torch/csrc/selective_scan.cu",
                           "paddle_tpu/ops/pallas/selective_scan.py:217"),
        "selective_scan_bwd": ("paddle_tpu_torch/csrc/selective_scan.cu",
                               "paddle_tpu/ops/pallas/selective_scan.py:284"),
        "wkv": ("paddle_tpu_torch/csrc/wkv.cu",
                "paddle_tpu/ops/pallas/wkv.py:301"),
        "wkv_bwd": ("paddle_tpu_torch/csrc/wkv.cu",
                    "paddle_tpu/ops/pallas/wkv.py:350"),
        "ssd": ("paddle_tpu_torch/csrc/ssd.cu",
                "paddle_tpu/ops/pallas/ssd.py:198"),
        "ssd_bwd": ("paddle_tpu_torch/csrc/ssd.cu",
                    "paddle_tpu/ops/pallas/ssd.py:243"),
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
