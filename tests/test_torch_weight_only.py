"""The weight-only GEMMs' grid plan and fragment layout, on the CPU.

The CUDA kernels (``paddle_tpu_torch/csrc/int8_matmul.cu``) do not run
here; what surrounds them does. The plan (``plan``, ``cta_units``,
``contributors``, ``slot``: the stream-K split the kernels compute on the
card) must cover every (column tile, k step) exactly once with shares
within one step of each other, at Llama-3-8B's four products and the
kernels' edges, for the decode kernel's column tile of 128 (``D_BN``,
which the card's plan reads from the library) and the 256 of a variant,
at one and two CTAs an SM. The numpy model of the decode kernel's fragment layout
(``decode_fragment_model``: which (k, n) each lane's registers take from
the int8 and half-split int4 bytes, the magic-number conversions bit for
bit, the column permutation undone at the store) must give the plain
product exactly (float64, integers times bf16 values: 1e-12 of the peak)
and agree with the JAX kernel in interpret mode within 1e-5 of the peak
(f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.int8_matmul import (
    int4_weight_matmul as jax_int4_matmul,
    int8_weight_matmul as jax_int8_matmul)
from paddle_tpu_torch.ops.cuda.int8_matmul import (
    ALIGNED_MIN, DECODE_MAX_ROWS, DECODE_OCC, contributors, cta_units,
    decode_fragment_model, kernel_takes, pack_int4, plan, slot)

H100_SMS = 132
BN = 128   # the decode kernel's column tile (csrc/int8_matmul.cu: D_BN)
# Llama-3-8B's decode products (K, N) and the kernels' edges: one column
# tile, N = 384, the smallest K the rule admits, K = 14336
PLAN_SHAPES = {"qkv": (4096, 6144), "out": (4096, 4096),
               "ffn1": (4096, 28672), "ffn2": (14336, 4096),
               "n128": (256, 128), "n384": (256, 384)}
EDGE_ROWS = (1, 7, 8, 9, 16, 17, 33, 63, 64, 65, 128, 255, 256)


def _check_plan(p, m, K, N, int4, sms=H100_SMS, occ=DECODE_OCC):
    assert p.kind == (0 if m <= DECODE_MAX_ROWS else 1)
    assert N % p.bn == 0 and p.tiles == N // p.bn
    assert p.rows >= m and p.rows % (8 if p.kind == 0 else 128) == 0
    assert p.wrows == (32 if p.kind == 1 and int4 else 64)
    assert p.steps * p.wrows == (K // 2 if int4 else K)
    slots = min(p.units, sms * (occ if p.kind == 0 else 1))
    q = p.units // p.ctas
    if p.kind == 0 and p.ctas < slots:   # k-aligned shares, equal
        assert p.units % p.ctas == 0 and p.ctas >= ALIGNED_MIN * slots
        assert p.steps % q == 0 or q % p.steps == 0
    else:
        assert p.ctas == slots
    ranges = [cta_units(p, c) for c in range(p.ctas)]
    # every unit exactly once, in order, shares within one step
    assert [u for r in ranges for u in r] == list(range(p.units))
    sizes = [len(r) for r in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # each tile's contributors are exactly the CTAs whose units meet it;
    # a shared tile's slots are distinct and within the scratch
    used = set()
    for t in range(p.tiles):
        lo, hi = t * p.steps, (t + 1) * p.steps
        meet = [c for c, r in enumerate(ranges)
                if r.start < hi and r.stop > lo]
        assert list(contributors(p, t)) == meet
        if len(meet) > 1:
            for c in meet:
                s = slot(p, c, t)
                assert 0 <= s < 2 * p.ctas and s not in used
                used.add(s)
    # the slots, then (wgmma kernel) 128 bytes a CTA for x's tensor map
    assert p.ws_floats == 2 * p.ctas * p.rows * p.bn \
        + (32 * p.ctas if p.kind else 0)
    if p.cluster > 1:   # one cluster is exactly one tile's contributors
        assert p.kind == 0 and 1 < p.cluster <= 8
        assert p.ctas % p.cluster == 0 and q * p.cluster == p.steps
        for t in range(p.tiles):
            assert list(contributors(p, t)) == list(
                range(t * p.cluster, (t + 1) * p.cluster))


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_plan_covers_every_unit_once(shape, int4):
    K, N = PLAN_SHAPES[shape]
    if int4:
        K = max(K, 256)
    for m in EDGE_ROWS:
        assert kernel_takes(m, K, N, int4)
        for bn, occ in ((BN, 1), (BN, DECODE_OCC), (256, DECODE_OCC)):
            if N % bn == 0:
                _check_plan(plan(m, K, N, int4, H100_SMS, bn, occ), m, K,
                            N, int4, occ=occ)


@pytest.mark.parametrize("sms", [1, 7, 132, 1000])
def test_plan_stream_k_split(sms):
    # K = 14336 at N = 4096: 224 steps a tile over 32 tiles, a share that
    # does not divide the steps; and more CTAs than units
    for int4 in (False, True):
        for m in (8, 64, 256):
            _check_plan(plan(m, 14336, 4096, int4, sms, BN, DECODE_OCC), m,
                        14336, 4096, int4, sms)
    # stream-K where k-aligned shares would idle too many CTAs (a share
    # that does not divide the steps), k-aligned ones where they do not
    p = plan(256, 14336, 4096, False, 132, BN, DECODE_OCC)
    assert (p.kind, p.units, p.ctas) == (1, 7168, 132) and p.units % p.ctas
    assert plan(8, 4096, 4096, False, 132, BN, 2).ctas == 256   # 8 steps
    assert plan(8, 4096, 28672, False, 132, BN, 2).ctas == 224  # one tile
    # the edge K = 14336, N = 384 (672 units): stream-K shares that do not
    # divide a tile's 224 steps at two CTAs an SM (k-aligned 168 would
    # idle 36% of 264), k-aligned ones of 7 steps at one (96 of 132)
    two = plan(8, 14336, 384, False, 132, BN, 2)
    assert two.ctas == 264 and two.units % two.ctas
    one = plan(8, 14336, 384, False, 132, BN, 1)
    assert (one.ctas, one.units // one.ctas) == (96, 7)
    assert one.units % one.ctas == 0
    # clusters where k-aligned shares split a tile into 2..8 and the card
    # holds every cluster at once; else the last-CTA fix-up on that grid
    assert plan(8, 4096, 4096, False, 132, BN, 2).cluster == 8
    assert plan(8, 4096, 6144, False, 132, BN, 2).cluster == 4
    assert plan(8, 4096, 28672, False, 132, BN, 2).cluster == 1  # one tile
    assert one.cluster == 1                                  # 32 to a tile
    few = plan(8, 4096, 4096, False, 132, BN, 2, lambda n: 31)
    assert (few.ctas, few.cluster) == (256, 1)
    assert plan(8, 4096, 4096, False, 132, BN, 2, lambda n: 32).cluster == 8
    assert plan(256, 4096, 4096, False, 132, BN, 2).cluster == 1  # wgmma
    small = plan(8, 128, 128, False, sms, BN, DECODE_OCC)
    assert small.ctas == min(small.units, DECODE_OCC * sms) == min(2, 2 * sms)


def _operands(m, K, N, int4, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((m, K)).astype(np.float32))
    x = x.bfloat16().float().numpy()
    if int4:
        q = rng.randint(-8, 8, (K, N)).astype(np.int8)
        w = pack_int4(torch.from_numpy(q)).numpy()
    else:
        q = w = rng.randint(-128, 128, (K, N)).astype(np.int8)
    scale = (rng.rand(N) * 2e-3 + 1e-4).astype(np.float32)
    return x, q, w, scale


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m", [1, 8, 9, 24, 64])
def test_fragment_model_matches_plain(m, int4):
    x, q, w, scale = _operands(m, 256, 256, int4, seed=m)
    got = decode_fragment_model(x, w, scale, int4, BN)
    ref = (x.astype(np.float64) @ q.astype(np.float64)) \
        * scale.astype(np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("int4", [False, True])
def test_fragment_model_matches_pallas(int4):
    m, K, N = 8, 256, 384
    x, _, w, scale = _operands(m, K, N, int4, seed=7)
    got = decode_fragment_model(x, w, scale, int4, BN)
    jfn = jax_int4_matmul if int4 else jax_int8_matmul
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                         interpret=True), np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
