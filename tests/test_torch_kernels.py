"""The port's kernel modules against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and the port's
plain PyTorch version (the version a CPU tensor takes), in f32.
Tolerances: attention outputs and (m, l) stats 2e-5 absolute (f32 sums in
another order); rope and RMS norm 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import rms_norm as jax_rms_norm
from paddle_tpu.ops.fused.flash_attention import (
    flash_attn_reference as jax_flash_reference)
from paddle_tpu.ops.fused.rope import (
    apply_rotary_position_embedding as jax_rope)
from paddle_tpu.ops.fused.rope import build_rope_cache as jax_rope_cache
from paddle_tpu.ops.pallas.flash_attention import flash_attention_bhsd
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention_pallas, paged_attention_reference as jax_paged_reference)
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_attention, paged_attention_reference)
from paddle_tpu_torch.ops.fused.flash_attention import (
    flash_attention, flash_attn_reference)
from paddle_tpu_torch.ops.fused.rope import (apply_rotary_position_embedding,
                                             build_rope_cache)

torch.set_num_threads(2)

ATOL = 2e-5


@pytest.mark.parametrize("seq,dim,theta", [(12, 16, 10000.0),
                                           (40, 32, 500000.0)])
def test_rope_matches_jax(seq, dim, theta):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, seq, 3, dim)).astype(np.float32)
    cos, sin = build_rope_cache(seq, dim, theta)
    jcos, jsin = jax_rope_cache(seq, dim, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    ours = apply_rotary_position_embedding(torch.from_numpy(x), cos, sin)
    ref = jax_rope.raw_fn(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    # per-row tables [b, s, dh] (the decode path's layout)
    pos = np.array([[3], [7]])
    ours = apply_rotary_position_embedding(torch.from_numpy(x[:, :1]),
                                           cos[pos], sin[pos])
    ref = jax_rope.raw_fn(jnp.asarray(x[:, :1]), jcos[pos], jsin[pos])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal((48,)).astype(np.float32)
    ours = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    ref = jax_rms_norm.raw_fn(jnp.asarray(x), jnp.asarray(w), epsilon=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


# (b, sq, sk, hq, hk, d, causal, q_offset, kv_len)
FLASH_CASES = {
    "causal": (2, 32, 32, 4, 4, 16, True, None, None),
    "q_offset": (1, 16, 48, 4, 2, 16, True, 20, None),
    "gqa_bottom_right": (1, 16, 40, 8, 2, 32, True, None, None),
    "kv_len": (2, 8, 32, 4, 2, 16, False, None, 19),
    "kv_len_causal": (1, 16, 64, 4, 1, 16, True, 7, 30),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_reference_matches_jax(case):
    b, sq, sk, hq, hk, d, causal, q_offset, kv_len = FLASH_CASES[case]
    rng = np.random.RandomState(2)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    ours = flash_attn_reference(tq, tk, tv, causal=causal, kv_len=kv_len,
                                q_offset=q_offset)
    # the dispatch takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        flash_attention(tq, tk, tv, causal=causal, kv_len=kv_len,
                        q_offset=q_offset).numpy(), ours.numpy())
    t = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731
    pallas = jnp.swapaxes(flash_attention_bhsd(
        t(q), t(k), t(v), causal=causal, q_offset=q_offset, kv_len=kv_len,
        interpret=True), 1, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=ATOL)
    if q_offset is None:
        # the JAX plain version aligns causal rows bottom-right, the
        # port's default
        ref = jax_flash_reference.raw_fn(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         kv_len=kv_len)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


# (page, pps, hq, hk, d, lens): lens include empty rows, page boundaries
# and one past them; rows shorter than pps pages keep null table tails
PAGED_CASES = {
    "boundaries_gqa": (16, 4, 8, 2, 32, [0, 1, 16, 17, 31, 32]),
    "mha": (8, 6, 4, 4, 32, [5, 0, 9, 48]),
    "group8_d64": (16, 4, 8, 1, 64, [0, 33, 64]),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_reference_matches_jax(case):
    page, pps, hq, hk, d, lens = PAGED_CASES[case]
    rng = np.random.RandomState(3)
    b, num_pages = len(lens), 40
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hk, num_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hk, num_pages, page, d)).astype(np.float32)
    # distinct shuffled blocks per row; entries past a row's length stay
    # the null block 0 (the engine's unbound tail)
    table = np.zeros((b, pps), np.int32)
    ids = rng.permutation(np.arange(1, num_pages))
    for i, n in enumerate(lens):
        used = -(-n // page)
        table[i, :used] = ids[:used]
        ids = ids[used:]
    seq_lens = np.asarray(lens, np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, seq_lens)]
    out, m, l = paged_attention_reference(*args, return_stats=True)
    out2, m2, l2 = paged_attention(*args, return_stats=True)
    np.testing.assert_array_equal(out2.numpy(), out.numpy())
    np.testing.assert_array_equal(m2.numpy(), m.numpy())
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, seq_lens)]
    for jout in (paged_attention_pallas(*jargs, interpret=True,
                                        return_stats=True),
                 jax_paged_reference(*jargs, return_stats=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(jout[0]),
                                   atol=ATOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(jout[1]),
                                   atol=ATOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(jout[2]),
                                   atol=ATOL, rtol=1e-5)
    empty = seq_lens == 0
    assert np.all(m.numpy()[empty] == np.float32(-1e30))
    assert np.all(l.numpy()[empty] == 0)
    assert np.all(out.numpy()[empty] == 0)
    assert np.isfinite(out.numpy()).all()
