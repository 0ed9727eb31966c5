"""The port's kernel modules against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and the port's
plain PyTorch version (the version a CPU tensor takes), in f32.
Tolerances: attention outputs and (m, l) stats 2e-5 absolute (f32 sums in
another order); rope and RMS norm 1e-5; attention gradients 1e-4 absolute
and the row logsumexp 1e-5 relative (longer f32 sums); the AdamW step
1e-6 x max(|ref|, 1) absolute (the same f32 operations, but XLA may fuse a
multiply and an add into one rounding, and numpy takes the bias
corrections' f32 pow); the fused cross-entropy and its gradients 1e-5.
"""

import jax
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
from paddle_tpu.ops.fused.cross_entropy import _flce as jax_flce
from paddle_tpu.ops.pallas import flash_attention as jax_pallas_flash
from paddle_tpu.ops.pallas.flash_attention import flash_attention_bhsd
from paddle_tpu.ops.pallas.fused_adamw import fused_adamw_flat
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention_pallas, paged_attention_reference as jax_paged_reference)
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_attention, paged_attention_reference)
from paddle_tpu_torch.ops.cuda.fused_adamw import (fused_adamw,
                                                   fused_adamw_reference)
from paddle_tpu_torch.ops.fused.cross_entropy import (
    fused_linear_cross_entropy)
from paddle_tpu_torch.ops.fused.flash_attention import (
    EMPTY_ROW_LSE, flash_attention, flash_attn_bwd_reference,
    flash_attn_reference)
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
# the backward cases add rows that see no column (rows 0-3: c <= r - 4).
# Their forward output is left out of the comparison with Pallas: the
# Pallas forward gives such a row the mean of v over the blocks it visits
# (exp2(NEG_INF - NEG_INF) = 1), the port zeros; lse and gradients agree.
BWD_CASES = dict(FLASH_CASES, empty_rows=(1, 16, 32, 4, 2, 16, True, -4,
                                          None))
GRAD_ATOL = 1e-4
LSE_RTOL = 1e-5
ADAMW_TOL = 1e-6


def _flash_inputs(case, seed=2):
    b, sq, sk, hq, hk, d, causal, q_offset, kv_len = BWD_CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return (q, k, v, do), dict(causal=causal, q_offset=q_offset,
                               kv_len=kv_len)


def _pallas_lse(q, k, v, causal, q_offset, kv_len):
    """The Pallas forward's lse ``[b, h, sq]`` (``_fwd`` in interpret mode,
    with the padding ``flash_attention_bhsd`` applies)."""
    t = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731
    qt, kt, vt = t(q), t(k), t(v)
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    kv_len = sk if kv_len is None else kv_len
    q_offset = kv_len - sq if q_offset is None else q_offset
    bq, bk = jax_pallas_flash._block_sizes(sq, sk, d, causal, dtype=qt.dtype)
    pad = lambda a, n: jnp.pad(  # noqa: E731
        a, ((0, 0), (0, 0), (0, (-a.shape[2]) % n), (0, 0)))
    _, lse = jax_pallas_flash._fwd(
        pad(qt, bq), pad(kt, bk), pad(vt, bk), None, None, None, None,
        d ** -0.5, causal, q_offset, kv_len, bq, bk, 0.0, True)
    return np.asarray(lse)[:, :, :sq, 0]


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


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_lse_and_backward_match_pallas(case):
    """The plain ``(out, lse)`` against the Pallas forward, and the plain
    backward against ``jax.grad`` through ``flash_attention_bhsd`` in
    interpret mode, which runs the Pallas ``_bwd``."""
    (q, k, v, do), kw = _flash_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attn_reference(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_array_equal(
        out.numpy(), flash_attn_reference(tq, tk, tv, **kw).numpy())
    ref_lse = _pallas_lse(q, k, v, **kw)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=LSE_RTOL)
    empty = ref_lse < -1e29
    assert np.all(lse.numpy()[empty] == np.float32(EMPTY_ROW_LSE))
    assert empty.any() == (case == "empty_rows")

    t = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731

    def loss(q_, k_, v_):
        o = flash_attention_bhsd(q_, k_, v_, interpret=True, **kw)
        return jnp.sum(o * t(do))

    grads = jax.grad(loss, argnums=(0, 1, 2))(t(q), t(k), t(v))
    ours = flash_attn_bwd_reference(tq, tk, tv, out, lse, tdo, **kw)
    for name, g, r in zip("qkv", ours, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jnp.swapaxes(r, 1, 2)),
                                   atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_autograd_function_matches_dense_autograd(case):
    """The dispatch's autograd Function on CPU tensors (plain forward and
    backward) against torch autograd through the dense reference."""
    (q, k, v, do), kw = _flash_inputs(case, seed=3)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ins, **kw)
    assert out.grad_fn is not None
    ours = torch.autograd.grad(out, ins, torch.from_numpy(do))
    ins2 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref_out = flash_attn_reference(*ins2, **kw)
    np.testing.assert_allclose(out.detach().numpy(),
                               ref_out.detach().numpy(), atol=ATOL)
    refs = torch.autograd.grad(ref_out, ins2, torch.from_numpy(do))
    for name, g, r in zip("qkv", ours, refs):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")
    with torch.no_grad():
        assert flash_attention(*ins, **kw).grad_fn is None


def test_fused_adamw_reference_matches_pallas():
    """Three steps at N = 1000 (not a tile multiple) against
    ``fused_adamw_flat`` in interpret mode; the CPU dispatch updates in
    place with the plain version's values."""
    n = 1000
    rng = np.random.RandomState(4)
    p = rng.standard_normal(n).astype(np.float32)
    m = np.zeros(n, np.float32)
    v = np.zeros(n, np.float32)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    jp, jm_, jv = (jnp.asarray(a) for a in (p, m, v))
    hyper = (3e-3, 0.9, 0.95, 1e-8, 0.1)
    for step in (1, 2, 3):
        g = rng.standard_normal(n).astype(np.float32)
        jp, jm_, jv = fused_adamw_flat(jp, jnp.asarray(g), jm_, jv, *hyper,
                                       jnp.int32(step), interpret=True)
        rp, rm, rv = fused_adamw_reference(tp, torch.from_numpy(g), tm, tv,
                                           *hyper, step)
        fused_adamw(tp, torch.from_numpy(g), tm, tv, *hyper, step)
        for ours, ref, exact in ((tp, jp, rp), (tm, jm_, rm), (tv, jv, rv)):
            np.testing.assert_array_equal(ours.numpy(), exact.numpy())
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                ours.numpy(), ref, rtol=0,
                atol=ADAMW_TOL * max(float(np.abs(ref).max()), 1.0))


def test_fused_linear_cross_entropy_matches_jax():
    """Value and gradients against the JAX chunked loss at chunk 16: 46
    rows make two full chunks and a ragged tail, and some labels are
    ignored (-100)."""
    rng = np.random.RandomState(5)
    n, h, vocab = 46, 32, 80
    hidden = rng.standard_normal((n, h)).astype(np.float32)
    weight = (rng.standard_normal((vocab, h)) * 0.2).astype(np.float32)
    labels = rng.randint(0, vocab, (n,))
    labels[[0, 17, 45]] = -100
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(weight).requires_grad_()
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                      chunk=16)
    loss.backward()
    jloss, (jdh, jdw) = jax.value_and_grad(
        lambda a, w: jax_flce(a, w, jnp.asarray(labels), transpose_y=False,
                              chunk=16, ignore_index=-100),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(weight.T))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw).T, atol=1e-5)
    assert np.all(th.grad.numpy()[[0, 17, 45]] == 0)
