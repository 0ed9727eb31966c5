"""Masks and segment ids in the flash attention oracles, on the CPU.

The wgmma flash kernels (``paddle_tpu_torch/csrc/flash_attention.cu`` and
``flash_attention_bwd.cu``) take an additive f32 or bool mask read by
strides and packed-varlen segment ids (``csrc/flash_mask.cuh``);
``chip_smoke.py`` holds them against the plain ``flash_attn_reference``
and ``flash_attn_bwd_reference``. Here those plain versions are held
against the Pallas ``_fwd`` (its lse) and ``flash_attention_pallas`` with
``jax.vjp`` (its output and gradients), both in interpret mode, on the
same seeded numpy inputs in f32: additive masks of 2, 3 and 4 dimensions
with one or every head, finite biases and ``-inf`` blocks that empty rows,
bool masks, segment ids with causal masking, GQA, and sq = 80 and 200 so
that tile edges fall inside. Tolerances as ``test_torch_flash.py``:
outputs 2e-5, gradients 1e-4 absolute; lse within 1e-5 of max(|lse|, 1)
(an lse near 0 has no relative precision of its own, as ``chip_smoke.py``
reads it).

A row that sees no column gives zeros in the port. The Pallas kernel
turns a bool mask into an additive -1e30, so a row that a bool mask
empties gets the mean of v there and gradients through it (ROADMAP §C):
such rows are compared by lse, and the gradients with their dout set to
zero, after checking that the port's gradients do not depend on it. A
mask that requires grad takes the plain version with autograd; its
gradient is held against ``jax.grad`` through the JAX dense path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused.flash_attention import dense_flash_attention
from paddle_tpu.ops.pallas import flash_attention as jax_pallas_flash
from paddle_tpu.ops.pallas.flash_attention import flash_attention_pallas
from paddle_tpu_torch.ops.cuda.flash_attention import (ADDITIVE_F32,
                                                       BOOL_U8, mask_args)
from paddle_tpu_torch.ops.fused import flash_attention as flash_mod
from paddle_tpu_torch.ops.fused.flash_attention import (
    EMPTY_ROW_LSE, flash_attention, flash_attn_bwd_reference,
    flash_attn_reference)

torch.set_num_threads(2)

ATOL = 2e-5
LSE_RTOL = 1e-5
GRAD_ATOL = 1e-4
D = 64

# (b, sq, sk, hq, hk, causal, mask kind, mask dims, mask heads, segments)
CASES = {
    # finite biases and -inf blocks over whole rows, broadcast over b and h
    "additive_2d_sq80": (2, 80, 80, 2, 2, False, "additive", 2, 1, False),
    # [b, sq, sk] under a causal mask, sq off every tile
    "additive_3d_causal_sq200": (2, 200, 200, 2, 2, True, "additive", 3, 1,
                                 False),
    # one head broadcast over a GQA group of 2
    "additive_4d_one_head_gqa": (2, 80, 96, 4, 2, False, "additive", 4, 1,
                                 False),
    # a mask per head, kv longer than q (bottom-right causal)
    "additive_4d_every_head_causal": (2, 80, 120, 4, 4, True, "additive", 4,
                                      4, False),
    # rows that see nothing under a bool mask
    "bool_3d_empty_rows": (2, 80, 80, 2, 1, False, "bool", 3, 1, False),
    "bool_4d_every_head_causal": (2, 200, 200, 4, 2, True, "bool", 4, 4,
                                  False),
    # packed sequences: 3-6 segments a row, causal inside each
    "segments_causal_sq200": (2, 200, 200, 4, 2, True, None, 0, 0, True),
    "segments_bool_2d_gqa": (2, 80, 80, 4, 1, True, "bool", 2, 1, True),
}


def _segments(rng, b, s):
    ids = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), rng.randint(2, 6),
                                  replace=False))
        ids[i] = np.searchsorted(cuts, np.arange(s), side="right")
    return ids


def _mask(rng, b, sq, sk, hm, kind, dims):
    """A mask of ``dims`` dimensions and its 4-D form ``[b, hm, sq, sk]``
    for the Pallas kernel (the JAX dispatch's reshapes)."""
    full = (b, hm, sq, sk)
    if kind == "additive":
        m = rng.standard_normal(full).astype(np.float32) * 2
        # whole -inf blocks, and every column of rows 3 and sq - 2 hidden
        m[..., 16:48, 32:64] = -np.inf
        m[..., 3, :] = -np.inf
        m[..., sq - 2, :] = -np.inf
    else:
        m = rng.random_sample(full) > 0.3
        m[..., 5, :] = False                     # rows 5 see nothing
    if dims == 2:
        m = m[0, 0]
    elif dims == 3:
        m = m[:, 0]
    four = m[None, None] if dims == 2 else m[:, None] if dims == 3 else m
    return m, np.broadcast_to(four, (b, hm, sq, sk))


def _inputs(case, seed=11):
    b, sq, sk, hq, hk, causal, kind, dims, hm, segs = CASES[case]
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, sq, hq, D), (b, sk, hk, D),
                                 (b, sk, hk, D), (b, sq, hq, D)))
    mask = mask4 = qs = ks = None
    if kind is not None:
        mask, mask4 = _mask(rng, b, sq, sk, hm, kind, dims)
    if segs:
        qs = ks = _segments(rng, b, sq)
    return (q, k, v, do), causal, mask, mask4, qs, ks


def _pallas_lse(q, k, v, causal, mask4, qs, ks):
    """The Pallas forward's lse ``[b, h, sq]``: ``_fwd`` in interpret mode
    with the mask and segment ids prepared and padded as
    ``flash_attention_bhsd`` prepares them."""
    bhsd = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    bq, bk = jax_pallas_flash._block_sizes(sq, sk, d, causal,
                                           dtype=jnp.float32)
    pq, pk = (-sq) % bq, (-sk) % bk
    pad = lambda a, n: jnp.pad(  # noqa: E731
        a, ((0, 0), (0, 0), (0, n), (0, 0)))
    mask = None
    if mask4 is not None:
        m = jnp.asarray(mask4)
        m = jnp.where(m, 0.0, jax_pallas_flash.NEG_INF) if m.dtype == bool \
            else m * jax_pallas_flash.LOG2E
        mask = jnp.pad(m.astype(jnp.float32),
                       ((0, 0), (0, 0), (0, pq), (0, pk)))
    qseg = kseg = None
    if qs is not None:
        qseg = jnp.pad(jnp.asarray(qs), ((0, 0), (0, pq)), constant_values=-1)
        kseg = jnp.pad(jnp.asarray(ks), ((0, 0), (0, pk)), constant_values=-2)
    _, lse = jax_pallas_flash._fwd(
        pad(bhsd(q), pq), pad(bhsd(k), pk), pad(bhsd(v), pk), mask, qseg,
        kseg, None, d ** -0.5, causal, sk - sq, sk, bq, bk, 0.0, True)
    return np.asarray(lse)[:, :, :sq, 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_flash_oracles_match_pallas(case):
    (q, k, v, do), causal, mask, mask4, qs, ks = _inputs(case)
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a))
    tq, tk, tv = t(q), t(k), t(v)
    kw = dict(attn_mask=t(mask), q_segment_ids=t(qs), kv_segment_ids=t(ks))
    out, lse = flash_attn_reference(tq, tk, tv, causal, return_lse=True,
                                    **kw)
    ref_lse = _pallas_lse(q, k, v, causal, mask4, qs, ks)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=LSE_RTOL,
                               atol=LSE_RTOL)
    empty = lse.numpy() == np.float32(EMPTY_ROW_LSE)          # [b, hq, sq]
    assert np.array_equal(empty, ref_lse < -1e29)
    assert empty.any() == (mask is not None)

    def fwd(q_, k_, v_):
        return flash_attention_pallas(
            q_, k_, v_, causal=causal, interpret=True,
            attn_mask=None if mask4 is None else jnp.asarray(mask4),
            q_segment_ids=None if qs is None else jnp.asarray(qs),
            kv_segment_ids=None if ks is None else jnp.asarray(ks))

    pallas_out, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    seen = ~empty.transpose(0, 2, 1)[..., None]               # [b, sq, hq, 1]
    np.testing.assert_allclose(np.where(seen, out.numpy(), 0),
                               np.where(seen, np.asarray(pallas_out), 0),
                               atol=ATOL)
    assert np.all(out.numpy()[~np.broadcast_to(seen, out.shape)] == 0)

    # the port's gradients do not depend on the dout of rows that see
    # nothing; Pallas's do (through the mean of v), so compare with it 0
    do_seen = np.where(seen, do, 0).astype(np.float32)
    ours = flash_attn_bwd_reference(tq, tk, tv, out, lse, t(do), causal,
                                    **kw)
    ours_seen = flash_attn_bwd_reference(tq, tk, tv, out, lse, t(do_seen),
                                         causal, **kw)
    for g, g_seen in zip(ours, ours_seen):
        assert torch.equal(g, g_seen)
    grads = vjp(jnp.asarray(do_seen))
    for name, g, r in zip("qkv", ours, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")
    if empty.any():
        assert np.all(ours[0].numpy()[~np.broadcast_to(seen, out.shape)]
                      == 0)

    # the dispatch's operator (plain forward and backward on CPU tensors)
    # gives the same output and gradients
    ins = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    got = flash_attention(*ins, causal=causal, **kw)
    assert "flash_fwd" in type(got.grad_fn).__name__
    assert torch.equal(got.detach(), out)
    for g, r in zip(torch.autograd.grad(got, ins, t(do)), ours):
        assert torch.equal(g, r)


def test_trainable_mask_takes_the_dense_route():
    """A mask that requires grad: the plain version with autograd (counted
    in ``dense_calls``), its gradient against ``jax.grad`` through the JAX
    dense path, which the JAX dispatch takes for such a mask."""
    rng = np.random.RandomState(3)
    b, s, hq, hk = 2, 40, 4, 2
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, D), (b, s, hk, D), (b, s, hk, D)))
    bias = rng.standard_normal((b, 1, s, s)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, D)).astype(np.float32)

    def jax_loss(q_, k_, v_, m_):
        out = dense_flash_attention(q_, k_, v_, causal=True, attn_mask=m_)
        return jnp.sum(out * do)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    before = flash_mod.dense_calls
    out = flash_attention(*ins[:3], causal=True, attn_mask=ins[3])
    assert flash_mod.dense_calls == before + 1
    assert out.grad_fn is not None and "flash_fwd" not in \
        type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do))
    for name, g, r in zip(("dq", "dk", "dv", "dmask"), grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=name)
    # a mask that does not require grad takes the operator, uncounted
    flash_attention(*ins[:3], causal=True, attn_mask=ins[3].detach())
    assert flash_mod.dense_calls == before + 1


def test_mask_args_pass_broadcast_masks_by_strides():
    """The C entries read a broadcast mask by strides, never materialised:
    a 2-D mask has batch and head strides 0, a 3-D one a head stride 0, a
    bool mask is read as its own bytes; another float type is converted at
    its own size; segment ids go to int32."""
    b, sq, sk, hq, hk = 2, 6, 10, 4, 2
    q = torch.zeros(b, sq, hq, D)
    k = torch.zeros(b, sk, hk, D)
    m2 = torch.randn(sq, sk)
    ptrs, ints, keep = mask_args("t", q, k, m2)
    assert ptrs == [m2.data_ptr(), None, None]
    assert ints == [ADDITIVE_F32, 0, 0, sk]
    m3 = torch.rand(b, sq, sk) > 0.5
    ptrs, ints, keep = mask_args("t", q, k, m3)
    assert ptrs[0] == m3.data_ptr() and keep[0].dtype == torch.uint8
    assert ints == [BOOL_U8, sq * sk, 0, sk]
    m4 = torch.randn(1, hq, sq, sk).bfloat16()
    ptrs, ints, keep = mask_args("t", q, k, m4)
    assert keep[0].dtype == torch.float32 and keep[0].untyped_storage(
    ).nbytes() == 4 * hq * sq * sk
    assert ints == [ADDITIVE_F32, 0, sq * sk, sk]
    strided = torch.randn(sk, sq).t()             # columns not contiguous
    ptrs, ints, keep = mask_args("t", q, k, strided)
    assert keep[0].stride(3) == 1 and torch.equal(keep[0][0, 0], strided)
    seg = torch.zeros(b, sq, dtype=torch.int64)
    kseg = torch.zeros(b, sk, dtype=torch.int64)
    ptrs, ints, keep = mask_args("t", q, k, None, seg, kseg)
    assert ptrs[0] is None and ints == [0, 0, 0, 0]
    assert [t.dtype for t in keep] == [torch.int32, torch.int32]
    with pytest.raises(ValueError, match="broadcast"):
        mask_args("t", q, k, torch.zeros(3, sq, sk))
    with pytest.raises(ValueError, match="2-, 3- or 4-D"):
        flash_attention(q, k, k, attn_mask=torch.zeros(sk))
    with pytest.raises(ValueError, match="go together"):
        flash_attention(q, k, k, q_segment_ids=seg)
