"""The flash attention's plain versions at the head dims of the mma.sync
kernels (``csrc/flash_attention_mma.cu``): 16 (``unet-tiny``), 32
(sdxl-small's level 1) and 80 (ViT-H14). The plain forward (out, lse) and
backward, the card kernels' oracles, against JAX's dense reference and its
autodiff, non-causal with sq != sk (77 text tokens, the UNet's
cross-attention) and causal with GQA, and against the Pallas ``_fwd`` and
``_bwd`` in interpret mode once per head dim; and the wrapper's head-dim
rule (every multiple of 16 up to 128 taken, the mma.sync library for all
but 64 and 128, any other d refused by name).

Tolerances, in f32: out within 2e-5 absolute and lse within 1e-5 relative
(f32 sums in another order); gradients within 1e-4 absolute (the
FlashAttention-2 formulas against autodiff of the dense softmax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused.flash_attention import _sdpa_reference
from paddle_tpu.ops.pallas import flash_attention as jax_pallas_flash
from paddle_tpu.ops.pallas.flash_attention import flash_attention_bhsd
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.fused.flash_attention import (
    flash_attn_bwd_reference, flash_attn_reference)

torch.set_num_threads(2)

ATOL = 2e-5
LSE_RTOL = 1e-5
GRAD_ATOL = 1e-4

# (b, sq, sk, hq, hk, causal)
CASES = {
    "cross_sk77": (2, 50, 77, 4, 4, False),
    "causal_gqa": (2, 70, 70, 4, 2, True),
}


def _inputs(b, sq, sk, hq, hk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, hq, d), (b, sk, hk, d), (b, sk, hk, d),
                          (b, sq, hq, d))]


def _jax_lse(q, k, causal):
    """logsumexp of the scaled, masked scores ``[b, hq, sq]`` (bottom-right
    causal), in jnp."""
    d, sq, sk = q.shape[3], q.shape[1], k.shape[1]
    kr = jnp.repeat(jnp.asarray(k), q.shape[2] // k.shape[2], axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) * d ** -0.5, kr)
    if causal:
        col, row = jnp.arange(sk), jnp.arange(sq)
        s = jnp.where(col[None, :] <= row[:, None] + (sk - sq), s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


@pytest.mark.parametrize("d", [16, 32, 80])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_reference(case, d):
    b, sq, sk, hq, hk, causal = CASES[case]
    q, k, v, do = _inputs(b, sq, sk, hq, hk, d, seed=d)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attn_reference(tq, tk, tv, causal, return_lse=True)

    def ref(q_, k_, v_):
        return _sdpa_reference(q_, k_, v_, causal, None, d ** -0.5)

    jout, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal),
                               rtol=LSE_RTOL)
    ours = flash_attn_bwd_reference(tq, tk, tv, out, lse, tdo, causal)
    for name, g, r in zip("qkv", ours, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


def _bhsd(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


# one case a head dim against the Pallas kernels: (b, sq, sk, hq, hk,
# causal, q_offset)
PALLAS_CASES = {
    16: (2, 70, 77, 4, 2, False, None),
    32: (2, 70, 83, 4, 2, True, 13),
    80: (1, 50, 77, 4, 4, False, None),
}


@pytest.mark.parametrize("d", sorted(PALLAS_CASES))
def test_plain_matches_pallas(d):
    b, sq, sk, hq, hk, causal, q_offset = PALLAS_CASES[d]
    q, k, v, do = _inputs(b, sq, sk, hq, hk, d, seed=3 * d)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=None)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attn_reference(tq, tk, tv, return_lse=True, **kw)
    # the Pallas forward's lse, padded as flash_attention_bhsd pads
    off = sk - sq if q_offset is None else q_offset
    bq, bk = jax_pallas_flash._block_sizes(sq, sk, d, causal,
                                           dtype=jnp.float32)
    pad = lambda a, n: jnp.pad(  # noqa: E731
        a, ((0, 0), (0, 0), (0, (-a.shape[2]) % n), (0, 0)))
    _, plse = jax_pallas_flash._fwd(
        pad(_bhsd(q), bq), pad(_bhsd(k), bk), pad(_bhsd(v), bk), None, None,
        None, None, d ** -0.5, causal, off, sk, bq, bk, 0.0, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(plse)[:, :, :sq, 0],
                               rtol=LSE_RTOL)

    def fwd(q_, k_, v_):
        return flash_attention_bhsd(q_, k_, v_, interpret=True, **kw)

    pout, vjp = jax.vjp(fwd, _bhsd(q), _bhsd(k), _bhsd(v))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jnp.swapaxes(pout, 1, 2)),
                               atol=ATOL)
    ours = flash_attn_bwd_reference(tq, tk, tv, out, lse, tdo, **kw)
    for name, g, r in zip("qkv", ours, vjp(_bhsd(do))):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(jnp.swapaxes(r, 1, 2)),
                                   atol=GRAD_ATOL, err_msg=f"d{name}")


def _qkv(d, hq=4, hk=2):
    return (torch.zeros(1, 3, hq, d), torch.zeros(1, 5, hk, d),
            torch.zeros(1, 5, hk, d))


def test_wrapper_takes_every_kernel_head_dim():
    """Every multiple of 16 up to 128 passes the wrapper's check; 64 and
    128 go to the wgmma sources, the rest to the mma.sync one."""
    assert fa.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for d in fa.HEAD_DIMS:
        fa._check_qkv("flash_attention_cuda", *_qkv(d))
        wgmma = d in (64, 128)
        assert fa._source(d, "wgmma", "mma") == ("wgmma" if wgmma else "mma")


@pytest.mark.parametrize("d", [24, 72, 136])
def test_wrapper_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match=r"d in \(16, 32, 48, 64, 80, 96, "
                                         r"112, 128\), got hq=4 hk=2 "
                                         rf"d={d}"):
        fa._check_qkv("flash_attention_cuda", *_qkv(d))
