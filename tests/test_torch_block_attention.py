"""The port's Paddle inference surface against the JAX package, on the CPU:
``ops/fused/block_attention.py`` (``PagedKVCache``,
``block_multihead_attention``, ``masked_multihead_attention``) and the
``incubate.nn.functional`` building blocks.

Seeded numpy inputs go through the JAX function and the port's (the plain
versions: CPU tensors). Tolerances: the page allocator, ``quant_weights``
and the fp8 casts bit for bit; f32 attention and norms within 2e-6 (sums in
another order); bf16 attention within 2e-2 absolute (inputs in [-1, 1],
outputs rounded once to bf16 after f32 math on both sides, plus the pages'
bf16 rounding); ``weight_only_linear`` in f32 within 1e-5 of the output's
largest magnitude; in bf16 within 1e-2 of it: JAX rounds ``q * scale`` to
bf16 before a bf16 product, the kernel's plain version scales the f32
accumulator, so each weight differs by up to 2^-9 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.fused.block_attention import PagedKVCache as JPaged
from paddle_tpu.ops.fused.block_attention import (
    block_multihead_attention as jax_bma,
    masked_multihead_attention as jax_mmha)
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch.ops.cuda.int8_matmul import (
    int4_weight_matmul_reference, int8_weight_matmul_reference)
from paddle_tpu_torch.ops.fused.block_attention import (
    PagedKVCache, block_multihead_attention, masked_multihead_attention)

torch.set_num_threads(2)

F32_TOL, BF16_TOL = 2e-6, 2e-2
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x._data if isinstance(x, JTensor) else x,
                      dtype=np.float32)


def pair(a, dtype="float32"):
    """The same values as a JAX array and a port tensor of ``dtype``."""
    jd, td = DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(
        np.ascontiguousarray(a)).to(td)


def rand(rng, *shape, scale=1.0):
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


# ------------------------------------------------------------ the allocator
def test_paged_cache_allocation_exhaustion_and_free():
    kw = dict(batch=3, kv_heads=2, head_dim=8, max_seq_len=40, page_size=16,
              num_pages=7)
    jc = JPaged(**kw, dtype=jnp.float32)
    tc = PagedKVCache(**kw, dtype=torch.float32, device="cpu")

    def same():
        assert np.array_equal(np.asarray(jc.page_table), tc.page_table.numpy())
        assert np.array_equal(np.asarray(jc.page_table), tc._host_table)
        assert jc._free_pages == tc._free_pages

    for c in (jc, tc):
        c.allocate_batch({0: 17, 2: 5})
        c._host_lens[0], c._host_lens[2] = 17, 5
    same()
    for c in (jc, tc):   # 3 pages free; this needs 4: nothing changes
        with pytest.raises(RuntimeError, match="exhausted"):
            c.allocate_batch({1: 33, 2: 12})
    same()
    for c in (jc, tc):
        c.allocate_batch({1: 16, 2: 12})
        c._host_lens[1], c._host_lens[2] = 16, 17
        c.free(0)
        c.allocate(0, 3)
    same()
    assert tc._host_lens == jc._host_lens
    assert np.array_equal(np.asarray(jc.seq_lens), tc.seq_lens.numpy())


# ------------------------------------------ prefill, decode and the MMHA step
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
def test_block_attention_prefill_and_decode(h, kvh, dtype):
    rng = np.random.RandomState(h * 10 + kvh)
    b, d, T0, steps = 3, 32, 21, 4
    jd, td = DT[dtype]
    jc = JPaged(b, kvh, d, T0 + steps, page_size=16, dtype=jd)
    tc = PagedKVCache(b, kvh, d, T0 + steps, page_size=16, dtype=td,
                      device="cpu")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in [T0] + [1] * steps:
        q, k, v = (rand(rng, b, t, n, d) for n in (h, kvh, kvh))
        (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, k, v))
        jout, _ = jax_bma(jq, jk, jv, jc)
        tout, _ = block_multihead_attention(tq, tk, tv, tc)
        assert tout.shape == (b, t, h, d) and tout.dtype == td
        np.testing.assert_allclose(np_of(tout), np_of(jout), atol=tol,
                                   err_msg=f"t={t}")
    np.testing.assert_array_equal(tc.seq_lens.numpy(), np.asarray(jc.seq_lens))
    np.testing.assert_array_equal(np_of(tc.k_pages), np_of(jc.k_pages))
    np.testing.assert_array_equal(np_of(tc.v_pages), np_of(jc.v_pages))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("with_lens", [True, False])
def test_masked_multihead_attention(fused, with_lens):
    rng = np.random.RandomState(3)
    b, h, s, d = 2, 4, 11, 16
    x = rand(rng, b, 3 * h * d) if fused else rand(rng, b, h, d)
    ck, cv = rand(rng, b, h, s, d), rand(rng, b, h, s, d)
    lens = np.array([5, 11], np.int32) if with_lens else None
    jout = jax_mmha(jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                    None if lens is None else jnp.asarray(lens))
    tout = masked_multihead_attention(
        torch.from_numpy(x), torch.from_numpy(ck), torch.from_numpy(cv),
        None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(np_of(tout), np_of(jout), atol=F32_TOL)


def test_masked_mha_agrees_with_block_decode():
    """One decode step: MMHA over the dense cache (kv heads repeated to the
    query heads) equals ``block_multihead_attention`` over the pages."""
    rng = np.random.RandomState(4)
    b, h, kvh, d, P = 2, 8, 2, 16, 19
    tc = PagedKVCache(b, kvh, d, P + 1, device="cpu", dtype=torch.float32)
    k, v = (torch.from_numpy(rand(rng, b, P + 1, kvh, d)) for _ in range(2))
    q = torch.from_numpy(rand(rng, b, P + 1, h, d))
    block_multihead_attention(q[:, :P], k[:, :P], v[:, :P], tc)
    out, _ = block_multihead_attention(q[:, P:], k[:, P:], v[:, P:], tc)
    def dense(t):
        return t.repeat_interleave(h // kvh, 2).transpose(1, 2)
    ref = masked_multihead_attention(q[:, P], dense(k), dense(v))
    np.testing.assert_allclose(out[:, 0].numpy(), ref.numpy(), atol=F32_TOL)


# ------------------------------------------------ the incubate building blocks
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_fused_norms(kind):
    rng = np.random.RandomState(5)
    x, res, bias = rand(rng, 3, 5, 16), rand(rng, 3, 5, 16), rand(rng, 16)
    w, nb = rand(rng, 16) + 1.5, rand(rng, 16)
    (jx, tx), (jr, tr), (jb, tb), (jw, tw), (jn, tn) = (
        pair(a) for a in (x, res, bias, w, nb))
    jfn = JF.fused_rms_norm if kind == "rms" else JF.fused_layer_norm
    tfn = TF.fused_rms_norm if kind == "rms" else TF.fused_layer_norm
    jo, jres = jfn(JTensor(jx), JTensor(jw), JTensor(jn), 1e-5, bias=jb,
                   residual=jr)
    to, tres = tfn(tx, tw, tn, 1e-5, bias=tb, residual=tr)
    np.testing.assert_allclose(np_of(to), np_of(jo), atol=F32_TOL)
    np.testing.assert_allclose(np_of(tres), np_of(jres), atol=F32_TOL)
    np.testing.assert_allclose(np_of(tfn(tx, tw)), np_of(jfn(JTensor(jx),
                               JTensor(jw))), atol=F32_TOL)
    if kind == "layer":   # normalised over the last two axes
        np.testing.assert_allclose(
            np_of(tfn(tx, begin_norm_axis=1)),
            np_of(jfn(JTensor(jx), begin_norm_axis=1)), atol=F32_TOL)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swiglu"])
def test_swiglu_and_bias_act(act):
    rng = np.random.RandomState(6)
    x, y, bias = rand(rng, 4, 12, scale=3), rand(rng, 4, 12), rand(rng, 12)
    (jx, tx), (jy, ty), (jb, tb) = (pair(a) for a in (x, y, bias))
    np.testing.assert_allclose(
        np_of(TF.fused_bias_act(tx, tb, act_method=act)),
        np_of(JF.fused_bias_act(JTensor(jx), JTensor(jb), act_method=act)),
        atol=F32_TOL)
    np.testing.assert_allclose(np_of(TF.swiglu(tx, ty)),
                               np_of(JF.swiglu(JTensor(jx), JTensor(jy))),
                               atol=F32_TOL)
    np.testing.assert_allclose(np_of(TF.swiglu(tx)),
                               np_of(JF.swiglu(JTensor(jx))), atol=F32_TOL)


def test_fused_dropout_add():
    rng = np.random.RandomState(7)
    x, y = rand(rng, 64, 32), rand(rng, 64, 32)
    (jx, tx), (jy, ty) = pair(x), pair(y)
    for kw in (dict(p=0.0), dict(p=0.3, training=False),
               dict(p=0.3, training=False, mode="downscale_in_infer")):
        np.testing.assert_allclose(
            np_of(TF.fused_dropout_add(tx, ty, **kw)),
            np_of(JF.fused_dropout_add(JTensor(jx), JTensor(jy), **kw)),
            atol=F32_TOL, err_msg=str(kw))
    g = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    a = TF.fused_dropout_add(tx, ty, p=0.25, generator=g())
    assert torch.equal(a, TF.fused_dropout_add(tx, ty, p=0.25, generator=g()))
    kept = (a - ty).abs() > 0
    # kept values are x / (1 - p), dropped ones leave y; the share kept is
    # 1 - p (2048 draws: within 4 standard deviations)
    np.testing.assert_allclose((a - ty)[kept].numpy(),
                               (tx / 0.75)[kept].numpy(), atol=1e-6)
    share = kept.float().mean().item()
    assert abs(share - 0.75) < 4 * (0.75 * 0.25 / x.size) ** 0.5
    jshare = float(np.mean(np_of(JF.fused_dropout_add(
        JTensor(jx), JTensor(jy), p=0.25)) != y))
    assert abs(jshare - 0.75) < 4 * (0.75 * 0.25 / x.size) ** 0.5


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear(transpose):
    rng = np.random.RandomState(8)
    x, w, b = rand(rng, 2, 5, 12), rand(rng, 12, 7), rand(rng, 7)
    if transpose:
        w = np.ascontiguousarray(w.T)
    (jx, tx), (jw, tw), (jb, tb) = (pair(a) for a in (x, w, b))
    np.testing.assert_allclose(
        np_of(TF.fused_linear(tx, tw, tb, transpose_weight=transpose)),
        np_of(JF.fused_linear(JTensor(jx), JTensor(jw), JTensor(jb),
                              transpose_weight=transpose)), atol=F32_TOL)


def test_fused_rotary_position_embedding():
    rng = np.random.RandomState(9)
    q, k = rand(rng, 2, 10, 4, 16), rand(rng, 2, 10, 2, 16)
    (jq, tq), (jk, tk) = pair(q), pair(k)
    for out_j, out_t in zip(JF.fused_rotary_position_embedding(jq, jk),
                            TF.fused_rotary_position_embedding(tq, tk)):
        np.testing.assert_allclose(np_of(out_t), np_of(out_j), atol=F32_TOL)
    pos = np.arange(30, 40)
    np.testing.assert_allclose(
        np_of(TF.fused_rotary_position_embedding(tq, position_ids=pos)),
        np_of(JF.fused_rotary_position_embedding(jq, None, position_ids=pos)),
        atol=F32_TOL)
    cos, sin = rand(rng, 1, 10, 1, 16), rand(rng, 1, 10, 1, 16)
    (jc, tc), (js, ts) = pair(cos), pair(sin)
    np.testing.assert_allclose(
        np_of(TF.fused_rotary_position_embedding(tq, sin=ts, cos=tc)),
        np_of(JF.fused_rotary_position_embedding(jq, None, sin=js, cos=jc)),
        atol=F32_TOL)


def test_flash_attention_name():
    rng = np.random.RandomState(10)
    q, k, v = rand(rng, 2, 9, 4, 16), rand(rng, 2, 13, 2, 16), \
        rand(rng, 2, 13, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a) for a in (q, k, v))
    np.testing.assert_allclose(
        np_of(TF.flash_attention(tq, tk, tv, causal=True)),
        np_of(JF.flash_attention(JTensor(jq), JTensor(jk), JTensor(jv),
                                 causal=True)), atol=F32_TOL)
    with pytest.raises(NotImplementedError):
        TF.flash_attention(tq, tk, tv, dropout_p=0.1)


# ----------------------------------------------------------- weight-only quant
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_quant_weights_bit_for_bit(algo, dtype):
    rng = np.random.RandomState(12)
    w = rand(rng, 64, 40, scale=0.1)
    w[:, 3] = 0.0                      # a zero column: scale 1e-9
    jw, tw = pair(w, dtype)
    jq, js = JF.quant_weights(JTensor(jw), algo=algo)
    tq, ts = TF.quant_weights(tw, algo=algo)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq._data))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js._data))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdt", ["int8", "int4"])
def test_weight_only_linear(wdt, dtype):
    rng = np.random.RandomState(13)
    x, w, b = rand(rng, 3, 5, 256), rand(rng, 256, 128, scale=0.1), \
        rand(rng, 128)
    jq, js = JF.quant_weights(JTensor(jnp.asarray(w)),
                              algo=f"weight_only_{wdt}")
    tq, ts = TF.quant_weights(torch.from_numpy(w), algo=f"weight_only_{wdt}")
    (jx, tx), (jb, tb) = pair(x, dtype), pair(b, dtype)
    ref = np_of(JF.weight_only_linear(JTensor(jx), jq, JTensor(jb), js,
                                      weight_dtype=wdt))
    out = TF.weight_only_linear(tx, tq, tb, ts, weight_dtype=wdt)
    assert out.shape == (3, 5, 128) and out.dtype == DT[dtype][1]
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(np_of(out), ref,
                               atol=tol * float(np.abs(ref).max()))


def test_int4_permutation_identity_with_minus_eight():
    """JAX's row-interleaved int4 bytes are the kernel's half-split bytes
    with K permuted: the kernel's plain version on the packed weight as
    given, with x's columns permuted, equals x @ q exactly (every value
    -8 .. 7, -8 included, widens exactly to bf16)."""
    rng = np.random.RandomState(14)
    K, N = 256, 128
    q = rng.randint(-8, 8, (K, N)).astype(np.int8)
    q[:, 0] = -8
    packed = TF._pack_nibbles(torch.from_numpy(q[0::2]),
                              torch.from_numpy(q[1::2]))
    assert np.array_equal(TF._unpack_interleaved(packed).numpy(), q)
    x = torch.from_numpy(rand(rng, 4, K)).to(torch.bfloat16)
    scale = torch.ones(N)
    xp = torch.cat([x[:, 0::2], x[:, 1::2]], dim=1)
    got = int4_weight_matmul_reference(xp, packed, scale, torch.float32)
    want = int8_weight_matmul_reference(x, torch.from_numpy(q), scale,
                                        torch.float32)
    exact = x.double() @ torch.from_numpy(q).double()
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                               rtol=1e-6, atol=1e-5)


def test_fp8_gemm_and_quantize():
    rng = np.random.RandomState(15)
    x, y = rand(rng, 6, 32, scale=3), rand(rng, 32, 16, scale=2)
    (jx, tx), (jy, ty) = pair(x), pair(y)
    for sx, sy, tr in ((1.0, 1.0, False), (0.05, 0.02, True)):
        yy, jyy = (ty.t().contiguous(), jnp.asarray(y.T)) if tr else (ty, jy)
        np.testing.assert_allclose(
            np_of(TF.fp8_gemm(tx, yy, sx, sy, transpose_y=tr)),
            np_of(JF.fp8_gemm(JTensor(jx), JTensor(jyy), sx, sy,
                              transpose_y=tr)), rtol=1e-6, atol=1e-6)
    tq, ts = TF.fp8_quantize(tx)
    jq, js = JF.fp8_quantize(JTensor(jx))
    assert tq.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq._data).astype(np.float32))
    assert ts.item() == float(np.asarray(js._data))


def test_incubate_exports_every_jax_name():
    import paddle_tpu.incubate.nn.functional as jax_incubate

    missing = [n for n in jax_incubate.__all__
               if n not in TF.__all__ or not hasattr(TF, n)]
    assert not missing
