"""The port's quantized serving pieces against the JAX package, on the CPU.

Seeded numpy inputs go through the JAX function and the port's plain
PyTorch version (what a CPU tensor takes). Tolerances: weight and KV
quantization, int4 packing and the quantized fused weights are bit-equal;
the weight-only products against the Pallas kernels in interpret mode (and
the JAX plain branch) within 1e-5 of the output's largest magnitude in f32
(f32 sums in another order) and within one bf16 ulp in bf16; the int8 paged
attention within 1e-5 absolute on out and 1e-5 relative on (m, l).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional.fused_transformer import (
    fused_weights_from_llama as jax_fused_weights)
from paddle_tpu.models import KVCacheSpec as JaxKVCacheSpec
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.kv_cache import dequantize_kv as jax_dequantize_kv
from paddle_tpu.models.kv_cache import quantize_kv as jax_quantize_kv
from paddle_tpu.ops.pallas.int8_matmul import (
    int4_weight_matmul as jax_int4_matmul,
    int8_weight_matmul as jax_int8_matmul, pack_int4 as jax_pack_int4,
    unpack_int4_packed as jax_unpack_int4)
from paddle_tpu.ops.pallas.paged_attention import paged_attention_pallas
from paddle_tpu.ops.quant_ops import weight_quantize as jax_weight_quantize
from paddle_tpu_torch.incubate.nn.functional import fused_weights_from_llama
from paddle_tpu_torch.models import (KVCacheSpec, LlamaConfig,
                                     LlamaForCausalLM, load_paddle_tpu_state)
from paddle_tpu_torch.models.kv_cache import dequantize_kv, quantize_kv
from paddle_tpu_torch.ops.cuda.int8_matmul import (
    int4_weight_matmul, int4_weight_matmul_reference, int8_weight_matmul,
    int8_weight_matmul_reference, kernel_takes, pack_int4,
    unpack_int4_packed)
from paddle_tpu_torch.ops.cuda.paged_attention import (
    paged_attention, paged_attention_reference)
from paddle_tpu_torch.ops.quant_ops import weight_dequantize, weight_quantize

torch.set_num_threads(2)

ALGOS = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
QMAX = {"int8": 127.0, "int4": 7.0}


def _weights_with_ties(kind, rows=64, cols=24, seed=0):
    """A [rows, cols] f32 weight with a zero column and a column whose
    values land exactly on .5 after the division by its scale."""
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    q = QMAX[kind]
    w[:, 5] = 0.0
    w[:6, 5] = [q, 0.5, 1.5, 2.5, -2.5, -0.5]   # scale 1: ties at .5
    return w


@pytest.mark.parametrize("kind", sorted(ALGOS))
def test_weight_quantize_bit_equal(kind):
    w = _weights_with_ties(kind)
    q, s = weight_quantize(torch.from_numpy(w), ALGOS[kind])
    jq, js = jax_weight_quantize.raw_fn(jnp.asarray(w), algo=ALGOS[kind])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert (q[:, 3] == 0).all() and s[3] == 0
    # round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
    assert q[1:6, 5].tolist() == [0, 2, 2, -2, 0]
    deq = weight_dequantize(q, s, torch.float32)
    np.testing.assert_array_equal(deq.numpy(), q.numpy() * s.numpy())


def test_pack_int4_bit_equal_and_roundtrip():
    rng = np.random.RandomState(1)
    q = rng.randint(-7, 8, (64, 40)).astype(np.int8)
    packed = pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_pack_int4(jnp.asarray(q))))
    assert packed.shape == (32, 40) and packed.dtype == torch.int8
    np.testing.assert_array_equal(unpack_int4_packed(packed).numpy(), q)
    np.testing.assert_array_equal(
        unpack_int4_packed(packed).numpy(),
        np.asarray(jax_unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((3, 5, 2, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # eps floor
    x[1, 2, 1] = 0.0
    x[1, 2, 1, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    q, s = quantize_kv(tx)
    jq, js = jax_quantize_kv(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[1, 2, 1, 1:6].tolist() == [0, 2, 2, -2, 0]
    for out in ("float32", "bfloat16"):
        ours = dequantize_kv(q, s, getattr(torch, out)).float().numpy()
        ref = np.asarray(jax_dequantize_kv(jq, js, getattr(jnp, out)),
                         np.float32)
        np.testing.assert_array_equal(ours, ref)


QTINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [True, "int8", "int4"])
def test_fused_weights_quantized_bit_equal(quantize, dtype):
    paddle.seed(7)
    jm = JaxLlama(JaxLlamaConfig(**QTINY, dtype=dtype))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**QTINY, dtype=dtype), device="cpu")
    # bf16 -> f32 numpy is exact; the port's bf16 parameters round back
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy()).astype(np.float32)
                               for k, v in jm.state_dict().items()})
    ours = fused_weights_from_llama(tm, quantize=quantize)
    ref = jax_fused_weights(jm, quantize=quantize)
    assert ours.quantized and ref.quantized
    for name in ("qkv_w", "out_w", "ffn1_w", "ffn2_w", "qkv_scale",
                 "out_scale", "ffn1_scale", "ffn2_scale"):
        a, b = getattr(ours, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    for name in ("ln_scale", "ffn_ln_scale"):
        np.testing.assert_array_equal(
            getattr(ours, name).float().numpy(),
            np.asarray(getattr(ref, name), np.float32), err_msg=name)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


# (m, K, N): two shapes on the kernel branch, one on JAX's plain branch
MATMUL_SHAPES = [(8, 256, 384), (200, 512, 256), (300, 256, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(ALGOS))
@pytest.mark.parametrize("m,K,N", MATMUL_SHAPES)
def test_weight_only_matmul_matches_pallas(m, K, N, kind, dtype):
    rng = np.random.RandomState(m + K + N)
    x = rng.standard_normal((m, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    int4 = kind == "int4"
    tq, ts = weight_quantize(torch.from_numpy(w), ALGOS[kind])
    tw = pack_int4(tq) if int4 else tq
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    plain = int4_weight_matmul_reference if int4 \
        else int8_weight_matmul_reference
    ours = plain(tx, tw, ts)
    wrapper = int4_weight_matmul if int4 else int8_weight_matmul
    np.testing.assert_array_equal(wrapper(tx, tw, ts).float().numpy(),
                                  ours.float().numpy())
    assert ours.dtype == tx.dtype
    assert kernel_takes(m, K, N, int4) == (m <= 256)
    jfn = jax_int4_matmul if int4 else jax_int8_matmul
    ref = np.asarray(jfn(jx, jnp.asarray(tw.numpy()), jnp.asarray(ts.numpy()),
                         interpret=True), np.float32)
    got = ours.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), \
            np.abs(got - ref).max()


# (group h/kvh, kvh): GQA 4/2 and MHA; d = 128; lens: empty, one token, not
# a page multiple, a full row
PAGED_INT8 = {"gqa": (2, 2), "mha": (1, 4)}
PAGE, PPS, NUM_PAGES, D = 16, 4, 20, 128
LENS = [0, 1, 37, 64]


def _int8_paged_inputs(group, kvh, seed=11):
    rng = np.random.RandomState(seed)
    b, h = len(LENS), group * kvh
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    kf = rng.standard_normal((kvh, NUM_PAGES, PAGE, D)).astype(np.float32)
    vf = rng.standard_normal((kvh, NUM_PAGES, PAGE, D)).astype(np.float32)
    kq, ks = quantize_kv(torch.from_numpy(kf))
    vq, vs = quantize_kv(torch.from_numpy(vf))
    # block-major scales [P, kvh, page]
    ks, vs = ks.transpose(0, 1).contiguous(), vs.transpose(0, 1).contiguous()
    table = np.zeros((b, PPS), np.int32)
    ids = rng.permutation(np.arange(1, NUM_PAGES))
    for i, n in enumerate(LENS):
        used = -(-n // PAGE)
        table[i, :used] = ids[:used]
        ids = ids[used:]
    return (torch.from_numpy(q), kq, vq, torch.from_numpy(table),
            torch.from_numpy(np.asarray(LENS, np.int32)), ks, vs)


@pytest.mark.parametrize("return_stats", [True, False])
@pytest.mark.parametrize("seq_grid", [False, True])
@pytest.mark.parametrize("case", sorted(PAGED_INT8))
def test_int8_paged_reference_matches_pallas(case, seq_grid, return_stats):
    q, kq, vq, table, lens, ks, vs = _int8_paged_inputs(*PAGED_INT8[case])
    ours = paged_attention_reference(q, kq, vq, table, lens,
                                     return_stats=return_stats, k_scales=ks,
                                     v_scales=vs)
    via = paged_attention(q, kq, vq, table, lens, return_stats=return_stats,
                          k_scales=ks, v_scales=vs)
    ours = ours if return_stats else (ours,)
    via = via if return_stats else (via,)
    for a, b in zip(via, ours):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = paged_attention_pallas(j(q), j(kq), j(vq), j(table), j(lens),
                                 interpret=True, return_stats=return_stats,
                                 seq_grid=seq_grid, k_scales=j(ks),
                                 v_scales=j(vs))
    ref = ref if return_stats else (ref,)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               atol=1e-5)
    empty = lens.numpy() == 0
    assert np.all(ours[0].numpy()[empty] == 0)
    if return_stats:
        _, m, l = ours
        np.testing.assert_allclose(m.numpy(), np.asarray(ref[1]), rtol=1e-5)
        np.testing.assert_allclose(l.numpy(), np.asarray(ref[2]), rtol=1e-5)
        assert np.all(m.numpy()[empty] == np.float32(-1e30))
        assert np.all(l.numpy()[empty] == 0)


def test_int8_spec_matches_jax():
    kw = dict(num_layers=3, num_kv_heads=2, head_dim=32, page_size=8)
    for dtype in ("float32", "bfloat16"):
        ours = KVCacheSpec(dtype=dtype, cache_dtype="int8", **kw)
        ref = JaxKVCacheSpec(dtype=dtype, cache_dtype="int8", **kw)
        assert ours.quantized and ref.quantized
        assert ours.storage_dtype == ref.storage_dtype == "int8"
        assert ours.bytes_per_token == ref.bytes_per_token
        assert ours.bytes_per_block == ref.bytes_per_block
        assert ours.scales_shape(11) == ref.scales_shape(11)
        plain = KVCacheSpec(dtype=dtype, **kw)
        assert not plain.quantized
        assert plain.bytes_per_block == JaxKVCacheSpec(
            dtype=dtype, **kw).bytes_per_block
    k, v = ours.alloc_pool(11, "cpu")
    ks, vs = ours.alloc_scales(11, "cpu")
    assert k.dtype == v.dtype == torch.int8 and k.shape == (3, 2, 11, 8, 32)
    assert ks.shape == (3, 11, 2, 8) and bool((ks == 1).all() & (vs == 1).all())
    with pytest.raises(ValueError, match="not quantized"):
        plain.alloc_scales(4, "cpu")
