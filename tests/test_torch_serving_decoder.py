"""The port's contiguous paged layout and ``ServingDecoder`` against the
JAX package on the CPU: ``KVCacheSpec.paged_contiguous_shape``,
``contiguous_page_table``, ``paged_cache_from_dense`` and one
``fused_multi_transformer_paged`` step by value, and the ``ServingDecoder``
step (dense and paged, f32 / int8 / int4 weights) against the JAX
``ServingDecoder.forward`` (no export), on a tiny f32 Llama (3 layers;
the paged cases at one layer, where JAX runs its Pallas kernel in
interpret mode) with JAX weights carried across by
``load_paddle_tpu_state``.

Tolerances: h, logits and caches within 1e-5 relative (and 1e-5
absolute); tokens and layouts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional.fused_transformer import (
    contiguous_page_table as jax_contiguous_page_table,
    fused_multi_transformer_paged as jax_fmt_paged,
    fused_weights_from_llama as jax_fused_weights,
    paged_cache_from_dense as jax_paged_cache_from_dense)
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.kv_cache import KVCacheSpec as JaxKVCacheSpec
from paddle_tpu.models.serving import ServingDecoder as JaxServingDecoder
from paddle_tpu.ops.fused.rope import build_rope_cache as jax_rope_cache
from paddle_tpu_torch.incubate.nn.functional import (
    contiguous_page_table, fused_multi_transformer_paged,
    fused_weights_from_llama, paged_cache_from_dense)
from paddle_tpu_torch.models import (KVCacheSpec, LlamaConfig,
                                     LlamaForCausalLM, ServingDecoder,
                                     fused_generate, load_paddle_tpu_state)
from paddle_tpu_torch.ops.fused.rope import build_rope_cache

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
HQ, HK, DH, EPS = 4, 2, 16, 1e-5
RTOL = ATOL = 1e-5


def make_pair(seed, **over):
    cfg = dict(TINY, **over)
    paddle.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**cfg))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return make_pair(41)


@pytest.fixture(scope="module")
def pair_1layer():
    return make_pair(43, num_hidden_layers=1)


def close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def prompts(seed, b=2, p=9):
    return np.random.RandomState(seed).randint(0, 128, (b, p)).astype(
        np.int32)


# --------------------------------------------------------------------------
# the contiguous paged layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch,max_len,page", [(2, 32, 8), (3, 13, 4),
                                                (1, 2048, 16)])
def test_paged_contiguous_shape_matches_jax(pair, batch, max_len, page):
    jm, tm = pair
    ours = KVCacheSpec.from_config(tm.config, page_size=page)
    ref = JaxKVCacheSpec.from_config(jm.config, page_size=page)
    assert ours.paged_contiguous_shape(batch, max_len) == \
        tuple(ref.paged_contiguous_shape(batch, max_len))


@pytest.mark.parametrize("batch,pps", [(1, 1), (3, 4), (8, 34)])
def test_contiguous_page_table_matches_jax(batch, pps):
    ours = contiguous_page_table(batch, pps)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax_contiguous_page_table(batch, pps)))
    assert ours[0, 0] == 0                   # row 0 owns block 0


@pytest.mark.parametrize("S,page,pps", [(13, 4, 5), (16, 8, 2), (7, 8, 3)])
def test_paged_cache_from_dense_matches_jax(S, page, pps):
    rng = np.random.RandomState(S)
    L, B = 2, 3
    k = rng.standard_normal((L, B, S, HK, DH)).astype(np.float32)
    v = rng.standard_normal((L, B, S, HK, DH)).astype(np.float32)
    kp, vp = paged_cache_from_dense(torch.from_numpy(k), torch.from_numpy(v),
                                    page, pps)
    jkp, jvp = jax_paged_cache_from_dense(jnp.asarray(k), jnp.asarray(v),
                                          page, pps)
    assert kp.shape == (L, HK, B * pps, page, DH)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jvp))
    with pytest.raises(ValueError, match="do not fit"):
        paged_cache_from_dense(torch.from_numpy(k), torch.from_numpy(v),
                               page, (S - 1) // page)


@pytest.mark.parametrize("quantize,index", [(False, 11), ("int8", 8),
                                            ("int4", 0)])
def test_fused_multi_transformer_paged_step_matches_jax(pair_1layer,
                                                        quantize, index):
    """One step at one layer (JAX's Pallas kernel in interpret mode) at
    ``index`` tokens a row: h and both page buffers, where the step's k/v
    land at (index // page, index % page) of every row's pages."""
    jm, tm = pair_1layer
    rng = np.random.RandomState(index + 1)
    B, page, pps = 3, 4, 4
    kp = np.zeros((1, HK, B * pps, page, DH), np.float32)
    vp = np.zeros_like(kp)
    hist = rng.standard_normal((2, 1, HK, B, pps * page, DH))
    hist[..., index:, :] = 0
    kp[:] = hist[0].reshape(kp.shape)
    vp[:] = hist[1].reshape(vp.shape)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    cos, sin = build_rope_cache(32, DH)
    jcos, jsin = jax_rope_cache(32, DH)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    h, nk, nv = fused_multi_transformer_paged(
        torch.from_numpy(x), fused_weights_from_llama(tm, quantize=quantize),
        tkp, tvp, index, cos[index:index + 1], sin[index:index + 1], HQ, HK,
        EPS)
    assert nk is tkp and nv is tvp           # written in place
    jh, jk, jv = jax_fmt_paged(
        jnp.asarray(x), jax_fused_weights(jm, quantize=quantize),
        jnp.asarray(kp), jnp.asarray(vp), index, jcos[index:index + 1],
        jsin[index:index + 1], HQ, HK, EPS, interpret=True)
    close(h.numpy(), jh)
    close(nk.numpy(), jk)
    close(nv.numpy(), jv)
    slot = nk.numpy().reshape(1, HK, B, pps * page, DH)[..., index, :]
    assert (np.abs(slot).max(axis=-1) > 0).all()    # every row written
    with pytest.raises(ValueError, match="decode-only"):
        fused_multi_transformer_paged(
            torch.zeros((B, 2, 64)), fused_weights_from_llama(tm), tkp, tvp,
            index, cos[:2], sin[:2], HQ, HK, EPS)


# --------------------------------------------------------------------------
# ServingDecoder
# --------------------------------------------------------------------------

def run_dense(dec, ids, steps, max_len, jax=False):
    """A prefill span, then ``steps`` greedy decode steps of a 3-layer
    decoder; returns the logits of every call and the final caches as
    numpy."""
    B, P = ids.shape
    shape = (3, B, max_len, HK, DH)
    if jax:
        ck = cv = jnp.zeros(shape, jnp.float32)
        to_np = lambda t: np.asarray(t.numpy())  # noqa: E731
    else:
        ck, cv = torch.zeros(shape), torch.zeros(shape)
        to_np = lambda t: t.numpy()  # noqa: E731
    logits, ck, cv = dec(paddle.to_tensor(ids) if jax
                         else torch.from_numpy(ids), ck, cv, np.int32(0))
    out = [to_np(logits)]
    for i in range(steps):
        tok = out[-1].argmax(-1).astype(np.int32)[:, None]
        logits, ck, cv = dec(paddle.to_tensor(tok) if jax
                             else torch.from_numpy(tok), ck, cv,
                             np.int32(P + i))
        out.append(to_np(logits))
    return out, to_np(ck), to_np(cv)


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_serving_decoder_dense_matches_jax(pair, quantize):
    jm, tm = pair
    ids = prompts(1)
    ours = run_dense(ServingDecoder(tm, quantize=quantize, max_len=32), ids,
                     4, 24)
    ref = run_dense(JaxServingDecoder(jm, quantize=quantize, max_len=32),
                    ids, 4, 24, jax=True)
    for a, r in zip(ours[0], ref[0]):
        assert a.shape == (2, 128) and a.dtype == np.float32
        close(a, r)
    close(ours[1], ref[1])
    close(ours[2], ref[2])


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_serving_decoder_paged_matches_jax(pair_1layer, quantize):
    """The paged decoder steps the pages a dense prefill packed: logits and
    pages against JAX's paged decoder (interpret mode) at one layer."""
    jm, tm = pair_1layer
    ids = prompts(2, 2, 6)
    B, P, max_len, page = 2, 6, 16, 4
    pps = max_len // page
    dense = ServingDecoder(tm, quantize=quantize, max_len=max_len)
    ck, cv = KVCacheSpec.from_config(tm.config).alloc_dense(B, max_len,
                                                            "cpu")
    logits, ck, cv = dense(torch.from_numpy(ids), ck, cv, 0)
    kp, vp = paged_cache_from_dense(ck, cv, page, pps)
    jkp, jvp = jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy())
    ours = ServingDecoder(tm, quantize=quantize, paged=True, page_size=page,
                          max_len=max_len)
    ref = JaxServingDecoder(jm, quantize=quantize, paged=True,
                            page_size=page, max_len=max_len, interpret=True)
    tok = logits.argmax(-1)[:, None]
    for i in range(3):
        lo, kp, vp = ours(tok, kp, vp, P + i)
        lr, jkp, jvp = ref(paddle.to_tensor(tok.numpy().astype(np.int32)),
                           jkp, jvp, np.int32(P + i))
        close(lo.numpy(), lr.numpy())
        close(kp.numpy(), jkp.numpy())
        close(vp.numpy(), jvp.numpy())
        jkp, jvp = jkp._data, jvp._data
        tok = lo.argmax(-1)[:, None]
    with pytest.raises(ValueError, match="decode-only"):
        ours(torch.from_numpy(ids), kp, vp, 0)


@pytest.mark.parametrize("quantize,paged", [(False, False), ("int8", False),
                                            ("int4", False), (False, True),
                                            ("int8", True)])
def test_stepping_the_decoder_equals_fused_generate(pair, quantize, paged):
    """A dense prefill span, then decode steps (paged: over the packed
    pages): the same tokens as ``fused_generate`` in the same mode, and
    the same logits bit for bit."""
    _, tm = pair
    ids = prompts(3)
    B, P, N, page = 2, 9, 6, 4
    T = P + N
    want = fused_generate(tm, ids, max_new_tokens=N, quantize=quantize,
                          paged=paged, page_size=page)
    dense = ServingDecoder(tm, quantize=quantize, max_len=64)
    step = ServingDecoder(tm, quantize=quantize, paged=True, page_size=page,
                          max_len=64) if paged else dense
    ck, cv = KVCacheSpec.from_config(tm.config).alloc_dense(B, T, "cpu")
    logits, ck, cv = dense(ids, ck, cv, 0)
    if paged:
        ck, cv = paged_cache_from_dense(ck, cv, page, -(-T // page))
    toks = [logits.argmax(-1)]
    for i in range(N - 1):
        logits, ck, cv = step(toks[-1][:, None], ck, cv, P + i)
        toks.append(logits.argmax(-1))
    got = torch.cat([torch.from_numpy(ids).long(),
                     torch.stack(toks, dim=1)], dim=1)
    assert torch.equal(got, want)


def test_tied_model_is_refused():
    tm = LlamaForCausalLM(LlamaConfig(**dict(TINY, tie_word_embeddings=True)),
                          device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        fused_generate(tm, prompts(4), max_new_tokens=2)
    with pytest.raises(ValueError, match="lm_head"):
        ServingDecoder(tm)
    # the layer-by-layer path takes the tied head
    assert tm.generate(prompts(4), max_new_tokens=2).shape == (2, 11)


def test_decoder_state_is_buffers_on_the_model_device(pair):
    _, tm = pair
    dec = ServingDecoder(tm, quantize="int4", max_len=40)
    names = dict(dec.named_buffers())
    assert not list(dec.parameters())
    for name in ("w_qkv_w", "w_qkv_scale", "w_ffn2_w", "embed",
                 "final_norm", "head", "rope_cos", "rope_sin"):
        assert names[name].device == tm.device, name
    assert names["w_qkv_w"].dtype == torch.int8
    assert names["head"].shape == (64, 128)
    assert names["head"].dtype == torch.float32
    assert names["rope_cos"].shape == (40, DH)
    with pytest.raises(ValueError, match="rope table"):
        dec(prompts(5), *KVCacheSpec.from_config(tm.config).alloc_dense(
            2, 48, "cpu"), 35)
