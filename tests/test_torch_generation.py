"""The port's decoding entry points against the JAX package on the CPU: the
Llama's cached path (``LlamaModel.forward(kv_caches=...)``, ``KVCache``),
``generate``, ``sample_logits`` and ``fused_generate`` (dense in f32, int8
and int4; paged), on a tiny f32 Llama (3 layers, width 64, 4 / 2 heads,
vocab 128) whose JAX weights reach the port through
``load_paddle_tpu_state``.

Tolerances: hidden states, logits and caches within 1e-5 relative (and
1e-5 absolute, for values near 0); tokens equal. Sampling: the same
support and a total-variation distance below 0.06 between 4000 JAX and
4000 port draws a row (two samples of one distribution over at most 6
tokens lie ~0.02 apart on average, sd ~0.008). The paged route is held
to JAX's paged route at one layer (its Pallas kernel in interpret mode)
and to JAX's dense route at 3 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.generation import fused_generate as jax_fused_generate
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.models.generation import sample_logits as jax_sample_logits
from paddle_tpu.models.llama import KVCache as JaxKVCache
from paddle_tpu_torch.core.device import make_generator
from paddle_tpu_torch.incubate.nn.functional import fused_weights_from_llama
from paddle_tpu_torch.models import (KVCache, KVCacheSpec, LlamaConfig,
                                     LlamaForCausalLM, fused_generate,
                                     generate, load_paddle_tpu_state,
                                     sample_logits)
from paddle_tpu_torch.models.generation import release_fused_weights

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
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
    return make_pair(31)


@pytest.fixture(scope="module")
def pair_1layer():
    return make_pair(33, num_hidden_layers=1)


def prompts(seed, b=2, p=7):
    return np.random.RandomState(seed).randint(0, 128, (b, p)).astype(
        np.int32)


def jax_ids(out):
    return np.asarray(out.numpy()).astype(np.int64)


def close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the cached path of the model
# --------------------------------------------------------------------------

def test_cached_model_matches_jax(pair):
    """Prefill at index 0, then two decode steps: the normed hidden states,
    the model-dtype logits and every layer's cache against JAX's."""
    jm, tm = pair
    ids = prompts(1)
    B, P, T = 2, ids.shape[1], 12
    L, kvh, dh = 3, 2, 16
    spec = KVCacheSpec.from_config(tm.config)
    k, v = spec.alloc_dense(B, T, "cpu")
    caches = [KVCache(k[i], v[i]) for i in range(L)]
    jcaches = [JaxKVCache(JaxTensor(jnp.zeros((B, T, kvh, dh))),
                          JaxTensor(jnp.zeros((B, T, kvh, dh))))
               for _ in range(L)]
    steps = [(ids, 0), (ids[:, -1:], P), (ids[:, :1], P + 1)]
    with torch.no_grad():
        for tokens, index in steps:
            h, caches = tm.model(torch.from_numpy(tokens), kv_caches=caches,
                                 cache_index=index, position_offset=index)
            hn = tm.model.norm(h)
            jh, jcaches = jm.model(paddle.to_tensor(tokens),
                                   kv_caches=jcaches, cache_index=index,
                                   position_offset=index)
            close(hn.numpy(), jh.numpy())
            close(tm.logits(hn).numpy(), jm.logits(jh).numpy())
            for c, jc in zip(caches, jcaches):
                close(c.k.numpy(), jc.k.numpy())
                close(c.v.numpy(), jc.v.numpy())
                assert c.length == jc.length
    # the stacked buffer is the caches' storage: every layer wrote into it
    assert all(c.k.data_ptr() == k[i].data_ptr()
               for i, c in enumerate(caches))
    assert int((k.abs().sum(dim=(0, 1, 3, 4)) > 0).sum()) == P + 2


def test_cached_model_refusals(pair):
    _, tm = pair
    spec = KVCacheSpec.from_config(tm.config)
    k, v = spec.alloc_dense(1, 8, "cpu")
    caches = [KVCache(k[i], v[i]) for i in range(3)]
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="segment_ids"):
        tm.model(ids, kv_caches=caches, cache_index=0,
                 segment_ids=torch.zeros_like(ids))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.model(ids, position_offset=61)
    with pytest.raises(ValueError, match="overflow"):
        with torch.no_grad():
            tm.model(ids, kv_caches=caches, cache_index=6, position_offset=6)


def test_kv_cache_empty_follows_the_device():
    c = KVCache.empty(2, 8, 2, 16, dtype=torch.float32, device="cpu")
    assert c.k.shape == (2, 8, 2, 16) and c.length == 0
    assert c.k.data_ptr() != c.v.data_ptr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            KVCache.empty(2, 8, 2, 16)


# --------------------------------------------------------------------------
# generate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,b,p,n", [(2, 2, 7, 6), (3, 3, 1, 5),
                                        (4, 1, 20, 9)])
def test_generate_greedy_matches_jax(pair, seed, b, p, n):
    jm, tm = pair
    ids = prompts(seed, b, p)
    ours = tm.generate(ids, max_new_tokens=n)
    ref = jax_ids(jm.generate(paddle.to_tensor(ids), max_new_tokens=n))
    assert ours.dtype == torch.long and ours.device.type == "cpu"
    assert ours.shape == (b, p + n)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("rows_equal,pad", [(False, None), (False, 5),
                                            (True, None), (True, 7)])
def test_generate_eos_and_padding_match_jax(pair, rows_equal, pad):
    """eos is row 0's third greedy token: with different rows, row 0 pads
    after it and row 1 runs on; with two equal rows, both stop and the rest
    is padding."""
    jm, tm = pair
    ids = prompts(5)
    if rows_equal:
        ids[1] = ids[0]
    free = tm.generate(ids, max_new_tokens=8).numpy()
    eos = int(free[0, ids.shape[1] + 2])
    ours = tm.generate(ids, max_new_tokens=8, eos_token_id=eos,
                       pad_token_id=pad).numpy()
    ref = jax_ids(jm.generate(paddle.to_tensor(ids), max_new_tokens=8,
                              eos_token_id=eos, pad_token_id=pad))
    np.testing.assert_array_equal(ours, ref)
    fill = eos if pad is None else pad
    assert (ours[0, ids.shape[1] + 3:] == fill).all()


def test_generate_without_new_tokens_returns_the_prompt(pair):
    jm, tm = pair
    ids = prompts(6)
    for n in (0, -1):
        ours = generate(tm, ids, max_new_tokens=n).numpy()
        ref = jax_ids(jax_generate(jm, paddle.to_tensor(ids),
                                   max_new_tokens=n))
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, ids)


def test_generate_refuses_requests_past_the_positions(pair):
    jm, tm = pair
    ids = prompts(7, 1, 60)
    with pytest.raises(ValueError, match="max_position_embeddings") as ours:
        generate(tm, ids, max_new_tokens=5)
    with pytest.raises(ValueError, match="max_position_embeddings") as ref:
        jax_generate(jm, paddle.to_tensor(ids), max_new_tokens=5)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        fused_generate(tm, ids, max_new_tokens=5)


def test_generate_samples_from_the_generator(pair):
    """Sampling is reproducible from the generator's seed."""
    _, tm = pair
    ids = prompts(8)
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=10)
    a = tm.generate(ids, generator=make_generator(3, "cpu"), **kw)
    b = tm.generate(ids, generator=make_generator(3, "cpu"), **kw)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 128)).all()


# --------------------------------------------------------------------------
# sample_logits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_logits_greedy_matches_jax_with_ties(dtype):
    """Logits on a coarse grid so rows hold ties for the maximum: both pick
    the first index."""
    rng = np.random.RandomState(9)
    x = rng.randint(-4, 5, (16, 40)).astype(np.float32) / 4
    x[:, 3] = x[:, 17] = x.max() + 1            # a tie at the top everywhere
    x[::2] = rng.standard_normal((8, 40)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    ours = sample_logits(tx).numpy()
    ref = np.asarray(jax_sample_logits(jx, jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(ours, ref)
    assert (ours[1::2] == 3).all()


def test_sample_logits_narrow_filters_are_greedy():
    x = np.random.RandomState(10).standard_normal((6, 50)).astype(np.float32)
    tx = torch.from_numpy(x)
    greedy = x.argmax(axis=-1)
    for kw in (dict(top_k=1), dict(top_p=1e-6), dict(top_k=3, top_p=1e-6)):
        ours = sample_logits(tx, make_generator(1, "cpu"), do_sample=True,
                             temperature=0.7, **kw).numpy()
        ref = np.asarray(jax_sample_logits(jnp.asarray(x),
                                           jax.random.PRNGKey(1), True, 0.7,
                                           **kw))
        np.testing.assert_array_equal(ours, greedy)
        np.testing.assert_array_equal(ref, greedy)


def test_sample_logits_top_k_past_the_vocabulary():
    """top_k above the vocabulary keeps every token: the same draws as no
    top_k from the same generator state."""
    x = torch.from_numpy(np.random.RandomState(11).standard_normal(
        (4, 20)).astype(np.float32))
    a = sample_logits(x, make_generator(2, "cpu"), do_sample=True, top_k=500)
    b = sample_logits(x, make_generator(2, "cpu"), do_sample=True)
    assert torch.equal(a, b)
    ref = jax_sample_logits(jnp.asarray(x.numpy()), jax.random.PRNGKey(2),
                            True, top_k=500)
    assert ref.shape == (4,)


def _filtered_probs(x, temperature, top_k, top_p):
    """The distribution the filters leave, in float64 numpy."""
    z = x.astype(np.float64) / temperature
    kth = np.sort(z, axis=-1)[:, -top_k][:, None]
    z = np.where(z < kth, -np.inf, z)
    srt = -np.sort(-z, axis=-1)
    p = np.exp(srt - srt[:, :1])
    p /= p.sum(-1, keepdims=True)
    keep = np.maximum(((np.cumsum(p, -1) - p) < top_p).sum(-1), 1)
    cut = np.take_along_axis(srt, keep[:, None] - 1, -1)
    z = np.where(z < cut, -np.inf, z)
    q = np.exp(z - z.max(-1, keepdims=True))
    return q / q.sum(-1, keepdims=True)


def test_sample_logits_draws_match_jax_in_distribution():
    x = (1.2 * np.random.RandomState(12).standard_normal((2, 32))).astype(
        np.float32)
    kw = dict(temperature=0.7, top_k=6, top_p=0.9)
    exact = _filtered_probs(x, **kw)
    support = [set(np.flatnonzero(row)) for row in exact]
    # the test's own premise: every kept token is likely enough to be drawn
    assert min(exact[exact > 0]) > 0.01
    n = 4000
    ours = sample_logits(torch.from_numpy(np.repeat(x, n, axis=0)),
                         make_generator(4, "cpu"), do_sample=True,
                         **kw).numpy().reshape(2, n)
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    ref = np.asarray(jax.vmap(lambda key: jax_sample_logits(
        jnp.asarray(x), key, True, **kw))(keys)).T         # [2, n]
    for row in range(2):
        assert set(np.unique(ours[row])) == support[row]
        assert set(np.unique(ref[row])) == support[row]
        po = np.bincount(ours[row], minlength=32) / n
        pr = np.bincount(ref[row], minlength=32) / n
        tv = 0.5 * np.abs(po - pr).sum()
        assert tv < 0.06, (row, tv)


# --------------------------------------------------------------------------
# fused_generate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, "int8", "int4", True])
def test_fused_generate_dense_matches_jax(pair, quantize):
    jm, tm = pair
    ids = prompts(13)
    ours = fused_generate(tm, ids, max_new_tokens=7, quantize=quantize)
    ref = jax_ids(jax_fused_generate(jm, paddle.to_tensor(ids),
                                     max_new_tokens=7, quantize=quantize))
    assert ours.shape == (2, 14)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_fused_generate_one_token_is_the_prefill(pair):
    jm, tm = pair
    ids = prompts(14)
    for n in (0, 1):
        ours = fused_generate(tm, ids, max_new_tokens=n).numpy()
        ref = jax_ids(jax_fused_generate(jm, paddle.to_tensor(ids),
                                         max_new_tokens=n))
        assert ours.shape == (2, 8)
        np.testing.assert_array_equal(ours, ref)


def test_fused_generate_paged_matches_jax_paged_route(pair_1layer):
    """One layer: JAX's paged route runs its Pallas kernel in interpret
    mode. The prompt ends off a page edge and the decode crosses one."""
    jm, tm = pair_1layer
    ids = prompts(15, 2, 6)
    ours = fused_generate(tm, ids, max_new_tokens=5, paged=True,
                          page_size=8)
    ref = jax_ids(jax_fused_generate(jm, paddle.to_tensor(ids),
                                     max_new_tokens=5, paged=True,
                                     page_size=8, paged_interpret=True))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("quantize,page", [(False, 8), ("int8", 4),
                                           ("int4", 16)])
def test_fused_generate_paged_matches_jax_dense_route(pair, quantize, page):
    jm, tm = pair
    ids = prompts(16, 2, 9)
    ours = fused_generate(tm, ids, max_new_tokens=8, quantize=quantize,
                          paged=True, page_size=page)
    ref = jax_ids(jax_fused_generate(jm, paddle.to_tensor(ids),
                                     max_new_tokens=8, quantize=quantize))
    np.testing.assert_array_equal(ours.numpy(), ref)
    dense = fused_generate(tm, ids, max_new_tokens=8, quantize=quantize)
    assert torch.equal(ours, dense)


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_fused_generate_restacks_after_an_in_place_update(quantize):
    """An optimizer writes parameters in place (same tensor, same address):
    the cached stack must be rebuilt, and the tokens equal a fresh model's
    with the updated weights."""
    _, tm = make_pair(35)
    ids = prompts(17)
    before = fused_generate(tm, ids, max_new_tokens=6, quantize=quantize)
    stale = tm._fused_generate_weights[str(quantize)][1]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.model.layers.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    after = fused_generate(tm, ids, max_new_tokens=6, quantize=quantize)
    fresh = LlamaForCausalLM(tm.config, device="cpu")
    fresh.load_state_dict(tm.state_dict())
    np.testing.assert_array_equal(
        after.numpy(),
        fused_generate(fresh, ids, max_new_tokens=6,
                       quantize=quantize).numpy())
    restacked = tm._fused_generate_weights[str(quantize)][1]
    assert restacked is not stale
    want = fused_weights_from_llama(tm, quantize=quantize)
    assert torch.equal(restacked.qkv_w, want.qkv_w)
    assert not torch.equal(stale.qkv_w, want.qkv_w)
    assert not torch.equal(before, after)
    # untouched parameters: the stack is reused
    fused_generate(tm, ids, max_new_tokens=2, quantize=quantize)
    assert tm._fused_generate_weights[str(quantize)][1] is restacked


def test_release_fused_weights_drops_every_cached_stack(pair):
    """``release_fused_weights`` frees the model's stacks (one a mode); the
    next call stacks again and decodes the same tokens."""
    _, tm = pair
    release_fused_weights(tm)
    ids = prompts(19)
    want = {q: fused_generate(tm, ids, max_new_tokens=4, quantize=q)
            for q in (False, "int8")}
    assert set(tm._fused_generate_weights) == {"False", "int8"}
    release_fused_weights(tm)
    assert not hasattr(tm, "_fused_generate_weights")
    release_fused_weights(tm)            # nothing cached: a no-op
    for q, toks in want.items():
        assert torch.equal(fused_generate(tm, ids, max_new_tokens=4,
                                          quantize=q), toks)
    assert set(tm._fused_generate_weights) == {"False", "int8"}


def test_entry_points_follow_the_model_device(pair):
    _, tm = pair
    ids = torch.from_numpy(prompts(18))
    for out in (generate(tm, ids, max_new_tokens=2),
                fused_generate(tm, ids, max_new_tokens=2),
                fused_generate(tm, ids, max_new_tokens=2, paged=True,
                               page_size=4)):
        assert out.device == tm.device and out.dtype == torch.long
