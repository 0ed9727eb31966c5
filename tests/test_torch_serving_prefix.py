"""The port's shared-prefix KV cache against the JAX package on the CPU:
the port's ``ServingEngine`` with ``prefix_cache=True`` and the JAX engine
(``interpret=True``) on tiny f32 Llamas loaded through
``load_paddle_tpu_state`` give the same greedy tokens, prefill chunks and
pool prefix counters for prompts that share a prefix, share one block
only, or share nothing (f32 and int8 pools, and under self-draft
speculation); LRU eviction in a small pool is the same in both; a shared
block never changes while a sharer decodes; ``pool.evict_fail`` and
``pool.bind_oom`` leave a ``BlockPool`` as it was before ``admit``, and
the engine contains them as backpressure.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import faults as jax_faults
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.core import faults
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.kv_cache import KVCacheSpec
from paddle_tpu_torch.serving import BlockPool, ServingConfig, ServingEngine

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
BS = 8
POOL_KEYS = ("prefix_queries", "prefix_hit_blocks", "prefix_miss_blocks",
             "prefix_saved_tokens", "cache_evictions", "cached_blocks",
             "evictable_blocks", "free_blocks", "blocks_in_use")


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(seed=5):
    """A 24-token (3-block) shared prefix with tails of 3, 9 and 20
    tokens; a prompt sharing only the first block; one sharing nothing."""
    rng = np.random.RandomState(seed)
    tok = lambda n: rng.randint(0, 256, (n,)).astype(np.int32)  # noqa: E731
    shared = tok(3 * BS)
    return [np.concatenate([shared, tok(n)]) for n in (3, 9, 20)] + [
        np.concatenate([shared[:BS], tok(2 * BS + 5)]), tok(30)]


def _serve(engine, prompts, new, first_alone=True):
    """The first prompt alone (it publishes its blocks), then the rest."""
    reqs = [engine.submit(prompts[0], new, rid="r0")]
    if first_alone:
        engine.run_until_complete()
    reqs += [engine.submit(p, new, rid=f"r{i}")
             for i, p in enumerate(prompts[1:], 1)]
    engine.run_until_complete()
    return reqs


def _engines(models, spec=False, **kw):
    jm, tm = models
    base = dict(max_seq_len=64, block_size=BS, prefill_buckets=(16,),
                max_batch=4, prefill_token_budget=16, **kw)
    return (JaxServingEngine(jm, JaxServingConfig(
                interpret=True, prefix_cache=True,
                speculative=(jm, 3) if spec else None, **base)),
            ServingEngine(tm, ServingConfig(
                prefix_cache=True, speculative=(tm, 3) if spec else None,
                **base)))


def _same(ref, ours, jeng, eng):
    for r, o in zip(ref, ours):
        assert o.status == r.status == "finished"
        assert o.tokens == r.tokens, (o.rid, o.tokens, r.tokens)
        assert o.prefill_chunks == r.prefill_chunks
        assert o.preemptions == r.preemptions
    jp, p = jeng.pool.stats(), eng.pool.stats()
    assert {k: p[k] for k in POOL_KEYS} == {k: jp[k] for k in POOL_KEYS}


@pytest.mark.parametrize("kv,spec", [("", False), ("int8", False),
                                     ("", True)])
def test_shared_prefix_matches_jax(models, kv, spec):
    jeng, eng = _engines(models, spec=spec, kv_cache_dtype=kv)
    prompts = _prompts()
    ours = _serve(eng, prompts, 6)
    _same(_serve(jeng, prompts, 6), ours, jeng, eng)
    # the router's read-only probe: JAX's keys and answers, nothing moves
    before = eng.pool.stats()
    for q in prompts:
        keys = eng.pool._chain_keys(q, len(q) // BS)
        assert keys == jeng.pool._chain_keys(q, len(q) // BS)
        assert eng.prefix_chain_hits(keys) == jeng.prefix_chain_hits(keys)
    assert eng.prefix_chain_hits(eng.pool._chain_keys(prompts[1], 3)) == 3
    assert eng.pool.stats() == before
    s = eng.stats()
    # r1, r2: the 3 shared blocks; r3: one; r4: none (r0 found none)
    assert s["pool"]["prefix_hit_blocks"] == 3 + 3 + 1
    assert s["pool"]["prefix_saved_tokens"] == 7 * BS
    assert s["prefill_carry_chunks"] >= 3
    # a hit starts its prefill after the shared blocks: one chunk for r1
    assert ours[1].prefill_chunks == 1
    # the tokens do not depend on the cache
    off = ServingEngine(models[1], ServingConfig(
        max_seq_len=64, block_size=BS, prefill_buckets=(16,), max_batch=4,
        prefill_token_budget=16, prefix_cache=False, kv_cache_dtype=kv))
    assert [r.tokens for r in _serve(off, prompts, 6)] == \
        [r.tokens for r in ours]
    # drain reclaims every block, the cached ones included
    d = eng.drain()["pool"]
    assert d["free_blocks"] == d["num_blocks"] and d["cached_blocks"] > 0


def test_lru_eviction_matches_jax(models):
    """8 usable blocks: the cached prefix is evicted, oldest first, by
    prompts that need the room, then partly found again."""
    jeng, eng = _engines(models, num_blocks=9)
    rng = np.random.RandomState(9)
    prompts = _prompts()
    waves = [[prompts[0]], [rng.randint(0, 256, (36,)).astype(np.int32)],
             [prompts[1]], [prompts[2], prompts[4]]]
    for wave in waves:
        ref = [jeng.submit(p, 6) for p in wave]
        jeng.run_until_complete()
        ours = [eng.submit(p, 6) for p in wave]
        eng.run_until_complete()
        _same(ref, ours, jeng, eng)
    assert eng.pool.stats()["cache_evictions"] > 0
    eng.drain()


def test_shared_block_never_changes(models):
    """A sharer decodes past the shared prefix (and writes its partial
    block) without touching the cached blocks, bit for bit."""
    _, eng = _engines(models)
    prompts = _prompts()
    eng.submit(prompts[0], 4)
    eng.run_until_complete()
    shared = sorted(eng.pool._cached.values())
    assert len(shared) == 3
    before = (eng.pool.k_pages[:, :, shared].clone(),
              eng.pool.v_pages[:, :, shared].clone())
    r = eng.submit(prompts[1], 12)
    eng.run_until_complete()
    assert r.status == "finished" and len(r.tokens) == 12
    assert eng.pool.stats()["prefix_hit_blocks"] == 3
    assert torch.equal(eng.pool.k_pages[:, :, shared], before[0])
    assert torch.equal(eng.pool.v_pages[:, :, shared], before[1])
    eng.drain()


def _pool_state(pool):
    return (dict(pool._refcount), list(pool._evictable), dict(pool._cached),
            list(pool._free_blocks), list(pool._free_slots),
            pool.table.copy().tolist(), pool.free_blocks,
            pool.blocks_in_use)


@pytest.mark.parametrize("point", ["pool.evict_fail", "pool.bind_oom"])
def test_pool_fault_rolls_admission_back(point):
    """A pool of 4 usable blocks, 3 of them cached and evictable: an
    admission that maps 2 of them and must evict the third to bind its
    tail raises the injected fault and leaves refcounts, the cache, free
    lists and tables as they were (the LRU order may change)."""
    spec = KVCacheSpec(num_layers=1, num_kv_heads=1, head_dim=8,
                       page_size=BS)
    pool = BlockPool(spec, 64, 5, 2, optimistic=True, prefix_cache=True)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 256, (3 * BS + 1,)).astype(np.int32)
    slot = pool.admit(len(prompt), 1, tokens=prompt)
    assert pool.register_prefix(slot, prompt) == 3
    pool.release(slot)
    assert pool.stats()["evictable_blocks"] == 3
    # shares blocks 0-1, then binds 2 more: the free one, then an eviction
    other = np.concatenate([prompt[:2 * BS], rng.randint(0, 256, (BS + 4,))])
    state = _pool_state(pool)
    # the first eviction, or the first bind
    with faults.inject(point, at=1) as arm:
        with pytest.raises(faults.FaultInjected):
            pool.admit(len(other), 1, tokens=other)
        assert arm.fires == 1
    assert _pool_state(pool)[2:] == state[2:]
    assert pool._refcount == state[0]
    assert sorted(pool._evictable) == sorted(state[1])
    # with nothing armed the same admission succeeds
    assert pool.admit(len(other), 1, tokens=other) is not None
    # the counters moved before the bind failed, as the JAX pool's do
    assert pool.stats()["prefix_hit_blocks"] == 2 + 2


def test_prefix_cache_needs_optimistic_admission():
    """Worst-case reservation cannot describe shared blocks: the pool
    refuses the pair, and the config resolves the cache off."""
    spec = KVCacheSpec(num_layers=1, num_kv_heads=1, head_dim=8,
                       page_size=BS)
    with pytest.raises(ValueError, match="optimistic=True"):
        BlockPool(spec, 64, 5, 2, optimistic=False, prefix_cache=True)
    c = ServingConfig(prefix_cache=True, preemption=False).resolve()
    assert c.prefix_cache is False


@pytest.mark.parametrize("point", ["pool.bind_oom", "pool.evict_fail"])
def test_engine_contains_admission_faults(models, point):
    """The injected admission fault is backpressure: the request retries
    the next iteration and both engines serve the same tokens."""
    jeng, eng = _engines(models, num_blocks=9)
    prompts = _prompts()
    fill = np.random.RandomState(4).randint(0, 256, (36,)).astype(np.int32)
    results = []
    for e, f in ((jeng, jax_faults), (eng, faults)):
        _serve(e, prompts[:1], 4)
        with f.inject(point, at=1):
            reqs = _serve(e, [fill, prompts[1]], 4, first_alone=False)
        results.append(reqs)
        assert e.scheduler.stats()["admission_faults"] == 1
        assert e.scheduler.stats()["rejected_reasons"]["pool_error"] == 1
    _same(*results, jeng, eng)
    eng.drain()
