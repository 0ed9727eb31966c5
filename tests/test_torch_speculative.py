"""Speculative decoding in the port against the JAX package on the CPU:
``fused_multi_transformer_paged_ragged_verify`` against the JAX function
(its Pallas paged kernel in interpret mode) on f32 and int8 pools, and the
port's speculative ``ServingEngine`` against the JAX speculative engine
(``interpret=True``) and against the port's own plain greedy decoding, on
tiny f32 Llamas loaded through ``load_paddle_tpu_state``: an independent
drafter (acceptance near 0) and self-draft (acceptance 1), chunked
prefill with preemption, an int8 pool, the ``serving.draft_divergence``
and ``serving.verify_nan`` fault points, and the refusals of
``ServingConfig._resolve_speculative``. The JAX engine's trace counts are
not asserted.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core import faults as jax_faults
from paddle_tpu.incubate.nn.functional.fused_transformer import (
    fused_multi_transformer_paged_ragged_verify as jax_verify)
from paddle_tpu.incubate.nn.functional.fused_transformer import (
    fused_weights_from_llama as jax_fused_weights)
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.core import faults
from paddle_tpu_torch.incubate.nn.functional.fused_transformer import (
    fused_multi_transformer_paged_ragged_verify, fused_weights_from_llama)
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.ops.fused.rope import build_rope_cache
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
DRAFT = dict(TINY, num_hidden_layers=1, intermediate_size=88)
K = 3
# verify function: h and committed k/v against JAX (f32 throughout)
VERIFY_ATOL = 2e-5


def _pair(cfg, seed):
    paddle.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**cfg))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """(verifier pair, independent drafter pair)."""
    return _pair(TINY, 21), _pair(DRAFT, 50)


# name -> (engine kwargs, prompt lengths, max_new_tokens)
SCENARIOS = {
    # the 41-token prompt takes 3 chunks of the 16-token budget
    "chunked": (dict(max_batch=4, prefill_token_budget=16),
                [5, 41, 13, 9], 12),
    # 8 usable blocks of 8 for requests that grow to 6, 4 and 4 blocks,
    # the 30-token prompt chunked: preemption and recompute
    "churn": (dict(max_batch=4, num_blocks=9, prefill_token_budget=16),
              [30, 20, 13], 12),
}


def _base(name, **kw):
    return dict(max_seq_len=64, block_size=8, prefill_buckets=(16,),
                **SCENARIOS[name][0], **kw)


def _prompts(name):
    rng = np.random.RandomState(len(name))
    return [rng.randint(0, 256, (n,)).astype(np.int32)
            for n in SCENARIOS[name][1]]


def _run(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new, rid=f"r{i}")
            for i, p in enumerate(prompts)]
    engine.run_until_complete()
    return reqs


def _plain(tm, name, **kw):
    eng = ServingEngine(tm, ServingConfig(**_base(name, **kw)))
    return [r.tokens for r in _run(eng, _prompts(name),
                                   SCENARIOS[name][2])]


@pytest.mark.parametrize("draft,name,kv", [
    ("independent", "churn", ""), ("self", "churn", ""),
    ("independent", "chunked", "int8")])
def test_engine_tokens_match_jax_and_plain(models, draft, name, kv):
    (jm, tm), (jd, td) = models
    if draft == "self":
        jd, td = jm, tm
    prompts, new = _prompts(name), SCENARIOS[name][2]
    ref = _run(JaxServingEngine(jm, JaxServingConfig(
        interpret=True, speculative=(jd, K),
        **_base(name, kv_cache_dtype=kv))), prompts, new)
    eng = ServingEngine(tm, ServingConfig(speculative=(td, K),
                                          **_base(name, kv_cache_dtype=kv)))
    ours = _run(eng, prompts, new)
    plain = _plain(tm, name, kv_cache_dtype=kv)
    for r, o, p in zip(ref, ours, plain):
        assert o.status == r.status == "finished"
        assert o.tokens == r.tokens == p, (o.rid, o.tokens, r.tokens, p)
        assert (o.spec_drafted, o.spec_accepted) == \
            (r.spec_drafted, r.spec_accepted)
        assert o.preemptions == r.preemptions
        assert o.prefill_chunks == r.prefill_chunks
    s = eng.drain()
    spec = s["speculative"]
    assert spec["drafted_tokens"] == sum(r.spec_drafted for r in ours) > 0
    assert spec["rollback_tokens"] == \
        spec["drafted_tokens"] - spec["accepted_tokens"]
    if draft == "self":
        assert spec["accept_rate"] > 0.9
        assert eng.iterations < sum(len(t) for t in plain)
    if name == "churn":
        assert s["preemptions"] >= 1
    assert s["pool"]["free_blocks"] == s["pool"]["num_blocks"]


def test_draft_divergence_costs_acceptance_not_tokens(models):
    """Self-draft scrambled by ``serving.draft_divergence``: nothing is
    accepted, the streams stay plain greedy decoding's."""
    (_, tm), _ = models
    eng = ServingEngine(tm, ServingConfig(speculative=(tm, K),
                                          **_base("chunked")))
    with faults.inject("serving.draft_divergence"):
        ours = _run(eng, _prompts("chunked"), SCENARIOS["chunked"][2])
    assert [r.tokens for r in ours] == _plain(tm, "chunked")
    assert eng.stats()["speculative"]["accepted_tokens"] == 0
    eng.drain()


def test_verify_nan_quarantines_one_request(models):
    """``serving.verify_nan`` on the 2nd verify step poisons the lowest
    ready slot: that request ends ``error``, its blocks return, the others
    keep plain greedy decoding's tokens; JAX quarantines the same one."""
    (jm, tm), (jd, td) = models
    prompts, new = _prompts("chunked"), SCENARIOS["chunked"][2]
    base = _base("chunked")
    with jax_faults.inject("serving.verify_nan", at=2):
        ref = _run(JaxServingEngine(jm, JaxServingConfig(
            interpret=True, speculative=(jd, K), **base)), prompts, new)
    eng = ServingEngine(tm, ServingConfig(speculative=(td, K), **base))
    with faults.inject("serving.verify_nan", at=2):
        ours = _run(eng, prompts, new)
    plain = _plain(tm, "chunked")
    assert [r.status for r in ours] == [r.status for r in ref]
    assert sum(r.status == "error" for r in ours) == 1
    for o, r, p in zip(ours, ref, plain):
        assert o.tokens == r.tokens
        if o.status == "finished":
            assert o.tokens == p
        else:
            assert "NaN sentinel" in o.error and o.tokens == p[:len(o.tokens)]
    s = eng.drain()
    assert s["faults"]["quarantined_requests"] == 1
    assert s["faults"]["nan_events"] == 1
    assert s["pool"]["free_blocks"] == s["pool"]["num_blocks"]


def _verify_inputs(tm, kv, seed=7):
    """A pool with random history and a verify window over it: rows of 0
    (idle), 5, 13 and 29 committed tokens, spans 0, 4, 2 and 4."""
    cfg = tm.config
    rng = np.random.RandomState(seed)
    L, kvh, dh, page, nb = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                            cfg.head_dim, 8, 20)
    B, S, pps = 4, K + 1, 8
    lens = np.array([0, 5, 13, 29], np.int32)
    spans = np.array([0, 4, 2, 4], np.int32)
    table = np.zeros((B, pps), np.int32)
    blocks = rng.permutation(np.arange(1, nb))
    for b in range(1, B):
        n = -(-int(lens[b] + spans[b]) // page)
        table[b, :n], blocks = blocks[:n], blocks[n:]
    shape = (L, kvh, nb, page, dh)
    if kv == "int8":
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (L, nb, kvh, page)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (L, nb, kvh, page)).astype(np.float32)
        scales = (ks, vs)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        scales = None
    x = (0.5 * rng.standard_normal((B, S, cfg.hidden_size))
         ).astype(np.float32)
    cos, sin = build_rope_cache(64, dh, cfg.rope_theta)
    pos = np.minimum(lens[:, None] + np.arange(S)[None], 63)
    return x, kp, vp, scales, table, lens, spans, cos.numpy()[pos], \
        sin.numpy()[pos]


@pytest.mark.parametrize("kv", ["", "int8"])
def test_verify_function_matches_jax(models, kv):
    """h within 2e-5 of the JAX function's; the committed window equal
    (int8: the same quantized values, scales within 2e-5 relative); the
    positions past each span and the rest of the pool untouched."""
    (jm, tm), _ = models
    cfg = tm.config
    x, kp, vp, scales, table, lens, spans, cos, sin = _verify_inputs(tm, kv)
    kw = dict(num_heads=cfg.num_attention_heads,
              num_kv_heads=cfg.num_key_value_heads,
              epsilon=cfg.rms_norm_eps)
    t = torch.from_numpy
    tpool = [t(kp.copy()), t(vp.copy())]
    tsc = [t(s.copy()) for s in scales] if scales else [None, None]
    outs = fused_multi_transformer_paged_ragged_verify(
        t(x), fused_weights_from_llama(tm), *tpool, t(table), t(lens),
        t(spans), t(cos), t(sin), **kw, k_scales=tsc[0], v_scales=tsc[1])
    j = jnp.asarray
    jouts = jax_verify(
        j(x), jax_fused_weights(jm), j(kp), j(vp), j(table), j(lens),
        j(spans), j(cos), j(sin), **kw, interpret=True,
        k_scales=j(scales[0]) if scales else None,
        v_scales=j(scales[1]) if scales else None)
    h, jh = outs[0].numpy(), np.asarray(jouts[0])
    assert np.isfinite(h).all()
    np.testing.assert_allclose(h, jh, rtol=0, atol=VERIFY_ATOL)
    # the committed positions: those inside a span, never block 0
    committed = np.zeros(kp.shape[2:4], bool)
    for b in range(4):
        for i in range(spans[b]):
            p = lens[b] + i
            committed[table[b, p // 8], p % 8] = True
    committed[0] = False
    for ours, ref, before in ((outs[1], jouts[1], kp), (outs[2], jouts[2],
                                                        vp)):
        ours, ref = ours.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(ours[:, :, 1:][:, :, ~committed[1:]],
                                      before[:, :, 1:][:, :, ~committed[1:]])
        if kv:
            np.testing.assert_array_equal(ours[:, :, committed],
                                          ref[:, :, committed])
        else:
            np.testing.assert_allclose(ours[:, :, committed],
                                       ref[:, :, committed], rtol=0,
                                       atol=VERIFY_ATOL)
    if kv:
        blk, slot = np.nonzero(committed)
        for ours, ref in zip(outs[3:], jouts[3:]):
            np.testing.assert_allclose(
                ours.numpy()[:, blk, :, slot],
                np.asarray(ref)[:, blk, :, slot], rtol=VERIFY_ATOL, atol=0)


class _Drafter:
    """A stand-in drafter: ``resolve`` reads only its ``config``."""

    def __init__(self, config):
        self.config = config


# refusal -> ServingConfig kwargs, given a drafter built from a config dict
BAD = {
    "not a pair": lambda d: dict(speculative=(d(TINY),)),
    "k = 0": lambda d: dict(speculative=(d(TINY), 0)),
    "window > max_seq_len": lambda d: dict(speculative=(d(TINY), 64)),
    "window > budget": lambda d: dict(speculative=(d(TINY), 8),
                                      prefill_token_budget=8),
    "no config": lambda d: dict(speculative=(object(), 2)),
    "short positions": lambda d: dict(speculative=(
        d(dict(TINY, max_position_embeddings=32)), 2)),
    "vocab": lambda d: dict(speculative=(d(dict(TINY, vocab_size=128)), 2)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_resolve_speculative_refusals_match_jax(case):
    """Each refusal raises ValueError with the JAX message word for
    word."""
    with pytest.raises(ValueError) as ours:
        ServingConfig(max_seq_len=64, **BAD[case](
            lambda c: _Drafter(LlamaConfig(**c)))).resolve(
            verifier_cfg=LlamaConfig(**TINY))
    with pytest.raises(ValueError) as ref:
        JaxServingConfig(max_seq_len=64, interpret=True, **BAD[case](
            lambda c: _Drafter(JaxLlamaConfig(**c)))).resolve(
            verifier_cfg=JaxLlamaConfig(**TINY))
    # a refused object's repr carries its address
    msg = [re.sub(r"0x[0-9a-f]+", "0x", str(e.value)) for e in (ours, ref)]
    assert msg[0] == msg[1]
    assert "ServingConfig.speculative" in msg[0]
