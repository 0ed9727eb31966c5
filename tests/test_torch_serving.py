"""Token parity of the whole slice: the port's ``ServingEngine`` on the CPU
against the JAX ``ServingEngine`` (``interpret=True``, prefix cache off) on
the same tiny f32 Llama; the port's engine keeps its default prefix cache,
which here only a preempted request's recompute hits. Greedy tokens must match exactly, including a
prompt longer than ``prefill_token_budget`` (chunked prefill) and a pool
small enough to force a preemption, and in the quantized modes (weight-only
int8/int4, the int8 KV pool, and both), on a model whose products all have
128-multiple widths. The JAX engine's trace counts and its int8-KV
match-rate constant are not asserted here.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
# every product's K and N a multiple of 128: qkv 128 x 256, out 128 x 128,
# ffn1 128 x 512, ffn2 256 x 128
QTINY = dict(TINY, hidden_size=128, intermediate_size=256)


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
    return _pair(TINY, 21)


@pytest.fixture(scope="module")
def quant_models():
    return _pair(QTINY, 23)


def _run(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new, rid=f"r{i}")
            for i, p in enumerate(prompts)]
    engine.run_until_complete()
    return reqs


# name -> (engine kwargs, prompt lengths, max_new_tokens)
SCENARIOS = {
    # the 41-token prompt exceeds the 16-token budget: 3 chunks
    "chunked": (dict(max_batch=4, prefill_token_budget=16),
                [5, 41, 13, 9], 12),
    # 4 usable blocks of 8; two requests grow to 4 blocks each
    "preemption": (dict(max_batch=4, num_blocks=5), [15, 15], 12),
}


def _check_parity(jm, tm, name, **quant):
    kw, lens, max_new = SCENARIOS[name]
    base = dict(max_seq_len=64, block_size=8, prefill_buckets=(16,), **kw,
                **quant)
    rng = np.random.RandomState(len(name))
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32) for n in lens]
    ref = _run(JaxServingEngine(jm, JaxServingConfig(
        interpret=True, prefix_cache=False, **base)), prompts, max_new)
    eng = ServingEngine(tm, ServingConfig(**base))
    ours = _run(eng, prompts, max_new)
    for r, o in zip(ref, ours):
        assert o.status == r.status == "finished"
        assert o.tokens == r.tokens, (o.rid, o.tokens, r.tokens)
        assert o.preemptions == r.preemptions
        assert o.prefill_chunks == r.prefill_chunks
    s = eng.drain()
    assert s["pool"]["free_blocks"] == s["pool"]["num_blocks"]
    if name == "preemption":
        assert s["preemptions"] >= 1
    else:
        assert max(r.prefill_chunks for r in ours) == 3
    return eng, s


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_tokens_match_jax(models, name):
    _check_parity(*models, name)


# (quantize, kv_cache_dtype) x scenario: every mode under chunked prefill;
# preemption, whose victim recomputes its prefix through the dequantized
# carry, with both
QUANT_CASES = [("int8", "", "chunked"), ("int4", "", "chunked"),
               (False, "int8", "chunked"), (True, "int8", "chunked"),
               (True, "int8", "preemption")]


@pytest.mark.parametrize("quantize,kv_dtype,name", QUANT_CASES)
def test_quantized_engine_tokens_match_jax(quant_models, quantize, kv_dtype,
                                           name):
    eng, s = _check_parity(*quant_models, name, quantize=quantize,
                           kv_cache_dtype=kv_dtype)
    mode = "int8" if quantize is True else quantize
    assert s["mode"]["quantize"] == mode
    assert s["mode"]["kv_cache_dtype"] == (kv_dtype or "float32")
    assert eng.weights.quantized == bool(quantize)
    pool = eng.pool
    assert (pool.k_scales is not None) == (kv_dtype == "int8")
    assert pool.k_pages.dtype == (torch.int8 if kv_dtype else torch.float32)


def test_stream_and_dense_forward_agree(models):
    """The streamed tokens are the dense forward's greedy argmax,
    teacher-forced (what chip_smoke.py checks on the card)."""
    _, tm = models
    eng = ServingEngine(tm, ServingConfig(max_seq_len=64, block_size=8))
    prompt = np.arange(3, 22, dtype=np.int32)
    toks = list(eng.stream(eng.submit(prompt, 8)))
    logits = tm(torch.tensor(np.concatenate([prompt, toks])[None]))
    assert logits[0, len(prompt) - 1:-1].argmax(-1).tolist() == toks
    s = eng.stats()
    assert s["latency"]["finished"] == 1 and s["decode_steps"] == 7


@pytest.mark.parametrize("quantize,kv_dtype,want", [
    (True, "int8", "int8"), ("int4", "", "int4"), (False, None, False),
    ("int8", "", "int8")])
def test_quantized_modes_resolve(quantize, kv_dtype, want):
    c = ServingConfig(quantize=quantize, kv_cache_dtype=kv_dtype).resolve()
    assert c.quantize == want and c.kv_cache_dtype == (kv_dtype or "")


@pytest.mark.parametrize("field,value", [
    ("kv_cache_dtype", "fp8"), ("kv_cache_dtype", "bfloat16"),
    ("quantize", "int2")])
def test_unknown_quantized_modes_raise(field, value):
    with pytest.raises(ValueError, match="not supported"):
        ServingConfig(**{field: value}).resolve()


def test_config_defaults_match_jax():
    c = ServingConfig().resolve()
    j = JaxServingConfig(interpret=True).resolve()
    for f in ("block_size", "max_batch", "prefill_token_budget",
              "prefill_buckets", "preemption", "prefix_cache",
              "max_seq_len"):
        assert getattr(c, f) == getattr(j, f), f
    assert c.prefix_cache is True
    # without preemption both resolve the cache off
    assert ServingConfig(preemption=False).resolve().prefix_cache is \
        JaxServingConfig(preemption=False, interpret=True).resolve() \
        .prefix_cache is False
