"""Static-batch autoregressive decoding over a static-shape KV cache (the
counterpart of ``paddle_tpu/models/generation.py``).

``generate`` decodes layer by layer through the model's own cached path
(``LlamaModel.forward(kv_caches=...)``: the flash forward over each
layer's cache, ``sq = 1`` a decode step); ``fused_generate`` runs the
fused layer stack (``fused_multi_transformer`` over dense caches, or
``fused_multi_transformer_paged`` over the contiguous paged layout), with
optional int8 / int4 weight-only weights. Both run eagerly under
``torch.inference_mode()`` on the model's device: a Python loop feeds the
next token back in (the JAX package jits the steps). Sampling runs on the
device; an explicit ``torch.Generator`` takes the place of the JAX
package's global key. The ``eos`` check is the one host sync a step, and
only when an ``eos_token_id`` is given.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kv_cache import KVCacheSpec, check_request_fits

__all__ = ["lm_head_tail", "sample_logits", "generate", "GenerationMixin",
           "fused_decoder_step", "fused_generate", "release_fused_weights"]


def lm_head_tail(h_last: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor, eps: float) -> torch.Tensor:
    """Final RMS norm then the LM head, both in f32: ``h_last [N, D]`` ->
    logits ``[N, V]``. ``head`` is ``[D, V]`` (the JAX layout; pass
    ``lm_head.weight.t()``). Same numerics as
    ``paddle_tpu.models.generation.lm_head_tail``."""
    hf = h_last.float()
    var = hf.square().mean(dim=-1, keepdim=True)
    hf = hf * torch.rsqrt(var + eps) * final_norm.float()
    return hf @ head.float()


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  do_sample: bool = False, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Next token of each row of ``logits [B, V]`` (any float dtype), on
    their device, as ``torch.long [B]``; ``paddle_tpu/models/generation.py:
    43-63`` step for step: f32 first; greedy is the argmax (the first index
    at ties); sampling divides by the temperature (clamped at 1e-6), keeps
    the ``top_k`` largest (``top_k`` clamped to the vocabulary) and the
    nucleus of mass ``top_p`` (at least one token), and draws from the
    softmax through ``torch.multinomial`` with ``generator`` (on the
    logits' device; None: the default one)."""
    logits = logits.float()
    if not do_sample:
        return logits.argmax(dim=-1)
    if temperature != 1.0:
        logits = logits / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = ((cum - probs) < top_p).sum(dim=-1).clamp_min(1)
        cutoff = sorted_logits.gather(-1, keep[:, None] - 1)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _prompt_ids(model, input_ids) -> torch.Tensor:
    """``input_ids [B, P]`` (tensor or array) as ``torch.long`` on the
    model's device."""
    return torch.as_tensor(input_ids).to(model.device, torch.long)


@torch.inference_mode()
def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None,
             pad_token_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``input_ids [B, P]``
    layer by layer over the model's KV cache
    (``paddle_tpu/models/generation.py:105-171``). Returns ``[B, P + N]``
    ``torch.long`` token ids on the model's device, the prompt included.
    The prefill writes the cache at index 0, each decode step one token
    at ``P + i``; the logits are the model-dtype LM head over the last
    normed hidden row. Rows that produced ``eos_token_id`` continue with
    ``pad_token_id`` (default: the eos id), and once every row has, the
    rest is padding. ``generator`` drives the draws when ``do_sample``."""
    from .llama import KVCache

    cfg = model.config
    ids = _prompt_ids(model, input_ids)
    if max_new_tokens <= 0:
        return ids
    B, P = ids.shape
    T = P + max_new_tokens
    check_request_fits(P, max_new_tokens, cfg.max_position_embeddings,
                       "max_position_embeddings",
                       request=f"generate batch of {B} prompts")
    k, v = KVCacheSpec.from_config(cfg).alloc_dense(B, T, ids.device)
    caches = [KVCache(k[i], v[i], 0) for i in range(cfg.num_hidden_layers)]

    def step(tokens, index):
        nonlocal caches
        hidden, caches = model.model(tokens, kv_caches=caches,
                                     cache_index=index, position_offset=index)
        logits = model.logits(model.model.norm(hidden[:, -1:]))[:, 0]
        return sample_logits(logits, generator, do_sample, temperature,
                             top_k, top_p)

    tok = step(ids, 0)
    pad_id = pad_token_id if pad_token_id is not None else eos_token_id
    done = torch.zeros(B, dtype=torch.bool, device=ids.device)
    out = [tok]
    for i in range(max_new_tokens - 1):
        if eos_token_id is not None:
            done |= tok == eos_token_id
            if bool(done.all()):         # the host sync, only with eos
                break
        tok = step(tok[:, None], P + i)
        if eos_token_id is not None:
            tok = torch.where(done, pad_id, tok)
        out.append(tok)
    gen = torch.stack(out, dim=1)
    if eos_token_id is not None and gen.shape[1] < max_new_tokens:
        gen = torch.cat([gen, gen.new_full(
            (B, max_new_tokens - gen.shape[1]), pad_id)], dim=1)
    return torch.cat([ids, gen], dim=1)


class GenerationMixin:
    """Adds ``.generate(...)`` to causal-LM modules (the PaddleNLP API)."""

    def generate(self, input_ids, **kwargs):
        return generate(self, input_ids, **kwargs)


def _param_key(model) -> tuple:
    """Where and at which version every decoder parameter is: an optimizer
    or ``load_state_dict`` writes in place, which moves ``_version``; a
    move to another device or a new tensor moves ``data_ptr``."""
    return tuple((p.data_ptr(), p._version) for layer in model.model.layers
                 for p in layer.parameters())


def fused_weights_cached(model, quantize):
    """The model's fused decoder stack for ``quantize``, cached on the model
    (``model._fused_generate_weights``, one entry a mode) and stacked again
    when a parameter moved or was written since."""
    from ..incubate.nn.functional.fused_transformer import (
        fused_weights_from_llama)

    cache = getattr(model, "_fused_generate_weights", None)
    if cache is None:
        cache = model._fused_generate_weights = {}
    key = _param_key(model)
    entry = cache.get(str(quantize))
    if entry is None or entry[0] != key:
        cache.pop(str(quantize), None)        # free the stale stack first
        entry = (key, fused_weights_from_llama(model, quantize=quantize))
        cache[str(quantize)] = entry
    return entry[1]


def release_fused_weights(model) -> None:
    """Drop the fused stacks :func:`fused_generate` cached on ``model`` (a
    Llama-3-8B stack holds ~13 GB in bf16); the next call stacks again."""
    model.__dict__.pop("_fused_generate_weights", None)


def f32_head(model, what: str) -> torch.Tensor:
    """``lm_head.weight`` as the f32 ``[D, V]`` view the tail multiplies
    by (converted once a call). A tied model has no ``lm_head``, in the
    JAX package either: refused by name."""
    if model.lm_head is None:
        raise ValueError(f"{what}: the model ties its embeddings "
                         f"(tie_word_embeddings=True) and has no lm_head; "
                         f"the fused decode path needs an lm_head")
    return model.lm_head.weight.detach().float().t()


def fused_decoder_step(cfg, weights, embed, final_norm, head, rope_cos,
                       rope_sin, tokens, cache_k, cache_v, index: int,
                       paged: bool = False):
    """One step of the fused decoder, the step :func:`fused_generate` and
    ``ServingDecoder`` share: ``tokens [B, span]`` (a prefill span, or one
    decode token a row) embedded and run at positions ``index ..`` (rows
    of ``rope_cos`` / ``rope_sin``) through ``fused_multi_transformer``
    over dense caches ``[L, B, S, kvh, dh]``, or, ``paged`` (decode only),
    ``fused_multi_transformer_paged`` over contiguous page buffers ``[L,
    kvh, B * pps, page, dh]``; the caches are written in place. ``head`` is
    the f32 ``[D, V]`` head. Returns the f32 logits ``[B, V]`` of each
    row's last position (:func:`lm_head_tail`) and the caches."""
    from ..incubate.nn.functional.fused_transformer import (
        fused_multi_transformer, fused_multi_transformer_paged)

    span = tokens.shape[1]
    x = embed[tokens].to(KVCacheSpec.from_config(cfg).torch_dtype)
    step = fused_multi_transformer_paged if paged else fused_multi_transformer
    h, cache_k, cache_v = step(
        x, weights, cache_k, cache_v, index, rope_cos[index:index + span],
        rope_sin[index:index + span], num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads, epsilon=cfg.rms_norm_eps)
    logits = lm_head_tail(h[:, -1], final_norm, head, cfg.rms_norm_eps)
    return logits, cache_k, cache_v


@torch.inference_mode()
def fused_generate(model, input_ids, max_new_tokens: int = 32,
                   quantize=False, do_sample: bool = False,
                   temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0, paged: bool = False,
                   page_size: int = 16,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Decode through the fused layer stack
    (``paddle_tpu/models/generation.py:181-345``): the prefill is one
    ``fused_multi_transformer`` call at index 0, each decode step one more
    at ``s = 1``; the tail is :func:`lm_head_tail` (f32). ``quantize``:
    False, True / "int8" or "int4" weight-only weights (the stack is
    cached on the model a mode, and stacked again after a parameter
    changes; :func:`release_fused_weights` drops it). ``paged=True``: the
    dense prefill cache is packed into the contiguous paged layout (pages
    of ``page_size`` tokens) and every decode step is
    ``fused_multi_transformer_paged``. Returns ``[B, P +
    max(max_new_tokens, 1)]`` ``torch.long`` ids on the model's device
    (the prefill's token always comes out, as in the JAX function)."""
    from ..incubate.nn.functional.fused_transformer import (
        paged_cache_from_dense)
    from ..ops.fused.rope import build_rope_cache

    if quantize is True:
        quantize = "int8"
    cfg = model.config
    ids = _prompt_ids(model, input_ids)
    dev = ids.device
    B, P = ids.shape
    T = P + max_new_tokens
    check_request_fits(P, max_new_tokens, cfg.max_position_embeddings,
                       "max_position_embeddings",
                       request=f"fused_generate batch of {B} prompts")
    spec = KVCacheSpec.from_config(cfg, page_size=page_size)
    cos, sin = build_rope_cache(T, cfg.head_dim, cfg.rope_theta, device=dev)
    parts = (cfg, fused_weights_cached(model, quantize),
             model.model.embed_tokens.weight, model.model.norm.weight,
             f32_head(model, "fused_generate"), cos, sin)
    ck, cv = spec.alloc_dense(B, T, dev)

    def next_token(tokens, index, paged_step):
        nonlocal ck, cv
        logits, ck, cv = fused_decoder_step(*parts, tokens, ck, cv, index,
                                            paged_step)
        return sample_logits(logits, generator, do_sample, temperature,
                             top_k, top_p)

    out = [next_token(ids, 0, False)]
    paged = paged and max_new_tokens > 1
    if paged:
        ck, cv = paged_cache_from_dense(ck, cv, page_size,
                                        spec.pages_per_seq(T))
    for index in range(P, T - 1):
        out.append(next_token(out[-1][:, None], index, paged))
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
