"""Llama-2/3-style decoder-only LM as ``torch.nn`` modules.

The counterpart of ``paddle_tpu/models/llama.py`` for serving and training:
the same parameter names and shapes (linear weights in PyTorch's
``[out, in]``; ``models/convert.py`` transposes the JAX ``[in, out]``
ones), the JAX model's bf16 rounding in its layers, and attention through
the flash dispatch (differentiable when grad is on), with an optional
attention mask and packed-varlen segment ids and positions. Without labels
the forward returns logits from the shared f32 tail (``lm_head_tail``:
final RMS norm and LM head in f32), which is what the serving engine
computes too; with labels it returns the training loss as the JAX model
does. ``recompute`` rematerialises each decoder layer in training
(``framework/recompute.py``); ``tie_word_embeddings`` makes the embedding
matrix the LM head. With ``kv_caches`` (one :class:`KVCache` a layer) the
model decodes incrementally over a static-shape cache, as the JAX model
does for ``generate``.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import amp_op
from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from ..framework.recompute import recompute
from ..nn.functional import RMSNorm, swiglu
from ..ops.fused.cross_entropy import fused_linear_cross_entropy
from ..ops.fused.flash_attention import flash_attention
from ..ops.fused.rope import apply_rotary_position_embedding, build_rope_cache
from .generation import GenerationMixin, lm_head_tail

IGNORE_INDEX = -100

__all__ = ["LlamaConfig", "LLAMA_PRESETS", "LlamaForCausalLM", "LlamaModel",
           "KVCache", "causal_lm_loss"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    # the embedding matrix is the LM head (no lm_head parameter)
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # rematerialise each decoder layer in training (framework/recompute.py)
    recompute: bool = False
    # "full": keep only each layer's input; "save_dots": keep the matrix
    # products' and flash's outputs, recompute the elementwise ops
    recompute_policy: str = "full"
    # training attention through parallel.sep_attention: ring attention
    # over the mesh's 'sep' axis inside a sequence-sharded step (flash
    # attention on whole sequences, as in JAX)
    context_parallel: bool = False
    # with labels, forward returns (loss, None) from the chunked fused
    # linear + cross-entropy instead of (loss, logits)
    fused_loss: bool = False

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def num_params(self) -> int:
        h, v, i = self.hidden_size, self.vocab_size, self.intermediate_size
        kvh = self.num_key_value_heads * self.head_dim
        per_layer = 2 * h * h + 2 * h * kvh + 3 * h * i + 2 * h
        head = 0 if self.tie_word_embeddings else v * h
        return v * h + self.num_hidden_layers * per_layer + h + head


LLAMA_PRESETS = {
    "llama2-7b": LlamaConfig(vocab_size=32000, hidden_size=4096,
                             intermediate_size=11008, num_hidden_layers=32,
                             num_attention_heads=32, num_key_value_heads=32),
    "llama2-13b": LlamaConfig(vocab_size=32000, hidden_size=5120,
                              intermediate_size=13824, num_hidden_layers=40,
                              num_attention_heads=40, num_key_value_heads=40),
    "llama2-70b": LlamaConfig(vocab_size=32000, hidden_size=8192,
                              intermediate_size=28672, num_hidden_layers=80,
                              num_attention_heads=64, num_key_value_heads=8),
    "llama3-8b": LlamaConfig(vocab_size=128256, hidden_size=4096,
                             intermediate_size=14336, num_hidden_layers=32,
                             num_attention_heads=32, num_key_value_heads=8,
                             rope_theta=500000.0,
                             max_position_embeddings=8192),
    "llama-tiny": LlamaConfig(vocab_size=2048, hidden_size=256,
                              intermediate_size=688, num_hidden_layers=4,
                              num_attention_heads=8, num_key_value_heads=4,
                              max_position_embeddings=512),
    "llama-350m": LlamaConfig(vocab_size=32000, hidden_size=1024,
                              intermediate_size=2816, num_hidden_layers=24,
                              num_attention_heads=16, num_key_value_heads=16,
                              max_position_embeddings=2048),
    "llama-1b": LlamaConfig(vocab_size=32000, hidden_size=2048,
                            intermediate_size=5504, num_hidden_layers=22,
                            num_attention_heads=16, num_key_value_heads=16,
                            max_position_embeddings=2048),
}


def causal_lm_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                   fused_loss: bool):
    """The causal LM loss of normed hidden states ``h [b, s, H]`` through
    the LM head ``head [vocab, H]`` (an ``nn.Linear`` weight, or a tied
    embedding matrix) as ``paddle_tpu/models/llama.py:334-357`` computes
    it: position t predicts label t + 1 (``-100`` is ignored), the mean f32
    cross-entropy. Returns ``(loss, None)`` from the chunked fused loss when
    ``fused_loss``, else ``(loss, logits)`` with the logits in the model
    dtype."""
    if fused_loss:
        return fused_linear_cross_entropy(
            h[:, :-1], head, labels[:, 1:], ignore_index=IGNORE_INDEX), None
    logits = F.linear(h, head)
    return _shifted_cross_entropy(logits, labels), logits


@amp_op("cross_entropy")
def _shifted_cross_entropy(logits, labels):
    """The mean f32 cross-entropy of ``logits [b, s, V]`` at position t
    against label t + 1 (``-100`` ignored): JAX's one ``cross_entropy``
    op."""
    shift_labels = labels[:, 1:].reshape(-1)
    per_token = F.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]).float(), shift_labels,
        ignore_index=IGNORE_INDEX, reduction="none")
    count = (shift_labels != IGNORE_INDEX).sum().clamp_min(1)
    return per_token.sum() / count


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **dd):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = hd
        self.context_parallel = getattr(cfg, "context_parallel", False)
        self.q_proj = nn.Linear(h, self.num_heads * hd, bias=False, **dd)
        self.k_proj = nn.Linear(h, self.num_kv_heads * hd, bias=False, **dd)
        self.v_proj = nn.Linear(h, self.num_kv_heads * hd, bias=False, **dd)
        self.o_proj = nn.Linear(self.num_heads * hd, h, bias=False, **dd)

    def forward(self, x, cos, sin, attn_mask=None, kv_cache=None,
                cache_index=None, segment_ids=None):
        """With ``kv_cache`` the step's k and v are written into the cache
        at ``cache_index`` and q attends over the whole cache up to
        ``kv_len = cache_index + s`` (bottom-right causal: row r sees
        columns ``<= cache_index + r``); returns ``(out, kv_cache)``."""
        b, s = x.shape[0], x.shape[1]
        # heads from the projections' widths: a tensor-parallel shard holds
        # its share of them
        q = self.q_proj(x).view(b, s, -1, self.head_dim)
        k = self.k_proj(x).view(b, s, -1, self.head_dim)
        v = self.v_proj(x).view(b, s, -1, self.head_dim)
        q = apply_rotary_position_embedding(q, cos, sin)
        k = apply_rotary_position_embedding(k, cos, sin)
        if kv_cache is not None:
            k, v, kv_cache = kv_cache.update(k, v, cache_index)
            out = flash_attention(q, k, v, causal=True, attn_mask=attn_mask,
                                  kv_len=int(cache_index) + s)
            return self.o_proj(out.reshape(b, s, -1)), kv_cache
        if self.context_parallel:
            from ..parallel import sequence_parallel as sp

            if attn_mask is None and segment_ids is None:
                out = sp.sep_attention(q, k, v, causal=True)
                return self.o_proj(out.reshape(b, s, -1))
            if sp.is_sequence_sharded():
                raise ValueError("context_parallel: ring attention is "
                                 "causal-only; attn_mask / segment_ids "
                                 "cannot span the sep shards")
            warnings.warn("context_parallel=True falls back to dense flash "
                          "attention when attn_mask/segment_ids are passed "
                          "(ring attention is causal-only)", stacklevel=2)
        out = flash_attention(q, k, v, causal=True, attn_mask=attn_mask,
                              q_segment_ids=segment_ids,
                              kv_segment_ids=segment_ids)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **dd):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False, **dd)
        self.up_proj = nn.Linear(h, i, bias=False, **dd)
        self.down_proj = nn.Linear(i, h, bias=False, **dd)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **dd):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **dd)
        self.self_attn = LlamaAttention(cfg, **dd)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **dd)
        self.mlp = LlamaMLP(cfg, **dd)

    def forward(self, x, cos, sin, attn_mask=None, kv_cache=None,
                cache_index=None, segment_ids=None):
        """Returns ``(x, kv_cache)`` with ``kv_cache``, else ``x``."""
        h = self.self_attn(self.input_layernorm(x), cos, sin,
                           attn_mask=attn_mask, kv_cache=kv_cache,
                           cache_index=cache_index, segment_ids=segment_ids)
        if kv_cache is not None:
            h, kv_cache = h
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x if kv_cache is None else (x, kv_cache)


class LlamaModel(nn.Module):
    """Embedding and decoder layers. ``forward`` returns the hidden states
    BEFORE the final norm: the f32 tail (``lm_head_tail``) applies it."""

    def __init__(self, cfg: LlamaConfig, **dd):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **dd)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, **dd)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **dd)
        cos, sin = build_rope_cache(cfg.max_position_embeddings, cfg.head_dim,
                                    cfg.rope_theta, device=dd["device"])
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, attn_mask=None, position_offset=0,
                kv_caches=None, cache_index=None, segment_ids=None,
                position_ids=None):
        """``segment_ids [b, s]`` masks attention across packed sequences
        and ``position_ids [b, s]`` gives each token its rope row (restarting
        at each packed sequence); ``attn_mask`` as ``flash_attention``
        takes it. In training with ``config.recompute`` each layer is
        recomputed in the backward under ``config.recompute_policy``.

        Incremental decode (``paddle_tpu/models/llama.py:235-291``): the
        tokens take rope rows from ``position_offset``; with ``kv_caches``
        (a :class:`KVCache` a layer) each layer writes its k and v at
        ``cache_index`` and attends over its cache, and the call returns
        ``(hidden, new_caches)``. An int offset past the rope table
        raises, as does ``segment_ids`` with ``kv_caches``."""
        s = input_ids.shape[1]
        n_rows = self.rope_cos.shape[0]
        if kv_caches is not None and segment_ids is not None:
            raise ValueError(
                "segment_ids (packed varlen) is a training-path feature; "
                "the kv-cache decode path does not thread segment masks")
        if position_ids is None and isinstance(position_offset, int) \
                and position_offset + s > n_rows:
            raise ValueError(f"position_offset {position_offset} + seq {s} "
                             f"exceeds max_position_embeddings {n_rows}")
        x = self.embed_tokens(input_ids)
        if position_ids is not None:
            cos, sin = self.rope_cos[position_ids], self.rope_sin[position_ids]
        else:
            # a tensor offset is clamped into the table, as the JAX
            # dynamic slice does
            off = min(max(int(position_offset), 0), max(n_rows - s, 0))
            cos, sin = self.rope_cos[off:off + s], self.rope_sin[off:off + s]
        cfg = self.config
        new_caches = None if kv_caches is None else []
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, c = layer(x, cos, sin, attn_mask=attn_mask,
                             kv_cache=kv_caches[i], cache_index=cache_index)
                new_caches.append(c)
            elif cfg.recompute and self.training:
                x = recompute(layer, x, cos, sin, attn_mask=attn_mask,
                              segment_ids=segment_ids,
                              policy=cfg.recompute_policy)
            else:
                x = layer(x, cos, sin, attn_mask=attn_mask,
                          segment_ids=segment_ids)
        return x if kv_caches is None else (x, new_caches)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Causal LM over :class:`LlamaModel`; ``.generate`` through
    :class:`GenerationMixin`. Its parameters are trainable, as the JAX
    model's are; the serving engine runs it under
    ``torch.inference_mode()``. Weights are drawn on ``device`` (default
    ``cuda``) from a ``torch.Generator`` seeded with ``seed``: normal with
    the config's ``initializer_range`` (the output projections scaled by
    1/sqrt(2L)), RMS norm weights one. With ``tie_word_embeddings``,
    ``lm_head`` is None and the embedding matrix is the head."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dd = {"device": dev, "dtype": to_torch_dtype(config.dtype)}
        self.model = LlamaModel(config, **dd)
        self.lm_head = None if config.tie_word_embeddings else nn.Linear(
            config.hidden_size, config.vocab_size, bias=False, **dd)
        with torch.no_grad():
            self._init_weights(make_generator(seed, dev))

    @property
    def device(self) -> torch.device:
        return self.head_weight.device

    @property
    def head_weight(self) -> torch.Tensor:
        """The LM head ``[vocab, hidden]``: ``lm_head.weight``, or the
        embedding matrix when the embeddings are tied."""
        return self.model.embed_tokens.weight if self.lm_head is None \
            else self.lm_head.weight

    def _init_weights(self, gen: torch.Generator):
        std = self.config.initializer_range
        out_std = std / math.sqrt(2 * self.config.num_hidden_layers)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(("o_proj.weight", "down_proj.weight")):
                nn.init.normal_(p, 0.0, out_std, generator=gen)
            else:
                nn.init.normal_(p, 0.0, std, generator=gen)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The LM head over NORMED hidden states (``model.norm`` of what
        :meth:`LlamaModel.forward` returns), in the model dtype: ``lm_head``
        or the tied embedding matrix, as ``paddle_tpu/models/llama.py:
        323-332``."""
        return F.linear(hidden, self.head_weight)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None, attn_mask=None,
                segment_ids=None, position_ids=None):
        """Without ``labels``: ``input_ids [b, s]`` -> f32 logits
        ``[b, s, vocab]`` from the f32 tail (where the JAX model keeps the
        model dtype). With ``labels [b, s]`` (``-100`` is ignored), as
        ``paddle_tpu/models/llama.py:334-357``: the final norm and the LM
        head in the model dtype, position t predicting label t + 1, and the
        mean f32 cross-entropy. Returns ``(loss, None)`` from the chunked
        fused loss when ``config.fused_loss``, else ``(loss, logits)``.
        ``attn_mask``, ``segment_ids`` and ``position_ids``: see
        :meth:`LlamaModel.forward`; with packed segments, set the label of
        each segment's first token to ``-100`` (the position before it,
        in the previous sequence, would predict it)."""
        h = self.model(input_ids, attn_mask=attn_mask,
                       segment_ids=segment_ids, position_ids=position_ids)
        if labels is None:
            b, s, d = h.shape
            logits = lm_head_tail(h.reshape(b * s, d), self.model.norm.weight,
                                  self.head_weight.t(),
                                  self.config.rms_norm_eps)
            return logits.view(b, s, -1)
        return self.lm_loss(h, labels)

    def lm_loss(self, h: torch.Tensor, labels: torch.Tensor,
                head: Optional[torch.Tensor] = None):
        """The labelled forward's tail on the decoder's output ``h``: the
        final norm, the LM head (``head``, default :attr:`head_weight`) and
        :func:`causal_lm_loss`."""
        return causal_lm_loss(self.model.norm(h),
                              self.head_weight if head is None else head,
                              labels, self.config.fused_loss)


class KVCache:
    """Static-shape KV cache of one layer for incremental decode
    (``paddle_tpu/models/llama.py:360-383``): ``k``, ``v`` are ``[batch,
    max_seq, kv_heads, head_dim]`` (a layer's slice of a stacked ``[L, B,
    T, kvh, dh]`` cache is one, contiguous and 16-byte aligned as the flash
    kernel's TMA maps need). :meth:`update` writes IN PLACE, where the JAX
    cache returns new arrays."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, length: int = 0):
        self.k, self.v = k, v
        self.length = length

    @classmethod
    def empty(cls, batch, max_seq, kv_heads, head_dim, dtype=torch.bfloat16,
              device=None) -> "KVCache":
        """Zeros on ``device`` (default ``cuda``; ``"cpu"`` when asked)."""
        shape = (batch, max_seq, kv_heads, head_dim)
        dev = resolve_device(device)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), 0)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor, index):
        """Write ``k_new``, ``v_new [b, s, kvh, dh]`` at positions
        ``[index, index + s)``; returns ``(k, v, cache)`` with the cache's
        ``length`` advanced by ``s``."""
        idx, s = int(index), k_new.shape[1]
        if idx < 0 or idx + s > self.k.shape[1]:
            raise ValueError(f"KVCache.update: {s} tokens at index {idx} "
                             f"overflow a cache of {self.k.shape[1]}")
        self.k[:, idx:idx + s] = k_new
        self.v[:, idx:idx + s] = v_new
        return self.k, self.v, KVCache(self.k, self.v, self.length + s)
