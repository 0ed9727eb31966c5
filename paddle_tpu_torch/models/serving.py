"""One fused decode (or prefill) step over a stacked decoder, its weights
held as buffers (the counterpart of ``paddle_tpu/models/serving.py``'s
``ServingDecoder``). The JAX module's ``export_decoder`` writes a StableHLO
artifact through ``jit.save``; the port has no saved-program format yet,
so only the step is here.
"""

from __future__ import annotations

import torch
from torch import nn

from .generation import f32_head, fused_decoder_step
from .kv_cache import KVCacheSpec

__all__ = ["ServingDecoder"]


class ServingDecoder(nn.Module):
    """``forward(tokens, cache_k, cache_v, cache_index) -> (logits, cache_k,
    cache_v)``.

    - dense mode: caches ``[L, B, S_max, kvh, dh]``; ``tokens [B, span]``
      is a prefill span or one decode token a row
      (``fused_multi_transformer``);
    - paged mode: caches are page buffers ``[L, kvh, B * pps, page, dh]``
      of the contiguous layout (``KVCacheSpec.paged_contiguous_shape``),
      decode only (``fused_multi_transformer_paged``).

    The caches are written in place and returned. The logits ``[B, V]``
    are f32, from :func:`lm_head_tail` over each row's last position. The
    fused stack (``fused_weights_from_llama``, optionally int8 / packed
    int4), the embedding, the final norm, the head (f32 ``[D, V]``,
    converted once) and the rope tables of ``max_len`` rows are buffers,
    on the model's device."""

    def __init__(self, model, quantize=False, paged: bool = False,
                 page_size: int = 16, max_len: int = 2048):
        super().__init__()
        from ..incubate.nn.functional.fused_transformer import (
            fused_weights_from_llama)
        from ..ops.fused.rope import build_rope_cache

        if quantize is True:
            quantize = "int8"
        cfg = model.config
        self.config = cfg
        self.paged = bool(paged)
        self.cache_spec = KVCacheSpec.from_config(cfg, page_size=page_size)
        head = f32_head(model, "ServingDecoder")
        with torch.no_grad():
            w = fused_weights_from_llama(model, quantize=quantize)
        self._w_fields = []
        for name, val in w.__dict__.items():
            self._w_fields.append(name)
            self.register_buffer(f"w_{name}", val)
        self.register_buffer("embed",
                             model.model.embed_tokens.weight.detach())
        self.register_buffer("final_norm", model.model.norm.weight.detach())
        self.register_buffer("head", head)
        cos, sin = build_rope_cache(max_len, cfg.head_dim, cfg.rope_theta,
                                    device=head.device)
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)

    def weights(self):
        """The buffers as a ``FusedTransformerWeights``."""
        from ..incubate.nn.functional.fused_transformer import (
            FusedTransformerWeights)

        return FusedTransformerWeights(**{
            name: getattr(self, f"w_{name}") for name in self._w_fields})

    @torch.inference_mode()
    def forward(self, tokens, cache_k, cache_v, cache_index):
        tokens = torch.as_tensor(tokens).to(self.embed.device, torch.long)
        idx, span = int(cache_index), tokens.shape[1]
        if idx < 0 or idx + span > self.rope_cos.shape[0]:
            raise ValueError(f"ServingDecoder: positions [{idx}, "
                             f"{idx + span}) outside the rope table of "
                             f"{self.rope_cos.shape[0]} (max_len)")
        return fused_decoder_step(
            self.config, self.weights(), self.embed, self.final_norm,
            self.head, self.rope_cos, self.rope_sin, tokens, cache_k,
            cache_v, idx, self.paged)
