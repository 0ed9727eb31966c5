"""MoE decoder LM: a Llama trunk whose every ``moe_every``-th layer routes
its FFN to experts (the counterpart of ``paddle_tpu/models/moe_llm.py``).

Parameter names are the JAX model's (``embed_tokens``, ``layers.{i}``,
``norm``, ``lm_head`` at the top, no ``model.`` prefix); a layer's ``mlp``
is a ``LlamaMLP`` or, when ``i % moe_every == moe_every - 1``, a
``MoELayer`` (``GShardGate``, or ``SwitchGate`` at top-1, over swiglu
``MLPExperts``). The gates' aux losses join the LM loss with weight
``aux_loss_alpha``. With ``recompute`` the dense layers are recomputed in
the backward under ``recompute_policy``; the MoE layers are not, as in the
JAX model (their gate's ``aux_loss`` is a side output of the forward).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from ..framework.recompute import recompute
from ..nn.functional import RMSNorm
from ..ops.fused.rope import build_rope_cache
from ..parallel.moe import GShardGate, MLPExperts, MoELayer, SwitchGate
from .llama import LlamaAttention, LlamaConfig, LlamaMLP, causal_lm_loss

__all__ = ["MoELlamaConfig", "MoELlamaForCausalLM"]


@dataclass
class MoELlamaConfig(LlamaConfig):
    moe_num_experts: int = 8
    moe_topk: int = 2
    moe_every: int = 2            # every k-th layer is MoE
    moe_capacity_factor: float = 2.0
    aux_loss_alpha: float = 0.01

    def param_counts(self):
        """``(total, activated per token)``: the activated count leaves out
        the FFN weights (``3 h i``) of the experts a token is not routed to,
        as ``bench.py:236-242`` counts them."""
        h, i, E = self.hidden_size, self.intermediate_size, \
            self.moe_num_experts
        n_moe = self.num_hidden_layers // self.moe_every
        expert = 3 * h * i + 2 * i + h            # w1, w2, b1, b2
        moe_extra = E * expert + h * E - 3 * h * i
        total = self.num_params() + n_moe * moe_extra
        return total, total - n_moe * (E - self.moe_topk) * 3 * h * i


class MoEDecoderLayer(nn.Module):
    def __init__(self, cfg: MoELlamaConfig, use_moe: bool, **dd):
        super().__init__()
        h = cfg.hidden_size
        self.input_layernorm = RMSNorm(h, cfg.rms_norm_eps, **dd)
        self.self_attn = LlamaAttention(cfg, **dd)
        self.post_attention_layernorm = RMSNorm(h, cfg.rms_norm_eps, **dd)
        self.use_moe = use_moe
        if use_moe:
            gate_cls = SwitchGate if cfg.moe_topk == 1 else GShardGate
            self.mlp = MoELayer(
                gate_cls(h, cfg.moe_num_experts,
                         capacity_factor=cfg.moe_capacity_factor, **dd),
                MLPExperts(cfg.moe_num_experts, h, cfg.intermediate_size,
                           activation="swiglu", **dd))
        else:
            self.mlp = LlamaMLP(cfg, **dd)

    def forward(self, x, cos, sin, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin,
                               attn_mask=attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class MoELlamaForCausalLM(nn.Module):
    """Weights are drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``: the Llama layers as
    ``LlamaForCausalLM`` draws them, gates and experts Xavier-uniform with
    zero expert biases. The head is untied, as in the JAX model."""

    def __init__(self, config: MoELlamaConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dd = {"device": dev, "dtype": to_torch_dtype(config.dtype)}
        every = config.moe_every
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **dd)
        self.layers = nn.ModuleList([
            MoEDecoderLayer(config, use_moe=(i % every == every - 1), **dd)
            for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **dd)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, **dd)
        cos, sin = build_rope_cache(config.max_position_embeddings,
                                    config.head_dim, config.rope_theta,
                                    device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        with torch.no_grad():
            self._init_weights(make_generator(seed, dev))

    def moe_layers(self):
        return [layer.mlp for layer in self.layers if layer.use_moe]

    def _init_weights(self, gen: torch.Generator):
        std = self.config.initializer_range
        out_std = std / math.sqrt(2 * self.config.num_hidden_layers)
        for name, p in self.named_parameters():
            if ".mlp.gate." in name or ".mlp.experts." in name:
                continue                     # the MoE modules' own rule
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith(("o_proj.weight", "down_proj.weight")):
                nn.init.normal_(p, 0.0, out_std, generator=gen)
            else:
                nn.init.normal_(p, 0.0, std, generator=gen)
        for moe in self.moe_layers():
            moe.gate.reset_parameters(gen)
            moe.experts.reset_parameters(gen)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None, attn_mask=None):
        """Without ``labels``: logits ``[b, s, vocab]`` in the model dtype,
        as the JAX model returns them. With ``labels``: ``(loss + alpha ·
        Σ aux, None)`` from the chunked fused loss when
        ``config.fused_loss``, else ``(loss + alpha · Σ aux, logits)``.
        ``attn_mask`` as ``flash_attention`` takes it."""
        s = input_ids.shape[1]
        if s > self.rope_cos.shape[0]:
            raise ValueError(f"sequence {s} exceeds max_position_embeddings "
                             f"{self.rope_cos.shape[0]}")
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos[:s], self.rope_sin[:s]
        aux_total = None
        cfg = self.config
        for layer in self.layers:
            if cfg.recompute and self.training and not layer.use_moe:
                x = recompute(layer, x, cos, sin, attn_mask=attn_mask,
                              policy=cfg.recompute_policy)
            else:
                x = layer(x, cos, sin, attn_mask=attn_mask)
            if layer.use_moe:
                a = layer.mlp.aux_loss
                aux_total = a if aux_total is None else aux_total + a
        x = self.norm(x)
        if labels is None:
            return self.lm_head(x)
        loss, logits = causal_lm_loss(x, self.lm_head.weight, labels,
                                      self.config.fused_loss)
        if aux_total is not None:
            loss = loss + aux_total * self.config.aux_loss_alpha
        return loss, logits
