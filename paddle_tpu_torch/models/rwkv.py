"""RWKV-5 causal LM as ``torch.nn`` modules: the counterpart of
``paddle_tpu/models/rwkv.py``, with the JAX model's parameter names and
shapes (linear weights in PyTorch's ``[out, in]``).

Time mixing: token-shift lerps, the r/k/v/g projections, the WKV recurrence
(``ops/fused/rwkv.py``: the hand-written kernels on CUDA tensors, the plain
chunked version on CPU tensors) with the per-(head, channel) log decay
``max(-exp(decay), -1e10)`` and the bonus, a per-head ``GroupNorm`` on
``[b l, D]``, the ``silu(g)`` gate and o_proj. Channel mixing: token shift,
``relu(k)²`` and a sigmoid gate. Every parameter is in the config's dtype,
as ``astype(dtype)`` leaves the JAX model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from ..nn.functional import GroupNorm, LayerNorm
from ..ops.fused.rwkv import rwkv_linear_attention, rwkv_log_decay, \
    token_shift
from .llama import causal_lm_loss

__all__ = ["RwkvConfig", "RwkvForCausalLM", "RwkvTimeMix", "RwkvChannelMix",
           "RwkvBlock"]


@dataclass
class RwkvConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    head_dim: int = 64
    intermediate_size: int = 0      # 0 -> 3.5 x hidden
    layer_norm_eps: float = 1e-5
    wkv_chunk: int = 32             # the plain version's chunk
    wkv_subchunk: int = 16          # and its sub-chunk block
    initializer_range: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        if self.hidden_size % self.head_dim:
            raise ValueError("hidden_size must be divisible by head_dim")
        if self.intermediate_size == 0:
            self.intermediate_size = int(3.5 * self.hidden_size)

    @property
    def num_heads(self) -> int:
        return self.hidden_size // self.head_dim


def _mix_init(cfg: RwkvConfig, layer_id: int) -> float:
    ratio = layer_id / max(cfg.num_hidden_layers - 1, 1)
    return 0.5 * (1 - ratio) + 0.2


class RwkvTimeMix(nn.Module):
    def __init__(self, cfg: RwkvConfig, layer_id: int, **dd):
        super().__init__()
        D, H, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.cfg = cfg
        mix = _mix_init(cfg, layer_id)
        for name in ("mix_r", "mix_k", "mix_v", "mix_g"):
            setattr(self, name, nn.Parameter(torch.full((D,), mix, **dd)))
        for name in ("r_proj", "k_proj", "v_proj", "g_proj", "o_proj"):
            setattr(self, name, nn.Linear(D, D, bias=False, **dd))
        # the rwkv5 "time_decay" ramp: fast channels to slow ones
        ramp = torch.tensor([-6.0 + 5.0 * (i / max(hd - 1, 1)) ** 0.7
                             for i in range(hd)], dtype=torch.float32)
        self.decay = nn.Parameter(ramp.repeat(H, 1).to(**dd))
        self.bonus = nn.Parameter(torch.full((H, hd), 0.5, **dd))
        self.ln_x = GroupNorm(H, D, eps=cfg.layer_norm_eps * 64, **dd)

    def forward(self, x):
        cfg = self.cfg
        b, l, D = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        xx = token_shift(x)

        def mixed(mu):
            return x * mu + xx * (1.0 - mu)

        r = self.r_proj(mixed(self.mix_r)).reshape(b, l, H, hd)
        k = self.k_proj(mixed(self.mix_k)).reshape(b, l, H, hd)
        v = self.v_proj(mixed(self.mix_v)).reshape(b, l, H, hd)
        g = self.g_proj(mixed(self.mix_g))
        wkv = rwkv_linear_attention(r, k, v, rwkv_log_decay(self.decay),
                                    self.bonus, cfg.wkv_chunk,
                                    cfg.wkv_subchunk)
        wkv = self.ln_x(wkv.reshape(b * l, D)).reshape(b, l, D)
        return self.o_proj(wkv * F.silu(g))


class RwkvChannelMix(nn.Module):
    def __init__(self, cfg: RwkvConfig, layer_id: int, **dd):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        mix = _mix_init(cfg, layer_id)
        self.mix_k = nn.Parameter(torch.full((D,), mix, **dd))
        self.mix_r = nn.Parameter(torch.full((D,), mix, **dd))
        self.k_proj = nn.Linear(D, I, bias=False, **dd)
        self.r_proj = nn.Linear(D, D, bias=False, **dd)
        self.v_proj = nn.Linear(I, D, bias=False, **dd)

    def forward(self, x):
        xx = token_shift(x)
        kx = x * self.mix_k + xx * (1.0 - self.mix_k)
        rx = x * self.mix_r + xx * (1.0 - self.mix_r)
        k = F.relu(self.k_proj(kx)) ** 2
        return torch.sigmoid(self.r_proj(rx)) * self.v_proj(k)


class RwkvBlock(nn.Module):
    def __init__(self, cfg: RwkvConfig, layer_id: int, **dd):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **dd)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **dd)
        self.att = RwkvTimeMix(cfg, layer_id, **dd)
        self.ffn = RwkvChannelMix(cfg, layer_id, **dd)

    def forward(self, x):
        x = x + self.att(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class RwkvForCausalLM(nn.Module):
    """Weights are drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``: normal(0, initializer_range)
    for the embedding and every linear weight, the JAX model's constants for
    the mixes, decay ramp and bonus, norms 1 and 0."""

    def __init__(self, config: RwkvConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dd = {"device": dev, "dtype": to_torch_dtype(config.dtype)}
        D = config.hidden_size
        self.embeddings = nn.Embedding(config.vocab_size, D, **dd)
        self.ln0 = LayerNorm(D, config.layer_norm_eps, **dd)
        self.blocks = nn.ModuleList(
            [RwkvBlock(config, i, **dd)
             for i in range(config.num_hidden_layers)])
        self.ln_out = LayerNorm(D, config.layer_norm_eps, **dd)
        self.head = nn.Linear(D, config.vocab_size, bias=False, **dd)
        with torch.no_grad():
            gen = make_generator(seed, dev)
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    nn.init.normal_(mod.weight, 0.0,
                                    config.initializer_range, generator=gen)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        """Without ``labels``: logits ``[b, l, vocab]`` in the model dtype.
        With them: ``(loss, logits)``, the mean f32 cross-entropy of
        position t against label t + 1."""
        x = self.ln0(self.embeddings(input_ids))
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_out(x)
        if labels is None:
            return self.head(x)
        return causal_lm_loss(x, self.head.weight, labels, fused_loss=False)
