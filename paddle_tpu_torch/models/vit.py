"""Vision Transformer as ``torch.nn`` modules: the counterpart of
``paddle_tpu/models/vit.py``, with the JAX model's parameter names and
shapes (linear weights in PyTorch's ``[out, in]``).

The image is cut into patches by one strided ``F.conv2d`` (JAX's
``lax.conv_general_dilated``; no kernel of the port), a class token and
learned position embeddings join them, a pre-norm ``TransformerEncoder``
(``nn/transformer.py``: non-causal attention through the flash kernels on
the card, exact GELU) runs over the ``num_patches + 1`` tokens, and the
head reads the class token. Every parameter is in the config's dtype, as
``astype(dtype)`` leaves the JAX model. A bf16 model takes f32 images only
under ``amp.auto_cast`` (``conv2d`` is white-listed), as in JAX, whose conv
refuses f32 images against bf16 weights; the flash kernels take bf16 only,
so on the card the attention needs a bf16 model or ``auto_cast``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from ..nn.functional import LayerNorm, cross_entropy
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer, \
    init_linear_

__all__ = ["ViTConfig", "VisionTransformer", "VIT_PRESETS", "PatchEmbed"]


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    attention_dropout: float = 0.0
    dtype: str = "float32"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def num_params(self) -> int:
        """Parameters, as ``VisionTransformer`` holds them."""
        d, p, c = self.hidden_size, self.patch_size, self.in_channels
        f = int(d * self.mlp_ratio)
        layer = 4 * (d * d + d) + 2 * d * f + f + d + 4 * d
        return (c * p * p * d + d + d + (self.num_patches + 1) * d
                + self.num_hidden_layers * layer + 2 * d
                + d * self.num_classes + self.num_classes)


VIT_PRESETS = {
    "vit-b16": ViTConfig(),
    "vit-l16": ViTConfig(hidden_size=1024, num_hidden_layers=24,
                         num_attention_heads=16),
    "vit-h14": ViTConfig(patch_size=14, hidden_size=1280,
                         num_hidden_layers=32, num_attention_heads=16),
    "vit-tiny": ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_classes=10),
}


class PatchEmbed(nn.Module):
    """``[B, C, H, W]`` -> ``[B, num_patches, hidden]`` by one conv with
    kernel and stride ``patch_size``."""

    def __init__(self, cfg: ViTConfig, **dd):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size,
                              kernel_size=cfg.patch_size,
                              stride=cfg.patch_size, **dd)

    def forward(self, x):
        x = self.proj(x)
        return x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)


class VisionTransformer(nn.Module):
    """ViT encoder and classification head. Weights are drawn on ``device``
    (default ``cuda``) from a ``torch.Generator`` seeded with ``seed``, by
    the JAX model's rules: the patch conv Kaiming-uniform (``sqrt(6 /
    fan_in)``), class token and position embeddings truncated normal (std
    0.02, cut at two), linear weights Xavier-uniform, biases 0, norms 1
    and 0; every encoder layer starts as a copy of the first."""

    def __init__(self, config: ViTConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dd = {"device": dev, "dtype": to_torch_dtype(config.dtype)}
        d = config.hidden_size
        self.patch_embed = PatchEmbed(config, **dd)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d, **dd))
        self.pos_embed = nn.Parameter(
            torch.empty(1, config.num_patches + 1, d, **dd))
        self.pos_drop = nn.Dropout(config.dropout)
        layer = TransformerEncoderLayer(
            d, config.num_attention_heads, int(d * config.mlp_ratio),
            dropout=config.dropout, activation="gelu",
            attn_dropout=config.attention_dropout, normalize_before=True,
            **dd)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers,
                                          norm=LayerNorm(d, **dd))
        self.head = nn.Linear(d, config.num_classes, **dd)
        with torch.no_grad():
            self._init_weights(make_generator(seed, dev))

    def _init_weights(self, gen: torch.Generator):
        conv = self.patch_embed.proj
        fan_in = conv.weight[0].numel()
        limit = math.sqrt(6.0 / fan_in)
        conv.weight.uniform_(-limit, limit, generator=gen)
        conv.bias.zero_()
        for p in (self.cls_token, self.pos_embed):
            nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                  generator=gen)
        first = self.encoder.layers[0]
        first.reset_parameters(gen)
        for layer in self.encoder.layers[1:]:
            layer.load_state_dict(first.state_dict())
        init_linear_(self.head, gen)

    def forward(self, x: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        """Logits ``[B, num_classes]``; with ``labels``, ``(mean
        cross-entropy, logits)``."""
        b = x.shape[0]
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(b, 1, x.shape[-1]), x], dim=1)
        x = self.pos_drop(x + self.pos_embed)
        x = self.encoder(x)
        logits = self.head(x[:, 0])
        if labels is None:
            return logits
        return cross_entropy(logits, labels), logits
