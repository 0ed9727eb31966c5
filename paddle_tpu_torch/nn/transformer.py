"""Transformer layers for the port (the counterpart of
``paddle_tpu/nn/transformer.py``): ``MultiHeadAttention``,
``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and ``Transformer``.

Query, key and value are ``[batch, seq, embed_dim]``; attention runs in
``[b, s, h, d]`` through ``scaled_dot_product_attention`` (the flash
kernels on the card), never materialising the score matrix. The
projections are ``torch.nn.Linear`` (weights ``[out, in]``), so
``models/convert.py`` transposes the JAX weights into them; norms are the
port's ``LayerNorm`` (JAX's rounding in bf16). As in JAX, an encoder or
decoder of N layers holds the given layer and N - 1 deep copies of it: all
start from the same weights. Weights are drawn by ``reset_parameters(gen)``
from a ``torch.Generator``: linear weights Xavier-uniform, biases 0, norms 1
and 0, as the JAX layers initialise them.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch import nn

from . import functional as F
from .functional import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "init_linear_"]

_ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}


def init_linear_(mod: nn.Linear, gen: torch.Generator) -> None:
    """Xavier-uniform weight and zero bias, as the JAX ``Linear``."""
    fan_out, fan_in = mod.weight.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        mod.weight.uniform_(-limit, limit, generator=gen)
        if mod.bias is not None:
            mod.bias.zero_()


def _activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r} — known: "
                         f"{', '.join(sorted(_ACTIVATIONS))}") from None


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention over ``[b, s, embed_dim]`` with an optional
    incremental ``Cache`` of keys and values (``[b, s, h, d]``)."""

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, bias: bool = True, device=None,
                 dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not split into "
                             f"{num_heads} heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        dd = {"device": device, "dtype": dtype, "bias": bias}
        self.q_proj = nn.Linear(embed_dim, embed_dim, **dd)
        self.k_proj = nn.Linear(kdim or embed_dim, embed_dim, **dd)
        self.v_proj = nn.Linear(vdim or embed_dim, embed_dim, **dd)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **dd)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.q_proj, self.k_proj, self.v_proj, self.out_proj):
            init_linear_(m, gen)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = MultiHeadAttention.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        return out if cache is None else (out, cache)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """An empty incremental cache (``value`` None) or one holding the
        projected ``key`` and ``value``."""
        if value is None:
            z = key.new_zeros(key.shape[0], 0, self.num_heads,
                              self.head_dim)
            return MultiHeadAttention.Cache(z, z.clone())
        return MultiHeadAttention.Cache(self._shape(self.k_proj(key)),
                                        self._shape(self.v_proj(value)))


def _ffn(layer, x):
    return layer.linear2(layer.act_dropout(layer.activation(
        layer.linear1(x))))


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual; norms
    before them (``normalize_before``) or after."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, bias: bool = True,
                 layer_norm_eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        dd = {"device": device, "dtype": dtype}
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=dropout if attn_dropout is None else attn_dropout,
            bias=bias, **dd)
        self.linear1 = nn.Linear(d_model, dim_feedforward, bias=bias, **dd)
        self.linear2 = nn.Linear(dim_feedforward, d_model, bias=bias, **dd)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.act_dropout = nn.Dropout(
            dropout if act_dropout is None else act_dropout)
        self.activation = _activation(activation)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.self_attn.reset_parameters(gen)
        init_linear_(self.linear1, gen)
        init_linear_(self.linear2, gen)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, attn_mask=src_mask)
        else:
            src, cache = self.self_attn(src, attn_mask=src_mask, cache=cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = residual + self.dropout2(_ffn(self, src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(nn.Module):
    """``encoder_layer`` and ``num_layers - 1`` deep copies of it, then an
    optional final ``norm``."""

    def __init__(self, encoder_layer: nn.Module, num_layers: int,
                 norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        return out if self.norm is None else self.norm(out)


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each with a residual and a norm (before or after)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, bias: bool = True,
                 layer_norm_eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        dd = {"device": device, "dtype": dtype}
        ad = dropout if attn_dropout is None else attn_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            bias=bias, **dd)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             bias=bias, **dd)
        self.linear1 = nn.Linear(d_model, dim_feedforward, bias=bias, **dd)
        self.linear2 = nn.Linear(dim_feedforward, d_model, bias=bias, **dd)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **dd)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.dropout3 = nn.Dropout(dropout)
        self.act_dropout = nn.Dropout(
            dropout if act_dropout is None else act_dropout)
        self.activation = _activation(activation)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.self_attn.reset_parameters(gen)
        self.cross_attn.reset_parameters(gen)
        init_linear_(self.linear1, gen)
        init_linear_(self.linear2, gen)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = residual + self.dropout1(self.self_attn(tgt,
                                                      attn_mask=tgt_mask))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = residual + self.dropout2(self.cross_attn(
            tgt, memory, memory, attn_mask=memory_mask))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = residual + self.dropout3(_ffn(self, tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(nn.Module):
    """``decoder_layer`` and ``num_layers - 1`` deep copies of it, then an
    optional final ``norm``."""

    def __init__(self, decoder_layer: nn.Module, num_layers: int,
                 norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        return out if self.norm is None else self.norm(out)


class Transformer(nn.Module):
    """An encoder and a decoder (final norms when ``normalize_before``)."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, bias: bool = True,
                 custom_encoder: Optional[nn.Module] = None,
                 custom_decoder: Optional[nn.Module] = None, device=None,
                 dtype=None):
        super().__init__()
        dd = {"device": device, "dtype": dtype}
        self.d_model = d_model
        self.nhead = nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, bias)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **dd), num_encoder_layers,
                LayerNorm(d_model, **dd) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **dd), num_decoder_layers,
                LayerNorm(d_model, **dd) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length: int):
        """``[length, length]`` f32: 0 on and below the diagonal, -inf
        above."""
        keep = torch.tril(torch.ones(length, length, dtype=torch.bool))
        return torch.where(keep, 0.0, float("-inf"))
