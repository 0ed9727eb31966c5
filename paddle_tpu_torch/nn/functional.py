"""Normalisation and activation of the model layers, in two roundings.

``rms_norm``, ``swiglu`` and ``RMSNorm`` are the model's layers and round as
``paddle_tpu/nn/functional.py`` does (:377, :182): the norm casts to the
input dtype BEFORE the weight multiply, and swiglu runs
``x * (1 / (1 + exp(-x))) * y`` op by op in the input dtype. In bf16 that is
bit for bit what the JAX model computes on the CPU.

``rms_norm_f32`` and ``swiglu_f32`` follow the fused serving path of the JAX
package (``incubate/nn/functional/fused_transformer.py``): the math runs in
f32 and the result is cast back once.

``layer_norm`` and ``group_norm`` (the RWKV layers) round as
``paddle_tpu/nn/functional.py:356-373`` and ``:426-445`` do: statistics in
f32, the normalised value cast to the input dtype before the affine
multiply and add (``torch.nn.LayerNorm`` rounds elsewhere in bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import amp_op

__all__ = ["rms_norm", "swiglu", "RMSNorm", "rms_norm_f32", "swiglu_f32",
           "layer_norm", "group_norm", "LayerNorm", "GroupNorm"]


@amp_op("rms_norm")
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """``(x * rsqrt(mean(x²) + eps))`` in f32, cast to ``x.dtype``, then
    times ``weight``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


@amp_op("swiglu")
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` as ``jax.nn.silu`` spells it, in the input
    dtype."""
    return gate * (1 / (1 + torch.exp(-gate))) * up


def rms_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * weight`` in f32, cast to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def swiglu_f32(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in f32, cast to ``gate.dtype``."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


@amp_op("layer_norm")
def layer_norm(x: torch.Tensor, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis: ``(x - mean) * rsqrt(var + eps)`` in f32, cast to
    ``x.dtype``, then times ``weight`` and plus ``bias``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


@amp_op("group_norm")
def group_norm(x: torch.Tensor, num_groups: int, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """x ``[N, C, ...]`` in ``num_groups`` groups of channels: statistics
    over each group (and the trailing axes) in f32, the normalised value
    cast to ``x.dtype``, then the per-channel ``weight`` and ``bias``."""
    n, c = x.shape[0], x.shape[1]
    xs = x.reshape(n, num_groups, c // num_groups, *x.shape[2:])
    dims = tuple(range(2, xs.dim()))
    xf = xs.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype).reshape(x.shape)
    shape = [1, c] + [1] * (x.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


class LayerNorm(nn.Module):
    """Weight 1 and bias 0 over the last axis of ``hidden_size``."""

    def __init__(self, hidden_size: int, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """Weight 1 and bias 0 per channel of ``num_channels`` in
    ``num_groups`` groups."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 device=None, dtype=torch.float32):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"GroupNorm: {num_channels} channels do not "
                             f"split into {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(num_channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(num_channels, device=device, dtype=dtype))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps)
