"""Normalisation and activation of the Llama path, in two roundings.

``rms_norm``, ``swiglu`` and ``RMSNorm`` are the model's layers and round as
``paddle_tpu/nn/functional.py`` does (:377, :182): the norm casts to the
input dtype BEFORE the weight multiply, and swiglu runs
``x * (1 / (1 + exp(-x))) * y`` op by op in the input dtype. In bf16 that is
bit for bit what the JAX model computes on the CPU.

``rms_norm_f32`` and ``swiglu_f32`` follow the fused serving path of the JAX
package (``incubate/nn/functional/fused_transformer.py``): the math runs in
f32 and the result is cast back once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["rms_norm", "swiglu", "RMSNorm", "rms_norm_f32", "swiglu_f32"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """``(x * rsqrt(mean(x²) + eps))`` in f32, cast to ``x.dtype``, then
    times ``weight``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


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
