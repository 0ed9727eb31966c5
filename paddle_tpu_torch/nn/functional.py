"""Normalisation and activation of the Llama path.

Both follow the fused serving path of the JAX package
(``incubate/nn/functional/fused_transformer.py``): the math runs in f32
and the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["rms_norm", "swiglu", "RMSNorm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * weight`` in f32, cast to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
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
