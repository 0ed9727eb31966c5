"""Rotary position embedding: rotate-half with a half-duplicated table,
f32 math (the counterpart of ``paddle_tpu/ops/fused/rope.py``)."""

from __future__ import annotations

import torch

from ...amp import amp_op

__all__ = ["build_rope_cache", "apply_rotary_position_embedding"]


def build_rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
                     device=None, dtype=torch.float32):
    """cos/sin tables ``[seq_len, head_dim]`` (half-duplicated)."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, device=device,
                                            dtype=torch.float32) / head_dim))
    pos = torch.arange(seq_len, device=device, dtype=torch.float32)
    freqs = torch.outer(pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


@amp_op("apply_rope")
def apply_rotary_position_embedding(x, cos, sin):
    """x ``[b, s, heads, head_dim]``; cos/sin ``[s, head_dim]`` or
    ``[b, s, head_dim]`` (per-row positions)."""
    if cos.dim() == 3:
        c, s = cos[:, :, None, :].float(), sin[:, :, None, :].float()
    else:
        c, s = cos[None, :, None, :].float(), sin[None, :, None, :].float()
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
