"""Rotary position embedding: rotate-half with a half-duplicated table,
f32 math (the counterpart of ``paddle_tpu/ops/fused/rope.py``)."""

from __future__ import annotations

import torch

from ...amp import amp_op

__all__ = ["build_rope_cache", "apply_rotary_position_embedding",
           "fused_rotary_position_embedding"]


def build_rope_cache(seq_len: int, head_dim: int, base: float = 10000.0,
                     device=None, dtype=torch.float32, position_ids=None):
    """cos/sin tables ``[seq_len, head_dim]`` (half-duplicated); with
    ``position_ids`` (1-D) one row per given position instead of
    ``0 .. seq_len - 1``."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, device=device,
                                            dtype=torch.float32) / head_dim))
    pos = torch.arange(seq_len, device=device, dtype=torch.float32) \
        if position_ids is None else torch.as_tensor(
            position_ids, device=device).to(torch.float32).reshape(-1)
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


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """``paddle.incubate.nn.functional.fused_rotary_position_embedding``
    as ``paddle_tpu/ops/fused/rope.py`` has it: rotate-half rope on q (and
    k, v when given), ``[b, s, heads, head_dim]`` each. ``cos``/``sin`` are
    ``[s, head_dim]``, ``[b, s, head_dim]`` or Paddle's ``[1, s, 1,
    head_dim]``; without them the tables are built for positions ``0 ..
    s - 1`` (or ``position_ids``). Returns one tensor or a tuple."""
    if cos is None or sin is None:
        cos, sin = build_rope_cache(q.shape[1], q.shape[-1], device=q.device,
                                    position_ids=position_ids)
    elif cos.dim() == 4:
        cos, sin = cos[0, :, 0, :], sin[0, :, 0, :]
    outs = [apply_rotary_position_embedding(t, cos, sin)
            for t in (q, k, v) if t is not None]
    return tuple(outs) if len(outs) > 1 else outs[0]
