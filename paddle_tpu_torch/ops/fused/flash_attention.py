"""Flash attention: the plain PyTorch version and the dispatch.

Layout is BSHD (``[batch, seq, heads, head_dim]``) with GQA (kv heads
divide query heads, never repeated in the kernel), causal masking with a
bottom-right ``q_offset`` and a ``kv_len`` tail — the subset of
``paddle_tpu/ops/fused/flash_attention.py`` that the serving path runs.
CPU tensors take the plain version; CUDA tensors launch the hand-written
kernel (``ops/cuda/flash_attention.py``) or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attn_reference"]


def _resolve(q, k, scale, kv_len, q_offset):
    sq, sk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    kv_len = sk if kv_len is None else int(kv_len)
    # bottom-right alignment by default, as the JAX flash_attention_bhsd
    q_offset = kv_len - sq if q_offset is None else int(q_offset)
    return scale, kv_len, q_offset


def flash_attn_reference(q, k, v, causal: bool = False,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         q_offset: Optional[int] = None) -> torch.Tensor:
    """Dense softmax(q kᵀ·scale) v with f32 math. Row r sees column c iff
    ``c < kv_len`` and, when causal, ``c <= q_offset + r`` (``q_offset``
    defaults to ``kv_len - sq``). A row that sees nothing gives zeros."""
    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hk != hq:
        kf = kf.repeat_interleave(hq // hk, dim=2)
        vf = vf.repeat_interleave(hq // hk, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    col = torch.arange(sk, device=q.device)
    visible = (col < kv_len)[None, :].expand(sq, sk)
    if causal:
        row = torch.arange(sq, device=q.device)
        visible = visible & (col[None, :] <= row[:, None] + q_offset)
    logits = logits.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(logits, dim=-1).masked_fill(
        ~visible.any(dim=-1, keepdim=True), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """The flash forward on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_attn_reference(q, k, v, causal, scale, kv_len, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from ..cuda.flash_attention import flash_attention_cuda

    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    return flash_attention_cuda(q, k, v, causal, scale, q_offset, kv_len)
