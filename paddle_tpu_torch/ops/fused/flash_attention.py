"""Flash attention: the plain PyTorch versions and the dispatch.

Layout is BSHD (``[batch, seq, heads, head_dim]``) with GQA (kv heads
divide query heads, never repeated in the kernels), causal masking with a
bottom-right ``q_offset`` and a ``kv_len`` tail — the subset of
``paddle_tpu/ops/fused/flash_attention.py`` that the serving and training
paths run. When grad is enabled and an input requires it, the dispatch goes
through an autograd Function whose forward keeps the row logsumexp and
whose backward is the flash backward; otherwise (serving,
``inference_mode``) it calls the bare forward. CPU tensors take the plain
versions; CUDA tensors launch the hand-written kernels
(``ops/cuda/flash_attention.py``) or raise.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["flash_attention", "flash_attn_reference",
           "flash_attn_bwd_reference", "EMPTY_ROW_LSE"]

#: the lse of a row that sees no column: the JAX kernel's
#: ``(m + log2 1) / log2(e)`` with ``m = -1e30``, in f32
EMPTY_ROW_LSE = float(np.float32(-1e30) * np.float32(1.0 / math.log2(math.e)))


def _resolve(q, k, scale, kv_len, q_offset):
    sq, sk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    kv_len = sk if kv_len is None else int(kv_len)
    # bottom-right alignment by default, as the JAX flash_attention_bhsd
    q_offset = kv_len - sq if q_offset is None else int(q_offset)
    return scale, kv_len, q_offset


def _visible(sq, sk, causal, kv_len, q_offset, device):
    """``[sq, sk]`` bool: row r sees column c."""
    col = torch.arange(sk, device=device)
    visible = (col < kv_len)[None, :].expand(sq, sk)
    if causal:
        row = torch.arange(sq, device=device)
        visible = visible & (col[None, :] <= row[:, None] + q_offset)
    return visible


def _repeat_kv(t, group):
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def flash_attn_reference(q, k, v, causal: bool = False,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         q_offset: Optional[int] = None,
                         return_lse: bool = False):
    """Dense softmax(q kᵀ·scale) v with f32 math. Row r sees column c iff
    ``c < kv_len`` and, when causal, ``c <= q_offset + r`` (``q_offset``
    defaults to ``kv_len - sq``). A row that sees nothing gives zeros. With
    ``return_lse`` also the f32 row logsumexp ``[b, hq, sq]`` of the scaled
    scores (natural log; :data:`EMPTY_ROW_LSE` for a row that sees
    nothing)."""
    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kf = _repeat_kv(k.float(), hq // hk)
    vf = _repeat_kv(v.float(), hq // hk)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    visible = _visible(sq, sk, causal, kv_len, q_offset, q.device)
    logits = logits.masked_fill(~visible, float("-inf"))
    seen = visible.any(dim=-1, keepdim=True)
    probs = torch.softmax(logits, dim=-1).masked_fill(~seen, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1).masked_fill(~seen[:, 0],
                                                      EMPTY_ROW_LSE)
    return out, lse


def flash_attn_bwd_reference(q, k, v, out, lse, dout, causal: bool = False,
                             scale: Optional[float] = None,
                             kv_len: Optional[int] = None,
                             q_offset: Optional[int] = None):
    """The plain backward: ``(dq, dk, dv)`` in the inputs' dtypes from the
    forward's ``out`` and ``lse [b, hq, sq]``, by the FlashAttention-2
    formulas in f32: ``P = exp(s - lse)`` on visible pairs (0 elsewhere),
    ``delta = rowsum(dO·O)``, ``dS = P·(dP - delta)``, ``dQ = scale·dS K``,
    ``dK = scale·dSᵀ Q``, ``dV = Pᵀ dO``; dK and dV are summed over each kv
    head's group of query heads."""
    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    group = hq // hk
    qf, dof = q.float(), dout.float()
    kf, vf = _repeat_kv(k.float(), group), _repeat_kv(v.float(), group)
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    visible = _visible(sq, sk, causal, kv_len, q_offset, q.device)
    p = torch.where(visible, torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * out.float()).sum(dim=-1).transpose(1, 2)   # [b, hq, sq]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if group > 1:
        dk = dk.reshape(b, sk, hk, group, d).sum(dim=3)
        dv = dv.reshape(b, sk, hk, group, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, causal, scale, kv_len, q_offset, return_lse):
    if q.device.type == "cpu":
        return flash_attn_reference(q, k, v, causal, scale, kv_len, q_offset,
                                    return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from ..cuda.flash_attention import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal, scale, q_offset, kv_len,
                                return_lse)


def _backward(q, k, v, out, lse, dout, causal, scale, kv_len, q_offset):
    if q.device.type == "cpu":
        return flash_attn_bwd_reference(q, k, v, out, lse, dout, causal,
                                        scale, kv_len, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from ..cuda.flash_attention import flash_attention_bwd_cuda

    return flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, scale,
                                    q_offset, kv_len)


class _FlashAttention(torch.autograd.Function):
    """The forward saves q, k, v, out and lse; the backward is the flash
    backward (kernel on CUDA, plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len, q_offset):
        out, lse = _forward(q, k, v, causal, scale, kv_len, q_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, kv_len, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand the gradient over strided
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention (kernels on CUDA tensors, plain versions on CPU
    ones), differentiable in q, k and v when grad is enabled."""
    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, kv_len,
                                     q_offset)
    return _forward(q, k, v, causal, scale, kv_len, q_offset, False)
