"""Flash attention: the plain PyTorch versions and the dispatch.

Layout is BSHD (``[batch, seq, heads, head_dim]``) with GQA (kv heads
divide query heads, never repeated in the kernels), causal masking with a
bottom-right ``q_offset``, a ``kv_len`` tail, an additive or bool
``attn_mask`` and packed-varlen segment ids — the surface of
``paddle_tpu/ops/fused/flash_attention.py`` that the serving and training
paths run (dropout is not ported). When grad is enabled and q, k or v
requires it, the dispatch calls the ``paddle_tpu_torch::flash_fwd``
operator, which returns the output and the row logsumexp and whose
backward is the flash backward; being an operator of the dispatcher, a
selective-checkpoint policy can keep its outputs (``framework/recompute``).
Otherwise (serving, ``inference_mode``) it calls the bare forward. CPU
tensors take the plain versions; CUDA tensors launch the hand-written
kernels (``ops/cuda/flash_attention.py``) or raise. A mask that requires
grad takes the plain version with autograd on every device, as the JAX
dispatch routes a trainable mask to its dense path: the kernels' backward
gives the mask no gradient.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...amp import amp_op

__all__ = ["flash_attention", "flash_attn_reference",
           "flash_attn_bwd_reference", "EMPTY_ROW_LSE"]

#: the lse of a row that sees no column: the JAX kernel's
#: ``(m + log2 1) / log2(e)`` with ``m = -1e30``, in f32
EMPTY_ROW_LSE = float(np.float32(-1e30) * np.float32(1.0 / math.log2(math.e)))

#: calls that took the plain version with autograd because ``attn_mask``
#: requires grad, since the count was last set to 0
dense_calls = 0


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


def broadcast_mask(attn_mask, q, k):
    """``attn_mask`` as a 4-D view ``[b, hq | 1, sq, sk]`` (no copy): 2-D
    is ``[sq, sk]``, 3-D ``[b, sq, sk]``, 4-D ``[b | 1, hq | 1, sq, sk]``,
    each dimension of size 1 broadcast (stride 0)."""
    b, sq, hq = q.shape[0], q.shape[1], q.shape[2]
    sk = k.shape[1]
    m = attn_mask
    if m.dim() == 2:
        m = m[None, None]
    elif m.dim() == 3:
        m = m[:, None]
    elif m.dim() != 4:
        raise ValueError(f"flash_attention: attn_mask must be 2-, 3- or "
                         f"4-D, got {tuple(attn_mask.shape)}")
    heads = m.shape[1]
    if heads not in (1, hq) or m.dtype not in (torch.bool, torch.float32,
                                               torch.bfloat16, torch.float16):
        raise ValueError(f"flash_attention: attn_mask {tuple(m.shape)} "
                         f"{m.dtype} must be bool or float and broadcast "
                         f"to [{b}, {hq} | 1, {sq}, {sk}]")
    try:
        return m.expand(b, heads, sq, sk)
    except RuntimeError:
        raise ValueError(f"flash_attention: attn_mask {tuple(attn_mask.shape)}"
                         f" does not broadcast to [{b}, {heads}, {sq}, {sk}]"
                         ) from None


def check_segments(q, k, q_segment_ids, kv_segment_ids):
    """Refuse segment ids that are not int ``[b, sq]`` and ``[b, sk]``, or
    one without the other."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: q_segment_ids and kv_segment_ids "
                         "go together")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != tuple(q.shape[:2])
            or tuple(kv_segment_ids.shape) != tuple(k.shape[:2])
            or q_segment_ids.is_floating_point()
            or kv_segment_ids.is_floating_point()):
        raise ValueError(f"flash_attention: segment ids must be int "
                         f"[b, sq] {tuple(q.shape[:2])} and [b, sk] "
                         f"{tuple(k.shape[:2])}, got "
                         f"{tuple(q_segment_ids.shape)} and "
                         f"{tuple(kv_segment_ids.shape)}")


def _repeat_kv(t, group):
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def _scores(q, k, causal, scale, kv_len, q_offset, attn_mask,
            q_segment_ids, kv_segment_ids):
    """f32 ``s = q kᵀ·scale + mask`` ``[b, hq, sq, sk]``, ``-inf`` where
    row r does not see column c: past ``kv_len`` or the causal diagonal,
    across segments, False in a bool mask, or ``-inf`` in an additive
    one."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kf = _repeat_kv(k.float(), hq // hk)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    visible = _visible(sq, sk, causal, kv_len, q_offset, q.device)[None, None]
    if q_segment_ids is not None:
        visible = visible & (q_segment_ids[:, None, :, None]
                             == kv_segment_ids[:, None, None, :])
    if attn_mask is not None:
        m = broadcast_mask(attn_mask, q, k)
        if m.dtype == torch.bool:
            visible = visible & m
        else:
            s = s + m.float()
    return s.masked_fill(~visible, float("-inf"))


def flash_attn_reference(q, k, v, causal: bool = False,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         q_offset: Optional[int] = None,
                         return_lse: bool = False, attn_mask=None,
                         q_segment_ids=None, kv_segment_ids=None):
    """Dense softmax(q kᵀ·scale + mask) v with f32 math. Row r sees column c
    iff ``c < kv_len``, when causal ``c <= q_offset + r`` (``q_offset``
    defaults to ``kv_len - sq``), its segment ids are equal, and the mask
    lets it: True in a bool mask, not ``-inf`` in an additive one (added to
    the scaled scores; see :func:`broadcast_mask` for its shapes). A row
    that sees nothing gives zeros. With ``return_lse`` also the f32 row
    logsumexp ``[b, hq, sq]`` of the scaled, masked scores (natural log;
    :data:`EMPTY_ROW_LSE` for a row that sees nothing). Differentiable by
    autograd, the mask too."""
    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    check_segments(q, k, q_segment_ids, kv_segment_ids)
    hq, hk = q.shape[2], k.shape[2]
    s = _scores(q, k, causal, scale, kv_len, q_offset, attn_mask,
                q_segment_ids, kv_segment_ids)
    seen = (s > float("-inf")).any(dim=-1, keepdim=True)
    # an empty row's scores are set finite before the softmax, so that
    # neither its value nor its gradient is NaN
    probs = torch.softmax(s.masked_fill(~seen, 0.0), dim=-1) \
        .masked_fill(~seen, 0.0)
    vf = _repeat_kv(v.float(), hq // hk)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s.masked_fill(~seen, 0.0), dim=-1) \
        .masked_fill(~seen[..., 0], EMPTY_ROW_LSE)
    return out, lse


def flash_attn_bwd_reference(q, k, v, out, lse, dout, causal: bool = False,
                             scale: Optional[float] = None,
                             kv_len: Optional[int] = None,
                             q_offset: Optional[int] = None, attn_mask=None,
                             q_segment_ids=None, kv_segment_ids=None):
    """The plain backward: ``(dq, dk, dv)`` in the inputs' dtypes from the
    forward's ``out`` and ``lse [b, hq, sq]``, by the FlashAttention-2
    formulas in f32: ``P = exp(s - lse)`` on the pairs the forward sees (0
    elsewhere), ``delta = rowsum(dO·O)``, ``dS = P·(dP - delta)``, ``dQ =
    scale·dS K``, ``dK = scale·dSᵀ Q``, ``dV = Pᵀ dO``; dK and dV are summed
    over each kv head's group of query heads. The mask gets no gradient."""
    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    check_segments(q, k, q_segment_ids, kv_segment_ids)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    group = hq // hk
    qf, dof = q.float(), dout.float()
    kf, vf = _repeat_kv(k.float(), group), _repeat_kv(v.float(), group)
    s = _scores(q, k, causal, scale, kv_len, q_offset, attn_mask,
                q_segment_ids, kv_segment_ids)
    p = torch.where(s > float("-inf"), torch.exp(s - lse.float()[..., None]),
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


def _forward(q, k, v, causal, scale, kv_len, q_offset, return_lse, mask,
             q_seg, kv_seg):
    if q.device.type == "cpu":
        return flash_attn_reference(q, k, v, causal, scale, kv_len, q_offset,
                                    return_lse, mask, q_seg, kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from ..cuda.flash_attention import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal, scale, q_offset, kv_len,
                                return_lse, mask, q_seg, kv_seg)


def _backward(q, k, v, out, lse, dout, causal, scale, kv_len, q_offset,
              mask, q_seg, kv_seg):
    if q.device.type == "cpu":
        return flash_attn_bwd_reference(q, k, v, out, lse, dout, causal,
                                        scale, kv_len, q_offset, mask, q_seg,
                                        kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from ..cuda.flash_attention import flash_attention_bwd_cuda

    return flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, scale,
                                    q_offset, kv_len, mask, q_seg, kv_seg)


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              attn_mask: Optional[torch.Tensor],
              q_segment_ids: Optional[torch.Tensor],
              kv_segment_ids: Optional[torch.Tensor], causal: bool,
              scale: float, kv_len: int, q_offset: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as an operator: ``(out, lse)`` (kernel on CUDA,
    plain version on the CPU). Differentiable in q, k and v; lse is not."""
    return _forward(q, k, v, causal, scale, kv_len, q_offset, True,
                    attn_mask, q_segment_ids, kv_segment_ids)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, mask, q_seg, kv_seg, causal, scale, kv_len, q_offset = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, mask, q_seg, kv_seg)
    ctx.args = (causal, scale, kv_len, q_offset)
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, dout, _dlse):
    q, k, v, out, lse, mask, q_seg, kv_seg = ctx.saved_tensors
    # autograd may hand the gradient over strided
    dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(), *ctx.args,
                           mask, q_seg, kv_seg)
    return dq, dk, dv, None, None, None, None, None, None, None


torch.library.register_autograd("paddle_tpu_torch::flash_fwd",
                                _flash_fwd_backward,
                                setup_context=_flash_fwd_setup)


@amp_op("flash_attention")
def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    q_offset: Optional[int] = None, attn_mask=None,
                    q_segment_ids=None, kv_segment_ids=None
                    ) -> torch.Tensor:
    """Flash attention (kernels on CUDA tensors, plain versions on CPU
    ones), differentiable in q, k and v when grad is enabled. ``attn_mask``
    is bool (True attends) or additive float, 2-D ``[sq, sk]``, 3-D ``[b,
    sq, sk]`` or 4-D ``[b, hq | 1, sq, sk]``; segment ids are int ``[b,
    sq]`` and ``[b, sk]``, and a pair in different segments is masked. A
    mask that requires grad takes the plain version with autograd (counted
    in :data:`dense_calls`)."""
    global dense_calls
    scale, kv_len, q_offset = _resolve(q, k, scale, kv_len, q_offset)
    if torch.is_grad_enabled() and attn_mask is not None \
            and attn_mask.requires_grad:
        dense_calls += 1
        return flash_attn_reference(q, k, v, causal, scale, kv_len, q_offset,
                                    False, attn_mask, q_segment_ids,
                                    kv_segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_fwd(q, k, v, attn_mask, q_segment_ids, kv_segment_ids,
                         bool(causal), scale, kv_len, q_offset)[0]
    return _forward(q, k, v, causal, scale, kv_len, q_offset, False,
                    attn_mask, q_segment_ids, kv_segment_ids)
