"""Chunked fused linear + softmax cross-entropy (the counterpart of
``paddle_tpu/ops/fused/cross_entropy.py``).

The f32 logits ``[rows, vocab]`` are the largest activation of a training
step. This op never holds them whole: each chunk of rows computes its logits
(matrix product in the model dtype, then f32 logsumexp) and keeps only its
loss; the backward recomputes each chunk's logits instead of saving them.
Plain torch ops: the JAX package computes this with XLA, not Pallas.
"""

from __future__ import annotations

import torch

from ...amp import amp_op

__all__ = ["fused_linear_cross_entropy"]


def _chunk_logits(h, weight):
    """f32 logits of rows ``h [c, H]`` against ``weight [V, H]``."""
    return (h @ weight.t()).float()


class _LinearCrossEntropy(torch.autograd.Function):
    """Sum of ``lse - gold`` over valid rows, divided by their count (at
    least 1). Saves hidden, weight and labels; the backward recomputes each
    chunk's logits and accumulates the weight's gradient in f32."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk, ignore_index):
        valid = labels != ignore_index
        safe = labels.masked_fill(~valid, 0)
        total = torch.zeros((), device=hidden.device, dtype=torch.float32)
        for start in range(0, hidden.shape[0], chunk):
            sl = slice(start, start + chunk)
            logits = _chunk_logits(hidden[sl], weight)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, safe[sl, None])[:, 0]
            total = total + torch.where(valid[sl], lse - gold,
                                        torch.zeros((), device=lse.device)
                                        ).sum()
        count = valid.sum().clamp_min(1).float()
        ctx.save_for_backward(hidden, weight, safe, valid, count)
        ctx.chunk = chunk
        return total / count

    @staticmethod
    def backward(ctx, grad):
        hidden, weight, safe, valid, count = ctx.saved_tensors
        chunk = ctx.chunk
        dh = torch.empty_like(hidden) if ctx.needs_input_grad[0] else None
        dw = torch.zeros(weight.shape, device=weight.device,
                         dtype=torch.float32) \
            if ctx.needs_input_grad[1] else None
        row_scale = valid.float() * (grad / count)
        for start in range(0, hidden.shape[0], chunk):
            sl = slice(start, start + chunk)
            # d(lse - gold)/dlogits = softmax - onehot(gold)
            dlogits = torch.softmax(_chunk_logits(hidden[sl], weight), dim=-1)
            rows = torch.arange(dlogits.shape[0], device=dlogits.device)
            dlogits[rows, safe[sl]] -= 1.0
            dlogits = (dlogits * row_scale[sl, None]).to(hidden.dtype)
            if dh is not None:
                dh[sl] = dlogits @ weight
            if dw is not None:
                dw += (dlogits.t() @ hidden[sl]).float()
        return dh, None if dw is None else dw.to(weight.dtype), None, None, \
            None


@amp_op("fused_linear_cross_entropy")
def fused_linear_cross_entropy(hidden, weight, labels, chunk: int = 1024,
                               ignore_index: int = -100) -> torch.Tensor:
    """Mean token cross-entropy of ``softmax(hidden @ weightᵀ)`` against
    ``labels`` without holding the logits: ``hidden [..., H]`` flattens to
    rows, ``weight`` is the LM head's ``[V, H]`` (``torch.nn.Linear``
    layout), ``labels [...]`` int with ``ignore_index`` rows left out of the
    sum and the count. Rows go ``chunk`` at a time. Returns an f32 scalar."""
    hidden = hidden.reshape(-1, hidden.shape[-1])
    labels = labels.reshape(-1)
    if labels.shape[0] != hidden.shape[0]:
        raise ValueError(f"fused_linear_cross_entropy: {hidden.shape[0]} "
                         f"rows of hidden but {labels.shape[0]} labels")
    return _LinearCrossEntropy.apply(hidden, weight, labels, int(chunk),
                                     int(ignore_index))
