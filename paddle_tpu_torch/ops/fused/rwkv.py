"""RWKV-5 time-mixing ops (the counterpart of
``paddle_tpu/ops/fused/rwkv.py``).

``rwkv_linear_attention`` computes the WKV recurrence per head::

    S_t = diag(w) S_{t-1} + k_tᵀ v_t,    out_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

On CUDA tensors it runs the hand-written forward and backward kernels
(``ops/cuda/wkv.py``) as one autograd function; on CPU tensors the plain
chunked version, whose autograd gives the gradient.
"""

from __future__ import annotations

import torch

from ...amp import amp_op
from ..cuda import wkv as _wkv
from ..cuda._build import device_of

__all__ = ["rwkv_linear_attention", "rwkv_linear_attention_reference",
           "rwkv_log_decay", "token_shift"]


@amp_op("rwkv_log_decay")
def rwkv_log_decay(a: torch.Tensor) -> torch.Tensor:
    """``log w = max(-exp(a), -1e10)`` in a's dtype: the log form goes to
    the recurrence as it is (``w = exp(-exp(a))`` would underflow for strong
    decays), bounded below so that exp(a) overflowing never gives -inf."""
    return torch.clamp_min(-torch.exp(a), -1e10)


@amp_op("token_shift")
def token_shift(x: torch.Tensor) -> torch.Tensor:
    """Position t sees position t - 1 (zeros at t = 0); x ``[b, l, D]``."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_linear_attention_reference(r, k, v, w, u):
    """Step-by-step oracle. r/k/v ``[b, l, h, d]``; w (the decay in (0, 1],
    not its log) and u ``[h, d]``; returns ``[b, l, h, d]`` in r's dtype."""
    b, l, h, d = r.shape
    S = torch.zeros(b, h, d, d, dtype=torch.float32, device=r.device)
    rf, kf, vf = (t.float() for t in (r, k, v))
    wf, uf = w.float(), u.float()
    outs = []
    for t in range(l):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # [b, h, d, d]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 S + uf[..., None] * kv))
        S = wf[..., None] * S + kv
    return torch.stack(outs, dim=1).to(r.dtype)


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        ctx.save_for_backward(r, k, v, logw, u)
        return _wkv.wkv_fwd(r, k, v, logw, u)

    @staticmethod
    def backward(ctx, dy):
        return _wkv.wkv_bwd(*ctx.saved_tensors, dy.contiguous())


@amp_op("rwkv_linear_attention")
def rwkv_linear_attention(r, k, v, logw, u, chunk: int = 32,
                          subchunk: int = 16):
    """WKV of r/k/v ``[b, l, h, d]`` with ``logw`` (the log decay, clamped to
    <= 0) and u ``[h, d]``; returns ``[b, l, h, d]`` in r's dtype.

    CUDA tensors take the forward and backward kernels (head_dim 64 or 128,
    else ``NotImplementedError``); ``chunk`` and ``subchunk`` shape only the
    plain chunked version, which CPU tensors take."""
    if device_of("rwkv_linear_attention", r, k, v, logw, u) == "cpu":
        return _wkv.wkv_reference(r, k, v, logw, u, chunk, subchunk)
    return _WKV.apply(r, k, v, logw, u)
