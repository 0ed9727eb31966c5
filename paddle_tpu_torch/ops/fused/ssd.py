"""Mamba-2 SSD (state-space duality), the counterpart of
``paddle_tpu/ops/fused/ssd.py``.

``ssd_chunked`` computes, per head h with a scalar data-dependent decay::

    S_t = exp(A_h dt_t) S_{t-1} + dt_t x_tᵀ B_t,    y_t = C_t S_tᵀ + D_h x_t

On CUDA tensors it runs the hand-written forward and backward kernels
(``ops/cuda/ssd.py``) as one autograd function; on CPU tensors the plain
chunked version, whose autograd gives the gradient.
"""

from __future__ import annotations

import torch

from ...amp import amp_op
from ..cuda import ssd as _ssd
from ..cuda._build import device_of
from ..cuda.ssd import ssd_chunked_reference, ssd_reference

__all__ = ["ssd_chunked", "ssd_chunked_reference", "ssd_reference"]


class _SSDFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        y, states = _ssd.ssd_fwd(x, dt, A, B, C, D)
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        return _ssd.ssd_bwd(*ctx.saved_tensors, dy)


@amp_op("ssd_chunked")
def ssd_chunked(x, dt, A, B, C, D, chunk: int = 64):
    """Chunked SSD of x ``[b, l, h, dh]``, dt ``[b, l, h]``, A ``[h]`` (< 0),
    B, C ``[b, l, ds]`` and D ``[h]``; returns ``[b, l, h, dh]`` in x's
    dtype.

    CUDA tensors take the forward and backward kernels (dh, ds in {64, 128},
    else ``NotImplementedError``), which keep their own chunk,
    ``kernel_chunk(dh, ds)``, whatever ``chunk`` says: the result differs
    only in rounding. CPU tensors take the plain chunked version with
    ``chunk``."""
    if device_of("ssd_chunked", x, dt, A, B, C, D) == "cpu":
        return ssd_chunked_reference(x, dt, A, B, C, D, chunk)
    return _SSDFn.apply(x, dt, A, B, C, D)
