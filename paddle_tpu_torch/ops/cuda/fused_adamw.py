"""One AdamW step over flat f32 buffers: the plain PyTorch version and the
wrapper of the hand-written kernel (``csrc/fused_adamw.cu``).

Replaces the TPU kernel ``paddle_tpu/ops/pallas/fused_adamw.py``
``fused_adamw_flat`` (``pl.pallas_call`` at :100). Bounded on the H100 by
bytes: 28 per parameter (p, g, m, v read; p, m, v written). CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.

``found_inf`` (GradScaler's flag, a scalar tensor on the buffers' device, or
None) skips the step when it is non-zero: the kernel reads it on the device
and writes nothing, so the caller never syncs for it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["fused_adamw", "fused_adamw_reference", "launches"]

#: kernel launches since the count was last set to 0
launches = 0

_ptr, _f32 = ctypes.c_void_p, ctypes.c_float


class _Scalars(NamedTuple):
    lr: float
    b1: float
    b2: float
    eps: float
    wd: float
    bc1: float
    bc2: float


def _scalars(lr, beta1, beta2, eps, weight_decay, step) -> _Scalars:
    """The kernel's scalars in f32, bias corrections ``1 - beta**step``
    computed on the host in f32 as ``fused_adamw_flat`` does."""
    f = np.float32
    b1, b2 = f(beta1), f(beta2)
    stepf = f(step)
    return _Scalars(float(f(lr)), float(b1), float(b2), float(f(eps)),
                    float(f(weight_decay)), float(f(1) - b1 ** stepf),
                    float(f(1) - b2 ** stepf))


def fused_adamw_reference(p, g, m, v, lr, beta1, beta2, eps, weight_decay,
                          step, found_inf=None):
    """The plain version: returns new ``(p, m, v)`` f32 from flat ``p, m, v``
    f32 and ``g`` of any float dtype, with the TPU kernel's operations in
    its order (every scalar and intermediate f32); returns ``(p, m, v)``
    themselves when ``found_inf`` is set (read on the host)."""
    if found_inf is not None and bool(found_inf):
        return p, m, v
    s = _scalars(lr, beta1, beta2, eps, weight_decay, step)
    f = np.float32
    one_b1, one_b2 = float(f(1) - f(s.b1)), float(f(1) - f(s.b2))
    decay = float(f(1) - f(s.lr) * f(s.wd))
    g = g.float()
    m = s.b1 * m + one_b1 * g
    v = s.b2 * v + one_b2 * g * g
    mhat = m / s.bc1
    vhat = v / s.bc2
    p = p * decay - s.lr * mhat / (torch.sqrt(vhat) + s.eps)
    return p, m, v


def _lib():
    lib = _build.load("fused_adamw")
    if lib.ptt_fused_adamw.argtypes is None:
        lib.ptt_fused_adamw.argtypes = [_ptr] * 4 + [ctypes.c_long] \
            + [_f32] * 7 + [_ptr, _ptr]
        lib.ptt_fused_adamw.restype = ctypes.c_int
    return lib


def fused_adamw(p, g, m, v, lr, beta1, beta2, eps, weight_decay, step,
                found_inf=None):
    """One AdamW step IN PLACE on the flat f32 buffers ``p``, ``m`` and
    ``v`` (``g`` is read), skipped when ``found_inf`` (a one-element tensor
    on their device, or None) is non-zero. On CUDA tensors (all four
    contiguous f32 ``[N]`` on one device, 16-byte aligned) one kernel
    launch, counted whether or not the flag skips it; on CPU tensors the
    plain version, copied back. Returns ``(p, m, v)``."""
    global launches
    if p.device.type == "cpu":
        if found_inf is not None and bool(found_inf):
            return p, m, v
        for dst, src in zip((p, m, v), fused_adamw_reference(
                p, g, m, v, lr, beta1, beta2, eps, weight_decay, step)):
            dst.copy_(src)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw: unsupported device {p.device}")
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.device != p.device \
                or t.dim() != 1 or t.numel() != n or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"fused_adamw: {name} must be a contiguous, "
                             f"16-byte aligned f32 [{n}] tensor on "
                             f"{p.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    flag = None
    if found_inf is not None:
        if found_inf.device != p.device or found_inf.numel() != 1:
            raise ValueError(f"fused_adamw: found_inf must be one element on "
                             f"{p.device}, got {tuple(found_inf.shape)} on "
                             f"{found_inf.device}")
        flag = found_inf.reshape(1).to(torch.int32).contiguous()
    s = _scalars(lr, beta1, beta2, eps, weight_decay, step)
    lib = _lib()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = lib.ptt_fused_adamw(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                             v.data_ptr(), n, *s,
                             None if flag is None else flag.data_ptr(),
                             stream)
    _build.check(lib, rc, "fused_adamw")
    launches += 1
    return p, m, v
