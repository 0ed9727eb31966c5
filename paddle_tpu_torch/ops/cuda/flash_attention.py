"""Wrapper of the hand-written flash forward kernel
(``csrc/flash_attention.cu``).

Replaces the TPU kernel ``paddle_tpu/ops/pallas/flash_attention.py:_fwd``
(``pl.pallas_call`` at :266). Bounded on the H100 by tensor-core
operations; see the source's header for the design. The plain PyTorch
version and the dispatch between the two live in
``paddle_tpu_torch/ops/fused/flash_attention.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_cuda", "launches"]

#: kernel launches since the count was last set to 0
launches = 0

_c_int, _ptr = ctypes.c_int, ctypes.c_void_p


def _lib():
    lib = _build.load("flash_attention")
    if lib.ptt_flash_fwd.argtypes is None:
        lib.ptt_flash_fwd.argtypes = [_ptr, _ptr, _ptr, _ptr] + [_c_int] * 9 \
            + [ctypes.c_float, _ptr]
        lib.ptt_flash_fwd.restype = _c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, scale: float, q_offset: int,
                         kv_len: int) -> torch.Tensor:
    """q ``[b, sq, hq, d]``, k/v ``[b, sk, hk, d]``: contiguous bf16 CUDA
    tensors, d in {64, 128}, hq a multiple of hk. Row r sees column c iff
    ``c < kv_len`` and, when causal, ``c <= q_offset + r``. Returns
    ``[b, sq, hq, d]`` bf16."""
    global launches
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    sk, hk = k.shape[1], k.shape[2]
    if hq % hk or d not in (64, 128):
        raise ValueError(f"flash_attention_cuda: needs hq % hk == 0 and d "
                         f"in (64, 128), got hq={hq} hk={hk} d={d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_cuda \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be a "
                             f"contiguous bf16 tensor on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b, sq, sk, hq, hk, d, int(kv_len),
                           int(q_offset), int(bool(causal)), float(scale),
                           stream)
    _build.check(lib, rc, "flash_attention_cuda")
    launches += 1
    return out
