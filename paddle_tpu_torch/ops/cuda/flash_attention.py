"""Wrappers of the hand-written flash attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward (``csrc/flash_attention_bwd.cu``).

They replace the TPU kernels ``paddle_tpu/ops/pallas/flash_attention.py``
``_fwd`` (``pl.pallas_call`` at :266) and ``_bwd`` (at :453). Both are
bounded on the H100 by tensor-core operations; both are warp-specialised
wgmma kernels fed by TMA, so every tensor must start on a 16-byte boundary
(see each source's header for the design). The plain PyTorch versions and the dispatch between the two
live in ``paddle_tpu_torch/ops/fused/flash_attention.py``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "launches",
           "bwd_launches", "misaligned"]

#: forward wrapper calls (one kernel each) since the count was last set to 0
launches = 0
#: backward wrapper calls since the count was last set to 0; each runs three
#: kernels (delta, dK/dV, dQ)
bwd_launches = 0

_c_int, _ptr = ctypes.c_int, ctypes.c_void_p


def _fwd_lib():
    lib = _build.load("flash_attention")
    if lib.ptt_flash_fwd.argtypes is None:
        lib.ptt_flash_fwd.argtypes = [_ptr] * 5 + [_c_int] * 9 \
            + [ctypes.c_float, _ptr]
        lib.ptt_flash_fwd.restype = _c_int
    return lib


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    if lib.ptt_flash_bwd.argtypes is None:
        lib.ptt_flash_bwd.argtypes = [_ptr] * 10 + [_c_int] * 9 \
            + [ctypes.c_float, _ptr]
        lib.ptt_flash_bwd.restype = _c_int
    return lib


def _check_qkv(what, q, k, v):
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} disagree")
    hk = k.shape[2]
    if hq % hk or d not in (64, 128):
        raise ValueError(f"{what}: needs hq % hk == 0 and d in (64, 128), "
                         f"got hq={hq} hk={hk} d={d}")


def misaligned(named) -> list:
    """The names of the ``(name, tensor)`` pairs whose data does not start
    on a 16-byte boundary: the TMA maps of the kernels need that (a view
    such as a layer of the serving cache ``cache_k[i]`` keeps it)."""
    return [name for name, t in named if t.data_ptr() % 16]


def _check_tensors(what, device, named, dtype=torch.bfloat16):
    for name, t in named:
        if t.dtype != dtype or not t.is_cuda or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"tensor on {device}, got {t.dtype} on "
                             f"{t.device}")
    bad = misaligned(named)
    if bad:
        raise ValueError(f"{what}: {', '.join(bad)} must start on a 16-byte "
                         f"boundary (TMA)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, scale: float, q_offset: int,
                         kv_len: int, return_lse: bool = False):
    """q ``[b, sq, hq, d]``, k/v ``[b, sk, hk, d]``: contiguous bf16 CUDA
    tensors, d in {64, 128}, hq a multiple of hk. Row r sees column c iff
    ``c < kv_len`` and, when causal, ``c <= q_offset + r``. Returns
    ``[b, sq, hq, d]`` bf16 and, with ``return_lse``, the f32 row
    logsumexp ``[b, hq, sq]`` (natural log; ``-1e30 * ln 2`` for a row that
    sees no column)."""
    global launches
    _check_qkv("flash_attention_cuda", q, k, v)
    _check_tensors("flash_attention_cuda", q.device,
                   (("q", q), ("k", k), ("v", v)))
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32) \
        if return_lse else None
    if sq > 0:
        lib = _fwd_lib()
        stream = _build.stream(q)
        rc = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(),
                               lse.data_ptr() if return_lse else None,
                               b, sq, sk, hq, hk, d, int(kv_len),
                               int(q_offset), int(bool(causal)), float(scale),
                               stream)
        _build.check(lib, rc, "flash_attention_cuda")
        launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool,
                             scale: float, q_offset: int, kv_len: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of the flash forward with the same
    arguments, from its ``out`` and ``lse``: q/out/dout ``[b, sq, hq, d]``,
    k/v ``[b, sk, hk, d]`` contiguous bf16, lse ``[b, hq, sq]`` f32, all on
    one CUDA device. dk/dv are summed over each kv head's group of query
    heads. Runs three kernels (delta = rowsum(dout * out), dK/dV, dQ)."""
    global bwd_launches
    _check_qkv("flash_attention_bwd_cuda", q, k, v)
    _check_tensors("flash_attention_bwd_cuda", q.device,
                   (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)))
    _check_tensors("flash_attention_bwd_cuda", q.device, (("lse", lse),),
                   torch.float32)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd_cuda: out {tuple(out.shape)}"
                         f", dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} must be {tuple(q.shape)} and "
                         f"{(b, hq, sq)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32)
    lib = _bwd_lib()
    stream = _build.stream(q)
    rc = lib.ptt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), b, sq, sk, hq, hk, d, int(kv_len),
                           int(q_offset), int(bool(causal)), float(scale),
                           stream)
    _build.check(lib, rc, "flash_attention_bwd_cuda")
    bwd_launches += 1
    return dq, dk, dv
