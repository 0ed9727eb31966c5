"""Wrappers of the hand-written flash attention kernels: at head dims 64
and 128 the forward (``csrc/flash_attention.cu``) and the backward
(``csrc/flash_attention_bwd.cu``), at every other multiple of 16 below 128
(:data:`MMA_HEAD_DIMS`: the UNet's 16 and 32, ViT-H14's 80) the forward and
backward of ``csrc/flash_attention_mma.cu``.

They replace the TPU kernels ``paddle_tpu/ops/pallas/flash_attention.py``
``_fwd`` (``pl.pallas_call`` at :266) and ``_bwd`` (at :453). All are
warp-specialised wgmma kernels fed by TMA, bounded on the H100 by
tensor-core operations at long sequences and by bytes at the vision paths'
short ones; the head-dim kernels lay d out in zero-filled panels and run
persistent CTAs built for short sequences. Either way q, k, v, out and
dout must start on a 16-byte boundary (see each source's header for the
design). All take an optional
mask, additive f32 or bool, read by strides (a broadcast dimension has
stride 0 and is never materialised), and optional int32 segment ids. The
plain PyTorch versions and the dispatch between the two live in
``paddle_tpu_torch/ops/fused/flash_attention.py``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..fused.flash_attention import broadcast_mask, check_segments
from . import _build

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "launches",
           "bwd_launches", "mma_launches", "mma_bwd_launches", "misaligned",
           "HEAD_DIMS", "WGMMA_HEAD_DIMS", "MMA_HEAD_DIMS"]

#: head dims of the wgmma kernels
WGMMA_HEAD_DIMS = (64, 128)
#: head dims of the head-dim kernels (``csrc/flash_attention_mma.cu``)
MMA_HEAD_DIMS = (16, 32, 48, 80, 96, 112)
#: every head dim the wrappers take
HEAD_DIMS = tuple(sorted(WGMMA_HEAD_DIMS + MMA_HEAD_DIMS))

#: forward wrapper calls at a wgmma head dim (one kernel each) since the
#: count was last set to 0
launches = 0
#: backward wrapper calls at a wgmma head dim since the count was last set
#: to 0; each runs three kernels (delta, dK/dV, dQ)
bwd_launches = 0
#: the same two counts at the head-dim kernels' head dims
mma_launches = 0
mma_bwd_launches = 0

_c_int, _ptr, _c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
#: the C entries' mask and segment arguments: mask, q and kv segment ids,
#: then (after the shape ints) the mask's kind and its batch, head and row
#: strides in elements
_MASK_PTRS, _MASK_INTS = [_ptr] * 3, [_c_int] + [_c_ll] * 3
#: mask kinds of the C entries
NO_MASK, ADDITIVE_F32, BOOL_U8 = 0, 1, 2


def _source(d, wgmma, mma):
    return wgmma if d in WGMMA_HEAD_DIMS else mma


def _fwd_lib(d):
    lib = _build.load(_source(d, "flash_attention", "flash_attention_mma"))
    if lib.ptt_flash_fwd.argtypes is None:
        lib.ptt_flash_fwd.argtypes = [_ptr] * 5 + _MASK_PTRS + [_c_int] * 9 \
            + _MASK_INTS + [ctypes.c_float, _ptr]
        lib.ptt_flash_fwd.restype = _c_int
    return lib


def _bwd_lib(d):
    lib = _build.load(_source(d, "flash_attention_bwd", "flash_attention_mma"))
    if lib.ptt_flash_bwd.argtypes is None:
        lib.ptt_flash_bwd.argtypes = [_ptr] * 10 + _MASK_PTRS \
            + [_c_int] * 9 + _MASK_INTS + [ctypes.c_float, _ptr]
        lib.ptt_flash_bwd.restype = _c_int
    return lib


def mask_args(what, q, k, attn_mask=None, q_segment_ids=None,
              kv_segment_ids=None):
    """The C entries' mask arguments ``(pointers, ints, keep)``: pointers
    of the mask and the two int32 segment-id tensors (None where absent),
    the mask's kind and its batch, head and row strides in elements (a
    broadcast dimension: 0; its columns contiguous), and the tensors that
    must live until the launch has been enqueued. A bool mask is read as
    bytes, a float one as f32 (another float type is converted before it
    is broadcast, so the copy keeps the mask's own size). A mask or segment
    ids of the wrong shape raise."""
    check_segments(q, k, q_segment_ids, kv_segment_ids)
    device = q.device
    mask, kind, strides = None, NO_MASK, (0, 0, 0)
    if attn_mask is not None:
        src = attn_mask if attn_mask.dtype in (torch.bool, torch.float32) \
            else attn_mask.float()
        m = broadcast_mask(src, q, k)
        if m.stride(3) != 1:
            m = m.contiguous()
        if m.device != device:
            raise ValueError(f"{what}: attn_mask is on {m.device}, q on "
                             f"{device}")
        kind = BOOL_U8 if m.dtype == torch.bool else ADDITIVE_F32
        mask = m.view(torch.uint8) if kind == BOOL_U8 else m
        strides = (m.stride(0) if m.shape[0] > 1 else 0,
                   m.stride(1) if m.shape[1] > 1 else 0, m.stride(2))
    segs = [None, None]
    if q_segment_ids is not None:
        for i, t in enumerate((q_segment_ids, kv_segment_ids)):
            if t.device != device:
                raise ValueError(f"{what}: segment ids are on {t.device}, "
                                 f"q on {device}")
            segs[i] = t.to(torch.int32).contiguous()
    keep = [t for t in (mask, *segs) if t is not None]
    ptrs = [None if t is None else t.data_ptr() for t in (mask, *segs)]
    return ptrs, [kind, *strides], keep


def _check_qkv(what, q, k, v):
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} disagree")
    hk = k.shape[2]
    if hq % hk or d not in HEAD_DIMS:
        raise ValueError(f"{what}: needs hq % hk == 0 and d in {HEAD_DIMS}, "
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
                         kv_len: int, return_lse: bool = False,
                         attn_mask=None, q_segment_ids=None,
                         kv_segment_ids=None):
    """q ``[b, sq, hq, d]``, k/v ``[b, sk, hk, d]``: contiguous bf16 CUDA
    tensors, d in :data:`HEAD_DIMS`, hq a multiple of hk. Row r sees column
    c iff ``c < kv_len``, when causal ``c <= q_offset + r``, the segment ids
    of r and c are equal, and the mask lets it (True in a bool mask; an
    additive one is added to the scaled scores, ``-inf`` hides a column).
    Returns
    ``[b, sq, hq, d]`` bf16 and, with ``return_lse``, the f32 row
    logsumexp ``[b, hq, sq]`` (natural log; ``-1e30 * ln 2`` for a row that
    sees no column)."""
    global launches, mma_launches
    _check_qkv("flash_attention_cuda", q, k, v)
    _check_tensors("flash_attention_cuda", q.device,
                   (("q", q), ("k", k), ("v", v)))
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32) \
        if return_lse else None
    ptrs, ints, keep = mask_args("flash_attention_cuda", q, k, attn_mask,
                                 q_segment_ids, kv_segment_ids)
    if sq > 0:
        lib = _fwd_lib(d)
        stream = _build.stream(q)
        rc = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(),
                               lse.data_ptr() if return_lse else None,
                               *ptrs, b, sq, sk, hq, hk, d, int(kv_len),
                               int(q_offset), int(bool(causal)), *ints,
                               float(scale), stream)
        _build.check(lib, rc, "flash_attention_cuda")
        if d in WGMMA_HEAD_DIMS:
            launches += 1
        else:
            mma_launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool,
                             scale: float, q_offset: int, kv_len: int,
                             attn_mask=None, q_segment_ids=None,
                             kv_segment_ids=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of the flash forward with the same
    arguments, from its ``out`` and ``lse``: q/out/dout ``[b, sq, hq, d]``,
    k/v ``[b, sk, hk, d]`` contiguous bf16, lse ``[b, hq, sq]`` f32, all on
    one CUDA device. dk/dv are summed over each kv head's group of query
    heads; the mask gets no gradient. Runs three kernels (delta =
    rowsum(dout * out), dK/dV, dQ)."""
    global bwd_launches, mma_bwd_launches
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
    ptrs, ints, keep = mask_args("flash_attention_bwd_cuda", q, k, attn_mask,
                                 q_segment_ids, kv_segment_ids)
    lib = _bwd_lib(d)
    stream = _build.stream(q)
    rc = lib.ptt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), *ptrs, b, sq, sk, hq, hk, d,
                           int(kv_len), int(q_offset), int(bool(causal)),
                           *ints, float(scale), stream)
    _build.check(lib, rc, "flash_attention_bwd_cuda")
    if d in WGMMA_HEAD_DIMS:
        bwd_launches += 1
    else:
        mma_bwd_launches += 1
    return dq, dk, dv
