"""Weight-only int8 and int4 GEMMs: int4 packing, the plain PyTorch versions
and the wrappers of the hand-written kernel (``csrc/int8_matmul.cu``).

Replace the TPU kernels ``paddle_tpu/ops/pallas/int8_matmul.py``
``int8_weight_matmul`` (``pl.pallas_call`` at :143) and
``int4_weight_matmul`` (:197). ``x [m, K]`` (cast to bf16, as the JAX
functions do) times an int8 ``[K, N]`` or half-split packed int4 ``[K/2, N]``
weight, f32 accumulation, times the per-column f32 scale, cast to the output
dtype. Bounded on the H100 by the weight bytes at decode shapes; the kernel
converts each int8 tile to bf16 in shared memory inside its K-loop, so the
device reads the weight at int8 (int4) width.

The dispatch rule is the JAX package's (``int8_matmul.py:116-121``, :134,
:186): the kernel takes a product when ``m <= 256``, ``K % 128 == 0`` (int4:
``(K / 2) % 128 == 0``) and ``N % 128 == 0``. Other shapes are computed as
the JAX package computes them outside Pallas: the weight dequantized to
bf16 (exact), a product with f32 accumulation, the scale, the cast. On CUDA
tensors a shape that passes the rule launches the kernel or raises; CPU
tensors take the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

__all__ = ["pack_int4", "unpack_int4_packed", "int8_weight_matmul",
           "int4_weight_matmul", "int8_weight_matmul_reference",
           "int4_weight_matmul_reference", "kernel_takes", "launches",
           "int4_launches"]

#: int8 kernel launches since the count was last set to 0
launches = 0
#: int4 kernel launches since the count was last set to 0
int4_launches = 0

MAX_ROWS = 256           # the JAX kernel's m limit
_BN, _KT = 128, 64       # the kernel's column tile and k step
_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
_SMS: Dict[int, int] = {}
_SPLIT_CACHE: Dict[tuple, tuple] = {}            # (device, m, K, N) -> split
_PARTIALS: Dict[tuple, torch.Tensor] = {}        # (device, stream) -> scratch
_ENTRY = None                                    # see _entry()


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` int8 values in [-7, 7] -> ``[K/2, N]`` int8, half-split:
    ``packed[r] = (q[r + K/2] << 4) | (q[r] & 0xF)``."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"pack_int4: K = {K} must be even")
    lo = q[:K // 2].to(torch.int32) & 15
    hi = q[K // 2:].to(torch.int32) & 15
    packed = (hi << 4) | lo
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def unpack_int4_packed(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[K/2, N]`` -> ``[K, N]`` int8, each
    nibble sign-extended (low ``((b & 15) ^ 8) - 8``, high ``b >> 4``)."""
    w32 = packed.to(torch.int32)
    lo = ((w32 & 15) ^ 8) - 8
    hi = w32 >> 4
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def kernel_takes(m: int, K: int, N: int, int4: bool) -> bool:
    """The JAX dispatch rule: does the kernel take this product?"""
    k_ok = (K // 2) % 128 == 0 if int4 else K % 128 == 0
    return 1 <= m <= MAX_ROWS and k_ok and N % 128 == 0


def _dot_f32(x: torch.Tensor, w_bf16: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 with f32 accumulation and an f32 result. On the CPU the
    operands are widened (bf16 -> f32 is exact, so the products are the
    same); on CUDA one bf16 product with an f32 output."""
    xb = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return xb.float() @ w_bf16.float()
    return torch.mm(xb, w_bf16, out_dtype=torch.float32)


def int8_weight_matmul_reference(x, w_q, scale, out_dtype=None):
    """The plain version: ``(bf16(x) @ bf16(w_q)) * scale`` with f32
    accumulation, cast to ``out_dtype`` (default ``x.dtype``)."""
    y = _dot_f32(x, w_q.to(torch.bfloat16))
    return (y * scale.float()[None, :]).to(out_dtype or x.dtype)


def int4_weight_matmul_reference(x, w_packed, scale, out_dtype=None):
    """The plain version of the int4 product: unpack, then as
    :func:`int8_weight_matmul_reference`."""
    return int8_weight_matmul_reference(x, unpack_int4_packed(w_packed),
                                        scale, out_dtype)


def _entry():
    """The C entry ``ptt_weight_only_gemm`` with its argument types set,
    looked up once."""
    global _ENTRY
    if _ENTRY is None:
        fn = _build.load("int8_matmul").ptt_weight_only_gemm
        fn.argtypes = [_ptr] * 5 + [_c_int] * 7 + [_ptr]
        fn.restype = _c_int
        _ENTRY = fn
    return _ENTRY


def _splits(m: int, K: int, N: int, idx: int) -> tuple:
    """Split K so that about two CTAs per SM are in flight: returns
    ``(splits, steps_per_split)`` over the kernel's ``K / 64`` steps,
    computed once per device and shape."""
    key = (idx, m, K, N)
    got = _SPLIT_CACHE.get(key)
    if got is None:
        if idx not in _SMS:
            _SMS[idx] = \
                torch.cuda.get_device_properties(idx).multi_processor_count
        steps = K // _KT
        rows = 16 if m <= 16 else 64
        blocks = (N // _BN) * -(-m // rows)
        want = max(1, min(steps, -(-2 * _SMS[idx] // blocks)))
        per = -(-steps // want)
        got = _SPLIT_CACHE[key] = (-(-steps // per), per)
    return got


def _partials(idx: int, stream: int, n: int) -> torch.Tensor:
    """The f32 split-K scratch of at least ``n`` elements: one buffer per
    device and stream, grown when a larger product needs it. Launches on one
    stream run in order, so no two of them use the buffer at once."""
    key = (idx, stream)
    buf = _PARTIALS.get(key)
    if buf is None or buf.numel() < n:
        buf = _PARTIALS[key] = torch.empty(n, dtype=torch.float32,
                                           device=torch.device("cuda", idx))
    return buf


def _launch(x, w, scale, out_dtype, int4: bool, what: str):
    # called 4 x L times per decode step: each check is the cheapest that
    # tells (dtypes are singletons; no copy when x and scale are in order)
    m, K = x.shape
    N = w.shape[1]
    if out_dtype is not torch.bfloat16 and out_dtype is not torch.float32:
        raise ValueError(f"{what}: the kernel writes bf16 or f32, not "
                         f"{out_dtype}")
    if x.dtype is not torch.bfloat16:
        x = x.to(torch.bfloat16)
    if not x.is_contiguous():
        x = x.contiguous()
    if scale.dtype is not torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    idx = x.get_device()
    if w.dtype is not torch.int8 or not w.is_contiguous() \
            or w.get_device() != idx or scale.get_device() != idx:
        raise ValueError(f"{what}: w must be a contiguous int8 tensor and "
                         f"scale a tensor on {x.device}, got w {w.dtype} on "
                         f"{w.device}, scale on {scale.device}")
    px, pw, ps = x.data_ptr(), w.data_ptr(), scale.data_ptr()
    if (px | pw | ps) % 16:
        raise ValueError(f"{what}: x, w and scale must be 16-byte aligned")
    splits, per = _splits(m, K, N, idx)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    part = _partials(idx, stream, splits * m * N).data_ptr() \
        if splits > 1 else None
    rc = _entry()(px, pw, ps, out.data_ptr(), part, m, K, N, splits, per,
                  int4, out_dtype is torch.float32, stream)
    if rc:
        _build.check(_build.load("int8_matmul"), rc, what)
    return out


def _matmul(x, w, scale, out_dtype, int4: bool):
    global launches, int4_launches
    out_dtype = out_dtype or x.dtype
    what = "int4_weight_matmul" if int4 else "int8_weight_matmul"
    plain = int4_weight_matmul_reference if int4 \
        else int8_weight_matmul_reference
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{what}: x and w must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, K = x.shape
    if w.shape[0] * (2 if int4 else 1) != K or scale.shape != (w.shape[1],):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"and scale {tuple(scale.shape)} disagree")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return plain(x, w, scale, out_dtype)
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not kernel_takes(m, K, w.shape[1], int4):
        # the JAX package computes these shapes outside Pallas as well
        return plain(x, w, scale, out_dtype)
    out = _launch(x, w, scale, out_dtype, int4, what)
    if int4:
        int4_launches += 1
    else:
        launches += 1
    return out


def int8_weight_matmul(x, w_q, scale, out_dtype=None):
    """``x [m, K] @ dequant(w_q [K, N] int8, scale [N])`` -> ``[m, N]`` in
    ``out_dtype`` (default ``x.dtype``)."""
    return _matmul(x, w_q, scale, out_dtype, int4=False)


def int4_weight_matmul(x, w_packed, scale, out_dtype=None):
    """``x [m, K] @ dequant(unpack(w_packed [K/2, N]), scale [N])`` ->
    ``[m, N]`` in ``out_dtype`` (default ``x.dtype``)."""
    return _matmul(x, w_packed, scale, out_dtype, int4=True)
