"""Grouped (ragged) GEMMs of the MoE expert FFN: the plain PyTorch versions
and the wrappers of the hand-written kernels (``csrc/grouped_gemm.cu``).

Replace the three TPU kernels of ``paddle_tpu/ops/pallas/grouped_gemm.py``:
``_gmm_call`` (``pl.pallas_call`` at :236), ``_tgmm_call`` (:290) and
``_gmm_swiglu_call`` (:487). ``lhs [M, K]`` holds the rows of group ``g`` in
``[offs[g], offs[g + 1])``, ``offs`` being the prefix sums of
``group_sizes [G]`` (int32); rows past ``offs[G]`` are the trash group
(dropped tokens), which the products return as exact zeros, bias included.
Bounded on the H100 by operations at the MoE layer's shapes.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. The kernels read the group sizes on the card: no wrapper here reads
them on the host (only the plain versions do). The kernels take bf16
operands with ``K`` and ``N`` multiples of 8 (16-byte rows) and at most 255
groups.
"""

from __future__ import annotations

from typing import List

import torch

from . import _build

__all__ = ["gmm", "tgmm", "gmm_swiglu", "gmm_reference", "tgmm_reference",
           "gmm_swiglu_reference", "launches", "tgmm_launches",
           "swiglu_launches", "MAX_GROUPS"]

#: gmm kernel launches since the count was last set to 0
launches = 0
#: tgmm kernel launches since the count was last set to 0
tgmm_launches = 0
#: fused gate + up + swiglu kernel launches since the count was last set to 0
swiglu_launches = 0

MAX_GROUPS = 255          # the kernels' table holds G + 1 <= 256 groups


# ------------------------------------------------------------ plain versions
def _offsets(group_sizes: torch.Tensor, m: int) -> List[int]:
    """Row offsets ``[G + 1]`` on the host, each size clamped as the kernels
    clamp it (negative sizes count 0, no offset passes ``m``)."""
    offs = [0]
    for s in group_sizes.tolist():
        offs.append(min(m, offs[-1] + max(int(s), 0)))
    return offs


def gmm_reference(lhs, rhs, group_sizes, bias=None, transpose_rhs=False):
    """The plain version of :func:`gmm`: per group, the f32 product of its
    rows with ``rhs[g]`` (``rhs[g]ᵀ`` when ``transpose_rhs``) plus
    ``bias[g]``, cast to ``lhs.dtype``; empty groups skipped, trash rows
    zero."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((m, n), dtype=lhs.dtype, device=lhs.device)
    offs = _offsets(group_sizes, m)
    for g in range(rhs.shape[0]):
        lo, hi = offs[g], offs[g + 1]
        if hi == lo:
            continue
        w = rhs[g].float()
        acc = lhs[lo:hi].float() @ (w.t() if transpose_rhs else w)
        if bias is not None:
            acc = acc + bias[g].float()
        out[lo:hi] = acc.to(lhs.dtype)
    return out


def tgmm_reference(lhs, dout, group_sizes):
    """The plain version of :func:`tgmm`: ``out[g] = lhs_gᵀ @ dout_g`` in
    f32, cast to ``lhs.dtype``; an empty group gives zeros, trash rows take
    no part."""
    G, K, N = group_sizes.shape[0], lhs.shape[1], dout.shape[1]
    out = torch.zeros((G, K, N), dtype=lhs.dtype, device=lhs.device)
    offs = _offsets(group_sizes, lhs.shape[0])
    for g in range(G):
        lo, hi = offs[g], offs[g + 1]
        if hi > lo:
            out[g] = (lhs[lo:hi].float().t() @ dout[lo:hi].float()).to(
                lhs.dtype)
    return out


def gmm_swiglu_reference(lhs, w1, group_sizes, b1, emit_residuals=True):
    """The plain version of :func:`gmm_swiglu`: per group ``g = x @ wg + bg``
    and ``u = x @ wu + bu`` in f32 (``w1[g]``'s first and second halves of
    columns), ``y = g * sigmoid(g) * u``; returns ``(y, g, u)`` cast to
    ``lhs.dtype`` (``g``, ``u`` None unless ``emit_residuals``), trash rows
    zero."""
    m, n = lhs.shape[0], w1.shape[2] // 2
    outs = [torch.zeros((m, n), dtype=lhs.dtype, device=lhs.device)
            for _ in range(3 if emit_residuals else 1)]
    offs = _offsets(group_sizes, m)
    for g in range(w1.shape[0]):
        lo, hi = offs[g], offs[g + 1]
        if hi == lo:
            continue
        h = lhs[lo:hi].float() @ w1[g].float() + b1[g].float()
        gate, up = h[:, :n], h[:, n:]
        for dst, val in zip(outs, (gate * torch.sigmoid(gate) * up, gate,
                                   up)):
            dst[lo:hi] = val.to(lhs.dtype)
    return (outs[0], outs[1], outs[2]) if emit_residuals \
        else (outs[0], None, None)


# ------------------------------------------------------------------ wrappers
def _check(what, group_sizes, named, k, n):
    """Raise unless every tensor of ``named`` is a contiguous, 16-byte
    aligned bf16 tensor on ``group_sizes``'s CUDA device, the sizes an int32
    ``[G]`` tensor with G <= MAX_GROUPS, and K, N multiples of 8."""
    dev = group_sizes.device
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1 \
            or not group_sizes.is_contiguous() \
            or not 1 <= group_sizes.shape[0] <= MAX_GROUPS:
        raise ValueError(f"{what}: group_sizes must be a contiguous int32 "
                         f"[G] tensor with 1 <= G <= {MAX_GROUPS}, got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    for name, t in named:
        if t.dtype != torch.bfloat16 or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned bfloat16 tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if k % 8 or n % 8 or k <= 0 or n <= 0:
        raise ValueError(f"{what}: K = {k} and N = {n} must be positive "
                         f"multiples of 8")


def gmm(lhs, rhs, group_sizes, bias=None, transpose_rhs=False):
    """``[M, K] x [G, K, N] -> [M, N]`` by contiguous row groups (with
    ``transpose_rhs``: ``[M, K] x [G, N, K] -> [M, N]``, contracting
    against rhs's last axis), plus ``bias [G, N]`` per group; rows past
    ``sum(group_sizes)`` come out zero. One kernel launch on CUDA tensors,
    the plain version on CPU tensors."""
    global launches
    what = "grouped_matmul"
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"{what}: lhs must be 2-D and rhs 3-D, got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    G = rhs.shape[0]
    k, n = (rhs.shape[2], rhs.shape[1]) if transpose_rhs \
        else (rhs.shape[1], rhs.shape[2])
    if lhs.shape[1] != k or group_sizes.shape != (G,) \
            or (bias is not None and tuple(bias.shape) != (G, n)):
        raise ValueError(f"{what}: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)} (transpose_rhs="
                         f"{transpose_rhs}), group_sizes "
                         f"{tuple(group_sizes.shape)} and bias "
                         f"{None if bias is None else tuple(bias.shape)} "
                         f"disagree")
    if _build.device_of(what, lhs, rhs, group_sizes, bias) == "cpu":
        return gmm_reference(lhs, rhs, group_sizes, bias, transpose_rhs)
    named = [("lhs", lhs), ("rhs", rhs)] \
        + ([("bias", bias)] if bias is not None else [])
    _check(what, group_sizes, named, k, n)
    m = lhs.shape[0]
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    rc = _build.entry("grouped_gemm", "ptt_gmm", 5, 5)(
        lhs.data_ptr(), rhs.data_ptr(),
        None if bias is None else bias.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, G, int(bool(transpose_rhs)),
        _build.stream(lhs))
    _build.check(_build.load("grouped_gemm"), rc, what)
    launches += 1
    return out


def tgmm(lhs, dout, group_sizes):
    """Per group ``lhs_gᵀ @ dout_g -> [G, K, N]``; an empty group gives
    zeros, trash rows take no part. One kernel launch on CUDA tensors, the
    plain version on CPU tensors."""
    global tgmm_launches
    what = "grouped_matmul_tgmm"
    if lhs.dim() != 2 or dout.dim() != 2 or lhs.shape[0] != dout.shape[0] \
            or group_sizes.dim() != 1:
        raise ValueError(f"{what}: lhs {tuple(lhs.shape)}, dout "
                         f"{tuple(dout.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} disagree")
    if _build.device_of(what, lhs, dout, group_sizes) == "cpu":
        return tgmm_reference(lhs, dout, group_sizes)
    (m, k), n, G = lhs.shape, dout.shape[1], group_sizes.shape[0]
    _check(what, group_sizes, [("lhs", lhs), ("dout", dout)], k, n)
    out = torch.empty((G, k, n), dtype=lhs.dtype, device=lhs.device)
    rc = _build.entry("grouped_gemm", "ptt_tgmm", 4, 4)(
        lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, G, _build.stream(lhs))
    _build.check(_build.load("grouped_gemm"), rc, what)
    tgmm_launches += 1
    return out


def gmm_swiglu(lhs, w1, group_sizes, b1, emit_residuals=True):
    """``silu(x @ wg + bg) * (x @ wu + bu)`` per group from one
    ``w1 [G, K, 2N]`` (gate columns, then up columns) and ``b1 [G, 2N]``.
    Returns ``(y, g, u)``, each ``[M, N]``: ``g`` and ``u`` are the
    pre-activations (None unless ``emit_residuals``); trash rows are zero in
    all three. One kernel launch on CUDA tensors, the plain version on CPU
    tensors."""
    global swiglu_launches
    what = "grouped_matmul_swiglu"
    if lhs.dim() != 2 or w1.dim() != 3 or w1.shape[2] % 2:
        raise ValueError(f"{what}: lhs must be 2-D and w1 [G, K, 2N], got "
                         f"{tuple(lhs.shape)} and {tuple(w1.shape)}")
    G, k, n2 = w1.shape
    if lhs.shape[1] != k or group_sizes.shape != (G,) \
            or tuple(b1.shape) != (G, n2):
        raise ValueError(f"{what}: lhs {tuple(lhs.shape)}, w1 "
                         f"{tuple(w1.shape)}, b1 {tuple(b1.shape)} and "
                         f"group_sizes {tuple(group_sizes.shape)} disagree")
    if _build.device_of(what, lhs, w1, group_sizes, b1) == "cpu":
        return gmm_swiglu_reference(lhs, w1, group_sizes, b1, emit_residuals)
    m, n = lhs.shape[0], n2 // 2
    _check(what, group_sizes, [("lhs", lhs), ("w1", w1), ("b1", b1)], k, n)
    outs = [torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
            for _ in range(3 if emit_residuals else 1)]
    res = [o.data_ptr() for o in outs[1:]] or [None, None]
    rc = _build.entry("grouped_gemm", "ptt_gmm_swiglu", 7, 4)(
        lhs.data_ptr(), w1.data_ptr(), b1.data_ptr(), group_sizes.data_ptr(),
        outs[0].data_ptr(), *res, m, k, n, G, _build.stream(lhs))
    _build.check(_build.load("grouped_gemm"), rc, what)
    swiglu_launches += 1
    return (outs[0], outs[1], outs[2]) if emit_residuals \
        else (outs[0], None, None)
