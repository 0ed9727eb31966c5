"""Grouped GEMMs with their gradients: the counterpart of the public surface
of ``paddle_tpu/ops/pallas/grouped_gemm.py``.

``grouped_matmul`` and ``grouped_matmul_swiglu`` are autograd Functions
whose backwards are those of ``_gmm_bwd`` (:347-375) and
``_gmm_swiglu_bwd`` (:550-569): dlhs is a grouped product with
``transpose_rhs`` flipped, drhs a ``tgmm``, dbias the per-group row sum of
``_group_bias_grad`` (:319-326), and the swiglu backward's elementwise part
runs in f32 in plain torch and is cast to the input dtype, as JAX does. The
products go through ``ops/cuda/grouped_gemm.py``: CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise. Tile sizes are the
kernels' own business (the JAX ``tm, tk, tn`` and its autotuning have no
counterpart here).
"""

from __future__ import annotations

import torch

from ..cuda.grouped_gemm import gmm, gmm_swiglu, tgmm

__all__ = ["grouped_matmul", "grouped_matmul_tgmm", "grouped_matmul_swiglu",
           "group_bias_grad"]


def group_bias_grad(dout: torch.Tensor, group_sizes: torch.Tensor,
                    n_groups: int) -> torch.Tensor:
    """``db[g]`` = the f32 sum of ``dout``'s rows in group ``g`` (trash rows
    left out) -> ``[n_groups, N]`` f32. The sizes stay on the device: each
    row's group comes from a search of their prefix sums, and one product of
    the group one-hot with ``dout`` sums the rows (f32 accumulation)."""
    m = dout.shape[0]
    ends = torch.cumsum(group_sizes.to(torch.int64).clamp_min(0), 0)
    rows = torch.arange(m, device=dout.device)
    row_g = torch.searchsorted(ends, rows, right=True)          # G = trash
    groups = torch.arange(n_groups, device=dout.device)
    onehot = (row_g[None, :] == groups[:, None])
    if dout.device.type == "cuda" and dout.dtype == torch.bfloat16:
        return torch.mm(onehot.to(dout.dtype), dout, out_dtype=torch.float32)
    return onehot.float() @ dout.float()


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, bias, transpose_rhs):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        ctx.bias_dtype = None if bias is None else bias.dtype
        return gmm(lhs, rhs, group_sizes, bias, transpose_rhs)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, sizes = ctx.saved_tensors
        dout = dout.contiguous()
        need = ctx.needs_input_grad
        dlhs = drhs = dbias = None
        if need[0]:
            # dlhs contracts dout against rhs's other axis
            dlhs = gmm(dout, rhs, sizes, None,
                       not ctx.transpose_rhs).to(lhs.dtype)
        if need[1]:
            # transpose_rhs: out = x @ w^T, so dw[g] = dout_g^T @ x_g, laid
            # out [G, K, N] as rhs
            drhs = (tgmm(dout, lhs, sizes) if ctx.transpose_rhs
                    else tgmm(lhs, dout, sizes)).to(rhs.dtype)
        if need[3] and ctx.bias_dtype is not None:
            dbias = group_bias_grad(dout, sizes, rhs.shape[0]).to(
                ctx.bias_dtype)
        return dlhs, drhs, None, dbias, None


class _GroupedMatmulSwiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, w1, group_sizes, b1, recompute_activation):
        y, g, u = gmm_swiglu(lhs, w1, group_sizes, b1,
                             emit_residuals=not recompute_activation)
        ctx.recompute = recompute_activation
        ctx.b1_dtype = b1.dtype
        if recompute_activation:
            ctx.save_for_backward(lhs, w1, group_sizes, b1)
        else:
            ctx.save_for_backward(lhs, w1, group_sizes, g, u)
        return y

    @staticmethod
    def backward(ctx, dy):
        if ctx.recompute:
            lhs, w1, sizes, b1 = ctx.saved_tensors
            _, g, u = gmm_swiglu(lhs, w1, sizes, b1, emit_residuals=True)
        else:
            lhs, w1, sizes, g, u = ctx.saved_tensors
        gf, uf, dyf = g.float(), u.float(), dy.float()
        sig = torch.sigmoid(gf)
        silu = gf * sig
        dg = dyf * uf * (sig + silu * (1.0 - sig))
        du = dyf * silu
        dh = torch.cat([dg, du], dim=-1).to(lhs.dtype)             # [M, 2N]
        del gf, uf, dyf, sig, silu, dg, du
        need = ctx.needs_input_grad
        dx = gmm(dh, w1, sizes, None, True).to(lhs.dtype) if need[0] else None
        dw1 = tgmm(lhs, dh, sizes).to(w1.dtype) if need[1] else None
        db1 = group_bias_grad(dh, sizes, w1.shape[0]).to(ctx.b1_dtype) \
            if need[3] else None
        return dx, dw1, None, db1, None


def grouped_matmul(lhs, rhs, group_sizes, bias=None, transpose_rhs=False):
    """Grouped GEMM: rows of ``lhs [M, K]`` sorted by group, per-group
    weights ``rhs [G, K, N]`` (``[G, N, K]`` with ``transpose_rhs``),
    optional per-group ``bias [G, N]``; rows past ``sum(group_sizes)`` come
    back zero (bias included). Differentiable in ``lhs``, ``rhs`` and
    ``bias``."""
    return _GroupedMatmul.apply(lhs, rhs, group_sizes, bias,
                                bool(transpose_rhs))


def grouped_matmul_tgmm(lhs, dout, group_sizes):
    """Per-group ``lhs_gᵀ @ dout_g -> [G, K, N]`` (no gradient: it is the
    backward's product)."""
    return tgmm(lhs, dout, group_sizes)


def grouped_matmul_swiglu(lhs, w1, group_sizes, b1,
                          recompute_activation=False):
    """Fused grouped gate + up + swiglu: ``silu(x @ wg + bg) * (x @ wu + bu)``
    per group from one ``w1 [G, K, 2N]`` (gate columns, then up columns) and
    ``b1 [G, 2N]`` -> ``[M, N]``; rows past ``sum(group_sizes)`` zero.
    ``recompute_activation=True`` keeps no pre-activation residuals: the
    backward runs the fused product again for them."""
    return _GroupedMatmulSwiglu.apply(lhs, w1, group_sizes, b1,
                                      bool(recompute_activation))
