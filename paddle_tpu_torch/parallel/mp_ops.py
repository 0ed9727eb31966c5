"""Model-parallel collectives with Megatron's gradients (the counterpart
of ``paddle_tpu/parallel/mp_ops.py``): each is a ``torch.autograd.Function``
whose backward is the JAX function's custom VJP. ``axis`` names the mesh
axis (or tuple of axes) of the group, ``tp`` by default; a group of one
rank makes every op an identity.
"""

from __future__ import annotations

import torch

from . import collective as C

__all__ = ["c_identity", "mp_allreduce", "c_split", "c_concat",
           "gather_seq_scatter_hidden", "scatter_seq_gather_hidden"]


def _split(x, axis, dim):
    pg, n = C.resolve_group(axis)
    if n == 1:
        return x
    import torch.distributed as dist

    return x.chunk(n, dim=dim)[dist.get_rank(pg)].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.contiguous().clone(), group=ctx.axis), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return C.all_reduce(x.contiguous().clone(), group=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _split(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(g.contiguous(), group=ctx.axis, axis=ctx.dim), \
            None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return C.all_gather(x.contiguous(), group=axis, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.axis, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return C.all_gather(x.contiguous(), group=axis, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return C.reduce_scatter(g.contiguous(), group=ctx.axis,
                                axis=ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return C.reduce_scatter(x.contiguous(), group=axis, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(g.contiguous(), group=ctx.axis, axis=ctx.dim), \
            None, None


def c_identity(x, axis="tp"):
    """Identity forward, all-reduce (sum) backward: where a replicated
    activation enters a column-parallel region."""
    return _Identity.apply(x, axis)


def mp_allreduce(x, axis="tp"):
    """All-reduce (sum) forward, identity backward: the output of a
    row-parallel product."""
    return _AllReduce.apply(x, axis)


def c_split(x, axis="tp", dim: int = -1):
    """This rank's slice along ``dim``; backward all-gathers the slices."""
    return _Split.apply(x, axis, dim % x.dim())


def c_concat(x, axis="tp", dim: int = -1):
    """The slices all-gathered along ``dim``; backward keeps this rank's
    slice."""
    return _Concat.apply(x, axis, dim % x.dim())


def gather_seq_scatter_hidden(x, axis="tp"):
    """All-gather the sequence dim (1) forward, reduce-scatter it backward
    (Paddle's ``AllGatherOp``: the gathered activation feeds per-rank weight
    shards, so each rank's gradient is a partial sum)."""
    return _GatherSeq.apply(x, axis, 1)


def scatter_seq_gather_hidden(x, axis="tp"):
    """Reduce-scatter the sequence dim (1) forward, all-gather backward
    (Paddle's ``ReduceScatterOp``)."""
    return _ScatterSeq.apply(x, axis, 1)
