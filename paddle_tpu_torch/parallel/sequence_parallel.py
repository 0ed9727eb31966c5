"""Sequence and context parallelism (the counterpart of
``paddle_tpu/parallel/sequence_parallel.py``): Megatron-SP's scatter /
gather ops and linears over ``tp``, and attention over a sequence sharded
on ``sep``: ring attention (``ops/fused/ring_attention``, the flash
kernels as the hop body, K and V exchanged with the ring neighbours by
``torch.distributed`` point-to-point ops) and Ulysses (an all-to-all from
sequence shards to head shards, flash over the whole sequence for hq / n
heads, and back).

Sequence shards are equal and contiguous: rank r of ``sep`` holds rows
``r * s .. (r + 1) * s - 1``, so a model under sep takes its rope rows at
those global positions and shifts its labels before the split
(``sharding.ShardedTrainStep`` does both, and runs its forward and backward
inside :func:`sequence_sharded`, where ``sep_attention`` takes the ring).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..ops.fused.flash_attention import flash_attention
from ..ops.fused.ring_attention import ring_flash_bwd, ring_flash_fwd
from . import collective as C
from . import env, mp_ops
from .mp_layers import ColumnParallelLinear, RowParallelLinear

__all__ = ["ring_attention", "sep_attention", "sequence_sharded",
           "is_sequence_sharded", "ulysses_attention",
           "ulysses_flash", "local_all_to_all", "scatter", "gather",
           "all_gather", "reduce_scatter", "ColumnSequenceParallelLinear",
           "RowSequenceParallelLinear", "split_sequence", "gather_sequence"]


# ---------------------------------------------------- Megatron-SP's ops (tp)
def scatter(x, axis="tp"):
    """This rank's slice of the sequence (dim 1); backward all-gathers."""
    return mp_ops.c_split(x, axis, dim=1)


def gather(x, axis="tp"):
    """All-gather the sequence (dim 1); backward keeps the local slice."""
    return mp_ops.c_concat(x, axis, dim=1)


def all_gather(x, axis="tp"):
    """All-gather forward, reduce-scatter backward: the SP -> TP boundary."""
    return mp_ops.gather_seq_scatter_hidden(x, axis)


def reduce_scatter(x, axis="tp"):
    """Reduce-scatter forward, all-gather backward: the TP -> SP boundary."""
    return mp_ops.scatter_seq_gather_hidden(x, axis)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input arrives sequence-sharded over
    tp: the sequence all-gathered first (its backward reduce-scatters, so
    no ``c_identity``)."""

    def forward(self, x):
        if self.nranks == 1:
            return super().forward(x)
        y = all_gather(x, self.axis) @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return mp_ops.c_concat(y, self.axis, -1) if self.gather_output else y


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output returns sequence-sharded: the
    partial products reduce-scattered over the sequence, then the bias."""

    def forward(self, x):
        if self.nranks == 1:
            return super().forward(x)
        if not self.input_is_parallel:
            x = mp_ops.c_split(x, self.axis, -1)
        y = reduce_scatter(x @ self.weight, self.axis)
        return y if self.bias is None else y + self.bias


def split_sequence(x, mesh=None):
    """This rank's shard of the sequence (dim 1) over sep."""
    return mp_ops.c_split(x, "sep", dim=1)


def gather_sequence(x, mesh=None):
    """The sequence (dim 1) all-gathered over sep."""
    return mp_ops.c_concat(x, "sep", dim=1)


# ------------------------------------------------------------ ring attention
def _ring_exchange(pg, n: int) -> Callable:
    """The exchange of one rank: its block to the next rank of ``pg``, the
    previous rank's back (batched point-to-point on NCCL, isend / irecv on
    gloo)."""
    me = dist.get_rank(pg)
    nxt = dist.get_global_rank(pg, (me + 1) % n)
    prv = dist.get_global_rank(pg, (me - 1) % n)
    nccl = dist.get_backend(pg) == "nccl"

    def exchange(blocks):
        (blk,) = blocks
        send = [t.contiguous() for t in blk]
        recv = [torch.empty_like(t) for t in send]
        if nccl:
            ops = [dist.P2POp(dist.isend, t, nxt, pg) for t in send] + \
                [dist.P2POp(dist.irecv, t, prv, pg) for t in recv]
            reqs = dist.batch_isend_irecv(ops)
        else:
            reqs = [dist.isend(t, nxt, group=pg) for t in send] + \
                [dist.irecv(t, prv, group=pg) for t in recv]
        for r in reqs:
            r.wait()
        return [tuple(recv)]
    return exchange


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        pg, n = C.resolve_group(axis)
        me = dist.get_rank(pg)
        ex = _ring_exchange(pg, n)
        outs, lses = ring_flash_fwd([q], [k], [v], [me], n, ex, causal,
                                    scale)
        ctx.save_for_backward(q, k, v, outs[0], lses[0])
        ctx.args = (me, n, ex, causal, scale)
        return outs[0]

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        me, n, ex, causal, scale = ctx.args
        dq, dk, dv = ring_flash_bwd([q], [k], [v], [out], [lse],
                                    [dout.contiguous()], [me], n, ex, causal,
                                    scale)
        return dq[0], dk[0], dv[0], None, None, None


def ring_attention(q, k, v, axis="sep", causal: bool = True,
                   scale: Optional[float] = None):
    """Exact attention over the ring of ``axis``: q, k, v are this rank's
    equal sequence shards ``[b, s, heads, d]`` (GQA: kv heads divide the
    query heads), positions global (causal across shards). Differentiable
    in q, k and v. One rank: flash attention."""
    pg, n = C.resolve_group(axis)
    if n == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _RingAttention.apply(q, k, v, axis, causal, scale)


# ------------------------------------------------------------------ Ulysses
def local_all_to_all(ts: List[torch.Tensor], split: int, concat: int):
    """The all-to-all of ``len(ts)`` ranks held in one process: rank j gets
    chunk j (along ``split``) of every rank's tensor, concatenated along
    ``concat`` in rank order."""
    n = len(ts)
    chunks = [t.chunk(n, dim=split) for t in ts]
    return [torch.cat([chunks[i][j] for i in range(n)], dim=concat)
            for j in range(n)]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.args = (axis, split, concat)
        return C.all_to_all(x, group=axis, split_axis=split,
                            concat_axis=concat)

    @staticmethod
    def backward(ctx, g):
        axis, split, concat = ctx.args
        return C.all_to_all(g.contiguous(), group=axis, split_axis=concat,
                            concat_axis=split), None, None, None


def ulysses_flash(qs, ks, vs, n: int, a2a: Callable, causal: bool = True,
                  scale: Optional[float] = None):
    """Ulysses over ``n`` ranks, written over ``a2a(tensors, split,
    concat)`` (one tensor a listed rank): sequence shards ``[b, s / n, h,
    d]`` to head shards ``[b, s, h / n, d]``, flash attention, and back.
    Raises when the query or kv heads do not divide by n."""
    hq, hk = qs[0].shape[2], ks[0].shape[2]
    if hq % n or hk % n:
        raise ValueError(f"ulysses_attention needs heads divisible by the "
                         f"axis size (heads {hq}/{hk}, axis {n}); use "
                         f"ring_attention otherwise")
    qh, kh, vh = (a2a(list(ts), 2, 1) for ts in (qs, ks, vs))
    outs = [flash_attention(q, k, v, causal=causal, scale=scale)
            for q, k, v in zip(qh, kh, vh)]
    return a2a(outs, 1, 2)


def ulysses_attention(q, k, v, axis="sep", causal: bool = True,
                      scale: Optional[float] = None):
    """DeepSpeed-Ulysses context parallelism over ``axis`` (this rank's
    sequence shards in and out). Differentiable in q, k and v."""
    pg, n = C.resolve_group(axis)
    if n == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    def a2a(ts, split, concat):
        return [_AllToAll.apply(t, axis, split, concat) for t in ts]
    return ulysses_flash([q], [k], [v], n, a2a, causal, scale)[0]


# set while a step runs a forward and backward on sep-sharded sequences
# (a global flag: autograd runs a CUDA backward on a thread of its own)
_SEQUENCE_SHARDED = False


@contextlib.contextmanager
def sequence_sharded():
    """Marks the sequences that reach ``sep_attention`` as this rank's
    shards of the ``sep`` axis, for the forward and backward run inside."""
    global _SEQUENCE_SHARDED
    before, _SEQUENCE_SHARDED = _SEQUENCE_SHARDED, True
    try:
        yield
    finally:
        _SEQUENCE_SHARDED = before


def is_sequence_sharded() -> bool:
    return _SEQUENCE_SHARDED


def sep_attention(q, k, v, causal: bool = True,
                  scale: Optional[float] = None):
    """Context-parallel attention over the mesh's ``sep`` axis. Inside
    :func:`sequence_sharded` (under a mesh with sep > 1), q, k, v are this
    rank's sequence shards and the ring attends over the whole sequence;
    elsewhere they are whole sequences and flash attention runs on them, as
    JAX's ``sep_attention`` returns the attention of the global sequence it
    is given (flash when there is no mesh or sep is 1)."""
    mesh = env.get_mesh()
    if not _SEQUENCE_SHARDED or mesh is None or mesh.axis_size("sep") == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return ring_attention(q, k, v, "sep", causal, scale)
