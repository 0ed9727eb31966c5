"""Ring attention with the flash kernels as the hop body (the counterpart of
``paddle_tpu/ops/pallas/ring_attention.py``).

n ranks each hold an equal shard of the sequence: q, k, v ``[b, s, heads,
d]`` (GQA: k and v keep their kv heads on the ring). K and V travel the
ring, rank r sending to r + 1, while each rank's q stays: at hop h rank r
holds the block of rank ``r - h``. Causal, the hop-0 (diagonal) block is
causal with ``q_offset`` 0, a strictly earlier block is seen whole, and a
strictly later one (``r < h``) is skipped, kernel and all. The forward
merges each hop's normalised output with its row logsumexp in f32; the
backward is a ring pass of its own: every hop calls the flash backward with
the global (out, lse), which is exact per block, and dk, dv travel with
their blocks and reach home after a last rotation.

The schedule is written once, over lists: ``qs[j]`` is the shard of rank
``ranks[j]`` and ``exchange(blocks)`` returns, for each listed rank, the
block its ring predecessor held. One process a rank lists one rank and
exchanges with ``torch.distributed`` (``parallel.sequence_parallel``); a
process that holds every rank lists them all and exchanges by rotating the
list (:func:`rotate`), which is how the schedule is checked on one card.
CPU tensors take the flash plain versions; CUDA tensors the kernels.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from .flash_attention import _backward, _forward

__all__ = ["ring_flash_fwd", "ring_flash_bwd", "rotate"]

Exchange = Callable[[List[tuple]], List[tuple]]


def rotate(blocks: List[tuple]) -> List[tuple]:
    """The in-process exchange when ``blocks`` lists every rank in ring
    order: rank j receives rank j - 1's block."""
    return blocks[-1:] + blocks[:-1]


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _seen(rank: int, hop: int, causal: bool) -> bool:
    return not causal or rank >= hop


def ring_flash_fwd(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], ranks: Sequence[int], n: int,
                   exchange: Exchange, causal: bool = True,
                   scale: Optional[float] = None):
    """``(outs, lses)`` for each listed rank: out ``[b, s, hq, d]`` in q's
    dtype, lse ``[b, hq, s]`` f32, over the whole ring's keys."""
    sc = _scale(qs[0], scale)
    s = qs[0].shape[1]
    outs, lses = [], []
    for q, k, v in zip(qs, ks, vs):
        if k.shape[1] != s:
            raise ValueError(f"ring attention needs equal shards, got q "
                             f"{s} and k {k.shape[1]} rows")
        o, lse = _forward(q, k, v, causal, sc, s, 0, True, None, None, None)
        outs.append(o.float())
        lses.append(lse)
    blocks = [(k, v) for k, v in zip(ks, vs)]
    for hop in range(1, n):
        blocks = exchange(blocks)
        for j, r in enumerate(ranks):
            if not _seen(r, hop, causal):
                continue
            kb, vb = blocks[j]
            o, lse = _forward(qs[j], kb, vb, False, sc, s, 0, True, None,
                              None, None)
            new = torch.logaddexp(lses[j], lse)
            w_old = torch.exp(lses[j] - new).transpose(1, 2)[..., None]
            w_new = torch.exp(lse - new).transpose(1, 2)[..., None]
            outs[j] = outs[j] * w_old + o.float() * w_new
            lses[j] = new
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def ring_flash_bwd(qs, ks, vs, outs, lses, douts, ranks: Sequence[int],
                   n: int, exchange: Exchange, causal: bool = True,
                   scale: Optional[float] = None):
    """``(dqs, dks, dvs)`` for each listed rank, in the inputs' dtypes,
    from the forward's global ``outs`` and ``lses``."""
    sc = _scale(qs[0], scale)
    s = qs[0].shape[1]
    dqs, dks, dvs = [], [], []
    for q, k, v, o, lse, do in zip(qs, ks, vs, outs, lses, douts):
        dq, dk, dv = _backward(q, k, v, o, lse, do, causal, sc, s, 0, None,
                               None, None)
        dqs.append(dq.float())
        dks.append(dk.float())
        dvs.append(dv.float())
    blocks = [(k, v, dk, dv) for k, v, dk, dv in zip(ks, vs, dks, dvs)]
    for hop in range(1, n):
        blocks = exchange(blocks)
        for j, r in enumerate(ranks):
            kb, vb, dk, dv = blocks[j]
            if _seen(r, hop, causal):
                dq_h, dk_h, dv_h = _backward(qs[j], kb, vb, outs[j], lses[j],
                                             douts[j], False, sc, s, 0, None,
                                             None, None)
                dqs[j] += dq_h.float()
                blocks[j] = (kb, vb, dk + dk_h.float(), dv + dv_h.float())
    # one more rotation brings every block's dk, dv home
    blocks = exchange([(dk, dv) for _, _, dk, dv in blocks])
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for (dk, _), k in zip(blocks, ks)],
            [dv.to(v.dtype) for (_, dv), v in zip(blocks, vs)])
