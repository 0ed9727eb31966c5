"""MoE routing ops (the counterpart of ``paddle_tpu/ops/moe_ops.py``):
``number_count``, ``assign_pos``, ``limit_by_capacity`` and
``prune_gate_by_capacity``, in torch integer ops on the ids' device.

They are the index-form routing surface of the reference MoE layer; the
port's ``MoELayer`` routes by capacity slots (``parallel/moe.py``) and does
not call them. Ids, counts and positions come back int64 (JAX's are int32
without x64); the values are JAX's. Ids must lie in ``0 .. E - 1`` for
``assign_pos`` and ``prune_gate_by_capacity``.
"""

from __future__ import annotations

import torch

__all__ = ["number_count", "assign_pos", "limit_by_capacity",
           "prune_gate_by_capacity"]


def _ids(x) -> torch.Tensor:
    return torch.as_tensor(x).reshape(-1).long()


def number_count(numbers, upper_range: int) -> torch.Tensor:
    """How many ids equal each of ``0 .. upper_range - 1``; ids outside
    that range (the -1 of a dropped token) are not counted."""
    ids = _ids(numbers)
    keep = (ids >= 0) & (ids < upper_range)
    return torch.bincount(ids[keep], minlength=upper_range)[:upper_range]


def assign_pos(x, cum_count, eff_num_len=None) -> torch.Tensor:
    """The permutation that groups token indices by expert id (stable within
    an expert): ``out[starts[e] + r] = t`` for the r-th token t of expert
    e, with ``starts`` the exclusive cumulative counts from ``cum_count``
    (inclusive)."""
    ids = _ids(x)
    n = ids.shape[0]
    cum = torch.as_tensor(cum_count, device=ids.device).reshape(-1).long()
    starts = torch.cat([cum.new_zeros(1), cum[:-1]])
    onehot = (ids[:, None] == torch.arange(cum.shape[0],
                                           device=ids.device)).long()
    within = (torch.cumsum(onehot, dim=0) - 1).gather(1, ids[:, None])[:, 0]
    pos = starts[ids] + within
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_(
        0, pos, torch.arange(n, device=ids.device))


def limit_by_capacity(expert_count, capacity, n_worker: int = 1):
    """Per-expert counts clamped by ``capacity``; with ``n_worker > 1``
    (counts ``[n_worker * E]``, worker-major) each expert's capacity is
    handed to the workers in order until it runs out."""
    ec = torch.as_tensor(expert_count).long()
    cap = torch.as_tensor(capacity, device=ec.device).long()
    if ec.dim() == 1 and n_worker > 1:
        remaining = cap
        outs = []
        for row in ec.reshape(n_worker, -1):
            take = torch.minimum(row, remaining)
            remaining = remaining - take
            outs.append(take)
        return torch.stack(outs).reshape(-1)
    return torch.minimum(ec, cap)


def prune_gate_by_capacity(gate_idx, expert_count, n_expert: int = 1,
                           n_worker: int = 1) -> torch.Tensor:
    """Expert ids with the tokens past their expert's count (in token
    order) set to -1."""
    ids = _ids(gate_idx)
    counts = torch.as_tensor(expert_count,
                             device=ids.device).reshape(-1).long()
    onehot = (ids[:, None] == torch.arange(n_expert * n_worker,
                                           device=ids.device)).long()
    rank = (torch.cumsum(onehot, dim=0) - 1).gather(1, ids[:, None])[:, 0]
    return torch.where(rank < counts[ids], ids, -1)
