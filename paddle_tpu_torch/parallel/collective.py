"""Collectives (the counterpart of ``paddle_tpu/parallel/collective.py``)
over ``torch.distributed``: NCCL on the card, gloo on the CPU.

``group`` is a mesh axis name or a tuple of them (as in JAX), a
:class:`Group`, a ``ProcessGroup``, or None (every rank). Paddle's
in-place forms keep their contract (``all_reduce`` and ``broadcast``
write into the tensor, the list forms fill the list); the functional forms
return the result, tiled as JAX's ``tiled=True``: ``all_gather`` concatenates
along ``axis``, ``reduce_scatter`` keeps this rank's chunk of the sum along
``axis``, ``all_to_all`` splits along ``split_axis`` and concatenates what
it receives along ``concat_axis``. A group of one rank returns its input.
``batch_isend_irecv`` posts point-to-point sends and receives together,
peers by global rank (the pipeline schedule's exchange of a tick).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from . import env

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "reduce_scatter", "all_to_all",
           "broadcast", "reduce", "scatter", "barrier", "resolve_group",
           "batch_isend_irecv"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A communication group: mesh axes (``axis``), or an explicit process
    group over ``ranks``."""

    def __init__(self, axis: Union[str, Sequence[str], None] = None,
                 ranks: Optional[List[int]] = None, process_group=None):
        self.axes = () if axis is None else (
            (axis,) if isinstance(axis, str) else tuple(axis))
        self.ranks = ranks
        self._pg = process_group

    @property
    def name(self) -> str:
        return "+".join(self.axes) if self.axes else f"ranks{self.ranks}"

    @property
    def process_group(self):
        if self._pg is not None or not self.axes:
            return self._pg
        return _mesh().group(self.axes)

    @property
    def nranks(self) -> int:
        return dist.get_world_size(self.process_group) \
            if dist.is_initialized() else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.process_group) \
            if dist.is_initialized() else 0

    def __repr__(self):
        return f"Group({self.name})"


_groups = {}


def new_group(ranks=None, axis=None, backend=None) -> Group:
    """A group over mesh ``axis`` (a name or a tuple), or over global
    ``ranks`` (every rank must call it, as ``dist.new_group``)."""
    if axis is not None:
        g = Group(axis, ranks)
    else:
        g = Group(None, ranks, dist.new_group(ranks, backend=backend)
                  if dist.is_initialized() else None)
    _groups[g.name] = g
    return g


def get_group(name: str) -> Optional[Group]:
    return _groups.get(name)


def _mesh():
    mesh = env.get_mesh()
    if mesh is None:
        raise RuntimeError("collective: a group named by mesh axes needs a "
                           "HybridMesh")
    return mesh


def resolve_group(group):
    """``(process group or None for every rank, its size)``."""
    if not dist.is_initialized():
        return None, 1
    if group is None:
        pg = None
    elif isinstance(group, (str, tuple, list)):
        pg = _mesh().group(group)
    elif isinstance(group, Group):
        pg = group.process_group
    else:
        pg = group
    return pg, dist.get_world_size(pg)


def all_reduce(tensor, op: str = ReduceOp.SUM, group=None,
               sync_op: bool = True):
    """Reduce ``tensor`` over the group in place; returns it."""
    pg, n = resolve_group(group)
    if n == 1:
        return tensor
    if op == ReduceOp.AVG:
        dist.all_reduce(tensor, dist.ReduceOp.SUM, group=pg)
        return tensor.div_(n)
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    dist.all_reduce(tensor, _TORCH_OPS[op], group=pg)
    return tensor


def _gather_list(tensor, pg, n):
    out = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(out, tensor.contiguous(), group=pg)
    return out


def all_gather(tensor_or_list, tensor=None, group=None, sync_op: bool = True,
               axis: int = 0):
    """``all_gather(tensor_list, tensor)`` fills the list with every rank's
    tensor (Paddle); ``out = all_gather(tensor, axis=...)`` returns them
    concatenated along ``axis``."""
    if isinstance(tensor_or_list, list):
        pg, n = resolve_group(group)
        tensor_or_list.extend(_gather_list(tensor, pg, n) if n > 1
                              else [tensor])
        return tensor_or_list
    pg, n = resolve_group(group)
    if n == 1:
        return tensor_or_list
    return torch.cat(_gather_list(tensor_or_list, pg, n), dim=axis)


def all_gather_object(obj_list: list, obj, group=None):
    pg, n = resolve_group(group)
    if n == 1:
        obj_list.append(obj)
        return obj_list
    out = [None] * n
    dist.all_gather_object(out, obj, group=pg)
    obj_list.extend(out)
    return obj_list


def _scatter_sum(x, pg, n, axis):
    """This rank's chunk along ``axis`` of the group's sum of ``x``."""
    axis = axis % x.dim()
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    me = dist.get_rank(pg)
    if dist.get_backend(pg) == "nccl":
        moved = x.movedim(axis, 0).contiguous()
        out = torch.empty((moved.shape[0] // n,) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=pg)
        return out.movedim(0, axis)
    total = x.clone()
    dist.all_reduce(total, group=pg)
    return total.chunk(n, dim=axis)[me].contiguous()


def reduce_scatter(tensor, tensor_list=None, op: str = ReduceOp.SUM,
                   group=None, sync_op: bool = True, axis: int = 0):
    """``reduce_scatter(out, [t_for_rank0, ...])`` writes into ``out``
    (Paddle); ``reduce_scatter(x, axis=...)`` returns this rank's chunk of
    the sum along ``axis``. Only SUM, as in JAX."""
    if op != ReduceOp.SUM:
        raise ValueError(f"reduce_scatter only supports SUM, got {op!r}")
    pg, n = resolve_group(group)
    src = tensor if tensor_list is None else torch.cat(tensor_list, dim=axis)
    out = src if n == 1 else _scatter_sum(src, pg, n, axis)
    if tensor_list is not None:
        tensor.copy_(out)
        return tensor
    return out


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op: bool = True, split_axis: int = 0,
               concat_axis: int = 0):
    """``out = all_to_all(x, split_axis=i, concat_axis=j)``: x split in as
    many chunks as ranks along i, chunk r sent to rank r, the received
    chunks concatenated along j in rank order. The list form fills
    ``out_tensor_list`` from ``in_tensor_list`` (one tensor a rank)."""
    pg, n = resolve_group(group)
    if isinstance(out_tensor_list, torch.Tensor):
        x = out_tensor_list
        if n == 1:
            return x
        chunks = x.chunk(n, dim=split_axis)
        got = _exchange(list(chunks), pg, n)
        return torch.cat(got, dim=concat_axis)
    got = _exchange(list(in_tensor_list), pg, n) if n > 1 \
        else list(in_tensor_list)
    out_tensor_list.extend(got)
    return out_tensor_list


def _exchange(chunks, pg, n):
    """Send ``chunks[r]`` to rank r; returns what each rank sent here."""
    send = torch.stack([c.contiguous() for c in chunks])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=pg)
    return list(recv.unbind(0))


def broadcast(tensor, src: int = 0, group=None, sync_op: bool = True):
    """``tensor`` from global rank ``src`` to the group, in place."""
    pg, n = resolve_group(group)
    if n > 1:
        dist.broadcast(tensor, src, group=pg)
    return tensor


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM, group=None,
           sync_op: bool = True):
    """Reduce into ``tensor`` on global rank ``dst``."""
    pg, n = resolve_group(group)
    if n > 1:
        if op == ReduceOp.AVG:
            dist.reduce(tensor, dst, dist.ReduceOp.SUM, group=pg)
            if env.get_rank() == dst:
                tensor.div_(n)
        else:
            dist.reduce(tensor, dst, _TORCH_OPS[op], group=pg)
    return tensor


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op: bool = True):
    """Fill ``tensor`` with ``tensor_list[i]`` of global rank ``src``, i
    this rank's index in the group."""
    pg, n = resolve_group(group)
    if n == 1:
        if tensor_list is not None:
            tensor.copy_(tensor_list[0])
        return tensor
    mine = env.get_rank() == src
    dist.scatter(tensor, [t.contiguous() for t in tensor_list] if mine
                 else None, src=src, group=pg)
    return tensor


def barrier(group=None):
    pg, n = resolve_group(group)
    if n > 1:
        dist.barrier(group=pg)


def batch_isend_irecv(sends, recvs, group=None):
    """Post every ``(tensor, dst)`` send and ``(tensor, src)`` receive (global
    ranks) at once and wait for all of them; every rank of ``group`` must
    post its matching halves in the same call. Returns the received
    tensors."""
    pg, _ = resolve_group(group)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group=pg)
           for t, dst in sends]
    ops += [dist.P2POp(dist.irecv, t, src, group=pg) for t, src in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [t for t, _ in recvs]
