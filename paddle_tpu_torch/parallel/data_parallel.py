"""``paddle.DataParallel`` (the counterpart of
``paddle_tpu/parallel/data_parallel.py``): wraps a module for eager
data-parallel training. After ``loss.backward()``, :meth:`reduce_gradients`
averages every gradient over the data-parallel group in flat buckets of
``comm_buffer_size`` MB (Paddle's EagerReducer: one all-reduce a bucket,
f32). The group is the mesh's ``dp`` axis when there is a mesh, else every
rank; on one rank the wrapper passes through.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from . import collective as C
from . import env

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        self._layers = layers
        self._comm_buffer_bytes = int(comm_buffer_size) * 1024 * 1024
        mesh = env.get_mesh()
        self._group = group if group is not None else (
            "dp" if mesh is not None else None)
        self._world = C.resolve_group(self._group)[1]

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    @torch.no_grad()
    def sync_params_buffers(self):
        """Every parameter and buffer from the group's first rank."""
        if self._world <= 1:
            return
        import torch.distributed as dist

        pg, _ = C.resolve_group(self._group)
        src = dist.get_global_rank(pg, 0) if pg is not None else 0
        for t in list(self._layers.parameters()) + list(
                self._layers.buffers()):
            C.broadcast(t.data, src=src, group=self._group)

    def _buckets(self, params: List[torch.Tensor]):
        bucket, size = [], 0
        for p in params:
            bucket.append(p)
            size += p.grad.numel() * p.grad.element_size()
            if size >= self._comm_buffer_bytes:
                yield bucket
                bucket, size = [], 0
        if bucket:
            yield bucket

    @torch.no_grad()
    def reduce_gradients(self):
        """Average every gradient over the group, one flat f32 all-reduce
        a bucket. Call after ``loss.backward()``, before the step."""
        if self._world <= 1:
            return
        params = [p for p in self._layers.parameters()
                  if p.requires_grad and p.grad is not None]
        for bucket in self._buckets(params):
            flat = torch.cat([p.grad.float().reshape(-1) for p in bucket])
            C.all_reduce(flat, group=self._group)
            flat /= self._world
            off = 0
            for p in bucket:
                n = p.grad.numel()
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
                off += n

    def scale_loss(self, loss):
        """Identity: the gradients are averaged in :meth:`reduce_gradients`."""
        return loss
