"""The distributed environment (the counterpart of
``paddle_tpu/parallel/env.py``) over ``torch.distributed``.

One process a rank. :func:`init_parallel_env` starts the default process
group: NCCL for ``cuda`` (the default), gloo for ``device="cpu"``. The
rendezvous is an ``init_method`` URL (``file://`` or ``tcp://``), else the
environment (``torchrun``'s ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE``, or
Paddle's ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``), else, for one
process, a ``file://`` store in a fresh temporary directory: no network.
The current mesh is a :class:`~.topology.HybridMesh`.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "get_mesh",
           "set_mesh", "is_initialized", "ParallelEnv", "current_device"]

_mesh = None
_device: Optional[torch.device] = None


def init_parallel_env(init_method: Optional[str] = None,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None, device=None,
                      timeout: float = 600.0) -> "ParallelEnv":
    """Start the default process group once (later calls return the
    environment as it is). ``device`` (default ``cuda``, which needs a
    card) picks the backend and, for ``cuda``, this rank's card (its local
    rank, ``LOCAL_RANK``, modulo the cards). ``timeout`` in seconds."""
    global _device
    dev = resolve_device(device)
    if dist.is_initialized():
        return ParallelEnv()
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE")
                         or env.get("PADDLE_TRAINERS_NUM") or 1)
    if rank is None:
        rank = int(env.get("RANK") or env.get("PADDLE_TRAINER_ID") or 0)
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        elif world_size == 1:
            store = os.path.join(tempfile.mkdtemp(prefix="ptt_dist_"), "store")
            init_method = f"file://{store}"
        else:
            raise ValueError("init_parallel_env: several ranks need an "
                             "init_method or MASTER_ADDR / MASTER_PORT")
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    _device = dev
    return ParallelEnv()


def is_initialized() -> bool:
    return dist.is_initialized()


def current_device() -> torch.device:
    """The device of this rank's collectives (``cuda:<local>`` or
    ``cpu``)."""
    if _device is not None:
        return _device
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_mesh():
    """The current :class:`~.topology.HybridMesh` (None before one is
    built)."""
    return _mesh


def set_mesh(mesh) -> None:
    global _mesh
    _mesh = mesh


def reduce_global_norm_sq(sums):
    """The hook of ``ClipGradByGlobalNorm``: ``sums`` maps a tuple of mesh
    axis names to the f32 sum of squares of the gradients sharded over
    exactly those axes; each is summed over its axes' group (every element
    then counts once, a replicated one on one rank only) and the total
    returned. Without a mesh the local total."""
    from . import collective

    total = None
    for axes, s in sums.items():
        axes = tuple(a for a in axes if _mesh is not None
                     and _mesh.axis_size(a) > 1)
        if axes:
            s = collective.all_reduce(s.clone(), group=axes)
        total = s if total is None else total + s
    return total


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def device_id(self) -> int:
        dev = current_device()
        return dev.index or 0 if dev.type == "cuda" else 0

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("LOCAL_RANK", get_rank()))
