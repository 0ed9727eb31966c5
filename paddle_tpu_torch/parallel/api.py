"""The auto-parallel user API (the counterpart of
``paddle_tpu/parallel/api.py``) on ``torch.distributed.tensor``: a
``ProcessMesh`` is a ``DeviceMesh``, a distributed tensor a ``DTensor``,
and Paddle's ``Shard`` / ``Replicate`` / ``Partial`` placements (one per
mesh dim) map onto DTensor's. ``reshard`` is ``DTensor.redistribute``
(the all-gather, slice, all-reduce, reduce-scatter or all-to-all that the
pair of placements needs); a ``Partial`` made from a replicated value
keeps the value on the first coordinate of each partial dim and zeros
elsewhere for ``sum`` (the value everywhere for ``avg``/``max``/``min``),
as JAX embeds it. These are the user-facing placements only: the
hybrid-parallel training path (``sharding``, ``mp_layers``) hands the
kernels plain local tensors. Cross-mesh resharding is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor import Partial as _TPartial
from torch.distributed.tensor import Replicate as _TReplicate
from torch.distributed.tensor import Shard as _TShard

from . import env

__all__ = ["ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
           "shard_tensor", "reshard", "dtensor_from_local", "shard_layer",
           "shard_optimizer", "placements_of"]


class ProcessMesh:
    """``paddle.distributed.ProcessMesh``: a ``DeviceMesh`` from a nested
    list of ranks (every rank of the world must appear once, in the
    started process group), a ``DeviceMesh`` or a ``HybridMesh``."""

    def __init__(self, mesh, dim_names: Optional[List[str]] = None):
        if isinstance(mesh, DeviceMesh):
            self._mesh = mesh
        elif hasattr(mesh, "mesh") and isinstance(mesh.mesh, DeviceMesh):
            self._mesh = mesh.mesh
        else:
            arr = np.asarray(mesh)
            if dim_names is None:
                dim_names = [f"d{i}" for i in range(arr.ndim)]
            self._mesh = DeviceMesh(env.current_device().type,
                                    torch.as_tensor(arr),
                                    mesh_dim_names=tuple(dim_names))
        self.shape = list(self._mesh.mesh.shape)
        self.dim_names = list(self._mesh.mesh_dim_names or [])

    @property
    def mesh(self) -> DeviceMesh:
        return self._mesh

    @property
    def process_ids(self):
        return self._mesh.mesh.flatten().tolist()

    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and self._mesh == other._mesh

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def is_shard(self, dim=None):
        return True if dim is None else dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        return isinstance(o, Replicate)


class Partial(Placement):
    """A pending reduction over a mesh dim: ``sum``, ``avg``, ``max`` or
    ``min``."""

    REDUCE_TYPES = ("sum", "avg", "max", "min")

    def __init__(self, reduce_type: str = "sum"):
        if reduce_type not in self.REDUCE_TYPES:
            raise ValueError(f"Partial reduce_type must be one of "
                             f"{self.REDUCE_TYPES}, got {reduce_type!r}")
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, o):
        return isinstance(o, Partial) and o.reduce_type == self.reduce_type


def _as_mesh(mesh) -> DeviceMesh:
    if mesh is None:
        mesh = env.get_mesh()
        if mesh is None:
            raise RuntimeError("no mesh: build a HybridMesh or pass a "
                               "ProcessMesh")
    return mesh.mesh if isinstance(mesh, ProcessMesh) \
        else ProcessMesh(mesh).mesh


def _torch_placements(placements):
    out = []
    for p in placements:
        if isinstance(p, Shard):
            out.append(_TShard(p.dim))
        elif isinstance(p, Partial):
            out.append(_TPartial(p.reduce_type))
        else:
            out.append(_TReplicate())
    return out


def _paddle_placements(placements):
    out = []
    for p in placements:
        if p.is_shard():
            out.append(Shard(p.dim))
        elif p.is_partial():
            out.append(Partial(p.reduce_op))
        else:
            out.append(Replicate())
    return out


def placements_of(x):
    """``(ProcessMesh, placements)`` of a distributed tensor, or None."""
    if not isinstance(x, DTensor):
        return None
    return ProcessMesh(x.device_mesh), _paddle_placements(x.placements)


def shard_tensor(x, mesh=None, placements: Sequence[Placement] = (),
                 dtype=None, stop_gradient: Optional[bool] = None):
    """``dist.shard_tensor``: the same global value on every rank, placed
    per ``placements`` (one per mesh dim)."""
    dm = _as_mesh(mesh)
    t = torch.as_tensor(x, dtype=dtype).to(env.current_device())
    partial = [i for i, p in enumerate(placements) if isinstance(p, Partial)]
    if partial:
        # Shard / Replicate first, then the partial dims take the value on
        # their first coordinate (sum) or everywhere (the other types)
        base = [Replicate() if isinstance(p, Partial) else p
                for p in placements]
        local = distribute_tensor(t, dm, _torch_placements(base)).to_local()
        coords = dm.get_coordinate()
        if any(placements[i].reduce_type == "sum" and coords[i] != 0
               for i in partial):
            local = torch.zeros_like(local)
        out = DTensor.from_local(local, dm, _torch_placements(placements),
                                 run_check=False)
    else:
        out = distribute_tensor(t, dm, _torch_placements(placements))
    if stop_gradient is not None:
        out.requires_grad_(not stop_gradient)
    return out


def reshard(x, mesh=None, placements: Sequence[Placement] = ()):
    """``dist.reshard``: the {Shard, Replicate, Partial} transitions on one
    mesh (``DTensor.redistribute``)."""
    dm = _as_mesh(mesh)
    if not isinstance(x, DTensor):
        return shard_tensor(x, dm, placements)
    if x.device_mesh != dm:
        raise NotImplementedError("reshard: moving between meshes is not "
                                  "ported")
    return x.redistribute(dm, _torch_placements(placements))


def dtensor_from_local(local, mesh=None,
                       placements: Sequence[Placement] = ()):
    """A distributed tensor from each rank's local piece."""
    return DTensor.from_local(local, _as_mesh(mesh),
                              _torch_placements(placements), run_check=False)


def shard_layer(layer: nn.Module, mesh=None, shard_fn=None, input_fn=None,
                output_fn=None):
    """``dist.shard_layer``: ``shard_fn(name, sublayer, process_mesh)``
    places each sublayer's parameters (default: every parameter
    replicated); ``input_fn(inputs, process_mesh)`` and
    ``output_fn(outputs, process_mesh)`` become forward pre- and post-hooks
    of ``layer``."""
    dm = _as_mesh(mesh)
    pm = ProcessMesh(dm)
    if shard_fn is None:
        def shard_fn(name, sub, m):  # noqa: F811
            for pname, p in list(sub.named_parameters(recurse=False)):
                if not isinstance(p, DTensor):
                    sub.register_parameter(pname, nn.Parameter(
                        distribute_tensor(p.detach(), dm,
                                          [_TReplicate()] * dm.ndim),
                        requires_grad=p.requires_grad))
    for name, sub in layer.named_modules():
        shard_fn(name, sub, pm)
    if input_fn is not None:
        layer.register_forward_pre_hook(lambda m, args: input_fn(args, pm))
    if output_fn is not None:
        layer.register_forward_hook(lambda m, args, out: output_fn(out, pm))
    return layer


class _ShardedOptimizer:
    """``dist.shard_optimizer``: the wrapped optimizer with each state
    entry shaped like its parameter placed as the parameter is (or by
    ``shard_fn(key, param, value)``)."""

    def __init__(self, optimizer, shard_fn=None):
        self._inner = optimizer
        inner_init = optimizer._init_state

        def sharded_init(param):
            st = inner_init(param)
            if not isinstance(param, DTensor):
                return st
            out = {}
            for k, v in st.items():
                if shard_fn is not None:
                    out[k] = shard_fn(k, param, v)
                elif not isinstance(v, DTensor) \
                        and tuple(v.shape) == tuple(param.shape):
                    out[k] = distribute_tensor(v, param.device_mesh,
                                               param.placements)
                else:
                    out[k] = v
            return out

        optimizer._init_state = sharded_init

    def __getattr__(self, name):
        return getattr(self._inner, name)


def shard_optimizer(optimizer, mesh=None, shard_fn=None):
    return _ShardedOptimizer(optimizer, shard_fn)
