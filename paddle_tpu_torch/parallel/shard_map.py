"""``shard_map`` (the counterpart of ``paddle_tpu/parallel/shard_map.py``):
run a function on each rank's shards.

``shard_map(f, mesh, in_specs, out_specs)`` returns a function of global
arguments: each tensor argument is cut to this rank's shard by its spec (a
``DTensor`` redistributed to the spec's placements and taken local, a plain
tensor read as the same global value on every rank and sliced), ``f`` runs
on the local shards (with whatever collectives it calls itself), and each
output becomes a ``DTensor`` with its spec's placements on ``mesh``
(``.full_tensor()`` is JAX's global result). Specs are ``P(...)`` of mesh
axis names, one for every argument or output (a single spec applies to
all; None leaves a non-tensor argument alone). ``check_vma`` /
``check_rep`` are accepted for JAX's signature: the port checks nothing
about replication.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from .activation_sharding import spec_placements
from .api import _as_mesh
from .sharding import P

__all__ = ["shard_map"]


def _per(specs, n):
    if isinstance(specs, P) or specs is None:
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"shard_map: {len(specs)} specs for {n} values")
    return specs


def _local(dm, t, placements):
    """This rank's shard of the global tensor ``t`` (``torch.chunk``'s
    split, as a DTensor's)."""
    coord = dm.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            parts = t.chunk(dm.size(i), dim=pl.dim)
            t = parts[coord[i]] if coord[i] < len(parts) else \
                t.narrow(pl.dim, 0, 0)
    return t.contiguous()


def shard_map(f, mesh=None, in_specs=None, out_specs=None, *,
              check_vma=None, check_rep=None, **kwargs):
    """``f`` mapped over the shards of ``mesh`` (a ``HybridMesh``, a
    ``ProcessMesh`` or a ``DeviceMesh``; None: the current mesh)."""
    dm = _as_mesh(mesh)
    names = tuple(dm.mesh_dim_names or ())

    def mapped(*args):
        local = []
        for a, spec in zip(args, _per(in_specs, len(args))):
            if torch.is_tensor(a) and spec is not None:
                want = spec_placements(names, spec, a.ndim)
                if isinstance(a, DTensor):
                    a = a.redistribute(dm, want).to_local()
                else:
                    a = _local(dm, a, want)
            local.append(a)
        out = f(*local)
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        wrapped = [DTensor.from_local(o, dm, spec_placements(names, s, o.ndim),
                                      run_check=False)
                   if torch.is_tensor(o) and s is not None else o
                   for o, s in zip(outs, _per(out_specs, len(outs)))]
        return wrapped[0] if single else type(out)(wrapped)

    return mapped
