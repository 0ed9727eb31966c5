"""Activation sharding constraints (the counterpart of
``paddle_tpu/parallel/activation_sharding.py``): a ``{kind: spec}`` table
installed by the ``activation_sharding`` context, read by ``constrain(x,
kind)`` calls in model code.

In the JAX package a constraint pins GSPMD's layout of an activation
(``with_sharding_constraint``). The port places collectives itself, so a
constraint acts on what carries a layout, a ``DTensor``: it is
redistributed to the placements the spec names on its mesh (a tensor dim
named by a mesh axis is sharded over it, the other mesh axes replicate,
``P.UNCONSTRAINED`` dims keep the placement they have). A local tensor is
returned as it is, as JAX's gate returns what is not traced. Spec axes
absent from the mesh are dropped; dims beyond a spec stay unconstrained,
and a spec longer than the tensor is cut.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from torch.distributed.tensor import DTensor, Replicate, Shard

from .sharding import P, _names

__all__ = ["activation_sharding", "constrain", "current_activation_specs"]

_TLS = threading.local()


def current_activation_specs() -> Optional[Dict[str, P]]:
    return getattr(_TLS, "specs", None)


def _mesh_names(mesh):
    dm = getattr(mesh, "mesh", mesh)        # HybridMesh / ProcessMesh
    return tuple(getattr(dm, "mesh_dim_names", None)
                 or getattr(mesh, "dim_names", None) or ())


def _prune(names, spec) -> P:
    out = []
    for entry in spec:
        if entry is None or entry is P.UNCONSTRAINED:
            out.append(entry)
        else:
            kept = tuple(a for a in _names(entry) if a in names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


class activation_sharding:
    """Installs ``specs`` (``{kind: P(...)}``, ``kind`` a logical activation
    class such as ``"residual"``) for ``constrain`` calls inside the
    context; axes absent from ``mesh`` are dropped dim by dim."""

    def __init__(self, mesh, specs: Dict[str, P]):
        names = _mesh_names(mesh)
        self._mesh = mesh
        self._specs = {k: _prune(names, s) for k, s in specs.items()}

    def __enter__(self):
        self._prev = getattr(_TLS, "specs", None)
        self._prev_mesh = getattr(_TLS, "mesh", None)
        _TLS.specs = self._specs
        _TLS.mesh = self._mesh
        return self

    def __exit__(self, *exc):
        _TLS.specs = self._prev
        _TLS.mesh = self._prev_mesh
        return False


def spec_placements(names, spec, ndim, current=None) -> list:
    """The placements, one a mesh axis of ``names``, that ``spec`` names
    for a tensor of ``ndim`` dims: a mesh axis named by a dim's entry
    shards that dim, any other replicates, unless ``current`` (the
    placements the tensor has) shards a dim the spec leaves
    ``P.UNCONSTRAINED``, which it keeps."""
    flat = tuple(spec)[:ndim]
    flat = flat + (P.UNCONSTRAINED,) * (ndim - len(flat))
    out = []
    for i, axis in enumerate(names):
        dims = [d for d, e in enumerate(flat)
                if e is not P.UNCONSTRAINED and axis in _names(e)]
        if dims:
            out.append(Shard(dims[0]))
            continue
        cur = None if current is None else current[i]
        keep = cur is not None and cur.is_shard() \
            and flat[cur.dim] is P.UNCONSTRAINED
        out.append(cur if keep else Replicate())
    return out


def constrain(x, kind: str):
    """``x`` constrained by the active context's spec for ``kind``: a
    ``DTensor`` redistributed to it, anything else (and any ``x`` outside a
    context or without a spec for ``kind``) returned as it is."""
    specs = current_activation_specs()
    if not specs or kind not in specs or not isinstance(x, DTensor):
        return x
    want = spec_placements(tuple(x.device_mesh.mesh_dim_names or ()),
                           specs[kind], x.ndim, x.placements)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
