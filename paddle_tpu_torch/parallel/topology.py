"""The hybrid-parallel topology (the counterpart of
``paddle_tpu/parallel/topology.py``): a ``torch.distributed`` device mesh
with the JAX package's named axes, in its order ``pp, dp, fsdp, sep, ep,
tp`` (tp innermost: tensor-parallel ranks are neighbours). Rank r sits at
the row-major coordinate of r in that shape. Each axis has its process
group (``init_device_mesh``'s); a tuple of axes gets one group per
combination of the other axes' coordinates, made on first use (every rank
must ask for it in the same order, as for any ``new_group``), its ranks in
row-major order of the tuple's axes. A pipeline rank's stage is its ``pp``
coordinate (:meth:`HybridMesh.get_stage_id`); :meth:`HybridMesh.group_ranks`
gives the global ranks of its group, which the schedule's point-to-point
sends address. Expert parallelism (``ep``) is not ported yet: a degree
above 1 raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from . import env

__all__ = ["HybridMesh", "get_hybrid_mesh", "AXIS_ORDER"]

AXIS_ORDER = ("pp", "dp", "fsdp", "sep", "ep", "tp")

_current: Optional["HybridMesh"] = None


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class HybridMesh:
    """Named mesh for hybrid parallelism over the started process group
    (``init_parallel_env``): the product of the degrees must equal the
    world size. Axes of size 1 exist all the same, so that sharding rules
    name them uniformly.

      dp    pure data parallel (replicated parameters)
      fsdp  the sharding (ZeRO) axis, also data parallel
      sep   sequence / context parallel (ring attention)
      tp    tensor (model) parallel
      pp    pipeline stages (``parallel.PipelineTrainStep``)
      ep    expert parallel (must be 1 for now)
    """

    def __init__(self, dp: int = 1, fsdp: int = 1, tp: int = 1, sep: int = 1,
                 pp: int = 1, ep: int = 1):
        sizes = {"pp": pp, "dp": dp, "fsdp": fsdp, "sep": sep, "ep": ep,
                 "tp": tp}
        if ep > 1:
            raise NotImplementedError(
                "HybridMesh: expert parallelism (ep) is not ported yet; ep "
                "must be 1")
        total = 1
        for s in sizes.values():
            total *= s
        world = env.get_world_size()
        if not dist.is_initialized():
            raise RuntimeError("HybridMesh: call init_parallel_env() first")
        if total != world:
            raise ValueError(f"mesh size {sizes} (={total}) must equal the "
                             f"world size {world}")
        dev = env.current_device()
        self.sizes: Dict[str, int] = sizes
        self.device = dev
        self.mesh = init_device_mesh(dev.type, tuple(sizes[a]
                                                     for a in AXIS_ORDER),
                                     mesh_dim_names=AXIS_ORDER)
        self._ranks = torch.arange(world).reshape(
            [sizes[a] for a in AXIS_ORDER])
        self._groups: Dict[Tuple[str, ...], object] = {}
        global _current
        _current = self
        env.set_mesh(self)

    # -- coordinates and groups ----------------------------------------------
    def axis_size(self, name: str) -> int:
        return self.sizes[name]

    def axis_rank(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        coord = (self._ranks == env.get_rank()).nonzero()[0]
        return int(coord[AXIS_ORDER.index(name)])

    def group_size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.sizes[a]
        return n

    def group_rank(self, axes) -> int:
        """This rank's index in the group of ``axes`` (row-major over the
        axes, in the mesh's order)."""
        r = 0
        for a in sorted(_axes(axes), key=AXIS_ORDER.index):
            r = r * self.sizes[a] + self.axis_rank(a)
        return r

    def group_ranks(self, axes) -> list:
        """The global ranks of this rank's group of ``axes``, in the order
        of :meth:`group_rank`."""
        dims = [AXIS_ORDER.index(a) for a in _axes(axes)]
        coord = (self._ranks == env.get_rank()).nonzero()[0]
        index = tuple(slice(None) if i in dims else int(coord[i])
                      for i in range(len(AXIS_ORDER)))
        return self._ranks[index].reshape(-1).tolist()

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of ``axes`` (an axis name or a tuple)."""
        key = tuple(sorted(_axes(axes), key=AXIS_ORDER.index))
        if key in self._groups:
            return self._groups[key]
        if len(key) == 1:
            g = self.mesh.get_group(key[0])
        else:
            dims = [AXIS_ORDER.index(a) for a in key]
            rest = [i for i in range(len(AXIS_ORDER)) if i not in dims]
            rows = self._ranks.permute(rest + dims).reshape(
                -1, self.group_size(key))
            g, me = None, env.get_rank()
            for row in rows.tolist():
                pg = dist.new_group(row)
                if me in row:
                    g = pg
        self._groups[key] = g
        return g

    # -- Paddle's HybridCommunicateGroup surface -----------------------------
    def get_data_parallel_world_size(self) -> int:
        return self.sizes["dp"] * self.sizes["fsdp"]

    def get_model_parallel_world_size(self) -> int:
        return self.sizes["tp"]

    def get_pipe_parallel_world_size(self) -> int:
        return self.sizes["pp"]

    def get_stage_id(self) -> int:
        """This rank's pipeline stage: its ``pp`` coordinate."""
        return self.axis_rank("pp")

    def get_pipe_parallel_group(self):
        return self.group("pp")

    def get_sharding_parallel_world_size(self) -> int:
        return self.sizes["fsdp"]

    def get_sep_parallel_world_size(self) -> int:
        return self.sizes["sep"]

    def get_expert_parallel_world_size(self) -> int:
        return self.sizes["ep"]

    def __repr__(self) -> str:
        return f"HybridMesh({self.sizes})"


def get_hybrid_mesh() -> Optional[HybridMesh]:
    return _current
