"""The fleet facade (the counterpart of ``paddle_tpu/parallel/fleet.py``):
``fleet.init(strategy=...)`` builds the :class:`~.topology.HybridMesh` of
the strategy's hybrid degrees over the started process group
(``init_parallel_env`` is called if it was not), ``distributed_model``
returns a wrapper whose ``train_batch((ids, labels), optimizer)`` runs a
:class:`~.sharding.ShardedTrainStep` (the ZeRO stage from
``sharding_configs`` when ``strategy.sharding``), and
``distributed_optimizer`` tags the optimizer. With ``pp_degree > 1`` the
step is a :class:`~.pipeline.PipelineTrainStep` instead, as JAX's fleet
builds it (``fleet.py:216-230``): ``pipeline_configs["schedule_mode"]``
``1F1B``, ``FThenB``, ``ZBH1`` or ``VPP`` (with ``vpp_degree``, default 2),
``accumulate_steps`` micro-batches, ``recompute`` as its remat.
``dp_degree`` 1 or -1 absorbs the ranks the other degrees leave.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from . import env

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group", "Fleet"]


@dataclasses.dataclass
class HybridConfig:
    """``hybrid_configs`` (``distributed_strategy.proto:46-53``)."""

    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1
    ep_degree: int = 1


class DistributedStrategy:
    """The strategy's knobs; the fields the port acts on are the hybrid
    degrees, ``sharding`` / ``sharding_configs["stage"]`` and
    ``recompute``. Other assignments are kept as plain attributes."""

    def __init__(self):
        self.hybrid_configs = HybridConfig()
        self.amp = False
        self.amp_configs: Dict[str, Any] = {"init_loss_scaling": 2.0 ** 15,
                                            "use_pure_bf16": True}
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {}
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {"stage": 1}
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "schedule_mode": "1F1B"}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1}
        self.fuse_all_reduce_ops = True
        self.find_unused_parameters = False

    def __setattr__(self, k, v):
        if k == "hybrid_configs" and isinstance(v, dict):
            hc = HybridConfig()
            for kk, vv in v.items():
                if hasattr(hc, kk):
                    setattr(hc, kk, int(vv))
            object.__setattr__(self, "hybrid_configs", hc)
            return
        object.__setattr__(self, k, v)

    def __repr__(self):
        return (f"DistributedStrategy(hybrid={self.hybrid_configs}, "
                f"amp={self.amp}, recompute={self.recompute}, "
                f"sharding={self.sharding}, pipeline={self.pipeline})")


class _HCG:
    """Paddle's HybridCommunicateGroup over the mesh."""

    def __init__(self, hm):
        self._hm = hm

    def get_data_parallel_world_size(self):
        return self._hm.sizes["dp"]

    def get_model_parallel_world_size(self):
        return self._hm.sizes["tp"]

    def get_pipe_parallel_world_size(self):
        return self._hm.sizes["pp"]

    def get_stage_id(self):
        return self._hm.get_stage_id()

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._hm.sizes["pp"] - 1

    def get_pipe_parallel_group(self):
        return self._hm.get_pipe_parallel_group()

    def get_sharding_parallel_world_size(self):
        return self._hm.sizes["fsdp"]

    def get_sep_parallel_world_size(self):
        return self._hm.sizes["sep"]

    @property
    def topology(self):
        return dict(self._hm.sizes)


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hm = None
        self._hcg = None
        self._initialized = False

    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None, device=None):
        from .topology import HybridMesh

        env.init_parallel_env(device=device)
        strategy = strategy or DistributedStrategy()
        hc = strategy.hybrid_configs
        n = env.get_world_size()
        others = (hc.mp_degree * hc.pp_degree * hc.sharding_degree
                  * hc.sep_degree * hc.ep_degree)
        if hc.dp_degree * others != n:
            if hc.dp_degree not in (-1, 1):
                raise ValueError(
                    f"hybrid degrees product {hc.dp_degree * others} != world "
                    f"size {n} and dp_degree={hc.dp_degree} was set "
                    f"explicitly (use dp_degree=-1 to absorb the rest)")
            hc.dp_degree = max(n // others, 1)
        self._hm = HybridMesh(dp=hc.dp_degree, fsdp=hc.sharding_degree,
                              tp=hc.mp_degree, sep=hc.sep_degree,
                              pp=hc.pp_degree, ep=hc.ep_degree)
        self._hcg = _HCG(self._hm)
        self._strategy = strategy
        self._initialized = True
        return self

    def _check_init(self):
        if not self._initialized:
            raise RuntimeError("call fleet.init(...) first")

    @property
    def strategy(self):
        return self._strategy

    @property
    def mesh(self):
        self._check_init()
        return self._hm

    def get_hybrid_communicate_group(self):
        self._check_init()
        return self._hcg

    def worker_num(self):
        return env.get_world_size()

    def worker_index(self):
        return env.get_rank()

    def barrier_worker(self):
        from .collective import barrier

        barrier()

    def distributed_model(self, model):
        self._check_init()
        return _DistributedModel(model, self)

    def distributed_optimizer(self, optimizer, strategy=None):
        self._check_init()
        optimizer._fleet = self
        return optimizer


#: ``pipeline_configs["schedule_mode"]`` -> ``PipelineTrainStep``'s schedule
SCHEDULE_MODES = {"1F1B": "1f1b", "FThenB": "fthenb", "ZBH1": "zb",
                  "VPP": "vpp"}


class _DistributedModel:
    """The model with ``train_batch``: a ShardedTrainStep (a
    PipelineTrainStep with ``pp_degree > 1``) built on the first batch
    (when the optimizer arrives)."""

    def __init__(self, model, fleet_obj: Fleet):
        self._model = model
        self._fleet = fleet_obj
        self._step = None

    @property
    def model(self):
        return self._model

    def __getattr__(self, name):
        return getattr(self.__dict__["_model"], name)

    def _build_step(self, optimizer):
        from ..nn.clip import ClipGradByGlobalNorm
        from .sharding import ShardedTrainStep, ShardingStage

        strat = self._fleet._strategy
        clip = getattr(optimizer, "_grad_clip", None)
        if strat.hybrid_configs.pp_degree > 1:
            from .pipeline import PipelineTrainStep

            if clip is not None:
                raise ValueError(f"train_batch: the pipelined step applies "
                                 f"no clip ({type(clip).__name__})")
            cfg = strat.pipeline_configs
            mode = cfg.get("schedule_mode", "1F1B")
            sched = SCHEDULE_MODES.get(mode, str(mode).lower())
            self._step = PipelineTrainStep(
                self._model, optimizer, self._fleet.mesh,
                num_microbatches=max(int(cfg.get("accumulate_steps", 1)), 1),
                schedule=sched,
                num_virtual_stages=int(cfg.get(
                    "vpp_degree", 2 if sched == "vpp" else 1)),
                remat=bool(strat.recompute))
            return
        stage = int(strat.sharding_configs.get("stage", 1)) \
            if strat.sharding else 0
        # Paddle hands the clip to the optimizer; the step applies a global
        # norm clip over every shard and refuses any other
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            raise ValueError(f"train_batch: the sharded step applies only "
                             f"ClipGradByGlobalNorm, not "
                             f"{type(clip).__name__}")
        self._step = ShardedTrainStep(
            self._model, None, optimizer, self._fleet.mesh,
            stage=min(max(stage, ShardingStage.NONE), ShardingStage.P_G_OS),
            clip_norm=None if clip is None else clip.clip_norm,
            remat=bool(strat.recompute))

    def train_batch(self, data, optimizer=None, scaler=None):
        """One hybrid-parallel step on ``data = (input_ids, labels)`` (the
        global batch); returns the global loss. A ``ClipGradByGlobalNorm``
        given to the optimizer clips over every shard (JAX's fleet leaves
        the optimizer's clip out); another clip, or a ``scaler``, raises:
        the step applies neither."""
        if scaler is not None:
            raise ValueError("train_batch: the sharded step takes no "
                             "GradScaler")
        if self._step is None:
            if optimizer is None:
                raise ValueError("train_batch needs the optimizer on the "
                                 "first call")
            self._build_step(optimizer)
        inputs, labels = data
        return self._step(inputs, labels)

    def __call__(self, *args, **kwargs):
        return self._model(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._model.state_dict(*a, **k)


_fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None, device=None):
    return _fleet.init(role_maker, is_collective, strategy, device)


def distributed_model(model):
    return _fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return _fleet.distributed_optimizer(optimizer, strategy)


def get_hybrid_communicate_group():
    return _fleet.get_hybrid_communicate_group()
