"""Model and data parallelism (the counterpart of ``paddle_tpu/parallel``).

The JAX package runs one SPMD program over a device mesh and lets GSPMD
place the collectives; the port runs one process a rank over
``torch.distributed`` (NCCL on the card, gloo with ``device="cpu"``) with
explicit collectives over one process group a mesh axis, and the kernels
receive plain local tensors:

* ``env`` / ``topology``: the process group and the ``HybridMesh`` (pp,
  dp, fsdp, sep, tp; ep waits for the expert-parallel slice);
* ``collective``: Paddle's collectives with ``group=`` a mesh axis;
* ``api``: ``ProcessMesh`` and the Shard / Replicate / Partial placements
  on DTensor (the user-facing placements only);
* ``mp_ops`` / ``mp_layers``: Megatron's tensor-parallel ops and layers;
* ``data_parallel``: ``DataParallel`` with bucketed gradient all-reduces;
* ``sharding``: ``ShardedTrainStep`` (ZeRO 1-3, tp, sep, dp);
* ``sequence_parallel``: ring and Ulysses attention on the flash kernels;
* ``checkpoint``: sharded save and resharding load in JAX's format;
* ``fleet``: the strategy facade;
* ``moe``: the mixture-of-experts layer (one device);
* ``pp_layers`` / ``pipeline`` / ``zero_bubble``: pipeline segmentation,
  ``pipeline_apply`` and ``PipelineTrainStep`` (1F1B, F-then-B, VPP, zero
  bubble), one stage a process or every stage in one;
* ``offload``: ``AsyncLoader`` and ``OffloadedTrainStep`` (optimizer state
  on the host);
* ``activation_sharding`` / ``shard_map``: layout constraints on DTensors
  and a function run on each rank's shards.
"""

from . import checkpoint, env, fleet, mp_ops, sequence_parallel
from .api import (Partial, Placement, ProcessMesh, Replicate, Shard,
                  dtensor_from_local, placements_of, reshard, shard_layer,
                  shard_optimizer, shard_tensor)
from .checkpoint import load_state_dict, save_state_dict
from .collective import (Group, ReduceOp, all_gather, all_gather_object,
                         all_reduce, all_to_all, barrier, broadcast,
                         new_group, reduce, reduce_scatter, scatter)
from .data_parallel import DataParallel
from .env import (ParallelEnv, get_mesh, get_rank, get_world_size,
                  init_parallel_env, set_mesh)
from .fleet import DistributedStrategy
from .moe import GShardGate, MLPExperts, MoELayer, NaiveGate, SwitchGate
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding,
                        get_rng_state_tracker)
from .sequence_parallel import (ColumnSequenceParallelLinear,
                                RowSequenceParallelLinear, gather_sequence,
                                ring_attention, sep_attention,
                                split_sequence, ulysses_attention)
from .sharding import (ShardedTrainStep, ShardingStage,
                       llama_sharding_rules, spec_for)
from .topology import HybridMesh
from .activation_sharding import (activation_sharding, constrain,
                                  current_activation_specs)
from .offload import AsyncLoader, OffloadedTrainStep
from .pipeline import PipelineTrainStep, pipeline_apply, stack_layer_params
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .shard_map import shard_map
from .zero_bubble import pipeline_apply_zb

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "get_mesh",
    "set_mesh", "ParallelEnv", "HybridMesh",
    "ReduceOp", "Group", "new_group", "all_reduce", "all_gather",
    "all_gather_object", "reduce_scatter", "all_to_all", "broadcast",
    "reduce", "scatter", "barrier",
    "ProcessMesh", "Shard", "Replicate", "Partial", "Placement",
    "shard_tensor", "reshard", "dtensor_from_local", "shard_layer",
    "shard_optimizer", "placements_of",
    "mp_ops", "ColumnParallelLinear", "RowParallelLinear",
    "VocabParallelEmbedding", "ParallelCrossEntropy",
    "get_rng_state_tracker", "DataParallel",
    "ShardedTrainStep", "ShardingStage", "llama_sharding_rules", "spec_for",
    "sequence_parallel", "ring_attention", "ulysses_attention",
    "sep_attention", "ColumnSequenceParallelLinear",
    "RowSequenceParallelLinear", "split_sequence", "gather_sequence",
    "checkpoint", "save_state_dict", "load_state_dict",
    "fleet", "DistributedStrategy", "env",
    "NaiveGate", "SwitchGate", "GShardGate", "MLPExperts", "MoELayer",
    "LayerDesc", "SharedLayerDesc", "PipelineLayer", "PipelineTrainStep",
    "pipeline_apply", "pipeline_apply_zb", "stack_layer_params",
    "AsyncLoader", "OffloadedTrainStep", "shard_map",
    "activation_sharding", "constrain", "current_activation_specs",
]
