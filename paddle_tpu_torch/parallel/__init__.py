"""Model and data parallelism (the counterpart of ``paddle_tpu/parallel``).

The JAX package runs one SPMD program over a device mesh and lets GSPMD
place the collectives; the port runs one process a rank over
``torch.distributed`` (NCCL on the card, gloo with ``device="cpu"``) with
explicit collectives over one process group a mesh axis, and the kernels
receive plain local tensors:

* ``env`` / ``topology``: the process group and the ``HybridMesh`` (dp,
  fsdp, tp, sep; pp and ep wait for the second part of ROADMAP A8);
* ``collective``: Paddle's collectives with ``group=`` a mesh axis;
* ``api``: ``ProcessMesh`` and the Shard / Replicate / Partial placements
  on DTensor (the user-facing placements only);
* ``mp_ops`` / ``mp_layers``: Megatron's tensor-parallel ops and layers;
* ``data_parallel``: ``DataParallel`` with bucketed gradient all-reduces;
* ``sharding``: ``ShardedTrainStep`` (ZeRO 1-3, tp, sep, dp);
* ``sequence_parallel``: ring and Ulysses attention on the flash kernels;
* ``checkpoint``: sharded save and resharding load in JAX's format;
* ``fleet``: the strategy facade;
* ``moe``: the mixture-of-experts layer (one device).
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
]
