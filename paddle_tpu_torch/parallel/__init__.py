"""Model parallelism (the counterpart of ``paddle_tpu/parallel``). Ported so
far: the mixture-of-experts layer on one device (``moe.py``); the mesh,
expert-parallel all-to-alls and the other strategies wait for ROADMAP A8."""

from .moe import GShardGate, MLPExperts, MoELayer, NaiveGate, SwitchGate

__all__ = ["NaiveGate", "SwitchGate", "GShardGate", "MLPExperts", "MoELayer"]
