"""Continuous-batching serving runtime: the KV block pool with its
shared-prefix cache (:mod:`.block_pool`), FCFS iteration-level admission
and the request lifecycle with its trace events (:mod:`.scheduler`), the
engine loop with chunked prefill, preemption, speculative decoding, fault
containment, registry telemetry and the flight recorder
(:mod:`.engine`), and N replicas behind one surface (:mod:`.fleet`):
prefix-affinity and load-aware placement (:mod:`.router`), checked
failover from ``resume_tokens``, autoscaling."""

from .block_pool import BlockPool, BlockPoolExhausted
from .engine import ServingConfig, ServingEngine
from .fleet import Fleet, FleetReplica
from .router import (AffinityRouter, AutoscalerPolicy, LoadAwareRouter,
                     ReplicaState, RoundRobinRouter, RouterPolicy)
from .scheduler import Request, Scheduler

__all__ = ["AffinityRouter", "AutoscalerPolicy", "BlockPool",
           "BlockPoolExhausted", "Fleet", "FleetReplica", "LoadAwareRouter",
           "ReplicaState", "Request", "RoundRobinRouter", "RouterPolicy",
           "Scheduler", "ServingConfig", "ServingEngine"]
