"""Continuous-batching serving runtime: the KV block pool with its
shared-prefix cache (:mod:`.block_pool`), FCFS iteration-level admission
and the request lifecycle (:mod:`.scheduler`), and the engine loop with
chunked prefill, preemption, speculative decoding and fault containment
(:mod:`.engine`)."""

from .block_pool import BlockPool, BlockPoolExhausted
from .engine import ServingConfig, ServingEngine
from .scheduler import Request, Scheduler

__all__ = ["BlockPool", "BlockPoolExhausted", "Request", "Scheduler",
           "ServingConfig", "ServingEngine"]
