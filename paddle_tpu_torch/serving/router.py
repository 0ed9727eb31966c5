"""Fleet routing policies (the counterpart of
``paddle_tpu/serving/router.py``): where does the next request go?

Pure policy over :class:`ReplicaState` snapshots; this module never
touches an engine. The :class:`~paddle_tpu_torch.serving.fleet.Fleet`
builds one ``ReplicaState`` per replica from ``engine.health()`` and the
metrics registry's slice under the replica's ``engine=`` label, hands the
list to a policy and gets back the chosen replica's index.

* :class:`RoundRobinRouter`: cycle over the routable replicas;
* :class:`LoadAwareRouter`: the routable replica of the lowest
  :meth:`ReplicaState.load_score` (in-flight work per decode slot, KV pool
  pressure, the decode-stall rate, step p99 against an SLO); exact ties go
  to the lowest index;
* :class:`AffinityRouter`: the replica whose pool already holds the
  longest leading chain of the prompt's blocks (:func:`chain_keys`, the
  pool's own chained sha1 keys, asked of each replica through
  ``engine.prefix_chain_hits``), unless it carries more than ``spill``
  in-flight requests over the least loaded one; no hit at all falls back
  to load-aware placement.

:class:`AutoscalerPolicy` decides to add a replica, retire one or hold,
from the same snapshots.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["chain_keys", "ReplicaState", "RouterPolicy", "RoundRobinRouter",
           "LoadAwareRouter", "AffinityRouter", "AutoscalerPolicy",
           "FLEET_SLO_STEP_MS", "FLEET_AFFINITY_SPILL", "FLEET_SCALE_UP_QUEUE",
           "FLEET_SCALE_DOWN_UTIL", "FLEET_MIN_REPLICAS",
           "FLEET_MAX_REPLICAS", "FLEET_AUTOSCALE_COOLDOWN"]

# The JAX package reads these from its FLAGS_fleet_* registry
# (``paddle_tpu/core/flags.py:368-399``); the port fixes the defaults.
FLEET_SLO_STEP_MS = 1000.0       # step p99 past this costs load score
FLEET_AFFINITY_SPILL = 4         # extra in-flight a chain holder may carry
FLEET_SCALE_UP_QUEUE = 4.0       # mean queue depth that adds a replica
FLEET_SCALE_DOWN_UTIL = 0.25     # decode-slot utilization that retires one
FLEET_MIN_REPLICAS = 1
FLEET_MAX_REPLICAS = 8
FLEET_AUTOSCALE_COOLDOWN = 8     # fleet steps between two actions


def chain_keys(tokens, block_size: int,
               n_blocks: Optional[int] = None) -> List[str]:
    """Chained sha1 keys of the leading full blocks of ``tokens``, the
    router's twin of ``BlockPool._chain_keys`` (same salt, same chaining).
    ``n_blocks`` defaults to ``(len - 1) // block_size``, the most the
    pool could match for this prompt (it always leaves one token to
    prefill)."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    bs = int(block_size)
    if n_blocks is None:
        n_blocks = (len(tokens) - 1) // bs if len(tokens) else 0
    keys: List[str] = []
    h = hashlib.sha1(f"bs={bs}".encode())
    for i in range(n_blocks):
        h = h.copy()
        h.update(np.ascontiguousarray(
            tokens[i * bs:(i + 1) * bs], dtype=np.int32).tobytes())
        keys.append(h.hexdigest())
    return keys


@dataclass
class ReplicaState:
    """What one routing or autoscaling decision reads of a replica.
    ``alive=False`` marks a replica lost to ``fleet.replica_die``;
    ``draining`` covers an engine drain and an autoscaler retire."""

    index: int                      # position in the fleet's replica list
    alive: bool = True
    draining: bool = False
    active: int = 0                 # decode batch occupancy (health())
    prefilling: int = 0             # mid-(chunked-)prefill (health())
    queued: int = 0                 # FCFS queue depth (health())
    max_batch: int = 1              # decode slots (capacity normalizer)
    iterations: int = 0             # engine iterations (stall-rate norm)
    free_blocks: int = 0            # serving.pool.free_blocks gauge
    evictable_blocks: int = 0       # serving.pool.evictable_blocks gauge
    usable_blocks: int = 1          # serving.pool.num_blocks gauge
    decode_stalls: int = 0          # serving.decode_stalls counter
    step_p99_ms: Optional[float] = None  # serving.step_ms histogram p99

    @property
    def routable(self) -> bool:
        """May this replica take new placements? (Dead and draining ones
        finish their in-flight work only.)"""
        return self.alive and not self.draining

    @property
    def inflight(self) -> int:
        return self.active + self.prefilling + self.queued

    @property
    def block_pressure(self) -> float:
        """1 - the reclaimable share of the pool (evictable cached blocks
        count as reclaimable)."""
        usable = max(self.usable_blocks, 1)
        return 1.0 - min(self.free_blocks, usable) / usable

    def load_score(self, slo_step_ms: float = FLEET_SLO_STEP_MS) -> float:
        """One comparable load number, smaller is better: in-flight work
        per decode slot, plus pool pressure, plus the lifetime stall rate,
        plus 0.1 x step p99 / SLO (capped at 10 SLOs; no term when
        ``slo_step_ms`` is 0)."""
        score = self.inflight / max(self.max_batch, 1)
        score += self.block_pressure
        score += self.decode_stalls / max(self.iterations, 1)
        if self.step_p99_ms is not None and slo_step_ms > 0:
            score += 0.1 * min(self.step_p99_ms / slo_step_ms, 10.0)
        return score


def _routable(states: Sequence[ReplicaState]) -> List[ReplicaState]:
    return [s for s in states if s.routable]


class RouterPolicy:
    """``choose`` returns the index of the replica the next request goes
    to, or None when no replica is routable."""

    name = "base"

    def choose(self, states: Sequence[ReplicaState],
               hits: Optional[Dict[int, int]] = None) -> Optional[int]:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class RoundRobinRouter(RouterPolicy):
    """Cycle over the routable replicas in index order."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, states, hits=None):
        cands = sorted(_routable(states), key=lambda s: s.index)
        if not cands:
            return None
        pick = cands[self._next % len(cands)]
        self._next += 1
        return pick.index


class LoadAwareRouter(RouterPolicy):
    """The least loaded routable replica; ties go to the lowest index."""

    name = "load_aware"

    def __init__(self, slo_step_ms: Optional[float] = None):
        self.slo_step_ms = float(FLEET_SLO_STEP_MS if slo_step_ms is None
                                 else slo_step_ms)

    def choose(self, states, hits=None):
        cands = _routable(states)
        if not cands:
            return None
        return min(cands, key=lambda s: (s.load_score(self.slo_step_ms),
                                         s.index)).index


class AffinityRouter(LoadAwareRouter):
    """Prefix affinity first, load-aware otherwise. ``hits`` maps a replica
    index to the leading cached chain blocks of the prompt being placed.
    The longest chain wins (ties: lower load, then lower index) unless it
    carries more than ``spill`` in-flight requests over the least loaded
    routable replica."""

    name = "affinity"

    def __init__(self, slo_step_ms: Optional[float] = None,
                 spill: Optional[int] = None):
        super().__init__(slo_step_ms)
        self.spill = int(FLEET_AFFINITY_SPILL if spill is None else spill)

    def choose(self, states, hits=None):
        cands = _routable(states)
        if not cands:
            return None
        with_hits = [s for s in cands if (hits or {}).get(s.index, 0) > 0]
        if with_hits:
            best = min(with_hits, key=lambda s: (
                -hits[s.index], s.load_score(self.slo_step_ms), s.index))
            if best.inflight - min(s.inflight for s in cands) <= self.spill:
                return best.index
        return super().choose(states, hits)


class AutoscalerPolicy:
    """Add / drain decisions from replica snapshots, stateless per call:
    ``decide(states, steps_since_action)`` is ``"add"`` when the mean
    queue depth a routable replica exceeds ``scale_up_queue`` (below
    ``max_replicas``), ``"drain"`` (retire one gracefully) when every queue
    is empty and decode-slot utilization is under ``scale_down_util``
    (above ``min_replicas``), else ``"hold"``; within ``cooldown`` steps
    of the last action it holds."""

    def __init__(self, scale_up_queue: Optional[float] = None,
                 scale_down_util: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown: Optional[int] = None):
        rd = lambda v, d: d if v is None else v  # noqa: E731
        self.scale_up_queue = float(rd(scale_up_queue, FLEET_SCALE_UP_QUEUE))
        self.scale_down_util = float(rd(scale_down_util,
                                        FLEET_SCALE_DOWN_UTIL))
        self.min_replicas = int(rd(min_replicas, FLEET_MIN_REPLICAS))
        self.max_replicas = int(rd(max_replicas, FLEET_MAX_REPLICAS))
        self.cooldown = int(rd(cooldown, FLEET_AUTOSCALE_COOLDOWN))

    def decide(self, states: Sequence[ReplicaState],
               steps_since_action: Optional[int] = None) -> str:
        if steps_since_action is not None \
                and steps_since_action < self.cooldown:
            return "hold"
        cands = _routable(states)
        n = len(cands)
        if n == 0:
            return "add" if self.max_replicas > 0 else "hold"
        mean_queue = sum(s.queued for s in cands) / n
        if mean_queue > self.scale_up_queue and n < self.max_replicas:
            return "add"
        util = (sum(s.active + s.prefilling for s in cands)
                / max(sum(s.max_batch for s in cands), 1))
        if (n > self.min_replicas and mean_queue == 0
                and util < self.scale_down_util):
            return "drain"
        return "hold"

    def __repr__(self):
        return (f"AutoscalerPolicy(up_queue={self.scale_up_queue:g}, "
                f"down_util={self.scale_down_util:g}, "
                f"replicas=[{self.min_replicas}, {self.max_replicas}], "
                f"cooldown={self.cooldown})")
