"""Serving fleet (the counterpart of ``paddle_tpu/serving/fleet.py``): N
``ServingEngine`` replicas behind one ``submit`` / ``step`` / ``drain``
surface.

* **Routing.** Every ``submit`` builds a
  :class:`~paddle_tpu_torch.serving.router.ReplicaState` per replica from
  ``engine.health()`` and the registry's slice under its ``engine=``
  label, asks each routable replica how many leading blocks of the prompt
  its prefix cache holds (``engine.prefix_chain_hits`` over one
  :func:`~paddle_tpu_torch.serving.router.chain_keys` list), and lets the
  policy choose; the ``fleet.route_misroute`` fault point perturbs the
  choice.
* **Checked failover.** ``kill_replica`` (or the ``fleet.replica_die``
  fault point) loses a replica mid-flight: its engine dumps a
  postmortem and hands back its live requests (``evacuate``); in-flight
  ones go to siblings through ``requeue_front`` in admission order and
  recompute from ``resume_tokens``, the never-admitted queue moves FCFS
  through ``adopt``. The dead pool is never released: its device state
  died with the replica.
* **Autoscaling.** Every ``autoscale_interval`` steps an
  :class:`~paddle_tpu_torch.serving.router.AutoscalerPolicy` reads the
  same snapshots: queueing adds a replica, idleness retires one
  gracefully (routing stops, in-flight work finishes, the final
  ``drain`` checks the pool came back whole).

The replicas read one stack of fused weights, built once by the first
(``ServingEngine(share_weights_with=)``): only their page buffers are
apart. Fleet counters and gauges are labelled ``fleet=<n>`` in the
registry the engines export into, so one ``metrics.serve()`` covers the
fleet; the ``fleet`` /healthz section lists every replica's state.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

from ..core import faults, metrics
from .engine import ServingConfig, ServingEngine
from .router import (AffinityRouter, AutoscalerPolicy, LoadAwareRouter,
                     ReplicaState, RoundRobinRouter, RouterPolicy,
                     chain_keys)
from .scheduler import Request

__all__ = ["Fleet", "FleetReplica"]

_FLEETS: "weakref.WeakSet" = weakref.WeakSet()

_ROUTERS = {"affinity": AffinityRouter, "load_aware": LoadAwareRouter,
            "round_robin": RoundRobinRouter}


class FleetReplica:
    """One replica's record: the engine and the lifecycle the fleet owns.
    ``dead``: lost to ``replica_die`` (never stepped again, pool not
    reclaimed); ``retiring``: an autoscaler retire in progress;
    ``retired``: drained clean and out of the fleet."""

    __slots__ = ("index", "engine", "dead", "retiring", "retired")

    def __init__(self, index: int, engine: ServingEngine):
        self.index = index
        self.engine = engine
        self.dead = False
        self.retiring = False
        self.retired = False

    @property
    def live(self) -> bool:
        return not self.dead and not self.retired

    @property
    def state(self) -> str:
        return ("dead" if self.dead else "retired" if self.retired
                else "retiring" if self.retiring else "live")

    def has_work(self) -> bool:
        h = self.engine.health()
        return bool(h["active"] or h["prefilling"] or h["queued"])

    def inflight(self) -> int:
        h = self.engine.health()
        return h["active"] + h["prefilling"] + h["queued"]

    def __repr__(self):
        return f"FleetReplica({self.index}, {self.state})"


class Fleet:
    """N serving replicas of ``model``, one serving surface.

    ``router``: ``"affinity"`` (default), ``"load_aware"``,
    ``"round_robin"`` or a ``RouterPolicy``. ``autoscaler``: None (a fixed
    fleet), True (an ``AutoscalerPolicy`` of the default constants) or a
    policy, run every ``autoscale_interval`` fleet steps. The replicas run
    on ``device`` (default: the model's; a CUDA device without a card
    raises) and share the first one's fused weights."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 replicas: int = 1, router="affinity", autoscaler=None,
                 autoscale_interval: int = 4, device=None):
        if replicas < 1:
            raise ValueError("fleet: need at least one replica")
        self._model = model
        self._config = config
        self._device = device
        if isinstance(router, str):
            try:
                router = _ROUTERS[router]()
            except KeyError:
                raise ValueError(
                    f"fleet: unknown router {router!r} — one of "
                    f"{sorted(_ROUTERS)} or a RouterPolicy instance"
                ) from None
        if not isinstance(router, RouterPolicy):
            raise TypeError(f"fleet: router must be a RouterPolicy or a "
                            f"policy name, got {type(router).__name__}")
        self.router = router
        self.autoscaler = AutoscalerPolicy() if autoscaler is True \
            else autoscaler
        self.autoscale_interval = max(int(autoscale_interval), 1)
        self._replicas: List[FleetReplica] = []
        self._placements: Dict[str, int] = {}
        self._steps = 0
        # the plain counts; the registry mirrors them
        self.failovers = 0
        self.rerouted = 0
        self.queue_transfers = 0
        self.misroutes = 0
        self.autoscale_ups = 0
        self.autoscale_downs = 0
        self._last_scale_step: Optional[int] = None
        self.metrics_labels = lbl = {
            "fleet": str(metrics.next_instance_id("fleet"))}
        mc = lambda name, doc: metrics.counter(  # noqa: E731
            name, doc=doc, owner=self, **lbl)
        self._m_routed = mc("fleet.routed", "Requests placed by the router.")
        self._m_affinity_hits = mc(
            "fleet.affinity_hits",
            "Placements that landed on a replica holding part of the "
            "prompt's cached block chain.")
        self._m_affinity_fallbacks = mc(
            "fleet.affinity_fallbacks",
            "Placements on a replica holding none of the prompt's chain.")
        self._m_misroutes = mc(
            "fleet.misroutes",
            "Routing decisions perturbed by the fleet.route_misroute "
            "fault point (latency-only fault).")
        self._m_failovers = mc(
            "fleet.failovers",
            "Replicas lost to fleet.replica_die and failed over.")
        self._m_rerouted = mc(
            "fleet.rerouted_requests",
            "In-flight requests re-routed onto siblings via resume_tokens "
            "recompute after a replica died.")
        self._m_queue_transfers = mc(
            "fleet.queue_transfers",
            "Never-admitted requests transferred FCFS off a dead "
            "replica's queue.")
        self._m_autoscale_ups = mc("fleet.autoscale_ups",
                                   "Replicas added by the autoscaler.")
        self._m_autoscale_downs = mc(
            "fleet.autoscale_downs",
            "Replicas retired gracefully by the autoscaler.")
        # the callbacks take the fleet as their argument: the registry
        # holds it weakly
        for gname, fn, doc in (
                ("fleet.replicas",
                 lambda f: sum(r.live for r in f._replicas),
                 "Live replicas (dead/retired excluded)."),
                ("fleet.replicas_routable",
                 lambda f: sum(r.live and not r.retiring
                               for r in f._replicas),
                 "Replicas accepting new placements right now."),
                ("fleet.steps", lambda f: f._steps, "Fleet steps driven.")):
            metrics.gauge(gname, doc=doc, callback=fn, owner=self, **lbl)
        for _ in range(replicas):
            self._add_replica()
        _FLEETS.add(self)

    # -- membership -------------------------------------------------------------
    def _add_replica(self) -> FleetReplica:
        first = self._replicas[0].engine if self._replicas else None
        rep = FleetReplica(len(self._replicas), ServingEngine(
            self._model, self._config, device=self._device,
            share_weights_with=first))
        self._replicas.append(rep)
        return rep

    def _routable(self) -> List[FleetReplica]:
        return [r for r in self._replicas if r.live and not r.retiring]

    @property
    def replicas(self) -> tuple:
        """The replica records in index order (``rep.engine`` is the
        engine)."""
        return tuple(self._replicas)

    @property
    def block_size(self) -> int:
        return self._replicas[0].engine.config.block_size

    def placement(self, rid) -> Optional[int]:
        """The replica request ``rid`` was last placed on (failover
        re-routes included), or None."""
        return self._placements.get(rid)

    # -- routing ----------------------------------------------------------------
    def replica_states(self) -> List[ReplicaState]:
        """One ``ReplicaState`` per replica not retired, from ``health()``
        and the registry under each replica's label; with telemetry off the
        pool terms fall back to the pool's own counts."""
        snap = metrics.snapshot()
        gauges, counters = snap["gauges"], snap["counters"]
        hists = snap["histograms"]
        states: List[ReplicaState] = []
        for rep in self._replicas:
            if rep.retired:
                continue
            eng = rep.engine
            h = eng.health()
            lk = metrics.label_key(**eng.metrics_labels)
            g = lambda name, default: gauges.get(  # noqa: E731
                name, {}).get(lk, default)
            step = hists.get("serving.step_ms", {}).get(lk) or {}
            states.append(ReplicaState(
                index=rep.index, alive=not rep.dead,
                draining=bool(h["draining"]) or rep.retiring,
                active=int(h["active"]), prefilling=int(h["prefilling"]),
                queued=int(h["queued"]), max_batch=int(eng.config.max_batch),
                iterations=int(h["iterations"]),
                free_blocks=int(g("serving.pool.free_blocks",
                                  eng.pool.free_blocks)),
                evictable_blocks=int(g("serving.pool.evictable_blocks", 0)),
                usable_blocks=int(g("serving.pool.num_blocks",
                                    eng.pool.usable_blocks)),
                decode_stalls=int(counters.get(
                    "serving.decode_stalls", {}).get(lk, 0)),
                step_p99_ms=step.get("p99")))
        return states

    def _choose(self, tokens) -> int:
        """Route one prompt (or resume sequence): the affinity probe, then
        the policy, then the misroute point. Raises when nothing is
        routable."""
        states = self.replica_states()
        keys = chain_keys(tokens, self.block_size)
        hits: Dict[int, int] = {}
        if keys:
            for st in states:
                if st.routable:
                    hits[st.index] = self._replicas[st.index] \
                        .engine.prefix_chain_hits(keys)
        choice = self.router.choose(states, hits=hits)
        if choice is None:
            raise RuntimeError(
                "fleet: no routable replica (all dead, draining or "
                "retiring) — submit after capacity returns")
        if hits.get(choice, 0) > 0:
            self._m_affinity_hits.inc()
        else:
            self._m_affinity_fallbacks.inc()
        if faults.fault_point("fleet.route_misroute") is not None:
            alts = sorted(st.index for st in states
                          if st.routable and st.index != choice)
            if alts:
                # the next routable index after the router's pick, wrapping
                choice = next((i for i in alts if i > choice), alts[0])
                self.misroutes += 1
                self._m_misroutes.inc()
        return choice

    def submit(self, prompt, max_new_tokens: int = 32,
               **kwargs) -> Request:
        """Place and queue one request; ``ServingEngine.submit``'s contract
        (its validation errors come from the chosen replica)."""
        choice = self._choose(prompt)
        req = self._replicas[choice].engine.submit(prompt, max_new_tokens,
                                                   **kwargs)
        self._placements[req.rid] = choice
        self._m_routed.inc()
        return req

    # -- the fleet loop ---------------------------------------------------------
    def step(self) -> bool:
        """One fleet iteration: the ``replica_die`` probe (with a sibling to
        fail over to), one step of every live replica with work, then the
        autoscaler and retire ticks. Returns True while any replica has
        work."""
        self._steps += 1
        if len(self._routable()) >= 2:
            arm = faults.fault_point("fleet.replica_die")
            if arm is not None:
                victim = self._pick_victim(arm.params)
                if victim is not None:
                    self.kill_replica(
                        victim, reason="fault injection: fleet.replica_die")
        more = False
        for rep in self._replicas:
            if rep.live and rep.has_work():
                more = rep.engine.step() or more
        if self.autoscaler is not None \
                and self._steps % self.autoscale_interval == 0:
            self._autoscale_tick()
        self._retire_tick()
        return more

    def has_work(self) -> bool:
        return any(rep.live and rep.has_work() for rep in self._replicas)

    def run_until_complete(self, max_iterations: int = 1_000_000) -> None:
        while self.has_work():
            self.step()
            max_iterations -= 1
            if max_iterations <= 0:
                raise RuntimeError(
                    "fleet: run_until_complete exceeded max_iterations")

    def drain(self, cancel_queued: bool = True) -> Dict[int, dict]:
        """Drain every live replica (each drain checks its pool came back
        whole); dead replicas are skipped. Returns ``{index: stats}``."""
        out: Dict[int, dict] = {}
        for rep in self._replicas:
            if not rep.live:
                continue
            out[rep.index] = rep.engine.drain(cancel_queued=cancel_queued)
            if rep.retiring:
                rep.retiring, rep.retired = False, True
        return out

    # -- checked failover -------------------------------------------------------
    def _pick_victim(self, params: dict) -> Optional[int]:
        """The armed ``replica=`` param if that replica is routable, else
        the busiest routable replica (ties: the lowest index)."""
        routable = self._routable()
        if len(routable) < 2:
            return None
        pin = params.get("replica")
        if pin is not None:
            pin = int(pin)
            return pin if any(r.index == pin for r in routable) else None
        return max(routable, key=lambda r: (r.inflight(), -r.index)).index

    def kill_replica(self, index: int, reason: str = "replica_die") -> int:
        """Lose replica ``index`` now and fail its requests over: the
        engine dumps its postmortem and hands back its requests
        (``evacuate``), the replica stops being routable, then each request
        is routed over its ``resume_tokens`` (a sibling holding its prefix
        wins): in-flight ones ``requeue_front`` at their destination in
        admission order, the queue ``adopt``-ed FCFS. Returns the number
        of requests moved."""
        rep = self._replicas[index]
        if not rep.live:
            return 0
        if not any(r.live and r.index != index for r in self._replicas):
            raise RuntimeError(
                "fleet: cannot fail over the last live replica — "
                "its requests have nowhere to go")
        running, queued = rep.engine.evacuate(reason)
        rep.dead = True
        self.failovers += 1
        self._m_failovers.inc()
        per_dest: Dict[int, List[Request]] = {}
        for req in running:
            dest = self._choose(req.resume_tokens)
            per_dest.setdefault(dest, []).append(req)
            self._placements[req.rid] = dest
        for dest, batch in per_dest.items():
            sched = self._replicas[dest].engine.scheduler
            # appendleft in reverse keeps the admission order at the head
            for req in reversed(batch):
                sched.requeue_front(req)
        self.rerouted += len(running)
        self._m_rerouted.inc(len(running))
        for req in queued:
            dest = self._choose(req.resume_tokens)
            self._replicas[dest].engine.scheduler.adopt(req)
            self._placements[req.rid] = dest
        self.queue_transfers += len(queued)
        self._m_queue_transfers.inc(len(queued))
        return len(running) + len(queued)

    # -- autoscaling ------------------------------------------------------------
    def _autoscale_tick(self) -> None:
        since = (None if self._last_scale_step is None
                 else self._steps - self._last_scale_step)
        decision = self.autoscaler.decide(self.replica_states(), since)
        if decision == "add":
            self._add_replica()
            self.autoscale_ups += 1
            self._m_autoscale_ups.inc()
            self._last_scale_step = self._steps
        elif decision == "drain" and self._begin_retire():
            self.autoscale_downs += 1
            self._m_autoscale_downs.inc()
            self._last_scale_step = self._steps

    def _begin_retire(self) -> bool:
        """Stop routing to the emptiest routable replica (ties: the newest);
        its work finishes on normal steps and ``_retire_tick`` drains it."""
        cands = self._routable()
        if len(cands) < 2:
            return False
        min(cands, key=lambda r: (r.inflight(), -r.index)).retiring = True
        return True

    def _retire_tick(self) -> None:
        for rep in self._replicas:
            if rep.retiring and rep.live and not rep.has_work():
                rep.engine.drain()          # checks free == total
                rep.retiring, rep.retired = False, True

    # -- observability ----------------------------------------------------------
    def health(self) -> dict:
        """This fleet's entry of the ``fleet`` /healthz section."""
        return {
            "fleet": self.metrics_labels["fleet"],
            "router": self.router.name,
            "autoscaler": (repr(self.autoscaler)
                           if self.autoscaler is not None else None),
            "steps": self._steps,
            "replicas": [{"replica": rep.index,
                          "engine": rep.engine.metrics_labels["engine"],
                          "state": rep.state} for rep in self._replicas],
            "live": sum(r.live for r in self._replicas),
            "routable": len(self._routable()),
            "failovers": self.failovers,
            "rerouted": self.rerouted,
            "queue_transfers": self.queue_transfers,
            "misroutes": self.misroutes,
            "autoscale_ups": self.autoscale_ups,
            "autoscale_downs": self.autoscale_downs,
        }

    def stats(self) -> Dict[int, dict]:
        """Every replica's ``stats()``, dead and retired ones included."""
        return {rep.index: rep.engine.stats() for rep in self._replicas}

    def serve(self, port: int = 0):
        """Start the process-wide scrape surface (``/metrics`` and
        ``/healthz`` cover every replica and fleet)."""
        return metrics.serve(port)


def _health_section() -> dict:
    """The ``fleet`` section of ``metrics.health_snapshot()``."""
    return {"fleets": sorted((f.health() for f in list(_FLEETS)),
                             key=lambda f: int(f["fleet"]))}


metrics.register_health_provider("fleet", _health_section)
