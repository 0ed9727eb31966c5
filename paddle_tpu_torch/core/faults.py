"""Deterministic fault injection (the counterpart of
``paddle_tpu/core/faults.py``).

A process-wide registry of named **fault points** sits in the serving hot
paths (engine, block pool, scheduler). Each is armed on a deterministic
schedule, so a chaos run is exactly reproducible: the Nth hit of a site
fires, not "2% of calls".

Arming, two equivalent spellings:

* the module-level schedule string :data:`FAULT_INJECT` (the JAX package
  reads the same grammar from ``FLAGS_fault_inject``)::

      faults.FAULT_INJECT = "decode_nan@3,pool_oom:every=5"

  ``name@N`` fires exactly on the Nth hit of the site; ``:every=K`` fires
  every Kth hit; ``:times=M`` caps the total fires; a bare name fires on
  every hit. Other ``key=val`` pairs become float (else str) params the
  site can read. Names resolve against the registry by full name
  (``serving.decode_nan``), alias (``decode_nan``) or the leaf after the
  last dot.

* the :func:`inject` context manager (tests)::

      with faults.inject("pool.bind_oom", at=2):
          ...

Site protocol: ``fault_point(name)`` returns the firing :class:`Arm` (or
None) and counts one hit per call while the point is armed;
``fire(name)`` raises :class:`FaultInjected` when it fires. Disarmed, a
probe is a string compare and two emptiness checks. Every fire is also
counted in the metrics registry's ``faults.injected`` counter, one child
per point.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from . import metrics

__all__ = ["FAULT_INJECT", "FaultInjected", "register_fault_point",
           "fault_points", "fault_point", "fire", "inject", "inject_spec",
           "parse_spec", "stats", "total_fired", "reset_stats"]

#: the schedule string (``FLAGS_fault_inject``'s grammar); "" = disarmed
FAULT_INJECT = ""


class FaultInjected(RuntimeError):
    """Raised by an armed :func:`fire` site; ``point`` names the fault
    point, so a test can tell an injected fault from an organic one."""

    def __init__(self, point: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault at {point!r}")
        self.point = point


class _PointDef:
    __slots__ = ("name", "alias", "doc")

    def __init__(self, name: str, alias: Optional[str], doc: str):
        self.name = name
        self.alias = alias
        self.doc = doc


class Arm:
    """One armed fault point: its schedule and its hit counter. Re-arming
    (a new schedule string, a fresh ``inject`` block) restarts at hit 0."""

    __slots__ = ("point", "at", "every", "times", "params", "hits", "fires")

    def __init__(self, point: str, at: Optional[int] = None,
                 every: Optional[int] = None, times: Optional[int] = None,
                 params: Optional[Dict[str, Any]] = None):
        if at is not None and at < 1:
            raise ValueError(f"fault arm {point!r}: at must be >= 1")
        if every is not None and every < 1:
            raise ValueError(f"fault arm {point!r}: every must be >= 1")
        if at is not None and every is not None:
            raise ValueError(
                f"fault arm {point!r}: 'at' and 'every' are mutually "
                f"exclusive schedules — '@N' fires exactly on hit N, "
                f"'every=K' fires periodically; pick one (add 'times=' "
                f"to cap a periodic arm)")
        self.point = point
        self.at = at
        self.every = every
        self.times = times
        self.params = params or {}
        self.hits = 0
        self.fires = 0

    def _should_fire(self) -> bool:
        self.hits += 1
        if self.times is not None and self.fires >= self.times:
            return False
        if self.at is not None:
            hit = self.hits == self.at
        elif self.every is not None:
            hit = self.hits % self.every == 0
        else:
            hit = True
        if hit:
            self.fires += 1
        return hit

    def __repr__(self):
        sched = (f"@{self.at}" if self.at is not None else
                 f":every={self.every}" if self.every is not None else
                 ":always")
        return (f"Arm({self.point}{sched}, hits={self.hits}, "
                f"fires={self.fires})")


_POINTS: Dict[str, _PointDef] = {}
_ALIASES: Dict[str, str] = {}
_LOCK = threading.Lock()
# arms of FAULT_INJECT: (the string last parsed, arms by full name)
_spec_src: str = ""
_spec_arms: Dict[str, Arm] = {}
# inject() arms, shadowing FAULT_INJECT's for the same point
_ctx_arms: Dict[str, List[Arm]] = {}
# lifetime fires per point (survive disarming; reset_stats clears them)
_fired: Dict[str, int] = {}


def register_fault_point(name: str, alias: Optional[str] = None,
                         doc: str = "") -> None:
    """Declare a named fault point. Registering it again with the same
    alias is a no-op; a conflicting alias raises."""
    with _LOCK:
        existing = _POINTS.get(name)
        if existing is not None:
            if existing.alias == alias:
                return
            raise ValueError(f"fault point {name!r} already registered "
                             f"with alias {existing.alias!r}")
        if alias is not None and alias in _ALIASES:
            raise ValueError(f"fault alias {alias!r} already maps to "
                             f"{_ALIASES[alias]!r}")
        _POINTS[name] = _PointDef(name, alias, doc)
        if alias is not None:
            _ALIASES[alias] = name


def fault_points() -> Dict[str, str]:
    """``{full name: doc}`` of every registered fault point."""
    return {n: p.doc for n, p in sorted(_POINTS.items())}


def _resolve(name: str) -> str:
    if name in _POINTS:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    leaf_matches = [n for n in _POINTS if n.rsplit(".", 1)[-1] == name]
    if len(leaf_matches) == 1:
        return leaf_matches[0]
    known = sorted(set(_POINTS) | set(_ALIASES))
    raise KeyError(f"unknown fault point {name!r}"
                   + (f" (ambiguous leaf: {sorted(leaf_matches)})"
                      if leaf_matches else "")
                   + f" — known points/aliases: {known}")


def parse_spec(spec: str) -> Dict[str, Arm]:
    """Parse a schedule string into arms keyed by full point name. Each
    comma-separated entry is ``name[@N][:key=val]*``; the keys ``at``,
    ``every`` and ``times`` are ints, any other key a float-or-str
    param."""
    arms: Dict[str, Arm] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        head, opts = parts[0].strip(), parts[1:]
        at = every = times = None
        params: Dict[str, Any] = {}
        if "@" in head:
            head, at_s = head.split("@", 1)
            try:
                at = int(at_s)
            except ValueError:
                raise ValueError(
                    f"fault_inject entry {entry!r}: '@' must be followed "
                    f"by an integer hit index, got {at_s!r}") from None
        name = _resolve(head.strip())
        for opt in opts:
            if "=" not in opt:
                raise ValueError(
                    f"fault_inject entry {entry!r}: option {opt!r} is not "
                    f"key=val")
            k, v = (s.strip() for s in opt.split("=", 1))
            if k == "at":
                at = int(v)
            elif k == "every":
                every = int(v)
            elif k == "times":
                times = int(v)
            else:
                try:
                    params[k] = float(v)
                except ValueError:
                    params[k] = v
        if name in arms:
            raise ValueError(f"fault_inject names {name!r} twice — one "
                             f"schedule per point")
        arms[name] = Arm(name, at=at, every=every, times=times,
                         params=params)
    return arms


def _sync_spec_arms() -> None:
    global _spec_src, _spec_arms
    src = FAULT_INJECT
    if src == _spec_src:
        return
    with _LOCK:
        if src == _spec_src:
            return
        _spec_arms = parse_spec(src) if src else {}
        _spec_src = src


def fault_point(name: str) -> Optional[Arm]:
    """The firing :class:`Arm` when ``name`` is armed and its schedule
    fires on this hit, else None. Every call while armed counts a hit."""
    _sync_spec_arms()
    if not _spec_arms and not _ctx_arms:
        return None
    full = _resolve(name)
    stack = _ctx_arms.get(full)
    arm = stack[-1] if stack else _spec_arms.get(full)
    if arm is None or not arm._should_fire():
        return None
    _fired[full] = _fired.get(full, 0) + 1
    # the registry's mirror of the harness's own count
    metrics.counter("faults.injected",
                    doc="Fault-point fires (core/faults.py), per point.",
                    point=full).inc()
    return arm


def fire(name: str) -> None:
    """Raise :class:`FaultInjected` when ``name`` is armed and fires."""
    arm = fault_point(name)
    if arm is not None:
        raise FaultInjected(arm.point,
                            f"injected fault at {arm.point!r} "
                            f"(hit {arm.hits})")


def _push(arms: Dict[str, Arm]) -> None:
    for full, arm in arms.items():
        _ctx_arms.setdefault(full, []).append(arm)


def _pop(arms: Dict[str, Arm]) -> None:
    for full, arm in arms.items():
        stack = _ctx_arms.get(full)
        if stack:
            stack.remove(arm)
            if not stack:
                del _ctx_arms[full]


@contextmanager
def inject(name: str, at: Optional[int] = None, every: Optional[int] = None,
           times: Optional[int] = None, **params: Any) -> Iterator[Arm]:
    """Arm one fault point for the block. A nested arm of the same point
    shadows the outer one; an ``inject`` arm shadows :data:`FAULT_INJECT`
    for its point."""
    full = _resolve(name)
    arms = {full: Arm(full, at=at, every=every, times=times, params=params)}
    _push(arms)
    try:
        yield arms[full]
    finally:
        _pop(arms)


@contextmanager
def inject_spec(spec: str) -> Iterator[Dict[str, Arm]]:
    """Arm a whole schedule string for the block."""
    arms = parse_spec(spec)
    _push(arms)
    try:
        yield arms
    finally:
        _pop(arms)


def stats() -> Dict[str, Any]:
    """Lifetime fires per point and the schedules armed now, freshly
    built on every call."""
    _sync_spec_arms()
    armed = {full: repr(arm) for full, arm in _spec_arms.items()}
    armed.update({full: repr(stack[-1]) for full, stack in _ctx_arms.items()})
    return {"fired": dict(_fired), "total_fired": sum(_fired.values()),
            "armed": armed}


def total_fired() -> int:
    """Lifetime fires over every point."""
    return sum(_fired.values())


def reset_stats() -> None:
    """Zero the lifetime fire counts (and their registry mirror) and parse
    :data:`FAULT_INJECT` anew at the next probe. Registration and
    ``inject`` blocks stay."""
    global _spec_src, _spec_arms
    _fired.clear()
    for child in metrics.get_registry().children("faults.injected").values():
        child.reset()
    with _LOCK:
        _spec_src = ""
        _spec_arms = {}


# The catalogue of the JAX package's ``paddle_tpu/core/faults.py:355-470``:
# the serving engine's, the block pool's, the scheduler's and the fleet's.
register_fault_point(
    "serving.decode_nan", alias="decode_nan",
    doc="Poison one active slot's decode-health value to NaN after the "
        "decode step (serving/engine.py): only that request is "
        "quarantined (status='error', blocks reclaimed); every other slot "
        "keeps decoding.")
register_fault_point(
    "serving.prefill_nan", alias="prefill_nan",
    doc="Poison a request's prefill-health value to NaN (serving/"
        "engine.py): the request is quarantined at admission instead of "
        "entering the decode batch.")
register_fault_point(
    "pool.bind_oom", alias="pool_oom",
    doc="Raise inside BlockPool._bind_block before any mutation "
        "(serving/block_pool.py). Admission rolls back to the pre-admit "
        "state (backpressure, retried next iteration); a bind failure "
        "mid-decode quarantines only that request.")
register_fault_point(
    "pool.evict_fail", alias="evict_fail",
    doc="Raise inside BlockPool._take_block just before a refcount-0 "
        "cached prefix block would be evicted (serving/block_pool.py). "
        "During admission the pool rolls back and the scheduler retries; "
        "during decode growth only the growing request is quarantined. "
        "The cache index never points at a reused block.")
register_fault_point(
    "serving.chunk_prefill_nan", alias="chunk_prefill_nan",
    doc="Poison the health value of a chunked-prefill step past the first "
        "chunk (serving/engine.py): the request is quarantined (its bound "
        "and shared-prefix blocks released) before it enters the decode "
        "batch.")
register_fault_point(
    "serving.kv_quant_nan", alias="kv_quant_nan",
    doc="Poison one active slot's decode-health value on an int8 KV pool "
        "(serving/engine.py), as a corrupted block scale would: only that "
        "slot is quarantined, its int8 blocks and scales reclaimed. The "
        "probe runs on quantized pools only.")
register_fault_point(
    "serving.verify_nan", alias="verify_nan",
    doc="Poison one active slot's verify-health value to NaN after a "
        "speculative draft/verify iteration (serving/engine.py): only that "
        "request is quarantined; every other slot commits its accepted "
        "span. The probe runs on speculative engines only.")
register_fault_point(
    "serving.draft_divergence", alias="draft_divergence",
    doc="Scramble every drafted token before verification (serving/"
        "engine.py), as a diverged drafter would: the verifier rejects "
        "them and commits its own token, so the streams stay equal to "
        "plain greedy decoding and only the acceptance falls. The probe "
        "runs on speculative engines only.")
register_fault_point(
    "serving.callback_raise", alias="callback_raise",
    doc="Raise in place of a user on_token callback (serving/scheduler.py "
        "Request._emit): the exception is recorded on "
        "request.callback_errors and the iteration goes on for every "
        "slot.")
register_fault_point(
    "fleet.replica_die", alias="replica_die",
    doc="Kill one live replica at the top of Fleet.step() (serving/"
        "fleet.py): the dead engine dumps a flight-recorder postmortem and "
        "hands back its requests (evacuate); in-flight requests go to "
        "siblings through requeue_front in admission order and recompute "
        "from resume_tokens, the never-admitted queue moves FCFS. The dead "
        "pool is never released. Param replica= pins the victim (default: "
        "the busiest live replica); the probe fires only with a sibling to "
        "fail over to.")
register_fault_point(
    "fleet.route_misroute", alias="route_misroute",
    doc="Perturb one routing decision (serving/fleet.py): the router's "
        "choice is swapped for the next routable replica, as a stale gauge "
        "would. Placement is an optimisation only: statuses, tokens and a "
        "clean drain hold unchanged.")
register_fault_point(
    "scheduler.slow_step", alias="slow_step",
    doc="Sleep at the head of Scheduler.schedule() (param seconds=, "
        "default 0.02), a stalled iteration, so request deadlines "
        "observably expire and are attributed.")
