"""Iteration-level FCFS scheduler and the request lifecycle (the
counterpart of ``paddle_tpu/serving/scheduler.py``).

One engine iteration = admit some queued requests (prefill) + one decode
step over every active slot. Admission is strictly FCFS: when the head
request does not fit, admission stops. At most ``token_budget`` prompt
tokens are admitted per iteration, but the first admission of an
iteration is always allowed so one oversized prompt cannot livelock.
A preempted request goes back to the head of the queue
(:meth:`Scheduler.requeue_front`) and recomputes its prefix on
re-admission.

Fault isolation: a blocked head records why (``admission_rejected`` =
``"pool_full"``, ``"no_free_slot"`` or ``"pool_error"``), so a deadline
that expires while queued is attributable; cancelled and expired queued
requests are finalized here without touching the pool; a pool fault
during ``admit`` (the ``pool.bind_oom`` point) is contained as
backpressure and retried next iteration.

Telemetry: every request records timestamped lifecycle events
(``Request.trace_events``: queued, admitted or recompute, the engine's
prefill chunks and decode steps, preempt, requeue, adopt, the terminal
status), and the scheduler mirrors its counters into the metrics
registry under the engine's label. Both stop when telemetry is off; the
plain attributes the engine branches on do not.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import faults, metrics

__all__ = ["Request", "Scheduler", "TERMINAL_STATUSES"]

#: ``Request.finished`` is True exactly when ``status`` is one of these
TERMINAL_STATUSES = ("finished", "error", "cancelled", "timeout")

# every ``status`` write goes through ``Request._transition``, which checks
# the move against this graph (``scheduler.py:63-68`` of the JAX package)
_STATUS_TRANSITIONS = {
    None: ("queued",),
    "queued": ("running", "error", "cancelled", "timeout"),
    "running": ("queued", "finished", "error", "cancelled", "timeout"),
    "finished": (), "error": (), "cancelled": (), "timeout": (),
}


class Request:
    """One generation request and the caller's handle to it: ``tokens``
    grows as decode streams, ``finished`` flips when done, and
    ``on_token(req, tok, is_last)`` fires per generated token.

    ``status`` walks ``queued -> running -> finished`` (``running ->
    queued`` on preemption), with the abnormal terminals ``error``
    (quarantined: NaN sentinel, kernel or pool fault), ``cancelled``
    (:meth:`cancel`, or a drain) and ``timeout`` (``deadline_ms``
    exceeded); an abnormal end carries its reason in ``error``. An
    exception raised by ``on_token`` is recorded in ``callback_errors``
    and never stops the engine."""

    def __init__(self, rid, prompt, max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 on_token: Optional[Callable] = None,
                 deadline_ms: Optional[float] = None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.on_token = on_token
        self.tokens: List[int] = []
        self.finished = False
        self.status: Optional[str] = None
        self._transition("queued")
        self.error: Optional[str] = None
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.admission_rejected: Optional[str] = None
        self.callback_errors: List[str] = []
        self._cancel_requested = False
        self.slot: Optional[int] = None
        self.t_submit = time.perf_counter()
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.preemptions = 0            # times evicted and requeued
        self.prefill_chunks = 0         # prefill executions (>1 = chunked)
        # speculative decoding: drafted and accepted tokens of this request
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.admit_seq: Optional[int] = None   # admission order (priority)
        self._prefill_pos = 0           # tokens of _prefill_seq prefilled
        self._prefill_seq: Optional[np.ndarray] = None
        # lifecycle events for tools/trace_requests.py (telemetry only)
        self.trace_events: List[dict] = []
        self._trace("queued", prompt_len=self.prompt_len)

    def _trace(self, event: str, **attrs) -> Optional[dict]:
        """Append one timestamped lifecycle event (nothing while telemetry
        is off). Returns the event, so a site that learns an attribute's
        final value later can set it in place."""
        if not metrics.METRICS:
            return None
        e = {"event": event, "ts": time.perf_counter()}
        e.update(attrs)
        self.trace_events.append(e)
        return e

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def resume_tokens(self) -> np.ndarray:
        """What must be in the cache before decode continues: the prompt
        plus every generated token except the last (the next decode
        input)."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens[:-1], np.int32)])

    @property
    def resume_len(self) -> int:
        return self.prompt_len + max(len(self.tokens) - 1, 0)

    @property
    def remaining_new_tokens(self) -> int:
        """Budget left to generate, counting the uncommitted last token, so
        ``resume_len + remaining_new_tokens == prompt_len +
        max_new_tokens`` always."""
        if not self.tokens:
            return self.max_new_tokens
        return self.max_new_tokens - len(self.tokens) + 1

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return (self.t_first_token - self.t_submit) * 1e3

    @property
    def decode_ms_per_token(self) -> Optional[float]:
        if self.t_done is None or len(self.tokens) < 2:
            return None
        return (self.t_done - self.t_first_token) * 1e3 \
            / (len(self.tokens) - 1)

    # -- lifecycle ------------------------------------------------------------
    def cancel(self) -> None:
        """Ask for cancellation: a queued request is finalized at the next
        scheduling pass without being admitted, a running one quarantined
        at the next iteration boundary. Idempotent; a no-op once
        terminal."""
        if not self.finished:
            self._cancel_requested = True

    def deadline_exceeded(self, now: Optional[float] = None) -> bool:
        if self.deadline_ms is None:
            return False
        now = time.perf_counter() if now is None else now
        return (now - self.t_submit) * 1e3 > self.deadline_ms

    def _transition(self, status: str) -> None:
        """The one write point of ``status``: an illegal move raises."""
        prev = self.status
        if status != prev and \
                status not in _STATUS_TRANSITIONS.get(prev, ()):
            raise AssertionError(
                f"request {self.rid!r}: illegal status transition "
                f"{prev!r} -> {status!r}")
        self.status = status

    def _finalize(self, status: str, error: Optional[str] = None) -> None:
        """Terminal transition of an abnormal end (a normal one goes
        through ``_emit(is_last=True)``). Idempotent."""
        if self.finished:
            return
        assert status in TERMINAL_STATUSES, status
        self.finished = True
        self._transition(status)
        self.error = error
        self.t_done = time.perf_counter()
        self._trace(status, error=error)

    def _emit(self, tok: int, is_last: bool) -> None:
        now = time.perf_counter()
        if self.t_first_token is None:
            self.t_first_token = now
        self.tokens.append(int(tok))
        if is_last:
            self.finished = True
            self._transition("finished")
            self.t_done = now
            self._trace("finished", generated=len(self.tokens))
        if self.on_token is not None:
            try:
                # the point stands in for "the user callback raised"
                faults.fire("serving.callback_raise")
                self.on_token(self, int(tok), is_last)
            except Exception as e:  # noqa: BLE001 - user code must not stop
                # the iteration of the other slots
                self.callback_errors.append(f"{type(e).__name__}: {e}")

    def __repr__(self):
        return (f"Request(rid={self.rid!r}, prompt_len={self.prompt_len}, "
                f"max_new_tokens={self.max_new_tokens}, "
                f"generated={len(self.tokens)}, status={self.status!r})")


class Scheduler:
    """FCFS queue + iteration-level admission over a ``BlockPool``. The
    plain counters are what the engine reads; each has a registry mirror
    labelled ``metrics_labels`` (default: the pool's)."""

    def __init__(self, pool, token_budget: int,
                 metrics_labels: Optional[Dict[str, str]] = None):
        self.pool = pool
        self.token_budget = int(token_budget)
        self._queue: deque = deque()
        self._admit_seq = 0
        self.submitted = 0
        self.admitted = 0
        self.finished = 0
        self.cancelled = 0
        self.deadline_timeouts = 0
        self.admission_faults = 0
        self.backpressure_events = 0
        self.preemption_requeues = 0
        self.peak_queue_depth = 0
        self.rejected_reasons: Dict[str, int] = {}
        lbl = dict(metrics_labels or getattr(pool, "metrics_labels", None)
                   or {"engine": f"sched-{metrics.next_instance_id('sched')}"})
        self.metrics_labels = lbl
        mc = lambda name, doc: metrics.counter(  # noqa: E731
            name, doc=doc, owner=self, **lbl)
        self._m_submitted = mc("serving.submitted", "Requests submitted.")
        self._m_admitted = mc("serving.admitted",
                              "Admissions (re-admissions included).")
        self._m_finished = mc("serving.finished",
                              "Requests reaching a terminal status.")
        self._m_backpressure = mc(
            "serving.backpressure_events",
            "Head-of-line admissions blocked this iteration.")
        self._m_cancelled = mc("serving.cancelled",
                               "Requests finalized 'cancelled'.")
        self._m_deadline_timeouts = mc(
            "serving.deadline_timeouts",
            "Requests finalized 'timeout' while queued.")
        self._m_admission_faults = mc(
            "serving.admission_faults",
            "Pool faults during admit contained as backpressure.")
        self._m_preemption_requeues = mc(
            "serving.preemption_requeues",
            "Preempted requests put back at the queue head.")
        self._m_peak_queue_depth = metrics.gauge(
            "serving.peak_queue_depth",
            doc="High-water mark of the FCFS queue.", owner=self, **lbl)
        metrics.gauge("serving.queue_depth",
                      doc="Requests waiting in the FCFS queue — router "
                          "load input.",
                      callback=lambda s: len(s._queue), owner=self, **lbl)
        self._reason_counters: Dict[str, metrics.Counter] = {}

    def _note_depth(self) -> None:
        self.peak_queue_depth = max(self.peak_queue_depth, len(self._queue))
        self._m_peak_queue_depth.set_to_max(len(self._queue))

    def _blocked(self, req: Request, reason: str) -> None:
        req.admission_rejected = reason
        self.backpressure_events += 1
        self._m_backpressure.inc()
        self.rejected_reasons[reason] = \
            self.rejected_reasons.get(reason, 0) + 1
        c = self._reason_counters.get(reason)
        if c is None:
            c = self._reason_counters[reason] = metrics.counter(
                "serving.admission_rejected",
                doc="Structured admission-block reasons, per reason.",
                owner=self, reason=reason, **self.metrics_labels)
        c.inc()

    def _note_end(self, counter=None) -> None:
        """One request finalized here (``counter``: its kind's count)."""
        self.finished += 1
        self._m_finished.inc()
        if counter is not None:
            counter.inc()

    # -- queue ----------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.append(req)
        self.submitted += 1
        self._m_submitted.inc()
        self._note_depth()

    def requeue_front(self, req: Request) -> None:
        """Put a preempted request back at the head of the queue: it was
        admitted before everything queued, so FCFS order holds."""
        req.slot = None
        req._transition("queued")
        req.preemptions += 1
        req._prefill_pos = 0
        req._prefill_seq = None
        req._trace("requeue")
        self._queue.appendleft(req)
        self.preemption_requeues += 1
        self._m_preemption_requeues.inc()
        self._note_depth()

    def take_queue(self) -> List[Request]:
        """Remove and return every queued request in FCFS order, untouched
        (no finalize, no pool work): the hook that moves a lost replica's
        queue to its siblings."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def adopt(self, req: Request) -> None:
        """Append a request moved from another replica's scheduler without
        counting a fresh submission."""
        req._trace("adopt")
        self._queue.append(req)
        self._note_depth()

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def has_queued(self) -> bool:
        return bool(self._queue)

    def has_preempted_queued(self) -> bool:
        """A preempted request is in-flight work: drain re-admits it."""
        return any(r.preemptions > 0 for r in self._queue)

    def cancel_queued(self, reason: str = "cancelled by caller") -> int:
        """Finalize every never-admitted queued request as ``cancelled``;
        preemption requeues (in-flight work) stay queued. Returns the
        number cancelled."""
        n = 0
        keep: List[Request] = []
        for req in self._queue:
            if req.preemptions > 0:
                keep.append(req)
                continue
            req._finalize("cancelled", reason)
            self._note_end(self._m_cancelled)
            n += 1
        self._queue = deque(keep)
        self.cancelled += n
        return n

    # -- admission ------------------------------------------------------------
    def _reap_one(self, req: Request, now: Optional[float] = None) -> bool:
        """Finalize ``req`` if it will never be admitted: cancelled, or its
        deadline passed while it waited. A timeout names what blocks
        admission."""
        if req._cancel_requested:
            req._finalize("cancelled", "cancelled while queued")
            self.cancelled += 1
            self._note_end(self._m_cancelled)
            return True
        if req.deadline_exceeded(now):
            reason = req.admission_rejected or self.pool.blocked_reason(
                req.resume_len, req.remaining_new_tokens,
                tokens=req.resume_tokens)
            why = f" (admission blocked: {reason})" if reason else ""
            req._finalize("timeout", f"deadline {req.deadline_ms:g} ms "
                                     f"expired while queued{why}")
            self.deadline_timeouts += 1
            self._note_end(self._m_deadline_timeouts)
            return True
        return False

    def _reap_queue(self) -> None:
        """Reap cancelled and expired requests anywhere in the queue, so
        one behind a blocked head still honours its deadline."""
        now = time.perf_counter()
        self._queue = deque(r for r in self._queue
                            if not self._reap_one(r, now))

    def schedule(self, only_preempted: bool = False
                 ) -> List[Tuple[Request, int]]:
        """Admit FCFS-head requests for this iteration; returns
        ``[(request, slot), ...]``, each with its prefill starting after
        the prefix the pool's cache gave it. ``only_preempted`` (drain)
        stops at the first request that was never preempted."""
        arm = faults.fault_point("scheduler.slow_step")
        if arm is not None:
            time.sleep(float(arm.params.get("seconds", 0.02)))
        plan: List[Tuple[Request, int]] = []
        used_tokens = 0
        while self._queue:
            req = self._queue[0]
            if only_preempted and req.preemptions == 0:
                break
            if self._reap_one(req):
                self._queue.popleft()
                continue
            if plan and used_tokens + req.resume_len > self.token_budget:
                break
            resume = req.resume_tokens
            try:
                slot = self.pool.admit(req.resume_len,
                                       req.remaining_new_tokens,
                                       tokens=resume)
            except ValueError as e:
                # never fits (normally refused at submit): this request
                # ends, the rest are scheduled
                self._queue.popleft()
                req._finalize("error", str(e))
                self._note_end()
                continue
            except Exception as e:
                # a pool fault: the pool rolled itself back; the head
                # retries next iteration
                self.admission_faults += 1
                self._m_admission_faults.inc()
                self._blocked(req, "pool_error")
                req.error = f"admission fault (will retry): {e}"
                break
            if slot is None:
                self._blocked(req, self.pool.blocked_reason(
                    req.resume_len, req.remaining_new_tokens,
                    tokens=resume) or "unknown")
                break
            self._queue.popleft()
            req.slot = slot
            req._transition("running")
            req.error = None
            req.t_admit = time.perf_counter()
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            req._prefill_seq = resume
            req._prefill_pos = self.pool.cached_prefix_len(slot)
            req._trace("recompute" if req.preemptions > 0 else "admitted",
                       slot=slot, cached_prefix=req._prefill_pos)
            used_tokens += req.resume_len
            plan.append((req, slot))
            self.admitted += 1
            self._m_admitted.inc()
        self._reap_queue()
        return plan

    def note_finished(self, n: int = 1) -> None:
        self.finished += n
        self._m_finished.inc(n)

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "peak_queue_depth": self.peak_queue_depth,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "finished": self.finished,
            "backpressure_events": self.backpressure_events,
            "prefill_token_budget": self.token_budget,
            "cancelled": self.cancelled,
            "deadline_timeouts": self.deadline_timeouts,
            "admission_faults": self.admission_faults,
            "rejected_reasons": dict(self.rejected_reasons),
            "preemption_requeues": self.preemption_requeues,
        }
