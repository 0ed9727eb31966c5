"""Iteration-level FCFS scheduler (the counterpart of
``paddle_tpu/serving/scheduler.py`` without fault injection and metrics).

One engine iteration = admit some queued requests (prefill) + one decode
step over every active slot. Admission is strictly FCFS: when the head
request does not fit, admission stops. At most ``token_budget`` prompt
tokens are admitted per iteration, but the first admission of an
iteration is always allowed so one oversized prompt cannot livelock.
A preempted request goes back to the head of the queue
(:meth:`Scheduler.requeue_front`) and recomputes its prefix on
re-admission.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

__all__ = ["Request", "Scheduler"]


class Request:
    """One generation request and the caller's handle to it: ``tokens``
    grows as decode streams, ``finished`` flips when done, and
    ``on_token(req, tok, is_last)`` fires per generated token. ``status``
    walks ``queued -> running -> finished`` (``running -> queued`` on
    preemption; ``queued -> cancelled`` when a drain cancels it)."""

    def __init__(self, rid, prompt, max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 on_token: Optional[Callable] = None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.on_token = on_token
        self.tokens: List[int] = []
        self.finished = False
        self.status = "queued"
        self.slot: Optional[int] = None
        self.t_submit = time.perf_counter()
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.preemptions = 0            # times evicted and requeued
        self.prefill_chunks = 0         # prefill executions (>1 = chunked)
        self.admit_seq: Optional[int] = None   # admission order (priority)
        self._prefill_pos = 0           # tokens of _prefill_seq prefilled
        self._prefill_seq: Optional[np.ndarray] = None

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

    def _emit(self, tok: int, is_last: bool) -> None:
        now = time.perf_counter()
        if self.t_first_token is None:
            self.t_first_token = now
        self.tokens.append(int(tok))
        if is_last:
            self.finished = True
            self.status = "finished"
            self.t_done = now
        if self.on_token is not None:
            self.on_token(self, int(tok), is_last)

    def __repr__(self):
        return (f"Request(rid={self.rid!r}, prompt_len={self.prompt_len}, "
                f"max_new_tokens={self.max_new_tokens}, "
                f"generated={len(self.tokens)}, status={self.status!r})")


class Scheduler:
    """FCFS queue + iteration-level admission over a ``BlockPool``."""

    def __init__(self, pool, token_budget: int):
        self.pool = pool
        self.token_budget = int(token_budget)
        self._queue: deque = deque()
        self._admit_seq = 0
        self.submitted = 0
        self.admitted = 0
        self.finished = 0
        self.cancelled = 0
        self.backpressure_events = 0
        self.preemption_requeues = 0
        self.peak_queue_depth = 0

    def submit(self, req: Request) -> None:
        self._queue.append(req)
        self.submitted += 1
        self.peak_queue_depth = max(self.peak_queue_depth, len(self._queue))

    def requeue_front(self, req: Request) -> None:
        """Put a preempted request back at the head of the queue: it was
        admitted before everything queued, so FCFS order holds."""
        req.slot = None
        req.status = "queued"
        req.preemptions += 1
        req._prefill_pos = 0
        req._prefill_seq = None
        self._queue.appendleft(req)
        self.preemption_requeues += 1
        self.peak_queue_depth = max(self.peak_queue_depth, len(self._queue))

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def has_queued(self) -> bool:
        return bool(self._queue)

    def has_preempted_queued(self) -> bool:
        """A preempted request is in-flight work: drain re-admits it."""
        return any(r.preemptions > 0 for r in self._queue)

    def cancel_queued(self) -> int:
        """Finalize every never-admitted queued request as ``cancelled``;
        preemption requeues stay queued. Returns the number cancelled."""
        keep = deque(r for r in self._queue if r.preemptions > 0)
        n = 0
        for req in self._queue:
            if req.preemptions == 0:
                req.finished = True
                req.status = "cancelled"
                req.t_done = time.perf_counter()
                n += 1
        self._queue = keep
        self.cancelled += n
        self.finished += n
        return n

    def schedule(self, only_preempted: bool = False
                 ) -> List[Tuple[Request, int]]:
        """Admit FCFS-head requests for this iteration; returns
        ``[(request, slot), ...]``. ``only_preempted`` (drain) stops at the
        first request that was never preempted."""
        plan: List[Tuple[Request, int]] = []
        used_tokens = 0
        while self._queue:
            req = self._queue[0]
            if only_preempted and req.preemptions == 0:
                break
            if plan and used_tokens + req.resume_len > self.token_budget:
                break
            slot = self.pool.admit(req.resume_len, req.remaining_new_tokens)
            if slot is None:
                self.backpressure_events += 1
                break
            self._queue.popleft()
            req.slot = slot
            req.status = "running"
            req.t_admit = time.perf_counter()
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            req._prefill_seq = req.resume_tokens
            req._prefill_pos = 0
            used_tokens += req.resume_len
            plan.append((req, slot))
            self.admitted += 1
        return plan

    def note_finished(self, n: int = 1) -> None:
        self.finished += n

    def stats(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "peak_queue_depth": self.peak_queue_depth,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "finished": self.finished,
            "cancelled": self.cancelled,
            "backpressure_events": self.backpressure_events,
            "prefill_token_budget": self.token_budget,
            "preemption_requeues": self.preemption_requeues,
        }
