"""Per-request serving lifecycle traces as Chrome-trace JSON (the library
half of the JAX package's ``tools/trace_requests.py``).

Every :class:`~paddle_tpu_torch.serving.scheduler.Request` records
timestamped lifecycle events (queued, admitted, prefill chunks, decode
steps, preempt / requeue / recompute, replica_die / adopt, quarantine or
the terminal status) while telemetry is on. :func:`export_chrome_trace`
writes them for ``chrome://tracing`` or Perfetto with one lane (tid) per
request, each event a slice lasting until the request's next event and
the last an instant marker, and, given an engine's flight-recorder
records, one ``serving.step`` lane of the engine's iterations. Timestamps
are ``time.perf_counter()`` microseconds::

    from paddle_tpu_torch.tools.trace_requests import export_chrome_trace
    export_chrome_trace(requests, "requests.json",
                        step_records=engine.flight_recorder.records())
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

__all__ = ["request_trace_events", "step_lane_events", "export_chrome_trace"]


def request_trace_events(req, tid: int,
                         pid: Optional[int] = None) -> List[Dict]:
    """The Chrome-trace events of one request's lane: a ``thread_name``
    label, a duration slice (``ph: "X"``) per recorded event ending at the
    next one, and the last event as an instant (``ph: "i"``)."""
    pid = os.getpid() if pid is None else pid
    events = req.trace_events
    out: List[Dict] = [{
        "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
        "args": {"name": f"request {req.rid} [{req.status}]"}}]
    for i, e in enumerate(events):
        ts_us = e["ts"] * 1e6
        args = {k: v for k, v in e.items() if k not in ("event", "ts")}
        args["rid"] = req.rid
        if i + 1 < len(events):
            dur = events[i + 1]["ts"] * 1e6 - ts_us
            out.append({"name": e["event"], "ph": "X", "ts": ts_us,
                        "dur": max(dur, 0.01), "pid": pid, "tid": tid,
                        "args": args})
        else:
            out.append({"name": e["event"], "ph": "i", "ts": ts_us,
                        "s": "t", "pid": pid, "tid": tid, "args": args})
    return out


def step_lane_events(records: Sequence[Dict], tid: int,
                     pid: Optional[int] = None) -> List[Dict]:
    """One ``serving.step`` lane of flight-recorder records: each record
    (its ``ts`` the end of the step, ``step_ms`` its length) a slice with
    the record's fields as args."""
    pid = os.getpid() if pid is None else pid
    if not records:
        return []
    out: List[Dict] = [{"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": "serving.step"}}]
    for rec in records:
        end_us = rec["ts"] * 1e6
        dur_us = max(float(rec.get("step_ms", 0.0)) * 1e3, 0.01)
        args = {k: v for k, v in rec.items() if k != "ts"}
        out.append({"name": "serving.step", "ph": "X",
                    "ts": end_us - dur_us, "dur": dur_us,
                    "pid": pid, "tid": tid, "args": args})
    return out


def export_chrome_trace(requests: Sequence, path: str,
                        merge: Sequence[str] = (),
                        step_records: Sequence[Dict] = ()) -> Dict:
    """Write one Chrome-trace JSON file: the ``traceEvents`` of every
    ``merge`` file, one lane per request (tids from 1), then, with
    ``step_records``, the ``serving.step`` lane. Returns the trace."""
    events: List[Dict] = []
    for mpath in merge:
        with open(mpath) as f:
            merged = json.load(f)
        events.extend(merged.get("traceEvents", merged)
                      if isinstance(merged, dict) else merged)
    tid = 0
    for tid, req in enumerate(requests, start=1):
        events.extend(request_trace_events(req, tid))
    if step_records:
        events.extend(step_lane_events(step_records, tid + 1))
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "metadata": {"tool": "paddle_tpu_torch.tools.trace_requests"}}
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
    return trace
