"""The serving flight recorder (the counterpart of the
``FlightRecorder`` of ``paddle_tpu/core/observatory.py``).

A :class:`FlightRecorder` is a fixed-size ring of per-step records (step
ms, decode batch, prefill tokens, stalls, health extrema, cumulative fault
counts) that the serving engine appends every iteration, and the
postmortem it dumps when something abnormal happened: a quarantine, a
contained fault, a drain that leaked blocks, a replica lost. A dump puts
together the ring, the owner's labelled slice of the metrics registry and
the fault harness's fire ledger. Records carry ``time.perf_counter()``
stamps, the clock of the requests' trace events, so
``tools/trace_requests.py`` draws them as a ``serving.step`` lane beside
the request lanes.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics

__all__ = ["FlightRecorder", "SERVING_FLIGHT_RECORDER_LEN",
           "SERVING_POSTMORTEM_DIR"]

#: records a ring holds (``FLAGS_serving_flight_recorder_len``); 0 turns
#: per-step recording off, not the postmortems
SERVING_FLIGHT_RECORDER_LEN = 256
#: where postmortems are written as JSON (``FLAGS_serving_postmortem_dir``);
#: "" keeps them in memory only
SERVING_POSTMORTEM_DIR = ""


class FlightRecorder:
    """A ring of per-step records and the postmortem dump."""

    #: postmortems kept in memory per recorder (the oldest dropped)
    MAX_POSTMORTEMS = 32

    def __init__(self, maxlen: Optional[int] = None,
                 labels: Optional[Dict[str, str]] = None,
                 name: str = "engine"):
        if maxlen is None:
            maxlen = SERVING_FLIGHT_RECORDER_LEN
        self.maxlen = max(int(maxlen), 0)
        self._ring: deque = deque(maxlen=self.maxlen or 1)
        self.labels = dict(labels) if labels else {}
        self.name = name
        self.postmortems: List[Dict[str, Any]] = []
        self.dumps = 0

    def record(self, **fields: Any) -> Optional[Dict[str, Any]]:
        """Append one per-step record stamped ``ts`` (nothing when the ring
        is off)."""
        if self.maxlen <= 0:
            return None
        rec = {"ts": time.perf_counter()}
        rec.update(fields)
        self._ring.append(rec)
        return rec

    def records(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def _metrics_slice(self) -> Dict[str, Dict[str, float]]:
        """Every counter and gauge child whose label set contains the
        recorder's labels (children keyed by a reason or a point too)."""
        want = [f"{k}={v}" for k, v in self.labels.items()]
        own = metrics.label_key(**self.labels)
        snap = metrics.snapshot()
        out: Dict[str, Dict[str, float]] = {}
        for kind in ("counters", "gauges"):
            sl: Dict[str, float] = {}
            for mname, children in snap[kind].items():
                for key, val in children.items():
                    parts = key.split(",") if key else []
                    if all(w in parts for w in want):
                        sl[mname if key == own else f"{mname}{{{key}}}"] = val
            out[kind] = sl
        return out

    def dump(self, reason: str, **context: Any) -> Dict[str, Any]:
        """Build, keep and (with :data:`SERVING_POSTMORTEM_DIR` set) write
        one postmortem; returns it."""
        from . import faults

        self.dumps += 1
        doc: Dict[str, Any] = {
            "schema": 1,
            "kind": "serving_postmortem",
            "reason": reason,
            "ts": time.perf_counter(),
            "name": self.name,
            "labels": dict(self.labels),
            "context": dict(context),
            "records": self.records(),
            "metrics": self._metrics_slice(),
            "fault_ledger": dict(faults.stats()["fired"]),
        }
        self.postmortems.append(doc)
        del self.postmortems[:-self.MAX_POSTMORTEMS]
        out_dir = str(SERVING_POSTMORTEM_DIR or "")
        if out_dir:
            try:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(
                    out_dir, f"postmortem_{self.name}_{self.dumps}.json")
                with open(path, "w") as f:
                    json.dump(metrics._sanitize_json(doc), f, indent=1)
                doc["path"] = path
            except OSError as e:
                # an unwritable directory must not stop the containment
                doc["path_error"] = f"{type(e).__name__}: {e}"
        return doc
