"""Process-wide metrics registry (the counterpart of
``paddle_tpu/core/metrics.py``).

Three typed instruments, each optionally labelled (one *family* per name,
one *child* per label set):

* :class:`Counter`: a monotonically increasing count (float increments
  allowed);
* :class:`Gauge`: a value that goes up and down, either set directly
  (``set`` / ``inc`` / ``set_to_max``) or callback-backed: with
  ``owner=obj, callback=fn`` the gauge reads ``fn(owner)`` at snapshot time
  through a weak reference, and a dead owner prunes the child, so a
  per-engine gauge never keeps an engine (or its KV pool on the card)
  alive;
* :class:`Histogram`: fixed buckets with exact ``count`` / ``sum`` /
  ``min`` / ``max`` and p50 / p90 / p99 estimated by linear interpolation
  inside the bucket where the rank falls, so within one bucket width of
  the exact order statistic.

Reading: :func:`snapshot` (a plain nested dict, freshly built on every
call)::

    {"counters":   {name: {label_key: value}},
     "gauges":     {name: {label_key: value}},
     "histograms": {name: {label_key: {"count", "sum", "min", "max",
                                       "p50", "p90", "p99",
                                       "buckets": [[le, count], ...]}}}}

where ``label_key`` is ``"k=v,k2=v2"`` (sorted), ``""`` unlabelled;
:func:`to_prometheus` (text exposition 0.0.4, dots become underscores,
cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` series);
:func:`to_json` (the snapshot as strict JSON). :func:`serve` starts the
scrape surface: ``GET /metrics`` and ``GET /healthz`` on 127.0.0.1.

The switch :data:`METRICS` (the JAX package reads ``FLAGS_metrics``, on by
default) gates every mutation: off, ``inc`` / ``set`` / ``observe`` and
the per-request trace events are a global read and nothing else.
Telemetry is not control state: whatever the runtime branches on stays a
plain attribute beside the code that needs it, so switching telemetry off
never changes what the engine does.
"""

from __future__ import annotations

import bisect
import json
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["METRICS", "set_enabled", "Counter", "Gauge", "Histogram",
           "Registry", "counter", "gauge", "histogram", "enabled",
           "snapshot", "to_prometheus", "to_json", "reset", "clear",
           "label_key", "next_instance_id", "get_registry",
           "DEFAULT_MS_BUCKETS", "RATIO_BUCKETS", "register_health_provider",
           "health_snapshot", "serve", "MetricsServer"]

#: telemetry on (``FLAGS_metrics``'s default); see :func:`set_enabled`
METRICS = True

#: log-spaced (x2) bounds from 10 µs to ~22 minutes, in milliseconds
DEFAULT_MS_BUCKETS: Tuple[float, ...] = tuple(
    0.01 * (2.0 ** i) for i in range(28))

#: linear bounds for a 0..1 rate (the speculative acceptance), one bucket
#: per 0.05
RATIO_BUCKETS: Tuple[float, ...] = tuple(
    round(0.05 * i, 2) for i in range(21))


def set_enabled(on: bool) -> bool:
    """Switch telemetry on or off process-wide; returns the old setting."""
    global METRICS
    old, METRICS = METRICS, bool(on)
    return old


def enabled() -> bool:
    """The hot-path probe: is telemetry on?"""
    return METRICS


def label_key(**labels: Any) -> str:
    """The child key of a label set: ``"k=v,k2=v2"`` sorted by key, ``""``
    unlabelled."""
    if not labels:
        return ""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class _DeadOwner(Exception):
    """A callback gauge's owner was collected: the child is pruned."""


class Counter:
    """Monotonic counter (float increments allowed)."""

    __slots__ = ("name", "labels", "_value", "owner_ref")

    def __init__(self, name: str, labels: str, owner: Any = None):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self.owner_ref = weakref.ref(owner) if owner is not None else None

    def inc(self, n: float = 1.0) -> None:
        # checked before the switch: a negative delta fails either way
        if n < 0:
            raise ValueError(f"counter {self.name!r}: negative increment "
                             f"{n} — use a Gauge for values that go down")
        if not METRICS:
            return
        self._value += n

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def __repr__(self):
        return f"Counter({self.name}{{{self.labels}}}={self._value:g})"


class Gauge:
    """A set-able or callback-backed point-in-time value."""

    __slots__ = ("name", "labels", "_value", "_callback", "owner_ref")

    def __init__(self, name: str, labels: str,
                 callback: Optional[Callable[[], float]] = None,
                 owner: Any = None):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._callback = callback
        self.owner_ref = weakref.ref(owner) if owner is not None else None

    def set(self, v: float) -> None:
        if not METRICS:
            return
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not METRICS:
            return
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_to_max(self, v: float) -> None:
        """The high-water mark spelling (``peak_*`` gauges)."""
        if not METRICS:
            return
        if v > self._value:
            self._value = float(v)

    @property
    def value(self) -> float:
        if self._callback is not None:
            return float(self._callback())
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def __repr__(self):
        return f"Gauge({self.name}{{{self.labels}}})"


class Histogram:
    """Fixed-bucket histogram. Bucket ``i`` counts observations ``v <=
    bounds[i]`` (not cumulative); the last slot is the +Inf overflow."""

    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "min", "max", "owner_ref")

    def __init__(self, name: str, labels: str,
                 bounds: Sequence[float] = DEFAULT_MS_BUCKETS,
                 owner: Any = None):
        b = tuple(float(x) for x in bounds)
        if not b or list(b) != sorted(set(b)):
            raise ValueError(f"histogram {name!r}: bucket bounds must be "
                             f"a non-empty strictly increasing sequence, "
                             f"got {bounds!r}")
        self.name = name
        self.labels = labels
        self.bounds = b
        self.owner_ref = weakref.ref(owner) if owner is not None else None
        self.counts = [0] * (len(b) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        if not METRICS:
            return
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def bucket_bounds(self, v: float) -> Tuple[float, float]:
        """``(lo, hi]`` of the bucket ``v`` falls in: the error bar of a
        percentile estimate."""
        i = bisect.bisect_left(self.bounds, v)
        lo = self.bounds[i - 1] if i > 0 else 0.0
        hi = self.bounds[i] if i < len(self.bounds) else float("inf")
        return lo, hi

    def percentile(self, p: float) -> Optional[float]:
        """The estimated ``p``-th percentile (``p`` in [0, 100]), clamped to
        the observed range; None while empty."""
        if self.count == 0:
            return None
        rank = max(p / 100.0, 0.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.bounds):          # the overflow bucket
                    return self.max
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(min(frac, 1.0), 0.0)
                return max(min(est, self.max), self.min)
            cum += c
        return self.max

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = self.max = None

    def state(self) -> Dict[str, Any]:
        """The plain-dict view :func:`snapshot` embeds."""
        buckets: List[List[float]] = [
            [self.bounds[i], self.counts[i]] for i in range(len(self.bounds))]
        buckets.append([float("inf"), self.counts[-1]])
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99), "buckets": buckets}

    def __repr__(self):
        return (f"Histogram({self.name}{{{self.labels}}}, "
                f"count={self.count}, sum={self.sum:g})")


class _Family:
    __slots__ = ("name", "kind", "doc", "children", "bounds")

    def __init__(self, name: str, kind: str, doc: str,
                 bounds: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.doc = doc
        self.children: Dict[str, Any] = {}
        self.bounds = bounds


class Registry:
    """One namespace of instrument families. The process-wide one is
    :func:`get_registry`; tests build their own."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        self._ids: Dict[str, int] = {}

    # -- registration ---------------------------------------------------------
    def _family(self, name: str, kind: str, doc: str,
                bounds: Optional[Tuple[float, ...]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.setdefault(
                    name, _Family(name, kind, doc, bounds))
        if fam.kind != kind:
            raise TypeError(
                f"metric {name!r} is already registered as a {fam.kind} — "
                f"one name, one instrument type")
        if doc and not fam.doc:
            fam.doc = doc
        return fam

    def counter(self, name: str, doc: str = "", owner: Any = None,
                **labels: Any) -> Counter:
        """Get or create the counter child of this label set; with
        ``owner`` it lives only as long as that object."""
        fam = self._family(name, "counter", doc)
        key = label_key(**labels)
        child = fam.children.get(key)
        if child is None:
            with self._lock:
                child = fam.children.setdefault(
                    key, Counter(name, key, owner=owner))
        return child

    def gauge(self, name: str, doc: str = "",
              callback: Optional[Callable] = None, owner: Any = None,
              **labels: Any) -> Gauge:
        """Get or create a gauge child. With ``owner`` and ``callback`` it
        reads ``callback(owner)`` through a weak reference; registering a
        callback again rebinds the child (the last owner wins)."""
        fam = self._family(name, "gauge", doc)
        key = label_key(**labels)
        cb = None
        if callback is not None:
            if owner is not None:
                ref = weakref.ref(owner)

                def cb(_ref=ref, _fn=callback):
                    obj = _ref()
                    if obj is None:
                        raise _DeadOwner()
                    return _fn(obj)
            else:
                cb = callback
        child = fam.children.get(key)
        if child is None or cb is not None:
            with self._lock:
                child = Gauge(name, key, callback=cb, owner=owner)
                fam.children[key] = child
        return child

    def histogram(self, name: str, doc: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  owner: Any = None, **labels: Any) -> Histogram:
        """Get or create the histogram child; the bucket bounds belong to
        the family (fixed at its first registration)."""
        fam = self._family(
            name, "histogram", doc,
            bounds=tuple(buckets) if buckets else DEFAULT_MS_BUCKETS)
        if buckets is not None and tuple(buckets) != fam.bounds:
            raise ValueError(
                f"histogram {name!r} already registered with bounds "
                f"{fam.bounds} — bucket layout is fixed per family")
        key = label_key(**labels)
        child = fam.children.get(key)
        if child is None:
            with self._lock:
                child = fam.children.setdefault(
                    key, Histogram(name, key, bounds=fam.bounds,
                                   owner=owner))
        return child

    def next_instance_id(self, kind: str) -> int:
        """Monotone ids per kind: the ``engine=<n>`` label allocator."""
        with self._lock:
            n = self._ids.get(kind, 0)
            self._ids[kind] = n + 1
            return n

    # -- reading --------------------------------------------------------------
    def children(self, name: str) -> Dict[str, Any]:
        """``{label_key: instrument}`` of one family (empty if unknown)."""
        fam = self._families.get(name)
        return dict(fam.children) if fam else {}

    def _live_items(self, fam: _Family):
        """``(label_key, value or state)`` pairs; the children of dead
        owners are pruned on the way."""
        dead, out = [], []
        for key, child in sorted(fam.children.items()):
            ref = child.owner_ref
            if ref is not None and ref() is None:
                dead.append(key)
                continue
            try:
                out.append((key, child.state() if fam.kind == "histogram"
                            else child.value))
            except _DeadOwner:
                dead.append(key)
        for key in dead:
            fam.children.pop(key, None)
        return out

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Every live instrument as a plain nested dict, built anew."""
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._families):
            fam = self._families[name]
            items = self._live_items(fam)
            if items:
                out[fam.kind + "s"][name] = dict(items)
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        """The snapshot as strict JSON (the +Inf bound becomes ``"+Inf"``)."""
        return json.dumps(_sanitize_json(self.snapshot()), indent=indent,
                          allow_nan=False)

    def to_prometheus(self) -> str:
        """Prometheus text exposition 0.0.4."""
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            items = self._live_items(fam)
            if not items:
                continue
            pname = name.replace(".", "_").replace("-", "_")
            if fam.doc:
                lines.append(f"# HELP {pname} {fam.doc}")
            lines.append(f"# TYPE {pname} {fam.kind}")
            for key, val in items:
                base = _prom_labels(key)
                suffix = f"{{{base}}}" if base else ""
                if fam.kind != "histogram":
                    lines.append(f"{pname}{suffix} {_fmt(val)}")
                    continue
                cum, sep = 0, "," if base else ""
                for le, c in val["buckets"]:
                    cum += c
                    le_s = "+Inf" if le == float("inf") else _fmt(le)
                    lines.append(
                        f'{pname}_bucket{{{base}{sep}le="{le_s}"}} {cum}')
                lines.append(f"{pname}_sum{suffix} {_fmt(val['sum'])}")
                lines.append(f"{pname}_count{suffix} {val['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- lifecycle ------------------------------------------------------------
    def reset(self) -> None:
        """Zero every settable instrument; registrations and callback
        bindings stay."""
        for fam in self._families.values():
            for child in fam.children.values():
                child.reset()

    def clear(self) -> None:
        """Drop every family and child (held instruments keep working but
        leave the snapshots)."""
        with self._lock:
            self._families.clear()


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def _prom_labels(key: str) -> str:
    """``"k=v,k2=v2"`` -> ``k="v",k2="v2"``."""
    if not key:
        return ""
    parts = []
    for pair in key.split(","):
        k, _, v = pair.partition("=")
        v = v.replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return ",".join(parts)


def _sanitize_json(v):
    """Strict JSON: +Inf / -Inf become strings, NaN None."""
    if isinstance(v, dict):
        return {k: _sanitize_json(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize_json(x) for x in v]
    if isinstance(v, float):
        if v == float("inf"):
            return "+Inf"
        if v == float("-inf"):
            return "-Inf"
        if v != v:
            return None
    return v


# -- the process-wide registry --------------------------------------------------
_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def counter(name: str, doc: str = "", owner: Any = None,
            **labels: Any) -> Counter:
    return _REGISTRY.counter(name, doc=doc, owner=owner, **labels)


def gauge(name: str, doc: str = "", callback: Optional[Callable] = None,
          owner: Any = None, **labels: Any) -> Gauge:
    return _REGISTRY.gauge(name, doc=doc, callback=callback, owner=owner,
                           **labels)


def histogram(name: str, doc: str = "",
              buckets: Optional[Sequence[float]] = None,
              owner: Any = None, **labels: Any) -> Histogram:
    return _REGISTRY.histogram(name, doc=doc, buckets=buckets, owner=owner,
                               **labels)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()


def to_prometheus() -> str:
    return _REGISTRY.to_prometheus()


def to_json(indent: Optional[int] = None) -> str:
    return _REGISTRY.to_json(indent=indent)


def reset() -> None:
    _REGISTRY.reset()


def clear() -> None:
    _REGISTRY.clear()


def next_instance_id(kind: str) -> int:
    return _REGISTRY.next_instance_id(kind)


# -- the scrape surface -----------------------------------------------------------
#: name -> zero-argument callable returning one JSON-able /healthz section
_HEALTH_PROVIDERS: Dict[str, Callable[[], Dict[str, Any]]] = {}

#: the /healthz envelope's own keys, which no section may shadow
_HEALTH_RESERVED = ("status", "draining", "metrics")


def register_health_provider(name: str,
                             fn: Callable[[], Dict[str, Any]]) -> None:
    """Register (or replace) one named /healthz section."""
    if name in _HEALTH_RESERVED:
        raise ValueError(
            f"health provider name {name!r} is reserved (the /healthz "
            f"envelope keys are {_HEALTH_RESERVED}) — pick another name")
    _HEALTH_PROVIDERS[name] = fn


def health_snapshot(include_metrics: bool = True) -> Dict[str, Any]:
    """The /healthz document: ``status`` (``"ok"``, ``"draining"`` or
    ``"error"`` when a provider raised), ``draining`` (any section says
    so), every provider's section and, by default, the registry
    snapshot."""
    providers: Dict[str, Any] = {}
    status, draining = "ok", False
    for name in sorted(_HEALTH_PROVIDERS):
        try:
            section = _HEALTH_PROVIDERS[name]()
        except Exception as e:
            section = {"error": f"{type(e).__name__}: {e}"}
            status = "error"
        providers[name] = section
        if isinstance(section, dict) and section.get("draining"):
            draining = True
    if draining and status == "ok":
        status = "draining"
    out: Dict[str, Any] = {"status": status, "draining": draining,
                           **providers}
    if include_metrics:
        out["metrics"] = _REGISTRY.snapshot()
    return out


class MetricsServer:
    """A stdlib HTTP server with ``/metrics`` and ``/healthz`` on a daemon
    thread. ``port=0`` binds a free port (read ``.port`` / ``.url``);
    :meth:`close` stops it."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        import http.server


        class _Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._reply(200, to_prometheus().encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    doc = health_snapshot()
                    code = 200 if doc["status"] in ("ok", "draining") \
                        else 503
                    body = json.dumps(_sanitize_json(doc),
                                      allow_nan=False).encode()
                    self._reply(code, body, "application/json")
                else:
                    self._reply(404, b"not found: /metrics, /healthz\n",
                                "text/plain")

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"metrics-serve-{self.port}", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(port: int = 0, host: str = "127.0.0.1") -> MetricsServer:
    """Start the scrape surface: ``GET /metrics`` returns
    :func:`to_prometheus`, ``GET /healthz`` :func:`health_snapshot` as
    strict JSON, anything else 404. Returns the running server."""
    return MetricsServer(port=port, host=host)
