"""Process-wide metrics registry: counters, gauges, histograms (a copy of
the JAX package's ``obs/metrics.py``, which imports only the stdlib).

Design constraints, in priority order:

1. **Hot-path cost**: an increment on the train-loop boundary must be
   invisible next to even a CPU step.  A child (one labeled series) is a
   ``__slots__`` object and ``inc`` is a single attribute ``+=`` — no
   lock, no dict lookup, no allocation.  Under the GIL that is effectively
   atomic; under free-threading a torn increment costs one tick of
   accuracy, never a deadlock — the right trade for telemetry.  The
   guard lives in tests/test_obs.py: < 2 us per increment on CPU.
2. **Snapshot/delta semantics**: ``snapshot()`` is a plain JSON-able
   dict stamped with a monotonic-clock timestamp; ``delta(prev, cur)``
   turns two snapshots into rates-ready differences (counters diff,
   gauges take the newer value).  The flight recorder rings deltas; the
   exporters serialize snapshots.
3. **Labels**: ``family.labels(k=v)`` returns the child for that label
   set; the series key is canonical (labels sorted), so
   ``labels(a=1, b=2)`` and ``labels(b=2, a=1)`` are the same series.

Registration (``registry().counter(name)``) takes a lock and is
idempotent — calling it again with the same name returns the same
family, so module-level and ad-hoc call sites can share series without
coordinating.  Stdlib-only on purpose (see the package docstring).
"""

from __future__ import annotations

import bisect
import math
import threading
import time

# Patchable seams: tests monkeypatch these to pin timestamps so flight
# dumps are bitwise-reproducible.  ``_now`` is the monotonic clock every
# in-process duration/age uses; ``_wall`` is the unix clock that lets
# events from DIFFERENT processes line up on one timeline (monotonic
# epochs are per-boot/per-namespace, wall clocks are shared on a host
# and NTP-close across one) — the cross-rank merge in obs/timeline.py
# aligns on wall stamps and keeps durations monotonic.
_now = time.monotonic
_wall = time.time

# Span histogram defaults: wall seconds from sub-ms dispatch boundaries
# to multi-minute capture phases.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   60.0, 600.0)


def json_safe(obj):
    """Replace non-finite floats with their string names ("nan"/"inf")
    so every obs writer (flight dumps, JSONL exporter, trace-file sink)
    emits STRICT JSON even — especially — when recording the NaN loss
    a drill exists to document: a bare ``NaN`` token (json.dumps's
    permissive default) breaks jq and every non-Python consumer."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def series_key(name: str, label_items: tuple = ()) -> str:
    """Canonical Prometheus-style series key: ``name{a="1",b="2"}``."""
    if not label_items:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in label_items)
    return f"{name}{{{inner}}}"


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, amount=1) -> None:
        self.value += amount


class _GaugeChild:
    __slots__ = ("value", "monotonic_ts")

    def __init__(self):
        self.value = 0.0
        self.monotonic_ts = None    # never set

    def set(self, value) -> None:
        self.value = value
        self.monotonic_ts = _now()

    def inc(self, amount=1) -> None:
        self.set(self.value + amount)


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last slot: > max bound
        self.sum = 0.0
        self.count = 0

    def observe(self, value) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1


class _Family:
    """One metric name; children are its labeled series (the unlabeled
    series is the ``()`` child, resolved once at construction so the
    bare ``inc()``/``set()`` path skips the dict entirely)."""

    kind = ""
    _child_cls: type = None

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: dict[tuple, object] = {}
        # RLock, not Lock: the SIGTERM-chained flight dump runs in the
        # MAIN thread and may interrupt it mid-registration — snapshot()
        # re-acquiring a plain Lock there would deadlock the dying
        # process past its kill grace with no postmortem written.
        self._lock = threading.RLock()
        self._bare = self._resolve(())

    def _new_child(self):
        return self._child_cls()

    def _resolve(self, items: tuple):
        child = self._children.get(items)
        if child is None:
            with self._lock:
                child = self._children.get(items)
                if child is None:
                    child = self._children[items] = self._new_child()
        return child

    def labels(self, **labels):
        return self._resolve(tuple(sorted(
            (k, str(v)) for k, v in labels.items())))

    def _touched(self, child) -> bool:
        if isinstance(child, _CounterChild):
            return bool(child.value)
        if isinstance(child, _GaugeChild):
            return child.monotonic_ts is not None
        return bool(child.count)

    def series(self):
        """(series_key, child) pairs, canonically sorted.  The key set
        is copied UNDER the lock: a snapshot may run on another thread
        (bench's watchdog dumping a flight) while the observed thread
        registers a new labeled series, and iterating the live dict
        there would raise mid-dump and silently cost the postmortem.
        The eager unlabeled child (the lock-free bare-op fast path) is
        elided while untouched in a family that only ever uses labels —
        a labeled-only export must not grow a phantom zero series."""
        with self._lock:
            snapshot = sorted(self._children.items())
        for items, child in snapshot:
            if (not items and len(snapshot) > 1
                    and not self._touched(child)):
                continue
            yield series_key(self.name, items), child


class Counter(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount=1) -> None:
        self._bare.inc(amount)

    @property
    def value(self):
        return self._bare.value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value) -> None:
        self._bare.set(value)

    def inc(self, amount=1) -> None:
        self._bare.inc(amount)

    @property
    def value(self):
        return self._bare.value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self._bounds = tuple(sorted(buckets))
        super().__init__(name, help)

    def _new_child(self):
        return _HistogramChild(self._bounds)

    def observe(self, value) -> None:
        self._bare.observe(value)


class MetricsRegistry:
    """Name -> family map with idempotent registration."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.RLock()   # see _Family: signal-safe re-entry

    def _register(self, cls, name: str, help: str, **kw) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = self._families[name] = cls(name, help, **kw)
        if not isinstance(fam, cls):
            raise ValueError(f"metric {name!r} already registered as a "
                             f"{fam.kind}, not a {cls.kind}")
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def families(self):
        # Keys copied under the lock — same cross-thread-snapshot
        # reasoning as _Family.series().
        with self._lock:
            fams = sorted(self._families.items())
        for _, fam in fams:
            yield fam

    def snapshot(self) -> dict:
        """Point-in-time JSON-able view, stamped with the monotonic
        clock (wall time is a different axis — the flight recorder
        carries its own start_unix for that)."""
        snap = {"monotonic_ts": round(_now(), 6),
                "counters": {}, "gauges": {}, "histograms": {}}
        for fam in self.families():
            for key, child in fam.series():
                if fam.kind == "counter":
                    snap["counters"][key] = child.value
                elif fam.kind == "gauge":
                    snap["gauges"][key] = {
                        "value": child.value,
                        "monotonic_ts": (None if child.monotonic_ts is None
                                         else round(child.monotonic_ts, 6))}
                else:
                    # One copy of the bucket counts serves every derived
                    # field: reading child.count at a later instant than
                    # the counts (while another thread observes) could
                    # yield +Inf < a finite bucket's cumulative — a
                    # structurally invalid histogram, worse than the
                    # one-tick skew the lock-free design accepts.
                    counts = list(child.counts)
                    cum, buckets = 0, {}
                    for bound, n in zip(child.bounds, counts):
                        cum += n
                        buckets[str(bound)] = cum
                    total = sum(counts)
                    buckets["+Inf"] = total
                    snap["histograms"][key] = {
                        "count": total,
                        "sum": round(child.sum, 6),
                        "buckets": buckets}
        return snap

    @staticmethod
    def delta(prev: dict | None, cur: dict) -> dict:
        """Counter differences (a series absent from ``prev`` counts
        from zero), newest gauge values, and the monotonic span between
        the two snapshots — the rate denominator."""
        prev = prev or {}
        out = {"span_s": (None if "monotonic_ts" not in prev else round(
                   cur["monotonic_ts"] - prev["monotonic_ts"], 6)),
               "counters": {}, "gauges": {}}
        prev_c = prev.get("counters", {})
        for key, value in cur.get("counters", {}).items():
            d = value - prev_c.get(key, 0)
            if d:
                out["counters"][key] = d
        for key, g in cur.get("gauges", {}).items():
            out["gauges"][key] = g["value"]
        return out


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every wired seam shares."""
    return _REGISTRY


def counter(name: str, help: str = "") -> Counter:
    return _REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, help, buckets=buckets)
