"""Metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of ``repro.obs.metrics`` (the JAX package keeps its own;
the port imports nothing from it).  One :class:`MetricsRegistry` owns a
flat namespace of metrics; each metric holds one value (or bucket table)
per label set.  Everything is plain Python + a lock — recording is an
O(1) dict update, and a DISABLED registry short-circuits every recording
call on a single attribute check, so instrumentation can stay in hot
paths unconditionally.

Naming follows Prometheus conventions so the exposition is scrapable
as-is: counters end in ``_total``, histograms expose
``<name>_bucket{le=...}`` / ``<name>_sum`` / ``<name>_count``.  The JSON
snapshot (:meth:`MetricsRegistry.snapshot`) flattens label sets into
``name{k=v,...}`` keys.

Percentiles come from the fixed buckets by linear interpolation inside
the covering bucket, clamped to the observed min/max — an estimate whose
error is bounded by the bucket width.
"""

from __future__ import annotations

import bisect
import json
import math
import threading


def _label_key(labels: dict) -> tuple:
    """Canonical hashable form of one label set (sorted pairs)."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: tuple) -> str:
    """Flattened snapshot key: ``name`` or ``name{k=v,...}``."""
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


def _prom_labels(key: tuple, extra: tuple = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    quoted = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in pairs
    )
    return "{" + quoted + "}"


class _Metric:
    """Shared per-metric state: name, help text, per-label-set series."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._registry = registry
        self.name = name
        self.help = help
        self._series: dict = {}  # label key tuple -> value/state

    def _get(self, labels: dict, default):
        key = _label_key(labels)
        with self._registry._lock:
            if key not in self._series:
                self._series[key] = default()
            return key

    def labelsets(self) -> list:
        return sorted(self._series)


class Counter(_Metric):
    """Monotonic accumulator.  ``inc`` is a no-op when the registry is
    disabled; negative increments raise (use a :class:`Gauge`)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if not self._registry.enabled:
            return
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        key = _label_key(labels)
        with self._registry._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time value (queue depth, pool occupancy)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not self._registry.enabled:
            return
        with self._registry._lock:
            self._series[_label_key(labels)] = v

    def add(self, n: float, **labels) -> None:
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._registry._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels):
        return self._series.get(_label_key(labels))


# Decode-latency-ish default: sub-0.1ms through 10s, roughly 2x steps.
DEFAULT_BUCKETS = (
    0.05,
    0.1,
    0.2,
    0.4,
    0.8,
    1.5,
    3.0,
    6.0,
    12.0,
    25.0,
    50.0,
    100.0,
    250.0,
    500.0,
    1000.0,
    2500.0,
    10000.0,
)


class _HistSeries:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = overflow (+inf) bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Fixed-bucket histogram with interpolated percentile estimates.

    ``buckets`` are upper bounds (ascending); samples beyond the last
    bound land in an implicit +inf bucket whose percentile estimates are
    clamped to the observed max.
    """

    kind = "histogram"

    def __init__(self, registry, name, help, buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name} needs ascending bucket bounds, "
                f"got {buckets!r}"
            )
        self.buckets = bounds

    def observe(self, v: float, **labels) -> None:
        if not self._registry.enabled:
            return
        v = float(v)
        key = _label_key(labels)
        with self._registry._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.counts[bisect.bisect_left(self.buckets, v)] += 1
            s.count += 1
            s.sum += v
            s.min = min(s.min, v)
            s.max = max(s.max, v)

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return s.count if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return s.sum if s else 0.0

    def percentile(self, p: float, **labels):
        """Interpolated p-th percentile estimate, or None when empty."""
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return None
        rank = (p / 100.0) * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            if c == 0:
                continue
            lo = self.buckets[i - 1] if i > 0 else s.min
            hi = self.buckets[i] if i < len(self.buckets) else s.max
            lo = max(min(lo, s.max), s.min)
            hi = max(min(hi, s.max), s.min)
            if cum + c >= rank:
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return s.max


class MetricsRegistry:
    """A namespace of metrics.  ``counter``/``gauge``/``histogram`` are
    idempotent: re-requesting a name returns the existing metric (and a
    kind mismatch raises, catching accidental name collisions)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._metrics: dict = {}

    # ------------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _register(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                    )
                return m
            m = cls(self, name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def metrics(self) -> list:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def value(self, name: str, **labels):
        """Convenience read of one counter/gauge series (None if the
        metric is unknown; 0/None per the metric's own default)."""
        m = self._metrics.get(name)
        if m is None:
            return None
        return m.value(**labels)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready export: flattened series under their kind.

        ``{"counters": {...}, "gauges": {...}, "histograms": {name:
        {"count", "sum", "p50", "p95", "p99", "min", "max"}}}``.
        """
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for m in self.metrics():
                if isinstance(m, Counter):
                    for key in m.labelsets():
                        name = _series_name(m.name, key)
                        out["counters"][name] = m._series[key]
                elif isinstance(m, Gauge):
                    for key in m.labelsets():
                        name = _series_name(m.name, key)
                        out["gauges"][name] = m._series[key]
                elif isinstance(m, Histogram):
                    for key in m.labelsets():
                        s = m._series[key]
                        labels = dict(key)
                        out["histograms"][_series_name(m.name, key)] = {
                            "count": s.count,
                            "sum": round(s.sum, 6),
                            "min": round(s.min, 6),
                            "max": round(s.max, 6),
                            "p50": round(m.percentile(50, **labels), 6),
                            "p95": round(m.percentile(95, **labels), 6),
                            "p99": round(m.percentile(99, **labels), 6),
                        }
        return out

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True) + "\n"

    def exposition(self) -> str:
        """Prometheus-style text exposition of every series."""
        lines = []
        with self._lock:
            for m in self.metrics():
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                if isinstance(m, Histogram):
                    for key in m.labelsets():
                        s = m._series[key]
                        cum = 0
                        for i, bound in enumerate(m.buckets):
                            cum += s.counts[i]
                            lab = _prom_labels(key, (("le", f"{bound:g}"),))
                            lines.append(f"{m.name}_bucket{lab} {cum}")
                        lab = _prom_labels(key, (("le", "+Inf"),))
                        lines.append(f"{m.name}_bucket{lab} {s.count}")
                        lines.append(
                            f"{m.name}_sum{_prom_labels(key)} {s.sum:g}"
                        )
                        lines.append(
                            f"{m.name}_count{_prom_labels(key)} {s.count}"
                        )
                else:
                    for key in m.labelsets():
                        lines.append(
                            f"{m.name}{_prom_labels(key)} "
                            f"{m._series[key]:g}"
                        )
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The process-global default registry: substrate-level counters (sc
# dispatch) record here.  DISABLED by default — the "zero cost until an
# operator opts in" contract.
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def enable() -> MetricsRegistry:
    """Turn the default registry on."""
    _DEFAULT.enable()
    return _DEFAULT


def disable() -> None:
    _DEFAULT.disable()


def enabled() -> bool:
    return _DEFAULT.enabled
