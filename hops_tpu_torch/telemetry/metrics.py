"""Thread-safe, label-aware metrics registry.

The reference platform surrounded every workload with observability —
per-serving Kafka inference logs shipped to ELK, Spark executor metrics,
TensorBoard profiling (SURVEY.md §5) — but until now this reproduction
had only structured logging and hang detection. This module is the
counters/gauges/histograms layer underneath all of it: a process-local
:class:`Registry` of named metrics, each optionally labelled, safe to
update from any thread (serving handler threads, the LM engine driver,
search executors) and cheap enough for hot paths (one lock acquire + a
dict lookup per update; bind with :meth:`_Metric.labels` to skip the
lookup).

Stdlib-only by design: importing this module must never pull in torch
— metrics are updated from processes that may not own the card (serving
hosts, job children). The host tag reuses the convention from
``runtime/logging.py``: ``h<rank>`` once a ``torch.distributed`` process
group is up, ``h?`` before/without it, computed lazily at export time
only.

Naming scheme (see docs/operations.md "Telemetry & metrics"):
``hops_tpu_<subsystem>_<what>[_<unit>]`` with ``_total`` for counters
and ``_seconds`` for latency histograms — the Prometheus conventions,
so ``export.render_prometheus`` is a straight transcription.
"""

from __future__ import annotations

import bisect
import math
import sys
import threading
import time
from typing import Any, Iterable

#: Latency buckets (seconds): sub-ms dispatch overheads up to the
#: minute-scale experiment steps — shared default for every `_seconds`
#: histogram so dashboards line up across subsystems.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Buckets for ratios in [0, 1] (batch fill, occupancy).
RATIO_BUCKETS: tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)


def hosttag() -> str:
    """``h<rank>`` — the per-host prefix from ``runtime/logging.py``.
    Tags with the real rank ONLY if a ``torch.distributed`` process
    group is already initialized; otherwise ``h?``. A scrape never
    imports torch into a process that has not loaded it, and never
    initializes CUDA or a process group."""
    try:
        torch = sys.modules.get("torch")
        if torch is not None:
            dist = torch.distributed
            if dist.is_available() and dist.is_initialized():
                return f"h{dist.get_rank()}"
    except Exception:  # graftlint: disable=swallowed-exception
        pass  # by contract: a metrics scrape must NEVER raise
    return "h?"


class _Metric:
    """Base: a named family of (label-values -> value) children."""

    type: str = "untyped"

    def __init__(self, name: str, help: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}  # guarded by: self._lock

    def _key(self, labels: dict[str, Any]) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name} declared labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[k]) for k in self.label_names)

    def labels(self, **labels: Any) -> Any:
        """Bind a child for repeated hot-path updates (one dict lookup
        amortized away)."""
        key = self._key(labels)
        with self._lock:
            return self._child(key)

    def _child(self, key: tuple[str, ...]) -> Any:  # guarded by: self._lock
        raise NotImplementedError

    def samples(self) -> list[tuple[str, dict[str, str], float]]:
        """``(name_suffix, labels, value)`` rows for the exporter."""
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    """Monotonically increasing count (requests, tokens, trials)."""

    type = "counter"

    def _child(self, key: tuple[str, ...]) -> _CounterChild:  # guarded by: self._lock
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _CounterChild(self._lock)
        return child

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self.labels(**labels).inc(amount)

    def value(self, **labels: Any) -> float:
        return self.labels(**labels).value

    def samples(self) -> list[tuple[str, dict[str, str], float]]:
        with self._lock:
            items = list(self._children.items())
        return [
            ("", dict(zip(self.label_names, key)), child.value)
            for key, child in items
        ]


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    """Point-in-time value (queue depth, occupancy, heartbeat time)."""

    type = "gauge"

    def _child(self, key: tuple[str, ...]) -> _GaugeChild:  # guarded by: self._lock
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _GaugeChild(self._lock)
        return child

    def set(self, value: float, **labels: Any) -> None:
        self.labels(**labels).set(value)

    def set_to_current_time(self, **labels: Any) -> None:
        self.labels(**labels).set(time.time())

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self.labels(**labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.labels(**labels).dec(amount)

    def value(self, **labels: Any) -> float:
        return self.labels(**labels).value

    def samples(self) -> list[tuple[str, dict[str, str], float]]:
        with self._lock:
            items = list(self._children.items())
        return [
            ("", dict(zip(self.label_names, key)), child.value)
            for key, child in items
        ]


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, lock: threading.Lock, bounds: tuple[float, ...]):
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        # bucket index -> (trace_id, value, unix time): the newest
        # traced observation per bucket, so a p99 bucket on a dashboard
        # links to a concrete trace in the ring (OpenMetrics-style
        # exemplars; export renders them behind a flag).
        # guarded by: self._lock
        self.exemplars: dict[int, tuple[str, float, float]] | None = None

    def snapshot(self) -> tuple[tuple[float, ...], list[int], int]:
        """Consistent ``(bounds, per-bucket counts, total count)`` view
        — quantile estimators (the fleet router's windowed p99) diff
        two snapshots instead of reaching into the fields unlocked."""
        with self._lock:
            return self.bounds, list(self.counts), self.count

    def observe(self, value: float, exemplar: str | None = None) -> None:
        value = float(value)
        # NaN compares false against every bound (bisect would file it
        # under the SMALLEST bucket); Prometheus clients count it only
        # in +Inf/_count, so route it to the overflow slot.
        if math.isnan(value):
            i = len(self.bounds)
        else:
            i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1
            if exemplar is not None:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[i] = (exemplar, value, time.time())


class Histogram(_Metric):
    """Distribution (latencies, fill ratios) with cumulative buckets in
    the Prometheus exposition."""

    type = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: tuple[str, ...],
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(math.isinf(b) for b in bounds):
            bounds = tuple(b for b in bounds if not math.isinf(b))
        self.buckets = bounds

    def _child(self, key: tuple[str, ...]) -> _HistogramChild:  # guarded by: self._lock
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _HistogramChild(self._lock, self.buckets)
        return child

    def observe(self, value: float, exemplar: str | None = None,
                **labels: Any) -> None:
        self.labels(**labels).observe(value, exemplar=exemplar)

    def exemplars(self) -> dict[tuple[tuple[str, ...], str], tuple[str, float, float]]:
        """``(child_key, le) -> (trace_id, value, time)`` — the newest
        traced observation per bucket, keyed the way the exporter
        reconstructs bucket rows."""
        with self._lock:
            items = [
                (key, dict(child.exemplars))
                for key, child in self._children.items()
                if child.exemplars
            ]
        out: dict[tuple[tuple[str, ...], str], tuple[str, float, float]] = {}
        for key, ex in items:
            for i, row in ex.items():
                le = _fmt(self.buckets[i]) if i < len(self.buckets) else "+Inf"
                out[(key, le)] = row
        return out

    def samples(self) -> list[tuple[str, dict[str, str], float]]:
        with self._lock:
            items = [
                (key, list(child.counts), child.sum, child.count)
                for key, child in self._children.items()
            ]
        rows: list[tuple[str, dict[str, str], float]] = []
        for key, counts, total, count in items:
            base = dict(zip(self.label_names, key))
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                rows.append(("_bucket", {**base, "le": _fmt(bound)}, float(cum)))
            rows.append(("_bucket", {**base, "le": "+Inf"}, float(count)))
            rows.append(("_sum", base, total))
            rows.append(("_count", base, float(count)))
        return rows


def _fmt(bound: float) -> str:
    """Prometheus-style bucket bound: integral bounds render bare."""
    return str(int(bound)) if bound == int(bound) else repr(bound)


class Registry:
    """Named metrics, get-or-create. One process-global :data:`REGISTRY`
    serves every subsystem; tests may build private ones. Get-or-create
    is what lets two modules share a well-known metric (the heartbeat
    gauge the Watchdog reads) without import-order coupling — but a
    name re-declared with a different type or label set is a bug and
    raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}  # guarded by: self._lock

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Iterable[str], **kwargs: Any) -> Any:
        label_names = tuple(labels)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.label_names != label_names:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type}{existing.label_names}, "
                        f"conflicting re-declaration"
                    )
                if kwargs.get("buckets") is not None:
                    # Same normalization the Histogram ctor applies —
                    # silently handing back differently-bucketed series
                    # would corrupt the second declarer's quantiles.
                    # buckets=None (a read-back, not a declaration)
                    # skips the check: readers must not have to restate
                    # the declarer's buckets.
                    wanted = tuple(sorted(
                        float(b) for b in kwargs["buckets"] if not math.isinf(b)
                    ))
                    if wanted != existing.buckets:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {existing.buckets}, conflicting "
                            f"re-declaration with {wanted}"
                        )
                return existing
            if "buckets" in kwargs and kwargs["buckets"] is None:
                kwargs["buckets"] = DEFAULT_BUCKETS
            metric = cls(name, help, label_names, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] | None = None) -> Histogram:
        """``buckets=None`` means "declarer's default" on first
        registration (:data:`DEFAULT_BUCKETS`) and "whatever was
        declared" on read-back — explicit buckets are a declaration and
        must match any existing one."""
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> list[_Metric]:
        """Stable-order snapshot of the registered metric families."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric — test isolation only: modules keep direct
        references to metric objects they created, so resetting a live
        process orphans (not re-links) those references."""
        with self._lock:
            self._metrics.clear()


#: The process-global registry every subsystem instruments into.
REGISTRY = Registry()
