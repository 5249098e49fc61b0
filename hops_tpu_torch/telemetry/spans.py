"""Span timers: wall-clock blocks feeding latency histograms.

``with span("hops_tpu_serving_request", model=name): ...`` times the
block into a ``<name>_seconds`` histogram in the global registry;
``@timed()`` does the same for whole functions. While a
``torch.profiler`` records, each span additionally opens a
``torch.profiler.record_function`` range so spans nest inside the
profiler's timeline — one annotation vocabulary across metrics and
traces. With no profiler recording, no range is opened.

:class:`Phases` is the in-process form for hot loops (the LM engine):
host seconds and counts of named phases of one owner, read back as
numbers rather than histograms, with the same profiler range per phase.
:func:`annotate` is the range alone, for code that counts nothing; with
no profiler recording it costs one flag test.

:class:`StepTimer` is the step-loop shape of the same idea: one
``tick()`` per training step feeds the step-time histogram, the
steps/examples counters (PromQL ``rate()`` gives steps/sec and
examples/sec), and the ``hops_tpu_heartbeat_time`` gauge that
``runtime/preemption.py`` maintains and ``diagnostics.Watchdog`` can
watch.
"""

from __future__ import annotations

import contextlib
import functools
import re
import sys
import time
from typing import Any, Callable, ContextManager, Iterator

from hops_tpu_torch.telemetry.metrics import DEFAULT_BUCKETS, REGISTRY, Registry
from hops_tpu_torch.telemetry import tracing

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: The well-known heartbeat gauge names (see module docstring). The
#: wall-clock gauge is for scrapes ("when did this loop last beat");
#: the monotonic twin is what in-process watchdogs compare against —
#: immune to NTP steps, meaningless across processes.
HEARTBEAT_GAUGE = "hops_tpu_heartbeat_time"
HEARTBEAT_MONO_GAUGE = "hops_tpu_heartbeat_monotonic"


_NULL = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording in this process: the
    module flag that the profiler sets on start and clears on stop.
    False, without importing torch, in a process that never loaded it."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def annotate(name: str) -> ContextManager[Any]:
    """A ``record_function(name)`` range while a profiler records (a
    ``user_annotation`` event in its trace, on the clock of the device's
    kernels); otherwise a shared no-op context, for one flag test."""
    if not profiling():
        return _NULL
    return sys.modules["torch.autograd.profiler"].record_function(name)


class Phases:
    """Host seconds (``time.perf_counter``) and counts of the named
    phases of one owner. ``with phases.phase(name):`` adds the block's
    seconds and one count to ``name`` and, while a profiler records,
    opens the :func:`annotate` range of the same name; :meth:`add`
    books an interval measured elsewhere (one that spans calls)."""

    def __init__(self) -> None:
        self._seconds: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        self._seconds[name] = self._seconds.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + count

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            self.add(name, time.perf_counter() - start)

    def seconds(self, name: str) -> float:
        return self._seconds.get(name, 0.0)

    def count(self, name: str) -> int:
        return self._counts.get(name, 0)


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _histogram(name: str, labels: tuple[str, ...], registry: Registry):
    return registry.histogram(
        f"{_sanitize(name)}_seconds",
        f"Duration of {name} spans",
        labels=labels,
        buckets=DEFAULT_BUCKETS,
    )


@contextlib.contextmanager
def span(name: str, registry: Registry = REGISTRY,
         **labels: Any) -> Iterator[None]:
    """Time the block into ``<name>_seconds{**labels}``. Label NAMES
    must be consistent across uses of one span name (they declare the
    histogram's label set). Exceptions propagate but the duration is
    still recorded — error latency is latency.

    When the calling context carries an active distributed trace
    (``telemetry/tracing.py``), the block additionally records a child
    tracing span of the same name — one annotation vocabulary across
    metrics, profiler timelines, and request traces — and the histogram
    observation carries the trace id as an exemplar, so a latency
    bucket links back to a concrete trace."""
    hist = _histogram(name, tuple(sorted(labels)), registry)
    # Nests inside a recording profiler's timeline; nothing otherwise.
    annotation = annotate(name)
    # Joins the active request trace; a no-op outside one (and the
    # whole lookup is one bool when tracing is disabled).
    tspan = tracing.child_span(name, **labels)
    start = time.monotonic()
    try:
        with annotation, tspan:
            yield
    finally:
        hist.observe(time.monotonic() - start,
                     exemplar=tracing.current_trace_id(), **labels)


def timed(name: str | None = None, registry: Registry = REGISTRY,
          **labels: Any) -> Callable:
    """Decorator form of :func:`span`; the metric name defaults to the
    function's qualified name (``hops_tpu_span_<module>_<fn>``)."""

    def deco(fn: Callable) -> Callable:
        span_name = name or _sanitize(
            f"hops_tpu_span_{fn.__module__}_{fn.__qualname__}"
        )

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with span(span_name, registry=registry, **labels):
                return fn(*args, **kwargs)

        return wrapper

    return deco


class StepTimer:
    """Step-cadence telemetry for training/experiment loops.

    Call :meth:`tick` once per completed step (``examples=`` the batch
    size if known). Feeds, all labelled ``loop=<name>``:

    - ``hops_tpu_step_seconds`` — step-time histogram (time between
      consecutive ticks; the first tick only arms the clock),
    - ``hops_tpu_steps_total`` / ``hops_tpu_examples_total`` —
      counters whose scrape-side ``rate()`` is steps/sec and
      examples/sec,
    - ``hops_tpu_heartbeat_time`` — unix time of the last tick, the
      gauge ``diagnostics.Watchdog(watch_heartbeat_gauge=True)`` reads
      instead of requiring explicit ``heartbeat()`` calls.
    """

    def __init__(self, loop: str = "train", registry: Registry = REGISTRY):
        self.loop = loop
        self._step_seconds = registry.histogram(
            "hops_tpu_step_seconds", "Training step wall time",
            labels=("loop",),
        ).labels(loop=loop)
        self._steps = registry.counter(
            "hops_tpu_steps_total", "Training steps completed",
            labels=("loop",),
        ).labels(loop=loop)
        self._examples = registry.counter(
            "hops_tpu_examples_total", "Training examples consumed",
            labels=("loop",),
        ).labels(loop=loop)
        self._heartbeat = registry.gauge(
            HEARTBEAT_GAUGE,
            "Unix time of the last step-boundary heartbeat, per loop",
            labels=("loop",),
        ).labels(loop=loop)
        self._heartbeat_mono = registry.gauge(
            HEARTBEAT_MONO_GAUGE,
            "Monotonic clock of the last step-boundary heartbeat, per "
            "loop (for in-process watchdogs; not comparable across "
            "processes)",
            labels=("loop",),
        ).labels(loop=loop)
        self._last: float | None = None

    def _beat(self) -> None:
        self._heartbeat.set(time.time())
        self._heartbeat_mono.set(time.monotonic())

    def arm(self) -> None:
        """Reset the step clock without recording anything — call at a
        loop (re)start so the first tick doesn't measure idle time
        spanning two runs."""
        self._last = time.monotonic()
        self._beat()

    def tick(self, examples: int | None = None) -> None:
        now = time.monotonic()
        if self._last is not None:
            self._step_seconds.observe(now - self._last)
        self._last = now
        self._steps.inc()
        if examples:
            self._examples.inc(examples)
        self._beat()
