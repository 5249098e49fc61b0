"""Metric export: Prometheus text exposition, JSON snapshots, pubsub
(a copy of ``hops_tpu/telemetry/export.py``: the module imports no JAX, and
the port imports nothing of the JAX package).

Three consumers, one registry (``metrics.REGISTRY``):

- **Prometheus scrape** — :func:`render_prometheus` produces text
  exposition format 0.0.4; :func:`start_http_server` serves it at
  ``GET /metrics`` from a standalone daemon thread, and
  ``modelrepo/serving.py`` mounts the same rendering on every started
  serving's own port (scrape the model server directly, the way the
  reference's serving containers were scraped).
- **JSON snapshot** — :func:`snapshot` for dashboards/tests; also
  served at ``GET /metrics.json``.
- **Pubsub tail** — :class:`PubsubExporter` periodically appends
  snapshots onto a ``messaging.pubsub`` topic: the stand-in
  for the reference's Kafka→ELK metrics pipeline (SURVEY.md §5) —
  consumers replay/tail it exactly like the inference logs.

Every exported series carries a ``host`` label (the
``runtime/logging.py`` hosttag convention) so multi-host scrapes and a
shared pubsub topic stay disambiguated.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any

from hops_tpu_torch.telemetry import metrics as _metrics
from hops_tpu_torch.telemetry.metrics import REGISTRY, Histogram, Registry

#: Render histogram exemplars (`# {trace_id="..."} value ts` appended
#: to bucket rows) in the Prometheus exposition. Off by default: the
#: `# {...}` suffix is OpenMetrics syntax and some 0.0.4-only scrapers
#: choke on it — flip via env or pass ``exemplars=`` explicitly.
EXEMPLARS_ENABLED = os.environ.get(
    "HOPS_TPU_METRIC_EXEMPLARS", "0") not in ("0", "false", "")


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _format_value(v: float) -> str:
    # Non-finite values use the exposition-format spellings; int()
    # comparison on them would raise and permanently 500 the scrape
    # (one diverged-loss observe must not kill /metrics).
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render_prometheus(registry: Registry = REGISTRY,
                      exemplars: bool | None = None) -> str:
    """Text exposition format 0.0.4 — what ``GET /metrics`` returns.

    ``exemplars=True`` (default: :data:`EXEMPLARS_ENABLED`) appends
    OpenMetrics-style exemplars to histogram bucket rows —
    ``# {trace_id="..."} value timestamp`` — linking a latency bucket
    to a concrete trace retrievable from ``GET /debug/traces/<id>``.
    """
    if exemplars is None:
        exemplars = EXEMPLARS_ENABLED
    host = _metrics.hosttag()
    out: list[str] = []
    for metric in registry.collect():
        if metric.help:
            out.append(f"# HELP {metric.name} {_escape(metric.help)}")
        out.append(f"# TYPE {metric.name} {metric.type}")
        ex_rows = (
            metric.exemplars()
            if exemplars and isinstance(metric, Histogram) else {}
        )
        for suffix, labels, value in metric.samples():
            labeled = {"host": host, **labels}
            body = ",".join(
                f'{k}="{_escape(str(v))}"' for k, v in labeled.items()
            )
            line = f"{metric.name}{suffix}{{{body}}} {_format_value(value)}"
            if ex_rows and suffix == "_bucket":
                key = tuple(
                    str(labels[k]) for k in metric.label_names
                    if k in labels
                )
                ex = ex_rows.get((key, labels.get("le", "")))
                if ex is not None:
                    tid, ex_value, ex_time = ex
                    line += (
                        f' # {{trace_id="{_escape(tid)}"}} '
                        f"{_format_value(ex_value)} {ex_time:.3f}"
                    )
            out.append(line)
    return "\n".join(out) + "\n"


def snapshot(registry: Registry = REGISTRY,
             families: "set[str] | None" = None) -> dict[str, Any]:
    """JSON-able point-in-time dump of every metric family.

    ``families`` restricts the dump to the named families — the hot
    scrape path: the fleet router polls every replica several times a
    second to read FOUR gauges, and rendering + parsing the full
    registry per poll was almost all of that cost."""
    out: dict[str, Any] = {}
    for metric in registry.collect():
        if families is not None and metric.name not in families:
            continue
        rows = [
            {"suffix": suffix, "labels": labels, "value": value}
            for suffix, labels, value in metric.samples()
        ]
        out[metric.name] = {
            "type": metric.type,
            "help": metric.help,
            "samples": rows,
        }
    return {"time": time.time(), "host": _metrics.hosttag(), "metrics": out}


def metrics_response(
    path_qs: str, registry: Registry = REGISTRY
) -> "tuple[int, dict[str, str], bytes] | None":
    """The pure half of :func:`handle_metrics_path`: given a request
    path (query string attached), return ``(status, headers, body)``
    for the metrics routes, or ``None`` when the path is not one —
    the shape the event-loop transport's ``route`` contract consumes
    directly (``runtime/httpserver.py``).

    ``GET /metrics.json?families=a,b`` serves only the named families
    (unknown names are simply absent) — the router's scrape asks for
    exactly the gauges it routes on instead of the whole registry."""
    path, _, query = path_qs.partition("?")
    path = path.rstrip("/")
    if path == "/metrics":
        data = render_prometheus(registry).encode()
        ctype = "text/plain; version=0.0.4; charset=utf-8"
    elif path == "/metrics.json":
        wanted = None
        if query:
            from urllib.parse import parse_qs

            raw = parse_qs(query).get("families", [])
            names = {n for part in raw for n in part.split(",") if n}
            wanted = names or None
        data = json.dumps(snapshot(registry, families=wanted)).encode()
        ctype = "application/json"
    else:
        return None
    return 200, {"Content-Type": ctype}, data


def handle_metrics_path(handler: BaseHTTPRequestHandler,
                        registry: Registry = REGISTRY) -> bool:
    """Serve ``GET /metrics`` / ``GET /metrics.json`` on an existing
    ``BaseHTTPRequestHandler`` — the stdlib-handler wrapper around
    :func:`metrics_response`, kept for any embedder still on the
    thread-per-connection transport. Returns True if the request path
    was a metrics route (and was answered)."""
    resp = metrics_response(handler.path, registry)
    if resp is None:
        return False
    status, headers, data = resp
    handler.send_response(status)
    for k, v in headers.items():
        handler.send_header(k, v)
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)
    return True


def debug_response(path_qs: str) -> "tuple[int, dict[str, str], bytes] | None":
    """The pure half of :func:`handle_debug_path`: ``(status, headers,
    body)`` for the debug surfaces, or ``None`` when the path is not
    one. Mounted beside :func:`metrics_response` on every serving,
    replica, and router port (and on :class:`MetricsServer`). Routes
    (docs/operations.md "Tracing & debugging"):

    - ``GET /debug/traces`` — newest-first trace summaries over this
      process's span ring; ``?limit=N`` caps the summary count and
      ``?since=<wall-time>`` drops traces that started before the
      stamp (malformed values degrade to the defaults, never a 500);
    - ``GET /debug/traces/<trace_id>`` — every recorded span of one
      trace (404 when the ring holds none);
    - ``GET /debug/flight`` — the flight recorder's event ring;
    - ``GET /debug/workload`` — workload-capture status (armed,
      artifact directory, segment/request/byte counts).
    """
    # Lazy: flight lives in runtime (which imports this package).
    from hops_tpu_torch.runtime import flight as _flight
    from hops_tpu_torch.telemetry import tracing as _tracing
    from hops_tpu_torch.telemetry import workload as _workload

    path, _, query = path_qs.partition("?")
    path = path.rstrip("/")
    code = 200
    if path == "/debug/traces":
        from urllib.parse import parse_qs

        params = parse_qs(query)

        def qnum(key: str, cast, default):
            try:
                return cast(params[key][0])
            except (KeyError, IndexError, ValueError):
                return default

        limit = qnum("limit", int, 50)
        if limit < 0:
            # A negative slice would drop the NEWEST traces — the
            # opposite of any caller's intent; degrade like any other
            # malformed value.
            limit = 50
        since = qnum("since", float, None)
        body: dict[str, Any] = {
            "enabled": _tracing.enabled(),
            "sample_rate": _tracing.TRACER.sample_rate,
            "ring_size": _tracing.TRACER.ring_size,
            "traces": _tracing.TRACER.traces(limit=limit, since=since),
        }
    elif path.startswith("/debug/traces/"):
        trace_id = path[len("/debug/traces/"):]
        spans = _tracing.TRACER.get_trace(trace_id)
        if spans:
            body = {"trace_id": trace_id, "spans": spans}
        else:
            code, body = 404, {"error": f"no spans for trace {trace_id!r} "
                                        "in this process's ring"}
    elif path == "/debug/flight":
        body = _flight.FLIGHT.snapshot()
    elif path == "/debug/workload":
        body = _workload.status()
    else:
        return None
    data = json.dumps(body, default=str).encode()
    return code, {"Content-Type": "application/json"}, data


def handle_debug_path(handler: BaseHTTPRequestHandler) -> bool:
    """Serve the debug surfaces on an existing stdlib handler — the
    thread-per-connection wrapper around :func:`debug_response`.
    Returns True if the request path was a debug route (and answered).
    """
    resp = debug_response(handler.path)
    if resp is None:
        return False
    code, headers, data = resp
    handler.send_response(code)
    for k, v in headers.items():
        handler.send_header(k, v)
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)
    return True


class MetricsServer:
    """Standalone scrape endpoint serving ``/metrics`` (Prometheus
    text) and ``/metrics.json`` — plus the ``/debug/*`` surfaces — for
    processes that have no serving port of their own (training jobs,
    the search loop). Rides the shared event-loop transport
    (``runtime/httpserver.py``); scrapes are read-only and cheap, so a
    small worker pool is plenty."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Registry = REGISTRY):
        # Lazy: runtime/httpserver imports this package's metrics
        # module; importing it at export's module top would cycle.
        from hops_tpu_torch.runtime.httpserver import HTTPServer

        registry_ = registry

        def route(method: str, path: str, headers: Any,
                  body: bytes) -> tuple[int, dict[str, str], bytes]:
            resp = metrics_response(path, registry_) or debug_response(path)
            if resp is None:
                return 404, {"Content-Type": "application/json"}, b"{}"
            return resp

        self._server = HTTPServer(
            route, bind=host, port=port, name="metrics", workers=2)

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self) -> None:
        self._server.stop()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def start_http_server(port: int = 0, registry: Registry = REGISTRY) -> MetricsServer:
    """Start a :class:`MetricsServer`; ``port=0`` picks a free one
    (read it back from ``.port``)."""
    return MetricsServer(port=port, registry=registry)


class PubsubExporter:
    """Periodic snapshot export onto a ``messaging.pubsub`` topic.

    The reference shipped per-serving metrics over Kafka into ELK;
    here every ``interval_s`` a :func:`snapshot` is appended to
    ``topic`` (default ``telemetry-metrics``), keyed by host tag —
    durable, replayable, shared-filesystem-wide. A final snapshot is
    flushed on :meth:`stop` so short-lived jobs still leave a record.
    """

    def __init__(self, topic: str = "telemetry-metrics",
                 interval_s: float = 10.0,
                 registry: Registry = REGISTRY):
        self.topic = topic
        self.interval_s = interval_s
        self._registry = registry
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._producer = None

    def _send(self) -> None:
        from hops_tpu_torch.messaging import pubsub

        if self._producer is None:
            self._producer = pubsub.Producer(self.topic)
        self._producer.send(snapshot(self._registry), key=_metrics.hosttag())

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._send()
            except Exception:  # noqa: BLE001 — export must not kill the host
                from hops_tpu_torch.runtime.logging import get_logger

                get_logger(__name__).exception("pubsub metrics export failed")

    def start(self) -> "PubsubExporter":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hops-metrics-pubsub"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self._send()  # final flush: short jobs still leave a record
        except Exception:  # noqa: BLE001 — flush is best-effort, but say so
            from hops_tpu_torch.runtime.logging import get_logger

            get_logger(__name__).exception("final pubsub metrics flush failed")

    def __enter__(self) -> "PubsubExporter":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
