"""Flight recorder: a bounded ring of the platform's last notable events.

Post-incident debugging of the chaos paths (retries, breaker trips,
preemptions, quarantines) used to mean grepping logs with no causal
thread. This module is the black box instead: every resilience and
fault-injection site appends one small structured event — monotonic
sequence number, wall time, kind, the active trace id when the event
fired under a traced request, and a payload — into a bounded in-memory
ring. Nothing is written in steady state; the ring is

- served live at ``GET /debug/flight`` (telemetry/export.py mounts it
  beside ``/metrics`` on every serving, replica, and router port), and
- **dumped to the rundir on unhandled failure** once
  :func:`install_crash_handler` has chained itself into
  ``sys.excepthook`` / ``threading.excepthook`` (``run_preemptible``
  does this), so a crashed host leaves its last-N-events story behind.

Event kinds are a closed, documented catalog — docs/operations.md
"Tracing & debugging" lists every kind, and the graftlint
``debug-surface-docs`` rule keeps code and catalog honest. Current
kinds: ``fault_fired``, ``retry``, ``giveup``, ``deadline_exceeded``,
``breaker_transition``, ``drain``, ``quarantine``, ``preemption``,
``recovery``, ``replica_state``, ``rollout``, ``dispatch_failure``,
``span_replayed``, ``eval_gate``, ``cutover``, ``crash``,
``partition``, ``fence``, ``generation``, ``generation_rejected``.

Stdlib-only (this is imported by the same hot paths ``faultinject``
rides); the trace-id peek goes through ``telemetry.tracing``, which is
stdlib-only too.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any

from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry import tracing

log = get_logger(__name__)

def _env_capacity(default: int = 2048) -> int:
    # Malformed env must degrade to the default, not kill every process
    # that imports this module (tracing._env_float holds the same line).
    try:
        return int(os.environ.get("HOPS_TPU_FLIGHT_RING", default))
    except ValueError:
        return default


#: Default ring capacity (events, not bytes — events are small dicts).
DEFAULT_CAPACITY = _env_capacity()


class FlightRecorder:
    """Thread-safe bounded ring of structured events.

    One process-global :data:`FLIGHT` serves the stack; tests may build
    private ones. ``record`` is cheap (one lock + deque append) and
    NEVER raises — the black box must not take the plane down.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        # RLock, not Lock: record() is called from signal handlers
        # (PreemptionGuard), which run on the main thread — if that
        # thread was itself inside record() when the signal landed, a
        # plain Lock would deadlock on re-acquire.
        self._lock = threading.RLock()
        self._seq = 0  # guarded by: self._lock
        # guarded by: self._lock
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def record(self, kind: str, **data: Any) -> dict[str, Any] | None:
        """Append one event; returns it (None if recording failed —
        swallowed by contract, a diagnostic layer must never fail the
        operation it observes)."""
        try:
            event: dict[str, Any] = {
                "time": time.time(),
                "kind": kind,
                "trace_id": tracing.current_trace_id(),
                "data": data,
            }
            with self._lock:
                self._seq += 1
                event["seq"] = self._seq
                self._ring.append(event)
            return event
        except Exception:  # graftlint: disable=swallowed-exception
            return None  # by contract: see docstring

    def events(self, kind: str | None = None,
               after_seq: int = 0) -> list[dict[str, Any]]:
        """Events in causal (sequence) order, optionally filtered by
        kind and/or newer-than ``after_seq`` (how tests scope to their
        own run against the process-global ring)."""
        with self._lock:
            rows = list(self._ring)
        return [
            e for e in rows
            if e["seq"] > after_seq and (kind is None or e["kind"] == kind)
        ]

    @property
    def seq(self) -> int:
        """The newest sequence number (0 = empty): snapshot this before
        an operation, then ``events(after_seq=...)`` scopes to it."""
        with self._lock:
            return self._seq

    def snapshot(self) -> dict[str, Any]:
        """The JSON body ``GET /debug/flight`` serves."""
        events = self.events()
        return {
            "time": time.time(),
            "pid": os.getpid(),
            "capacity": self.capacity,
            "events": events,
        }

    def dump(self, path: str | Path | None = None,
             reason: str = "manual") -> Path | None:
        """Write the ring to ``path`` (default: the active rundir's
        logdir, ``flight_<pid>.json``). Returns the written path, or
        None on failure — dumping happens on the way DOWN; it must not
        mask the original crash."""
        try:
            if path is None:
                from hops_tpu_torch.runtime import rundir

                path = Path(rundir.logdir()) / f"flight_{os.getpid()}.json"
            path = Path(path)
            path.parent.mkdir(parents=True, exist_ok=True)
            body = self.snapshot()
            body["reason"] = reason
            path.write_text(json.dumps(body, indent=2, default=str))
            log.warning("flight recorder dumped %d event(s) to %s (%s)",
                        len(body["events"]), path, reason)
            return path
        except Exception:  # graftlint: disable=swallowed-exception
            # By contract: a crash-path dump failure must not replace
            # the original exception — it is already being reported.
            return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


#: The process-global recorder every subsystem records into.
FLIGHT = FlightRecorder()


def _crash_flush_workload(dump_path: Path | None) -> Path | None:
    """Crash-path companion to the flight dump: finalize any active
    workload-capture segment and manifest (so the crashed run's
    traffic is replayable post-mortem) and leave a pointer file next
    to the flight dump naming the artifact. Never raises — this runs
    on the way DOWN."""
    try:
        from hops_tpu_torch.telemetry import workload

        artifact = workload.crash_flush()
        if artifact is None:
            return None
        log.warning("workload capture flushed for post-mortem replay: %s",
                    artifact)
        if dump_path is not None:
            pointer = Path(dump_path).with_name(
                f"workload_{os.getpid()}.json")
            pointer.write_text(json.dumps(
                {"workload_artifact": str(artifact),
                 "flight_dump": str(dump_path)}, indent=2))
        return artifact
    except Exception:  # graftlint: disable=swallowed-exception
        # By contract: a crash-path flush failure must not replace the
        # original exception — it is already being reported.
        return None


def record(kind: str, **data: Any) -> dict[str, Any] | None:
    """Record onto the process-global :data:`FLIGHT` ring."""
    return FLIGHT.record(kind, **data)


_install_lock = threading.Lock()
_installed = False  # guarded by: _install_lock


def install_crash_handler() -> bool:
    """Chain the flight-recorder dump into ``sys.excepthook`` and
    ``threading.excepthook``: any unhandled exception records a
    ``crash`` event, dumps the ring to the rundir, and finalizes any
    active workload-capture segment + manifest (with a
    ``workload_<pid>.json`` pointer next to the flight dump) so the
    crashed run's traffic is replayable post-mortem — all before the
    previous hook runs. Idempotent; returns True when this call
    installed it."""
    global _installed
    with _install_lock:
        if _installed:
            return False
        _installed = True
        prev_sys = sys.excepthook
        prev_threading = threading.excepthook

        def _sys_hook(exc_type, exc, tb):
            FLIGHT.record("crash", where="main",
                          error=f"{exc_type.__name__}: {exc}")
            dumped = FLIGHT.dump(reason=f"unhandled {exc_type.__name__}")
            _crash_flush_workload(dumped)
            prev_sys(exc_type, exc, tb)

        def _threading_hook(args):
            FLIGHT.record(
                "crash",
                where=getattr(args.thread, "name", "?"),
                error=f"{args.exc_type.__name__}: {args.exc_value}",
            )
            dumped = FLIGHT.dump(reason=f"unhandled {args.exc_type.__name__} "
                                        f"in thread")
            _crash_flush_workload(dumped)
            prev_threading(args)

        sys.excepthook = _sys_hook
        threading.excepthook = _threading_hook
        return True
