"""Workload capture: the request stream as a replayable artifact
(a copy of ``hops_tpu/telemetry/workload/capture.py``).

Every perf or chaos question used to be answered with synthetic
Poisson load because the real workload — who arrived when, with what —
evaporates after every run. The :class:`WorkloadRecorder` writes one
JSON line per request into an append-only segment stream:

- **Versioned schema** (:data:`SCHEMA`): each record carries ``v``, a
  process-monotonic ``seq``, ``t_mono``/``t_wall`` arrival stamps, the
  ``surface`` that saw it (``router`` | ``serving`` | ``synthetic``),
  ``endpoint``/``path``/``tenant``, the payload (full body when its
  JSON serialization fits ``payload_cap_bytes``, a shape summary
  above that — instance count plus per-instance shape/keys, enough
  for the replay engine's seeded re-materialization), ``entity_keys``
  (the entity-ID dicts of feature-join requests, kept verbatim — skew
  is the workload), ``prompt_lens``/``budgets`` for LM requests, and
  the outcome: ``status``, ``latency_ms``, ``trace_id`` cross-link.
- **Rotation + manifest**: segments rotate at ``segment_bytes``; each
  finalized segment's size and SHA-256 land in ``manifest.json``
  (atomic replace), the same integrity discipline as checkpoint
  manifests — replay refuses bitrot instead of replaying garbage.
- **Crash flush**: :func:`crash_flush` (chained into
  ``flight.install_crash_handler``) finalizes the open segment and
  manifest so a crashed run's traffic is replayable post-mortem.

Arming: ``HOPS_TPU_WORKLOAD_CAPTURE=<dir>`` at import (value ``1`` /
``true`` picks a pid-suffixed directory under ``$TMPDIR``), or
:func:`start_capture` / ``POST /admin/capture/start`` at runtime;
``POST /admin/capture/stop`` finalizes. Status (armed, segments,
requests, bytes, drops) is served at ``GET /debug/workload``.

The disabled path must cost nothing: hot call sites guard with
``if workload.capturing():`` — one module-global read — before
building any record (the contract ``faultinject.fire`` and tracing
keep).
Stdlib-only: this is imported by serving hosts and the fleet router.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any

from hops_tpu_torch.runtime import faultinject
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

#: Artifact schema identifier; bump the suffix on breaking changes.
SCHEMA = "hops-tpu-workload/1"
#: Per-record schema version (travels on every line).
RECORD_VERSION = 1

DEFAULT_SEGMENT_BYTES = 4 << 20  # 4 MiB per segment before rotation
DEFAULT_PAYLOAD_CAP = 4096  # full-body capture cap (serialized bytes)

_m_captured = REGISTRY.counter(
    "hops_tpu_workload_captured_requests_total",
    "Requests recorded into the active workload-capture artifact, per "
    "capture surface (router | serving | synthetic)",
    labels=("surface",),
)
_m_dropped = REGISTRY.counter(
    "hops_tpu_workload_capture_dropped_total",
    "Requests the workload recorder failed to record (capture must "
    "never fail the request it observes)",
)
_m_segments = REGISTRY.counter(
    "hops_tpu_workload_capture_segments_total",
    "Workload-capture segments finalized into the artifact manifest",
)
_m_active = REGISTRY.gauge(
    "hops_tpu_workload_capture_active",
    "1 while this process is capturing its request stream, else 0 "
    "(the fleet router scrapes this for per-replica capture status)",
)


def _summarize_instance(inst: Any) -> dict[str, Any]:
    """Shape summary of one instance — enough structure for the replay
    engine to re-materialize a same-shape payload from a seed."""
    if isinstance(inst, dict):
        return {"kind": "dict", "keys": sorted(str(k) for k in inst)}
    if isinstance(inst, (list, tuple)):
        shape: list[int] = []
        probe: Any = inst
        while isinstance(probe, (list, tuple)):
            shape.append(len(probe))
            probe = probe[0] if probe else None
        return {"kind": "list", "shape": shape}
    return {"kind": type(inst).__name__}


def summarize_payload(payload: Any, cap_bytes: int) -> tuple[Any, Any]:
    """``(payload, None)`` when the serialized body fits ``cap_bytes``,
    else ``(None, summary)`` — byte size, instance count, and the first
    instance's shape (homogeneous batches are the serving contract)."""
    try:
        serialized = json.dumps(payload, default=str)
    except (TypeError, ValueError):
        return None, {"kind": "unserializable"}
    if len(serialized) <= cap_bytes:
        return payload, None
    summary: dict[str, Any] = {"bytes": len(serialized)}
    instances = payload.get("instances") if isinstance(payload, dict) else None
    if isinstance(instances, list):
        summary["instances"] = len(instances)
        if instances:
            summary["instance"] = _summarize_instance(instances[0])
    return None, summary


class WorkloadRecorder:
    """Append-only JSONL segment stream with rotation and a
    size+SHA-256 manifest. Thread-safe; :meth:`record` never raises
    past its own drop counter (capture must not fail the request)."""

    def __init__(
        self,
        directory: str | Path,
        *,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        payload_cap_bytes: int = DEFAULT_PAYLOAD_CAP,
        meta: dict[str, Any] | None = None,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        # Refuse a directory that already holds an artifact: appending
        # would clobber the old manifest and merge two processes'
        # records — whose t_mono stamps come from UNRELATED monotonic
        # clocks, so the merged stream's inter-arrival gaps are garbage
        # (a replay could sleep for days on one). One capture, one dir.
        existing = sorted(
            p.name for p in self.directory.glob("segment_*.jsonl"))
        if (self.directory / "manifest.json").exists() or existing:
            raise FileExistsError(
                f"{self.directory} already holds a workload artifact "
                f"({existing[:3] or ['manifest.json']}...) — captures "
                "never append across runs (their monotonic clocks don't "
                "compose); pick a fresh directory"
            )
        self.segment_bytes = int(segment_bytes)
        self.payload_cap_bytes = int(payload_cap_bytes)
        self._lock = threading.Lock()
        # guarded by: self._lock
        self._seq = 0
        self._segment_index = 0  # guarded by: self._lock
        self._segment_requests = 0  # guarded by: self._lock
        self._segment_first_seq = 1  # guarded by: self._lock
        self._bytes_written = 0  # guarded by: self._lock
        self._total_requests = 0  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock
        self._manifest: dict[str, Any] = {
            "schema": SCHEMA,
            "created_wall": time.time(),
            "meta": dict(meta or {}),
            "closed": False,
            "segments": [],
        }  # guarded by: self._lock
        # Unbuffered: a failed write surfaces at the write itself (never
        # at a later flush), so the accounted byte count is always an
        # exact on-disk prefix and _resync_locked can truncate to it.
        self._fh = open(self._segment_path(0), "ab", buffering=0)  # guarded by: self._lock
        #: Helper threads fsync-publishing rolled segments; stop() joins
        #: them so the closed manifest holds every segment.
        self._publishers: list[threading.Thread] = []  # guarded by: self._lock
        # Running digest of the open segment, updated per written line:
        # finalization is O(1) — no 4 MiB read-back + re-hash while
        # request threads queue on the recorder lock.
        self._segment_hash = hashlib.sha256()  # guarded by: self._lock
        self._write_manifest_locked()

    # -- paths / manifest (call with self._lock held) -------------------------

    def _segment_path(self, index: int) -> Path:
        return self.directory / f"segment_{index:06d}.jsonl"

    def _write_manifest_locked(self) -> None:  # guarded by: self._lock
        tmp = self.directory / f"manifest.json.tmp{os.getpid()}"
        tmp.write_text(json.dumps(self._manifest, indent=2))
        os.replace(tmp, self.directory / "manifest.json")

    def _detach_segment_locked(  # guarded by: self._lock
        self, open_next: bool = True
    ) -> dict[str, Any]:
        """Swap the full segment out of the recorder state and open its
        successor, so :meth:`_publish_segment` can fsync and manifest it
        WITHOUT the lock. The entry's accounting (bytes, hash, seq
        range) is final at detach time — nothing writes to a detached
        handle — only its durability is still pending."""
        path = self._segment_path(self._segment_index)
        seg = {
            "fh": self._fh,
            "path": path,
            "entry": {
                "file": path.name,
                "bytes": self._bytes_written,
                "sha256": self._segment_hash.hexdigest(),
                "requests": self._segment_requests,
                "first_seq": self._segment_first_seq,
                "last_seq": self._seq,
            },
        }
        if open_next:
            self._open_next_segment_locked()
        else:
            self._fh = None  # closed recorder: _closed gates every write
        return seg

    def _publish_segment(self, seg: dict[str, Any]) -> None:
        """Make a detached segment durable, then manifest it.

        The fsync runs OUTSIDE the recorder lock — request threads used
        to queue behind a disk flush on every hot-path segment roll
        (graftlint: blocking-under-lock). The manifest entry lands only
        after the bytes are durable, so a crash can never leave the
        manifest referencing an unsynced segment; entries are kept
        sorted by ``first_seq`` because publishes may complete out of
        detach order."""
        fh = seg["fh"]
        try:
            faultinject.fire("workload.publish")  # chaos: slow disk
            fh.flush()
            os.fsync(fh.fileno())
        finally:
            fh.close()
        if seg["entry"]["requests"] == 0:
            seg["path"].unlink(missing_ok=True)
            return
        with self._lock:
            segments = self._manifest["segments"]
            segments.append(seg["entry"])
            segments.sort(key=lambda s: s["first_seq"])
            self._write_manifest_locked()
        _m_segments.inc()

    def _resync_locked(self) -> None:  # guarded by: self._lock
        """Recover from a failed record write: a partially-flushed line
        would desynchronize the file from the running hash/byte
        counters, and the NEXT finalized manifest would then refuse its
        own segment at replay. Drop the Python buffer, truncate the
        file back to the accounted length, and reopen; if even that
        fails (the disk is gone), close the recorder — a capture that
        can't stay consistent must stop, not poison its manifest."""
        path = self._segment_path(self._segment_index)
        try:
            try:
                self._fh.close()  # close() may re-attempt the bad flush
            except OSError:
                pass
            os.truncate(path, self._bytes_written)
            self._fh = open(path, "ab", buffering=0)
        except OSError:
            self._closed = True
            log.warning("workload capture: could not resync %s after a "
                        "failed write; capture stopped", path)

    def _open_next_segment_locked(self) -> None:  # guarded by: self._lock
        self._segment_index += 1
        self._segment_requests = 0
        self._segment_first_seq = self._seq + 1
        self._bytes_written = 0
        self._segment_hash = hashlib.sha256()
        self._fh = open(self._segment_path(self._segment_index), "ab",
                        buffering=0)

    # -- the capture surface --------------------------------------------------

    def record(
        self,
        *,
        surface: str,
        endpoint: str,
        path: str | None = None,
        tenant: str | None = None,
        payload: Any = None,
        instances: Any = None,
        lm_mode: bool = False,
        status: int | None = None,
        latency_ms: float | None = None,
        trace_id: str | None = None,
        t_mono: float | None = None,
        t_wall: float | None = None,
        wire_format: str | None = None,
        payload_summary: Any = None,
    ) -> dict[str, Any] | None:
        """Append one request record; returns it, or None on a drop
        (counted on ``hops_tpu_workload_capture_dropped_total`` — by
        contract a capture failure must never fail the request).

        ``payload_summary`` short-circuits :func:`summarize_payload`:
        packed-wire call sites already hold a header-only shape summary
        (the tensor body itself never JSON-serializes), so they pass it
        explicitly along with ``wire_format="packed"`` — the replayer
        re-materializes a same-shape packed frame from it."""
        try:
            if payload_summary is not None:
                body, summary = None, payload_summary
            else:
                body, summary = summarize_payload(
                    payload, self.payload_cap_bytes)
            rec: dict[str, Any] = {
                "v": RECORD_VERSION,
                "t_mono": time.monotonic() if t_mono is None else t_mono,
                "t_wall": time.time() if t_wall is None else t_wall,
                "surface": surface,
                "endpoint": endpoint,
            }
            if path:
                rec["path"] = path
            if tenant is not None:
                rec["tenant"] = tenant
            if wire_format and wire_format != "json":
                rec["wire_format"] = wire_format
            if body is not None:
                rec["payload"] = body
            if summary is not None:
                rec["payload_summary"] = summary
            if body is None and isinstance(instances, list) and instances:
                # Only for CAPPED payloads — a kept body already holds
                # the instances verbatim, and duplicating them would
                # double every feature-join record. Entity-ID keys
                # travel verbatim past the cap: key skew IS the
                # workload the feature store benches replay against.
                # The exemption is itself size-bounded — a batch of
                # WIDE dicts (full feature rows, not entity IDs) must
                # not smuggle megabytes past payload_cap_bytes; over
                # the bound the shape summary (keys + count) is what
                # replay re-materializes from.
                if all(isinstance(i, dict) and "prompt" not in i
                       for i in instances):
                    serialized_keys = json.dumps(
                        instances, separators=(",", ":"), default=str)
                    if len(serialized_keys) <= 4 * self.payload_cap_bytes:
                        rec["entity_keys"] = instances
                if lm_mode:
                    rec["prompt_lens"] = [
                        len(i.get("prompt", [])) if isinstance(i, dict)
                        else len(i)
                        for i in instances
                    ]
                    rec["budgets"] = [
                        int(i.get("max_new_tokens", 32))
                        if isinstance(i, dict) else 32
                        for i in instances
                    ]
            if status is not None:
                rec["status"] = int(status)
            if latency_ms is not None:
                rec["latency_ms"] = round(float(latency_ms), 3)
            if trace_id:
                rec["trace_id"] = trace_id
            with self._lock:
                if self._closed:
                    return None
                # seq is assigned under the lock so segments hold
                # strictly increasing sequence ranges.
                self._seq += 1
                rec["seq"] = self._seq
                line = (json.dumps(rec, separators=(",", ":"), default=str)
                        + "\n").encode()
                try:
                    self._fh.write(line)
                except Exception:
                    # ENOSPC/EIO mid-flush: part of the line may be on
                    # disk while the counters say it isn't. Resync (or
                    # stop) before the drop counter takes it.
                    self._resync_locked()
                    raise
                self._segment_hash.update(line)
                self._bytes_written += len(line)
                self._segment_requests += 1
                self._total_requests += 1
                if self._bytes_written >= self.segment_bytes:
                    # Hot-path roll: detach under the lock, fsync +
                    # manifest on a helper thread — concurrent record()
                    # calls keep appending to the fresh segment instead
                    # of queueing behind the flush. stop() joins these.
                    seg = self._detach_segment_locked()
                    t = threading.Thread(
                        target=self._publish_segment, args=(seg,),
                        daemon=True, name="workload-capture-publish",
                    )
                    self._publishers = [
                        p for p in self._publishers if p.is_alive()
                    ]
                    self._publishers.append(t)
                    t.start()
            _m_captured.inc(surface=surface)
            return rec
        except Exception:  # graftlint: disable=swallowed-exception
            _m_dropped.inc()  # by contract: see docstring
            return None

    def rotate(self) -> None:
        """Finalize the open segment into the manifest and start a new
        one — the crash-flush path: after this the artifact on disk is
        complete and replayable even if the process dies mid-write.
        Synchronous (durable on return), but the fsync itself runs with
        the lock released so concurrent record() calls don't stall."""
        with self._lock:
            if self._closed:
                return
            seg = self._detach_segment_locked()
        self._publish_segment(seg)

    def stop(self) -> Path:
        """Finalize everything; the artifact directory is the result."""
        with self._lock:
            if self._closed:
                return self.directory
            self._closed = True
            seg = self._detach_segment_locked(open_next=False)
            self._segment_requests = 0
            self._bytes_written = 0
            pending = list(self._publishers)
        self._publish_segment(seg)
        for t in pending:
            t.join()  # every in-flight roll must land before "closed"
        with self._lock:
            self._manifest["closed"] = True
            self._write_manifest_locked()
        return self.directory

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "directory": str(self.directory),
                "schema": SCHEMA,
                "requests": self._total_requests,
                "segments_finalized": len(self._manifest["segments"]),
                "open_segment_requests": self._segment_requests,
                "open_segment_bytes": self._bytes_written,
                "segment_bytes": self.segment_bytes,
                "payload_cap_bytes": self.payload_cap_bytes,
                "closed": self._closed,
            }


# -- process-global capture ----------------------------------------------------

_arm_lock = threading.Lock()
#: The armed recorder; read WITHOUT the lock on the hot path (arming
#: and disarming swap the whole reference under _arm_lock).
_RECORDER: WorkloadRecorder | None = None


def capturing() -> bool:
    """One module-global read: the hot-path guard every call site
    checks before building a record."""
    return _RECORDER is not None


def start_capture(
    directory: str | Path | None = None,
    *,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    payload_cap_bytes: int = DEFAULT_PAYLOAD_CAP,
    meta: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Arm process-global capture into ``directory`` (default: a
    pid-suffixed dir under ``$TMPDIR``). Idempotent while already
    capturing (returns the live status). Returns the capture status."""
    global _RECORDER
    with _arm_lock:
        if _RECORDER is not None:
            return status()
        if directory is None:
            directory = (Path(tempfile.gettempdir())
                         / f"hops_tpu_workload_{os.getpid()}")
        _RECORDER = WorkloadRecorder(
            directory, segment_bytes=segment_bytes,
            payload_cap_bytes=payload_cap_bytes, meta=meta,
        )
        _m_active.set(1)
        log.info("workload capture armed into %s", directory)
    return status()


def stop_capture() -> dict[str, Any] | None:
    """Disarm and finalize; returns the final status (with the
    artifact directory), or None when nothing was capturing."""
    global _RECORDER
    with _arm_lock:
        rec = _RECORDER
        if rec is None:
            return None
        _RECORDER = None
        _m_active.set(0)
    rec.stop()
    final = rec.status()
    final["capturing"] = False
    log.info("workload capture finalized: %s (%d requests, %d segments)",
             final["directory"], final["requests"],
             final["segments_finalized"])
    return final


def record_request(**fields: Any) -> None:
    """Record one request onto the armed recorder; no-op when disarmed
    (call sites guard with :func:`capturing` first, so the disarmed
    path never builds the field dict)."""
    rec = _RECORDER
    if rec is None:
        return
    rec.record(**fields)


def status() -> dict[str, Any]:
    """The ``GET /debug/workload`` body."""
    rec = _RECORDER
    if rec is None:
        return {"capturing": False}
    return {"capturing": True, **rec.status()}


def crash_flush() -> Path | None:
    """Finalize the open segment + manifest of an active capture so a
    crashed run's traffic is replayable post-mortem (chained into
    ``flight.install_crash_handler``). Capture stays armed — the crash
    may be another thread's. Returns the artifact dir, or None.
    Never raises: this runs on the way DOWN."""
    try:
        rec = _RECORDER
        if rec is None:
            return None
        rec.rotate()
        return rec.directory
    except Exception:  # graftlint: disable=swallowed-exception
        # By contract: a crash-path flush failure must not replace the
        # original exception being reported.
        return None


def admin_action(path: str, payload: dict[str, Any] | None) -> tuple[int, dict[str, Any]]:
    """The ``POST /admin/capture/{start,stop}`` control plane, shared
    by every serving endpoint and the fleet router (each mounts it in
    its own ``do_POST``). Returns ``(status_code, body)``."""
    p = path.split("?", 1)[0].rstrip("/")
    payload = payload if isinstance(payload, dict) else {}
    if p == "/admin/capture/start":
        try:
            return 200, start_capture(
                payload.get("dir"),
                segment_bytes=int(
                    payload.get("segment_bytes", DEFAULT_SEGMENT_BYTES)),
                payload_cap_bytes=int(
                    payload.get("payload_cap_bytes", DEFAULT_PAYLOAD_CAP)),
                meta=payload.get("meta"),
            )
        except (OSError, ValueError, TypeError) as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}
    if p == "/admin/capture/stop":
        final = stop_capture()
        return 200, final if final is not None else {"capturing": False}
    return 404, {"error": f"unknown admin path {path}"}


def _arm_from_env() -> None:
    value = os.environ.get("HOPS_TPU_WORKLOAD_CAPTURE", "")
    if not value or value in ("0", "false"):
        return
    directory = None if value in ("1", "true") else value
    try:
        start_capture(directory)
    except OSError as e:
        # Misconfigured env must not kill every importing process.
        log.warning("HOPS_TPU_WORKLOAD_CAPTURE=%s: capture not armed: %s",
                    value, e)


_arm_from_env()
