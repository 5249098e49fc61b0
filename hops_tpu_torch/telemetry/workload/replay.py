"""Workload replay: re-issue a captured stream against any live config
(a copy of ``hops_tpu/telemetry/workload/replay.py``).

The artifact is the experiment: :func:`replay` re-runs yesterday's
traffic — or a synthesized scenario — against a single
server, a fleet, or an LM engine at ``--replay-speed`` multiples.
Three layers:

- :func:`load_artifact` — verify the manifest (every segment's size
  and SHA-256, the checkpoint-manifest discipline) and parse the
  records; bitrot raises :class:`WorkloadCorruptError` with the
  offending file instead of replaying garbage.
- :func:`issued_stream` — the deterministic half: for each record,
  the intended issue offset (recorded inter-arrivals compressed by
  ``speed``) and the materialized body — recorded payloads verbatim,
  capped payloads re-materialized from ``(seed, seq)`` via SHA-256
  (platform-stable, same artifact + same seed ⇒ byte-identical
  stream; the determinism test pins this).
- :func:`replay` — the open-loop runner: a pacer thread sleeps until
  each intended offset and hands the request to a worker pool (late
  completions never delay later arrivals — open loop is the point),
  then the report compares recorded vs replayed status mix,
  throughput, and latency percentiles, plus arrival fidelity:
  achieved vs intended inter-arrival error (p50 error as a fraction
  of the intended p50 gap — the <10%-at-1x acceptance bound).

Replayed per-tenant metrics flow through a ``tenant_label`` collapser
(the fleet router's ``limiter.label_for``) so replaying a
tenant-spray capture cannot mint unbounded metric children.
Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import random
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable

from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY
from hops_tpu_torch.telemetry.workload.capture import SCHEMA

log = get_logger(__name__)

_m_replayed = REGISTRY.counter(
    "hops_tpu_workload_replayed_requests_total",
    "Requests re-issued by the workload replay engine, per collapsed "
    "tenant label (explicitly configured tenants keep their own child; "
    "everyone else folds into `default` via limiter.label_for)",
    labels=("tenant",),
)


class WorkloadCorruptError(RuntimeError):
    """A workload artifact failed its manifest integrity check —
    refusing to replay it (the checkpoint-corruption contract)."""


def load_artifact(path: str | Path, *, verify: bool = True) -> dict[str, Any]:
    """Load ``{"manifest", "records"}`` from an artifact directory.

    ``verify=True`` (default) checks every manifested segment's byte
    size and SHA-256 before parsing — a flipped bit raises
    :class:`WorkloadCorruptError` naming the segment, never a silent
    half-replay. Records come back sorted by ``t_mono``.
    """
    path = Path(path)
    manifest_path = path / "manifest.json"
    if not manifest_path.exists():
        raise WorkloadCorruptError(
            f"workload artifact {path} has no manifest.json — not a "
            "capture/synthesis output (or its finalization never ran)"
        )
    try:
        manifest = json.loads(manifest_path.read_text())
    except ValueError as e:
        raise WorkloadCorruptError(
            f"workload artifact {path}: manifest.json is not valid JSON "
            f"({e}) — refusing to replay"
        ) from e
    if manifest.get("schema") != SCHEMA:
        raise WorkloadCorruptError(
            f"workload artifact {path}: schema "
            f"{manifest.get('schema')!r} != {SCHEMA!r} — wrong or "
            "future artifact version; re-capture with this build"
        )
    records: list[dict[str, Any]] = []
    for seg in manifest.get("segments", []):
        seg_path = path / seg["file"]
        try:
            data = seg_path.read_bytes()
        except OSError as e:
            raise WorkloadCorruptError(
                f"workload artifact {path}: manifested segment "
                f"{seg['file']} is unreadable ({e}) — refusing to "
                "replay a partial capture"
            ) from e
        if verify:
            if len(data) != seg["bytes"]:
                raise WorkloadCorruptError(
                    f"workload artifact {path}: segment {seg['file']} is "
                    f"{len(data)} bytes, manifest says {seg['bytes']} — "
                    "truncated or appended-to after finalization; "
                    "refusing to replay (re-capture, or drop the "
                    "segment from manifest.json to accept the loss)"
                )
            digest = hashlib.sha256(data).hexdigest()
            if digest != seg["sha256"]:
                raise WorkloadCorruptError(
                    f"workload artifact {path}: segment {seg['file']} "
                    f"fails its SHA-256 check (bitrot) — refusing to "
                    "replay (re-capture, or drop the segment from "
                    "manifest.json to accept the loss)"
                )
        for line in data.splitlines():
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError as e:
                if verify:
                    # The checksum passed but a line won't parse: the
                    # manifest itself lied (or the writer was broken).
                    raise WorkloadCorruptError(
                        f"workload artifact {path}: segment {seg['file']} "
                        f"holds an unparsable record ({e}) despite a "
                        "passing checksum — refusing to replay"
                    ) from e
                log.warning("workload artifact %s: skipping unparsable "
                            "record in %s (verify=False)", path, seg["file"])
    records.sort(key=lambda r: (r.get("t_mono", 0.0), r.get("seq", 0)))
    return {"manifest": manifest, "records": records}


# -- deterministic re-materialization ------------------------------------------


def _rng_for(seed: int, seq: int) -> random.Random:
    # SHA-256, not hash(): str-hash is salted per process on 3.3+ and
    # tuple seeds drifted across versions — the faultinject lesson.
    digest = hashlib.sha256(f"workload:{seed}:{seq}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def materialize_payload(rec: dict[str, Any], seed: int) -> dict[str, Any]:
    """The request body to issue for ``rec``: the recorded payload
    verbatim when capture kept it, else a deterministic same-shape
    re-materialization from ``(seed, rec.seq)``."""
    if rec.get("payload") is not None:
        return rec["payload"]
    rng = _rng_for(seed, int(rec.get("seq", 0)))
    if rec.get("prompt_lens"):
        # LM request: regenerate token ids at the recorded lengths and
        # decode budgets (greedy + seed 0 keeps the replay itself
        # deterministic on the serving side).
        instances = [
            {"prompt": [rng.randrange(256) for _ in range(n)],
             "max_new_tokens": budget, "seed": 0}
            for n, budget in zip(
                rec["prompt_lens"],
                rec.get("budgets") or [32] * len(rec["prompt_lens"]))
        ]
        return {"instances": instances}
    if rec.get("entity_keys"):
        # Feature-join request: the entity-ID dicts were captured
        # verbatim (skew is the workload) — reuse them.
        return {"instances": rec["entity_keys"]}
    summary = rec.get("payload_summary") or {}
    n = int(summary.get("instances", 1))
    inst = summary.get("instance") or {}
    if inst.get("kind") == "list" and inst.get("shape"):
        # The summary's shape is ONE instance's shape (homogeneous
        # batches are the serving contract) — rebuild n of it.
        def build(shape: list[int]) -> Any:
            if len(shape) == 1:
                return [round(rng.uniform(-1.0, 1.0), 6)
                        for _ in range(shape[0])]
            return [build(shape[1:]) for _ in range(shape[0])]

        return {"instances": [build(list(inst["shape"]))
                              for _ in range(n)]}
    if inst.get("kind") == "dict" and inst.get("keys"):
        return {"instances": [
            {k: rng.randrange(1 << 16) for k in inst["keys"]}
            for _ in range(n)
        ]}
    return {"instances": [[round(rng.uniform(-1.0, 1.0), 6)]
                          for _ in range(n)]}


def materialize_body(rec: dict[str, Any],
                     seed: int) -> tuple[bytes, dict[str, str]]:
    """``(body_bytes, headers)`` for one record — the wire-level twin of
    :func:`materialize_payload`.

    Records captured off the packed wire (``wire_format: "packed"``)
    re-encode as a packed columnar frame in the summary's recorded
    dtype, with the matching ``Content-Type`` — a packed-body capture
    replays as packed traffic, not as a JSON approximation of it.
    Everything else serializes to canonical JSON. Deterministic: same
    record + same seed ⇒ identical bytes (the determinism test pins
    this)."""
    payload = materialize_payload(rec, seed)
    if rec.get("wire_format") == "packed":
        # Lazy import: wirecodec pulls numpy, which replay's stdlib-only
        # consumers only need when a packed record is actually present.
        import numpy as np

        from hops_tpu_torch.runtime import wirecodec

        summary = rec.get("payload_summary") or {}
        try:
            arr = np.asarray(payload.get("instances"),
                             dtype=np.dtype(summary.get("dtype", "<f4")))
            frame = wirecodec.encode_frame([("instances", arr)])
        except (wirecodec.WireCodecError, TypeError, ValueError) as e:
            log.warning("workload replay: packed record seq=%s did not "
                        "re-encode (%s); issuing JSON instead",
                        rec.get("seq"), e)
        else:
            return frame, {"Content-Type": wirecodec.MEDIA_TYPE,
                           "Accept": wirecodec.MEDIA_TYPE}
    body = json.dumps(payload, separators=(",", ":"),
                      sort_keys=True).encode()
    return body, {"Content-Type": "application/json"}


def issued_stream(
    records: list[dict[str, Any]], *, seed: int = 0, speed: float = 1.0,
) -> list[dict[str, Any]]:
    """The deterministic issue plan: per record, the intended offset
    from replay start (recorded inter-arrivals divided by ``speed``),
    the serialized body, and the headers. Same records + same seed ⇒
    byte-identical plan (the determinism test pins this)."""
    if speed <= 0:
        raise ValueError(f"replay speed must be > 0, got {speed}")
    if not records:
        return []
    t0 = records[0].get("t_mono", 0.0)
    plan = []
    for rec in records:
        body, headers = materialize_body(rec, seed)
        if rec.get("tenant"):
            headers["X-Tenant"] = str(rec["tenant"])
        plan.append({
            "seq": rec.get("seq"),
            "offset_s": max(0.0, (rec.get("t_mono", t0) - t0)) / speed,
            "endpoint": rec.get("endpoint"),
            "tenant": rec.get("tenant"),
            "body": body,
            "headers": headers,
        })
    return plan


# -- the open-loop runner ------------------------------------------------------


def _http_target(base_url: str, timeout_s: float) -> Callable[..., int]:
    url = base_url.rstrip("/")
    if not url.endswith("/predict"):
        url = url + "/predict"

    def send(item: dict[str, Any]) -> int:
        req = urllib.request.Request(
            url, data=item["body"], headers=item["headers"])
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                resp.read()
                return resp.status
        except urllib.error.HTTPError as e:
            e.read()
            return e.code

    return send


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


class ReplayReport(dict):
    """The replay result: a plain dict (JSON-able as-is) with the
    recorded-vs-replayed comparison and arrival-fidelity stats."""


def _stream_stats(statuses: list[int], latencies_ms: list[float],
                  duration_s: float) -> dict[str, Any]:
    mix: dict[str, int] = {}
    for s in statuses:
        mix[str(s)] = mix.get(str(s), 0) + 1
    out: dict[str, Any] = {
        "requests": len(statuses),
        "status_mix": dict(sorted(mix.items())),
        "duration_s": round(duration_s, 4),
        "rps": round(len(statuses) / duration_s, 2) if duration_s > 0 else 0.0,
    }
    if latencies_ms:
        out["latency_p50_ms"] = round(_percentile(latencies_ms, 0.50), 3)
        out["latency_p99_ms"] = round(_percentile(latencies_ms, 0.99), 3)
    return out


def recorded_stats(records: list[dict[str, Any]]) -> dict[str, Any] | None:
    """The recorded side of the comparison — None for synthetic
    artifacts that carry no outcomes."""
    statuses = [r["status"] for r in records if r.get("status") is not None]
    if not statuses:
        return None
    latencies = [float(r["latency_ms"]) for r in records
                 if r.get("latency_ms") is not None]
    monos = [r["t_mono"] for r in records if "t_mono" in r]
    duration = (max(monos) - min(monos)) if len(monos) > 1 else 0.0
    return _stream_stats(statuses, latencies, max(duration, 1e-9))


def replay(
    records: list[dict[str, Any]],
    target: str | Callable[[dict[str, Any]], int],
    *,
    speed: float = 1.0,
    seed: int = 0,
    max_workers: int | None = None,
    request_timeout_s: float = 30.0,
    tenant_label: Callable[[str], str] | None = None,
) -> ReplayReport:
    """Open-loop replay of ``records`` against ``target`` (a base URL
    POSTed at ``/predict``, or a callable ``send(item) -> status``).

    The pacer holds the intended schedule regardless of response
    latency (slow responses consume pool workers, never delay
    arrivals); per-request results land in the report's
    ``replayed``/``arrival`` sections next to the ``recorded``
    baseline. ``max_workers`` defaults to the plan size (capped at
    512): a 32-thread default would quietly re-serialize anything past
    32 in flight and a thundering-herd burst would never land as one —
    an exhausted pool is exactly the open-loop violation this knob
    exists to avoid (the per-request ``achieved`` stamps record any
    residual slip either way). ``tenant_label`` collapses the
    per-tenant replay counter exactly like the router's rate-limit
    labels — pass ``router.limiter.label_for`` when replaying into a
    fleet."""
    plan = issued_stream(records, seed=seed, speed=speed)
    send = target if callable(target) else _http_target(
        target, request_timeout_s)
    if max_workers is None:
        max_workers = min(512, max(32, len(plan)))
    elif len(plan) > max_workers:
        log.warning(
            "workload replay: %d requests over a %d-worker pool — "
            "bursts wider than the pool will issue late (open-loop "
            "fidelity degrades; see the arrival error stats)",
            len(plan), max_workers)
    label = tenant_label if tenant_label is not None else (
        lambda tenant: "default")

    results: list[dict[str, Any]] = []
    results_lock = threading.Lock()

    def issue(item: dict[str, Any], intended: float, t0: float) -> None:
        achieved = time.monotonic() - t0
        t_req = time.perf_counter()
        try:
            status = send(item)
            error = None
        except Exception as e:  # noqa: BLE001 — a replay error is a data point
            status, error = -1, f"{type(e).__name__}: {e}"
        latency_ms = (time.perf_counter() - t_req) * 1e3
        _m_replayed.inc(tenant=label(item.get("tenant") or ""))
        row = {"seq": item["seq"], "intended_s": intended,
               "achieved_s": achieved, "status": status,
               "latency_ms": latency_ms}
        if error is not None:
            row["error"] = error
        with results_lock:
            results.append(row)

    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix="workload-replay")
    t0 = time.monotonic()
    try:
        for item in plan:
            delay = item["offset_s"] - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            pool.submit(issue, item, item["offset_s"], t0)
    finally:
        pool.shutdown(wait=True)
    wall = time.monotonic() - t0

    results.sort(key=lambda r: r["intended_s"])
    statuses = [r["status"] for r in results]
    latencies = [r["latency_ms"] for r in results if r["status"] >= 0]
    intended_gaps = [
        b["intended_s"] - a["intended_s"]
        for a, b in zip(results, results[1:])
    ]
    achieved_gaps = [
        b["achieved_s"] - a["achieved_s"]
        for a, b in zip(results, results[1:])
    ]
    gap_errors = [abs(a - i) for a, i in zip(achieved_gaps, intended_gaps)]
    p50_gap = _percentile(intended_gaps, 0.50)
    p50_err = _percentile(gap_errors, 0.50)
    report = ReplayReport(
        speed=speed,
        seed=seed,
        replayed=_stream_stats(statuses, latencies, max(wall, 1e-9)),
        arrival={
            "intended_interarrival_p50_ms": round(p50_gap * 1e3, 3),
            "achieved_error_p50_ms": round(p50_err * 1e3, 3),
            "achieved_error_p95_ms": round(
                _percentile(gap_errors, 0.95) * 1e3, 3),
            # The acceptance bound: p50 |achieved - intended| gap error
            # as a fraction of the intended p50 gap (< 0.10 at 1x).
            "p50_error_frac": round(p50_err / p50_gap, 4) if p50_gap > 0
            else 0.0,
        },
        errors=sum(1 for s in statuses if s < 0),
    )
    recorded = recorded_stats(records)
    if recorded is not None:
        report["recorded"] = recorded
    return report
