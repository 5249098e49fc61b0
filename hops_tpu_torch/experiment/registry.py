"""Experiments registry — the local equivalent of the Hopsworks
Experiments service the reference registered every run with
(SURVEY.md §3.1 "registers run in Experiments service").

Backed by an append-only JSONL index in the project's Experiments
dataset; the latest record per run_id wins, so status transitions
(RUNNING -> FINISHED/FAILED) are appends, not rewrites.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

from hops_tpu_torch.runtime import fs


def _index_path() -> Path:
    p = Path(fs.project_path("Experiments")) / "index.jsonl"
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


def register(record: dict[str, Any]) -> None:
    record = dict(record)
    record.setdefault("time", time.time())
    with _index_path().open("a") as f:
        f.write(json.dumps(record, default=str) + "\n")
    # Make the run findable (the platform indexed runs into ES for the
    # Experiments UI search; SURVEY.md §2.2 elasticsearch row). Indexing
    # is best-effort: the JSONL append above is the record of truth, and
    # a search-index failure must not fail run registration.
    try:
        from hops_tpu_torch.messaging import searchindex

        searchindex.index_run(record)
    except Exception as exc:  # pragma: no cover - defensive
        from hops_tpu_torch.runtime.logging import get_logger

        get_logger(__name__).warning("run search-indexing failed: %s", exc)


def list_runs(name: str | None = None) -> list[dict[str, Any]]:
    """All runs (latest record per run_id), optionally filtered by name."""
    path = _index_path()
    if not path.exists():
        return []
    latest: dict[str, dict[str, Any]] = {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        latest[rec["run_id"]] = {**latest.get(rec["run_id"], {}), **rec}
    runs = sorted(latest.values(), key=lambda r: r.get("time", 0))
    if name is not None:
        runs = [r for r in runs if r.get("name") == name]
    return runs


def get_run(run_id: str) -> dict[str, Any] | None:
    for rec in list_runs():
        if rec["run_id"] == run_id:
            return rec
    return None


def best_run(
    name: str | None = None, metric: str = "metric", direction: str = "max"
) -> dict[str, Any] | None:
    """Best finished run by a metric (the experiment-level counterpart of
    ``model.get_best_model`` — SURVEY.md §2.5)."""
    candidates = [
        r
        for r in list_runs(name)
        if r.get("status") == "FINISHED" and _metric_of(r, metric) is not None
    ]
    if not candidates:
        return None
    key = lambda r: _metric_of(r, metric)  # noqa: E731
    return max(candidates, key=key) if direction.lower() == "max" else min(candidates, key=key)


def _metric_of(rec: dict[str, Any], metric: str) -> float | None:
    m = rec.get("metrics") or {}
    v = m.get(metric, rec.get(metric))
    try:
        return float(v)
    except (TypeError, ValueError):
        return None
