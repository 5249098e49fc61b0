"""Search index — the `hops.elasticsearch` twin.

The reference exposes per-project Elasticsearch connection config for
Spark↔ES pipelines (``get_elasticsearch_config(index)``, reference:
notebooks/spark/Elasticsearch-python.ipynb:72,123; SURVEY.md §2.2).
The TPU build keeps the config-provider surface for external clusters
and adds what the platform actually used ES for — searching runs, logs
and metadata — as an embedded inverted index over JSON documents in the
project tree, so `index → document → search` works with zero external
services.
"""

from __future__ import annotations

import json
import re
import threading
from collections import defaultdict
from pathlib import Path
from typing import Any

from hops_tpu_torch.runtime import fs

_TOKEN = re.compile(r"[a-z0-9_]+")
_lock = threading.Lock()


def get_elasticsearch_config(index: str) -> dict[str, str]:
    """Connector config for an external ES cluster (reference shape:
    host/port/auth keys consumed by the Spark connector). Point at a
    real cluster via ``HOPS_TPU_ES_HOST``/``HOPS_TPU_ES_PORT``; the
    embedded index below needs none of this."""
    import os

    return {
        "es.nodes": os.environ.get("HOPS_TPU_ES_HOST", "localhost"),
        "es.port": os.environ.get("HOPS_TPU_ES_PORT", "9200"),
        "es.resource": f"{fs.project_name()}_{index}/_doc",
        "es.net.http.auth.user": fs.project_user(),
        "es.index.auto.create": "true",
    }


class SearchIndex:
    """Embedded inverted index over JSON docs, persisted per project."""

    def __init__(self, name: str):
        self.name = name
        self.dir = Path(fs.project_path(f"SearchIndex/{name}"))
        self.dir.mkdir(parents=True, exist_ok=True)
        self._docs_file = self.dir / "docs.jsonl"

    @staticmethod
    def _tokens(value: Any) -> set[str]:
        return set(_TOKEN.findall(json.dumps(value, default=str).lower()))

    def index_document(self, doc_id: str, doc: dict[str, Any]) -> None:
        with _lock, self._docs_file.open("a") as f:
            f.write(json.dumps({"_id": doc_id, "_source": doc}, default=str) + "\n")

    def _scan(self) -> dict[str, dict[str, Any]]:
        docs: dict[str, dict[str, Any]] = {}
        if self._docs_file.exists():
            for line in self._docs_file.read_text().splitlines():
                rec = json.loads(line)
                docs[rec["_id"]] = rec["_source"]  # last write wins
        return docs

    def get(self, doc_id: str) -> dict[str, Any] | None:
        return self._scan().get(doc_id)

    def count(self) -> int:
        return len(self._scan())

    def search(self, query: str, limit: int = 10) -> list[dict[str, Any]]:
        """Rank docs by matched-term count (ES-style hit envelopes)."""
        terms = set(_TOKEN.findall(query.lower()))
        scores: dict[str, int] = defaultdict(int)
        docs = self._scan()
        for doc_id, src in docs.items():
            hit = len(terms & self._tokens(src))
            if hit:
                scores[doc_id] = hit
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
        return [
            {"_id": doc_id, "_score": score, "_source": docs[doc_id]}
            for doc_id, score in ranked
        ]

    def delete(self) -> None:
        fs.rmr(self.dir)


def index_run(run_meta: dict[str, Any]) -> None:
    """Index an experiment-run record for search (what the platform's
    Experiments UI used ES for)."""
    SearchIndex("experiments").index_document(str(run_meta.get("run_id")), run_meta)


def search_runs(query: str, limit: int = 10) -> list[dict[str, Any]]:
    return SearchIndex("experiments").search(query, limit)
