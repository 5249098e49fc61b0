"""Online feature store — embedded KV store for serving vectors (counterpart of
``hops_tpu/featurestore/online.py``, copied with the port's imports).

The reference's online store was MySQL Cluster (NDB) reached over JDBC
prepared statements (`td.get_serving_vector`,
feature_vector_model_serving.ipynb:175-196 — SURVEY.md §2.6, "implied
native"). The port replaces it with an embedded key-value store:
the native C++ engine in ``hops_tpu_torch/native`` (open-addressing hash index
over an append-only mmap'd log) when built, else a pure-sqlite fallback
with identical semantics. Keys are the JSON-encoded primary-key values
of a row; values are the row — packed struct records behind
``wirecodec.ROW_FORMAT_PACKED`` by default, legacy JSON rows when
``HOPS_TPU_ONLINE_ROW_FORMAT=json`` (and always on read: the format is
sniffed per value, so existing ``.hkv``/``.db`` files keep working and
the two formats coexist in one store).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from pathlib import Path
from typing import Any, Iterator

import pandas as pd

from hops_tpu_torch.featurestore import storage
from hops_tpu_torch.runtime import wirecodec
from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)


def _key_of(pk_values: list[Any]) -> str:
    return json.dumps(pk_values, default=str, separators=(",", ":"))


def _row_format() -> str:
    """Write-side row format: ``packed`` (default) or ``json``.

    Read paths sniff per value and never consult this — flipping the
    env var mid-life is safe and only affects new writes.
    """
    fmt = os.environ.get("HOPS_TPU_ONLINE_ROW_FORMAT", "packed") \
        .strip().lower()
    if fmt not in ("packed", "json"):
        raise ValueError(
            f"HOPS_TPU_ONLINE_ROW_FORMAT={fmt!r}: pick packed|json")
    return fmt


def _encode_row(rec: dict, fmt: str) -> str:
    if fmt == "packed":
        return wirecodec.pack_row(rec)
    return json.dumps(rec, default=str)


def _decode_row(raw: str) -> dict:
    """Decode one stored row value, sniffing the format byte."""
    if wirecodec.is_packed_row(raw):
        return wirecodec.unpack_row(raw)
    return json.loads(raw)


def _decode_rows(raws: list[str | None]) -> list[dict | None]:
    """Batched row decode for multi-gets: one ``json.loads`` of a
    joined array instead of one parser setup per key. After the native
    backend took the lookup itself to ~10us/key, the per-key Python
    ``json.loads`` became the dominant multi-get cost — joining the
    rows into a single array parses the whole batch in one C call
    (``bench.py --hot-path`` carries the before/after). Packed rows
    (``wirecodec.ROW_FORMAT_PACKED`` sniffed per value) take the
    struct-unpack path instead; a mixed batch decodes each row by its
    own format, so stores written under either setting read back
    correctly. If the joined parse fails (a malformed stored row), fall
    back to the per-row decode so the error points at the guilty row,
    exactly like the pre-batching path."""
    present = [r for r in raws if r is not None]
    if not present:
        return [None] * len(raws)
    if any(wirecodec.is_packed_row(r) for r in present):
        return [_decode_row(r) if r is not None else None for r in raws]
    try:
        decoded = json.loads("[" + ",".join(present) + "]")
    except ValueError:
        decoded = None
    if decoded is None or len(decoded) != len(present):
        # Joined parse failed — or a malformed stored row was a valid
        # JSON *fragment* with a top-level comma ('1,2'), which would
        # silently shift every later row onto the wrong key. Either
        # way, per-row decode restores the pre-batching behavior: the
        # error points at the guilty row, neighbors stay aligned.
        log.warning("online store: batched row decode failed; falling back "
                    "to per-row decode")
        return [json.loads(r) if r is not None else None for r in raws]
    it = iter(decoded)
    return [next(it) if r is not None else None for r in raws]


class OnlineStore:
    """One KV namespace per (feature group, version).

    Concurrency contract: ``self._lock`` is the WRITER lock — it
    serializes the batched put/delete/flush cycles. Reads take a
    backend-dependent path (:meth:`_read`): the sqlite backend is
    reader-safe without any lock (each reader thread gets its own WAL
    snapshot connection, seeing the last committed batch and never a
    half-flushed one), so serving-rate point lookups never queue behind
    a materialization flush; the native mmap log is NOT reader-safe
    mid-compact, so its reads briefly take the writer lock.
    """

    def __init__(self, path: Path):
        self.path = path
        self._impl = _open_backend(path)
        self._lock = threading.Lock()

    # -- write path (fg.insert with online_enabled) --------------------------

    def put_dataframe(self, df: pd.DataFrame, primary_key: list[str]) -> int:
        rows = 0
        fmt = _row_format()
        with self._lock:
            for rec in df.to_dict(orient="records"):
                key = _key_of([rec[k] for k in primary_key])
                self._impl.put(key, _encode_row(rec, fmt))
                rows += 1
            self._impl.flush()
        return rows

    def delete_keys(self, df: pd.DataFrame, primary_key: list[str]) -> None:
        with self._lock:
            for rec in df.to_dict(orient="records"):
                self._impl.delete(_key_of([rec[k] for k in primary_key]))
            self._impl.flush()

    # -- read path (prepared-statement lookups) ------------------------------
    #
    # Reads used to hit self._impl directly with no lock at all, racing
    # put_dataframe's batched flush on both backends (the sqlite
    # connection was shared across threads mid-commit; the native mmap
    # log is not reader-safe mid-compact). The fix keeps reads off the
    # writer lock where the backend can prove a consistent snapshot
    # (sqlite WAL reader connections) and takes the lock where it
    # can't (native).

    def _read(self, fn):
        """Run a read on the backend's reader-safe path, or under the
        writer lock when the backend has none (see class docstring)."""
        if getattr(self._impl, "reader_safe", False):
            return fn()
        with self._lock:
            return fn()

    def get(self, pk_values: list[Any]) -> dict | None:
        raw = self._read(lambda: self._impl.get(_key_of(pk_values)))
        return _decode_row(raw) if raw is not None else None

    def get_many(self, pk_values_list: list[list[Any]]) -> list[dict | None]:
        """Batched point lookup, results in input order (the serving
        multi-get path: one backend round trip per batch where the
        backend supports it, instead of one per key)."""
        keys = [_key_of(pk) for pk in pk_values_list]
        impl = self._impl
        if hasattr(impl, "get_many"):
            raws = self._read(lambda: impl.get_many(keys))
        else:
            raws = self._read(lambda: [impl.get(k) for k in keys])
        return _decode_rows(raws)

    def scan(self) -> Iterator[dict]:
        # Materialized under _read, not yielded lazily: a generator
        # must not hold the writer lock across the caller's loop body —
        # and on the locked path the underlying cursor would otherwise
        # run outside the lock entirely.
        rows = self._read(lambda: [_decode_row(v) for v in self._impl.scan()])
        yield from rows

    def count(self) -> int:
        return self._read(self._impl.count)

    def close(self) -> None:
        self._impl.close()


def open_store(name: str, version: int) -> OnlineStore:
    d = storage.feature_store_root() / "online"
    d.mkdir(parents=True, exist_ok=True)
    return OnlineStore(d / f"{name}_{version}")


def _open_backend(path: Path):
    """Pick the shard backend: the native log-structured engine when
    ``libhops_native.so`` is built, else sqlite.

    ``HOPS_TPU_ONLINE_BACKEND`` overrides: ``auto`` (default — prefer
    native, fall back to sqlite with a logged reason), ``native``
    (required: raise if unbuilt — a deployment that EXPECTS native
    lookup latency must not silently run 10x slower), ``sqlite``
    (force the fallback, e.g. to compare in ``bench.py --hot-path``).

    An existing shard file wins over the preference: a store created
    under one backend must keep reading its own data after the env
    changes (the two formats are not interchangeable on disk).
    """
    import os

    from hops_tpu_torch.native import kvstore

    choice = os.environ.get("HOPS_TPU_ONLINE_BACKEND", "auto").strip().lower()
    if choice not in ("auto", "native", "sqlite"):
        raise ValueError(
            f"HOPS_TPU_ONLINE_BACKEND={choice!r}: pick auto|native|sqlite"
        )
    native_path = Path(str(path) + ".hkv")
    sqlite_path = Path(str(path) + ".db")
    # Existing data pins the backend regardless of preference.
    file_pinned = False
    if native_path.exists() and not sqlite_path.exists():
        if choice == "sqlite":
            log.warning(
                "online store %s: HOPS_TPU_ONLINE_BACKEND=sqlite but an "
                "existing native shard file wins (formats are not "
                "interchangeable on disk)", path.name,
            )
        choice = "native"
        file_pinned = True
    elif sqlite_path.exists() and not native_path.exists():
        if choice == "native":
            log.warning(
                "online store %s: HOPS_TPU_ONLINE_BACKEND=native but an "
                "existing sqlite shard file wins (formats are not "
                "interchangeable on disk)", path.name,
            )
        choice = "sqlite"
    if choice == "sqlite":
        return _SqliteKV(str(sqlite_path))
    if kvstore.available():
        return kvstore.NativeKV(str(native_path))
    if choice == "native":
        reason = (
            f"existing native shard file {native_path.name} requires the "
            "native backend (sqlite cannot read it)"
            if file_pinned
            else "HOPS_TPU_ONLINE_BACKEND=native"
        )
        raise RuntimeError(
            f"{reason}, but libhops_native.so is not built (g++ failed, or "
            "HOPS_TPU_DISABLE_NATIVE is set; see hops_tpu_torch.native.build)"
        )
    log.info(
        "online store %s: native kvstore not built, falling back to "
        "sqlite (see hops_tpu_torch.native.build for log-structured "
        "point lookups)", path.name,
    )
    return _SqliteKV(str(sqlite_path))


class _SqliteKV:
    """Fallback backend when the native engine isn't built.

    ``self._db`` is the writer connection (callers serialize writes with
    the store's writer lock). Reads run on per-thread READER connections
    against the same WAL database: a WAL reader sees the last committed
    state for the lifetime of its cursor — never a half-flushed batch,
    never blocked by the writer — which is what makes this backend
    ``reader_safe`` (see ``OnlineStore._read``).
    """

    #: Reads need no lock: WAL snapshot isolation on reader connections.
    reader_safe = True

    def __init__(self, path: str):
        self._path = path
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT)")
        # Prepared-statement spirit of the reference: sqlite caches the
        # compiled statement; WAL keeps point reads fast under writes.
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.commit()  # table + WAL mode durable before any reader opens
        self._local = threading.local()
        self._readers_lock = threading.Lock()
        self._readers: list[sqlite3.Connection] = []  # guarded by: self._readers_lock

    def _reader(self) -> sqlite3.Connection:
        db = getattr(self._local, "db", None)
        if db is None:
            db = self._local.db = sqlite3.connect(self._path, check_same_thread=False)
            with self._readers_lock:
                self._readers.append(db)
        return db

    def put(self, key: str, value: str) -> None:
        self._db.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value))

    def get(self, key: str) -> str | None:
        row = self._reader().execute(
            "SELECT v FROM kv WHERE k = ?", (key,)
        ).fetchone()
        return row[0] if row else None

    def get_many(self, keys: list[str]) -> list[str | None]:
        found: dict[str, str] = {}
        db = self._reader()
        # 500-key chunks: sqlite's bound-parameter limit is 999 on
        # older builds.
        for i in range(0, len(keys), 500):
            chunk = keys[i:i + 500]
            q = f"SELECT k, v FROM kv WHERE k IN ({','.join('?' * len(chunk))})"
            found.update(db.execute(q, chunk).fetchall())
        return [found.get(k) for k in keys]

    def delete(self, key: str) -> None:
        self._db.execute("DELETE FROM kv WHERE k = ?", (key,))

    def scan(self):
        yield from (v for (v,) in self._reader().execute("SELECT v FROM kv"))

    def count(self) -> int:
        return self._reader().execute("SELECT COUNT(*) FROM kv").fetchone()[0]

    def flush(self) -> None:
        self._db.commit()

    def close(self) -> None:
        self._db.commit()
        self._db.close()
        # Reader connections are per-thread but live on this object too:
        # without closing them here a serving process leaks one open
        # .db/WAL handle per (reader thread, shard) past store close.
        # Callers stop reading before close() — the concurrency contract.
        with self._readers_lock:
            readers, self._readers = list(self._readers), []
        for db in readers:
            try:
                db.close()
            except sqlite3.Error:
                log.debug("closing sqlite reader connection failed", exc_info=True)
