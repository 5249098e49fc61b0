"""SQL execution over feature-store tables via in-process sqlite3 (counterpart of
``hops_tpu/sql/gateway.py``, copied with the port's imports).

Table resolution: identifiers in FROM/JOIN clauses are matched against
feature groups — ``name_<version>`` pins a version, a bare ``name``
reads the latest. Matched tables are loaded into a temporary sqlite
database and the query runs there (the same pattern as the reference's
server-side "query constructor → spark.sql", SURVEY.md §3.5, minus the
cluster).
"""

from __future__ import annotations

import re
import sqlite3

import pandas as pd

_FROM_RE = re.compile(r"\b(?:from|join)\s+([A-Za-z_][A-Za-z0-9_.]*)", re.IGNORECASE)


def _resolve_tables(sql: str, feature_store) -> dict[str, pd.DataFrame]:
    tables: dict[str, pd.DataFrame] = {}
    for ident in _FROM_RE.findall(sql):
        name = ident.split(".")[-1]
        if name in tables:
            continue
        df = _lookup(feature_store, name)
        if df is not None:
            tables[name] = df
    return tables


def _lookup(feature_store, ident: str) -> pd.DataFrame | None:
    if feature_store is None:
        return None
    stem, _, ver = ident.rpartition("_")
    candidates = [(stem, int(ver))] if (stem and ver.isdigit()) else []
    candidates.append((ident, None))
    for name, version in candidates:
        try:
            return feature_store.get_feature_group(name, version).read()
        except KeyError:
            continue
    return None


def execute(sql: str, feature_store=None, connector=None,
            tables: dict[str, pd.DataFrame] | None = None) -> pd.DataFrame:
    """Run ``sql`` and return a DataFrame. Tables come from (in order)
    the explicit ``tables`` dict, the feature store, or ``connector.read()``
    registered under the connector's name."""
    resolved = dict(tables or {})
    for name, df in _resolve_tables(sql, feature_store).items():
        resolved.setdefault(name, df)
    if connector is not None and getattr(connector, "name", None):
        try:
            resolved.setdefault(connector.name, connector.read())
        except (RuntimeError, NotImplementedError, FileNotFoundError):
            pass
    db = sqlite3.connect(":memory:")
    try:
        for name, df in resolved.items():
            df.to_sql(name, db, index=False)
        return pd.read_sql_query(sql, db)
    finally:
        db.close()


class _Cursor:
    """Minimal DB-API cursor (the PyHive shape the reference exercised)."""

    def __init__(self, feature_store):
        self._fs = feature_store
        self._result: pd.DataFrame | None = None

    def execute(self, sql: str) -> None:
        self._result = execute(sql, feature_store=self._fs)

    @property
    def description(self):
        if self._result is None:
            return None
        return [(c, None, None, None, None, None, None) for c in self._result.columns]

    def fetchall(self) -> list[tuple]:
        return [tuple(r) for r in self._result.itertuples(index=False)]

    def fetchone(self):
        rows = self.fetchall()
        return rows[0] if rows else None

    def close(self) -> None:
        pass


class _Connection:
    def __init__(self, feature_store):
        self._fs = feature_store

    def cursor(self) -> _Cursor:
        return _Cursor(self._fs)

    def close(self) -> None:
        pass


def connection(feature_store=None) -> _Connection:
    """Reference: ``hive.setup_hive_connection()`` (PyHive.ipynb:46)."""
    if feature_store is None:
        from hops_tpu_torch import featurestore as hsfs

        feature_store = hsfs.connection().get_feature_store()
    return _Connection(feature_store)
