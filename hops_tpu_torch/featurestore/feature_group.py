"""Feature groups: schema'd, versioned, time-travelable feature tables (counterpart of
``hops_tpu/featurestore/feature_group.py``, copied with the port's imports).

Reference surface (SURVEY.md §2.6; feature_engineering.ipynb:177,267,313;
time_travel_python.ipynb): ``fs.create_feature_group(...)`` → ``.save(df)``,
``fg.insert`` (upsert), ``fg.commit_details()``, ``fg.select/select_all/
filter``, online writes when ``online_enabled``, validation gates via
``validation_type``, schematized tags.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any

import pandas as pd

from hops_tpu_torch.featurestore import online as online_mod
from hops_tpu_torch.featurestore import statistics as stats_mod
from hops_tpu_torch.featurestore import storage
from hops_tpu_torch.featurestore.feature import Feature, _Condition, schema_from_dataframe
from hops_tpu_torch.featurestore.query import Query

if TYPE_CHECKING:
    from hops_tpu_torch.featurestore.connection import FeatureStore

_KIND = "featuregroups"


class FeatureGroup:
    """A versioned feature table backed by the Parquet commit log."""

    def __init__(
        self,
        feature_store: "FeatureStore",
        name: str,
        version: int = 1,
        description: str = "",
        primary_key: list[str] | None = None,
        partition_key: list[str] | None = None,
        online_enabled: bool = False,
        time_travel_format: str | None = "COMMIT_LOG",
        statistics_config: Any = None,
        validation_type: str = "NONE",
        expectations: list | None = None,
        event_time: str | None = None,
    ):
        self._fs = feature_store
        self.name = name
        self.version = version
        self.description = description
        self.primary_key = [k.lower() for k in (primary_key or [])]
        self.partition_key = [k.lower() for k in (partition_key or [])]
        self.online_enabled = online_enabled
        self.time_travel_format = time_travel_format
        self.statistics_config = stats_mod.StatisticsConfig.from_dict(statistics_config)
        self.validation_type = validation_type.upper()
        self.expectation_names = [
            e if isinstance(e, str) else e.name for e in (expectations or [])
        ]
        self.event_time = event_time
        self._features: list[Feature] = []
        self._online: online_mod.OnlineStore | None = None

    # -- identity -------------------------------------------------------------

    @property
    def dir(self):
        return storage.entity_dir(_KIND, self.name, self.version)

    @property
    def features(self) -> list[Feature]:
        if not self._features and (self.dir / "metadata.json").exists():
            self._load_meta()
        return self._features

    def __getitem__(self, name: str) -> Feature:
        return self.get_feature(name)

    def get_feature(self, name: str) -> Feature:
        for f in self.features:
            if f.name == name:
                return f
        raise KeyError(f"feature {name!r} not in {self.name}_{self.version}")

    def __repr__(self) -> str:
        return f"FeatureGroup({self.name!r}, version={self.version})"

    # -- persistence ----------------------------------------------------------

    def _save_meta(self) -> None:
        storage.write_metadata(
            self.dir,
            {
                "name": self.name,
                "version": self.version,
                "description": self.description,
                "primary_key": self.primary_key,
                "partition_key": self.partition_key,
                "online_enabled": self.online_enabled,
                "time_travel_format": self.time_travel_format,
                "statistics_config": self.statistics_config.to_dict(),
                "validation_type": self.validation_type,
                "expectations": self.expectation_names,
                "event_time": self.event_time,
                "features": [f.to_dict() for f in self._features],
                "tags": self._load_tags(),
            },
        )

    def _load_meta(self) -> None:
        meta = storage.read_metadata(self.dir)
        self.description = meta.get("description", "")
        self.primary_key = meta.get("primary_key", [])
        self.partition_key = meta.get("partition_key", [])
        self.online_enabled = meta.get("online_enabled", False)
        self.time_travel_format = meta.get("time_travel_format")
        self.statistics_config = stats_mod.StatisticsConfig.from_dict(
            meta.get("statistics_config")
        )
        self.validation_type = meta.get("validation_type", "NONE")
        self.expectation_names = meta.get("expectations", [])
        self.event_time = meta.get("event_time")
        self._features = [Feature.from_dict(f) for f in meta.get("features", [])]

    # -- write path -----------------------------------------------------------

    def save(self, df: pd.DataFrame, write_options: dict | None = None) -> "FeatureGroup":
        """First materialization (reference: ``fg.save(df)``,
        feature_engineering.ipynb cell 13)."""
        df = _normalize(df)
        self._features = schema_from_dataframe(df, self.primary_key, self.partition_key)
        self._save_meta()
        self._commit(df, operation="insert", write_options=write_options)
        return self

    def insert(
        self,
        df: pd.DataFrame,
        overwrite: bool = False,
        operation: str = "upsert",
        write_options: dict | None = None,
    ) -> "FeatureGroup":
        """Upsert new rows as a commit (reference: ``fg.insert``,
        time_travel_python.ipynb:695)."""
        df = _normalize(df)
        if not (self.dir / "metadata.json").exists():
            return self.save(df, write_options)
        if overwrite:
            # Hudi "insert_overwrite": tombstone current state first
            # (through _commit so the online store is purged too).
            current = self.read()
            if len(current):
                self._commit(current, operation="delete")
        self._commit(df, operation=operation, write_options=write_options)
        return self

    def commit_delete_record(self, df: pd.DataFrame, write_options: dict | None = None) -> None:
        """Delete by primary key (reference: time-travel deletes,
        time_travel_python.ipynb cell 24)."""
        df = _normalize(df)
        self._commit(df[self.primary_key] if self.primary_key else df, operation="delete")

    def _commit(self, df: pd.DataFrame, operation: str, write_options: dict | None = None) -> int:
        # Deletes carry only the primary key — expectations don't apply.
        if operation != "delete":
            self._validate_on_write(df)
        # ``before`` feeds both the upsert bookkeeping (needs a primary key)
        # and post-commit statistics (needed even for keyless append FGs,
        # where stats must describe the full table, not just this commit).
        need_before = bool(self.primary_key) or self.statistics_config.enabled
        before = storage.read_as_of(self.dir, self.primary_key) if need_before else None
        cid = storage.write_commit(self.dir, df, operation=operation)
        # Commit bookkeeping mirrors the reference's commit_details fields.
        if operation == "delete":
            counts = {"rows_inserted": 0, "rows_updated": 0, "rows_deleted": int(len(df))}
        elif before is not None and len(before) and self.primary_key:
            existing = before.set_index(self.primary_key).index
            incoming = df.set_index(self.primary_key).index
            updated = int(incoming.isin(existing).sum())
            counts = {
                "rows_inserted": int(len(df) - updated),
                "rows_updated": updated,
                "rows_deleted": 0,
            }
        else:
            counts = {"rows_inserted": int(len(df)), "rows_updated": 0, "rows_deleted": 0}
        meta = storage.read_commit_meta(self.dir, cid)
        meta.update(counts)
        (self.dir / "commits" / f"{cid}.json").write_text(json.dumps(meta, indent=2))
        if self.statistics_config.enabled:
            # Post-commit state derived in memory (no second log replay).
            after = _apply_commit(before, df, operation, self.primary_key)
            stats = stats_mod.compute_statistics(after, self.statistics_config)
            stats_mod.save_statistics(self.dir, str(cid), stats)
        if self.online_enabled and operation != "delete":
            self.online_store().put_dataframe(df, self.primary_key)
        elif self.online_enabled and operation == "delete":
            self.online_store().delete_keys(df, self.primary_key)
        return cid

    def _validate_on_write(self, df: pd.DataFrame) -> None:
        if self.validation_type == "NONE" or not self.expectation_names:
            return
        from hops_tpu_torch.featurestore import validation as val_mod

        report = val_mod.validate_dataframe(self._fs, self, df, persist=True)
        if self.validation_type == "STRICT" and report["status"] != "SUCCESS":
            raise val_mod.DataValidationError(
                f"STRICT validation failed for {self.name}_{self.version}: "
                f"{report['status']}"
            )

    # -- read path ------------------------------------------------------------

    def read(
        self,
        wallclock_time=None,
        online: bool = False,
        dataframe_type: str = "pandas",
    ) -> pd.DataFrame:
        """Current (or point-in-time) state (reference: ``fg.read()`` /
        ``fg.read(wallclock_time)``)."""
        if online:
            return pd.DataFrame(list(self.online_store().scan()))
        ts = storage.resolve_timestamp(wallclock_time)
        return storage.read_as_of(self.dir, self.primary_key, as_of=ts)

    def read_changes(self, start_wallclock_time, end_wallclock_time) -> pd.DataFrame:
        """Incremental pull between two commit times (reference:
        time_travel_python.ipynb incremental reads)."""
        t0 = storage.resolve_timestamp(start_wallclock_time)
        t1 = storage.resolve_timestamp(end_wallclock_time)
        return storage.read_as_of(self.dir, self.primary_key, as_of=t1, exclude_until=t0)

    def show(self, n: int = 5, online: bool = False) -> pd.DataFrame:
        return self.read(online=online).head(n)

    def commit_details(self, limit: int | None = None) -> dict:
        """Reference: ``fg.commit_details()`` (time_travel_python.ipynb:432)."""
        ids = storage.commit_ids(self.dir)
        if limit:
            ids = ids[-limit:]
        out = {}
        for cid in ids:
            m = storage.read_commit_meta(self.dir, cid)
            out[cid] = {
                "committedOn": m.get("committed_on"),
                "rowsInserted": m.get("rows_inserted", m.get("rows", 0)),
                "rowsUpdated": m.get("rows_updated", 0),
                "rowsDeleted": m.get("rows_deleted", 0),
            }
        return out

    # -- query algebra --------------------------------------------------------

    def select_all(self) -> Query:
        return Query(self, list(self.features))

    def select(self, features: list) -> Query:
        feats = [f if isinstance(f, Feature) else self.get_feature(f) for f in features]
        return Query(self, feats)

    def select_except(self, features: list) -> Query:
        drop = {f.name if isinstance(f, Feature) else f for f in features}
        return Query(self, [f for f in self.features if f.name not in drop])

    def filter(self, condition: _Condition) -> Query:
        return self.select_all().filter(condition)

    # -- statistics / validation / tags --------------------------------------

    def get_statistics(self, commit_time=None) -> dict:
        name = None
        if commit_time is not None:
            ts = storage.resolve_timestamp(commit_time)
            ids = [c for c in storage.commit_ids(self.dir) if c <= ts]
            name = str(ids[-1]) if ids else None
        return stats_mod.load_statistics(self.dir, name)

    def compute_statistics(self) -> dict:
        stats = stats_mod.compute_statistics(self.read(), self.statistics_config)
        stats_mod.save_statistics(self.dir, "manual", stats)
        return stats

    def attach_expectation(self, expectation) -> None:
        name = expectation if isinstance(expectation, str) else expectation.name
        if name not in self.expectation_names:
            self.expectation_names.append(name)
            self._save_meta()

    def detach_expectation(self, expectation) -> None:
        name = expectation if isinstance(expectation, str) else expectation.name
        if name in self.expectation_names:
            self.expectation_names.remove(name)
            self._save_meta()

    def get_expectations(self) -> list:
        return [self._fs.get_expectation(n) for n in self.expectation_names]

    def validate(self, df: pd.DataFrame | None = None) -> dict:
        """Run attached expectations (reference: ``fg.validate(df)``,
        feature_validation_python.ipynb:448)."""
        from hops_tpu_torch.featurestore import validation as val_mod

        return val_mod.validate_dataframe(
            self._fs, self, _normalize(df) if df is not None else self.read(), persist=True
        )

    def get_validations(self) -> list[dict]:
        from hops_tpu_torch.featurestore import validation as val_mod

        return val_mod.load_validations(self.dir)

    # -- tags (reference: feature_store_tags.ipynb cells 16-28) ---------------

    def _load_tags(self) -> dict:
        try:
            return storage.read_metadata(self.dir).get("tags", {})
        except FileNotFoundError:
            return {}

    def add_tag(self, name: str, value: Any) -> None:
        meta = storage.read_metadata(self.dir)
        meta.setdefault("tags", {})[name] = value
        storage.write_metadata(self.dir, meta)

    def get_tag(self, name: str) -> Any:
        return self._load_tags().get(name)

    def get_tags(self) -> dict:
        return self._load_tags()

    def delete_tag(self, name: str) -> None:
        meta = storage.read_metadata(self.dir)
        meta.get("tags", {}).pop(name, None)
        storage.write_metadata(self.dir, meta)

    # -- online ---------------------------------------------------------------

    def online_store(self) -> online_mod.OnlineStore:
        if self._online is None:
            self._online = online_mod.open_store(self.name, self.version)
        return self._online

    def get_serving_row(self, keys: dict[str, Any]) -> dict | None:
        return self.online_store().get([keys[k] for k in self.primary_key])

    def delete(self) -> None:
        import shutil

        if self.dir.exists():
            shutil.rmtree(self.dir)


class OnDemandFeatureGroup(FeatureGroup):
    """External (on-demand) feature group: no materialized commits — rows
    come from a storage connector + SQL at read time (reference:
    ``fs.create_on_demand_feature_group``, SURVEY.md §2.6)."""

    def __init__(self, feature_store, name, version=1, query: str = "", storage_connector=None, **kw):
        super().__init__(feature_store, name, version, time_travel_format=None, **kw)
        self.query = query
        self.storage_connector = storage_connector

    def save(self, df=None, write_options=None) -> "OnDemandFeatureGroup":
        sample = self.read().head(100)
        self._features = schema_from_dataframe(sample, self.primary_key, self.partition_key)
        self._save_meta()
        meta = storage.read_metadata(self.dir)
        meta["on_demand"] = True
        meta["query"] = self.query
        meta["storage_connector"] = getattr(self.storage_connector, "name", None)
        storage.write_metadata(self.dir, meta)
        return self

    def read(self, wallclock_time=None, online=False, dataframe_type="pandas") -> pd.DataFrame:
        if self.query:
            if getattr(self.storage_connector, "executes_sql", False):
                # SQL-capable connectors (JDBC over embedded sqlite)
                # execute the query in the external database itself —
                # the reference's external-SQL on-demand FG semantics
                # (ComputeFeatures.scala:179-191, snowflake role).
                try:
                    return self.storage_connector.read(query=self.query)
                except (RuntimeError, NotImplementedError):
                    pass  # config-only connector: fall back to the gateway
            from hops_tpu_torch.sql import gateway

            return gateway.execute(self.query, feature_store=self._fs, connector=self.storage_connector)
        if self.storage_connector is not None:
            return self.storage_connector.read()
        raise ValueError("on-demand feature group needs a query or a storage connector")


def _apply_commit(
    before: pd.DataFrame | None, df: pd.DataFrame, operation: str, primary_key: list[str]
) -> pd.DataFrame:
    """In-memory equivalent of replaying the new commit on top of ``before``."""
    if before is None or not len(before):
        return df if operation != "delete" else pd.DataFrame(columns=df.columns)
    if operation == "delete":
        if not primary_key:
            return before
        doomed = df.set_index(primary_key).index
        return before[~before.set_index(primary_key).index.isin(doomed)]
    merged = pd.concat([before, df], ignore_index=True)
    if primary_key:
        merged = merged.drop_duplicates(subset=primary_key, keep="last")
    return merged.reset_index(drop=True)


def _normalize(df: pd.DataFrame) -> pd.DataFrame:
    """Lowercase column names (the reference's Hive layer is
    case-insensitive; hsfs lowercases feature names)."""
    df = df.copy()
    df.columns = [str(c).lower() for c in df.columns]
    return df
