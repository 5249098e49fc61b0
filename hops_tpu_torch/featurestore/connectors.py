"""Storage connectors: named external data sources (counterpart of
``hops_tpu/featurestore/connectors.py``, copied with the port's imports).

Reference (SURVEY.md §2.6): ``fs.get_storage_connector(name[, "S3"])``
for S3 training-dataset sinks and ingest
(S3-Ingest-to-Feature-Store-basics.ipynb:100), Snowflake
(``connector.snowflake_connector_options()``), Redshift/JDBC, and the
default HopsFS connector. Here connectors are a persisted registry;
path-based connectors (HOPSFS, S3-via-mounted-path) are fully
functional, network-SQL warehouses are configuration carriers whose
``read()`` is gated on their (absent) client libraries.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import pandas as pd

from hops_tpu_torch.featurestore import storage


def _registry_path() -> Path:
    return storage.feature_store_root() / "connectors.json"


def _load_registry() -> dict:
    p = _registry_path()
    return json.loads(p.read_text()) if p.exists() else {}


def _save_registry(reg: dict) -> None:
    _registry_path().write_text(json.dumps(reg, indent=2))


@dataclasses.dataclass
class StorageConnector:
    name: str
    type: str = "HOPSFS"
    options: dict = dataclasses.field(default_factory=dict)

    #: True when read(query=...) executes SQL in the external system
    #: (JDBC); path-based connectors ignore ``query``.
    executes_sql = False

    def read(self, query: str | None = None, data_format: str | None = None,
             path: str | None = None) -> pd.DataFrame:
        raise NotImplementedError

    def spark_options(self) -> dict:
        return dict(self.options)


class HopsFSConnector(StorageConnector):
    """Default connector: paths inside the project workspace."""

    def resolve(self, path: str | None = None) -> Path:
        from hops_tpu_torch.runtime import fs as hfs

        base = self.options.get("path", "")
        rel = str(Path(base) / path) if path else base
        return Path(hfs.project_path(rel)) if not Path(rel).is_absolute() else Path(rel)

    def read(self, query=None, data_format=None, path=None) -> pd.DataFrame:
        target = self.resolve(path)
        return _read_path(target, data_format)


class S3Connector(StorageConnector):
    """S3 bucket (reference ingest role:
    S3-Ingest-to-Feature-Store-basics.ipynb:100).

    Reads accept both bucket-relative keys and full ``s3://bucket/key``
    URIs. The byte source is ``options["mount_point"]`` — a local
    directory standing in for the bucket root (FUSE mount in
    production, an injected fixture dir in tests), so the whole
    resolve→read→ingest path executes without network egress. A URI
    naming a different bucket, or a read with no mount configured,
    raises honestly.
    """

    def resolve(self, path: str | None = None) -> Path:
        mount = self.options.get("mount_point")
        if not mount:
            raise RuntimeError(
                f"S3 connector {self.name!r}: no mount_point configured and "
                "no S3 client library in this image; mount the bucket or "
                "copy locally")
        key = path or ""
        if key.startswith("s3://") or key.startswith("s3a://"):
            rest = key.split("://", 1)[1]
            uri_bucket, _, key = rest.partition("/")
            if not self.bucket:
                raise ValueError(
                    f"S3 connector {self.name!r} has no bucket configured; "
                    "cannot validate URI reads — pass a bucket-relative key "
                    "or create the connector with bucket=...")
            if uri_bucket != self.bucket:
                raise ValueError(
                    f"S3 connector {self.name!r} is bound to bucket "
                    f"{self.bucket!r}, not {uri_bucket!r}")
        # Keys are bucket-relative by definition: anchor them under the
        # mount and refuse escapes (absolute keys, '..' traversal).
        root = Path(mount).resolve()
        target = (root / key.lstrip("/")).resolve()
        if root != target and root not in target.parents:
            raise ValueError(
                f"S3 key {path!r} escapes the mounted bucket root {root}")
        return target

    def read(self, query=None, data_format=None, path=None) -> pd.DataFrame:
        return _read_path(self.resolve(path), data_format)

    @property
    def bucket(self) -> str:
        return self.options.get("bucket", "")


class JDBCConnector(StorageConnector):
    """JDBC-role connector, functional for embedded sqlite databases.

    The reference ingests from warehouse SQL through JDBC connectors
    (Redshift_pyspark.ipynb:129,138; snowflake/getting-started.ipynb:
    115-124 role). Network drivers aren't in this image, but the
    embedded SQL engine is (sql/gateway.py), so a connection string of
    ``jdbc:sqlite:<path>``, ``sqlite:<path>`` or a bare file path
    executes ``read(query)`` directly against that database — the full
    external-SQL → on-demand FG → training-dataset path runs. Other
    JDBC URLs still raise honestly.
    """

    executes_sql = True

    #: Whether a scheme-less connection string may name a local database
    #: file. True for generic JDBC; Snowflake overrides to False since
    #: its scheme-less account URLs (*.snowflakecomputing.com) must
    #: never be mistaken for a filesystem path.
    _allow_bare_path = True

    def read(self, query=None, data_format=None, path=None) -> pd.DataFrame:
        db_path = self._sqlite_path()
        if db_path is None:
            raise RuntimeError(
                f"{self.type} connector {self.name!r}: connection string "
                f"{self.connection_string()!r} requires a network database "
                "driver not in this image; embedded sqlite "
                "(jdbc:sqlite:<path>) is supported")
        if not Path(db_path).exists():
            raise FileNotFoundError(
                f"{self.type} connector {self.name!r}: database {db_path} does not exist")
        sql = query or self.options.get("query")
        if not sql:
            raise ValueError(f"{self.type} connector {self.name!r}: read() needs a query")
        import sqlite3

        db = sqlite3.connect(db_path)
        try:
            return pd.read_sql_query(sql, db)
        finally:
            db.close()

    def connection_string(self) -> str:
        return self.options.get("connection_string", "")

    def _sqlite_path(self) -> str | None:
        cs = self.connection_string()
        for prefix in ("jdbc:sqlite:", "sqlite:///", "sqlite:"):
            if cs.startswith(prefix):
                return cs[len(prefix):]
        if self._allow_bare_path and cs and ":" not in cs.split("/", 1)[0]:
            return cs  # bare filesystem path
        return None


class SnowflakeConnector(JDBCConnector):
    """Snowflake warehouse connector.

    Carries the full option set the reference's Spark reads consume
    (snowflake/getting-started.ipynb:115-124). ``read(query)`` executes
    when ``url`` names an embedded database (``jdbc:sqlite:<path>`` /
    ``sqlite:<path>`` / a bare file path) — the same warehouse-SQL →
    on-demand-FG → training-dataset path as JDBC/Redshift — and raises
    honestly for real ``*.snowflakecomputing.com`` URLs, whose client
    library is not in this image.
    """

    def snowflake_connector_options(self) -> dict:
        """Reference: snowflake/getting-started.ipynb:115-124."""
        o = self.options
        return {
            "sfURL": o.get("url", ""), "sfUser": o.get("user", ""),
            "sfPassword": o.get("password", ""), "sfDatabase": o.get("database", ""),
            "sfSchema": o.get("schema", ""), "sfWarehouse": o.get("warehouse", ""),
            "sfRole": o.get("role", ""),
        }

    _allow_bare_path = False

    def connection_string(self) -> str:
        return self.options.get("connection_string") or self.options.get("url", "")


class RedshiftConnector(JDBCConnector):
    pass


_TYPES = {
    "HOPSFS": HopsFSConnector,
    "S3": S3Connector,
    "JDBC": JDBCConnector,
    "SNOWFLAKE": SnowflakeConnector,
    "REDSHIFT": RedshiftConnector,
}


def create(name: str, connector_type: str, **options: Any) -> StorageConnector:
    ctype = connector_type.upper()
    if ctype not in _TYPES:
        raise ValueError(f"unknown connector type {connector_type!r}; have {sorted(_TYPES)}")
    reg = _load_registry()
    reg[name] = {"type": ctype, "options": options}
    _save_registry(reg)
    return _TYPES[ctype](name=name, type=ctype, options=options)


def get(name: str, connector_type: str | None = None) -> StorageConnector:
    reg = _load_registry()
    if name not in reg:
        if name.upper() == "HOPSFS" or connector_type == "HOPSFS":
            return HopsFSConnector(name=name, type="HOPSFS", options={})
        raise KeyError(f"no storage connector named {name!r}")
    entry = reg[name]
    if connector_type and entry["type"] != connector_type.upper():
        raise KeyError(f"connector {name!r} is {entry['type']}, not {connector_type}")
    return _TYPES[entry["type"]](name=name, type=entry["type"], options=entry["options"])


def _read_path(target: Path, data_format: str | None) -> pd.DataFrame:
    if target.is_dir():
        frames = []
        for p in sorted(target.iterdir()):
            if p.suffix in (".parquet", ".csv"):
                frames.append(_read_path(p, None))
        if not frames:
            raise FileNotFoundError(f"no readable files under {target}")
        return pd.concat(frames, ignore_index=True)
    fmt = data_format or target.suffix.lstrip(".")
    if fmt == "parquet":
        return pd.read_parquet(target)
    if fmt == "csv":
        return pd.read_csv(target)
    raise ValueError(f"unsupported format {fmt!r} for {target}")
