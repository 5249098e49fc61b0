"""On-disk layout + log-structured commit store for feature groups (counterpart of
``hops_tpu/featurestore/storage.py``, copied with the port's imports).

The reference delegated storage to Hive tables / Hudi datasets on HopsFS
(SURVEY.md §3.5). Here each feature group is a directory of Parquet
commit files plus JSON commit metadata — a merge-on-read log: every
``save``/``insert`` appends one commit; reads replay commits up to a
timestamp and reduce by primary key (last write wins), which is exactly
the upsert + point-in-time (``as_of``) semantics of the reference's HUDI
path (time_travel_python.ipynb:695,432).

Layout under the project root (``fs.project_path()``):

    FeatureStore/featuregroups/<name>_<version>/
        metadata.json             # schema, keys, options, tags
        commits/<id>.parquet      # the rows written by commit <id>
        commits/<id>.json         # {"committed_on", "rows_inserted", ...}
        statistics/<id>.json
        validations/<ts>.json
    FeatureStore/trainingdatasets/<name>_<version>/...
    FeatureStore/online/<name>_<version>.kv
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pandas as pd

from hops_tpu_torch.runtime import fs as hfs

_DELETE_COL = "_hops_deleted"  # marker column inside delete commits


def feature_store_root() -> Path:
    root = Path(hfs.project_path("FeatureStore"))
    root.mkdir(parents=True, exist_ok=True)
    return root


def entity_dir(kind: str, name: str, version: int) -> Path:
    d = feature_store_root() / kind / f"{name}_{version}"
    return d


def list_versions(kind: str, name: str) -> list[int]:
    base = feature_store_root() / kind
    if not base.exists():
        return []
    out = []
    for p in base.iterdir():
        stem, _, ver = p.name.rpartition("_")
        if stem == name and ver.isdigit():
            out.append(int(ver))
    return sorted(out)


def next_version(kind: str, name: str) -> int:
    versions = list_versions(kind, name)
    return (versions[-1] + 1) if versions else 1


def read_metadata(d: Path) -> dict:
    return json.loads((d / "metadata.json").read_text())


def write_metadata(d: Path, meta: dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / "metadata.json").write_text(json.dumps(meta, indent=2, default=str))


# -- commit log ---------------------------------------------------------------


def new_commit_id(d: Path) -> int:
    """Millisecond timestamp, bumped past any existing commit id."""
    cid = int(time.time() * 1000)
    existing = commit_ids(d)
    if existing and cid <= existing[-1]:
        cid = existing[-1] + 1
    return cid


def commit_ids(d: Path) -> list[int]:
    cdir = d / "commits"
    if not cdir.exists():
        return []
    return sorted(int(p.stem) for p in cdir.glob("*.json"))


def write_commit(d: Path, df: pd.DataFrame, operation: str, extra: dict | None = None) -> int:
    cid = new_commit_id(d)
    cdir = d / "commits"
    cdir.mkdir(parents=True, exist_ok=True)
    df = df.copy()
    df[_DELETE_COL] = operation == "delete"
    df.to_parquet(cdir / f"{cid}.parquet", index=False)
    meta = {
        "commit_id": cid,
        "committed_on": pd.Timestamp.now().isoformat(),
        "operation": operation,
        "rows": int(len(df)),
        **(extra or {}),
    }
    (cdir / f"{cid}.json").write_text(json.dumps(meta, indent=2))
    return cid


def read_commit_meta(d: Path, cid: int) -> dict:
    return json.loads((d / "commits" / f"{cid}.json").read_text())


def read_as_of(
    d: Path,
    primary_key: list[str],
    as_of: int | None = None,
    exclude_until: int | None = None,
) -> pd.DataFrame:
    """Replay the commit log: concat commits in ``(exclude_until, as_of]``,
    keep the last write per primary key, drop deletions.

    ``as_of=None`` reads the latest state (reference: ``fg.read()``);
    ``as_of=ts`` is the reference's ``query.as_of(ts)``; ``exclude_until``
    gives incremental reads between two commits (``fg.read_changes``).
    """
    ids = commit_ids(d)
    if as_of is not None:
        ids = [c for c in ids if c <= as_of]
    if exclude_until is not None:
        ids = [c for c in ids if c > exclude_until]
    if not ids:
        return pd.DataFrame()
    frames = [pd.read_parquet(d / "commits" / f"{c}.parquet") for c in ids]
    df = pd.concat(frames, ignore_index=True)
    if primary_key:
        df = df.drop_duplicates(subset=primary_key, keep="last")
    if _DELETE_COL in df.columns:
        df = df[~df[_DELETE_COL].fillna(False)].drop(columns=[_DELETE_COL])
    return df.reset_index(drop=True)


def resolve_timestamp(ts) -> int | None:
    """Accept ms epoch ints, datetimes, or the reference's string formats
    (e.g. ``"20210101000000"`` / ISO dates) and return ms epoch."""
    if ts is None:
        return None
    if isinstance(ts, (int, float)):
        return int(ts)
    if isinstance(ts, str) and ts.isdigit():
        if len(ts) == 14:  # reference format yyyymmddHHMMSS
            ts = pd.Timestamp(
                f"{ts[0:4]}-{ts[4:6]}-{ts[6:8]} {ts[8:10]}:{ts[10:12]}:{ts[12:14]}"
            )
        else:  # a stringified ms-epoch commit id
            return int(ts)
    return int(pd.Timestamp(ts).timestamp() * 1000)
