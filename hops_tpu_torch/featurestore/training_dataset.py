"""Training datasets: materialized, split, versioned training data (counterpart of
``hops_tpu/featurestore/training_dataset.py``, copied with the port's imports).

Reference surface (SURVEY.md §2.6, training_datasets.ipynb:125,156,
409-429): ``fs.create_training_dataset(name, data_format, splits={...},
version).save(query_or_df)``; ``td.read(split)``; ``td.tf_data(...)``
feeder; ``td.query`` replay; online serving vectors via
``td.init_prepared_statement()`` / ``td.get_serving_vector({pk: v})``.

Formats: parquet, csv, tfrecord (via TensorFlow when present), and
"recordio" — the native engine's format (hops_tpu_torch/native/recordio.cc),
the default for shuffled feeding.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any

import numpy as np
import pandas as pd

from hops_tpu_torch.featurestore import statistics as stats_mod
from hops_tpu_torch.featurestore import storage
from hops_tpu_torch.featurestore.feature import Feature, schema_from_dataframe
from hops_tpu_torch.featurestore.query import Query

if TYPE_CHECKING:
    from hops_tpu_torch.featurestore.connection import FeatureStore

_KIND = "trainingdatasets"


class _MissingConnector:
    """Stand-in for a storage connector recorded in TD metadata but
    absent from the connector registry. ``resolve`` raises (so reads
    fail with the real cause) with the RuntimeError that
    ``TrainingDataset.delete`` tolerates."""

    type = "MISSING"

    def __init__(self, name: str):
        self.name = name

    def resolve(self, path: str | None = None):
        raise RuntimeError(
            f"storage connector {self.name!r} is recorded in this training "
            "dataset's metadata but missing from the connector registry; "
            "recreate it with fs.create_storage_connector to read the data")

# - petastorm: schema'd columnar with tensor columns + row-group reader
#   (featurestore/columnar.py; reference PetastormHelloWorld.ipynb:21-44)
# - delta: transactional commit-log materialization with append/overwrite
#   history and as_of reads (reference delta/DeltaOnHops.ipynb), reusing
#   the feature-group commit-log machinery (featurestore/storage.py)
_FORMATS = ("parquet", "csv", "tfrecord", "recordio", "petastorm", "delta")
_FORMAT_ALIASES = {"hudi": "delta"}


class TrainingDataset:
    def __init__(
        self,
        feature_store: "FeatureStore",
        name: str,
        version: int = 1,
        description: str = "",
        data_format: str = "parquet",
        splits: dict[str, float] | None = None,
        seed: int | None = None,
        label: list[str] | None = None,
        coalesce: bool = False,
        storage_connector: Any = None,
        statistics_config: Any = None,
        train_split: str | None = None,
    ):
        data_format = _FORMAT_ALIASES.get(data_format.lower(), data_format.lower())
        if data_format not in _FORMATS:
            raise ValueError(
                f"data_format must be one of {_FORMATS} (or aliases "
                f"{tuple(_FORMAT_ALIASES)}), got {data_format!r}"
            )
        self._fs = feature_store
        self.name = name
        self.version = version
        self.description = description
        self.data_format = data_format
        self.splits = dict(splits or {})
        self.seed = seed
        self.label = [l.lower() for l in (label or [])]
        self.coalesce = coalesce
        self.storage_connector = storage_connector
        self.statistics_config = stats_mod.StatisticsConfig.from_dict(statistics_config)
        self.train_split = train_split
        self._features: list[Feature] = []
        self._query_dict: dict | None = None
        self._serving_prepared = False
        self._serving_fgs: list = []

    # -- identity -------------------------------------------------------------

    @property
    def meta_dir(self):
        """Workspace registry entry — metadata always lives here so
        ``get_training_dataset`` finds connector-backed TDs too."""
        return storage.entity_dir(_KIND, self.name, self.version)

    @property
    def dir(self):
        """Data root: the workspace by default, or the storage
        connector's resolved directory when one is set (reference:
        training_datasets.ipynb cell 12 saves a TD through an S3
        connector)."""
        if self.storage_connector is not None:
            if not hasattr(self.storage_connector, "resolve"):
                raise ValueError(
                    f"storage connector {self.storage_connector.name!r} "
                    f"({self.storage_connector.type}) cannot host training "
                    "datasets: only path-backed connectors (HOPSFS, mounted "
                    "S3) materialize files")
            return self.storage_connector.resolve(f"{self.name}_{self.version}")
        return self.meta_dir

    @property
    def features(self) -> list[Feature]:
        if not self._features and (self.meta_dir / "metadata.json").exists():
            self._load_meta()
        return self._features

    @property
    def query(self) -> Query | None:
        """Replay of the query this TD was built from (reference:
        ``td.query``, training_datasets.ipynb cell 14)."""
        if self._query_dict is None and (self.meta_dir / "metadata.json").exists():
            self._load_meta()
        if self._query_dict is None:
            return None
        return Query.from_dict(self._fs, self._query_dict)

    def __repr__(self) -> str:
        return f"TrainingDataset({self.name!r}, version={self.version}, format={self.data_format})"

    def _save_meta(self) -> None:
        storage.write_metadata(self.meta_dir, {
            "name": self.name,
            "version": self.version,
            "description": self.description,
            "data_format": self.data_format,
            "splits": self.splits,
            "seed": self.seed,
            "label": self.label,
            "coalesce": self.coalesce,
            "train_split": self.train_split,
            "storage_connector": getattr(self.storage_connector, "name", None),
            "features": [f.to_dict() for f in self._features],
            "query": self._query_dict,
            # A re-save must not wipe tags set via add_tag.
            "tags": (storage.read_metadata(self.meta_dir).get("tags", {})
                     if (self.meta_dir / "metadata.json").exists() else {}),
        })

    def _load_meta(self) -> None:
        meta = storage.read_metadata(self.meta_dir)
        self.description = meta.get("description", "")
        self.data_format = meta.get("data_format", "parquet")
        self.splits = meta.get("splits", {})
        self.seed = meta.get("seed")
        self.label = meta.get("label", [])
        self.coalesce = meta.get("coalesce", False)
        self.train_split = meta.get("train_split")
        sc = meta.get("storage_connector")
        if sc and self.storage_connector is None:
            try:
                self.storage_connector = self._fs.get_storage_connector(sc)
            except KeyError:
                # Registry entry gone (wiped registry, partial workspace
                # copy): keep the TD loadable — and deletable — with a
                # sentinel that names the problem on any data access.
                self.storage_connector = _MissingConnector(sc)
        self._features = [Feature.from_dict(f) for f in meta.get("features", [])]
        self._query_dict = meta.get("query")

    # -- materialization ------------------------------------------------------

    def save(self, data: Query | pd.DataFrame, write_options: dict | None = None) -> "TrainingDataset":
        if isinstance(data, Query):
            df = data.read()
            self._query_dict = data.to_dict()
        else:
            df = data.copy()
            df.columns = [str(c).lower() for c in df.columns]
        self._features = schema_from_dataframe(df, [], [])
        split_frames = self._split(df)
        for split_name, frame in split_frames.items():
            self._write_split(split_name, frame)
        self._save_meta()
        if self.statistics_config.enabled:
            stats_mod.save_statistics(
                self.meta_dir, "all", stats_mod.compute_statistics(df, self.statistics_config))
        return self

    def insert(self, data: Query | pd.DataFrame, overwrite: bool = True,
               write_options: dict | None = None) -> "TrainingDataset":
        """Re-materialize. For ``delta`` format, ``overwrite=False``
        appends a commit to each split's log instead (DeltaOnHops.ipynb
        append-mode write); ``overwrite=True`` starts a new table version
        that as_of reads can still see past."""
        if self.data_format == "delta" and not overwrite:
            df = data.read() if isinstance(data, Query) else data.copy()
            df.columns = [str(c).lower() for c in df.columns]
            for split_name, frame in self._split(df).items():
                storage.write_commit(self._split_dir(split_name), frame, operation="insert")
            return self
        return self.save(data, write_options)

    def _split(self, df: pd.DataFrame) -> dict[str, pd.DataFrame]:
        if not self.splits:
            return {"": df}
        fractions = np.array(list(self.splits.values()), dtype=float)
        fractions = fractions / fractions.sum()
        rng = np.random.RandomState(self.seed if self.seed is not None else 0)
        perm = rng.permutation(len(df))
        bounds = np.floor(np.cumsum(fractions) * len(df)).astype(int)
        bounds[-1] = len(df)  # float rounding must never drop tail rows
        out, start = {}, 0
        for split_name, end in zip(self.splits, bounds):
            out[split_name] = df.iloc[perm[start:end]].reset_index(drop=True)
            start = end
        return out

    def _split_dir(self, split: str):
        d = self.dir / (split or "data")
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _write_split(self, split: str, df: pd.DataFrame) -> None:
        d = self._split_dir(split)
        if self.data_format == "delta":
            # A save is a truncating commit: history before it survives
            # for as_of reads, current reads start from it.
            storage.write_commit(d, df, operation="insert", extra={"truncate": True})
            return
        # coalesce=True -> single output file (training-data-coalesced.ipynb:61);
        # otherwise shard for parallel reads.
        n_parts = 1 if (self.coalesce or len(df) < 10_000) else 8
        parts = np.array_split(np.arange(len(df)), n_parts)
        for i, idx in enumerate(parts):
            part = df.iloc[idx]
            stem = d / f"part-{i:05d}"
            if self.data_format == "parquet":
                part.to_parquet(f"{stem}.parquet", index=False)
            elif self.data_format == "csv":
                part.to_csv(f"{stem}.csv", index=False)
            elif self.data_format == "tfrecord":
                _write_tfrecord(part, f"{stem}.tfrecord")
            elif self.data_format == "recordio":
                _write_recordio(part, f"{stem}.rio")
            elif self.data_format == "petastorm":
                from hops_tpu_torch.featurestore import columnar

                columnar.write_dataset(d, part, part=i)

    # -- read path ------------------------------------------------------------

    def read(self, split: str | None = None, read_options: dict | None = None) -> pd.DataFrame:
        """``read_options`` (per format): ``{"as_of": ts}`` time-travels a
        delta TD; ``{"columns": [...]}`` column-projects a petastorm TD."""
        opts = read_options or {}
        d = self.dir / (split or ("data" if not self.splits else next(iter(self.splits))))
        if not d.exists():
            raise KeyError(f"split {split!r} of {self.name}_{self.version} not materialized")
        if self.data_format == "delta":
            return _read_delta(d, as_of=opts.get("as_of"))
        if self.data_format == "petastorm":
            from hops_tpu_torch.featurestore import columnar

            return columnar.read_dataset(d, columns=opts.get("columns"))
        frames = []
        for p in sorted(d.iterdir()):
            if p.suffix == ".parquet":
                frames.append(pd.read_parquet(p))
            elif p.suffix == ".csv":
                frames.append(pd.read_csv(p))
            elif p.suffix == ".tfrecord":
                frames.append(_read_tfrecord(p, self.features))
            elif p.suffix == ".rio":
                frames.append(_read_recordio(p))
        return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()

    def commit_details(self, split: str | None = None) -> dict[int, dict]:
        """Delta-format history: commit id -> metadata, oldest first
        (reference: Delta table history, DeltaOnHops.ipynb)."""
        if self.data_format != "delta":
            raise ValueError(f"commit_details requires delta format, not {self.data_format}")
        d = self.dir / (split or ("data" if not self.splits else next(iter(self.splits))))
        return {c: storage.read_commit_meta(d, c) for c in storage.commit_ids(d)}

    def row_group_reader(self, split: str | None = None,
                         columns: list[str] | None = None,
                         shuffle: bool = True, seed: int = 0):
        """Petastorm-format streaming reader: decoded numpy batches one
        parquet row group at a time, shuffled at row-group granularity
        (the ``make_reader`` role, PetastormHelloWorld.ipynb)."""
        if self.data_format != "petastorm":
            raise ValueError(f"row_group_reader requires petastorm format, not {self.data_format}")
        from hops_tpu_torch.featurestore import columnar

        d = self.dir / (split or ("data" if not self.splits else next(iter(self.splits))))
        return columnar.RowGroupReader(d, columns=columns, shuffle=shuffle, seed=seed)

    def show(self, n: int = 5, split: str | None = None) -> pd.DataFrame:
        return self.read(split=split).head(n)

    def get_statistics(self) -> dict:
        return stats_mod.load_statistics(self.meta_dir)

    # -- feeding (td.tf_data twin) --------------------------------------------

    def tf_data(self, target_name: str | None = None, split: str | None = None,
                feature_names: list[str] | None = None, is_training: bool = True):
        """Reference: ``td.tf_data(target_name, split, is_training)``
        (training_datasets.ipynb:409-429). Returns a :class:`DataFeeder`
        exposing ``numpy_iterator`` and ``loader`` (the torch path),
        ``tf_record_dataset`` and ``tf_csv_dataset``."""
        from hops_tpu_torch.featurestore.feed import DataFeeder

        return DataFeeder(self, target_name=target_name, split=split,
                          feature_names=feature_names, is_training=is_training)

    def loader(self, batch_size: int, target_name: str | None = None,
               split: str | None = None, is_training: bool = True,
               **kwargs: Any):
        """The staged parallel input pipeline over this TD
        (``featurestore/loader.py``): sharded readers → threaded decode
        → packed batch assembly → ``prefetch_to_device``, with
        snapshot/restore for preemption resume. Equivalent to
        ``td.tf_data(...).loader(batch_size, ...)``."""
        return self.tf_data(target_name=target_name, split=split,
                            is_training=is_training).loader(batch_size, **kwargs)

    # -- online serving vectors ----------------------------------------------

    @property
    def serving_keys(self) -> list[str]:
        """Union of primary keys of the query's feature groups."""
        q = self.query
        if q is None:
            return []
        keys: list[str] = []
        for fg in q.feature_groups:
            for k in fg.primary_key:
                if k not in keys:
                    keys.append(k)
        return keys

    def init_prepared_statement(self) -> None:
        """Open the online stores of the constituent groups (reference:
        JDBC prepared statements, feature_vector_model_serving.ipynb:175)."""
        q = self.query
        if q is None:
            raise ValueError("training dataset was not built from a query")
        self._serving_fgs = [fg for fg in q.feature_groups if fg.online_enabled]
        if not self._serving_fgs:
            raise ValueError("no online-enabled feature groups in this training dataset")
        for fg in self._serving_fgs:
            fg.online_store()
        self._serving_prepared = True

    def get_serving_vector(self, entry: dict[str, Any]) -> list:
        """Point lookup across the online stores, returned in training-data
        feature order minus the label (the reference's contract)."""
        if not self._serving_prepared:
            self.init_prepared_statement()
        merged: dict[str, Any] = {}
        for fg in self._serving_fgs:
            row = fg.get_serving_row(entry)
            if row is not None:
                merged.update(row)
        order = [f.name for f in self.features if f.name not in self.label]
        return [merged.get(name) for name in order]

    def get_serving_vectors(self, entries: list[dict[str, Any]]) -> list[list]:
        return [self.get_serving_vector(e) for e in entries]

    # -- tags -----------------------------------------------------------------

    def add_tag(self, name: str, value: Any) -> None:
        meta = storage.read_metadata(self.meta_dir)
        meta.setdefault("tags", {})[name] = value
        storage.write_metadata(self.meta_dir, meta)

    def get_tag(self, name: str) -> Any:
        return storage.read_metadata(self.meta_dir).get("tags", {}).get(name)

    def get_tags(self) -> dict:
        return storage.read_metadata(self.meta_dir).get("tags", {})

    def delete_tag(self, name: str) -> None:
        meta = storage.read_metadata(self.meta_dir)
        meta.get("tags", {}).pop(name, None)
        storage.write_metadata(self.meta_dir, meta)

    def delete(self) -> None:
        import shutil

        dirs = {self.meta_dir}
        try:
            dirs.add(self.dir)
        except (ValueError, RuntimeError):
            # Unresolvable connector (SQL-typed, or mount absent on this
            # host): the registry entry must still be removable.
            pass
        for d in dirs:
            if d.exists():
                shutil.rmtree(d)


# -- format codecs ------------------------------------------------------------


def _read_delta(d, as_of=None) -> pd.DataFrame:
    """Replay a delta TD split: commits from the last truncating commit
    at-or-before ``as_of`` (truncate = a fresh save over the table).
    The replay itself is storage.read_as_of — one commit-log codec."""
    ts = storage.resolve_timestamp(as_of)
    ids = [c for c in storage.commit_ids(d) if ts is None or c <= ts]
    truncates = [c for c in ids if storage.read_commit_meta(d, c).get("truncate")]
    exclude_until = truncates[-1] - 1 if truncates else None
    if not ids:
        return pd.DataFrame()
    return storage.read_as_of(d, primary_key=[], as_of=ts, exclude_until=exclude_until)


def _write_tfrecord(df: pd.DataFrame, path: str) -> None:
    try:
        import tensorflow as tf
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("tfrecord format requires tensorflow") from e

    with tf.io.TFRecordWriter(path) as w:
        for rec in df.to_dict(orient="records"):
            feats = {}
            for k, v in rec.items():
                if isinstance(v, (int, np.integer, bool)):
                    feats[k] = tf.train.Feature(int64_list=tf.train.Int64List(value=[int(v)]))
                elif isinstance(v, (float, np.floating)):
                    feats[k] = tf.train.Feature(float_list=tf.train.FloatList(value=[float(v)]))
                elif isinstance(v, (list, np.ndarray)):
                    feats[k] = tf.train.Feature(
                        float_list=tf.train.FloatList(value=[float(x) for x in v]))
                else:
                    feats[k] = tf.train.Feature(
                        bytes_list=tf.train.BytesList(value=[str(v).encode()]))
            w.write(tf.train.Example(features=tf.train.Features(feature=feats)).SerializeToString())


def _read_tfrecord(path, features: list[Feature]) -> pd.DataFrame:
    import tensorflow as tf

    rows = []
    for raw in tf.data.TFRecordDataset(str(path)):
        ex = tf.train.Example()
        ex.ParseFromString(raw.numpy())
        row = {}
        for k, feat in ex.features.feature.items():
            kind = feat.WhichOneof("kind")
            vals = list(getattr(feat, kind).value)
            if kind == "bytes_list":
                vals = [v.decode() for v in vals]
            row[k] = vals[0] if len(vals) == 1 else vals
        rows.append(row)
    return pd.DataFrame(rows)


def _write_recordio(df: pd.DataFrame, path: str) -> None:
    from hops_tpu_torch.native.recordio import RecordWriter

    with RecordWriter(path) as w:
        for rec in df.to_dict(orient="records"):
            w.write(json.dumps(rec, default=str).encode())


def _read_recordio(path) -> pd.DataFrame:
    from hops_tpu_torch.native.recordio import RecordReader

    with RecordReader(path) as r:
        return pd.DataFrame(
            [json.loads(rec) for rec in r.read_batch(range(len(r)))]
        )
