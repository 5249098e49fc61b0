"""Fluent builder facade — the Scala client's ergonomics in Python (counterpart of
``hops_tpu/featurestore/builders.py``, copied with the port's imports).

The reference's JVM client builds entities with a chained builder
(featurestore_tour/src/.../ComputeFeatures.scala:108-115 feature
groups, :312-327 training datasets; connection via
``HopsworksConnection.builder.build`` Main.scala-side). SURVEY.md §2.6
records this as the one un-twinned component; this module closes it as
a facade over the kwargs APIs — same single implementation underneath,
so reference Scala call shapes translate line for line::

    fg = (fs.createFeatureGroup()
            .name("games_features")
            .version(1)
            .description("Features of games")
            .timeTravelFormat(TimeTravelFormat.HUDI)
            .primaryKeys(["home_team_id"])
            .partitionKeys(["score"])
            .statisticsConfig(StatisticsConfig(True, True, True))
            .build())
    fg.save(df)

    td = (fs.createTrainingDataset()
            .name("tour_td").version(1)
            .dataFormat(DataFormat.TFRECORD)
            .build())
    td.save(query)
"""

from __future__ import annotations

from typing import Any

from hops_tpu_torch.featurestore.statistics import StatisticsConfig


class TimeTravelFormat:
    """Scala enum twin (ComputeFeatures.scala:112,122)."""

    NONE = None
    HUDI = "COMMIT_LOG"  # the commit-log store IS the Hudi role here
    COMMIT_LOG = "COMMIT_LOG"


class DataFormat:
    """Scala enum twin (ComputeFeatures.scala:325)."""

    CSV = "csv"
    TFRECORD = "tfrecord"
    PARQUET = "parquet"
    PETASTORM = "petastorm"
    DELTA = "delta"
    RECORDIO = "recordio"


def _stats_arg(value: Any) -> Any:
    # The Scala-positional tuple form; StatisticsConfig/dict pass through
    # (the entities' from_dict accepts both unchanged).
    if isinstance(value, (tuple, list)):
        return dict(zip(("enabled", "histograms", "correlations"), value))
    return value


class _Builder:
    """Chained-setter base: setters map camelCase -> snake_case kwargs,
    with ``_renames`` only for names the mechanical mapping can't derive
    (plural Scala setters -> singular kwargs)."""

    _renames: dict[str, str] = {}

    def __init__(self, fs=None):
        self._fs = fs
        self._kw: dict[str, Any] = {}

    def __getattr__(self, attr: str):
        if attr.startswith("_"):
            raise AttributeError(attr)
        key = self._renames.get(attr)
        if key is None:
            # camelCase -> snake_case (primaryKeys -> primary_keys)
            key = "".join(f"_{c.lower()}" if c.isupper() else c for c in attr)

        def setter(value):
            self._kw[key] = value
            return self

        return setter


class FeatureGroupBuilder(_Builder):
    """`fs.createFeatureGroup()` — ComputeFeatures.scala:108-115."""

    _renames = {
        "primaryKeys": "primary_key",
        "partitionKeys": "partition_key",
    }

    def build(self):
        kw = dict(self._kw)
        name = kw.pop("name")
        version = kw.pop("version", None)
        if "statistics_config" in kw:
            kw["statistics_config"] = _stats_arg(kw["statistics_config"])
        return self._fs.create_feature_group(name, version=version, **kw)


class TrainingDatasetBuilder(_Builder):
    """`fs.createTrainingDataset()` — ComputeFeatures.scala:320-327."""


    def build(self):
        kw = dict(self._kw)
        name = kw.pop("name")
        version = kw.pop("version", None)
        if "statistics_config" in kw:
            kw["statistics_config"] = _stats_arg(kw["statistics_config"])
        return self._fs.create_training_dataset(name, version=version, **kw)


class _ConnBuilder(_Builder):
    def build(self):
        from hops_tpu_torch.featurestore.connection import connection

        return connection(**self._kw)


class HopsworksConnection:
    """`HopsworksConnection.builder.build()` (Scala Main.scala usage)."""

    # `.builder` is an attribute in the Scala API, not a call.
    class _BuilderDescriptor:
        def __get__(self, obj, objtype=None):
            return _ConnBuilder()

    builder = _BuilderDescriptor()
