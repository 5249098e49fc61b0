"""Feature-store layer (counterpart of ``hops_tpu/featurestore``) — the
port's `hsfs` equivalent.

Feature groups are schema'd, versioned Parquet datasets with a
log-structured commit history (Hudi-style time travel); queries are a
lazy select/join/filter/``as_of`` algebra executed with pandas/pyarrow
on the host (feature engineering is host-side prep work — the card only
ever sees the materialized training batches); training datasets
materialize query results into split files and feed torch through the
feeder and the staged loader (``feed.py``, ``loader.py``: pinned
staging, host-to-device copies on a side stream); online serving
vectors come from a sharded embedded KV store (``online.py`` over the
native engine of ``native/``, ``online_serving.py``), and the serving
host's ``feature_config`` joins them into model inputs at request time.
The on-disk layout is the JAX package's, so a store written by one
package reads in the other.

Usage mirrors the reference (feature_engineering.ipynb:92):

    import hops_tpu_torch.featurestore as hsfs
    conn = hsfs.connection()
    fs = conn.get_feature_store()
    fg = fs.create_feature_group("sales", version=1, primary_key=["id"])
    fg.save(df)
    q = fg.select(["f1", "f2"]).join(other.select_all()).filter(fg["f1"] > 0)
    td = fs.create_training_dataset("dataset", version=1, splits={"train": 0.8, "test": 0.2})
    td.save(q)
"""

from __future__ import annotations

from hops_tpu_torch.featurestore.connection import Connection, connection  # noqa: F401
from hops_tpu_torch.featurestore.feature import Feature, Filter, Logic  # noqa: F401
from hops_tpu_torch.featurestore.feature_group import FeatureGroup  # noqa: F401
from hops_tpu_torch.featurestore.loader import (  # noqa: F401
    ArraySource,
    DataLoader,
    RecordIOSource,
    Source,
    StreamingSource,
    StreamSpan,
)
from hops_tpu_torch.featurestore.online_serving import (  # noqa: F401
    FeatureJoinPredictor,
    Materializer,
    ShardedOnlineStore,
    open_sharded_store,
)
from hops_tpu_torch.featurestore.query import Query  # noqa: F401
from hops_tpu_torch.featurestore.statistics import StatisticsConfig  # noqa: F401
from hops_tpu_torch.featurestore.training_dataset import TrainingDataset  # noqa: F401
from hops_tpu_torch.featurestore.validation import Expectation, Rule  # noqa: F401
from hops_tpu_torch.featurestore import bias  # noqa: F401

__all__ = [
    "Connection",
    "connection",
    "ArraySource",
    "DataLoader",
    "RecordIOSource",
    "Source",
    "StreamingSource",
    "StreamSpan",
    "Feature",
    "Filter",
    "Logic",
    "FeatureGroup",
    "FeatureJoinPredictor",
    "Materializer",
    "ShardedOnlineStore",
    "open_sharded_store",
    "Query",
    "StatisticsConfig",
    "TrainingDataset",
    "Expectation",
    "Rule",
    "bias",
]
