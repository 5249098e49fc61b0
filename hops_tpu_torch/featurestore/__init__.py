"""Feature-store layer (counterpart of ``hops_tpu/featurestore``): so far
its input pipeline.

Ported: the staged, resumable batch loader (``loader.py``: sources over
arrays, native RecordIO shards and pubsub streams) and the feeder with
its device prefetch (``feed.py``: pinned staging, host-to-device copies
on a side stream, each rank's rows of the global batch on its own
device). The rest of the JAX package's feature store — connections,
feature groups, queries, training datasets, statistics, validation and
online serving, and the serving host's ``feature_config`` — is
``ROADMAP.md`` Queue 1 item 7.
"""

from __future__ import annotations

from hops_tpu_torch.featurestore.loader import (  # noqa: F401
    ArraySource,
    DataLoader,
    RecordIOSource,
    Source,
    StreamingSource,
    StreamSpan,
)

__all__ = [
    "ArraySource",
    "DataLoader",
    "RecordIOSource",
    "Source",
    "StreamingSource",
    "StreamSpan",
]
