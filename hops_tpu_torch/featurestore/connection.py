"""Connection + FeatureStore handles (counterpart of
``hops_tpu/featurestore/connection.py``, copied with the port's imports).

Reference: ``hsfs.connection()`` in-cluster and
``hsfs.connection(host, project, engine="hive", api_key_value=...)`` for
external clients (feature_engineering.ipynb:92; aws-sagemaker.ipynb —
SURVEY.md §2.6). Here a "connection" binds to a project workspace on the
shared filesystem; ``engine`` selects the execution engine for query
materialization ("pandas" is the only in-process engine — it plays the
role both Spark and Hive played in the reference).
"""

from __future__ import annotations

from typing import Any

from hops_tpu_torch.featurestore import storage
from hops_tpu_torch.featurestore.feature_group import FeatureGroup, OnDemandFeatureGroup
from hops_tpu_torch.featurestore.query import Query
from hops_tpu_torch.featurestore.training_dataset import TrainingDataset
from hops_tpu_torch.featurestore.validation import Expectation, Rule, RULE_DEFINITIONS
from hops_tpu_torch.runtime import config


class Connection:
    def __init__(self, host: str | None = None, project: str | None = None,
                 engine: str = "pandas", api_key_value: str | None = None):
        if project:
            config.configure(project=project)
        self.host = host
        self.engine = engine
        self._api_key = api_key_value

    def get_feature_store(self, name: str | None = None) -> "FeatureStore":
        return FeatureStore(self, name or config.runtime().project)

    # Reference: connection.get_rules()/get_rule (feature_validation_python.ipynb:249).
    def get_rules(self) -> list[dict]:
        return [dict(name=n, **d) for n, d in RULE_DEFINITIONS.items()]

    def get_rule(self, name: str) -> dict:
        return dict(name=name, **RULE_DEFINITIONS[name.upper()])

    def close(self) -> None:
        pass


def connection(host: str | None = None, project: str | None = None,
               engine: str = "pandas", api_key_value: str | None = None,
               **_ignored: Any) -> Connection:
    """Reference: ``hsfs.connection(...)``."""
    return Connection(host=host, project=project, engine=engine, api_key_value=api_key_value)


class FeatureStore:
    """Project-scoped feature store handle (the reference's ``fs``)."""

    def __init__(self, conn: Connection, project: str):
        self._conn = conn
        self.project = project

    # -- Scala-builder ergonomics (featurestore/builders.py) ------------------

    def createFeatureGroup(self):  # noqa: N802 — Scala client surface
        from hops_tpu_torch.featurestore.builders import FeatureGroupBuilder

        return FeatureGroupBuilder(self)

    def createTrainingDataset(self):  # noqa: N802
        from hops_tpu_torch.featurestore.builders import TrainingDatasetBuilder

        return TrainingDatasetBuilder(self)

    def getFeatureGroup(self, name: str, version: int | None = None):  # noqa: N802
        return self.get_feature_group(name, version)

    def getName(self) -> str:  # noqa: N802
        return self.project

    # -- feature groups -------------------------------------------------------

    def create_feature_group(self, name: str, version: int | None = None, **kwargs) -> FeatureGroup:
        if version is None:
            version = storage.next_version("featuregroups", name)
        return FeatureGroup(self, name, version, **kwargs)

    def get_feature_group(self, name: str, version: int | None = None) -> FeatureGroup:
        if version is None:
            versions = storage.list_versions("featuregroups", name)
            if not versions:
                raise KeyError(f"no feature group named {name!r}")
            version = versions[-1]
        d = storage.entity_dir("featuregroups", name, version)
        if not (d / "metadata.json").exists():
            raise KeyError(f"feature group {name}_{version} does not exist")
        meta = storage.read_metadata(d)
        cls = OnDemandFeatureGroup if meta.get("on_demand") else FeatureGroup
        fg = cls(self, name, version)
        fg._load_meta()
        if meta.get("on_demand"):
            fg.query = meta.get("query", "")
            sc = meta.get("storage_connector")
            fg.storage_connector = self.get_storage_connector(sc) if sc else None
        return fg

    def get_feature_groups(self, name: str) -> list[FeatureGroup]:
        return [self.get_feature_group(name, v) for v in storage.list_versions("featuregroups", name)]

    def create_on_demand_feature_group(
        self, name: str, version: int | None = None, query: str = "",
        storage_connector=None, **kwargs
    ) -> OnDemandFeatureGroup:
        if version is None:
            version = storage.next_version("featuregroups", name)
        return OnDemandFeatureGroup(
            self, name, version, query=query, storage_connector=storage_connector, **kwargs
        )

    # -- training datasets ----------------------------------------------------

    def create_training_dataset(self, name: str, version: int | None = None, **kwargs) -> TrainingDataset:
        if version is None:
            version = storage.next_version("trainingdatasets", name)
        return TrainingDataset(self, name, version, **kwargs)

    def get_training_dataset(self, name: str, version: int | None = None) -> TrainingDataset:
        if version is None:
            versions = storage.list_versions("trainingdatasets", name)
            if not versions:
                raise KeyError(f"no training dataset named {name!r}")
            version = versions[-1]
        td = TrainingDataset(self, name, version)
        td._load_meta()
        return td

    # -- queries --------------------------------------------------------------

    def construct_query(self, d: dict) -> Query:
        return Query.from_dict(self, d)

    def sql(self, query: str, online: bool = False):
        """Ad-hoc SQL over registered feature groups (reference:
        ``fs.sql(...)`` routed to Spark/Hive)."""
        from hops_tpu_torch.sql import gateway

        return gateway.execute(query, feature_store=self)

    # -- expectations (reference: feature_validation_python.ipynb) ------------

    def create_expectation(self, name: str, description: str = "",
                           features: list[str] | None = None,
                           rules: list[Rule] | None = None) -> Expectation:
        return Expectation(self, name, description=description,
                           features=features or [], rules=rules or [])

    def get_expectation(self, name: str) -> Expectation:
        return Expectation.load(self, name)

    def get_expectations(self) -> list[Expectation]:
        d = storage.feature_store_root() / "expectations"
        if not d.exists():
            return []
        return [Expectation.load(self, p.stem) for p in sorted(d.glob("*.json"))]

    def delete_expectation(self, name: str) -> None:
        p = storage.feature_store_root() / "expectations" / f"{name}.json"
        if p.exists():
            p.unlink()

    # -- storage connectors ---------------------------------------------------

    def get_storage_connector(self, name: str, connector_type: str | None = None):
        from hops_tpu_torch.featurestore import connectors

        return connectors.get(name, connector_type)

    def create_storage_connector(self, name: str, connector_type: str, **options):
        from hops_tpu_torch.featurestore import connectors

        return connectors.create(name, connector_type, **options)
