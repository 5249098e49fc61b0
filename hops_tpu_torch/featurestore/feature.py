"""Feature metadata and filter expressions (counterpart of
``hops_tpu/featurestore/feature.py``, copied with the port's imports).

The reference's query filters compose ``Feature`` comparisons with ``&``
(feature_exploration.ipynb cells 14-16, SURVEY.md §2.6 "Query algebra").
Here a comparison produces a :class:`Filter`, and ``&``/``|`` produce a
:class:`Logic` tree that :meth:`evaluate`s against a pandas DataFrame at
query-execution time.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import pandas as pd

# pandas/pyarrow dtype -> feature-store type string (offline types follow
# the reference's Hive-ish names: feature_engineering.ipynb schema output).
_DTYPE_TO_TYPE = {
    "int8": "int",
    "int16": "int",
    "int32": "int",
    "int64": "bigint",
    "uint8": "int",
    "uint16": "int",
    "uint32": "bigint",
    "uint64": "bigint",
    "float16": "float",
    "float32": "float",
    "float64": "double",
    "bool": "boolean",
    "object": "string",
    "string": "string",
    "str": "string",
}


def infer_type(series: pd.Series) -> str:
    """Map a pandas column dtype to a feature type string."""
    dtype = str(series.dtype)
    if dtype.startswith("datetime"):
        return "timestamp"
    if dtype in _DTYPE_TO_TYPE:
        return _DTYPE_TO_TYPE[dtype]
    if dtype.startswith("category"):
        return "string"
    # array-valued columns (e.g. embeddings stored as lists)
    if len(series) and isinstance(series.iloc[0], (list, np.ndarray)):
        return "array<double>"
    return "string"


@dataclasses.dataclass
class Feature:
    """A named, typed column of a feature group.

    Comparison operators build :class:`Filter` conditions, mirroring the
    reference's ``fg.select_all().filter(fg.feature > 10)`` idiom.
    """

    name: str
    type: str = "double"
    primary: bool = False
    partition: bool = False
    description: str = ""

    def __eq__(self, other: Any) -> "Filter":  # type: ignore[override]
        return Filter(self, "==", other)

    def __ne__(self, other: Any) -> "Filter":  # type: ignore[override]
        return Filter(self, "!=", other)

    def __lt__(self, other: Any) -> "Filter":
        return Filter(self, "<", other)

    def __le__(self, other: Any) -> "Filter":
        return Filter(self, "<=", other)

    def __gt__(self, other: Any) -> "Filter":
        return Filter(self, ">", other)

    def __ge__(self, other: Any) -> "Filter":
        return Filter(self, ">=", other)

    def isin(self, values: list) -> "Filter":
        return Filter(self, "in", list(values))

    def like(self, pattern: str) -> "Filter":
        """SQL-LIKE match; ``%`` wildcards."""
        return Filter(self, "like", pattern)

    def contains(self, values: list) -> "Filter":
        return Filter(self, "in", list(values))

    def __hash__(self) -> int:
        return hash((self.name, self.type))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Feature":
        return cls(**{k: d[k] for k in ("name", "type", "primary", "partition", "description") if k in d})


class _Condition:
    """Base: things that evaluate to a boolean mask over a DataFrame."""

    def __and__(self, other: "_Condition") -> "Logic":
        return Logic("AND", self, other)

    def __or__(self, other: "_Condition") -> "Logic":
        return Logic("OR", self, other)

    def evaluate(self, df: pd.DataFrame) -> pd.Series:
        raise NotImplementedError


class Filter(_Condition):
    """A single comparison ``feature <op> value``."""

    def __init__(self, feature: Feature, op: str, value: Any):
        self.feature = feature
        self.op = op
        self.value = value

    def evaluate(self, df: pd.DataFrame) -> pd.Series:
        col = df[self.feature.name]
        v = self.value
        if self.op == "==":
            return col == v
        if self.op == "!=":
            return col != v
        if self.op == "<":
            return col < v
        if self.op == "<=":
            return col <= v
        if self.op == ">":
            return col > v
        if self.op == ">=":
            return col >= v
        if self.op == "in":
            return col.isin(v)
        if self.op == "like":
            regex = "^" + "".join(
                ".*" if c == "%" else ("." if c == "_" else re.escape(c)) for c in v
            ) + "$"
            return col.astype(str).str.match(regex)
        raise ValueError(f"unknown filter op {self.op!r}")

    def __repr__(self) -> str:
        return f"Filter({self.feature.name} {self.op} {self.value!r})"


class Logic(_Condition):
    """AND/OR composition of conditions."""

    def __init__(self, op: str, left: _Condition, right: _Condition):
        self.op = op
        self.left = left
        self.right = right

    def evaluate(self, df: pd.DataFrame) -> pd.Series:
        lhs, rhs = self.left.evaluate(df), self.right.evaluate(df)
        return (lhs & rhs) if self.op == "AND" else (lhs | rhs)

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"


def schema_from_dataframe(
    df: pd.DataFrame,
    primary_key: list[str] | None = None,
    partition_key: list[str] | None = None,
) -> list[Feature]:
    """Infer a feature schema from a DataFrame (reference: implicit in
    ``fg.save(df)`` — the server registered the Spark schema)."""
    primary = set(k.lower() for k in (primary_key or []))
    partition = set(k.lower() for k in (partition_key or []))
    feats = []
    for name in df.columns:
        feats.append(
            Feature(
                name=str(name),
                type=infer_type(df[name]),
                primary=str(name).lower() in primary,
                partition=str(name).lower() in partition,
            )
        )
    return feats
