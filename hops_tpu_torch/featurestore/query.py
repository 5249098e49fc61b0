"""Lazy query algebra over feature groups (counterpart of
``hops_tpu/featurestore/query.py``, copied with the port's imports).

Reference surface (SURVEY.md §2.6, feature_exploration.ipynb cells
10-31): ``fg.select(...).join(other.select_all(), on=[...],
join_type="left").filter(fg["f"] > 10).as_of(ts)`` → lazy until
``read()``/``show(n)``. Execution here is pandas merges on the host —
feature joins are metadata-scale work; the card only sees materialized
training batches.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import pandas as pd

from hops_tpu_torch.featurestore.feature import Feature, _Condition

if TYPE_CHECKING:
    from hops_tpu_torch.featurestore.feature_group import FeatureGroup


@dataclasses.dataclass
class Join:
    query: "Query"
    on: list[str]
    left_on: list[str]
    right_on: list[str]
    join_type: str = "inner"
    prefix: str | None = None


class Query:
    """Immutable-ish query tree rooted at one feature group."""

    def __init__(self, feature_group: "FeatureGroup", features: list[Feature]):
        self._fg = feature_group
        self._features = list(features)
        self._joins: list[Join] = []
        self._filters: list[_Condition] = []
        self._as_of: Any = None

    # -- algebra --------------------------------------------------------------

    def join(
        self,
        other: "Query",
        on: list[str] | None = None,
        left_on: list[str] | None = None,
        right_on: list[str] | None = None,
        join_type: str = "inner",
        prefix: str | None = None,
    ) -> "Query":
        """Reference: join on explicit keys or (default) the shared primary
        key of the two root groups (feature_exploration.ipynb cell 27-29)."""
        if on is None and left_on is None:
            shared = [k for k in self._fg.primary_key if k in other._fg.primary_key]
            on = shared or None
            if on is None:
                raise ValueError(
                    "no shared primary key between "
                    f"{self._fg.name} and {other._fg.name}; pass on=/left_on="
                )
        self._joins.append(
            Join(
                query=other,
                on=[k.lower() for k in (on or [])],
                left_on=[k.lower() for k in (left_on or [])],
                right_on=[k.lower() for k in (right_on or [])],
                join_type=join_type,
                prefix=prefix,
            )
        )
        return self

    def filter(self, condition: _Condition) -> "Query":
        self._filters.append(condition)
        return self

    def as_of(self, wallclock_time) -> "Query":
        """Point-in-time read over every group in the tree (reference:
        ``query.as_of``, time_travel_python.ipynb:1222-1272)."""
        self._as_of = wallclock_time
        return self

    @property
    def features(self) -> list[Feature]:
        feats = list(self._features)
        for j in self._joins:
            feats.extend(j.query.features)
        return feats

    @property
    def feature_groups(self) -> list["FeatureGroup"]:
        fgs = [self._fg]
        for j in self._joins:
            fgs.extend(j.query.feature_groups)
        return fgs

    # -- execution ------------------------------------------------------------

    def _base_frame(self, as_of, online: bool) -> pd.DataFrame:
        if online:
            if not self._fg.online_enabled:
                raise ValueError(
                    f"feature group {self._fg.name}_{self._fg.version} is not "
                    "online_enabled; online=True would silently return no rows"
                )
            df = self._fg.read(online=True)
        else:
            df = self._fg.read(wallclock_time=as_of)
        if df.empty:
            return pd.DataFrame(columns=[f.name for f in self._fg.features])
        return df

    def _output_columns(self) -> list[str]:
        """Merged-frame column names of the selected features, in order,
        accounting for join-key dedup, prefixes, and pandas' collision
        suffix ("_right")."""
        cols = [f.name for f in self._features]
        for j in self._joins:
            key_cols = set(j.on or j.right_on)
            for c in j.query._output_columns():
                if j.on and c in key_cols:
                    if c not in cols:
                        cols.append(c)  # merge keeps one copy under the key name
                    continue
                if j.prefix and c not in key_cols:
                    c = f"{j.prefix}{c}"
                cols.append(c if c not in cols else f"{c}_right")
        return cols

    def read(self, online: bool = False, dataframe_type: str = "pandas",
             _extra_keep: tuple = (), _as_of=None, _project: bool = True):
        """Execute the query. ``online=True`` runs the same select/join/
        filter tree against every group's online store (latest values
        only — reference: ``query.show(n, online=True)``,
        feature_exploration.ipynb cell 12); the offline commit log is
        not consulted, so rows committed offline-only are absent.
        """
        # as_of flows down from the root read without mutating children, so
        # a shared sub-query is unaffected by a parent's point-in-time read.
        as_of = self._as_of if self._as_of is not None else _as_of
        if online and as_of is not None:
            raise ValueError(
                "online=True reads latest serving values; it cannot be "
                "combined with as_of() time travel"
            )
        df = self._base_frame(as_of, online)
        # Columns needed for execution: selected + join keys + filter columns
        # (+ anything a parent needs from this side: its join keys AND its
        # filter columns, which may live in this group or deeper).
        filter_cols: set[str] = set()
        for cond in self._filters:
            filter_cols.update(_condition_columns(cond))
        keep = {f.name for f in self._features} | set(_extra_keep) | filter_cols
        for j in self._joins:
            keep.update(j.on or j.left_on)
        df = df[[c for c in df.columns if c in keep]]

        pass_down = tuple(filter_cols) + tuple(_extra_keep)
        for j in self._joins:
            right_keys = tuple(j.on or j.right_on)
            right = j.query.read(
                online=online, _extra_keep=right_keys + pass_down,
                _as_of=as_of, _project=False,
            )
            if j.prefix:
                key_cols = set(j.on or j.right_on)
                right = right.rename(
                    columns={c: f"{j.prefix}{c}" for c in right.columns if c not in key_cols}
                )
            kwargs: dict = {"how": j.join_type}
            if j.on:
                kwargs["on"] = j.on
            else:
                kwargs["left_on"], kwargs["right_on"] = j.left_on, j.right_on
            df = df.merge(right, suffixes=("", "_right"), **kwargs)

        for cond in self._filters:
            df = df[cond.evaluate(df)]
        if _project:
            # Drop execution-only columns (filter cols, join keys) so the
            # result — and any TD schema derived from it — is exactly the
            # selection.
            df = df[[c for c in self._output_columns() if c in df.columns]]
        df = df.reset_index(drop=True)
        return _convert(df, dataframe_type) if _project else df

    def show(self, n: int = 5, online: bool = False) -> pd.DataFrame:
        return self.read(online=online).head(n)

    # -- introspection --------------------------------------------------------

    def to_string(self) -> str:
        """SQL-ish rendering for debugging (reference: query.to_string())."""
        cols = ", ".join(f.name for f in self._features) or "*"
        sql = f"SELECT {cols} FROM {self._fg.name}_{self._fg.version}"
        for j in self._joins:
            keys = j.on or list(zip(j.left_on, j.right_on))
            sql += f" {j.join_type.upper()} JOIN {j.query._fg.name}_{j.query._fg.version} ON {keys}"
        if self._filters:
            sql += " WHERE " + " AND ".join(repr(f) for f in self._filters)
        if self._as_of is not None:
            sql += f" AS OF {self._as_of}"
        return sql

    def to_dict(self) -> dict:
        """Replayable description persisted with training datasets
        (reference: ``td.query`` replay, training_datasets.ipynb cell 14)."""
        return {
            "feature_group": {"name": self._fg.name, "version": self._fg.version},
            "features": [f.name for f in self._features],
            "joins": [
                {
                    "query": j.query.to_dict(),
                    "on": j.on,
                    "left_on": j.left_on,
                    "right_on": j.right_on,
                    "join_type": j.join_type,
                    "prefix": j.prefix,
                }
                for j in self._joins
            ],
            "as_of": (
                self._as_of
                if self._as_of is None or isinstance(self._as_of, (int, float, str))
                else str(self._as_of)
            ),
        }

    @classmethod
    def from_dict(cls, feature_store, d: dict) -> "Query":
        fg = feature_store.get_feature_group(
            d["feature_group"]["name"], d["feature_group"]["version"]
        )
        q = fg.select(d["features"]) if d.get("features") else fg.select_all()
        for j in d.get("joins", []):
            q.join(
                cls.from_dict(feature_store, j["query"]),
                on=j["on"] or None,
                left_on=j["left_on"] or None,
                right_on=j["right_on"] or None,
                join_type=j["join_type"],
                prefix=j.get("prefix"),
            )
        if d.get("as_of") is not None:
            q.as_of(d["as_of"])
        return q

    def __repr__(self) -> str:
        return f"Query({self.to_string()})"


def _convert(df: pd.DataFrame, dataframe_type: str):
    """Result conversion — reference hsfs ``dataframe_type`` values
    pandas/numpy/python (spark has no counterpart on the card)."""
    kind = dataframe_type.lower()
    if kind in ("pandas", "default"):
        return df
    if kind == "numpy":
        return df.to_numpy()
    if kind == "python":
        return df.to_dict("records")
    raise ValueError(
        f"unsupported dataframe_type {dataframe_type!r}; "
        "expected pandas | numpy | python"
    )


def _condition_columns(cond) -> set[str]:
    from hops_tpu_torch.featurestore.feature import Filter, Logic

    if isinstance(cond, Filter):
        return {cond.feature.name}
    if isinstance(cond, Logic):
        return _condition_columns(cond.left) | _condition_columns(cond.right)
    return set()
