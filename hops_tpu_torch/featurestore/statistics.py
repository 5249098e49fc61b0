"""Descriptive statistics for feature groups / training datasets (counterpart of
``hops_tpu/featurestore/statistics.py``, copied with the port's imports).

The reference computed descriptive stats, histograms and correlations as
a Spark job at FG/TD creation, controlled by ``statistics_config``
(feature_engineering.ipynb:177-183, ComputeFeatures.scala:114 —
SURVEY.md §5 "Metrics"). Same knobs here, computed with pandas/NumPy.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pandas as pd


@dataclasses.dataclass
class StatisticsConfig:
    """Mirrors the reference's ``StatisticsConfig(descriptive, histograms,
    correlations)`` (ComputeFeatures.scala:114)."""

    enabled: bool = True
    histograms: bool = False
    correlations: bool = False
    columns: list[str] | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "StatisticsConfig":
        if isinstance(d, StatisticsConfig):
            return d
        if isinstance(d, bool):
            return cls(enabled=d)
        return cls(**d) if d else cls()


def compute_statistics(df: pd.DataFrame, cfg: StatisticsConfig) -> dict:
    """Descriptive stats (+ optional histograms/correlations) as a JSON-able dict."""
    if not cfg.enabled or df.empty:
        return {}
    cols = cfg.columns or list(df.columns)
    out: dict = {"row_count": int(len(df)), "features": {}}
    numeric = df.select_dtypes(include=[np.number])
    for c in cols:
        if c not in df.columns:
            continue
        s = df[c]
        # Tensor columns (petastorm-style object cells) are unhashable;
        # describe their presence only. Sniff the first non-null cell —
        # row 0 may be missing.
        probe = s.dropna()
        if s.dtype == object and len(probe) and isinstance(probe.iloc[0], np.ndarray):
            out["features"][c] = {
                "count": int(s.count()),
                "num_missing": int(s.isna().sum()),
                "tensor_shape": list(np.asarray(probe.iloc[0]).shape),
            }
            continue
        entry: dict = {
            "count": int(s.count()),
            "num_missing": int(s.isna().sum()),
            "distinct": int(s.nunique()),
        }
        if c in numeric.columns:
            desc = s.describe()
            entry.update(
                mean=float(desc["mean"]),
                stddev=float(desc["std"]) if len(s) > 1 else 0.0,
                min=float(desc["min"]),
                max=float(desc["max"]),
                p25=float(desc["25%"]),
                p50=float(desc["50%"]),
                p75=float(desc["75%"]),
            )
            if cfg.histograms:
                counts, edges = np.histogram(s.dropna().to_numpy(dtype=float), bins=10)
                entry["histogram"] = {
                    "counts": counts.tolist(),
                    "edges": [float(e) for e in edges],
                }
        out["features"][c] = entry
    if cfg.correlations and len(numeric.columns) > 1:
        corr = numeric[[c for c in cols if c in numeric.columns]].corr()
        out["correlations"] = {
            a: {b: (None if pd.isna(v) else float(v)) for b, v in row.items()}
            for a, row in corr.to_dict().items()
        }
    return out


def save_statistics(d: Path, name: str, stats: dict) -> None:
    sdir = d / "statistics"
    sdir.mkdir(parents=True, exist_ok=True)
    (sdir / f"{name}.json").write_text(json.dumps(stats, indent=2))


def load_statistics(d: Path, name: str | None = None) -> dict:
    sdir = d / "statistics"
    if not sdir.exists():
        return {}
    files = sorted(sdir.glob("*.json"))
    if not files:
        return {}
    target = sdir / f"{name}.json" if name else files[-1]
    return json.loads(target.read_text())
