"""Slice-based bias and fairness analysis for feature data and models (counterpart of
``hops_tpu/featurestore/bias.py``, copied with the port's imports).

Reference role (featurestore/feature-bias/feature-bias-whatif.ipynb):
train a classifier on census data, then inspect it with the What-If
Tool — per-slice performance, acceptance rates across protected groups,
and decision-threshold exploration. The widget itself is a notebook UI;
the capability underneath is slice metrics + disparity measures +
threshold sweeps, which is what this module provides as a plain API
over pandas frames (so it composes with feature groups, training
datasets, and ``modelrepo.batch`` predictions).

All metrics are computed jointly in one pass per slice; predictions may
be hard labels or scores (scores + ``threshold`` give the What-If
threshold-exploration behavior).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import pandas as pd

_METRIC_COLUMNS = (
    "count", "base_rate", "acceptance_rate", "accuracy", "tpr", "fpr", "precision",
)


def _require_binary(vals: np.ndarray, column: str, role: str) -> None:
    """Fail fast on non-0/1 data — e.g. the census labels '<=50K'/'>50K'
    of the reference notebook, which must be binarized first; silent
    all-False comparisons would report zero disparity on disparate data."""
    uniq = pd.unique(vals)
    if not set(np.asarray(uniq, dtype=object)) <= {0, 1, True, False}:
        raise ValueError(
            f"{role} column {column!r} must contain only 0/1, got "
            f"{list(uniq[:5])!r}; binarize it first, e.g. "
            f"df[{column!r}] = (df[{column!r}] == positive_value).astype(int)")


def slice_metrics(
    df: pd.DataFrame,
    label: str,
    prediction: str,
    slice_by: str | list[str],
    threshold: float | None = None,
) -> pd.DataFrame:
    """Per-group confusion metrics.

    Returns one row per slice value with count, base_rate (P(y=1)),
    acceptance_rate (P(yhat=1)), accuracy, tpr (equal-opportunity
    axis), fpr, precision. ``threshold`` binarizes a score column.
    """
    if isinstance(slice_by, str):
        slice_by = [slice_by]
    clash = set(slice_by) & (set(_METRIC_COLUMNS) | {"_y", "_yhat"})
    if clash:
        raise ValueError(
            f"slice column(s) {sorted(clash)} collide with metric/scratch "
            f"column names {_METRIC_COLUMNS + ('_y', '_yhat')}; rename them "
            "before slicing")
    y = df[label].to_numpy()
    _require_binary(y, label, "label")
    yhat = df[prediction].to_numpy()
    if threshold is not None:
        yhat = (yhat >= threshold).astype(int)
    else:
        _require_binary(yhat, prediction, "prediction (pass threshold= for scores)")
    work = df[slice_by].copy()
    work["_y"], work["_yhat"] = y, yhat

    rows = []
    for key, grp in work.groupby(slice_by, dropna=False, observed=True):
        gy, gp = grp["_y"].to_numpy(), grp["_yhat"].to_numpy()
        pos, neg = gy == 1, gy == 0
        tp, fp = int((gp[pos] == 1).sum()), int((gp[neg] == 1).sum())
        rows.append({
            **dict(zip(slice_by, key if isinstance(key, tuple) else (key,))),
            "count": len(gy),
            "base_rate": float(pos.mean()),
            "acceptance_rate": float((gp == 1).mean()),
            "accuracy": float((gp == gy).mean()),
            "tpr": float(tp / pos.sum()) if pos.any() else np.nan,
            "fpr": float(fp / neg.sum()) if neg.any() else np.nan,
            "precision": float(tp / (tp + fp)) if (tp + fp) else np.nan,
        })
    out = pd.DataFrame(rows)
    out.attrs["slice_by"] = list(slice_by)
    return out


def disparity(metrics: pd.DataFrame, metric: str = "acceptance_rate") -> dict[str, Any]:
    """Max-minus-min gap and max/min ratio of ``metric`` across slices.

    ``metric="acceptance_rate"`` is demographic-parity difference;
    ``metric="tpr"`` is the equal-opportunity difference.
    """
    vals = metrics[metric].dropna()
    if vals.empty:
        return {"metric": metric, "gap": np.nan, "ratio": np.nan,
                "max_group": None, "min_group": None}
    # slice_metrics records its slice columns; fall back to exclusion
    # for hand-built frames (collisions are rejected at slice time).
    slice_cols = metrics.attrs.get(
        "slice_by",
        [c for c in metrics.columns if c not in _METRIC_COLUMNS])
    if not slice_cols:
        raise ValueError(
            "metrics frame has no slice columns (every column matches a "
            "metric name); build it with slice_metrics or include the "
            "group column")
    hi, lo = vals.idxmax(), vals.idxmin()
    name = lambda i: tuple(metrics.loc[i, c] for c in slice_cols)  # noqa: E731
    return {
        "metric": metric,
        "gap": float(vals.max() - vals.min()),
        "ratio": float(vals.max() / vals.min()) if vals.min() > 0 else np.inf,
        "max_group": name(hi) if len(slice_cols) > 1 else name(hi)[0],
        "min_group": name(lo) if len(slice_cols) > 1 else name(lo)[0],
    }


def threshold_sweep(
    df: pd.DataFrame,
    label: str,
    score: str,
    slice_by: str | list[str],
    thresholds: np.ndarray | list[float] | None = None,
    parity_metric: str = "acceptance_rate",
) -> pd.DataFrame:
    """The What-If threshold exploration: disparity of ``parity_metric``
    and overall accuracy at each decision threshold."""
    if thresholds is None:
        thresholds = np.linspace(0.1, 0.9, 17)
    y = df[label].to_numpy()
    rows = []
    for t in thresholds:
        m = slice_metrics(df, label, score, slice_by, threshold=float(t))
        d = disparity(m, parity_metric)
        overall = float(((df[score].to_numpy() >= t).astype(int) == y).mean())
        rows.append({"threshold": float(t), "gap": d["gap"],
                     "ratio": d["ratio"], "overall_accuracy": overall})
    return pd.DataFrame(rows)


def bias_report(
    df: pd.DataFrame,
    label: str,
    prediction: str,
    slice_by: str | list[str],
    threshold: float | None = None,
) -> dict[str, Any]:
    """One-call summary: per-slice metrics plus the three standard
    disparities (demographic parity, equal opportunity, accuracy gap)."""
    m = slice_metrics(df, label, prediction, slice_by, threshold=threshold)
    return {
        "slices": m,
        "demographic_parity": disparity(m, "acceptance_rate"),
        "equal_opportunity": disparity(m, "tpr"),
        "accuracy_gap": disparity(m, "accuracy"),
    }
