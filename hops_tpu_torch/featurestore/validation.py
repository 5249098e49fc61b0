"""Data-validation rules + expectations ("unit tests for data") (counterpart of
``hops_tpu/featurestore/validation.py``, copied with the port's imports).

Reference (SURVEY.md §2.6, feature_validation_python.ipynb):
``connection.get_rules()``, ``fs.create_expectation(name, rules=[
Rule(name="HAS_MIN", level="WARNING", min=0), ...]).save()``,
``fg.attach_expectation``, ``fg.validate(df)``, ``fg.get_validations()``,
and ``validation_type`` NONE/WARNING/STRICT/ALL gating inserts.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import pandas as pd

from hops_tpu_torch.featurestore import storage


class DataValidationError(RuntimeError):
    """Raised when a STRICT-mode insert fails validation."""


# Rule catalog: predicate(series, rule) -> (ok, observed). Mirrors the
# Deequ-derived names the reference exposes via connection.get_rules().
RULE_DEFINITIONS: dict[str, dict] = {
    "HAS_MIN": {"predicate": "bounds", "accepts": ["min", "max"],
                "description": "column minimum within [min, max]"},
    "HAS_MAX": {"predicate": "bounds", "accepts": ["min", "max"],
                "description": "column maximum within [min, max]"},
    "HAS_MEAN": {"predicate": "bounds", "accepts": ["min", "max"],
                 "description": "column mean within [min, max]"},
    "HAS_SUM": {"predicate": "bounds", "accepts": ["min", "max"],
                "description": "column sum within [min, max]"},
    "HAS_STANDARD_DEVIATION": {"predicate": "bounds", "accepts": ["min", "max"],
                               "description": "column stddev within [min, max]"},
    "HAS_SIZE": {"predicate": "bounds", "accepts": ["min", "max"],
                 "description": "row count within [min, max]"},
    "HAS_COMPLETENESS": {"predicate": "bounds", "accepts": ["min", "max"],
                         "description": "fraction of non-null values within [min, max]"},
    "HAS_UNIQUENESS": {"predicate": "bounds", "accepts": ["min", "max"],
                       "description": "fraction of values appearing exactly once"},
    "HAS_DISTINCTNESS": {"predicate": "bounds", "accepts": ["min", "max"],
                         "description": "fraction of distinct values"},
    "HAS_ENTROPY": {"predicate": "bounds", "accepts": ["min", "max"],
                    "description": "Shannon entropy within [min, max]"},
    "IS_CONTAINED_IN": {"predicate": "membership", "accepts": ["legal_values"],
                        "description": "all values in legal_values"},
    "HAS_DATATYPE": {"predicate": "datatype", "accepts": ["accepted_type"],
                     "description": "column dtype matches accepted_type"},
    "HAS_NUMBER_OF_DISTINCT_VALUES": {"predicate": "bounds", "accepts": ["min", "max"],
                                      "description": "distinct count within [min, max]"},
}


@dataclasses.dataclass
class Rule:
    """One constraint (reference: ``Rule(name="HAS_MIN", level="WARNING",
    min=0)``, feature_validation_python.ipynb:304-311)."""

    name: str
    level: str = "WARNING"  # WARNING | ERROR
    min: float | None = None
    max: float | None = None
    legal_values: list | None = None
    accepted_type: str | None = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        return cls(**d)


def _observe(series_or_df, rule: Rule) -> float | str | None:
    name = rule.name.upper()
    if name == "HAS_SIZE":
        return float(len(series_or_df))
    s: pd.Series = series_or_df
    if name == "HAS_MIN":
        return float(s.min())
    if name == "HAS_MAX":
        return float(s.max())
    if name == "HAS_MEAN":
        return float(s.mean())
    if name == "HAS_SUM":
        return float(s.sum())
    if name == "HAS_STANDARD_DEVIATION":
        return float(s.std()) if len(s) > 1 else 0.0
    if name == "HAS_COMPLETENESS":
        return float(s.notna().mean()) if len(s) else 1.0
    if name == "HAS_UNIQUENESS":
        counts = s.value_counts()
        return float((counts == 1).sum() / len(s)) if len(s) else 1.0
    if name == "HAS_DISTINCTNESS":
        return float(s.nunique() / len(s)) if len(s) else 1.0
    if name == "HAS_NUMBER_OF_DISTINCT_VALUES":
        return float(s.nunique())
    if name == "HAS_ENTROPY":
        p = s.value_counts(normalize=True).to_numpy()
        return float(-(p * np.log2(p)).sum()) if len(p) else 0.0
    if name == "IS_CONTAINED_IN":
        return float(s.isin(rule.legal_values or []).mean()) if len(s) else 1.0
    if name == "HAS_DATATYPE":
        return str(s.dtype)
    return None


def _check(observed, rule: Rule) -> bool:
    name = rule.name.upper()
    if name == "IS_CONTAINED_IN":
        return observed == 1.0
    if name == "HAS_DATATYPE":
        want = (rule.accepted_type or "").lower()
        got = str(observed).lower()
        aliases = {
            "integral": ("int",), "int": ("int",),
            "fractional": ("float", "double"), "float": ("float",),
            "string": ("object", "str", "string"), "boolean": ("bool",),
        }
        return any(got.startswith(p) for p in aliases.get(want, (want,)))
    ok = True
    if rule.min is not None:
        ok = ok and observed >= rule.min
    if rule.max is not None:
        ok = ok and observed <= rule.max
    return ok


@dataclasses.dataclass
class Expectation:
    """A named set of rules over a set of features (reference:
    ``fs.create_expectation(...).save()``)."""

    _fs: Any
    name: str
    description: str = ""
    features: list[str] = dataclasses.field(default_factory=list)
    rules: list[Rule] = dataclasses.field(default_factory=list)

    def save(self) -> "Expectation":
        d = storage.feature_store_root() / "expectations"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{self.name}.json").write_text(json.dumps({
            "name": self.name,
            "description": self.description,
            "features": self.features,
            "rules": [r.to_dict() for r in self.rules],
        }, indent=2))
        return self

    @classmethod
    def load(cls, fs, name: str) -> "Expectation":
        p = storage.feature_store_root() / "expectations" / f"{name}.json"
        d = json.loads(p.read_text())
        return cls(fs, d["name"], d.get("description", ""), d.get("features", []),
                   [Rule.from_dict(r) for r in d.get("rules", [])])


def validate_dataframe(fs, fg, df: pd.DataFrame, persist: bool = False) -> dict:
    """Evaluate every attached expectation; returns the validation report
    dict (status: SUCCESS | WARNING | FAILURE)."""
    results = []
    worst = "SUCCESS"
    for exp_name in fg.expectation_names:
        exp = Expectation.load(fs, exp_name)
        for feature in (exp.features or [f.name for f in fg.features]):
            for rule in exp.rules:
                size_rule = rule.name.upper() == "HAS_SIZE"
                if not size_rule and feature not in df.columns:
                    status, observed = "FAILURE", "missing column"
                else:
                    observed = _observe(df if size_rule else df[feature], rule)
                    ok = _check(observed, rule)
                    status = "SUCCESS" if ok else ("FAILURE" if rule.level.upper() == "ERROR" else "WARNING")
                results.append({
                    "expectation": exp.name, "feature": feature,
                    "rule": rule.name, "level": rule.level,
                    "observed": observed, "status": status,
                })
                worst = _worse(worst, status)
    report = {
        "validation_time": int(time.time() * 1000),
        "status": worst,
        "expectation_results": results,
    }
    if persist and fg.expectation_names:
        vdir: Path = fg.dir / "validations"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / f"{report['validation_time']}.json").write_text(
            json.dumps(report, indent=2, default=str))
    return report


def load_validations(fg_dir: Path) -> list[dict]:
    vdir = fg_dir / "validations"
    if not vdir.exists():
        return []
    return [json.loads(p.read_text()) for p in sorted(vdir.glob("*.json"))]


def _worse(a: str, b: str) -> str:
    order = {"SUCCESS": 0, "WARNING": 1, "FAILURE": 2}
    return a if order[a] >= order[b] else b
