"""Versioned model registry (counterpart of ``hops_tpu/modelrepo/registry.py``).

``export(path, name, metrics)`` registers an artifact file or directory
as the next version under ``Models/<name>/<version>`` of the current
project (:mod:`hops_tpu_torch.runtime.fs`), with a ``model.json`` of
metadata; ``get_best_model(name, metric, Metric.MAX)`` returns the
metadata ``{'name', 'version', 'metrics', ...}`` of the best version.

The port stores a model in its own artifact format, not as a pickled
flax module (the JAX package's ``save_flax`` / ``load_flax``): a language
model as ``lm_config.json`` and ``params.npz`` (:func:`save_lm`), a
classifier as ``classifier.json`` and ``params.npz``
(:func:`save_classifier`, which also converts a JAX bundle's weights).
Both are written by :mod:`hops_tpu_torch.modelrepo.serving`.
"""

from __future__ import annotations

import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Mapping

from hops_tpu_torch.runtime import fs


class Metric:
    MAX = "max"
    MIN = "min"


def _models_root() -> Path:
    p = Path(fs.project_path("Models"))
    p.mkdir(parents=True, exist_ok=True)
    return p


def _next_version(name: str) -> int:
    d = _models_root() / name
    if not d.exists():
        return 1
    versions = [int(v.name) for v in d.iterdir() if v.name.isdigit()]
    return max(versions, default=0) + 1


def export(
    path: str | Path,
    name: str,
    metrics: dict[str, Any] | None = None,
    description: str = "",
) -> dict[str, Any]:
    """Register a local artifact file or directory as a new version of
    ``name``; returns its metadata."""
    src = Path(path)
    if not src.exists():
        raise FileNotFoundError(f"model artifact {src} does not exist")
    version = _next_version(name)
    dst = _models_root() / name / str(version)
    dst.mkdir(parents=True, exist_ok=True)
    if src.is_dir():
        shutil.copytree(src, dst, dirs_exist_ok=True)
    else:
        shutil.copy2(src, dst / src.name)
    meta = {
        "name": name,
        "version": version,
        "metrics": {k: _num(v) for k, v in (metrics or {}).items()},
        "description": description,
        "created": time.time(),
        "path": str(dst),
    }
    (dst / "model.json").write_text(json.dumps(meta, indent=2, default=str))
    return meta


def save_lm(
    lm_config: Mapping[str, Any],
    params: Mapping[str, Any],
    name: str,
    metrics: dict[str, Any] | None = None,
    description: str = "",
) -> dict[str, Any]:
    """Export a TransformerLM (its fields and its flax-named parameters,
    a tree or a flat ``'/'``-joined dict) as a servable artifact."""
    from hops_tpu_torch.modelrepo.serving import save_lm_artifact

    with tempfile.TemporaryDirectory() as tmp:
        save_lm_artifact(tmp, lm_config, params)
        return export(tmp, name, metrics=metrics, description=description)


def save_classifier(
    module: str,
    fields: Mapping[str, Any],
    variables: Mapping[str, Any],
    name: str,
    metrics: dict[str, Any] | None = None,
    description: str = "",
) -> dict[str, Any]:
    """Export a classifier (``CNN``, ``FFN`` or ``ResNet``) as a servable
    bundle — the counterpart of the JAX package's ``save_flax``.

    ``module`` is the class name, ``fields`` its constructor fields (a
    JAX module's dataclass fields, dtypes included), ``variables`` its
    weights: ``{"params": ..., "batch_stats": ...}`` as numpy trees.
    Given a JAX ``save_flax`` bundle's ``params`` and
    ``extra_variables`` (converted to numpy by the caller: this module
    never unpickles one, since that needs flax), this converts it;
    given :func:`~hops_tpu_torch.models.convert.params_to_flax` of a port
    module, it saves that module
    (:func:`~hops_tpu_torch.modelrepo.serving.save_classifier_artifact`)."""
    from hops_tpu_torch.modelrepo.serving import save_classifier_artifact

    with tempfile.TemporaryDirectory() as tmp:
        save_classifier_artifact(tmp, module, fields, variables)
        return export(tmp, name, metrics=metrics, description=description)


def load_classifier(name: str, version: int | None = None, device: Any = None):
    """A registered classifier on ``device`` (``None``: the card), in eval
    mode — the counterpart of ``load_flax`` for :func:`save_classifier`
    bundles."""
    from hops_tpu_torch.modelrepo.serving import load_classifier_artifact

    path = Path(get_model(name, version)["path"])
    if not (path / "classifier.json").is_file():
        raise ValueError(f"model {name!r} is not a classifier bundle "
                         f"(no classifier.json in {path})")
    return load_classifier_artifact(path, device)


def lm_artifact(name: str, version: int | None = None) -> Path:
    """The artifact directory of a registered language model."""
    path = Path(get_model(name, version)["path"])
    if not (path / "lm_config.json").is_file():
        raise ValueError(f"model {name!r} is not a language-model artifact "
                         f"(no lm_config.json in {path})")
    return path


def list_models(name: str | None = None) -> list[dict[str, Any]]:
    out = []
    root = _models_root()
    for model_dir in sorted(root.iterdir() if name is None else [root / name]):
        if not model_dir.is_dir():
            continue
        for vdir in sorted(model_dir.iterdir(),
                           key=lambda v: int(v.name) if v.name.isdigit() else 0):
            meta_file = vdir / "model.json"
            if meta_file.exists():
                out.append(json.loads(meta_file.read_text()))
    return out


def get_model(name: str, version: int | None = None) -> dict[str, Any]:
    versions = list_models(name)
    if not versions:
        raise KeyError(f"model {name!r} not found")
    if version is None:
        return versions[-1]
    for m in versions:
        if m["version"] == version:
            return m
    raise KeyError(f"model {name!r} version {version} not found")


def get_best_model(name: str, metric: str, direction: str = Metric.MAX) -> dict[str, Any]:
    """The best version of ``name`` by a numeric ``metric``."""
    candidates = [
        m for m in list_models(name)
        if isinstance(m.get("metrics", {}).get(metric), (int, float))
    ]
    if not candidates:
        raise KeyError(f"no versions of {name!r} carry numeric metric {metric!r}")
    key = lambda m: m["metrics"][metric]  # noqa: E731
    return max(candidates, key=key) if direction == Metric.MAX else min(candidates, key=key)


def _num(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
