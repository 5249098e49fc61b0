"""Typed configuration layer.

The reference had four uncoordinated config idioms — templated JSON job
configs, argparse CLIs, Scallop args, properties files (SURVEY.md §5
"Config / flag system"). This module unifies them: dataclass-backed typed
configs that load from (in priority order) explicit kwargs > CLI-style
``key=value`` overrides > environment (``HOPS_TPU_<KEY>``) > JSON file >
defaults, with dotted-path access for nested sections.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, TypeVar, get_type_hints

T = TypeVar("T")

_ENV_PREFIX = "HOPS_TPU_"


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a string/JSON value to the annotated dataclass field type."""
    if typ is Any or value is None:
        return value
    # Unwrap Optional / unions: coerce to the first non-None member.
    import types as _types
    import typing as _typing

    if isinstance(typ, _types.UnionType) or getattr(typ, "__origin__", None) is _typing.Union:
        members = [a for a in typ.__args__ if a is not type(None)]
        for i, m in enumerate(members):
            try:
                return _coerce(value, m)
            except (ValueError, TypeError):
                if i == len(members) - 1:
                    raise
        return value
    origin = getattr(typ, "__origin__", None)
    if dataclasses.is_dataclass(typ):
        if isinstance(value, str):
            value = json.loads(value)
        if isinstance(value, dict):
            return from_dict(typ, value)
    if origin in (list, tuple) and isinstance(value, str):
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            value = value.split(",")  # CLI form: "mesh=4,2" / "axes=data,model"
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            value = [value]  # single-element override: "mesh=4"
        args = getattr(typ, "__args__", ())
        elem = args[0] if args and args[0] is not Ellipsis else Any
        coerce_elem = elem if elem in (int, float, str, bool) else Any
        value = [
            _coerce(v.strip() if isinstance(v, str) else v, coerce_elem) for v in value
        ]
        return tuple(value) if origin is tuple else value
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str) and not isinstance(value, typ):
        return typ(value)
    return value


def from_dict(cls: type[T], data: dict[str, Any]) -> T:
    """Build dataclass ``cls`` from a (possibly nested) dict, coercing types."""
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(data[f.name], hints.get(f.name, Any))
    return cls(**kwargs)


def to_dict(cfg: Any) -> dict[str, Any]:
    return dataclasses.asdict(cfg)


def _apply_env(cls: type, data: dict[str, Any]) -> None:
    for f in dataclasses.fields(cls):
        env_key = _ENV_PREFIX + f.name.upper()
        if env_key in os.environ:
            data[f.name] = os.environ[env_key]


def _set_dotted(data: dict[str, Any], key: str, value: Any) -> None:
    parts = key.split(".")
    node = data
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load(
    cls: type[T],
    path: str | Path | None = None,
    overrides: list[str] | dict[str, Any] | None = None,
    **kwargs: Any,
) -> T:
    """Load a config dataclass from file + env + overrides + kwargs.

    ``overrides`` accepts ``["train.lr=0.1", "mesh=4,2"]``-style strings
    (the CLI form) or a plain dict with dotted keys.
    """
    data: dict[str, Any] = {}
    if path is not None:
        data.update(json.loads(Path(path).read_text()))
    _apply_env(cls, data)
    if overrides:
        items = (
            overrides.items()
            if isinstance(overrides, dict)
            else (kv.split("=", 1) for kv in overrides)
        )
        for k, v in items:
            _set_dotted(data, k, v)
    data.update(kwargs)
    return from_dict(cls, data)


def save(cfg: Any, path: str | Path) -> None:
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2, default=str))


@dataclasses.dataclass
class RuntimeConfig:
    """Global runtime knobs; the root config most subsystems hang off."""

    project: str = "default"
    workspace: str = ""  # resolved lazily by fs.workspace_root()
    seed: int = 0
    # Default dtype for compute on the MXU.
    compute_dtype: str = "bfloat16"
    # Mesh axis names used by the distribution layer, outermost first.
    mesh_axes: tuple[str, ...] = ("data", "model")
    log_level: str = "INFO"


# Initialized through load() so the documented precedence applies from
# the start: env (HOPS_TPU_PROJECT / HOPS_TPU_WORKSPACE, as exported to
# job children and serving hosts) > field defaults; an explicit
# configure(...) later still overrides either. A malformed env var must
# not make the package unimportable — warn and fall back to defaults.
try:
    _current = load(RuntimeConfig)
except Exception as _env_err:  # noqa: BLE001
    import warnings

    warnings.warn(f"ignoring invalid HOPS_TPU_* environment: {_env_err}")
    _current = RuntimeConfig()


def runtime() -> RuntimeConfig:
    return _current


def configure(**kwargs: Any) -> RuntimeConfig:
    """Update the process-global runtime config in place."""
    global _current
    _current = dataclasses.replace(_current, **kwargs)
    if "log_level" in kwargs:
        import logging as _stdlog

        _stdlog.getLogger("hops_tpu_torch").setLevel(_current.log_level)
    return _current
