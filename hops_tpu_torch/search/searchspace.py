"""Searchspace: typed hyperparameter domains (a copy of
``hops_tpu/search/searchspace.py``: the module imports no JAX, and the port imports nothing
of the JAX package).

Reference surface: ``Searchspace(kernel=('INTEGER', [2, 8]))`` /
``.add('dropout', ('DOUBLE', [0.01, 0.99]))`` with case-insensitive type
names (maggy-fashion-mnist-example.ipynb:124-130, SURVEY.md §2.4).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Iterator

_TYPES = ("INTEGER", "DOUBLE", "DISCRETE", "CATEGORICAL")


class Searchspace:
    def __init__(self, **params: tuple[str, list[Any]]):
        self._params: dict[str, tuple[str, list[Any]]] = {}
        for name, spec in params.items():
            self.add(name, spec)

    def add(self, name: str, spec: tuple[str, list[Any]]) -> "Searchspace":
        kind, domain = spec
        kind = kind.upper()
        if kind not in _TYPES:
            raise ValueError(f"unknown searchspace type {kind!r}; expected one of {_TYPES}")
        if kind in ("INTEGER", "DOUBLE"):
            if len(domain) != 2 or domain[0] > domain[1]:
                raise ValueError(f"{name}: {kind} needs [min, max], got {domain}")
        elif not domain:
            raise ValueError(f"{name}: empty domain")
        self._params[name] = (kind, list(domain))
        return self

    def names(self) -> list[str]:
        return list(self._params)

    def items(self):
        return self._params.items()

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v[0]}{v[1]}" for k, v in self._params.items())
        return f"Searchspace({inner})"

    def sample(self, rng: random.Random) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name, (kind, domain) in self._params.items():
            if kind == "INTEGER":
                out[name] = rng.randint(int(domain[0]), int(domain[1]))
            elif kind == "DOUBLE":
                out[name] = rng.uniform(float(domain[0]), float(domain[1]))
            else:  # DISCRETE / CATEGORICAL
                out[name] = rng.choice(domain)
        return out

    def grid(self, doubles_per_axis: int = 5) -> Iterator[dict[str, Any]]:
        """Cartesian grid; continuous axes discretized."""
        axes: list[list[Any]] = []
        for kind, domain in self._params.values():
            if kind == "INTEGER":
                axes.append(list(range(int(domain[0]), int(domain[1]) + 1)))
            elif kind == "DOUBLE":
                lo, hi = float(domain[0]), float(domain[1])
                n = doubles_per_axis
                axes.append([lo + (hi - lo) * i / (n - 1) for i in range(n)])
            else:
                axes.append(list(domain))
        for combo in itertools.product(*axes):
            yield dict(zip(self._params, combo))

    def clip(self, params: dict[str, Any]) -> dict[str, Any]:
        """Project arbitrary values back into the domain (used by
        differential evolution's mutation step)."""
        out = dict(params)
        for name, (kind, domain) in self._params.items():
            v = out.get(name)
            if kind == "INTEGER":
                out[name] = int(min(max(round(v), domain[0]), domain[1]))
            elif kind == "DOUBLE":
                out[name] = float(min(max(v, domain[0]), domain[1]))
            elif v not in domain:
                out[name] = min(domain, key=lambda d: abs(hash(d) - hash(v)))
        return out
