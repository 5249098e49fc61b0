"""Trial optimizers: ask/tell strategies behind the async driver (a copy of
``hops_tpu/search/optimizers.py``: the module imports no JAX, and the port imports nothing
of the JAX package).

Covers the reference's optimizer set (SURVEY.md §2.3-2.4):
``randomsearch`` and ``asha`` (maggy's lagom optimizers), exhaustive
grid (``experiment.grid_search``), and differential evolution
(``experiment.differential_evolution``). All are ask/tell and
non-blocking: ``ask()`` returns the next trial config or ``None`` when
nothing can be issued *right now* (the driver retries as results come
in), and ``finished()`` says the whole search is exhausted — that is
what makes the lagom loop asynchronous (no generation barrier except
where the algorithm itself demands one).
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Iterator

from hops_tpu_torch.search.searchspace import Searchspace


@dataclass
class TrialResult:
    trial_id: str
    params: dict[str, Any]
    metric: float | None
    stopped_early: bool = False
    meta: dict[str, Any] = field(default_factory=dict)


class Optimizer:
    direction: str = "max"

    def better(self, a: float, b: float) -> bool:
        return a > b if self.direction == "max" else a < b

    def ask(self) -> dict[str, Any] | None:
        raise NotImplementedError

    def tell(self, result: TrialResult) -> None:
        raise NotImplementedError

    def finished(self) -> bool:
        raise NotImplementedError


class RandomSearch(Optimizer):
    """maggy ``optimizer='randomsearch'``."""

    def __init__(self, space: Searchspace, num_trials: int, direction: str = "max", seed: int = 0):
        self.space = space
        self.num_trials = num_trials
        self.direction = direction.lower()
        self._rng = random.Random(seed)
        self._asked = 0
        self._told = 0

    def ask(self) -> dict[str, Any] | None:
        if self._asked >= self.num_trials:
            return None
        self._asked += 1
        return self.space.sample(self._rng)

    def tell(self, result: TrialResult) -> None:
        self._told += 1

    def finished(self) -> bool:
        return self._told >= self.num_trials


class GridSearch(Optimizer):
    """``experiment.grid_search``: cartesian product of an args dict
    (grid_search_fashion_mnist.ipynb cell 6 — keys are wrapper kwargs,
    values are lists)."""

    def __init__(self, args_dict: dict[str, list[Any]], direction: str = "max"):
        self.direction = direction.lower()
        keys = list(args_dict)
        self._combos: Iterator[dict[str, Any]] = (
            dict(zip(keys, combo)) for combo in itertools.product(*args_dict.values())
        )
        self.total = 1
        for v in args_dict.values():
            self.total *= len(v)
        self._told = 0

    @classmethod
    def from_trials(cls, trials: list[dict[str, Any]], direction: str = "max") -> "GridSearch":
        """Sequentially issue a precomputed trial list (used by the LOCO
        ablator)."""
        opt = cls.__new__(cls)
        opt.direction = direction.lower()
        opt._combos = iter(trials)
        opt.total = len(trials)
        opt._told = 0
        return opt

    def ask(self) -> dict[str, Any] | None:
        return next(self._combos, None)

    def tell(self, result: TrialResult) -> None:
        self._told += 1

    def finished(self) -> bool:
        return self._told >= self.total


class DifferentialEvolution(Optimizer):
    """``experiment.differential_evolution`` (evolutionary_search_
    mnist.ipynb:267): DE/rand/1/bin over bounded INTEGER/DOUBLE axes;
    categorical axes crossover only. Generations are inherent barriers:
    ``ask()`` returns None while a generation is in flight."""

    def __init__(
        self,
        space: Searchspace,
        generations: int = 4,
        population: int = 5,
        direction: str = "max",
        mutation: float = 0.8,
        crossover: float = 0.7,
        seed: int = 0,
    ):
        if population < 4:
            raise ValueError(f"DE/rand/1 needs population >= 4, got {population}")
        self.space = space
        self.generations = generations
        self.population = population
        self.direction = direction.lower()
        self.mutation = mutation
        self.crossover = crossover
        self._rng = random.Random(seed)
        self._gen = 0
        self._pop: list[dict[str, Any]] = [space.sample(self._rng) for _ in range(population)]
        self._fitness: list[float | None] = [None] * population
        self._pending: list[tuple[int, dict[str, Any]]] = list(enumerate(self._pop))
        self._in_flight: dict[int, dict[str, Any]] = {}
        self._candidates: dict[int, dict[str, Any]] = {}

    def ask(self) -> dict[str, Any] | None:
        if not self._pending:
            return None
        idx, params = self._pending.pop(0)
        self._in_flight[idx] = params
        return {**params, "_de_idx": idx}

    def tell(self, result: TrialResult) -> None:
        idx = result.meta.get("_de_idx", result.params.get("_de_idx"))
        params = self._in_flight.pop(idx)
        metric = result.metric
        prev = self._fitness[idx]
        if metric is not None and (prev is None or self.better(metric, prev)):
            self._fitness[idx] = metric
            self._pop[idx] = params
        if not self._pending and not self._in_flight:
            self._next_generation()

    def _next_generation(self) -> None:
        self._gen += 1
        if self.finished():
            return
        names = self.space.names()
        for i in range(self.population):
            a, b, c = self._rng.sample([j for j in range(self.population) if j != i], 3)
            trial: dict[str, Any] = {}
            for name in names:
                kind, _ = dict(self.space.items())[name]
                target = self._pop[i][name]
                if self._rng.random() < self.crossover:
                    if kind in ("INTEGER", "DOUBLE"):
                        trial[name] = self._pop[a][name] + self.mutation * (
                            self._pop[b][name] - self._pop[c][name]
                        )
                    else:
                        trial[name] = self._rng.choice(
                            [self._pop[a][name], self._pop[b][name], self._pop[c][name]]
                        )
                else:
                    trial[name] = target
            self._pending.append((i, self.space.clip(trial)))

    def finished(self) -> bool:
        return self._gen >= self.generations and not self._pending and not self._in_flight


class ASHA(Optimizer):
    """Asynchronous Successive Halving (the BASELINE.json "Maggy ASHA"
    config): rungs of budgets ``min_budget * eta^r``; a trial finishing
    rung r is promoted to rung r+1 iff it is in the top 1/eta of that
    rung's results so far — fully async, no synchronized halving rounds.
    Trial configs carry a ``budget`` kwarg for the train fn."""

    def __init__(
        self,
        space: Searchspace,
        num_trials: int = 20,
        min_budget: int = 1,
        eta: int = 3,
        max_rungs: int = 4,
        direction: str = "max",
        seed: int = 0,
    ):
        self.space = space
        self.num_trials = num_trials
        self.min_budget = min_budget
        self.eta = eta
        self.max_rungs = max_rungs
        self.direction = direction.lower()
        self._rng = random.Random(seed)
        self._asked_base = 0
        self._done = 0
        # rung -> list of (metric, params)
        self._rungs: dict[int, list[tuple[float, dict[str, Any]]]] = {}
        self._promotable: list[tuple[int, dict[str, Any]]] = []
        self._promoted: dict[int, int] = {}  # rung -> count promoted out

    def budget(self, rung: int) -> int:
        return self.min_budget * self.eta**rung

    def ask(self) -> dict[str, Any] | None:
        if self._promotable:
            rung, params = self._promotable.pop(0)
            return {**params, "budget": self.budget(rung), "_rung": rung}
        if self._asked_base < self.num_trials:
            self._asked_base += 1
            return {
                **self.space.sample(self._rng),
                "budget": self.budget(0),
                "_rung": 0,
            }
        return None

    def tell(self, result: TrialResult) -> None:
        self._done += 1
        rung = result.meta.get("_rung", result.params.get("_rung", 0))
        if result.metric is None:
            return
        params = {
            k: v for k, v in result.params.items() if k not in ("budget", "_rung")
        }
        entries = self._rungs.setdefault(rung, [])
        entries.append((result.metric, params))
        if rung + 1 >= self.max_rungs:
            return
        # Promote while the rung's top-1/eta has grown past what we already
        # promoted (the async rule: never wait for the rung to fill).
        entries.sort(key=lambda t: t[0], reverse=self.direction == "max")
        want = len(entries) // self.eta
        have = self._promoted.get(rung, 0)
        for i in range(have, want):
            self._promotable.append((rung + 1, entries[i][1]))
        self._promoted[rung] = max(have, want)

    def finished(self) -> bool:
        return (
            self._asked_base >= self.num_trials
            and not self._promotable
            and self._done >= self.num_trials + sum(self._promoted.values())
        )


def make_optimizer(
    name_or_opt: Any, space: Searchspace | None, num_trials: int, direction: str
) -> Optimizer:
    if isinstance(name_or_opt, Optimizer):
        return name_or_opt
    name = str(name_or_opt).lower()
    if name == "randomsearch":
        return RandomSearch(space, num_trials, direction)
    if name == "asha":
        return ASHA(space, num_trials, direction=direction)
    raise ValueError(f"unknown optimizer {name_or_opt!r} (expected 'randomsearch', 'asha', or an Optimizer)")
