"""Early-stopping policies for the async trial driver (a copy of
``hops_tpu/search/earlystop.py``: the module imports no JAX, and the port imports nothing
of the JAX package).

Reference knobs: ``es_interval`` (check period), ``es_min`` (minimum
finished trials before stopping kicks in) — maggy-fashion-mnist-
example.ipynb:307-318, SURVEY.md §2.4. Policy: median rule — a running
trial whose latest metric is worse than the median of completed trials'
final metrics gets stopped.
"""

from __future__ import annotations

import statistics


class MedianEarlyStopper:
    def __init__(self, direction: str = "max", es_min: int = 5):
        self.direction = direction.lower()
        self.es_min = es_min

    def should_stop(
        self, running_latest: float | None, finished_finals: list[float]
    ) -> bool:
        if running_latest is None or len(finished_finals) < self.es_min:
            return False
        med = statistics.median(finished_finals)
        if self.direction == "max":
            return running_latest < med
        return running_latest > med


class NoEarlyStop:
    def should_stop(self, running_latest, finished_finals) -> bool:  # noqa: ARG002
        return False
