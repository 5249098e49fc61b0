"""Async hyperparameter search — the maggy twin.

Counterpart of ``examples/lagom_search.py`` (notebooks/ml/
Parallel_Experiments/Maggy/maggy-fashion-mnist-example.ipynb, SURVEY.md
§2.4): a Searchspace over kernel/pool/dropout, a trial function that
heartbeats per-step metrics through the reporter (enabling median early
stopping), and the async ``lagom`` driver with ASHA available as
``optimizer="asha"``. The model here is a cheap analytic proxy so the
search dynamics — async trials, heartbeats, early stops — are the point,
not the FLOPs. Trials run one at a time on ``device`` (default: every
visible card, one trial each).

Usage: ``python examples_torch/lagom_search.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import math

from hops_tpu_torch import experiment
from hops_tpu_torch.search import Searchspace


def trial_fn(kernel, pool, dropout, reporter):
    # Smooth proxy loss with a known optimum (kernel=4, pool=2, dropout≈0.1).
    best = 0.0
    for step in range(20):
        acc = (
            0.9
            - 0.02 * (kernel - 4) ** 2
            - 0.03 * (pool - 2) ** 2
            - 2.0 * (dropout - 0.1) ** 2
        ) * (1 - math.exp(-(step + 1) / 5))
        best = max(best, acc)
        reporter.broadcast(metric=acc)
    return best


def main(*, device=None) -> dict:
    from hops_tpu_torch.runtime.devices import resolve_device

    sp = Searchspace(kernel=("INTEGER", [2, 8]), pool=("INTEGER", [2, 8]))
    sp.add("dropout", ("DOUBLE", [0.01, 0.99]))
    result = experiment.lagom(
        train_fn=trial_fn,
        searchspace=sp,
        optimizer="randomsearch",
        direction="max",
        num_trials=12,
        name="proxy_search",
        hb_interval=0.05,
        es_interval=0.1,
        es_min=5,
        devices=None if device is None else [resolve_device(device)],
    )
    print(
        f"search complete: best_metric={result['best_metric']:.4f} "
        f"best_config={result['best_config']} early_stopped={result.get('early_stopped', 0)}"
    )
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
