"""Driver-side plotting — the matplotlib_sparkmagic twin.

Counterpart of ``examples/plotting_tour.py``
(notebooks/ml/Plotting/matplotlib_sparkmagic.ipynb:61,87,95, SURVEY.md
§2.8): the reference pulls a distributed DataFrame to the Jupyter driver
(``%%spark -o df``) and plots it locally with matplotlib. Here the three
distributed result kinds the framework produces — a training run's
metric stream, a feature group's statistics, a hyperparameter search's
trials — are pulled driver-local with
:func:`hops_tpu_torch.plotting.collect` and rendered to PNGs in the
run's own directory (headless Agg backend). The search's trials run on
``device`` (default: every visible card).

Usage: ``python examples_torch/plotting_tour.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import pandas as pd

import hops_tpu_torch.featurestore as hsfs
from hops_tpu_torch import experiment, plotting
from hops_tpu_torch.search import Searchspace


def train_fn(steps=60):
    # A cheap run that logs the curves a real one would.
    from hops_tpu_torch.experiment import tensorboard

    loss = 2.5
    for step in range(steps):
        loss *= 0.95
        tensorboard.scalar(step, "loss", loss + 0.02 * math.sin(step))
        tensorboard.scalar(step, "accuracy", 1.0 - loss / 3.0)
    return {"metric": 1.0 - loss, "log": "trained"}


def trial_fn(lr, width, reporter):
    acc = 0.9 - 3.0 * (lr - 0.1) ** 2 - 0.001 * (width - 64) ** 2
    reporter.broadcast(metric=acc)
    return acc


def main(*, device=None) -> dict:
    from hops_tpu_torch.runtime.devices import resolve_device

    # 1) run metrics -> line panels.
    exp_dir, _ = experiment.launch(train_fn, name="plotting_demo")
    metrics_png = plotting.plot_metrics(exp_dir, out=f"{exp_dir}/plots/metrics.png")

    # 2) feature-group statistics (histograms enabled) -> stats figure.
    fs = hsfs.connection().get_feature_store()
    rs = np.random.RandomState(3)
    df = pd.DataFrame(
        {
            "team_id": np.arange(200),
            "season_score": rs.gamma(4.0, 25.0, 200),
            "avg_rating": rs.normal(70, 8, 200),
        }
    )
    fg = fs.create_feature_group(
        "plotting_demo_scores", version=1, primary_key=["team_id"],
        statistics_config={"enabled": True, "histograms": True},
    )
    fg.save(df)
    stats_png = plotting.plot_statistics(fg, out=f"{exp_dir}/plots/statistics.png")

    # 3) search trials -> convergence figure.
    sp = Searchspace(lr=("DOUBLE", [0.01, 0.5]), width=("INTEGER", [16, 128]))
    result = experiment.lagom(
        train_fn=trial_fn, searchspace=sp, optimizer="randomsearch",
        direction="max", num_trials=8, name="plotting_demo_search",
        hb_interval=0.05, devices=None if device is None else [resolve_device(device)],
    )
    trials_png = plotting.plot_trials(result, out=f"{exp_dir}/plots/trials.png")

    print(f"figures: {metrics_png}, {stats_png}, {trials_png}")
    return {"figures": [str(metrics_png), str(stats_png), str(trials_png)]}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
