"""PyTorch wrapper functions through the same experiment launchers.

Counterpart of ``examples/torch_mnist.py``, the twin of the reference's
PyTorch family: ``experiment.launch`` over a torch training fn
(notebooks/ml/Experiment/PyTorch/mnist.ipynb:252, which torch.saves into
the run's logdir) and the same fn under
``experiment.differential_evolution``
(notebooks/ml/Parallel_Experiments/PyTorch/differential_evolution/
mnist.ipynb:230, generations x population semantics). The wrapper owns
its entire training program, returns a metrics dict, and gets a per-run
logdir; here it trains on the card (``device``), and each search trial
on the device group the driver gives it.

Usage: ``python examples_torch/torch_mnist.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from hops_tpu_torch import experiment
from hops_tpu_torch.experiment import tensorboard

try:
    from examples_torch.golden_parity import real_digits
except ImportError:  # run directly as a script from examples_torch/
    from golden_parity import real_digits


def train_torch(lr: float = 1e-3, dropout: float = 0.3, epochs: int = 5,
                device=None) -> dict:
    """The wrapper fn: a full torch program, nothing framework-specific
    about how it is launched. ``device`` None is the card, or inside a
    search trial the trial's device."""
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    # A local generator, not torch.manual_seed: concurrent DE trials
    # share the process-global RNG, so per-trial streams must be local.
    gen = torch.Generator().manual_seed(0)
    train, test = real_digits()
    x = torch.from_numpy(train["image"].reshape(-1, 784)).to(dev)
    y = torch.from_numpy(train["label"].astype(np.int64)).to(dev)

    model = nn.Sequential(
        nn.Linear(784, 128), nn.ReLU(), nn.Dropout(dropout), nn.Linear(128, 10)
    ).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    loss_fn = nn.CrossEntropyLoss()

    model.train()
    for _ in range(epochs):
        perm = torch.randperm(len(y), generator=gen).to(dev)
        for i in range(0, len(y) - 63, 64):
            sel = perm[i : i + 64]
            opt.zero_grad()
            loss = loss_fn(model(x[sel]), y[sel])
            loss.backward()
            opt.step()

    model.eval()
    with torch.no_grad():
        tx = torch.from_numpy(test["image"].reshape(-1, 784)).to(dev)
        pred = model(tx).argmax(dim=1).cpu().numpy()
    acc = float((pred == test["label"]).mean())

    # Reference torch.saves the model into the run's logdir; same here.
    torch.save(model.state_dict(), os.path.join(tensorboard.logdir(), "model.pt"))
    return {"accuracy": acc, "loss": float(loss.detach())}


def main(generations: int = 2, population: int = 4, *, device=None) -> dict:
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    logdir, metrics = experiment.launch(
        train_torch, args={"device": dev}, name="torch_mnist", metric_key="accuracy"
    )
    assert os.path.exists(os.path.join(logdir, "model.pt"))

    search_dir, summary = experiment.differential_evolution(
        train_torch,
        {"lr": [1e-4, 1e-2], "dropout": [0.05, 0.6]},
        generations=generations,
        population=population,
        direction="max",
        optimization_key="accuracy",
        name="torch_mnist_de",
        devices=None if device is None else [dev],
    )
    print(
        f"torch via launch: acc={metrics['accuracy']:.3f}; DE best "
        f"acc={summary['best_metric']:.3f} at {summary['best_config']}"
    )
    return {"launch": metrics, "de": summary, "logdir": logdir}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
