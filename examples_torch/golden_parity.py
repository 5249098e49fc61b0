"""Golden-metric parity on real data: the reference's committed accuracies.

Counterpart of ``examples/golden_parity.py``. The reference ships two
golden numbers as notebook outputs (SURVEY.md §6):

- MNIST FFN via ``experiment.launch`` — **0.9200** val accuracy
  (notebooks/ml/End_To_End_Pipeline/tensorflow/model_repo_and_serving.ipynb
  output cell);
- MNIST CNN via ``experiment.mirrored`` — **0.828125** val accuracy
  (notebooks/ml/Distributed_Training/mirrored_strategy/
  mirroredstrategy_mnist_example.ipynb output cell).

With no network, MNIST itself is not fetchable; the parity run uses the
bundled **real** handwritten-digits dataset (scikit-learn
``load_digits`` — 1797 scanned 8x8 digit images from the UCI
repository), deterministically split, nearest-neighbor-upscaled to the
models' 28x28 input. Same model families, same launchers, real
handwritten-digit pixels, trained on the card; the bar is the
reference's golden number for each launcher.

Usage: ``python examples_torch/golden_parity.py [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hops_tpu_torch import experiment
from hops_tpu_torch.models import common
from hops_tpu_torch.models.mnist import CNN, FFN
from hops_tpu_torch.parallel import multihost
from hops_tpu_torch.parallel.strategy import current_strategy

GOLDEN_FFN = 0.9200  # experiment.launch golden (model_repo_and_serving.ipynb)
GOLDEN_CNN = 0.828125  # experiment.mirrored golden (mirroredstrategy_mnist_example.ipynb)


def real_digits(seed: int = 0):
    """Deterministic train/test split of the real handwritten digits,
    upscaled 8x8 -> 24x24 (x3 nearest) and zero-padded to 28x28."""
    from sklearn.datasets import load_digits

    d = load_digits()
    images = (d.images / 16.0).astype(np.float32)  # (1797, 8, 8) in [0, 1]
    images = np.kron(images, np.ones((1, 3, 3), np.float32))  # 24x24
    images = np.pad(images, ((0, 0), (2, 2), (2, 2)))[..., None]  # 28x28x1
    labels = d.target.astype(np.int32)
    idx = np.random.RandomState(seed).permutation(len(labels))
    images, labels = images[idx], labels[idx]
    n_train = 1500
    return (
        {"image": images[:n_train], "label": labels[:n_train]},
        {"image": images[n_train:], "label": labels[n_train:]},
    )


def _test_accuracy(model, test) -> float:
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(test["image"]).to(next(model.parameters()).device))
    return float(np.mean(logits.argmax(-1).cpu().numpy() == test["label"]))


def train_ffn(epochs: int = 30, batch: int = 100, device=None) -> dict:
    """The ``experiment.launch`` golden config twin (FFN, Adam)."""
    train, test = real_digits()
    model = FFN(dtype="float32", device=device, seed=0)
    state = common.create_train_state(model, learning_rate=1e-3)
    step = common.make_train_step()
    n = len(train["label"])
    for epoch in range(epochs):
        order = np.random.RandomState(epoch).permutation(n)
        for i in range(0, n - batch + 1, batch):
            sel = order[i : i + batch]
            state, _ = step(state, {k: v[sel] for k, v in train.items()})
    return {"accuracy": _test_accuracy(model, test)}


def train_cnn_mirrored(epochs: int = 4) -> dict:
    """The ``experiment.mirrored`` golden config twin (CNN, data-parallel
    over this host's ranks; per-replica batch x num_replicas)."""
    strategy = current_strategy()
    n_rep = strategy.num_replicas_in_sync
    per_replica = 8
    global_batch = per_replica * n_rep
    train, test = real_digits()
    model = CNN(dtype="float32", device=strategy.device, seed=0)
    state = strategy.replicate(common.create_train_state(model, learning_rate=1e-3))
    step = strategy.step(common.make_train_step())
    n = (len(train["label"]) // global_batch) * global_batch
    for epoch in range(epochs):
        order = np.random.RandomState(epoch).permutation(len(train["label"]))[:n]
        for i in range(0, n, global_batch):
            sel = order[i : i + global_batch]
            batch = strategy.distribute_batch({k: v[sel] for k, v in train.items()})
            state, metrics = step(state, batch)
    return {"accuracy": _test_accuracy(model, test)}


def main(*, device=None) -> dict:
    import torch.distributed as dist

    # The mirrored strategy computes on this process's recorded device.
    joined = dist.is_available() and dist.is_initialized()
    if not joined:
        multihost.initialize(device=device)
    try:
        _, ffn = experiment.launch(train_ffn, args={"device": multihost.device()},
                                   name="golden_ffn", metric_key="accuracy")
        _, cnn = experiment.mirrored(train_cnn_mirrored, name="golden_cnn",
                                     metric_key="accuracy")
    finally:
        if not joined:
            multihost.shutdown()
    ffn_acc, cnn_acc = ffn["metric"], cnn["metric"]
    print(f"FFN  (launch):   {ffn_acc:.4f}  golden {GOLDEN_FFN}  "
          f"{'PASS' if ffn_acc >= GOLDEN_FFN else 'FAIL'}")
    print(f"CNN  (mirrored): {cnn_acc:.4f}  golden {GOLDEN_CNN}  "
          f"{'PASS' if cnn_acc >= GOLDEN_CNN else 'FAIL'}")
    return {"ffn": ffn_acc, "cnn": cnn_acc}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
