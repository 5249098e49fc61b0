"""Distributed-training twins: mirrored + collective_all_reduce on
synthetic data.

Counterpart of ``examples/distributed_training.py``, the twin of the
reference's ``*_simulated_data_example.ipynb`` notebooks (SURVEY.md §4
item 2): random tensors exercise the distributed path without a
dataset. ``mirrored`` = this host's ranks (single-host
MirroredStrategy, mirroredstrategy_mnist_example.ipynb:125);
``collective_all_reduce`` = every rank of the run (MultiWorkerMirrored,
SURVEY.md §2.9 row 2) — the same wrapper, gradients averaged by DDP
over NCCL. Run under ``python -m hops_tpu_torch.launch`` for several
ranks; alone it is one rank on ``--device``.

Usage: ``python examples_torch/distributed_training.py [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from hops_tpu_torch import experiment
from hops_tpu_torch.models import common
from hops_tpu_torch.models.mnist import CNN
from hops_tpu_torch.parallel import multihost
from hops_tpu_torch.parallel.strategy import current_strategy


def train_wrapper():
    strategy = current_strategy()
    n = strategy.num_replicas_in_sync
    per_replica_batch = 32
    global_batch = per_replica_batch * n

    rng = np.random.RandomState(0)
    model = CNN(dtype="float32", dropout_rate=0.1, device=strategy.device, seed=0)
    state = strategy.replicate(common.create_train_state(model))
    step = strategy.step(common.make_train_step())

    for i in range(10):
        batch = strategy.distribute_batch(
            {
                "image": rng.rand(global_batch, 28, 28, 1).astype(np.float32),
                "label": rng.randint(0, 10, global_batch),
            }
        )
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    print(f"replicas={n} loss={loss:.4f}")
    return {"loss": loss, "accuracy": float(metrics["accuracy"])}


def main(*, device=None) -> dict:
    import torch.distributed as dist

    # The strategies compute on this process's recorded device; under the
    # launcher, the group's (it recorded it when the ranks joined).
    joined = dist.is_available() and dist.is_initialized()
    if not joined:
        multihost.initialize(device=device)
    try:
        _, single_host = experiment.mirrored(train_wrapper, name="mirrored_simulated",
                                             metric_key="accuracy")
        _, full_slice = experiment.collective_all_reduce(
            train_wrapper, name="collective_simulated", metric_key="accuracy"
        )
    finally:
        if not joined:
            multihost.shutdown()
    print(f"mirrored={single_host['metric']} collective={full_slice['metric']}")
    return {"mirrored": single_host, "collective": full_slice}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
