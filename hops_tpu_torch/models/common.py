"""Training state and losses (counterpart of ``hops_tpu/models/common.py``).

One ``step(state, batch) -> (state, metrics)`` shape for every train
step of the port. The state holds the module (its parameters are the
weights, fp32 masters for training), the optimizer over them, the step
number and the dropout seed. The classification steps, BatchNorm and
the synthetic data of the JAX module are a later slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """The module, its optimizer, the number of steps taken and the seed
    that dropout masks derive from (per step, as JAX folds the step into
    its rng)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    seed: int = 0


def create_train_state(
    model: nn.Module,
    seed: int = 0,
    optimizer: torch.optim.Optimizer | None = None,
    learning_rate: float = 1e-3,
) -> TrainState:
    """A :class:`TrainState` at step 0 over ``model``'s weights as they
    are (load them first: a JAX tree or ``convert.random_params``).

    The default optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999),
    eps=1e-8)``, the update of ``optax.adam``. The weights it updates
    must be fp32 masters (``param_dtype="float32"``): updating bf16
    weights would round every step's update away.
    """
    low = sorted({str(p.dtype) for p in model.parameters() if p.dtype != torch.float32})
    if low:
        raise ValueError(f"train fp32 master weights (param_dtype='float32'), not {low}")
    if optimizer is None:
        optimizer = torch.optim.Adam(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
    return TrainState(model=model, optimizer=optimizer, step=0, seed=seed)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long()
    )


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
