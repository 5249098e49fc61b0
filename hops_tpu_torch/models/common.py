"""Training state and losses (counterpart of ``hops_tpu/models/common.py``).

One ``step(state, batch) -> (state, metrics)`` shape for every train
step of the port. The state holds the module (its parameters are the
weights, fp32 masters for training; BatchNorm's running statistics are
its buffers), the optimizer over them, the step number and the dropout
seed. A step updates the weights, the statistics and the optimizer's
state in place and returns the state with the next step number.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn

from hops_tpu_torch.runtime.devices import resolve_device


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
    _require_fp32(model)
    if optimizer is None:
        optimizer = torch.optim.Adam(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
    return TrainState(model=model, optimizer=optimizer, step=0, seed=seed)


def _require_fp32(model: nn.Module) -> None:
    low = sorted({str(p.dtype) for p in model.parameters() if p.dtype != torch.float32})
    if low:
        raise ValueError(f"train fp32 master weights (param_dtype='float32'), not {low}")


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of step ``step`` (``fold_in(rng, step)`` in JAX)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long()
    )


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(
    loss_fn: Callable[..., Any] | None = None,
    grad_comms: Any | None = None,
    axis_name: Any = "data",
) -> Callable[[TrainState, dict[str, Any]], tuple[TrainState, dict[str, torch.Tensor]]]:
    """Classification train step: ``(state, {"image", "label"}) ->
    (state, {"loss", "accuracy"})``.

    The JAX package's step on a port :class:`TrainState` or
    :class:`BNTrainState`: a train-mode forward of the NHWC images (a
    BatchNorm model normalizes by batch statistics and updates its
    running ones), ``loss_fn(logits, labels)`` (default: mean softmax
    cross-entropy), one optimizer step. Dropout masks derive from
    ``(state.seed, state.step)``. Images and labels may be numpy arrays
    or tensors; they are moved to the model's device. Metrics are 0-d
    tensors there (no host sync).

    ``grad_comms`` (explicit gradient communication across replicas)
    belongs to the distribution layer, a later slice: it must be None.
    """
    if grad_comms is not None:
        raise NotImplementedError(
            "grad_comms needs the distribution layer (gradient communication across "
            "replicas), which is a later slice of the port")
    del axis_name  # names the replica axis of grad_comms only
    fn = loss_fn if loss_fn is not None else cross_entropy_loss

    def train_step(state: TrainState, batch: dict[str, Any]):
        model = state.model
        dev = _device_of(model)
        images = torch.as_tensor(batch["image"]).to(dev)
        labels = torch.as_tensor(batch["label"]).to(dev, torch.long)
        gen = torch.Generator().manual_seed(step_seed(state.seed, state.step))
        logits = model(images, train=True, generator=gen)
        loss = fn(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        metrics = {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), labels)}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


@dataclasses.dataclass
class BNTrainState(TrainState):
    """TrainState of a model with BatchNorm: the running statistics are
    the module's buffers, so they train, save and restore with it."""


def create_bn_train_state(
    model: nn.Module,
    seed: int = 0,
    optimizer: torch.optim.Optimizer | None = None,
    learning_rate: float = 0.1,
) -> BNTrainState:
    """Like :func:`create_train_state` for BatchNorm models; the default
    optimizer is SGD with momentum 0.9 (``optax.sgd(lr, momentum=0.9)``:
    the trace starts at the first gradient, no dampening)."""
    _require_fp32(model)
    if optimizer is None:
        optimizer = torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=0.9)
    return BNTrainState(model=model, optimizer=optimizer, step=0, seed=seed)


def make_bn_train_step(
    loss_fn: Callable[..., Any] | None = None,
    grad_comms: Any | None = None,
    axis_name: Any = "data",
) -> Callable[[BNTrainState, dict[str, Any]], tuple[BNTrainState, dict[str, torch.Tensor]]]:
    """Alias of :func:`make_train_step`, which handles BatchNorm states."""
    return make_train_step(loss_fn, grad_comms=grad_comms, axis_name=axis_name)


def make_eval_step() -> Callable[[TrainState, dict[str, Any]], dict[str, torch.Tensor]]:
    """Eval step for plain and BatchNorm models alike (running
    statistics are read from the module)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict[str, Any]):
        dev = _device_of(state.model)
        labels = torch.as_tensor(batch["label"]).to(dev, torch.long)
        logits = state.model(torch.as_tensor(batch["image"]).to(dev), train=False)
        return {"loss": cross_entropy_loss(logits, labels), "accuracy": accuracy(logits, labels)}

    return eval_step


@dataclasses.dataclass
class SyntheticClassData:
    """Learnable synthetic classification data: class-prototype images
    plus noise, so models reach high accuracy without a dataset.

    The JAX package draws from ``jax.random``, which torch cannot
    reproduce: the port draws from a ``torch.Generator`` on ``device``
    (the card by default) and is deterministic for a given ``seed``,
    ``batch_size`` and device. Batch ``i`` depends on ``(seed, i)`` only,
    so ``batches(..., start=k)`` yields the stream from batch ``k`` on
    without drawing the batches before it.
    """

    num_classes: int = 10
    shape: tuple[int, ...] = (28, 28, 1)
    noise: float = 0.35
    seed: int = 0
    device: Any = None

    def batches(self, batch_size: int, num_batches: int,
                start: int = 0) -> Iterator[dict[str, torch.Tensor]]:
        dev = resolve_device(self.device)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        protos = torch.randn((self.num_classes, *self.shape), generator=g, device=dev)
        for i in range(start, num_batches):
            g.manual_seed(step_seed(self.seed, i + 1))
            labels = torch.randint(0, self.num_classes, (batch_size,), generator=g, device=dev)
            noise = torch.randn((batch_size, *self.shape), generator=g, device=dev)
            yield {"image": protos[labels] + self.noise * noise, "label": labels}
