"""Distribution strategies — the user-facing API of the parallel layer
(counterpart of ``hops_tpu/parallel/strategy.py``).

The JAX package compiles ``fn(state, batch)`` once over a mesh and lets
XLA insert the gradient all-reduce. The port runs ``fn`` in every
process (one per card, ``python -m hops_tpu_torch.launch``) on that
rank's rows of the batch, and averages the gradients over the data
replicas before the optimizer's update, so N replicas on equal shards
compute what one process computes on the global batch:

- a :class:`~hops_tpu_torch.models.common.TrainState` (a module and its
  optimizer; the port's train steps take one) has its module wrapped by
  composable DDP (``torch.distributed._composable.replicate``) for
  :class:`MirroredStrategy` and :class:`CollectiveAllReduceStrategy`,
  or sharded by FSDP2 (``fully_shard``) for :class:`ShardedStrategy`.
  The composable forms keep the module's own attributes
  (``model.device``, ``model.unembed.kernel``), which a
  ``DistributedDataParallel`` wrapper would hide behind ``.module``;
- a tree of plain tensors (``fn`` differentiates with respect to them,
  as a JAX step takes ``jax.grad`` of its state) has its floating
  leaves marked as requiring grad for the call, and a hook on each
  averages its gradient over the replicas.

The step's scalar metrics are averaged over the replicas too, so they
are the global batch's, as the JAX package's replicated outputs are.

Typical wrapper-function use::

    def train_fn():
        strategy = parallel.get_strategy()
        state = strategy.replicate(create_train_state(model))
        step = strategy.step(make_lm_train_step())
        for batch in data:
            state, metrics = step(state, strategy.distribute_batch(batch))
        return {"loss": float(metrics["loss"])}

Multi-rank runs are held on gloo across CPU processes in the tests; one
card runs a process group of one rank (NCCL refuses two ranks on one
card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch import nn

from hops_tpu_torch.parallel import mesh as mesh_lib
from hops_tpu_torch.parallel import multihost
from hops_tpu_torch.parallel.mesh import Mesh, _tree_map
from hops_tpu_torch.runtime.devices import resolve_device

_current: list["Strategy"] = []

_GRAD_COMMS_LATER = (
    "explicit gradient communication (grad_comms: bucketed, quantized or "
    "ZeRO-sharded updates) is the gradient-communication slice of the port "
    "(parallel/grad_comms.py, ROADMAP.md Queue 1 item 4), not ported yet")
_TP_LATER = (
    "ShardedStrategy's model (tensor-parallel) axis is ROADMAP.md Queue 1 item 5 "
    "(tensor parallelism); the LM's attention runs in hand-written kernels that "
    "DTensor cannot propagate through")


def _is_train_state(state: Any) -> bool:
    return isinstance(getattr(state, "model", None), nn.Module) and isinstance(
        getattr(state, "optimizer", None), torch.optim.Optimizer)


class Strategy:
    """Base: data parallelism over an arbitrary mesh of ranks.

    ``device`` is where this process computes (default: the device
    ``multihost.initialize`` recorded, else the card)."""

    def __init__(
        self,
        mesh: Mesh | None = None,
        data_axis: str | tuple[str, ...] = "data",
        grad_comms: Any | None = None,
        device: str | torch.device | None = None,
    ):
        if grad_comms is not None:
            raise NotImplementedError(_GRAD_COMMS_LATER)
        self.mesh = mesh if mesh is not None else mesh_lib.global_mesh()
        self.data_axis = data_axis
        #: Always None until gradient communication is ported.
        self.grad_comms = None
        self._device = device
        # Steps memoized per (fn, donate_state, config), as the JAX
        # package memoizes its compiled steps.
        self._step_cache: dict[Any, Callable[..., Any]] = {}

    @property
    def device(self) -> torch.device:
        """This process's device for the strategy, resolved on first use."""
        if not isinstance(self._device, torch.device):
            self._device = (multihost.device() if self._device is None
                            else resolve_device(self._device))
        return self._device

    # -- introspection (reference: strategy.num_replicas_in_sync) ------------

    @property
    def num_replicas_in_sync(self) -> int:
        axes = self.data_axis if isinstance(self.data_axis, tuple) else (self.data_axis,)
        return math.prod(self.mesh.shape[a] for a in axes)

    @property
    def num_hosts(self) -> int:
        """The number of distinct hosts among the ranks."""
        return len(set(multihost.hosts()))

    def global_batch_size(self, per_replica: int) -> int:
        """Reference pattern: ``BATCH_SIZE_PER_REPLICA * num_replicas``."""
        return per_replica * self.num_replicas_in_sync

    def _distributed(self) -> bool:
        """Whether the mesh's ranks form a process group to reduce over
        (a group of one rank counts: the card runs one)."""
        return multihost._initialized()

    # -- placement ------------------------------------------------------------

    def replicate(self, tree: Any) -> Any:
        """The same value on every rank's device, rank 0's: a TrainState
        has its module moved, broadcast and wrapped for gradient
        averaging (and its optimizer state broadcast); a module is moved
        and wrapped; a tree of tensors is broadcast."""
        if _is_train_state(tree):
            return self._prepare(tree)
        if isinstance(tree, nn.Module):
            return self._wrap(tree.to(self.device))
        return mesh_lib.replicate(self.mesh, tree, self.device)

    def distribute_batch(self, batch: Any) -> Any:
        """This rank's rows of the global ``batch`` on its device."""
        return mesh_lib.shard_batch(self.mesh, batch, self.data_axis, self.device)

    def _wrap(self, model: nn.Module) -> nn.Module:
        """Composable DDP on ``model`` (once): its gradients are averaged
        over the mesh's ranks in backward, and rank 0's weights and
        buffers are broadcast now."""
        if not self._distributed() or getattr(model, "_hops_tpu_parallel", None):
            return model
        from torch.distributed._composable import replicate

        ids = [self.device.index] if self.device.type == "cuda" else None
        replicate(model, device_ids=ids, process_group=self.mesh.group)
        model._hops_tpu_parallel = "ddp"
        return model

    def _prepare(self, state: Any) -> Any:
        """A TrainState ready for :meth:`step`: its module on the device
        and wrapped, its optimizer state with it."""
        model = state.model
        if getattr(model, "_hops_tpu_parallel", None):
            return state
        model.to(self.device)
        broadcast = self._distributed() and self.mesh.size > 1
        for st in state.optimizer.state.values():
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and v.dim():
                    st[k] = v.to(self.device)
                    if broadcast:
                        dist.broadcast(st[k], src=int(self.mesh.devices.flat[0]),
                                       group=self.mesh.group)
        if not self._distributed():
            model._hops_tpu_parallel = "local"  # one process: nothing to average
        self._wrap(model)
        return state

    # -- execution ------------------------------------------------------------

    def step(
        self,
        fn: Callable[..., Any],
        donate_state: bool = True,
        grad_comms: Any | None = None,
    ) -> Callable[..., Any]:
        """``fn(state, batch) -> (state, aux)`` as one data-parallel step:
        the state replicated (prepared on first use), the batch this
        rank's rows, gradients averaged over the replicas before the
        update, and ``aux``'s floating scalars averaged after it.

        The port's train steps update the state in place, so
        ``donate_state`` only keys the memo (the JAX package donates the
        state's buffers). ``grad_comms`` raises ``NotImplementedError``:
        explicit gradient communication is a later slice.
        """
        if grad_comms is not None or self.grad_comms is not None:
            raise NotImplementedError(_GRAD_COMMS_LATER)
        key = (fn, donate_state, None)
        cached = self._step_cache.get(key)
        if cached is None:
            cached = self._step_cache[key] = self._make_step(fn)
        return cached

    def _make_step(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        def stepped(state: Any, batch: Any):
            if _is_train_state(state):
                new_state, aux = fn(self._prepare(state), batch)
            else:
                with self._averaged_leaf_grads(state):
                    new_state, aux = fn(state, batch)
                new_state = _tree_map(
                    lambda x: x.detach() if isinstance(x, torch.Tensor) else x, new_state)
            return new_state, self._average_metrics(aux)

        return stepped

    def _replicas_group(self) -> tuple[bool, Any]:
        """(whether there are replicas to reduce over, their group)."""
        return self._distributed() and self.num_replicas_in_sync > 1, self.mesh.group

    @contextlib.contextmanager
    def _averaged_leaf_grads(self, state: Any) -> Iterator[None]:
        """Mark the floating leaf tensors of ``state`` as requiring grad,
        with a hook that averages each one's gradient over the replicas,
        for the duration of the block."""
        reduce, group = self._replicas_group()
        n = self.num_replicas_in_sync
        leaves: list[torch.Tensor] = []
        _tree_map(lambda x: leaves.append(x) if isinstance(x, torch.Tensor) else None, state)
        leaves = [t for t in leaves if t.is_floating_point() and t.is_leaf]

        def average(g: torch.Tensor) -> torch.Tensor:
            g = g.clone()
            dist.all_reduce(g, group=group)
            return g / n

        flags = [t.requires_grad for t in leaves]
        handles = []
        for t in leaves:
            t.requires_grad_(True)
            if reduce:
                handles.append(t.register_hook(average))
        try:
            yield
        finally:
            for h in handles:
                h.remove()
            for t, flag in zip(leaves, flags):
                t.requires_grad_(flag)

    def _average_metrics(self, aux: Any) -> Any:
        """``aux`` with each floating 0-d tensor of a dict averaged over
        the replicas (one all-reduce)."""
        reduce, group = self._replicas_group()
        if not reduce or not isinstance(aux, dict):
            return aux
        keys = [k for k, v in aux.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0 and v.is_floating_point()]
        if not keys:
            return aux
        packed = torch.stack([aux[k].detach().float() for k in keys])
        dist.all_reduce(packed, group=group)
        packed /= self.num_replicas_in_sync
        return {**aux, **{k: packed[i].to(aux[k].dtype) for i, k in enumerate(keys)}}

    def run(self, fn: Callable[..., Any], state: Any, batch: Any) -> Any:
        return self.step(fn)(state, self.distribute_batch(batch))

    # -- scope (reference: ``with strategy.scope():``) ------------------------

    @contextlib.contextmanager
    def scope(self) -> Iterator["Strategy"]:
        _current.append(self)
        try:
            yield self
        finally:
            _current.pop()


class MirroredStrategy(Strategy):
    """Data parallelism over the ranks of ONE host (reference:
    single-host ``tf.distribute.MirroredStrategy``); DDP."""

    def __init__(self, data_axis: str = "data", grad_comms: Any | None = None,
                 device: str | torch.device | None = None):
        super().__init__(mesh_lib.local_mesh((data_axis,)), data_axis, grad_comms, device)


class CollectiveAllReduceStrategy(Strategy):
    """Data parallelism over EVERY rank; gradients all-reduced over
    NVLink and the network (reference: ``MultiWorkerMirroredStrategy``
    with NCCL); DDP.

    ``update_sharding`` other than ``"replicated"`` (the ZeRO-1/2
    updates) and ``grad_comms`` raise ``NotImplementedError``: they are
    the gradient-communication slice.
    """

    def __init__(
        self,
        data_axis: str = "data",
        update_sharding: str = "replicated",
        grad_comms: Any | None = None,
        device: str | torch.device | None = None,
    ):
        if update_sharding != "replicated":
            raise NotImplementedError(_GRAD_COMMS_LATER)
        super().__init__(mesh_lib.global_mesh((data_axis,)), data_axis, grad_comms, device)


# The reference docs name ParameterServerStrategy as a supported mode but
# never call it; it is a documented alias of collective all-reduce.
ParameterServerStrategy = CollectiveAllReduceStrategy


class ShardedStrategy(Strategy):
    """Data × FSDP parallelism over one (data, fsdp, model) mesh, on FSDP2.

    Large parameters are sharded over ``fsdp`` on the dimension the JAX
    package's rule picks (:func:`~hops_tpu_torch.parallel.sharding.spec_for`),
    the rest on their first dimension (FSDP2 shards every parameter);
    with ``data > 1`` the shards are replicated over ``data`` (HSDP).
    The batch splits over data AND fsdp, as in the JAX package. Call
    :meth:`shard_state` once after creating the train state (the step
    does it on first use otherwise). ``model > 1`` raises
    ``NotImplementedError``: tensor parallelism is a later slice.
    """

    def __init__(
        self,
        data: int = -1,
        fsdp: int = 1,
        model: int = 1,
        min_shard_size: int = 4096,
        device: str | torch.device | None = None,
    ):
        if model != 1:
            raise NotImplementedError(_TP_LATER)
        if data == -1 and fsdp == -1:
            data = 1  # fsdp=-1 alone asks for every rank on the fsdp axis
        mesh = mesh_lib.make_mesh({"data": data, "fsdp": fsdp, "model": model})
        super().__init__(mesh, ("data", "fsdp"), device=device)
        self.min_shard_size = min_shard_size

    def _placement(self, p: nn.Parameter):
        from hops_tpu_torch.parallel.sharding import spec_for
        from torch.distributed.tensor import Shard

        spec = spec_for(tuple(p.shape), self.mesh.shape["fsdp"], self.min_shard_size)
        return spec if isinstance(spec, Shard) else None

    def _wrap(self, model: nn.Module) -> nn.Module:
        """FSDP2 on each of the LM's blocks and on the root. The root
        keeps its parameters unsharded from forward to backward, so a
        loss that reads one after the forward (the chunked LM-head loss
        reads ``unembed.kernel``) reads the gathered weight and its
        gradient is reduce-scattered with the rest."""
        if not self._distributed() or getattr(model, "_hops_tpu_parallel", None):
            return model
        from torch.distributed.fsdp import fully_shard

        axes = ("data", "fsdp") if self.mesh.shape["data"] > 1 else ("fsdp",)
        dm = self.mesh.device_mesh(axes)
        blocks = model.blocks() if callable(getattr(model, "blocks", None)) else []
        for block in blocks:
            fully_shard(block, mesh=dm, shard_placement_fn=self._placement)
        fully_shard(model, mesh=dm, reshard_after_forward=False,
                    shard_placement_fn=self._placement)
        model._hops_tpu_parallel = "fsdp"
        return model

    def shard_state(self, state: Any) -> Any:
        """The TrainState with its module on FSDP2 and its optimizer
        rebuilt over the sharded parameters, carrying its state (moments
        sharded as their parameters are). FSDP2 swaps each parameter for
        a DTensor, so the optimizer built before it would update dead
        tensors."""
        if not _is_train_state(state):
            raise TypeError("ShardedStrategy shards a TrainState's module (FSDP2); "
                            f"got {type(state).__name__}")
        model = state.model
        if not self._distributed():
            return super()._prepare(state)
        if getattr(model, "_hops_tpu_parallel", None):
            return state
        opt = state.optimizer
        old = dict(model.named_parameters())
        model.to(self.device)
        self._wrap(model)
        new = dict(model.named_parameters())
        by_old = {id(p): new[name] for name, p in old.items()}
        groups = [{**g, "params": [by_old[id(p)] for p in g["params"]]} for g in opt.param_groups]
        rebuilt = type(opt)(groups, **opt.defaults)
        from torch.distributed.tensor import distribute_tensor

        for name, p in old.items():
            st = opt.state.get(p)
            if not st:
                continue
            q = new[name]
            rebuilt.state[q] = {
                k: distribute_tensor(v.to(self.device), q.device_mesh, q.placements)
                if isinstance(v, torch.Tensor) and v.shape == p.shape else v
                for k, v in st.items()}
        return dataclasses.replace(state, model=model, optimizer=rebuilt)

    def _prepare(self, state: Any) -> Any:
        return self.shard_state(state)

    def step(
        self,
        fn: Callable[..., Any],
        donate_state: bool = True,
        grad_comms: Any | None = None,
    ) -> Callable[..., Any]:
        if grad_comms is not None:
            raise ValueError(
                "ShardedStrategy already owns its collectives (FSDP2); grad_comms "
                "applies to the data-parallel strategies (Strategy/Mirrored/"
                "CollectiveAllReduce)")
        return super().step(fn, donate_state)


def current_strategy() -> "Strategy | None":
    """The innermost active ``strategy.scope()``, if any."""
    return _current[-1] if _current else None


def get_strategy() -> "Strategy":
    """Active strategy, or a default over every rank."""
    return _current[-1] if _current else Strategy()
