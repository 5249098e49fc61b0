"""Parameter-sharding rules on DTensor placements (counterpart of
``hops_tpu/parallel/sharding.py``).

The JAX package annotates each large parameter with a ``PartitionSpec``
over a ``model`` or ``fsdp`` axis and lets GSPMD partition the program.
The port keeps the rule that picks the sharded dimension and expresses
it as a DTensor placement (``Shard(d)`` or ``Replicate()``) on one axis
of a :class:`~hops_tpu_torch.parallel.mesh.Mesh`; ``ShardedStrategy``
feeds the same rule to FSDP2.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import Replicate, Shard

from hops_tpu_torch.parallel.mesh import Mesh, _tree_map


def spec_for(shape: tuple[int, ...], axis_size: int | None = None,
             min_size: int = 4096) -> Shard | Replicate:
    """The placement of one parameter of ``shape``: ``Shard`` on the
    dimension that (a) divides by ``axis_size`` and (b) is largest —
    the Megatron-style column/row split chosen mechanically — for a
    >=2-D parameter of at least ``min_size`` elements; ``Replicate``
    otherwise (biases and norms: their all-reduce would cost more than
    the memory saved)."""
    if len(shape) < 2 or math.prod(shape) < min_size:
        return Replicate()
    if axis_size is not None:
        candidates = [d for d in range(len(shape)) if shape[d] % axis_size == 0]
    else:
        candidates = list(range(len(shape)))
    if not candidates:
        return Replicate()
    return Shard(max(candidates, key=lambda d: shape[d]))


def infer_param_spec(
    params: Any,
    axis: str = "model",
    axis_size: int | None = None,
    min_size: int = 4096,
) -> Any:
    """Placement tree for a tree of parameters (tensors or arrays, in
    dicts, lists or tuples): :func:`spec_for` of each leaf. ``axis``
    names the mesh axis the placements apply to (:func:`sharding_tree`,
    :func:`shard_params`)."""
    del axis  # a placement is per axis; the caller pairs it with one
    return _tree_map(lambda p: spec_for(tuple(p.shape), axis_size, min_size), params)


def sharding_tree(mesh: Mesh, spec_tree: Any, axis: str = "model") -> Any:
    """Per leaf, the placements over every axis of ``mesh``: the leaf's
    placement on ``axis``, ``Replicate()`` on the others."""
    def placements(spec: Any) -> list:
        return [spec if a == axis else Replicate() for a in mesh.axis_names]

    return _tree_map(placements, spec_tree)


def shard_params(mesh: Mesh, params: Any, axis: str = "model", min_size: int = 4096) -> Any:
    """``params`` as DTensors on ``mesh`` with the inferred placements on
    ``axis`` (``distribute_tensor``: rank 0's values, each rank keeping
    its shard). Needs a process group."""
    dm = mesh.device_mesh()
    size = mesh.shape[axis]

    def place(p: Any) -> Any:
        from torch.distributed.tensor import distribute_tensor

        t = torch.as_tensor(p)
        spec = spec_for(tuple(t.shape), size, min_size)
        placements = [spec if a == axis else Replicate() for a in mesh.axis_names]
        return distribute_tensor(t.to(dm.device_type), dm, placements)

    return _tree_map(place, params)
