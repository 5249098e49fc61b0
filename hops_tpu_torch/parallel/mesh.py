"""Mesh construction and batch placement (counterpart of
``hops_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` of chips over the slice;
the port lays a :class:`Mesh` of ``torch.distributed`` ranks, one process
per card (or per CPU worker), and hands torch a
``torch.distributed.device_mesh.DeviceMesh`` of the same grid where
DTensor and FSDP2 need one (:meth:`Mesh.device_mesh`). Axis conventions
are the JAX package's:

- ``data``    — batch (data-parallel) axis
- ``fsdp``    — parameter-sharding axis (ZeRO-style, optional)
- ``model``   — tensor-parallel axis
- ``seq``     — sequence/context-parallel axis (ring attention)

Ranks are laid out in rank order, host-major as launchers number them,
so the innermost axes stay inside one host. With no process group the
world is one rank, and a mesh is the one local device.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hops_tpu_torch.parallel import multihost

# Sub-slice scoping: a trial runner partitions the ranks into disjoint
# groups and enters a device_scope per trial thread, so framework code
# that builds meshes inside the trial sees only its group.
_scope = threading.local()


@contextlib.contextmanager
def device_scope(devices: Sequence[int]):
    """Limit default mesh construction on this thread to the ranks
    ``devices``."""
    prev = getattr(_scope, "devices", None)
    _scope.devices = list(devices)
    try:
        yield
    finally:
        _scope.devices = prev


def scoped_devices() -> list[int] | None:
    """Ranks of the enclosing :func:`device_scope`, or None."""
    devs = getattr(_scope, "devices", None)
    return list(devs) if devs is not None else None


class Mesh:
    """A named grid of ranks: ``devices`` is an int array of global ranks
    shaped by the axes, ``shape`` maps each axis name to its size (as
    ``jax.sharding.Mesh.shape`` does). ``group`` is the process group
    the mesh's collectives ride, None for the default (whole-world)
    group."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group: Any = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d rank grid for axes {self.axis_names}")
        self.group = group
        self._device_meshes: dict[tuple[str, ...], Any] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.reshape(-1).tolist()})"

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """The axis coordinates of ``rank`` (default: this process's)."""
        rank = multihost.process_index() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def device_mesh(self, axes: Sequence[str] | None = None):
        """The ``torch.distributed`` ``DeviceMesh`` over ``axes`` (default:
        every axis; the axes left out must have size 1), on this process's
        device type. Needs a process group (``multihost.initialize``)."""
        axes = tuple(self.axis_names if axes is None else axes)
        cached = self._device_meshes.get(axes)
        if cached is not None:
            return cached
        dropped = [a for a in self.axis_names if a not in axes]
        if any(self.shape[a] != 1 for a in dropped):
            raise ValueError(f"axes {dropped} of {self.shape} are not of size 1")
        if not multihost._initialized():
            raise RuntimeError(
                "a DeviceMesh needs a process group: join one with multihost.initialize "
                "or run under python -m hops_tpu_torch.launch")
        from torch.distributed.device_mesh import DeviceMesh

        grid = self.devices.reshape([self.shape[a] for a in axes])
        dm = DeviceMesh(multihost.device().type, torch.from_numpy(grid), mesh_dim_names=axes)
        self._device_meshes[axes] = dm
        return dm


def _resolve_devices(devices: Sequence[int] | None) -> list[int]:
    """Ranks for mesh construction: the explicit argument, else the
    enclosing :func:`device_scope`'s group, else every rank — sorted,
    so neighbours on one host stay adjacent on the inner axes."""
    if devices is None:
        devices = scoped_devices()
    devs = list(devices) if devices is not None else list(range(multihost.process_count()))
    return sorted(int(d) for d in devs)


def make_mesh(
    shape: Sequence[int] | Mapping[str, int] | None = None,
    axis_names: Sequence[str] = ("data",),
    devices: Sequence[int] | None = None,
) -> Mesh:
    """Build a mesh over the ranks ``devices`` (default: the enclosing
    :func:`device_scope`'s group, else every rank).

    ``shape`` may be a dict ``{"data": 4, "model": 2}``, a tuple matching
    ``axis_names``, or ``None`` (all ranks on the first axis). ``-1``
    in one position means "whatever is left".
    """
    devs = _resolve_devices(devices)
    if isinstance(shape, Mapping):
        axis_names = tuple(shape.keys())
        shape = tuple(shape.values())
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    shape = list(shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = len(devs) // known
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devs)} devices")
    return Mesh(np.array(devs).reshape(shape), axis_names)


def _host_of(rank: int) -> int:
    """The index of ``rank``'s host, hosts numbered in order of their
    first rank."""
    names = multihost.hosts()
    order = list(dict.fromkeys(names))
    return order.index(names[rank])


def hybrid_mesh(
    ici: Mapping[str, int],
    dcn: Mapping[str, int],
    devices: Sequence[int] | None = None,
    slice_id: Callable[[int], Any] | None = None,
) -> Mesh:
    """Multi-host mesh: the ``dcn`` axes (across hosts, over the network)
    outermost, the ``ici`` axes (the ranks of one host, over NVLink)
    innermost — the JAX package's DCN × ICI layout with hosts in place
    of slices. Put pure data parallelism on the ``dcn`` axes and keep
    every bandwidth-hungry axis on ``ici`` axes inside one host.

    ``slice_id`` maps a rank to its group (default: its host, from the
    ranks' hostnames); to emulate hosts on one machine pass one, e.g.
    ``lambda r: r // 4``. Every group must hold ``prod(ici)`` ranks and
    ``prod(dcn)`` must equal the number of groups.

        mesh = hybrid_mesh(ici={"data": 4, "model": 2}, dcn={"replica": 2})
        # axes ("replica", "data", "model")
    """
    devs = _resolve_devices(devices)
    if slice_id is None:
        slice_id = _host_of
    groups: dict[Any, list[int]] = {}
    for d in devs:
        groups.setdefault(slice_id(d), []).append(d)
    slices = [groups[k] for k in sorted(groups)]
    n_dcn, n_ici = math.prod(dcn.values()), math.prod(ici.values())
    if len(slices) != n_dcn:
        raise ValueError(
            f"dcn axes {dict(dcn)} want {n_dcn} slices, found {len(slices)} "
            f"(slice ids {sorted(groups)})")
    sizes = {len(s) for s in slices}
    if sizes != {n_ici}:
        raise ValueError(
            f"ici axes {dict(ici)} want {n_ici} chips per slice, "
            f"found sizes {sorted(sizes)}")
    arr = np.array(slices).reshape(tuple(dcn.values()) + tuple(ici.values()))
    return Mesh(arr, tuple(dcn) + tuple(ici))


def local_mesh(axis_names: Sequence[str] = ("data",)) -> Mesh:
    """Mesh over this host's ranks only (the reference's single-host
    MirroredStrategy domain) — or the enclosing trial's group inside a
    :func:`device_scope`. On several hosts its collectives ride a
    process group of this host's ranks."""
    scoped = scoped_devices()
    if scoped is not None:
        return make_mesh(axis_names=axis_names, devices=scoped)
    names = multihost.hosts()
    by_host: dict[str, list[int]] = {}
    for rank, name in enumerate(names):
        by_host.setdefault(name, []).append(rank)
    mine = by_host[names[multihost.process_index()]]
    mesh = make_mesh(axis_names=axis_names, devices=mine)
    if len(by_host) > 1:
        # Every rank creates every host's group, in one order.
        mesh.group, _ = dist.new_subgroups_by_enumeration(list(by_host.values()))
    return mesh


def global_mesh(axis_names: Sequence[str] = ("data",)) -> Mesh:
    """Mesh over every rank (the MultiWorkerMirrored domain)."""
    return make_mesh(axis_names=axis_names)


def replicated(mesh: Mesh) -> list:
    """DTensor placements of a value replicated over every axis of
    ``mesh`` (``NamedSharding(mesh, P())`` in the JAX package)."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * len(mesh.axis_names)


def pvary(x: Any, axes: Sequence[str | None]) -> Any:
    """``x`` unchanged. In the JAX package this marks a broadcast constant
    as varying over ``axes`` for ``shard_map``'s loop-carry typing; a
    torch process holds its own local values, untyped by axis, so there
    is nothing to mark. Kept so callers written against the JAX
    package's surface work as they are."""
    del axes
    return x


def batch_sharding(mesh: Mesh, axis: str | tuple[str, ...] = "data") -> list:
    """DTensor placements of a batch split on its leading dim along the
    data axis (or several combined axes, e.g. ``("data", "fsdp")`` for
    ZeRO semantics), replicated over the others."""
    from torch.distributed.tensor import Replicate, Shard

    axes = axis if isinstance(axis, tuple) else (axis,)
    return [Shard(0) if a in axes else Replicate() for a in mesh.axis_names]


def _data_slot(mesh: Mesh, axis: str | tuple[str, ...]) -> tuple[int, int]:
    """(this rank's index among the data replicas, their count)."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    coords = mesh.coords()
    sizes = [mesh.shape[a] for a in axes]
    index = int(np.ravel_multi_index([coords[a] for a in axes], sizes)) if sizes else 0
    return index, math.prod(sizes)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Any, axis: str | tuple[str, ...] = "data",
                device: str | torch.device | None = None) -> Any:
    """This rank's rows of a batch tree (numpy arrays or tensors, the
    same global batch on every rank), on ``device`` (default: this
    process's, :func:`multihost.device`).

    As in the JAX package's multi-process runs, each process contributes
    its process-local rows: the rank's contiguous slice along the leading
    dim, by its index among the data replicas on ``axis``. The leading
    dim must divide by the replica count, as a sharding's must.
    """
    index, count = _data_slot(mesh, axis)
    dev = multihost.device() if device is None else torch.device(device)

    def place(x: Any) -> torch.Tensor:
        t = torch.as_tensor(x)
        rows = t.shape[0]
        if rows % count:
            raise ValueError(f"batch of {rows} rows does not split over {count} replicas")
        per = rows // count
        return t[index * per:(index + 1) * per].to(dev)

    return _tree_map(place, batch)


def replicate(mesh: Mesh, tree: Any, device: str | torch.device | None = None) -> Any:
    """A tree of tensors (or numpy arrays) as rank ``mesh.devices.flat[0]``
    holds it, on every rank's ``device`` (default: this process's):
    broadcast over the mesh's group."""
    dev = multihost.device() if device is None else torch.device(device)
    src = int(mesh.devices.reshape(-1)[0])

    def place(x: Any) -> Any:
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        t = torch.as_tensor(x).to(dev).clone()
        if multihost._initialized() and mesh.size > 1:
            dist.broadcast(t, src=src, group=mesh.group)
        return t

    return _tree_map(place, tree)
