"""Multi-host runtime initialization and cross-host coordination
(counterpart of ``hops_tpu/parallel/multihost.py``).

Every process runs the same program; host 0 is the chief that registers
runs. In the JAX package one process drives every chip of its host; in
the port one process drives one card (or the CPU), the torch idiom, so
the "hosts" of the JAX package's helpers are the port's processes:
``process_index`` is the rank and ``process_count`` the world size.
:func:`initialize` joins them into one ``torch.distributed`` process
group (NCCL for cards, gloo for the CPU) through a ``tcp://`` rendezvous
at the chief; control-plane barriers, broadcasts and agreement checks
ride that group. With no process group the world is one process of
index 0 and every helper is local.
"""

from __future__ import annotations

import os
import socket
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from hops_tpu_torch.runtime.devices import resolve_device
from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)

# The device this process computes on, once initialize() has named one
# (the launcher's --platform); None means the card, cuda:0.
_device: torch.device | None = None
# Hostname of every rank, gathered once per process group.
_hosts: list[str] | None = None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _local_rank(process_id: int) -> int:
    """This process's card on its host: ``LOCAL_RANK`` when a launcher
    set it, else the rank modulo the host's cards (ranks host-major)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(1, torch.cuda.device_count())


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Join the multi-host runtime: a process group of ``num_processes``
    ranks that meet at ``coordinator_address`` (``host:port``, served by
    rank 0). The backend follows the device: NCCL for a CUDA device,
    pinned to this process's card (``torch.cuda.set_device``), gloo for
    the CPU; ``device=None`` is the card. Nothing falls back from one
    to the other.

    A single process with no coordinator joins nothing, as in the JAX
    package; ``device`` is still recorded as this process's device
    (:func:`device`). Joining twice is a no-op. After joining, every
    rank adopts the chief's run-session id, so a run's artifacts land in
    one ``Experiments/<session>_<n>`` directory.
    """
    global _device
    if _initialized():
        return
    want_multi = coordinator_address is not None or num_processes not in (None, 1)
    if not want_multi:
        if device is not None:
            _device = resolve_device(device)
        return
    dev = resolve_device(device)
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "joining a process group needs coordinator_address, num_processes and "
            f"process_id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if dev.type == "cuda":
        dev = torch.device("cuda", _local_rank(process_id))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        **({"device_id": dev} if backend == "nccl" else {}),
    )
    _device = dev
    _sync_session_id()
    hosts()  # gathered while every rank is here, so later reads are local
    log.info("joined multihost runtime: rank %d/%d on %s (%s)",
             process_index(), process_count(), dev, backend)


def shutdown() -> None:
    """Leave the process group (if any) and forget the recorded device."""
    global _device, _hosts
    if _initialized():
        dist.destroy_process_group()
    _device, _hosts = None, None


def device() -> torch.device:
    """This process's device: the one :func:`initialize` recorded, else
    the card, ``cuda:0`` (raises when there is none)."""
    return _device if _device is not None else resolve_device(None)


def _sync_session_id() -> None:
    """Adopt the chief's run-session id on every process so a run's
    artifacts land in ONE ``Experiments/<session>_<n>`` directory."""
    from hops_tpu_torch.runtime import rundir

    rundir.set_session_id(broadcast_from_chief(rundir.session_id() if is_chief() else ""))


def process_index() -> int:
    """This process's rank (``jax.process_index()`` in the JAX package);
    0 when no process group is initialized."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes (``jax.process_count()`` in the JAX
    package); 1 when no process group is initialized."""
    return dist.get_world_size() if _initialized() else 1


def is_chief() -> bool:
    """Host 0 — the reference's "chief worker"/driver role."""
    return process_index() == 0


def hosts() -> list[str]:
    """The hostname of every rank, by rank. :func:`initialize` gathers
    them; in a group joined some other way the first call gathers them,
    a collective that every rank must make."""
    global _hosts
    if not _initialized():
        return [socket.gethostname()]
    if _hosts is None or len(_hosts) != process_count():
        gathered: list[Any] = [None] * process_count()
        dist.all_gather_object(gathered, socket.gethostname())
        _hosts = [str(h) for h in gathered]
    return list(_hosts)


def broadcast_from_chief(value: Any) -> Any:
    """Broadcast a small host-level value (config, run ids; anything
    picklable) from rank 0 to all ranks. Control-plane use only."""
    if not _initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Block until every rank has reached the barrier ``name``."""
    del name  # the JAX package names its barriers; torch's are anonymous
    if _initialized():
        dist.barrier()


def all_hosts_agree(value: Any) -> bool:
    """Check a value is identical on every rank (guards against
    divergent control flow, the classic SPMD deadlock)."""
    arr = np.asarray(value, dtype=np.float32).reshape(-1)
    if not _initialized():
        return True
    gathered: list[Any] = [None] * process_count()
    dist.all_gather_object(gathered, arr)
    return all(g.shape == arr.shape and np.array_equal(g, gathered[0]) for g in gathered)
