"""Process identity across hosts (counterpart of
``hops_tpu/parallel/multihost.py``).

Every host runs the same program; host 0 is the chief that registers
runs. The port reads the process index and count from
``torch.distributed``: with no process group initialized the world is
one process of index 0. Joining a group (``initialize``) and the
cross-host barrier, broadcast and agreement helpers belong to the
distribution layer, a later slice.
"""

from __future__ import annotations

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


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
