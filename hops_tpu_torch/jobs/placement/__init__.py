"""Multi-host placement: host agents, a placement client, shard servers.

The counterpart of ``hops_tpu/jobs/placement/__init__.py``, copied with the port's imports.

Every distributed piece of the platform used to be single-host: fleet
replicas were local ``Popen`` children of the ``ReplicaManager``,
feature-store shards were local files, and the router only ever spoke
to ``127.0.0.1``. This package is the control plane that removes that
assumption — the port's equivalent of the reference platform's
jobs service (PAPER.md L6, ``jobs-client/``):

- :mod:`~hops_tpu_torch.jobs.placement.registry` — :class:`Host` +
  :class:`HostRegistry`: the set of machines placement may use, from a
  static list or a join-via-announce directory hostds heartbeat into.
- :mod:`~hops_tpu_torch.jobs.placement.hostd` — the per-host agent: a stdlib
  HTTP daemon accepting spawn / drain / reap / kill / health verbs for
  the UNITS on its host (``serving_host --fleet-worker`` replicas and
  :mod:`~hops_tpu_torch.jobs.placement.shardd` feature-shard servers).
- :mod:`~hops_tpu_torch.jobs.placement.client` — :class:`PlacementClient`:
  what ``ReplicaManager`` (and through it the autoscaler and rollouts)
  drives instead of local ``Popen``. Per-host circuit breakers,
  deadlines on every RPC, and placement across the surviving hosts
  when one dies — the ``placement.rpc`` fault point makes partitions
  deterministically injectable.
- :mod:`~hops_tpu_torch.jobs.placement.shardd` — one feature-store shard
  (``featurestore.online.OnlineStore``) behind HTTP, warm-startable
  from a snapshot manifest; it imports the feature store's online module
  and with it torch, as the JAX package's imports JAX.
- :mod:`~hops_tpu_torch.jobs.placement.lease` — :class:`Lease`: the TTL
  contract behind hostd's self-fencing (a host that cannot renew
  kills its own units before survivors re-place them).
- :mod:`~hops_tpu_torch.jobs.placement.invariants` — the post-hoc audit
  proving "at most one live unit per slot" from flight events.

Data plane vs control plane: the placement client places units and
manages their lifecycle; request traffic (router forwards, shard
``multi_get`` fan-out) goes DIRECT to each unit's ``host:port`` — the
hostd is never on the hot path. Partition tolerance spans both: the
client mints ``(slot, generation)`` identity for every unit, data
planes refuse superseded generations, and the lease fences the host
side (docs/operations.md "Partition tolerance & fencing").

See docs/operations.md "Multi-host placement".
"""

from hops_tpu_torch.jobs.placement.client import (
    GENERATION_HEADER,
    PlacedUnit,
    PlacementClient,
    PlacementError,
)
from hops_tpu_torch.jobs.placement.hostd import Hostd
from hops_tpu_torch.jobs.placement.invariants import audit_slot_invariant
from hops_tpu_torch.jobs.placement.lease import Lease
from hops_tpu_torch.jobs.placement.registry import Host, HostRegistry

__all__ = [
    "GENERATION_HEADER",
    "Host",
    "HostRegistry",
    "Hostd",
    "Lease",
    "PlacedUnit",
    "PlacementClient",
    "PlacementError",
    "audit_slot_invariant",
]
