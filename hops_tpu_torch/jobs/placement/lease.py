"""The lease: hostd's suicide pact with the registry.

The counterpart of ``hops_tpu/jobs/placement/lease.py``, copied with the port's imports.

A TTL alone cannot make partitions safe — when the registry ages a
host out, the host itself has no idea it is gone and keeps serving:
its replicas answer with a stale model, its feature shards accept
writes, while the autoscaler re-places the "lost" capacity on
survivors. Split-brain, by construction. The classic fix (Gray &
Cheriton's leases, and every fencing design since) is to make the TTL
a **contract held by both sides**:

- the registry promises to keep the host in membership for ``ttl_s``
  after each observed heartbeat (receiver-side monotonic arrival
  aging — see :mod:`~hops_tpu_torch.jobs.placement.registry`);
- the host promises that if it cannot RENEW within that same window,
  it stops serving on its own: hostd drains and kills every unit it
  runs (``Hostd.self_fence``). A host that cannot reach the registry
  must assume the registry has already given it up.

Both sides measure on clocks that only move forward: the lease runs on
``time.monotonic()`` (injectable for tests), so an NTP step — forward
or back — can neither fire a spurious fence nor hold one open. The
registry's side ages by arrival time for the same reason. Sender wall
clocks are display metadata everywhere.

For the fence to be safe the lease TTL must be **at least** the
registry TTL (hostd defaults to ``3 × heartbeat_s``, the registry
default is looser): membership must lapse before or with the fence,
never after, or survivors would route to a host that has already
killed its units. The reverse gap — registry ages the host out while
its lease still has time left — is the zombie window; the generation
tokens minted by the placement client close it at the data plane
(docs/operations.md "Partition tolerance & fencing").

Metrics (docs/operations.md "Partition tolerance & fencing"):
``hops_tpu_placement_lease_renewals_total{host,outcome}`` counts
renewal attempts (``ok`` / ``error``);
``hops_tpu_placement_lease_fenced_total{host}`` counts self-fences.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_m_renewals = REGISTRY.counter(
    "hops_tpu_placement_lease_renewals_total",
    "Lease renewal attempts by the hostd heartbeat, per outcome",
    labels=("host", "outcome"),
)
_m_fenced = REGISTRY.counter(
    "hops_tpu_placement_lease_fenced_total",
    "Self-fences: a hostd killed its own units after its lease expired",
    labels=("host",),
)


class Lease:
    """One host's renewable TTL grant, measured on a monotonic clock.

    Starts renewed (construction IS the first grant — hostd announces
    before the heartbeat thread exists). ``renew()`` on every
    successful announce; ``expired()`` once ``ttl_s`` passes without
    one; ``mark_fenced()`` latches the fence decision exactly once per
    expiry episode so the heartbeat loop fences once, not every tick,
    and un-latches on the renewal that follows a heal."""

    def __init__(self, owner: str, ttl_s: float, *,
                 clock: Callable[[], float] = time.monotonic):
        if ttl_s <= 0:
            raise ValueError(f"lease ttl must be positive, got {ttl_s}")
        self.owner = owner
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._renewed_at = clock()  # guarded by: self._lock
        self._fenced = False  # guarded by: self._lock

    def renew(self) -> None:
        """A successful heartbeat announce: restart the TTL window and
        clear any fence latch (the host has rejoined; its units were
        already killed at fence time, so rejoining is split-brain-safe)."""
        with self._lock:
            was_fenced = self._fenced
            self._renewed_at = self._clock()
            self._fenced = False
        _m_renewals.inc(host=self.owner, outcome="ok")
        if was_fenced:
            log.warning("lease %s: renewed after fence — host rejoins empty",
                        self.owner)

    def renewal_failed(self) -> None:
        """Account one failed announce (the TTL keeps running)."""
        _m_renewals.inc(host=self.owner, outcome="error")

    def remaining_s(self) -> float:
        """Seconds of grant left (negative once expired)."""
        with self._lock:
            return self.ttl_s - (self._clock() - self._renewed_at)

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def mark_fenced(self) -> bool:
        """Latch the fence decision; True exactly once per expiry
        episode (callers fence iff this returns True)."""
        with self._lock:
            if self._fenced:
                return False
            self._fenced = True
        _m_fenced.inc(host=self.owner)
        return True

    @property
    def fenced(self) -> bool:
        with self._lock:
            return self._fenced
