"""PlacementClient — place and manage units across the host fleet.

The counterpart of ``hops_tpu/jobs/placement/client.py``, copied with the port's imports.

The single-host ``ReplicaManager`` owned its workers with ``Popen``;
this client is the drop-in control plane that replaces that: every verb
is an HTTP RPC to the target host's :mod:`~hops_tpu_torch.jobs.placement.
hostd` agent over the shared keep-alive
:class:`~hops_tpu_torch.runtime.httpclient.HTTPPool`, and every RPC is

- **bounded**: ``with_deadline`` around the whole exchange (spawn gets
  its own, larger budget — a replica unit pays torch startup);
- **breaker-guarded per host**: a partitioned or dead host fails fast
  and stops being a placement candidate until its breaker half-opens;
- **injectable**: the ``placement.rpc`` fault point fires before each
  RPC, keyed by host name — chaos tests partition a single host
  deterministically.

Placement policy: least-placed healthy host first (ties broken by
name), with retry-on-next-host when a candidate fails — a host dying
mid-scale-up costs one breaker strike, not a failed spawn. That is
what "the autoscaler re-places on survivors" means mechanically: the
autoscaler just calls ``manager.spawn()``; this client routes it away
from the dead host.

This client also MINTS placement identity: every spawn fills a
``slot`` (caller-named or auto) at a fresh ``generation`` — a
monotonic per-slot counter this client owns. The cfg handed to the
unit carries both, forwarders stamp ``X-Hops-Generation:
<slot>:<current generation>`` on data-plane requests, and a unit whose
own token differs refuses with a typed 410. ``bump_generation`` is the
fencing verb: called BEFORE re-placing a lost unit, it supersedes the
old one so a zombie healing from a partition is rejected at the data
plane — "at most one live unit per slot", enforced, and audited post
hoc by :mod:`~hops_tpu_torch.jobs.placement.invariants` from the
``generation``/``fence`` flight events recorded here.

Metrics (docs/operations.md "Multi-host placement"):
``hops_tpu_placement_rpc_total{host,verb,outcome}``,
``hops_tpu_placement_rpc_seconds{verb}``,
``hops_tpu_placement_hosts{state}``,
``hops_tpu_placement_units{host,kind}``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any

from hops_tpu_torch.jobs.placement.registry import Host, HostRegistry
from hops_tpu_torch.runtime import faultinject, flight
from hops_tpu_torch.runtime.httpclient import HTTPPool
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.runtime.resilience import CircuitBreaker, with_deadline
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_m_rpc = REGISTRY.counter(
    "hops_tpu_placement_rpc_total",
    "Placement control-plane RPCs by host, verb and outcome "
    "(ok | error | rejected)",
    labels=("host", "verb", "outcome"),
)
_m_rpc_seconds = REGISTRY.histogram(
    "hops_tpu_placement_rpc_seconds",
    "Placement control-plane RPC latency per verb",
    labels=("verb",),
)
_m_hosts = REGISTRY.gauge(
    "hops_tpu_placement_hosts",
    "Registry hosts by health as the placement client sees them "
    "(healthy = breaker admits traffic, ejected = breaker open)",
    labels=("state",),
)
_m_units = REGISTRY.gauge(
    "hops_tpu_placement_units",
    "Units this placement client has placed, per host and kind",
    labels=("host", "kind"),
)


class PlacementError(RuntimeError):
    """A placement verb failed (host unreachable, agent error, or no
    healthy host left to place on)."""


#: The wire header carrying the placement identity a forward was
#: routed under (see module docs): ``X-Hops-Generation: <slot>:<gen>``.
GENERATION_HEADER = "X-Hops-Generation"


@dataclasses.dataclass
class PlacedUnit:
    """Handle to one unit placed on some host: the manager's record of
    where its worker lives, and the argument to every lifecycle verb.
    ``slot``/``generation`` are the identity MINTED for this unit; the
    slot's *current* generation lives in the client
    (:meth:`PlacementClient.current_generation`) and moves past this
    snapshot when the unit is superseded."""

    host: Host
    uid: str
    kind: str
    port: int
    pid: int | None = None
    slot: str | None = None
    generation: int = 0

    @property
    def address(self) -> str:
        return self.host.address


class PlacementClient:
    """Control-plane client over a :class:`HostRegistry` (see module
    docs). Thread-safe: the router's manager, the autoscaler and a
    rollout all drive one client."""

    def __init__(
        self,
        registry: HostRegistry,
        *,
        rpc_timeout_s: float = 5.0,
        spawn_timeout_s: float = 90.0,
        breaker_failures: int = 3,
        breaker_reset_s: float = 5.0,
        pool: HTTPPool | None = None,
    ):
        self.registry = registry
        self.rpc_timeout_s = rpc_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self._breaker_failures = breaker_failures
        self._breaker_reset_s = breaker_reset_s
        self._pool = pool if pool is not None else HTTPPool(identity="placement")
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}  # guarded by: self._lock
        self._placed: dict[str, int] = {}  # per-host unit count, guarded by: self._lock
        self._placing: dict[str, int] = {}  # per-host spawns in flight, guarded by: self._lock
        self._generations: dict[str, int] = {}  # slot → current gen, guarded by: self._lock
        self._slot_seq = 0  # auto-slot counter, guarded by: self._lock

    # -- host view ------------------------------------------------------------

    def _breaker(self, host: Host) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(host.name)
            if br is None:
                br = self._breakers[host.name] = CircuitBreaker(
                    name=f"placement-{host.name}",
                    failure_threshold=self._breaker_failures,
                    reset_timeout_s=self._breaker_reset_s,
                )
            return br

    def hosts(self) -> list[Host]:
        return self.registry.hosts()

    def healthy_hosts(self) -> list[Host]:
        """Hosts whose breaker currently admits traffic (this CONSUMES
        a half-open probe slot for an open breaker — exactly one caller
        gets to try the maybe-healed host)."""
        healthy = [h for h in self.hosts() if self._breaker(h).allow()]
        self._publish_host_gauges()
        return healthy

    def _publish_host_gauges(self) -> None:
        hosts = self.hosts()
        ejected = sum(
            1 for h in hosts if self._breaker(h).state == "open")
        _m_hosts.set(len(hosts) - ejected, state="healthy")
        _m_hosts.set(ejected, state="ejected")

    def probe(self, host: Host) -> bool:
        """One bounded ``/healthz`` probe; feeds the host's breaker."""
        try:
            self._rpc(host, "health", "GET", "/healthz")
            return True
        except PlacementError:
            return False

    def units(self, host: Host) -> list[dict[str, Any]]:
        return self._rpc(host, "units", "GET", "/units").get("units", [])

    # -- the RPC --------------------------------------------------------------

    def _rpc(
        self,
        host: Host,
        verb: str,
        method: str,
        path: str,
        body: dict[str, Any] | None = None,
        *,
        timeout_s: float | None = None,
    ) -> dict[str, Any]:
        budget = timeout_s if timeout_s is not None else self.rpc_timeout_s
        breaker = self._breaker(host)
        if not breaker.allow():
            _m_rpc.inc(host=host.name, verb=verb, outcome="rejected")
            raise PlacementError(
                f"host {host.name} ejected (breaker open, retry in "
                f"{breaker.retry_after_s():.1f}s)")
        data = json.dumps(body or {}).encode() if method == "POST" else None
        try:
            # Chaos point: a partition to ONE host is a keyed
            # error/latency spec here — the breaker and the
            # retry-on-next-host policy are what absorb it.
            faultinject.fire("placement.rpc", key=host.name)
            t0 = time.perf_counter()

            def _exchange():
                return self._pool.request(
                    method, f"{host.endpoint}{path}", data,
                    {"Content-Type": "application/json"} if data else None,
                    timeout_s=budget)

            status, payload, _ = with_deadline(
                _exchange, budget * 1.25, op=f"placement.{verb}")
            _m_rpc_seconds.observe(time.perf_counter() - t0, verb=verb)
        except (OSError, TimeoutError) as e:
            breaker.record_failure()
            _m_rpc.inc(host=host.name, verb=verb, outcome="error")
            self._publish_host_gauges()
            raise PlacementError(
                f"placement {verb} to {host.name} ({host.key}) failed: "
                f"{type(e).__name__}: {e}") from e
        try:
            parsed = json.loads(payload) if payload else {}
        except ValueError:
            parsed = {"error": payload[:200].decode(errors="replace")}
        if status >= 500:
            breaker.record_failure()
            _m_rpc.inc(host=host.name, verb=verb, outcome="error")
            self._publish_host_gauges()
            raise PlacementError(
                f"placement {verb} on {host.name} failed: "
                f"{parsed.get('error', status)}")
        breaker.record_success()
        _m_rpc.inc(host=host.name, verb=verb, outcome="ok")
        if status >= 400:
            raise PlacementError(
                f"placement {verb} on {host.name} rejected ({status}): "
                f"{parsed.get('error')}")
        return parsed

    # -- placement verbs ------------------------------------------------------

    def _order(self, hosts: list[Host], prefer: str | None) -> list[Host]:
        """``hosts``, least placed first (units placed, and spawns in
        flight to them), ``prefer`` ahead of all. Call under the lock."""
        hosts = sorted(hosts, key=lambda h: (
            self._placed.get(h.name, 0) + self._placing.get(h.name, 0), h.name))
        if prefer is not None:
            hosts.sort(key=lambda h: h.name != prefer)
        return hosts

    def spawn(self, kind: str, cfg: dict[str, Any], *,
              prefer: str | None = None,
              slot: str | None = None) -> PlacedUnit:
        """Place one unit on the least-placed healthy host, retrying the
        next candidate when a host fails — the caller sees one spawn,
        however many hosts died under it. The unit fills ``slot``
        (auto-minted when None; pass the old slot to RE-place) at a
        freshly minted generation, both injected into its cfg."""
        with self._lock:
            if slot is None:
                self._slot_seq += 1
                slot = f"{kind}-{self._slot_seq}"
            gen = self._generations.get(slot, 0) + 1
            self._generations[slot] = gen
        cfg = dict(cfg)
        cfg["slot"], cfg["generation"] = slot, gen
        errors: list[str] = []
        healthy = self.healthy_hosts()
        tried: set[str] = set()
        while True:
            # Pick and reserve in one step: spawns side by side each see
            # the hosts the others are placing on as taken.
            with self._lock:
                host = next((h for h in self._order(healthy, prefer)
                             if h.name not in tried), None)
                if host is None:
                    break
                self._placing[host.name] = self._placing.get(host.name, 0) + 1
            tried.add(host.name)
            rec = None
            try:
                rec = self._rpc(
                    host, "spawn", "POST", "/units/spawn",
                    {"kind": kind, "cfg": cfg},
                    timeout_s=self.spawn_timeout_s)
            except PlacementError as e:
                errors.append(str(e))
                log.warning("placement: spawn of %s failed on %s, trying "
                            "next host: %s", kind, host.name, e)
            finally:
                with self._lock:
                    self._placing[host.name] -= 1
                    if rec is not None:
                        self._placed[host.name] = self._placed.get(host.name, 0) + 1
            if rec is None:
                continue
            unit = PlacedUnit(host=host, uid=rec["uid"], kind=kind,
                              port=int(rec["port"]), pid=rec.get("pid"),
                              slot=slot, generation=gen)
            flight.record("generation", action="mint", slot=slot,
                          generation=gen, unit_kind=kind, host=host.name,
                          uid=unit.uid)
            _m_units.set(self._placed_count(host.name, kind),
                         host=host.name, kind=kind)
            return unit
        raise PlacementError(
            "no healthy host could place a "
            f"{kind} unit: {'; '.join(errors) or 'registry is empty'}")

    # -- generations (fencing tokens) -----------------------------------------

    def bump_generation(self, slot: str) -> int:
        """Supersede ``slot``'s current occupant BEFORE re-placing it:
        any unit still holding an older generation — a zombie healing
        from a partition — is now refused at the data plane (typed 410
        against the stamped header) and reaped by ``reconcile()``."""
        with self._lock:
            gen = self._generations.get(slot, 0) + 1
            self._generations[slot] = gen
        flight.record("generation", action="bump", slot=slot, generation=gen)
        log.warning("placement: slot %s bumped to generation %d "
                    "(previous occupant superseded)", slot, gen)
        return gen

    def current_generation(self, slot: str) -> int:
        with self._lock:
            return self._generations.get(slot, 0)

    def generation_header(self, unit: PlacedUnit) -> dict[str, str]:
        """Headers stamping ``unit``'s slot at its CURRENT generation
        (empty when the unit carries no identity). Deliberately the
        live counter, not the unit's snapshot: a stale routing view
        aiming at a superseded unit must present the newer token so
        the zombie rejects it."""
        if unit is None or unit.slot is None:
            return {}
        return {GENERATION_HEADER:
                f"{unit.slot}:{self.current_generation(unit.slot)}"}

    def _placed_count(self, host_name: str, kind: str) -> int:
        # The gauge tracks per-(host, kind); the balance counter is
        # per-host only — re-derive the labelled value from the agent
        # would cost an RPC, so approximate with the host total.
        with self._lock:
            return self._placed.get(host_name, 0)

    def _unit_verb(self, unit: PlacedUnit, verb: str) -> dict[str, Any]:
        out = self._rpc(unit.host, verb, "POST",
                        f"/units/{unit.uid}/{verb}")
        if verb in ("reap", "kill"):
            with self._lock:
                n = self._placed.get(unit.host.name, 0)
                self._placed[unit.host.name] = max(0, n - 1)
            _m_units.set(self._placed_count(unit.host.name, unit.kind),
                         host=unit.host.name, kind=unit.kind)
        return out

    def drain(self, unit: PlacedUnit) -> dict[str, Any]:
        return self._unit_verb(unit, "drain")

    def reap(self, unit: PlacedUnit) -> dict[str, Any]:
        return self._unit_verb(unit, "reap")

    def kill(self, unit: PlacedUnit) -> dict[str, Any]:
        """Chaos verb: SIGKILL the unit's worker, no drain."""
        return self._unit_verb(unit, "kill")

    def close(self) -> None:
        self._pool.close()
