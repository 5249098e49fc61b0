"""Zero-downtime versioned rollouts: warm, canary-gate, shift, drain.

The counterpart of ``hops_tpu/modelrepo/fleet/rollout.py``, copied with the port's imports.

The platform move the reference does with K8s rolling updates, done
natively over the replica manager + router:

1. **Warm** one new-version replica and gate on its ``/healthz`` —
   model load and jit warmup happen OFF the serving path.
2. **Canary**: the warmed replica joins the routable set (least-loaded
   selection naturally sends it traffic — it is the idlest replica in
   the fleet) and is judged over up to ``canary_requests`` forwards
   inside ``canary_window_s``. The router's per-replica circuit breaker
   is the judge: if the new version's error rate trips it open, the
   canary is reaped and the fleet ROLLS BACK to the prior version —
   clients only ever saw retried requests, never a failed one (replica
   5xx retries on an old replica). The gate judges whatever traffic
   arrives: an idle fleet's window passes vacuously (rollouts must not
   require synthetic traffic) — logged, with ``canary_forwards`` in
   the summary.
3. **Shift + drain**: one old replica at a time — spawn its new-version
   replacement, wait ready, then drain the old one (503-draining
   contract; in-flight work finishes) and reap it at in-flight zero.
   The ready count never dips below the starting count, so there is no
   request window with zero (or even reduced) capacity.

Outcomes land on ``hops_tpu_fleet_rollouts_total{outcome}`` and the
returned summary; a rollback raises nothing — it IS the designed
recovery path.
"""

from __future__ import annotations

import time
from typing import Any

from hops_tpu_torch.modelrepo.fleet.replicas import FleetSpawnError
from hops_tpu_torch.runtime import flight
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_m_rollouts = REGISTRY.counter(
    "hops_tpu_fleet_rollouts_total",
    "Version rollouts per fleet endpoint and outcome "
    "(completed | rolled_back | spawn_failed)",
    labels=("model", "outcome"),
)


class RolloutError(RuntimeError):
    """A rollout failed for a reason rollback cannot fix (e.g. the new
    version cannot spawn at all)."""


def roll_out(
    manager: Any,
    router: Any,
    version: int | None,
    *,
    canary_requests: int = 8,
    canary_window_s: float = 15.0,
    drain_timeout_s: float = 30.0,
    poll_interval_s: float = 0.02,
) -> dict[str, Any]:
    """Roll the fleet behind ``router`` onto ``version``.

    Returns a summary dict: ``outcome`` (``completed`` |
    ``rolled_back``), ``version``, ``replaced`` (old rids reaped),
    ``canary`` (its rid), ``duration_s``. Raises :class:`RolloutError`
    only when the new version cannot even spawn its canary.
    """
    t0 = time.monotonic()
    olds = [r.rid for r in manager.ready()]
    name = manager.name
    if not olds:
        raise RolloutError(f"fleet {name!r} has no ready replicas to roll")
    log.info("fleet %s: rolling %d replica(s) to version %s",
             name, len(olds), version)

    # 1. Warm the canary (readiness-gated inside spawn()).
    try:
        canary = manager.spawn(version)
    except FleetSpawnError as e:
        _m_rollouts.inc(model=name, outcome="spawn_failed")
        flight.record("rollout", model=name, outcome="spawn_failed")
        raise RolloutError(
            f"fleet {name!r}: version {version} failed to warm a canary: {e}"
        ) from e

    # 2. Canary gate: survive traffic, judged by its breaker. The gate
    # judges whatever traffic ARRIVES in the window — an idle fleet's
    # canary passes vacuously (by design: rollouts must not require
    # synthetic traffic), but that is logged and surfaced as
    # canary_forwards in the summary so operators can see how much
    # validation the new version actually got.
    forwarded0 = _forwards(name, canary.rid)
    deadline = time.monotonic() + canary_window_s
    tripped = False
    while time.monotonic() < deadline:
        if router.breaker_state(canary.rid) == "open":
            tripped = True
            break
        if _forwards(name, canary.rid) - forwarded0 >= canary_requests:
            break
        time.sleep(poll_interval_s)
    # The breaker may trip on the very last judged request.
    tripped = tripped or router.breaker_state(canary.rid) == "open"
    canary_forwards = int(_forwards(name, canary.rid) - forwarded0)
    if not tripped and canary_forwards < canary_requests:
        log.warning(
            "fleet %s: canary %s saw only %d/%d requests in its %.1fs "
            "window — version %s rolls out with that much validation",
            name, canary.rid, canary_forwards, canary_requests,
            canary_window_s, version)
    if tripped:
        log.warning("fleet %s: canary %s (version %s) tripped its breaker — "
                    "rolling back", name, canary.rid, version)
        _drain_and_reap(manager, canary.rid, drain_timeout_s, poll_interval_s)
        _m_rollouts.inc(model=name, outcome="rolled_back")
        flight.record("rollout", model=name, outcome="rolled_back")
        return {
            "outcome": "rolled_back",
            "version": version,
            "canary": canary.rid,
            "replaced": [],
            "duration_s": round(time.monotonic() - t0, 3),
        }

    # 3. Shift: replace old replicas one at a time, capacity-neutral.
    # The judged version is committed into the serving definition
    # FIRST: a concurrent autoscaler spawn (heal or scale-up) from
    # here on resolves the NEW artifact instead of quietly
    # resurrecting the old one — the straggler sweep below catches the
    # spawns that raced the commit. The canary already added one new
    # replica, so the FIRST old drains without a fresh spawn; every
    # further old gets its replacement warmed before the drain starts.
    manager.commit_version(version)
    target = canary.version
    replaced: list[str] = []
    new_rids = [canary.rid]
    for i, old in enumerate(olds):
        if i > 0:
            try:
                new_rids.append(manager.spawn(version).rid)
            except FleetSpawnError as e:
                # Capacity-safe abort: olds not yet drained keep
                # serving the OLD version; the already-landed new
                # replicas serve the new one. Operators see a mixed
                # fleet on /fleet and a rolled_back outcome — but the
                # committed definition is the judged NEW version, so
                # autoscaler heals converge the fleet forward.
                log.warning("fleet %s: replacement spawn failed mid-rollout "
                            "(%s); aborting with %d/%d replaced",
                            name, e, len(replaced), len(olds))
                _m_rollouts.inc(model=name, outcome="rolled_back")
                flight.record("rollout", model=name, outcome="rolled_back")
                return {
                    "outcome": "rolled_back",
                    "version": version,
                    "canary": canary.rid,
                    "replaced": replaced,
                    "duration_s": round(time.monotonic() - t0, 3),
                }
        _drain_and_reap(manager, old, drain_timeout_s, poll_interval_s)
        replaced.append(old)
    # Straggler sweep: an autoscaler spawn that read the definition
    # BEFORE the commit hosts the old version and is not in the
    # starting snapshot — without this it survives a "completed"
    # rollout and the fleet serves mixed versions indefinitely.
    # Stragglers drain WITHOUT a replacement (they were capacity the
    # autoscaler added; it re-heals with the new version if the fleet
    # is genuinely below floor). Version-None rollouts change nothing,
    # so there is nothing to sweep.
    if version is not None:
        sweep_deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < sweep_deadline:
            stragglers = [r.rid for r in manager.ready()
                          if r.version != target]
            for rid in stragglers:
                log.warning(
                    "fleet %s: draining old-version straggler %s "
                    "(spawned mid-rollout)", name, rid)
                _drain_and_reap(manager, rid, drain_timeout_s,
                                poll_interval_s)
                replaced.append(rid)
            # A spawn still warming may host either version (its
            # config read may predate the commit): wait for it to
            # settle rather than declare the fleet homogeneous.
            pending = [r for r in manager.replicas()
                       if r.state == "starting"
                       and (r.version is None or r.version != target)]
            if not stragglers and not pending:
                break
            if not stragglers:
                time.sleep(poll_interval_s)
    _m_rollouts.inc(model=name, outcome="completed")
    flight.record("rollout", model=name, outcome="completed")
    log.info("fleet %s: rollout to version %s complete (%d replaced, %.2fs)",
             name, version, len(replaced), time.monotonic() - t0)
    return {
        "outcome": "completed",
        "version": version,
        "canary": canary.rid,
        "canary_forwards": canary_forwards,
        "replaced": replaced,
        "new_replicas": new_rids,
        "duration_s": round(time.monotonic() - t0, 3),
    }


def _drain_and_reap(manager: Any, rid: str, timeout_s: float,
                    poll_s: float) -> None:
    """Stop admissions on ``rid``, wait for in-flight zero, reap. A
    drain that outlives ``timeout_s`` is force-reaped (logged) — a
    wedged request must not wedge the rollout."""
    manager.drain(rid)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if manager.drained(rid):
            manager.reap(rid)
            return
        time.sleep(poll_s)
    log.warning("fleet %s: replica %s still has in-flight work after "
                "%.1fs drain; force-reaping", manager.name, rid, timeout_s)
    manager.reap(rid)


def _forwards(model: str, rid: str) -> float:
    """Router-side forwards to ``rid`` (``value()`` auto-creates the
    label child, so an untouched replica reads 0)."""
    from hops_tpu_torch.modelrepo.fleet.router import _m_forwards

    return _m_forwards.value(model=model, replica=rid)
