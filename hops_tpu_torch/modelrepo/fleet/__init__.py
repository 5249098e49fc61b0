"""Horizontal serving fleet: N replicas behind one routed endpoint.

The counterpart of ``hops_tpu/modelrepo/fleet/__init__.py``, copied with the port's imports.

PAPER.md's L4 layer (Hopsworks model serving on Docker/K8s) is a fleet
of serving containers behind a platform endpoint. This package is that
layer natively: a least-loaded front router
(:mod:`~hops_tpu_torch.modelrepo.fleet.router`), a replica manager spawning
``serving_host --fleet-worker`` processes
(:mod:`~hops_tpu_torch.modelrepo.fleet.replicas`), telemetry-driven
autoscaling (:mod:`~hops_tpu_torch.modelrepo.fleet.autoscale`) and
zero-downtime versioned rollouts
(:mod:`~hops_tpu_torch.modelrepo.fleet.rollout`). One call stands it up::

    from hops_tpu_torch.modelrepo import fleet, serving

    serving.create_or_update("mnist", model_name="mnist")
    f = fleet.start_fleet(
        "mnist", replicas=3,
        autoscale=fleet.AutoscalePolicy(min_replicas=2, max_replicas=6),
        rate_limits={"default": {"rate_rps": 200, "burst": 50}},
    )
    f.predict([[...]])            # POST {endpoint}/predict
    f.roll_out(version=2)         # warm → canary → shift → drain
    f.stop()

See docs/operations.md "Serving fleet" for the routing policy, the
autoscaler knobs, the rollout/rollback runbook and every
``hops_tpu_fleet_*`` metric.
"""

from __future__ import annotations

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from hops_tpu_torch.modelrepo.fleet.autoscale import Autoscaler, AutoscalePolicy
from hops_tpu_torch.modelrepo.fleet.replicas import (
    FleetSpawnError,
    Replica,
    ReplicaManager,
)
from hops_tpu_torch.modelrepo.fleet.rollout import RolloutError, roll_out
from hops_tpu_torch.modelrepo.fleet.router import (
    EjectionPolicy,
    HedgePolicy,
    Router,
    TenantRateLimiter,
    TokenBucket,
)

__all__ = [
    "Autoscaler",
    "AutoscalePolicy",
    "EjectionPolicy",
    "FleetSpawnError",
    "HedgePolicy",
    "Replica",
    "ReplicaManager",
    "RolloutError",
    "Router",
    "ServingFleet",
    "TenantRateLimiter",
    "TokenBucket",
    "roll_out",
    "start_fleet",
]


#: Soak-proven default SLO the default brownout controller defends —
#: deliberately loose (an interactive p99 of 1s) so it only fires on a
#: genuinely burning fleet, never on CI jitter. Pass an explicit
#: ``brownout=qos.BrownoutPolicy(...)`` to tighten it.
DEFAULT_BROWNOUT_SLO_P99_MS = 1000.0


class ServingFleet:
    """Manager + router + (optional) autoscaler as one handle.

    Gray-failure tolerance is ON by default: unless the caller says
    otherwise, the router runs adaptive hedging (:class:`HedgePolicy`),
    outlier ejection (:class:`EjectionPolicy`), and brownout degradation
    (``qos.BrownoutPolicy`` at :data:`DEFAULT_BROWNOUT_SLO_P99_MS`) —
    the PR 14 soak configuration. An explicit ``hedge=None`` /
    ``ejection=None`` / ``brownout=None`` opts that mechanism out (the
    router maps ``None`` to its disabled policy)."""

    def __init__(
        self,
        name: str,
        replicas: int = 2,
        *,
        inprocess: bool = False,
        autoscale: AutoscalePolicy | None = None,
        autoscale_interval_s: float = 1.0,
        rate_limits: dict[str, dict[str, float]] | None = None,
        spawn_timeout_s: float = 60.0,
        placement: Any = None,
        **router_kwargs: Any,
    ):
        from hops_tpu_torch.runtime import qos

        # setdefault, not a default argument: an EXPLICIT None must
        # survive to the Router (which maps it to the disabled policy)
        # while an omitted kwarg gets the soak default.
        router_kwargs.setdefault("hedge", HedgePolicy())
        router_kwargs.setdefault("ejection", EjectionPolicy())
        router_kwargs.setdefault(
            "brownout",
            qos.BrownoutPolicy(slo_p99_ms=DEFAULT_BROWNOUT_SLO_P99_MS))
        self.manager = ReplicaManager(
            name, inprocess=inprocess, spawn_timeout_s=spawn_timeout_s,
            placement=placement)
        self.router = None
        self.autoscaler = None
        try:
            if not inprocess:
                # Process workers, local or placed, come up side by side:
                # each start is mostly its own interpreter importing
                # torch and loading weights. (Placement counts a spawn in
                # flight to a host as a unit on it; in-process replicas
                # share this interpreter, so they have nothing to overlap.)
                with ThreadPoolExecutor(replicas) as pool:
                    spawns = [pool.submit(self.manager.spawn) for _ in range(replicas)]
                for spawn in spawns:
                    spawn.result()
            else:
                for _ in range(replicas):
                    self.manager.spawn()
            self.router = Router(
                self.manager, rate_limits=rate_limits, **router_kwargs)
            if autoscale is not None:
                self.autoscaler = Autoscaler(
                    self.manager, self.router, autoscale,
                ).start(autoscale_interval_s)
        except BaseException:
            # A failed startup must not leak already-spawned workers:
            # the caller never gets a handle to stop() them.
            if self.router is not None:
                self.router.stop()
            self.manager.stop()
            raise

    @property
    def endpoint(self) -> str:
        return self.router.endpoint

    def predict(self, instances: list[Any], *, tenant: str | None = None,
                priority: str | None = None,
                timeout_s: float = 30.0) -> dict[str, Any]:
        """POST ``/predict`` through the router (convenience client)."""
        headers = {"Content-Type": "application/json"}
        if tenant is not None:
            headers["X-Tenant"] = tenant
        if priority is not None:
            headers["X-Priority"] = priority
        req = urllib.request.Request(
            f"{self.endpoint}/predict",
            data=json.dumps({"instances": instances}).encode(),
            headers=headers,
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())

    def roll_out(self, version: int | None, **kwargs: Any) -> dict[str, Any]:
        return roll_out(self.manager, self.router, version, **kwargs)

    def describe(self) -> dict[str, Any]:
        return self.router.describe()

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.router.stop()
        self.manager.stop()

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def start_fleet(name: str, replicas: int = 2, **kwargs: Any) -> ServingFleet:
    """Stand up a fleet for an existing ``serving.create_or_update``
    endpoint definition: spawn ``replicas`` workers, start the router
    (and the autoscaler when a policy is given)."""
    return ServingFleet(name, replicas, **kwargs)
