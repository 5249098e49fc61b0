"""Telemetry-driven replica autoscaling with hysteresis and cooldowns.

The counterpart of ``hops_tpu/modelrepo/fleet/autoscale.py``, copied with the port's imports.

The scaling signal is the router's view of the fleet (it already
scrapes every replica): ``Router.fleet_load()`` — mean routing score
(in-flight + queue depth + shed rate) per ready replica — plus an
optional p99-latency trigger from the router's rolling window. Policy:

- scale UP when load stays above ``target_load * high_factor`` (or p99
  above ``p99_target_ms``) for ``breaches_to_scale`` consecutive ticks
  and the up-cooldown has elapsed — hysteresis on both axes, so one
  bursty tick doesn't flap the fleet;
- scale DOWN when load stays below ``target_load * low_factor`` just as
  persistently: the least-loaded replica is DRAINED (it finishes its
  in-flight work behind the 503-draining contract), and a later tick
  reaps it once its in-flight count hits zero — capacity never
  disappears under a request;
- ``min_replicas``/``max_replicas`` clamp everything, and a fleet that
  has fallen BELOW ``min_replicas`` (chaos kill, failed spawn) is
  healed back up regardless of load.

Every decision lands on ``hops_tpu_fleet_target_replicas`` (gauge) and
``hops_tpu_fleet_scale_events_total{direction}`` — the dashboard trace
of why the fleet is the size it is. ``tick()`` is synchronous and
deterministic under an injected clock; ``start()`` wraps it in a
daemon-thread loop for production use.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_m_target = REGISTRY.gauge(
    "hops_tpu_fleet_target_replicas",
    "Autoscaler's current target replica count per fleet endpoint",
    labels=("model",),
)
_m_scale_events = REGISTRY.counter(
    "hops_tpu_fleet_scale_events_total",
    "Autoscaler decisions per fleet endpoint and direction (up | down)",
    labels=("model", "direction"),
)


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs (docs/operations.md "Serving fleet")."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: Healthy per-replica routing score (inflight + queue + shed rate).
    target_load: float = 4.0
    #: Load above target*high_factor is a scale-up breach; below
    #: target*low_factor a scale-down breach — the hysteresis band.
    high_factor: float = 1.25
    low_factor: float = 0.5
    #: Consecutive breaching ticks before acting (flap damping).
    breaches_to_scale: int = 2
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 15.0
    #: Optional latency trigger: scale up when the router's p99 exceeds
    #: this (None = load-only). The signal is SLO-driven: the router's
    #: windowed estimate from the ``hops_tpu_fleet_latency_seconds``
    #: histogram (``Router.histogram_p99_ms``), falling back to the
    #: rolling-window ``recent_p99_ms`` until enough bucket data lands.
    p99_target_ms: float | None = None
    #: An active brownout (the router's SLO-burn controller at level
    #: >= 1) counts as an up-breach: sustained burn means the fleet is
    #: under-provisioned, and capacity is the durable fix brownout is
    #: buying time for.
    scale_on_brownout: bool = True

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.low_factor >= self.high_factor:
            raise ValueError("low_factor must be < high_factor (hysteresis)")


class Autoscaler:
    """Drives a :class:`ReplicaManager` from a :class:`Router`'s
    telemetry under an :class:`AutoscalePolicy`."""

    def __init__(
        self,
        manager: Any,
        router: Any,
        policy: AutoscalePolicy | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        load_fn: Callable[[], float | None] | None = None,
    ):
        self.manager = manager
        self.router = router
        self.policy = policy or AutoscalePolicy()
        self._clock = clock
        self._load_fn = load_fn or router.fleet_load
        self._up_breaches = 0
        self._down_breaches = 0
        self._last_up = -float("inf")
        self._last_down = -float("inf")
        self.target = max(self.policy.min_replicas, len(manager.ready()) or 0)
        self._m_target = _m_target.labels(model=manager.name)
        self._m_target.set(self.target)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- the decision loop ----------------------------------------------------

    def tick(self) -> str | None:
        """One evaluation: reconcile placed liveness, reap finished
        drains, heal below-minimum, then judge load. Returns the action
        taken (``"up"`` | ``"down"`` | ``"reap"`` | ``"heal"`` | None)
        — tests drive this directly."""
        # Placed fleets first sweep for replicas whose HOST died (no
        # local SIGCHLD): reconcile marks them failed, which drops the
        # live count below target and turns this very tick into a heal
        # — re-placement lands on the surviving hosts.
        reconcile = getattr(self.manager, "reconcile", None)
        if reconcile is not None:
            reconcile()
        self._reap_drained()
        live = [r for r in self.manager.replicas()
                if r.state in ("ready", "starting")]
        now = self._clock()
        # Healing beats load math: a fleet below its floor serves the
        # next burst badly no matter what the gauges say right now.
        if len(live) < max(self.policy.min_replicas, min(self.target, self.policy.max_replicas)):
            self._spawn_one()
            return "heal"
        load = self._load_fn()
        p99 = self._p99_ms()
        up_breach = False
        if load is not None and load > self.policy.target_load * self.policy.high_factor:
            up_breach = True
        if (self.policy.p99_target_ms is not None and p99 is not None
                and p99 > self.policy.p99_target_ms):
            up_breach = True
        if (self.policy.scale_on_brownout
                and getattr(self.router, "brownout_level", 0) >= 1):
            up_breach = True
        down_breach = (
            load is not None
            and load < self.policy.target_load * self.policy.low_factor
        )
        self._up_breaches = self._up_breaches + 1 if up_breach else 0
        self._down_breaches = self._down_breaches + 1 if down_breach else 0

        ready = len(self.manager.ready())
        if (self._up_breaches >= self.policy.breaches_to_scale
                and ready < self.policy.max_replicas
                and now - self._last_up >= self.policy.up_cooldown_s):
            self.target = min(self.policy.max_replicas, ready + 1)
            self._last_up = now
            self._up_breaches = 0
            self._m_target.set(self.target)
            _m_scale_events.inc(model=self.manager.name, direction="up")
            log.info("fleet %s: scaling UP to %d (load=%.2f p99=%s)",
                     self.manager.name, self.target, load or -1, p99)
            self._spawn_one()
            return "up"
        if (self._down_breaches >= self.policy.breaches_to_scale
                and ready > self.policy.min_replicas
                and now - self._last_down >= self.policy.down_cooldown_s):
            self.target = max(self.policy.min_replicas, ready - 1)
            self._last_down = now
            self._down_breaches = 0
            self._m_target.set(self.target)
            _m_scale_events.inc(model=self.manager.name, direction="down")
            victim = self._least_loaded_ready()
            if victim is not None:
                log.info("fleet %s: scaling DOWN to %d — draining %s "
                         "(load=%.2f)", self.manager.name, self.target,
                         victim.rid, load or -1)
                self.manager.drain(victim.rid)
            return "down"
        return None

    def _p99_ms(self) -> float | None:
        """The latency trigger's signal: the router's histogram-derived
        windowed p99 when available (SLO truth from bucket deltas),
        else its rolling window. Tolerates routers without the
        histogram surface (tests drive stubs)."""
        if self.router is None:
            return None
        hist = getattr(self.router, "histogram_p99_ms", None)
        p99 = hist() if hist is not None else None
        if p99 is None:
            p99 = self.router.recent_p99_ms()
        return p99

    def _reap_drained(self) -> str | None:
        for rep in self.manager.replicas():
            if rep.state == "draining" and self.manager.drained(rep.rid):
                self.manager.reap(rep.rid)
                return "reap"
        return None

    def _spawn_one(self) -> None:
        try:
            self.manager.spawn()
        except Exception as e:  # noqa: BLE001 — next tick retries
            log.warning("fleet %s: autoscale spawn failed (%s: %s); "
                        "next tick retries", self.manager.name,
                        type(e).__name__, e)

    def _least_loaded_ready(self) -> Any | None:
        ready = self.manager.ready()
        if not ready:
            return None
        if self.router is None:
            return ready[-1]
        return min(ready, key=lambda r: self.router._view(r.rid).score())

    # -- the daemon loop ------------------------------------------------------

    def start(self, interval_s: float = 1.0) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(interval_s,), daemon=True,
                name=f"fleet-autoscaler-{self.manager.name}",
            )
            self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("fleet %s: autoscaler tick failed",
                              self.manager.name)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
