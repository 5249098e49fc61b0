"""Front router: one endpoint over N serving replicas, least-loaded.

The counterpart of ``hops_tpu/modelrepo/fleet/router.py``, copied with the port's imports.

The thin request-routing tier the TF-paper systems framing calls for:
capacity (replica count) and versions (rollouts) change UNDER this
server without clients noticing. Design:

- **Least-loaded selection.** A scraper thread polls every replica's
  ``/metrics.json`` (its own port — the per-process registry) every
  ``scrape_interval_s`` and reads the serving gauges: queue depth
  (``hops_tpu_serving_batch_queue_depth``), in-flight executions
  (``hops_tpu_serving_inflight``) and the shed counter
  (``hops_tpu_serving_shed_total`` — its delta per scrape is the shed
  *rate*). The routing score adds the router's OWN per-replica
  in-flight count (exact and instant, where scrapes are stale by up to
  one interval — without it a burst between scrapes dogpiles the
  replica that looked idle last time). Lowest score wins; ties
  round-robin.
- **Routing around failure.** Each replica gets a
  ``resilience.CircuitBreaker``; a forward that fails at the transport
  (connect refused/reset/timeout) or with a replica-side 5xx records a
  failure and the request RETRIES on the next-best replica (predict is
  idempotent), so a dead or dying replica costs latency, not errors. A
  replica-side 503 (shedding, draining) retries elsewhere WITHOUT
  feeding the breaker — overload is load, not failure. 4xx is the
  client's problem and relays verbatim.
- **Per-tenant token buckets** (the layer above PR 5's per-replica
  load shedder): requests carry ``X-Tenant``; an empty bucket answers
  429 + ``Retry-After`` before any replica is touched.

Every forward passes through the ``router.forward`` fault point and an
explicit timeout (the ``blocking-call-no-deadline`` lint rule holds
this module to that).

**Gray-failure tolerance** (docs/operations.md "Tail latency & QoS").
Crash failures were already routed around (breakers, retries); the
mechanisms below keep the p99 honest when a component is *slow but
alive* — answering 200s at 20x the fleet median, which no breaker ever
sees:

- **Adaptive hedging** (:class:`HedgePolicy`): when a forward is still
  unanswered after an adaptive timer — the median across replicas of
  each replica's recent-latency p95, so one gray replica cannot
  inflate the timer that defends against it — a second attempt fires
  at the next-best replica; first response wins, the loser is
  abandoned WITHOUT a breaker strike (slow is not down). A hard hedge
  budget (``budget_frac``, default ≤5% of traffic, small burst) means
  hedging can never amplify an overload into a retry storm.
- **Outlier ejection** (:class:`EjectionPolicy`): each replica's
  latency EWMA is compared against the median of its peers; a replica
  answering far above the fleet (slow-but-200) is EJECTED into
  *probation* — distinct from breaker-open: the breaker opens on
  failures and heals on half-open successes, probation opens on
  latency and heals only when periodic **shadow probes** (copies of
  live requests, responses discarded) come back at fleet-normal
  latency ``readmit_probes`` times in a row. Ejections are capped
  (``max_ejected_frac``, never the last replica) so the detector can
  never empty the fleet.
- **QoS classes + brownout**: requests resolve to ``interactive`` or
  ``batch`` (``X-Priority`` header / tenant config, header can only
  demote — see :mod:`hops_tpu_torch.runtime.qos`); per-class token buckets
  gate admission, and under sustained SLO burn a
  :class:`~hops_tpu_torch.runtime.qos.BrownoutController` walks the fleet
  through *degrade* (downstream layers serve defaults / shrink decode
  budgets; forwards carry ``X-Hops-Brownout``) into *shed* (batch
  refused at the front door) — lowest class always sheds first.

**Zero-copy relay.** The forward path streams request and response
bodies through as raw bytes: the client's body goes onto the replica
wire unparsed, and the replica's response body returns to the client
byte-for-byte (2xx and 4xx/5xx alike) — no ``json.loads``/``json.dumps``
round-trip per hop (the ``relay-json-roundtrip`` lint rule keeps it
that way). Routing needs only the status code, headers and the
router's own scrape state; the body is parsed lazily in exactly two
places that need the object — the workload recorder's shape summaries
(armed captures only, after the reply is written) and the
``X-Hops-Debug: timeline`` merge (explicit operator ask). Tenant
extraction is header-based (``X-Tenant``). ``_reply`` recomputes only
the framing headers ``_relay_headers`` already owned.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import statistics
import threading
import time
import urllib.error
from typing import Any

from hops_tpu_torch.runtime import faultinject, flight, qos, wirecodec
from hops_tpu_torch.runtime.httpclient import HTTPPool
from hops_tpu_torch.runtime.httpserver import HTTPServer
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.runtime.resilience import CircuitBreaker, with_deadline
from hops_tpu_torch.telemetry import export as telemetry_export
from hops_tpu_torch.telemetry import tracing
from hops_tpu_torch.telemetry import workload
from hops_tpu_torch.telemetry.metrics import REGISTRY
from hops_tpu_torch.telemetry.spans import span

log = get_logger(__name__)

_m_requests = REGISTRY.counter(
    "hops_tpu_fleet_requests_total",
    "Requests received by the fleet router, per endpoint",
    labels=("model",),
)
_m_forwards = REGISTRY.counter(
    "hops_tpu_fleet_forwards_total",
    "Forwards per endpoint and replica (the balance to watch)",
    labels=("model", "replica"),
)
_m_retries = REGISTRY.counter(
    "hops_tpu_fleet_retries_total",
    "Forwards retried on another replica, per endpoint and reason "
    "(connect | error | shed)",
    labels=("model", "reason"),
)
_m_rate_limited = REGISTRY.counter(
    "hops_tpu_fleet_rate_limited_total",
    "Requests answered 429 by the per-tenant token bucket",
    labels=("tenant",),
)
_m_unrouted = REGISTRY.counter(
    "hops_tpu_fleet_unrouted_total",
    "Requests that exhausted every replica (503/5xx to the client)",
    labels=("model",),
)
_m_hedges = REGISTRY.counter(
    "hops_tpu_fleet_hedges_total",
    "Hedged forwards per endpoint and outcome (won = the hedge "
    "answered first, lost = the primary did, denied = the hedge "
    "budget refused to fire one)",
    labels=("model", "outcome"),
)
_m_ejections = REGISTRY.counter(
    "hops_tpu_fleet_ejections_total",
    "Replicas ejected into latency probation (gray-failure outliers), "
    "per endpoint",
    labels=("model",),
)
_m_readmissions = REGISTRY.counter(
    "hops_tpu_fleet_readmissions_total",
    "Probation replicas re-admitted after healthy shadow probes, per "
    "endpoint",
    labels=("model",),
)
_m_probation = REGISTRY.gauge(
    "hops_tpu_fleet_probation_replicas",
    "Replicas currently in latency probation, per endpoint",
    labels=("model",),
)
_m_synthetic_probes = REGISTRY.counter(
    "hops_tpu_fleet_synthetic_probes_total",
    "Shadow probes fired with bodies materialized from the "
    "probe_workload capture artifact (probation re-admission when no "
    "live traffic flows), per endpoint",
    labels=("model",),
)
_m_qos_shed = REGISTRY.counter(
    "hops_tpu_fleet_qos_shed_total",
    "Requests refused by QoS policy, per endpoint, class, and reason "
    "(rate = class token bucket, brownout = batch shed under SLO burn)",
    labels=("model", "priority", "reason"),
)
_m_brownout = REGISTRY.gauge(
    "hops_tpu_fleet_brownout_level",
    "Current brownout level per endpoint (0 normal, 1 degrade, "
    "2 shed-batch)",
    labels=("model",),
)
_m_request_seconds = REGISTRY.histogram(
    "hops_tpu_fleet_latency_seconds",
    "Router end-to-end request latency per endpoint and QoS class "
    "(the SLO histogram the autoscaler's p99 signal reads)",
    labels=("model", "priority"),
)


#: Headers never relayed from a replica response: the body travels
#: through the router as VERBATIM bytes, but ``_reply`` still frames it
#: itself (one Content-Length it computed, one Content-Type it owns), so
#: passing the replica's framing through would send two (possibly
#: conflicting) Content-Lengths and truncate or hang clients. These
#: framing headers are the ONLY thing the relay recomputes.
_NO_RELAY_HEADERS = frozenset({
    "content-length", "content-type", "transfer-encoding", "connection",
    "keep-alive", "server", "date",
})


def _relay_headers(headers: Any) -> dict[str, str]:
    return {k: v for k, v in dict(headers).items()
            if k.lower() not in _NO_RELAY_HEADERS}


def _relayed_with_ctype(headers: Any) -> dict[str, str]:
    """Relay headers for a VERBATIM byte body: the non-framing headers
    plus the replica's own Content-Type — the bytes are the replica's
    serialization, so its declared type must travel with them
    (``_reply`` honors a caller-supplied Content-Type and recomputes
    only Content-Length)."""
    out = _relay_headers(headers)
    # Case-insensitive lookup: HTTP headers may arrive in any casing
    # (proxies/h2 commonly lowercase), and _relay_headers already
    # filtered every variant out.
    ctype = next(
        (v for k, v in dict(headers).items() if k.lower() == "content-type"),
        None,
    )
    if ctype:
        out["Content-Type"] = ctype
    return out


class TokenBucket:
    """Per-tenant rate limit: ``rate_rps`` tokens/s, ``burst`` deep.

    ``acquire()`` returns 0.0 when admitted (one token consumed) or the
    seconds until a token will exist — the 429's ``Retry-After``.
    Injectable clock for deterministic refill tests.
    """

    def __init__(self, rate_rps: float, burst: float,
                 clock=time.monotonic):
        if rate_rps <= 0 or burst <= 0:
            raise ValueError("rate_rps and burst must be > 0")
        self.rate_rps = float(rate_rps)
        self.burst = float(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = float(burst)  # guarded by: self._lock
        self._last = clock()  # guarded by: self._lock

    def acquire(self, n: float = 1.0) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate_rps)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate_rps

    @property
    def tokens(self) -> float:
        with self._lock:
            now = self._clock()
            return min(
                self.burst, self._tokens + (now - self._last) * self.rate_rps)

    @property
    def last_used(self) -> float:
        """Clock time of the last ``acquire`` — the LRU key the
        limiter's bucket-map eviction sorts on."""
        with self._lock:
            return self._last


class TenantRateLimiter:
    """``{tenant: {"rate_rps": r, "burst": b}}`` with an optional
    ``"default"`` entry covering unnamed tenants; no entry = unlimited.

    ``X-Tenant`` is untrusted client input, so the bucket map is
    HARD-bounded at ``max_buckets``: buckets that have refilled to
    full burst are pruned first (a full bucket admits exactly like a
    fresh one, so that eviction never changes an answer), and when a
    spray of unique tenants leaves nothing refilled, the
    least-recently-used bucket is evicted anyway. An evicted mid-limit
    tenant returns later at full burst — under attack, bounded memory
    beats exact answers; real tenants keep acquiring, stay recent, and
    survive the LRU pass.
    """

    def __init__(self, limits: dict[str, dict[str, float]] | None,
                 clock=time.monotonic, max_buckets: int = 4096):
        self._clock = clock
        self._limits = dict(limits or {})
        self.max_buckets = max_buckets
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}  # guarded by: self._lock

    def acquire(self, tenant: str) -> float:
        """0.0 = admitted, else seconds until this tenant has a token."""
        spec = self._limits.get(tenant, self._limits.get("default"))
        if spec is None or not spec.get("rate_rps"):
            # No entry — or a QoS-only entry ({"priority": ...} with no
            # rate): unlimited here, the class buckets still apply.
            return 0.0
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= self.max_buckets:
                    for name in [t for t, b in self._buckets.items()
                                 if b.tokens >= b.burst]:
                        del self._buckets[name]
                while len(self._buckets) >= self.max_buckets:
                    # Unique-tenant spray: nothing has refilled, but
                    # the cap is a hard bound — evict the coldest.
                    lru = min(self._buckets,
                              key=lambda t: self._buckets[t].last_used)
                    del self._buckets[lru]
                bucket = self._buckets[tenant] = TokenBucket(
                    spec["rate_rps"], spec.get("burst", spec["rate_rps"]),
                    clock=self._clock,
                )
        return bucket.acquire()

    def label_for(self, tenant: str) -> str:
        """Metric-safe tenant label: the tenant's own name only when
        it has an explicitly configured limit; everyone admitted under
        the ``"default"`` spec collapses to ``default`` — an untrusted
        ``X-Tenant`` spray must not mint unbounded counter children in
        the registry the router itself exports."""
        return tenant if tenant in self._limits else "default"

    def priority_for(self, tenant: str) -> str | None:
        """The tenant's configured QoS class (``{"priority": "batch"}``
        in its limit spec), or None when unconfigured — the header /
        default resolution in :func:`hops_tpu_torch.runtime.qos.
        parse_priority` takes over."""
        spec = self._limits.get(tenant, self._limits.get("default"))
        return spec.get("priority") if spec else None


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Adaptive request hedging (docs/operations.md "Tail latency &
    QoS"). The budget is the safety property: hedges consume a token
    bucket refilled at ``budget_frac`` tokens per routed request, so
    over any window hedges stay ≤ ``budget_frac`` of traffic (plus the
    small ``budget_burst``) — hedging can never amplify an overload."""

    enabled: bool = True
    #: Hard hedge budget as a fraction of routed requests.
    budget_frac: float = 0.05
    #: Tokens the budget may bank (burst headroom at cold start).
    budget_burst: float = 5.0
    #: Recent latency samples the fleet needs before hedging arms
    #: (an adaptive timer from no data is a guess).
    min_samples: int = 16
    #: Clamp on the adaptive timer (median-across-replicas of p95s).
    delay_floor_s: float = 0.001
    delay_cap_s: float = 1.0

    def __post_init__(self) -> None:
        if not 0.0 < self.budget_frac <= 0.5:
            raise ValueError("budget_frac must be in (0, 0.5]")
        if self.delay_floor_s > self.delay_cap_s:
            raise ValueError("delay_floor_s must be <= delay_cap_s")


@dataclasses.dataclass(frozen=True)
class EjectionPolicy:
    """Gray-failure outlier ejection. A replica whose latency EWMA sits
    above ``factor`` × the median of its peers (and above ``floor_ms``
    absolutely, so microsecond jitter on an idle fleet never ejects) is
    moved to probation; shadow probes re-admit it once it answers at
    ≤ ``readmit_factor`` × the healthy median + ``readmit_slack_ms``
    for ``readmit_probes`` consecutive probes."""

    enabled: bool = True
    factor: float = 3.0
    floor_ms: float = 25.0
    min_samples: int = 20
    #: Never leave fewer than one replica, never eject more than this
    #: fraction of the ready fleet.
    max_ejected_frac: float = 0.5
    probe_interval_s: float = 0.5
    probe_timeout_s: float = 10.0
    readmit_probes: int = 3
    readmit_factor: float = 2.0
    readmit_slack_ms: float = 10.0

    def __post_init__(self) -> None:
        if self.factor <= 1.0:
            raise ValueError("ejection factor must be > 1")
        if not 0.0 < self.max_ejected_frac < 1.0:
            raise ValueError("max_ejected_frac must be in (0, 1)")
        if self.readmit_probes < 1:
            raise ValueError("readmit_probes must be >= 1")


class _LatencyStats:
    """Per-replica forward-latency tracker: EWMA (the ejection signal)
    plus a recent-sample ring (the hedge timer's p95 source)."""

    def __init__(self, window: int = 256, alpha: float = 0.2):
        self._lock = threading.Lock()
        self._ring: collections.deque[float] = collections.deque(maxlen=window)  # guarded by: self._lock
        self._ewma: float | None = None  # guarded by: self._lock
        self._alpha = alpha
        self.count = 0  # guarded by: self._lock

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ring.append(seconds)
            self.count += 1
            self._ewma = (
                seconds if self._ewma is None
                else self._alpha * seconds + (1 - self._alpha) * self._ewma
            )

    @property
    def ewma_ms(self) -> float | None:
        with self._lock:
            return self._ewma * 1e3 if self._ewma is not None else None

    def p95_ms(self) -> float | None:
        with self._lock:
            window = sorted(self._ring)
        if not window:
            return None
        return window[min(len(window) - 1, int(len(window) * 0.95))] * 1e3

    def sample_count(self) -> int:
        with self._lock:
            return self.count

    def reset(self) -> None:
        """Forget history (on readmission: the probation-era samples
        must not immediately re-eject a healed replica)."""
        with self._lock:
            self._ring.clear()
            self._ewma = None
            self.count = 0


class _ReplicaView:
    """The router's read model of one replica: breaker, local inflight,
    last scraped load."""

    def __init__(self, rid: str, breaker_failures: int, breaker_reset_s: float):
        self.rid = rid
        self.breaker = CircuitBreaker(
            name=f"fleet-{rid}",
            failure_threshold=breaker_failures,
            reset_timeout_s=breaker_reset_s,
        )
        # += on an attribute is load/add/store bytecodes, NOT atomic:
        # two handler threads can lose an increment while both
        # decrements land, driving the count negative and permanently
        # skewing least-loaded selection toward this replica.
        self._count_lock = threading.Lock()
        self.inflight = 0  # guarded by: self._count_lock
        self.queue_depth = 0.0
        self.scraped_inflight = 0.0
        self.shed_rate = 0.0
        self._last_shed_total: float | None = None
        self.scrape_ok = True
        # Monotonic time of the last SUCCESSFUL scrape: `GET /fleet`
        # serves its age so a stale scrape (wedged or unreachable
        # replica) is distinguishable from a healthy idle one whose
        # numbers just happen to sit at zero.
        self.last_scrape_mono: float | None = None
        # Scraped hops_tpu_workload_capture_active: `GET /fleet`
        # reports which replica processes are capturing their streams.
        self.capture_active = 0.0
        # Gray-failure state: forward latencies feed the EWMA/p95; a
        # latency outlier moves to PROBATION (unroutable, distinct
        # from breaker-open) until shadow probes heal it.
        self.latency = _LatencyStats()
        self.probation = False
        self.probation_since: float | None = None
        self.probe_oks = 0
        self.last_probe_mono = 0.0

    def inflight_inc(self) -> None:
        with self._count_lock:
            self.inflight += 1

    def inflight_dec(self) -> None:
        with self._count_lock:
            self.inflight -= 1

    def score(self) -> float:
        with self._count_lock:
            inflight = self.inflight
        s = inflight + self.queue_depth + self.scraped_inflight \
            + self.shed_rate
        if not self.scrape_ok:
            s += 1.0  # deprioritize a replica we cannot see into
        return s


class _HedgeRace:
    """First-response-wins coordination between a primary forward and
    its hedge. Attempts ``post()`` their outcome; the first *terminal*
    one (kind ``"ok"``) becomes the winner, later posts learn they were
    abandoned (``post`` returns False) and skip all breaker/retry
    bookkeeping."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._winner: tuple | None = None  # guarded by: self._cv
        self._failures: list[tuple] = []  # guarded by: self._cv
        self._launched = 0  # guarded by: self._cv
        self._finished = 0  # guarded by: self._cv

    def register_launch(self) -> None:
        with self._cv:
            self._launched += 1

    def post(self, outcome: tuple) -> bool:
        """Record an attempt's outcome; True = this post was LIVE (no
        winner existed yet — its bookkeeping counts)."""
        with self._cv:
            self._finished += 1
            live = self._winner is None
            if live and outcome[0] == "ok":
                self._winner = outcome
            elif live and outcome[0] == "fail":
                self._failures.append(outcome)
            self._cv.notify_all()
            return live

    def wait(self, timeout: float | None) -> tuple | None:
        """Block until a winner exists or every launched attempt has
        finished (or ``timeout``); returns the winner if any."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._winner is not None
                or (self._launched > 0 and self._finished >= self._launched),
                timeout=timeout,
            )
            return self._winner

    def settled(self) -> bool:
        with self._cv:
            return self._finished >= self._launched

    def last_failure(self) -> tuple | None:
        with self._cv:
            return self._failures[-1] if self._failures else None


class Router:
    """The fleet's front HTTP server (``POST /predict``).

    ``manager`` needs only ``.name`` and ``.replicas()`` returning
    objects with ``rid`` / ``port`` / ``state`` — the real
    :class:`~hops_tpu_torch.modelrepo.fleet.replicas.ReplicaManager` in
    production, a stub in router unit tests.
    """

    def __init__(
        self,
        manager: Any,
        *,
        rate_limits: dict[str, dict[str, float]] | None = None,
        class_limits: dict[str, dict[str, float]] | None = None,
        scrape_interval_s: float = 0.25,
        forward_timeout_s: float = 30.0,
        max_attempts: int | None = None,
        breaker_failures: int = 3,
        breaker_reset_s: float = 5.0,
        hedge: HedgePolicy | dict[str, Any] | None = None,
        ejection: EjectionPolicy | dict[str, Any] | None = None,
        brownout: qos.BrownoutPolicy | dict[str, Any] | None = None,
        attempt_workers: int = 128,
        probe_workload: Any = None,
        port: int = 0,
        clock=time.monotonic,
    ):
        self.manager = manager
        self.name = manager.name
        #: Capture/synthesis artifact dir (telemetry.workload) whose
        #: recorded requests become SYNTHETIC shadow-probe bodies: a
        #: probation replica on a quiet fleet would otherwise never be
        #: probed again (probes piggyback on live traffic) and sit
        #: ejected forever. None = live-traffic probes only.
        self.probe_workload = probe_workload
        self._probe_bodies: list[bytes] | None = None  # lazy; [] = unusable
        self._probe_body_idx = 0
        self.scrape_interval_s = scrape_interval_s
        self.forward_timeout_s = forward_timeout_s
        self.max_attempts = max_attempts
        self.breaker_failures = breaker_failures
        self.breaker_reset_s = breaker_reset_s
        self.limiter = TenantRateLimiter(rate_limits, clock=clock)
        # Per-QoS-class token buckets: a flooded batch class runs out of
        # tokens while interactive traffic keeps flowing — the first
        # shed-lowest-first layer, ahead of any replica capacity.
        self._class_buckets: dict[str, TokenBucket] = {
            cls: TokenBucket(spec["rate_rps"],
                             spec.get("burst", spec["rate_rps"]), clock=clock)
            for cls, spec in (class_limits or {}).items()
            if spec.get("rate_rps")
        }
        if isinstance(hedge, dict):
            hedge = HedgePolicy(**hedge)
        self.hedge = hedge if hedge is not None else HedgePolicy(enabled=False)
        if isinstance(ejection, dict):
            ejection = EjectionPolicy(**ejection)
        self.ejection = (
            ejection if ejection is not None else EjectionPolicy(enabled=False))
        if isinstance(brownout, dict):
            brownout = qos.BrownoutPolicy(**brownout)
        self._brownout = (
            qos.BrownoutController(brownout) if brownout is not None else None)
        self._m_brownout = _m_brownout.labels(model=self.name)
        self._m_probation = _m_probation.labels(model=self.name)
        # Hedge budget: tokens accrue per routed request, capped —
        # guarded by: self._hedge_lock.
        self._hedge_lock = threading.Lock()
        self._hedge_tokens = self.hedge.budget_burst
        #: Keep-alive connection pool for every router->replica hop
        #: (forwards, hedges, scrapes, shadow probes): a hedge must not
        #: pay a fresh handshake on top of the latency it is rescuing.
        self.pool = HTTPPool(identity="router")
        # Worker pools for raced attempts (a thread per forward would
        # be creation churn at request rate; lazily built because
        # un-hedged routers never race attempts). Hedges get their OWN
        # small pool: under a load spike that saturates the primary
        # pool, the rescue path must not queue behind the very
        # primaries it exists to rescue.
        self.attempt_workers = int(attempt_workers)
        self._attempt_pool = None  # guarded by: self._hedge_lock
        self._hedge_pool = None  # guarded by: self._hedge_lock
        self._scrape_pool = None  # guarded by: self._hedge_lock
        self._views_lock = threading.Lock()
        self._views: dict[str, _ReplicaView] = {}  # guarded by: self._views_lock
        self._rr = 0  # guarded by: self._views_lock
        self._lat_lock = threading.Lock()
        self._latencies: list[float] = []  # guarded by: self._lat_lock
        # Per-QoS-class rolling windows (guarded by: self._lat_lock).
        self._class_latencies: dict[str, list[float]] = {}
        # Periodic bucket-count snapshots of the per-class SLO
        # histogram; histogram_p99_ms() takes deltas against the oldest
        # in-window snapshot.
        self._hist_lock = threading.Lock()
        self._hist_ring: collections.deque = collections.deque(maxlen=64)  # guarded by: self._hist_lock
        self._stop = threading.Event()
        name = self.name
        router = self

        m_requests = _m_requests.labels(model=name)
        m_unrouted = _m_unrouted.labels(model=name)

        def _reply(code: int, body: dict[str, Any] | bytes,
                   headers: dict[str, str] | None = None):
            # Relay path hands bytes straight through (zero-copy:
            # the replica's serialized body is the response);
            # router-authored payloads (errors, /fleet) are dicts.
            # A relayed byte body keeps the REPLICA's declared
            # Content-Type (route() passes it through) — stamping
            # application/json on, say, an HTML error page from the
            # replica's HTTP stack would lie to the client; only
            # Content-Length is always recomputed (by the transport
            # core's assemble()).
            # bytes bodies (incl. packed frames) relay untouched; only
            # the router's OWN dict responses serialize as JSON here.
            data = body if isinstance(body, bytes) \
                else json.dumps(body).encode()  # graftlint: disable=json-on-hot-wire
            hdrs = dict(headers or {})
            ctype = hdrs.pop("Content-Type", "application/json")
            out = {"Content-Type": ctype}
            out.update(hdrs)
            return code, out, data

        def _do_get(path_full: str, headers: Any):
            try:
                resp = telemetry_export.metrics_response(path_full)
                if resp is None:
                    # Debug surfaces on the router's own port: ITS span
                    # ring (for in-process fleets this includes replica
                    # spans — one shared ring) and flight recorder.
                    resp = telemetry_export.debug_response(path_full)
                if resp is not None:
                    return resp
                path = path_full.rstrip("/")
                if path == "/healthz":
                    ready = router.routable()
                    if ready:
                        return _reply(200, {"status": "ok",
                                            "ready_replicas": len(ready)})
                    return _reply(503, {"status": "unready",
                                        "ready_replicas": 0},
                                  headers={"Retry-After": "1"})
                if path == "/fleet":
                    return _reply(200, router.describe())
                return _reply(404, {"error": f"unknown path {path_full}"})
            except Exception as e:  # noqa: BLE001 — server must stay up
                return _reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _do_post(path_full: str, headers: Any, body_in: bytes):
            # Workload capture stamps the fleet-front-door ARRIVAL
            # — the recorded stream is what clients sent, with
            # rate-limited, unrouted, and handler-crash outcomes
            # included (their status IS the outcome). Defined
            # before any work so the outer except can record the
            # 500s it answers.
            t_arr_mono, t_arr_wall = time.monotonic(), time.time()
            body = body_in or b"{}"
            state = {"is_predict": False}

            def capture(status: int, tspan: Any = None) -> None:
                if not (state["is_predict"] and workload.capturing()):
                    return
                # Format-aware lazy parse: the relay never decoded the
                # body, so the summarizer must sniff the framing. A
                # packed body gets a header-only shape summary — armed
                # capture on a packed-body fleet records shapes, it
                # does not log a JSON decode warning per request.
                payload_obj, wire_format, summary = None, "json", None
                if wirecodec.is_packed(body):
                    wire_format = "packed"
                    try:
                        fs = wirecodec.frame_summary(body)
                    except wirecodec.WireCodecError:
                        fs = {"bytes": len(body), "format": "packed"}
                    summary = {"bytes": fs["bytes"]}
                    tensor = next(
                        (c for c in fs.get("columns", ())
                         if c.get("name") == "instances" and "shape" in c),
                        None)
                    if tensor is not None:
                        shape = tensor["shape"]
                        summary["instances"] = shape[0] if shape else 1
                        summary["instance"] = {"kind": "list",
                                               "shape": shape[1:]}
                        summary["dtype"] = tensor["dtype"]
                else:
                    try:
                        # Capture is the relay's one lazy-parse
                        # consumer: runs post-reply, only while armed,
                        # and only on non-packed bodies.
                        payload_obj = json.loads(body)  # graftlint: disable=json-on-hot-wire
                    except ValueError:
                        payload_obj = None
                workload.record_request(
                    surface="router",
                    endpoint=name,
                    path=path_full.rstrip("/"),
                    tenant=headers.get("X-Tenant"),
                    payload=payload_obj,
                    instances=(
                        payload_obj.get("instances")
                        if isinstance(payload_obj, dict) else None
                    ),
                    status=status,
                    latency_ms=(time.monotonic() - t_arr_mono) * 1e3,
                    trace_id=(
                        tspan.trace_id
                        if getattr(tspan, "sampled", False) else None
                    ),
                    t_mono=t_arr_mono,
                    t_wall=t_arr_wall,
                    wire_format=wire_format,
                    payload_summary=summary,
                )

            def done(resp, tspan: Any = None,
                     probe_headers: dict[str, str] | None = None):
                # Capture and shadow probes run as the route's `after`
                # callback — after the reply is queued for write, so
                # neither may delay the response.
                code = resp[0]

                def after() -> None:
                    capture(code, tspan)
                    if probe_headers is not None:
                        router._maybe_shadow_probe(body, probe_headers)

                return resp[0], resp[1], resp[2], after

            try:
                path = path_full.rstrip("/")
                if path.startswith("/admin/capture/"):
                    # Workload-capture control plane on the fleet's
                    # front door (status: GET /debug/workload).
                    try:
                        admin_payload = json.loads(body)  # graftlint: disable=json-on-hot-wire
                    except ValueError:
                        admin_payload = {}
                    return _reply(*workload.admin_action(path, admin_payload))
                if path not in ("/predict", f"/v1/models/{name}:predict"):
                    return _reply(404, {"error": f"unknown path {path_full}"})
                state["is_predict"] = True
                m_requests.inc()
                tenant = headers.get("X-Tenant", "default")
                wait = router.limiter.acquire(tenant)
                if wait > 0:
                    _m_rate_limited.inc(
                        tenant=router.limiter.label_for(tenant))
                    return done(_reply(
                        429,
                        {"error": f"tenant {tenant!r} rate limited"},
                        headers={"Retry-After": f"{math.ceil(wait)}"},
                    ))
                # QoS class: tenant config is authoritative; the
                # untrusted header can only demote relative to it.
                priority = qos.parse_priority(
                    headers.get(qos.PRIORITY_HEADER),
                    router.limiter.priority_for(tenant),
                )
                # Brownout shed BEFORE the class bucket is charged:
                # a request that will be refused anyway must not
                # drain batch tokens — the bucket would sit empty
                # when the brownout lifts, turning recovery into a
                # burst of spurious 429s.
                if (router.brownout_level >= qos.SHED
                        and qos.rank(priority) > 0):
                    # Brownout shed: the lowest class yields first
                    # so the interactive SLO survives the burn.
                    _m_qos_shed.inc(model=name, priority=priority,
                                    reason="brownout")
                    return done(_reply(
                        503,
                        {"error": f"{priority} traffic shed "
                                  "(brownout; SLO burn)"},
                        headers={"Retry-After": "1"},
                    ))
                cwait = router._class_acquire(priority)
                if cwait > 0:
                    _m_qos_shed.inc(model=name, priority=priority,
                                    reason="rate")
                    return done(_reply(
                        429,
                        {"error": f"{priority} class rate limited"},
                        headers={"Retry-After": f"{math.ceil(cwait)}"},
                    ))
                t0 = time.perf_counter()
                # The trace starts (or, with an incoming
                # `traceparent`, extends) at the fleet's front
                # door; every forward hop below becomes a child,
                # and the chosen sampling decision rides the
                # injected header to the replicas.
                debug = (headers.get(tracing.DEBUG_HEADER) or "")
                # The resolved class rides every forward (replicas
                # must not re-derive it from the untrusted client
                # header); a brownout level rides too so
                # subprocess replicas degrade with the fleet.
                relay_headers = {qos.PRIORITY_HEADER: priority}
                # Wire-format negotiation is end-to-end: the client's
                # Content-Type/Accept ride the relay verbatim so the
                # replica decides the framing (the router never decodes
                # the body either way).
                ctype = headers.get("Content-Type")
                if ctype:
                    relay_headers["Content-Type"] = ctype
                accept = headers.get("Accept")
                if accept:
                    relay_headers["Accept"] = accept
                if debug:
                    relay_headers[tracing.DEBUG_HEADER] = debug
                lvl = router.brownout_level
                if lvl > 0:
                    relay_headers[qos.BROWNOUT_HEADER] = str(lvl)
                # An explicit timeline ask force-samples: the
                # operator debugging a request must get the
                # breakdown whatever the ambient sample rate.
                tspan = tracing.start_trace(
                    "fleet.request", headers=headers, model=name,
                    force_sample=debug.strip().lower() == "timeline")
                with tspan:
                    with span("hops_tpu_fleet_request", model=name):
                        code, payload, rheaders = router.route(
                            body, extra_headers=relay_headers)
                    if debug.strip().lower() == "timeline":
                        # The ONE relay path that needs the object:
                        # the inline timeline merges the router's
                        # own spans into the replica's breakdown.
                        payload = router._merge_debug(payload, tspan)
                # Rolling window behind recent_p99_ms(): the
                # autoscaler's latency trigger reads this; the
                # per-class SLO histogram feeds histogram_p99_ms()
                # and the brownout controller.
                dt = time.perf_counter() - t0
                router.observe_latency(dt, priority=priority)
                _m_request_seconds.observe(
                    dt, model=name, priority=priority)
                if code >= 500:
                    m_unrouted.inc()
                return done(_reply(code, payload, headers=rheaders),
                            tspan, relay_headers)
            except Exception as e:  # noqa: BLE001 — server must stay up
                # A handler crash is a client-visible 500: it
                # belongs in the recorded error mix (capture()
                # never raises past the recorder's drop counter).
                return done(_reply(500, {"error": f"{type(e).__name__}: {e}"}))

        def handler_route(method: str, path: str, headers: Any, body: bytes):
            if method == "GET":
                return _do_get(path, headers)
            if method == "POST":
                return _do_post(path, headers, body)
            return _reply(404, {"error": f"unknown path {path}"})

        self._server = HTTPServer(
            handler_route, bind="127.0.0.1", port=port,
            name=f"fleet-router-{name}", workers=32)
        self._scraper = threading.Thread(
            target=self._scrape_loop, daemon=True,
            name=f"fleet-scraper-{name}",
        )
        self._scraper.start()
        log.info("fleet router for %s listening on 127.0.0.1:%d",
                 name, self.port)

    # -- views / telemetry scrape ---------------------------------------------

    @staticmethod
    def _rep_host(rep: Any) -> str:
        """Where a replica's serving port lives. Placed replicas carry
        their host's address; local (and duck-typed test) replicas
        default to loopback."""
        return getattr(rep, "host", None) or "127.0.0.1"

    def _view(self, rid: str) -> _ReplicaView:
        with self._views_lock:
            view = self._views.get(rid)
            if view is None:
                view = self._views[rid] = _ReplicaView(
                    rid, self.breaker_failures, self.breaker_reset_s)
            return view

    def _scrape_loop(self) -> None:
        interval = self.scrape_interval_s
        while not self._stop.wait(interval):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the scraper must survive
                log.exception("fleet %s: scrape cycle failed", self.name)
            try:
                self._eject_tick()
                self._brownout_tick()
                self._synthetic_probe_tick()
            except Exception:  # noqa: BLE001 — detectors must not kill the loop
                log.exception("fleet %s: gray-failure tick failed", self.name)

    def scrape_once(self) -> None:
        """One COALESCED pass over every routable replica's
        ``/metrics.json``: all scrapes fire concurrently through the
        shared keep-alive pool (one persistent connection per replica,
        reused every 0.25 s cycle — no re-dialing), so the pass's
        wall-time is the slowest replica, not the sum. Each scrape
        still runs under its own deadline and its own
        ``router.scrape`` fault point — a wedged or chaos-stalled
        replica fails ONLY its own scrape.

        Also prunes views whose replica no longer exists (reaped,
        killed, or failed): every rollout and autoscale churn mints
        fresh rids, so without this the ``_views`` dict — a breaker and
        counters per rid ever seen — grows for the router's lifetime.
        """
        reps = self.manager.replicas()
        live = {rep.rid for rep in reps}
        with self._views_lock:
            for rid in [r for r in self._views if r not in live]:
                del self._views[rid]
        targets = [rep for rep in reps
                   if rep.state in ("ready", "starting")
                   and rep.port is not None]
        if not targets:
            return
        if len(targets) == 1:
            snaps = [self._scrape_replica(
                self._rep_host(targets[0]), targets[0].port)]
        else:
            ex = self._scrape_executor()
            snaps = list(ex.map(
                lambda rep: self._scrape_replica(
                    self._rep_host(rep), rep.port),
                targets))
        for rep, snap in zip(targets, snaps):
            view = self._view(rep.rid)
            if snap is None:
                view.scrape_ok = False
                continue
            view.scrape_ok = True
            view.last_scrape_mono = time.monotonic()
            view.queue_depth = snap["queue_depth"]
            view.scraped_inflight = snap["inflight"]
            view.capture_active = snap["capture_active"]
            shed = snap["shed_total"]
            if view._last_shed_total is not None:
                view.shed_rate = max(0.0, shed - view._last_shed_total)
            view._last_shed_total = shed

    def _scrape_executor(self):
        from concurrent.futures import ThreadPoolExecutor

        with self._hedge_lock:
            if self._scrape_pool is None:
                self._scrape_pool = ThreadPoolExecutor(
                    max_workers=8,
                    thread_name_prefix=f"fleet-scrape-{self.name}",
                )
            return self._scrape_pool

    #: The only families the routing score reads — the scrape asks the
    #: replica for exactly these, so each poll renders and parses a
    #: four-family view instead of the replica's full registry snapshot
    #: (which grows with every instrumented subsystem).
    _SCRAPE_FAMILIES = (
        "hops_tpu_serving_batch_queue_depth",
        "hops_tpu_serving_inflight",
        "hops_tpu_serving_shed_total",
        "hops_tpu_workload_capture_active",
    )

    def _scrape_replica(self, host: str,
                        port: int) -> dict[str, float] | None:
        timeout = max(0.5, self.scrape_interval_s * 2)

        def fetch() -> tuple[int, bytes, dict[str, str]]:
            # Chaos point: latency here models a gray metrics path.
            faultinject.fire("router.scrape", key=port)
            return self.pool.request(
                "GET",
                f"http://{host}:{port}/metrics.json"
                f"?families={','.join(self._SCRAPE_FAMILIES)}",
                timeout_s=timeout,
            )

        try:
            # The WHOLE fetch runs under the deadline (not just the
            # socket): a wedged scrape path — injected or real — makes
            # this scrape fail, the view goes stale (deprioritized by
            # score, age surfaced on GET /fleet), and routing itself
            # never stalls. DeadlineExceeded is a TimeoutError, which
            # the OSError arm catches.
            code, raw, _ = with_deadline(fetch, timeout, op="router.scrape")
            if code != 200:
                return None
            # Metrics scrape of a replica's /metrics — telemetry
            # control plane, not the request/response data wire.
            families = json.loads(raw).get("metrics", {})  # graftlint: disable=json-on-hot-wire
        except (OSError, ValueError, RuntimeError):
            return None

        def gauge(family: str) -> float:
            rows = families.get(family, {}).get("samples", [])
            return float(sum(
                r["value"] for r in rows
                if r["labels"].get("model", self.name) == self.name
                and not r.get("suffix")
            ))

        def counter(family: str) -> float:
            rows = families.get(family, {}).get("samples", [])
            return float(sum(
                r["value"] for r in rows
                if r["labels"].get("model", self.name) == self.name
            ))

        return {
            "queue_depth": gauge("hops_tpu_serving_batch_queue_depth"),
            "inflight": gauge("hops_tpu_serving_inflight"),
            "shed_total": counter("hops_tpu_serving_shed_total"),
            "capture_active": gauge("hops_tpu_workload_capture_active"),
        }

    # -- selection / forwarding -----------------------------------------------

    def routable(self) -> list[Any]:
        """Replicas a request may go to right now: ready, with a port,
        breaker not open, not in latency probation."""
        out = []
        for rep in self.manager.replicas():
            if rep.state != "ready" or rep.port is None:
                continue
            view = self._view(rep.rid)
            if view.breaker.state == "open" or view.probation:
                continue
            out.append(rep)
        return out

    def pick(self, exclude: set[str] = frozenset()) -> Any | None:
        """Least-loaded routable replica not in ``exclude``."""
        candidates = [r for r in self.routable() if r.rid not in exclude]
        if not candidates:
            return None
        with self._views_lock:
            self._rr += 1
            rr = self._rr
        scored = sorted(
            (self._view(r.rid).score(), (rr + i) % len(candidates), i)
            for i, r in enumerate(candidates)
        )
        return candidates[scored[0][2]]

    def route(
        self, body: bytes, extra_headers: dict[str, str] | None = None
    ) -> tuple[int, dict[str, Any] | bytes, dict[str, str]]:
        """Forward ``body`` to the best replica, retrying the next-best
        on transport failure / replica 5xx / shed-503 until attempts or
        replicas run out. Returns ``(status, payload, headers)`` where
        ``payload`` is the replica's response body as VERBATIM bytes —
        the zero-copy relay contract: the forward path never parses or
        re-serializes either body (routing needs only the status code
        and headers), so 2xx and 4xx/5xx alike reach the client
        byte-for-byte as the replica sent them. Only the router's own
        no-replica 503 is a dict (it authored it).

        With hedging enabled (and latency data + budget available),
        each attempt may race a second forward at the next-best replica
        after the adaptive timer: first response wins, the loser is
        abandoned — it still finishes on its own thread (latency
        recorded: an abandoned-slow completion is exactly the gray
        signal the ejector wants) but never strikes a breaker, never
        counts a retry, and never double-answers the client.

        Tracing: each forward attempt is a ``fleet.forward`` child span
        of the caller's active trace, tagged with the replica id, the
        attempt index, and the replica breaker's state at selection
        time — so retries read as SIBLING hops under one request, and
        the ``traceparent`` injected on the wire makes the replica's
        own ``serving.request`` span a child of the hop that reached
        it. Hedge attempts additionally carry ``hedge=True``."""
        attempts = self.max_attempts or max(3, len(self.manager.replicas()) + 1)
        hedging = self.hedge.enabled
        if hedging:
            self._hedge_accrue()
        tried: set[str] = set()
        last: tuple[int, Any, dict[str, str]] | None = None
        for attempt in range(attempts):
            rep = self.pick(exclude=tried)
            if rep is None:
                break
            tried.add(rep.rid)
            view = self._view(rep.rid)
            if not view.breaker.allow():
                continue  # raced open, or half-open probe budget spent
            delay = self._hedge_delay_s() if hedging else None
            if delay is None:
                kind, code, payload, headers = self._attempt_sync(
                    rep, view, body, extra_headers, attempt)
            else:
                kind, code, payload, headers = self._attempt_hedged(
                    rep, view, body, extra_headers, attempt, tried, delay)
            if kind == "ok":
                return code, payload, headers
            if kind == "fail":
                last = (code, payload, headers)
            # kind == "transport": unanswered — retry invisible to the
            # client beyond latency.
        if last is not None:
            return last
        return (
            503,
            {"error": f"no routable replicas for {self.name!r}"},
            {"Retry-After": "1"},
        )

    # -- attempt machinery ----------------------------------------------------
    #
    # Outcome kinds: "ok" = terminal, relay to the client (2xx and
    # plain 4xx alike); "fail" = answered but retryable (shed-503/429,
    # replica 5xx, superseded-generation 410) — remembered as `last`,
    # retried elsewhere;
    # "transport" = never answered, retried with nothing client-visible.

    @staticmethod
    def _classify(code: int) -> str:
        if code < 400:
            return "ok"
        if code in (410, 429, 503) or code >= 500:
            # 410 is the fencing refusal: a superseded-generation unit
            # (zombie healed from a partition) typed-rejected the
            # forward — answer is per-replica, so retry elsewhere.
            return "fail"
        return "ok"  # other 4xx: the client's request is bad everywhere

    def _account_live(self, view: _ReplicaView, code: int) -> None:
        """Breaker/retry bookkeeping for a LIVE (non-abandoned) answered
        attempt — abandoned hedge losers never reach this."""
        if code < 400:
            view.breaker.record_success()
        elif code == 410:
            # Superseded-generation refusal: placement identity, not
            # replica health — the unit is a fenced zombie doing
            # exactly its job. No breaker strike; the route loop
            # retries on the live generation, and reconcile() reaps
            # the zombie.
            _m_retries.inc(model=self.name, reason="generation")
            flight.record("retry", op="router.forward",
                          reason="generation", replica=view.rid,
                          model=self.name)
        elif code in (429, 503):
            # Shedding/draining: load, not failure. Don't strike the
            # breaker; the route loop tries a less-loaded replica.
            _m_retries.inc(model=self.name, reason="shed")
            flight.record("retry", op="router.forward", reason="shed",
                          replica=view.rid, model=self.name)
        elif code >= 500:
            view.breaker.record_failure()
            _m_retries.inc(model=self.name, reason="error")
            flight.record("retry", op="router.forward", reason="error",
                          replica=view.rid, model=self.name, status=code)

    def _account_transport(self, view: _ReplicaView, e: Exception) -> None:
        view.breaker.record_failure()
        _m_retries.inc(model=self.name, reason="connect")
        flight.record("retry", op="router.forward",
                      reason="connect", replica=view.rid,
                      model=self.name,
                      error=type(getattr(e, "reason", e)).__name__)

    def _attempt_sync(
        self, rep: Any, view: _ReplicaView, body: bytes,
        extra_headers: dict[str, str] | None, attempt: int,
    ) -> tuple[str, int, Any, dict[str, str]]:
        """One un-hedged forward attempt on the caller's thread."""
        _m_forwards.inc(model=self.name, replica=rep.rid)
        view.inflight_inc()
        fspan = tracing.child_span(
            "fleet.forward", replica=rep.rid, attempt=attempt,
            breaker=view.breaker.state,
        )
        t0 = time.perf_counter()
        try:
            with fspan:
                try:
                    # Chaos point. ANY armed error class models a
                    # transport failure on this hop (the catalog
                    # promises a retry, and the fault grammar defaults
                    # to RuntimeError) — only the real forward below
                    # narrows to transport exception types.
                    faultinject.fire("router.forward")
                except Exception as e:
                    raise urllib.error.URLError(e) from e
                code, payload, headers = self._forward(
                    self._rep_host(rep), rep.port, body,
                    self._stamp_generation(rep, extra_headers))
                fspan.annotate(status=code)
        except (OSError, urllib.error.URLError) as e:
            # Transport failure: the replica is gone or wedged —
            # breaker strike, retry elsewhere.
            self._account_transport(view, e)
            return "transport", 0, None, {}
        finally:
            view.inflight_dec()
        view.latency.observe(time.perf_counter() - t0)
        self._account_live(view, code)
        return self._classify(code), code, payload, headers

    def _attempt_hedged(
        self, rep: Any, view: _ReplicaView, body: bytes,
        extra_headers: dict[str, str] | None, attempt: int,
        tried: set[str], delay: float,
    ) -> tuple[str, int, Any, dict[str, str]]:
        """One possibly-hedged attempt: the primary forward runs on a
        worker thread; if it is still unanswered after ``delay`` and
        the hedge budget allows, a second forward races it at the
        next-best replica. First terminal response wins."""
        race = _HedgeRace()
        ctx = tracing.current_context()
        self._launch_attempt(race, rep, view, body, extra_headers,
                             attempt, ctx, role="primary")
        if race.wait(delay) is None and not race.settled():
            hedge_rep = self.pick(exclude=tried)
            if hedge_rep is not None:
                hview = self._view(hedge_rep.rid)
                if not hview.breaker.allow():
                    pass  # raced open; the primary stands alone
                elif self._hedge_take():
                    tried.add(hedge_rep.rid)
                    flight.record("hedge", model=self.name,
                                  replica=hedge_rep.rid, primary=rep.rid,
                                  delay_ms=round(delay * 1e3, 2))
                    self._launch_attempt(
                        race, hedge_rep, hview, body, extra_headers,
                        attempt, ctx, role="hedge")
                else:
                    _m_hedges.inc(model=self.name, outcome="denied")
        winner = race.wait(None)  # bounded by forward_timeout_s per leg
        if winner is not None:
            return winner
        fail = race.last_failure()
        if fail is not None:
            return fail
        return "transport", 0, None, {}

    def _launch_attempt(
        self, race: "_HedgeRace", rep: Any, view: _ReplicaView,
        body: bytes, extra_headers: dict[str, str] | None, attempt: int,
        ctx: Any, role: str,
    ) -> None:
        race.register_launch()
        _m_forwards.inc(model=self.name, replica=rep.rid)
        # Inflight counts from the COORDINATOR thread, before the
        # worker exists: the score must see the attempt immediately.
        view.inflight_inc()

        def run() -> None:
            err: Exception | None = None
            code, payload, headers = 0, None, {}
            t0 = time.perf_counter()
            try:
                with tracing.use_context(ctx):
                    fspan = tracing.child_span(
                        "fleet.forward", replica=rep.rid, attempt=attempt,
                        breaker=view.breaker.state, hedge=(role == "hedge"),
                    )
                    try:
                        with fspan:
                            try:
                                faultinject.fire("router.forward")
                            except Exception as e:
                                raise urllib.error.URLError(e) from e
                            code, payload, headers = self._forward(
                                self._rep_host(rep), rep.port, body,
                                self._stamp_generation(rep, extra_headers))
                            fspan.annotate(status=code)
                    except (OSError, urllib.error.URLError) as e:
                        err = e
            finally:
                view.inflight_dec()
            if err is None:
                # Abandoned losers observe too: an abandoned-slow
                # completion is exactly the gray-latency signal the
                # ejection detector feeds on.
                view.latency.observe(time.perf_counter() - t0)
                outcome = (self._classify(code), code, payload, headers)
            else:
                outcome = ("transport", 0, None, {})
            live = race.post(outcome)
            if live:
                # The race was undecided when this attempt landed: it
                # carries normal breaker/retry semantics.
                if err is not None:
                    self._account_transport(view, err)
                else:
                    self._account_live(view, code)
                if role == "hedge":
                    _m_hedges.inc(
                        model=self.name,
                        outcome="won" if outcome[0] == "ok" else "lost")
            else:
                # Abandoned loser: no breaker strike, no retry counter
                # — slow is not down, and the client was already
                # answered by the winner.
                if role == "hedge":
                    _m_hedges.inc(model=self.name, outcome="lost")

        self._attempt_executor(role).submit(run)

    def _attempt_executor(self, role: str):
        from concurrent.futures import ThreadPoolExecutor

        with self._hedge_lock:
            if role == "hedge":
                if self._hedge_pool is None:
                    # Sized by the budget: hedges are <= ~5% of
                    # traffic, so a quarter of the primary pool is
                    # already generous headroom.
                    self._hedge_pool = ThreadPoolExecutor(
                        max_workers=max(8, self.attempt_workers // 4),
                        thread_name_prefix=f"fleet-hedge-{self.name}",
                    )
                return self._hedge_pool
            if self._attempt_pool is None:
                self._attempt_pool = ThreadPoolExecutor(
                    max_workers=self.attempt_workers,
                    thread_name_prefix=f"fleet-attempt-{self.name}",
                )
            return self._attempt_pool

    def _stamp_generation(
        self, rep: Any, extra_headers: dict[str, str] | None,
    ) -> dict[str, str] | None:
        """Fencing stamp (docs/operations.md "Partition tolerance &
        fencing"): forwards to a PLACED replica carry its slot's
        CURRENT generation — deliberately the placement client's live
        counter, not the unit snapshot, so once reconcile() bumps the
        slot every forward that still reaches the old unit presents
        the newer token and the zombie typed-rejects it (410)."""
        unit = getattr(rep, "unit", None)
        placement = getattr(self.manager, "placement", None)
        if (unit is None or placement is None
                or getattr(unit, "slot", None) is None):
            return extra_headers
        gen = placement.current_generation(unit.slot)
        return {**(extra_headers or {}),
                "X-Hops-Generation": f"{unit.slot}:{gen}"}

    def _forward(
        self, host: str, port: int, body: bytes,
        extra_headers: dict[str, str] | None = None,
    ) -> tuple[int, bytes, dict[str, str]]:
        headers = {"Content-Type": "application/json", **(extra_headers or {})}
        # Propagate the trace across the process boundary: the active
        # span here is this hop's fleet.forward, so the replica's
        # serving.request parents to exactly the hop that reached it.
        tracing.inject_headers(headers)
        # Persistent-connection pool: no per-hop handshake, and 4xx/5xx
        # come back as data (the zero-copy relay treats status codes as
        # routing input, never exceptions). Bodies stay raw bytes.
        code, data, resp_headers = self.pool.request(
            "POST",
            f"http://{host}:{port}/v1/models/{self.name}:predict",
            body=body, headers=headers, timeout_s=self.forward_timeout_s,
        )
        if code >= 400 and not data:
            return (
                code,
                # Synthesized error body for an empty upstream error —
                # errors are spec'd JSON regardless of negotiation.
                json.dumps({"error": f"replica answered {code}"}).encode(),  # graftlint: disable=json-on-hot-wire
                _relay_headers(resp_headers),
            )
        return code, data, _relayed_with_ctype(resp_headers)

    def _merge_debug(
        self, payload: dict[str, Any] | bytes, tspan: Any
    ) -> dict[str, Any] | bytes:
        """Fold the router's own spans for this trace into the inline
        timeline a replica returned under ``X-Hops-Debug: timeline``
        (dedup by span id: with in-process replicas the shared ring
        already holds the replica's spans). The one relay path that
        parses the relayed bytes — the operator asked for the merged
        object. A non-JSON body relays untouched."""
        if isinstance(payload, bytes):
            raw = payload
            if wirecodec.is_packed(raw):
                # A packed frame carries no debug dict by design
                # (replicas answer timeline asks in JSON); relay the
                # frame untouched rather than mis-parse it.
                return raw
            try:
                # graftlint: disable=json-on-hot-wire — the one relay
                # path spec'd to parse: the operator asked for the
                # merged timeline object.
                parsed = json.loads(payload)
            except ValueError:
                return raw
            if not isinstance(parsed, dict):
                # Valid JSON but not an object (list/scalar): nothing
                # to merge into — relay the ORIGINAL bytes, not a
                # re-serialization of the parse.
                return raw
            payload = parsed
        if not isinstance(payload, dict):
            return payload
        dbg = payload.setdefault("debug", {})
        rows = {r["span_id"]: r for r in dbg.get("timeline", [])
                if isinstance(r, dict) and "span_id" in r}
        for r in tracing.timeline(tspan):
            rows.setdefault(r["span_id"], r)
        merged = sorted(rows.values(), key=lambda r: r.get("start", 0.0))
        if merged:
            dbg["timeline"] = merged
            dbg.setdefault("trace_id", merged[0].get("trace_id"))
        return payload

    # -- hedging --------------------------------------------------------------

    def _class_acquire(self, priority: str) -> float:
        bucket = self._class_buckets.get(priority)
        return bucket.acquire() if bucket is not None else 0.0

    def _hedge_accrue(self) -> None:
        with self._hedge_lock:
            self._hedge_tokens = min(
                self.hedge.budget_burst,
                self._hedge_tokens + self.hedge.budget_frac)

    def _hedge_take(self) -> bool:
        with self._hedge_lock:
            if self._hedge_tokens >= 1.0:
                self._hedge_tokens -= 1.0
                return True
            return False

    def _hedge_delay_s(self) -> float | None:
        """The adaptive hedge timer: the MEDIAN across replicas of each
        replica's recent-latency p95, clamped to the policy bounds. The
        median (not a merged-window p95) is what keeps one gray replica
        from inflating the very timer that defends against it. None
        until the fleet has ``min_samples`` observations — hedging from
        no data is a guess."""
        p95s: list[float] = []
        total = 0
        for rep in self.manager.replicas():
            if rep.state != "ready":
                continue
            view = self._view(rep.rid)
            n = view.latency.sample_count()
            if n >= 8:
                p = view.latency.p95_ms()
                if p is not None:
                    p95s.append(p)
                    total += n
        if not p95s or total < self.hedge.min_samples:
            return None
        delay = statistics.median(p95s) / 1e3
        return min(max(delay, self.hedge.delay_floor_s),
                   self.hedge.delay_cap_s)

    # -- gray-failure ejection / probation ------------------------------------

    def _healthy_median_ms(self) -> float | None:
        """Median latency EWMA across non-probation ready replicas —
        the reference a probe result is judged against."""
        vals: list[float] = []
        for rep in self.manager.replicas():
            if rep.state != "ready" or rep.port is None:
                continue
            view = self._view(rep.rid)
            if view.probation or view.latency.sample_count() < 4:
                continue
            e = view.latency.ewma_ms
            if e is not None:
                vals.append(e)
        return statistics.median(vals) if vals else None

    def _eject_tick(self) -> None:
        """One ejection pass (scrape-loop cadence): compare every ready
        replica's latency EWMA to the median of its PEERS (excluding
        itself — a 2-replica fleet must still see the gray one) and
        move outliers to probation, capped so the detector can never
        empty the fleet."""
        pol = self.ejection
        if not pol.enabled:
            return
        ready = [r for r in self.manager.replicas()
                 if r.state == "ready" and r.port is not None]
        views = [self._view(r.rid) for r in ready]
        in_probation = sum(1 for v in views if v.probation)
        candidates = []
        for v in views:
            if v.probation or v.latency.sample_count() < pol.min_samples:
                continue
            e = v.latency.ewma_ms
            if e is not None:
                candidates.append((v, e))
        if len(candidates) >= 2:
            max_ejected = min(
                len(views) - 1, int(len(views) * pol.max_ejected_frac))
            for view, ewma in sorted(candidates, key=lambda t: -t[1]):
                if in_probation >= max_ejected:
                    break
                peers = [e for v, e in candidates if v is not view]
                med = statistics.median(peers)
                if ewma > max(pol.factor * med, pol.floor_ms):
                    view.probation = True
                    view.probation_since = time.monotonic()
                    view.probe_oks = 0
                    view.last_probe_mono = 0.0
                    in_probation += 1
                    _m_ejections.inc(model=self.name)
                    flight.record("replica_ejected", model=self.name,
                                  replica=view.rid, ewma_ms=round(ewma, 1),
                                  peer_median_ms=round(med, 1))
                    log.warning(
                        "fleet %s: ejected %s into latency probation "
                        "(ewma %.1f ms vs peer median %.1f ms)",
                        self.name, view.rid, ewma, med)
        self._m_probation.set(
            sum(1 for v in views if v.probation))

    def _probe_body_pool(self) -> list[bytes]:
        """Synthetic probe bodies from the ``probe_workload`` artifact,
        materialized lazily on the first probation that needs one: up to
        32 captured requests, deterministically re-materialized
        (``materialize_payload`` seed 0 — the same bodies across router
        restarts). An unusable artifact logs once and leaves the pool
        empty; live-traffic probes keep working."""
        if self._probe_bodies is None:
            bodies: list[bytes] = []
            if self.probe_workload is not None:
                try:
                    from hops_tpu_torch.telemetry.workload import (
                        load_artifact, materialize_payload)

                    art = load_artifact(self.probe_workload)
                    for rec in art["records"][:32]:
                        # Shadow probes are spec'd JSON: they exercise
                        # the replica's default (negotiation-free) path.
                        bodies.append(json.dumps(  # graftlint: disable=json-on-hot-wire
                            materialize_payload(rec, seed=0)
                        ).encode())
                except Exception:  # noqa: BLE001 — probes are optional
                    log.exception(
                        "fleet %s: probe_workload %s unusable — "
                        "synthetic probes disabled",
                        self.name, self.probe_workload)
            self._probe_bodies = bodies
        return self._probe_bodies

    def _synthetic_probe_tick(self) -> None:
        """Scrape-loop hook: probation replicas on a QUIET fleet get
        shadow probes with synthetic bodies from the captured-workload
        pool — without this, probes only piggyback on live requests and
        a zero-traffic probation is a life sentence. The per-view probe
        cadence inside :meth:`_maybe_shadow_probe` dedups against live
        traffic: a busy router's probation views are already inside
        their probe interval, so this tick fires nothing extra."""
        if not self.ejection.enabled or self.probe_workload is None:
            return
        with self._views_lock:
            if not any(v.probation for v in self._views.values()):
                return
        pool = self._probe_body_pool()
        if not pool:
            return
        body = pool[self._probe_body_idx % len(pool)]
        self._probe_body_idx += 1
        self._maybe_shadow_probe(body, None, synthetic=True)

    def _maybe_shadow_probe(
        self, body: bytes, extra_headers: dict[str, str] | None,
        synthetic: bool = False,
    ) -> None:
        """Probation replicas are re-judged with SHADOW traffic: a copy
        of a live (idempotent) request, fired after the real reply went
        out, response discarded. Probe cadence per replica is
        ``probe_interval_s``."""
        if not self.ejection.enabled:
            return
        now = time.monotonic()
        for rep in self.manager.replicas():
            if rep.state != "ready" or rep.port is None:
                continue
            view = self._view(rep.rid)
            if not view.probation:
                continue
            if now - view.last_probe_mono < self.ejection.probe_interval_s:
                continue
            view.last_probe_mono = now
            if synthetic:
                _m_synthetic_probes.inc(model=self.name)
            threading.Thread(
                target=self._shadow_probe, args=(rep, view, body,
                                                 extra_headers),
                daemon=True, name=f"fleet-probe-{self.name}-{rep.rid}",
            ).start()

    def _shadow_probe(
        self, rep: Any, view: _ReplicaView, body: bytes,
        extra_headers: dict[str, str] | None,
    ) -> None:
        headers = {"Content-Type": "application/json", **(extra_headers or {})}
        t0 = time.perf_counter()
        try:
            code, _, _ = self.pool.request(
                "POST",
                f"http://{self._rep_host(rep)}:{rep.port}"
                f"/v1/models/{self.name}:predict",
                body=body, headers=headers,
                timeout_s=self.ejection.probe_timeout_s,
            )
        except OSError:
            view.probe_oks = 0  # still unreachable — stay in probation
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        view.latency.observe(dt_ms / 1e3)
        ref = self._healthy_median_ms()
        limit = (
            self.ejection.readmit_factor * ref
            + self.ejection.readmit_slack_ms
            if ref is not None else None
        )
        if code < 500 and (limit is None or dt_ms <= limit):
            view.probe_oks += 1
        else:
            view.probe_oks = 0
        if view.probe_oks >= self.ejection.readmit_probes:
            view.probation = False
            view.probation_since = None
            view.probe_oks = 0
            # Forget the probation-era samples: the gray history must
            # not immediately re-eject a healed replica.
            view.latency.reset()
            _m_readmissions.inc(model=self.name)
            flight.record("replica_readmitted", model=self.name,
                          replica=rep.rid, probe_ms=round(dt_ms, 1))
            log.info("fleet %s: readmitted %s from probation "
                     "(probe %.1f ms)", self.name, rep.rid, dt_ms)

    # -- brownout / SLO signals -----------------------------------------------

    @property
    def brownout_level(self) -> int:
        return self._brownout.level if self._brownout is not None else 0

    def _brownout_tick(self) -> None:
        self._hist_snapshot_tick()
        if self._brownout is None:
            return
        p99 = self.histogram_p99_ms(priority=qos.PRIORITIES[0])
        if p99 is None:
            p99 = self.recent_p99_ms(priority=qos.PRIORITIES[0])
        prev = self._brownout.level
        level = self._brownout.observe(p99)
        if level != prev:
            flight.record(
                "brownout", model=self.name, level=level,
                p99_ms=None if p99 is None else round(p99, 1))
            log.warning(
                "fleet %s: brownout level %d -> %d (interactive p99 "
                "%s ms vs slo %.0f)", self.name, prev, level,
                "?" if p99 is None else f"{p99:.1f}",
                self._brownout.policy.slo_p99_ms)
        self._m_brownout.set(level)
        if level > 0:
            # Raise/refresh only, under THIS fleet's scope: a
            # co-hosted fleet's endpoints stay at full quality, and
            # level 0 arrives by TTL expiry so recovery never stomps
            # another controller's active brownout.
            qos.set_brownout(
                level, hold_s=max(1.0, 6 * self.scrape_interval_s),
                scope=self.name)

    def _hist_snapshot_tick(self) -> None:
        snap = {
            prio: _m_request_seconds.labels(
                model=self.name, priority=prio).snapshot()
            for prio in qos.PRIORITIES
        }
        with self._hist_lock:
            self._hist_ring.append((time.monotonic(), snap))

    def histogram_p99_ms(
        self, priority: str | None = None, window_s: float = 10.0,
        min_count: int = 20,
    ) -> float | None:
        """p99 estimated from the ``hops_tpu_fleet_latency_seconds``
        histogram's bucket deltas over the recent window — the SLO
        signal the autoscaler and the brownout controller read (None
        until enough observations land). Linear interpolation within
        the bucket; an overflow-bucket p99 reports the top bound (a
        lower bound on the truth, still a breach of any target below
        it)."""
        with self._hist_lock:
            ring = list(self._hist_ring)
        now = time.monotonic()
        base = None
        for t, snap in ring:
            if now - t <= window_s:
                base = snap  # oldest snapshot still inside the window
                break
        prios = [priority] if priority is not None else list(qos.PRIORITIES)
        bounds: tuple[float, ...] | None = None
        delta: list[int] | None = None
        total = 0
        for prio in prios:
            b, counts, n = _m_request_seconds.labels(
                model=self.name, priority=prio).snapshot()
            if base is not None and prio in base:
                base_counts, base_n = base[prio][1], base[prio][2]
            else:
                base_counts, base_n = [0] * len(counts), 0
            d = [c - bc for c, bc in zip(counts, base_counts)]
            bounds = b
            delta = d if delta is None else [x + y for x, y in zip(delta, d)]
            total += n - base_n
        if bounds is None or delta is None or total < min_count:
            return None
        target = 0.99 * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(delta):
            hi = bounds[i] if i < len(bounds) else None
            cum += c
            if cum >= target:
                if hi is None:
                    return bounds[-1] * 1e3
                frac = (target - (cum - c)) / c if c else 1.0
                return (lo + frac * (hi - lo)) * 1e3
            if hi is not None:
                lo = hi
        return bounds[-1] * 1e3

    # -- surface --------------------------------------------------------------

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def breaker_state(self, rid: str) -> str:
        return self._view(rid).breaker.state

    def observe_latency(self, seconds: float,
                        priority: str | None = None) -> None:
        with self._lat_lock:
            self._latencies.append(seconds)
            if len(self._latencies) > 2048:
                del self._latencies[:1024]
            if priority is not None:
                lst = self._class_latencies.setdefault(priority, [])
                lst.append(seconds)
                if len(lst) > 2048:
                    del lst[:1024]

    def recent_p99_ms(self, priority: str | None = None) -> float | None:
        """p99 of the most recent window of router-observed latencies,
        optionally restricted to one QoS class (the autoscaler's
        fallback latency trigger; the primary signal is
        :meth:`histogram_p99_ms`)."""
        with self._lat_lock:
            src = (self._latencies if priority is None
                   else self._class_latencies.get(priority, []))
            window = list(src[-512:])
        if not window:
            return None
        window.sort()
        return window[min(len(window) - 1, int(len(window) * 0.99))] * 1e3

    def fleet_load(self) -> float | None:
        """Mean routing score per routable replica — the autoscaler's
        primary signal (None when nothing is routable)."""
        routable = self.routable()
        if not routable:
            return None
        return sum(self._view(r.rid).score() for r in routable) / len(routable)

    def describe(self) -> dict[str, Any]:
        reps = []
        now = time.monotonic()
        for rep in self.manager.replicas():
            view = self._view(rep.rid)
            ewma = view.latency.ewma_ms
            reps.append({
                "rid": rep.rid,
                "state": rep.state,
                "port": rep.port,
                "version": getattr(rep, "version", None),
                "score": round(view.score(), 3),
                "breaker": view.breaker.state,
                # Gray-failure state, DISTINCT from the breaker: a
                # probation replica answers 200s — it is slow, not
                # down — and heals by shadow probes, not half-open.
                "probation": view.probation,
                "latency_ewma_ms": (
                    round(ewma, 2) if ewma is not None else None),
                # How long the breaker has sat in that state, and how
                # stale the scraped load numbers are (None = never
                # scraped): without the ages a wedged replica whose
                # last scrape said "idle" is indistinguishable from a
                # healthy idle one.
                "breaker_state_age_s": round(view.breaker.state_age_s(), 3),
                "last_scrape_age_s": (
                    round(now - view.last_scrape_mono, 3)
                    if view.last_scrape_mono is not None else None
                ),
                # Scraped per-replica workload-capture status (for
                # in-process fleets every replica shares the router's
                # process-global recorder, so these agree).
                "capture": bool(view.capture_active),
            })
        with self._hedge_lock:
            hedge_tokens = self._hedge_tokens
        return {"model": self.name, "replicas": reps,
                "ready": sum(1 for r in reps if r["state"] == "ready"),
                "capture": workload.status(),
                "qos": {
                    "brownout_level": self.brownout_level,
                    "hedging": self.hedge.enabled,
                    "hedge_tokens": round(hedge_tokens, 3),
                    "ejection": self.ejection.enabled,
                    "probation": sum(
                        1 for r in reps if r.get("probation")),
                }}

    def stop(self) -> None:
        self._stop.set()
        self._server.stop()
        self._scraper.join(timeout=5)
        with self._hedge_lock:
            pools = [p for p in (self._attempt_pool, self._hedge_pool,
                                 self._scrape_pool)
                     if p is not None]
        for p in pools:
            # In-flight abandoned losers finish against the live pool;
            # waiting bounds teardown by the forward timeout instead of
            # racing socket close under a worker.
            p.shutdown(wait=True)
        self.pool.close()
