"""Deterministic fault injection: break the platform on purpose.

Every resilience behavior in this tree — checkpoint quarantine, the
``run_preemptible`` supervisor, serving load-shedding, trial retries —
is proven by *injecting the fault it defends against*, not by hoping a
flaky CI run exercises it. This module is the injection registry:
named **fault points** compiled into the hot paths, disarmed by
default (one ``is None`` check — see the ``bench.py --fault-overhead``
smoke), armed either in code::

    from hops_tpu_torch.runtime import faultinject
    faultinject.arm(faultinject.FaultPlan.parse(
        "loader.read=error:OSError@times=1,after=5"))

or from the environment for end-to-end chaos tests::

    HOPS_TPU_FAULTS="checkpoint.save=corrupt@times=1;serving.handle=error:RuntimeError@p=0.5"

Grammar: ``point=mode[:arg][@key=val,...]`` joined by ``;``.
Modes: ``error[:ExcName]`` raises (builtin exception, default
``RuntimeError``), ``latency:seconds`` sleeps, ``corrupt`` asks the
fault point to damage its payload (bytes) or artifact (files) — points
that have nothing to damage ignore it, and ``partition`` black-holes
the passage (raises ``ConnectionError``, records a ``partition``
flight event — the network-partition simulator, normally armed at the
``transport.send`` point via :func:`cut`/:func:`heal`). Keys: ``p``
(probability, default 1), ``times`` (max firings, default unlimited),
``after`` (passages to skip first, default 0), ``seed``, and ``key`` —
a discriminator matched against the value the fault point passes to
``fire(point, key=...)``, so a fault can target ONE replica port or
ONE feature shard out of many sharing a process (gray failures are
per-component by nature; a keyed spec counts passages only for its
key, keeping replay deterministic per component).

Partitions are **directional**: ``transport.send`` evaluates a send
from ``src`` to ``dst`` against three keys — ``dst`` (anything → dst),
``src->dst`` (that edge only) and ``src->*`` (src's whole egress) — so
asymmetric cuts (A→B delivered while B→A is black-holed) are one keyed
clause each. ``dst`` is the logical host name when the endpoint was
registered via :func:`name_endpoint` (hostd names its own agent port
and every unit it spawns), else the raw ``host:port``. See
docs/operations.md "Partition tolerance & fencing".

Determinism: each spec keeps a passage counter; probabilistic firing
draws from ``random.Random((seed, point, passage))`` — a plan replays
identically across runs and regardless of thread interleaving *per
point* (passages are counted under a lock).

Fault points wired through the stack (keep in sync with
docs/operations.md "Failure handling & fault injection"):

==================  ========================================================
``checkpoint.save``     ``CheckpointManager.save`` (corrupt: damages the
                        step's files after its manifest is written)
``checkpoint.restore``  ``CheckpointManager.restore`` (corrupt: damages the
                        newest step before verification)
``loader.read``         ``LoaderIterator`` batch production
``serving.handle``      the serving POST handler, before predict
``search.trial``        ``TrialDriver._run_trial``, around the train fn
``pubsub.publish``      ``pubsub.Producer.send`` (corrupt: mangles the
                        encoded record)
``pubsub.poll``         ``pubsub.Consumer.poll_records``, per record
                        (error/latency abort the poll with the offset
                        restored — a retry re-delivers the batch;
                        corrupt mangles the record consumer-side into
                        a poison record, the durable topic untouched)
``lm_engine.dispatch``  ``LMEngine.step``, before the iteration's device
                        dispatch wave (an error fails only the in-flight
                        requests; the scheduler keeps serving)
``online.lookup``       ``ShardedOnlineStore.multi_get``, per shard batch
                        (an error degrades those keys to the missing-key
                        policy and feeds the shard's breaker)
``online.materialize``  the write-through ``Materializer`` poll/flush
                        cycle (survived with backoff; freshness lag
                        rises while it stalls)
``router.forward``      the fleet router, before forwarding a request
                        to its chosen replica (latency delays the hop;
                        an error is treated as a replica failure and
                        the request retries on another replica)
``router.scrape``       the router's per-replica ``/metrics.json``
                        scrape, keyed by replica port (latency models
                        a gray metrics path: the scrape times out, the
                        view goes stale and the replica is
                        deprioritized, routing never stalls)
``shard.lookup``        one shard-lookup *attempt* inside
                        ``ShardedOnlineStore.multi_get``'s parallel
                        fan-out, keyed by shard index (latency models
                        a slow-but-alive shard: the per-shard hedge
                        and the multi-get deadline contain it)
``fleet.spawn``         ``ReplicaManager.spawn``, before a replica
                        worker is created (an error fails that spawn
                        attempt; autoscaler/rollout retry policies own
                        the recovery)
``placement.rpc``       every placement control-plane RPC, keyed by
                        host name — client-side in
                        ``PlacementClient._rpc`` (a partition: the
                        verb never reaches the host) and agent-side in
                        the hostd dispatcher. The per-host breaker
                        ejects the partitioned host; spawns re-place
                        on survivors
``transport.send``      every ``HTTPPool`` exchange, evaluated by
                        :func:`fire_transport` against the directional
                        keys above before any bytes move — the network
                        fabric itself. ``partition`` black-holes the
                        send (the classic cut), ``latency`` models a
                        slow link. Also fired by hostd's heartbeat
                        announce (``dst=registry``) so a cut host's
                        lease expires and it self-fences
==================  ========================================================
"""

from __future__ import annotations

import builtins
import dataclasses
import hashlib
import os
import random
import threading
import time
from pathlib import Path
from typing import Any

from hops_tpu_torch.runtime import flight
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry import tracing
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

ENV_VAR = "HOPS_TPU_FAULTS"

#: The named injection points compiled into the stack.
POINTS = (
    "checkpoint.save",
    "checkpoint.restore",
    "loader.read",
    "serving.handle",
    "search.trial",
    "pubsub.publish",
    "pubsub.poll",
    "lm_engine.dispatch",
    "online.lookup",
    "online.materialize",
    "router.forward",
    "router.scrape",
    "shard.lookup",
    "fleet.spawn",
    "placement.rpc",
    "serving.start",
    "workload.publish",
    "transport.send",
)

_MODES = ("error", "latency", "corrupt", "partition")

_m_injected = REGISTRY.counter(
    "hops_tpu_faults_injected_total",
    "Faults actually injected, per fault point and mode",
    labels=("point", "mode"),
)


class FaultPlanError(ValueError):
    """A ``HOPS_TPU_FAULTS`` string / FaultSpec that doesn't parse."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: what to do at a point, and on which passages."""

    point: str
    mode: str
    arg: Any = None  # exception class (error) / seconds (latency)
    probability: float = 1.0
    times: int | None = None
    after: int = 0
    seed: int = 0
    #: Optional discriminator: the spec fires only on passages whose
    #: ``fire(point, key=...)`` value equals it (replica port, shard
    #: index). None matches every passage.
    key: str | None = None
    # runtime counters — guarded by: FaultPlan._lock
    passages: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        if self.point not in POINTS:
            raise FaultPlanError(
                f"unknown fault point {self.point!r}; known: {', '.join(POINTS)}")
        if self.mode not in _MODES:
            raise FaultPlanError(
                f"unknown fault mode {self.mode!r}; known: {', '.join(_MODES)}")
        if self.mode == "error":
            if self.arg is None:
                self.arg = RuntimeError
            elif isinstance(self.arg, str):
                exc = getattr(builtins, self.arg, None)
                if not (isinstance(exc, type) and issubclass(exc, BaseException)):
                    raise FaultPlanError(
                        f"{self.arg!r} is not a builtin exception type")
                self.arg = exc
        elif self.mode == "latency":
            try:
                self.arg = float(self.arg)
            except (TypeError, ValueError):
                raise FaultPlanError(
                    f"latency mode needs seconds, got {self.arg!r}") from None
        elif self.mode == "partition" and self.arg is not None:
            raise FaultPlanError(
                f"partition mode takes no argument, got {self.arg!r}")
        if not 0.0 <= self.probability <= 1.0:
            raise FaultPlanError(f"probability must be in [0,1], got "
                                 f"{self.probability}")

    def _should_fire(self) -> bool:  # guarded by: FaultPlan._lock
        passage = self.passages
        self.passages += 1
        if passage < self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.probability < 1.0:
            # Stable digest seed: random.seed rejects tuples on 3.11+
            # and would hash the point name under PYTHONHASHSEED on
            # 3.10 — either way breaking cross-run replayability.
            digest = hashlib.sha256(
                f"{self.seed}:{self.point}:{passage}".encode()).digest()
            rng = random.Random(int.from_bytes(digest[:8], "big"))
            if rng.random() >= self.probability:
                return False
        self.fired += 1
        return True


class FaultPlan:
    """An armed set of :class:`FaultSpec`, indexed by point."""

    def __init__(self, specs: list[FaultSpec]):
        self._lock = threading.Lock()
        self._by_point: dict[str, list[FaultSpec]] = {}
        for spec in specs:
            self._by_point.setdefault(spec.point, []).append(spec)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the ``HOPS_TPU_FAULTS`` grammar (see module docstring)."""
        specs: list[FaultSpec] = []
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if "=" not in clause:
                raise FaultPlanError(f"expected point=mode[...], got {clause!r}")
            point, rest = clause.split("=", 1)
            opts = ""
            if "@" in rest:
                rest, opts = rest.split("@", 1)
            mode, _, arg = rest.partition(":")
            kwargs: dict[str, Any] = {}
            for kv in opts.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise FaultPlanError(f"expected key=val in options, got {kv!r}")
                k, v = kv.split("=", 1)
                k = k.strip()
                if k == "p":
                    kwargs["probability"] = float(v)
                elif k in ("times", "after", "seed"):
                    kwargs[k] = int(v)
                elif k == "key":
                    kwargs["key"] = v.strip()
                else:
                    raise FaultPlanError(f"unknown fault option {k!r}")
            specs.append(FaultSpec(point=point.strip(), mode=mode.strip(),
                                   arg=arg or None, **kwargs))
        if not specs:
            raise FaultPlanError(f"no fault specs in {text!r}")
        return cls(specs)

    def evaluate(self, point: str, key: str | None = None, *,
                 keyed_only: bool = False) -> list[FaultSpec]:
        """The specs that fire on this passage of ``point``. A keyed
        spec sees (and counts) only passages carrying its key, so its
        ``times``/``after``/``p`` schedule replays deterministically
        per component regardless of how other keys interleave.
        ``keyed_only`` skips key-less specs — :func:`fire_transport`
        evaluates several directional keys per send and must count an
        unkeyed spec's passage exactly once."""
        with self._lock:
            specs = self._by_point.get(point)
            if not specs:
                return []
            return [
                s for s in specs
                if (s.key == key if keyed_only or s.key is not None else True)
                and s._should_fire()
            ]

    def add(self, spec: FaultSpec) -> None:
        """Arm one more spec in a live plan (:func:`cut` uses this to
        open partitions mid-run without disturbing armed schedules)."""
        with self._lock:
            self._by_point.setdefault(spec.point, []).append(spec)

    def remove(self, *, point: str | None = None, mode: str | None = None,
               key: str | None = None) -> int:
        """Drop armed specs matching every given filter; returns the
        count removed (:func:`heal` closes partitions with this)."""
        removed = 0
        with self._lock:
            for pt in list(self._by_point):
                if point is not None and pt != point:
                    continue
                keep = [
                    s for s in self._by_point[pt]
                    if not ((mode is None or s.mode == mode)
                            and (key is None or s.key == key))
                ]
                removed += len(self._by_point[pt]) - len(keep)
                if keep:
                    self._by_point[pt] = keep
                else:
                    del self._by_point[pt]
        return removed

    def describe(self) -> str:
        with self._lock:
            return "; ".join(
                f"{s.point}={s.mode}"
                + (f":{getattr(s.arg, '__name__', s.arg)}" if s.arg is not None else "")
                + (f"@key={s.key}" if s.key is not None else "")
                for specs in self._by_point.values() for s in specs
            )


#: The armed plan. ``None`` = disarmed: :func:`fire` is a single
#: attribute load + ``is None`` test, nothing else (bench-guarded).
_PLAN: FaultPlan | None = None


def arm(plan: FaultPlan | str) -> FaultPlan:
    """Arm a plan (or a plan string) process-wide; returns it."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _PLAN = plan
    log.warning("fault injection ARMED: %s", plan.describe())
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def armed() -> bool:
    return _PLAN is not None


def arm_from_env(environ: dict | None = None) -> FaultPlan | None:
    """Arm from ``HOPS_TPU_FAULTS`` if set (e2e chaos tests); returns
    the plan or None. Malformed plans raise — a chaos test that thinks
    it is injecting faults but isn't must not pass silently."""
    text = (environ if environ is not None else os.environ).get(ENV_VAR)
    if not text:
        return None
    return arm(text)


def _apply(spec: FaultSpec, point: str, **info: Any) -> bool:
    """Execute one fired spec; returns True when it was ``corrupt``.
    ``info`` rides into the flight event (``src``/``dst`` for
    transport passages)."""
    _m_injected.inc(point=point, mode=spec.mode)
    # The black box + the causal thread: a fired fault lands in the
    # flight recorder and annotates whatever request trace it fired
    # under, so post-incident the injected failure, the retry it
    # provoked, and the breaker it tripped read in one sequence.
    # Partitions get their own flight kind: a chaos drill's timeline
    # (cut → fence → re-place → heal → generation_rejected) must read
    # from the recorder without grepping generic fault noise.
    kind = "partition" if spec.mode == "partition" else "fault_fired"
    flight.record(kind, point=point, mode=spec.mode, **info)
    tracing.add_event(kind, point=point, mode=spec.mode, **info)
    if spec.mode == "latency":
        log.warning("faultinject: %s sleeping %.3fs", point, spec.arg)
        time.sleep(spec.arg)
        return False
    if spec.mode == "error":
        log.warning("faultinject: %s raising %s", point, spec.arg.__name__)
        raise spec.arg(f"faultinject: injected {spec.arg.__name__} at {point}")
    if spec.mode == "partition":
        where = (f"{info.get('src')}->{info.get('dst')}"
                 if "dst" in info else point)
        log.warning("faultinject: partition black-holed %s", where)
        raise ConnectionError(f"faultinject: partition at {where} (black-holed)")
    log.warning("faultinject: %s corrupt trigger", point)
    return True


def fire(point: str, key: Any = None) -> bool:
    """Evaluate ``point``. Raises / sleeps per the armed plan; returns
    True when a ``corrupt`` spec fired (the site decides what that
    means for its artifact). Disarmed: returns False immediately.
    ``key`` names the specific component this passage belongs to
    (replica port, shard index) for ``@key=``-scoped specs."""
    if _PLAN is None:
        return False
    corrupt = False
    for spec in _PLAN.evaluate(point, key=None if key is None else str(key)):
        corrupt |= _apply(spec, point)
    return corrupt


def fire_data(point: str, data: bytes) -> bytes:
    """Like :func:`fire` for byte-payload points: a ``corrupt`` spec
    returns a damaged copy of ``data`` instead of a flag."""
    if _PLAN is None:
        return data
    if fire(point):
        return _corrupt_bytes(data)
    return data


# ---------------------------------------------------------------- partitions
#
# The network-partition simulator. HTTPPool calls fire_transport()
# before every exchange; a ``partition`` spec at ``transport.send``
# black-holes matching sends with ConnectionError — exactly what a
# dropped SYN looks like to the caller, so every breaker/retry/hedge
# path exercises its real partition behavior. Cuts are directional
# (see the module docstring) and deterministic: FaultSpec's
# seed/p/times/after schedule applies per key.

_endpoints_lock = threading.Lock()
#: ``"host:port"`` → logical name, so chaos plans address hosts by the
#: names operators know (``key=h1``), not ephemeral ports.
_ENDPOINTS: dict[str, str] = {}


def name_endpoint(hostport: str, name: str) -> None:
    """Register ``host:port`` under a logical host name for partition
    keying. Hostd registers its agent port and every unit it spawns,
    so ``cut("h1")`` severs the whole host — agent and units alike."""
    with _endpoints_lock:
        _ENDPOINTS[hostport] = name


def endpoint_name(hostport: str) -> str:
    """The logical name for ``host:port`` (itself when unregistered)."""
    with _endpoints_lock:
        return _ENDPOINTS.get(hostport, hostport)


def fire_transport(src: str, dst: str) -> None:
    """Transport fault point: evaluate one send from the pool named
    ``src`` to endpoint ``dst`` (``host:port`` or a logical name).
    Matches specs keyed ``dst``, ``src->dst`` and ``src->*`` — plus
    unkeyed ``transport.send`` specs, counted exactly once per send.
    Raises ``ConnectionError`` on a fired partition; disarmed it is
    one attribute load + ``is None`` test."""
    plan = _PLAN
    if plan is None:
        return
    dname = endpoint_name(dst)
    fired = plan.evaluate("transport.send", key=dname)
    for key in (f"{src}->{dname}", f"{src}->*"):
        fired += plan.evaluate("transport.send", key=key, keyed_only=True)
    for spec in fired:
        _apply(spec, "transport.send", src=src, dst=dname)


def cut(key: str, *, probability: float = 1.0, times: int | None = None,
        after: int = 0, seed: int = 0) -> FaultSpec:
    """Open a partition: black-hole ``transport.send`` passages
    matching ``key`` (a destination name, ``src->dst`` edge, or
    ``src->*`` egress). Arms an empty plan if none is armed; adds to
    the live plan otherwise. Returns the armed spec; close the cut
    with :func:`heal`."""
    global _PLAN
    spec = FaultSpec(point="transport.send", mode="partition",
                     probability=probability, times=times, after=after,
                     seed=seed, key=key)
    plan = _PLAN
    if plan is None:
        plan = _PLAN = FaultPlan([])
    plan.add(spec)
    flight.record("partition", action="cut", key=key)
    log.warning("faultinject: partition CUT %s", key)
    return spec


def heal(key: str | None = None) -> int:
    """Close partitions: remove armed ``partition`` specs at
    ``transport.send`` matching ``key`` (all of them when None).
    Returns the number healed."""
    plan = _PLAN
    if plan is None:
        return 0
    healed = plan.remove(point="transport.send", mode="partition", key=key)
    if healed:
        flight.record("partition", action="heal", key=key or "*")
        log.warning("faultinject: partition HEALED %s (%d cut%s)",
                    key or "*", healed, "s" if healed != 1 else "")
    return healed


def _corrupt_bytes(data: bytes) -> bytes:
    """Deterministic damage: truncate the body to half and flip its
    first byte — enough to defeat checksums and parsers. A trailing
    newline is PRESERVED: line-framed payloads (pubsub records) must
    stay one damaged record, not bleed into the next line — a missing
    terminator would wedge tailing consumers on a partial-write check
    forever, which is a different fault than corruption."""
    tail = b"\n" if data.endswith(b"\n") else b""
    body = data[: len(data) - len(tail)]
    half = body[: max(1, len(body) // 2)]
    return bytes([half[0] ^ 0xFF]) + half[1:] + tail if half else tail


def corrupt_directory(directory: str | Path) -> Path | None:
    """Damage the largest file under ``directory`` in place (truncate
    to half) — the checkpoint fault points' artifact corruption.
    Returns the damaged path (None when the dir holds no files)."""
    directory = Path(directory)
    files = sorted(
        (p for p in directory.rglob("*") if p.is_file()),
        key=lambda p: p.stat().st_size,
    )
    if not files:
        return None
    victim = files[-1]
    data = victim.read_bytes()
    victim.write_bytes(_corrupt_bytes(data) if data else b"")
    log.warning("faultinject: corrupted %s (%d -> %d bytes)",
                victim, len(data), victim.stat().st_size)
    return victim


# E2E chaos tests arm via the environment before the process starts.
if os.environ.get(ENV_VAR):
    arm_from_env()
