"""End-to-end QoS classes and brownout degradation (a copy of
``hops_tpu/runtime/qos.py``: the module imports no JAX, and the port
imports nothing of the JAX package).

Gray-failure tolerance needs the whole stack to agree on two small
pieces of shared state, and this module is where they live so the
fleet router (top), the serving host (middle), and the feature /
LM layers (bottom) can all import it without cycles:

- **Priority classes.** Two classes, ``interactive`` and ``batch``
  (``X-Priority`` header, or per-tenant config). Interactive is the
  latency SLO; batch is throughput that must yield first under
  pressure. The class rides a contextvar from the HTTP handler down
  through the batcher/joins/LM admission of the SAME request, and the
  router relays the header on every forward so subprocess replicas see
  it too. Untrusted headers can only *lower* a tenant's configured
  class, never raise it.
- **Brownout state.** Under sustained SLO burn the router's
  :class:`BrownoutController` walks a level ladder — 0 (normal),
  1 (*degrade*: feature joins stop waiting on slow shards and serve
  defaults, LM decode budgets shrink), 2 (*shed*: batch-class traffic
  is refused at the front door) — with hysteresis on both edges so one
  bursty tick doesn't flap the fleet. The level is published here
  (:func:`set_brownout` / :func:`brownout_level`) with a hold TTL:
  in-process components read it directly, and subprocess replicas
  adopt it per-request from the ``X-Hops-Brownout`` header the router
  stamps on forwards while browned out. Interactive traffic is shed
  only by the mechanisms that already existed (rate limits,
  ``max_inflight``) — brownout's whole point is to spend quality and
  batch capacity BEFORE touching the interactive class.
- **Bounded priority queues.** :class:`BoundedPriorityQueue` is the
  one sanctioned priority-queue shape for the serving tiers (the
  ``unbounded-priority-queue`` lint rule enforces that queues there
  declare a bound): a hard bound with a shed-lowest-class-first
  eviction policy, FIFO within a class, and a starvation guard — after
  ``starvation_limit`` consecutive higher-class pops while lower-class
  work waits, the oldest lower-class item is served regardless, so
  batch makes progress under any sustained interactive load.

See docs/operations.md "Tail latency & QoS".
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import Any, Callable, Iterator, Sequence

PRIORITIES = ("interactive", "batch")
PRIORITY_HEADER = "X-Priority"
BROWNOUT_HEADER = "X-Hops-Brownout"

#: Brownout levels (the ladder the controller walks).
NORMAL, DEGRADE, SHED = 0, 1, 2


def rank(priority: str) -> int:
    """Smaller = more important. Unknown classes collapse to batch —
    an unrecognized claim must not jump the queue."""
    try:
        return PRIORITIES.index(priority)
    except ValueError:
        return len(PRIORITIES) - 1


def parse_priority(header_value: str | None,
                   configured: str | None = None) -> str:
    """Resolve a request's class from its ``X-Priority`` header and the
    tenant's configured class. The header is untrusted client input: it
    can DEMOTE relative to the tenant's configured class (a batch tool
    on an interactive tenant may self-identify), never promote past it.
    No signal at all means interactive — humans are the default."""
    base = configured if configured in PRIORITIES else None
    claimed = (header_value or "").strip().lower()
    claimed = claimed if claimed in PRIORITIES else None
    if base is None and claimed is None:
        return PRIORITIES[0]
    if base is None:
        return claimed
    if claimed is None:
        return base
    return claimed if rank(claimed) >= rank(base) else base


# -- the request's class, riding the call stack --------------------------------

_current_priority: contextvars.ContextVar[str] = contextvars.ContextVar(
    "hops_tpu_torch_qos_priority", default=PRIORITIES[0])


def request_priority() -> str:
    """The priority class of the request this thread is serving."""
    return _current_priority.get()


@contextlib.contextmanager
def priority_scope(priority: str) -> Iterator[None]:
    token = _current_priority.set(
        priority if priority in PRIORITIES else PRIORITIES[0])
    try:
        yield
    finally:
        _current_priority.reset(token)


# -- the brownout level, scoped per endpoint ------------------------------------
#
# Originally ONE process-wide level — which meant a multi-fleet host
# (two in-process fleets, or a serving replica co-located with an
# online-serving daemon) browned out EVERY endpoint the moment one
# model's SLO burned. Levels are now keyed by a *scope* string (a fleet
# or model name; ``""`` is the legacy process-global scope, kept for
# standalone daemons and existing callers). The effective level a
# component sees is ``max(global, its scope)`` — the global scope can
# still degrade the whole host (an operator big-red-switch), but one
# endpoint's controller only touches its own scope.
#
# The scope rides the request context like the priority class does
# (:func:`brownout_scope`): the HTTP handler enters its endpoint's
# scope, and every layer underneath (feature joins, LM decode budgets)
# reads :func:`brownout_level` with no arguments and resolves the
# request's own endpoint.

_brownout_lock = threading.Lock()
#: scope -> (level, expires_monotonic). guarded by: _brownout_lock
_brownout_state: dict[str, tuple[int, float]] = {}

_current_brownout_scope: contextvars.ContextVar[str] = contextvars.ContextVar(
    "hops_tpu_torch_qos_brownout_scope", default="")


@contextlib.contextmanager
def brownout_scope(scope: str) -> Iterator[None]:
    """Bind the brownout scope of the request this context serves (the
    endpoint's fleet/model name). Rides ``contextvars`` into batcher
    and join layers exactly like :func:`priority_scope`."""
    token = _current_brownout_scope.set(scope or "")
    try:
        yield
    finally:
        _current_brownout_scope.reset(token)


def set_brownout(level: int, hold_s: float = 3.0,
                 clock: Callable[[], float] = time.monotonic,
                 scope: str = "") -> None:
    """Publish the brownout level for ``scope`` with a hold TTL. The
    TTL is the fail-safe direction: if the controller (or the router
    stamping headers at a subprocess replica) dies, the fleet drifts
    back to full quality instead of staying degraded forever."""
    with _brownout_lock:
        lvl = max(0, int(level))
        if lvl == 0:
            _brownout_state.pop(scope or "", None)
        else:
            _brownout_state[scope or ""] = (lvl, clock() + hold_s)


def _level_locked(scope: str, now: float) -> int:  # guarded by: _brownout_lock
    state = _brownout_state.get(scope)
    if state is None:
        return 0
    level, expires = state
    return 0 if now >= expires else level


def brownout_level(clock: Callable[[], float] = time.monotonic,
                   scope: str | None = None) -> int:
    """The effective level for ``scope`` (default: the scope bound to
    the current request context, or the global scope outside one) —
    the max of the global level and the scoped level, each under its
    own TTL."""
    if scope is None:
        scope = _current_brownout_scope.get()
    now = clock()
    with _brownout_lock:
        level = _level_locked("", now)
        if scope:
            level = max(level, _level_locked(scope, now))
        return level


def note_remote_brownout(header_value: str | None,
                         hold_s: float = 3.0, scope: str = "") -> None:
    """Adopt a brownout level relayed on a forward's ``X-Hops-Brownout``
    header (subprocess replicas have no view of the router's
    controller), under the replica's own endpoint scope. Only raises or
    refreshes — expiry is by TTL, so a brief gap in browned-out traffic
    cannot flap the level."""
    if not header_value:
        return
    try:
        level = int(str(header_value).strip())
    except ValueError:
        return
    if level > 0 and level >= brownout_level(scope=scope):
        set_brownout(level, hold_s=hold_s, scope=scope)


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """When sustained SLO burn degrades the fleet (docs/operations.md
    "Tail latency & QoS")."""

    #: The interactive-class p99 target the controller defends.
    slo_p99_ms: float
    #: p99 above slo for ``burn_window_s`` continuously -> DEGRADE.
    burn_window_s: float = 1.0
    #: p99 above ``shed_factor * slo`` for ``burn_window_s`` -> SHED.
    shed_factor: float = 2.0
    #: p99 below ``exit_factor * slo`` for ``recover_window_s`` steps
    #: the level DOWN one notch (hysteresis: exit_factor < 1).
    exit_factor: float = 0.8
    recover_window_s: float = 2.0

    def __post_init__(self) -> None:
        if self.slo_p99_ms <= 0:
            raise ValueError("slo_p99_ms must be > 0")
        if not 0 < self.exit_factor < 1:
            raise ValueError("exit_factor must be in (0, 1) (hysteresis)")
        if self.shed_factor < 1:
            raise ValueError("shed_factor must be >= 1")


class BrownoutController:
    """Walks the brownout ladder from an observed p99 stream.

    ``observe(p99_ms)`` is called on the owner's cadence (the router's
    scrape loop); it returns the current level. Deterministic under an
    injected clock. The controller only COMPUTES the level — publishing
    it (:func:`set_brownout`, metrics, flight events) stays with the
    owner, which knows the model name and hold semantics.
    """

    def __init__(self, policy: BrownoutPolicy,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self._clock = clock
        self.level = 0
        self._burn_since: float | None = None
        self._shed_burn_since: float | None = None
        self._clear_since: float | None = None

    def observe(self, p99_ms: float | None) -> int:
        now = self._clock()
        p = self.policy
        if p99_ms is None:
            # No signal: hold the level, reset edge timers (we can't
            # claim the burn is sustained through a blind spot).
            self._burn_since = self._shed_burn_since = self._clear_since = None
            return self.level
        burning = p99_ms > p.slo_p99_ms
        shed_burning = p99_ms > p.slo_p99_ms * p.shed_factor
        clearing = p99_ms < p.slo_p99_ms * p.exit_factor

        def edge(since: float | None, active: bool) -> float | None:
            # Explicit None checks: a timestamp of 0.0 (injected test
            # clocks start there) is a REAL edge, not "unset".
            if not active:
                return None
            return now if since is None else since

        self._burn_since = edge(self._burn_since, burning)
        self._shed_burn_since = edge(self._shed_burn_since, shed_burning)
        self._clear_since = edge(self._clear_since, clearing)
        if (self._shed_burn_since is not None
                and now - self._shed_burn_since >= p.burn_window_s):
            self.level = SHED
        elif (self._burn_since is not None
                and now - self._burn_since >= p.burn_window_s):
            self.level = max(self.level, DEGRADE)
        elif (self.level > 0 and self._clear_since is not None
                and now - self._clear_since >= p.recover_window_s):
            self.level -= 1
            self._clear_since = now  # the next notch needs its own window
        return self.level


# -- bounded priority queue ----------------------------------------------------


class ShedError(RuntimeError):
    """Raised to the producer whose item was refused or evicted by a
    :class:`BoundedPriorityQueue` shed (serving maps it to a 503)."""


class QueueFullError(ShedError):
    """Typed admission reject: a bounded submit queue is at capacity,
    so the request is refused at the door instead of buffering
    unboundedly. A load signal, not a failure — serving maps it to
    503 ``reason="overload"`` with Retry-After, no breaker strike."""


class StarvationGuard:
    """After ``limit`` consecutive higher-class picks while lower-class
    work waits, the next pick MUST take the most-starved class. One
    instance per queue/admission site; not thread-safe by itself (call
    under the owner's lock)."""

    def __init__(self, limit: int = 8):
        if limit < 1:
            raise ValueError("starvation limit must be >= 1")
        self.limit = limit
        self._preferred_streak = 0

    def pick_rank(self, ranks_waiting: Sequence[int]) -> int:
        """Which rank to serve, given the (non-empty) set of ranks with
        queued work."""
        best, worst = min(ranks_waiting), max(ranks_waiting)
        if worst > best and self._preferred_streak >= self.limit:
            self._preferred_streak = 0
            return worst
        if worst > best:
            self._preferred_streak += 1
        else:
            self._preferred_streak = 0
        return best


class BoundedPriorityQueue:
    """A hard-bounded priority queue that sheds lowest class first.

    ``put(item, rank)`` admits unless the queue is full; full, it
    evicts the NEWEST item of the worst (highest-rank) class that is
    strictly worse than the incoming item — shedding the least
    important, least-sunk work — and returns it so the caller can fail
    its producer with :class:`ShedError`. If nothing queued is worse,
    the incoming item itself is refused (raises :class:`ShedError`).
    ``get`` serves FIFO within a class, best class first, under a
    :class:`StarvationGuard`. Ranks below 0 are control items
    (sentinels) and are never evicted or counted by the guard.
    """

    def __init__(self, bound: int, *, starvation_limit: int = 8):
        if bound < 1:
            raise ValueError("BoundedPriorityQueue needs a bound >= 1")
        self.bound = bound
        self._cv = threading.Condition()
        self._lanes: dict[int, collections.deque] = {}  # guarded by: self._cv
        # Queued non-control items (sentinels on negative ranks are
        # excluded from the bound).
        self._size = 0  # guarded by: self._cv
        self._guard = StarvationGuard(starvation_limit)  # guarded by: self._cv

    def qsize(self) -> int:
        with self._cv:
            return self._size

    def put(self, item: Any, rank: int = 0) -> Any | None:
        """Admit ``item``; returns an evicted lower-class item (the
        caller owns failing it) or None. Raises :class:`ShedError` when
        the queue is full of equal-or-better work."""
        with self._cv:
            evicted = None
            if rank >= 0 and self._size >= self.bound:
                worst = max(
                    (r for r, lane in self._lanes.items() if r > rank and lane),
                    default=None,
                )
                if worst is None:
                    raise ShedError(
                        f"priority queue full ({self.bound}) of rank<="
                        f"{rank} work")
                evicted = self._lanes[worst].pop()  # newest of the worst
                self._size -= 1
            self._lanes.setdefault(rank, collections.deque()).append(item)
            if rank >= 0:
                self._size += 1
            self._cv.notify()
            return evicted

    def _pop_locked(self) -> Any:  # guarded by: self._cv
        waiting = [r for r, lane in self._lanes.items() if lane]
        control = [r for r in waiting if r < 0]
        if control:
            return self._lanes[min(control)].popleft()
        r = self._guard.pick_rank(waiting)
        self._size -= 1
        return self._lanes[r].popleft()

    def get(self, timeout: float | None = None) -> Any:
        """Best-class item, FIFO within class; raises ``queue.Empty``
        on timeout (the stdlib contract the batcher loop speaks)."""
        import queue as _queue

        with self._cv:
            if not self._cv.wait_for(
                lambda: any(lane for lane in self._lanes.values()),
                timeout=timeout,
            ):
                raise _queue.Empty
            return self._pop_locked()

    def get_nowait(self) -> Any:
        import queue as _queue

        with self._cv:
            if not any(lane for lane in self._lanes.values()):
                raise _queue.Empty
            return self._pop_locked()
