"""Preemption-safe training: cooperative SIGTERM handling + resume
(counterpart of ``hops_tpu/runtime/preemption.py``).

Cloud GPUs are preemptible infrastructure: maintenance events and
scheduler evictions deliver SIGTERM with a grace window. The reference
has no story here (a killed run restarts from scratch — SURVEY.md §5
"no auto-resume of a killed run"). The pattern is cooperative: a signal
cannot safely interrupt a step whose kernels are queued on the card, so
the handler only sets a flag and the training loop checks it at step
boundaries — checkpoint, then exit cleanly, and the restarted job
resumes via :func:`hops_tpu_torch.runtime.checkpoint.restore_or_init`.

Multihost: a maintenance event may SIGTERM hosts at slightly different
times, but every process must leave the collective at the SAME step or
the stragglers deadlock in their next all-reduce. ``should_stop
(sync=True)`` agrees globally (a ``MAX`` all-reduce of one int32 over
the ``torch.distributed`` process group), so the loop exits coherently.

    guard = PreemptionGuard()
    state, start = checkpoint.restore_or_init(state)
    with CheckpointManager() as ckpt:
        for step in range(start, num_steps):
            state, metrics = train_step(state, batch)
            if guard.should_stop(sync=multihost.process_count() > 1):
                ckpt.save(step, state, force=True)
                break
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Any

import torch
import torch.distributed as dist

from hops_tpu_torch.parallel.multihost import process_count
from hops_tpu_torch.runtime import flight
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.spans import StepTimer

log = get_logger(__name__)


def _first_leaf(batch: Any) -> Any:
    """The first array of a dict / tuple / list nesting (dicts in key
    order, as the JAX package walks a pytree)."""
    if isinstance(batch, dict):
        return _first_leaf([batch[k] for k in sorted(batch)])
    if isinstance(batch, (list, tuple)):
        for item in batch:
            leaf = _first_leaf(item)
            if leaf is not None:
                return leaf
        return None
    return batch


def _batch_examples(batch: Any) -> int | None:
    """Leading-dim row count of a batch of tensors or numpy arrays (None
    if shapeless)."""
    try:
        shape = getattr(_first_leaf(batch), "shape", ())
        return int(shape[0]) if len(shape) >= 1 else None
    except Exception:  # noqa: BLE001 — telemetry must not fail the step
        return None


class PreemptionGuard:
    """Flag-based cooperative preemption notice.

    Installs handlers for ``signals`` (default SIGTERM) that set a
    thread-safe flag and chain to any previous handler. The training
    loop polls :meth:`should_stop` at step boundaries; nothing is
    interrupted mid-dispatch. Use as a context manager (or call
    :meth:`uninstall`) to restore the previous handlers.
    """

    def __init__(self, signals: tuple = (signal.Signals.SIGTERM,), install: bool = True):
        self._flag = threading.Event()
        self._signals = tuple(signals)
        self._previous: dict[Any, Any] = {}
        self._sync_polls = 0  # should_stop(sync=True) decimation counter
        if install:
            self.install()

    # -- lifecycle -----------------------------------------------------------

    def install(self) -> "PreemptionGuard":
        if self._previous:
            return self  # already installed: re-chaining would make the
            # handler its own "previous" and recurse on delivery
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def __enter__(self) -> "PreemptionGuard":
        if not self._previous:
            self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handler(self, signum, frame) -> None:
        log.warning("preemption notice (signal %s): will stop at the next "
                    "step boundary", signum)
        # Signal-handler context: flight.record is async-signal-unsafe
        # in theory (it takes a lock) but never blocks on anything that
        # could be interrupted mid-hold by THIS handler, and by
        # contract it never raises.
        flight.record("preemption", signal=int(signum))
        self._flag.set()
        prev = self._previous.get(signum)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    # -- polling -------------------------------------------------------------

    def notice(self) -> None:
        """Programmatic preemption (tests, external watchers)."""
        self._flag.set()

    def should_stop(self, sync: bool = False, sync_every: int = 1) -> bool:
        """True once a preemption notice arrived.

        ``sync=True``: agree across ALL processes (any-host max) so a
        multihost loop exits at one coherent step boundary. Costs one
        tiny all-reduce per poll. ``sync_every=k`` decimates that cost:
        only every k-th poll performs the all-reduce (an internal poll
        counter, shared across hosts because every host polls once per
        step); the polls in between return False even when the LOCAL
        flag is set, so an agreed stop still lands on a common
        k-boundary — a host that answered its own flag early would
        leave the stragglers deadlocked in their next collective.
        """
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        local = self._flag.is_set()
        if not sync or process_count() == 1:
            return local
        poll = self._sync_polls
        self._sync_polls += 1
        if poll % sync_every:
            return False  # off-boundary: defer so every host agrees
        # NCCL reduces tensors on the card, gloo on the host.
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        flag = torch.tensor([int(local)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed and not local:
            log.warning("another host was preempted: stopping at this "
                        "step boundary")
            self._flag.set()
        return agreed


def run_preemptible(
    train_step,
    state: Any,
    batches,
    *,
    directory: str | None = None,
    save_every: int = 100,
    sync: bool | None = None,
    sync_every: int = 1,
    guard: PreemptionGuard | None = None,
    max_recoveries: int = 0,
    recovery_policy: Any = None,
):
    """Checkpointed, preemption-safe training loop.

    Resumes from the latest checkpoint under ``directory`` (the active
    run's ``checkpoints/`` by default), steps through ``batches``,
    saves every ``save_every`` steps, and on preemption saves once more
    and returns early. Returns ``(state, last_metrics, completed_steps)``.

    ``batches`` is either a plain iterable — steps already completed
    before resume are drawn and discarded — or a callable
    ``batches(start_step) -> iterable`` that produces the stream
    already fast-forwarded (e.g. a ``featurestore.DataLoader``, or
    ``lambda k: data.batches(batch_size, num_batches, start=k)`` on a
    ``SyntheticClassData``), so resume skips no data materialization at
    all.

    Resumable iterators (anything exposing ``state_dict`` /
    ``load_state_dict`` — the loader pipeline's iterators): each
    checkpoint save also writes a data-state sidecar
    (``checkpoint.save_data_state``), and resume repositions the
    iterator from the restored step's sidecar, so the exact remaining
    batch stream replays deterministically.

    ``sync_every=k`` decimates the multihost stop-agreement all-reduce
    to every k-th step (see :meth:`PreemptionGuard.should_stop`).

    **Supervisor mode** (``max_recoveries > 0``): a transient step or
    feed failure no longer kills the run. The exception is caught, the
    state is re-restored from the newest *valid* checkpoint (a corrupt
    latest step is quarantined by ``CheckpointManager.restore``), the
    batch stream is rebuilt at the restored position, and the loop
    resumes — up to ``max_recoveries`` times, backing off between
    attempts under ``recovery_policy`` (a ``resilience.RetryPolicy``;
    default: 3 attempts irrelevant here, only its delay schedule is
    used). Each recovery increments ``hops_tpu_run_recoveries_total``.
    Requires ``batches`` to be re-derivable: a callable, a resumable
    iterator, or a re-iterable sequence (a one-shot generator cannot
    be replayed and exhausts recovery). Preemption notices and
    ``KeyboardInterrupt``/``SystemExit`` are never treated as
    recoverable.
    """
    from hops_tpu_torch.runtime.resilience import RetryPolicy
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    own_guard = guard is None
    guard = guard or PreemptionGuard()
    # The crash path of the flight recorder: an unhandled failure in
    # this (supervised) loop dumps the event ring to the rundir.
    flight.install_crash_handler()
    if sync is None:
        sync = process_count() > 1
    policy = recovery_policy or RetryPolicy(base_delay_s=0.05, max_delay_s=5.0)
    import random

    backoff_rng = random.Random(policy.seed) if policy.seed is not None else None
    m_recoveries = REGISTRY.counter(
        "hops_tpu_run_recoveries_total",
        "Supervisor recoveries (re-restore + resume after a transient "
        "step/feed failure), per loop",
        labels=("loop",),
    )
    recoveries = 0
    try:
        while True:
            try:
                return _run_attempt(
                    train_step, state, batches, directory=directory,
                    save_every=save_every, sync=sync, sync_every=sync_every,
                    guard=guard)
            except Exception as e:  # noqa: BLE001 — bounded supervisor retry
                if recoveries >= max_recoveries:
                    raise
                recoveries += 1
                m_recoveries.inc(loop="preemptible")
                flight.record("recovery", loop="preemptible",
                              attempt=recoveries,
                              error=f"{type(e).__name__}: {e}")
                pause = policy.delay(recoveries - 1, backoff_rng)
                log.warning(
                    "run_preemptible: transient failure (%s: %s); recovery "
                    "%d/%d — re-restoring from checkpoint in %.2fs",
                    type(e).__name__, e, recoveries, max_recoveries, pause)
                time.sleep(pause)
    finally:
        if own_guard:
            guard.uninstall()


def _run_attempt(
    train_step,
    state: Any,
    batches,
    *,
    directory: str | None,
    save_every: int,
    sync: bool,
    sync_every: int,
    guard: PreemptionGuard,
):
    """One incarnation of the train loop: restore, step, checkpoint.
    Raises on step/feed failure — the supervisor in
    :func:`run_preemptible` decides whether that is fatal."""
    from hops_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        load_data_state,
        restore_or_init,
    )

    state, start = restore_or_init(state, directory)
    metrics = None
    step = start - 1
    src = batches(start) if callable(batches) else batches
    resumable = hasattr(src, "state_dict") and hasattr(src, "load_state_dict")
    data_state = load_data_state(directory, start - 1) if start else None
    if resumable and data_state is not None:
        # The sidecar's position (next-unyielded batch at save time) is
        # authoritative — it repositions even streams the callable path
        # already fast-forwarded, covering iterators whose position is
        # not a pure function of the step count.
        src.load_state_dict(data_state)
    if callable(batches) or (resumable and data_state is not None):
        stream = enumerate(src, start=start)
    else:
        stream = enumerate(src)
    # Step-cadence telemetry: step time, steps/examples counters, and
    # the heartbeat gauges — the signal a diagnostics.Watchdog(
    # watch_heartbeat_gauge="preemptible") reads instead of needing an
    # explicit heartbeat() call wired into the loop.
    timer = StepTimer(loop="preemptible")
    timer.arm()
    with CheckpointManager(directory, save_interval_steps=save_every) as ckpt:
        saved = ran = False
        for step, batch in stream:
            if step < start:
                continue  # consumed by a previous incarnation
            ran = True
            state, metrics = train_step(state, batch)
            timer.tick(examples=_batch_examples(batch))
            saved = ckpt.save(step, state)  # interval save
            if saved and resumable:
                ckpt.save_data_state(step, src.state_dict())
            if guard.should_stop(sync=sync, sync_every=sync_every):
                if not saved:
                    # A published step is never overwritten, even
                    # with force=True — only save if the interval
                    # save didn't just write this step.
                    ckpt.save(step, state, force=True)
                    if resumable:
                        ckpt.save_data_state(step, src.state_dict())
                log.warning("preempted: checkpointed step %d, exiting "
                            "cleanly", step)
                break
        else:
            # Normal completion: make the final state durable too —
            # otherwise up to save_every-1 finished steps would be
            # redone by the next incarnation after a hard kill.
            if ran and not saved:
                ckpt.save(step, state, force=True)
                if resumable:
                    ckpt.save_data_state(step, src.state_dict())
        ckpt.wait()
    return state, metrics, step + 1
