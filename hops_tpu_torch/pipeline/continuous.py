"""Continuous training with eval-gated live cutover into the serving
fleet — the platform's closed loop (the counterpart of
``hops_tpu/pipeline/continuous.py``, copied with the port's imports).

The reference platform's defining property is not any one subsystem but
the loop through all of them: streaming ingest feeds training, training
feeds the model repo, the repo feeds serving, and the whole thing runs
*continuously* while brokers hiccup, trainers die, and bad candidates
appear. This module is that loop, built from the pieces the previous
PRs proved in isolation:

- **Streaming spans, exactly once.** A
  :class:`~hops_tpu_torch.featurestore.StreamingSource` tails the topic with
  a durable consumer group. Delivery is at-least-once (the
  Materializer's offset discipline: commit only after the work is
  durable); convergence to *effectively-once training* comes from the
  :class:`SpanLedger` — a checkpoint-sidecar JSONL whose entries tile
  the consumed byte range of the topic. The group offset commits only
  AFTER the ledger entries covering it are fsynced next to the
  checkpoint, so a crash replays uncommitted spans and the ledger
  dedupes the overlap. The bar is the TensorFlow paper's: resume from
  consistent state without double-applying data.

- **The rollback protocol.** Model state and ledger move together:
  every checkpoint save flushes the ledger entries for the steps it
  contains, then commits the offset. A restore that falls back to step
  N truncates the ledger to entries with ``step <= N`` and repositions
  the stream at the truncated end — spans past N replay against the
  rolled-back state and land in the ledger exactly once. Provable from
  the file: entries are disjoint, contiguous, and step-monotonic
  (:meth:`SpanLedger.verify`).

- **Eval gate + cutover.** Every ``eval_every`` steps the segment ends,
  a held-out eval scores the candidate, and only an improvement (per
  ``mode``/``min_delta``) is pushed to the model registry and rolled
  into the serving fleet via the breaker-judged rollout
  (:mod:`hops_tpu_torch.modelrepo.fleet.rollout`) — which itself rolls back
  on a canary breaker trip. An eval regression never reaches the
  fleet; a breaker-tripped canary never replaces the incumbent. Both
  outcomes land on the flight recorder (``eval_gate`` / ``cutover``
  events) and on metrics.

Held to the JAX package's loop in ``tests/test_torch_continuous.py``:
broker faults, poison records, a SIGKILLed trainer mid-span, and a
mid-rollout replica kill, with the ledger accounting every span exactly
once and zero client-visible serving errors.

One difference from the JAX loop: a torch train step updates its state
in place (``optimizer.step()``), so a passed candidate is handed to the
cutover thread as a :func:`snapshot_state` copy taken on the training
thread (see :class:`_CutoverWorker`).
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from hops_tpu_torch.runtime import flight
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.runtime.preemption import PreemptionGuard, run_preemptible
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

LEDGER_FILENAME = "span_ledger.jsonl"

_m_records = REGISTRY.counter(
    "hops_tpu_continuous_records_total",
    "Streamed records seen by the continuous trainer, by disposition "
    "(trained = entered a span ledger entry, deduped = replayed offsets "
    "the ledger already covered)",
    labels=("result",),
)
_m_spans = REGISTRY.counter(
    "hops_tpu_continuous_spans_trained_total",
    "Training spans (ledger entries) the continuous loop produced",
)
_m_gates = REGISTRY.counter(
    "hops_tpu_continuous_eval_gates_total",
    "Eval-gate decisions on continuous-training candidates",
    labels=("outcome",),
)
_m_cutovers = REGISTRY.counter(
    "hops_tpu_continuous_cutovers_total",
    "Candidate cutovers into the registry/fleet, by rollout outcome "
    "(pushed = registry only, completed / rolled_back = fleet rollout)",
    labels=("outcome",),
)
_m_gate_seconds = REGISTRY.histogram(
    "hops_tpu_continuous_eval_gate_seconds",
    "Held-out eval latency per gate (training is paused while it runs)",
    buckets=(0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0),
)
_m_snapshot_seconds = REGISTRY.histogram(
    "hops_tpu_continuous_snapshot_seconds",
    "Training-thread time to snapshot a passed candidate for its cutover",
    buckets=(0.0001, 0.001, 0.01, 0.1, 1.0, 10.0),
)


# -- the span ledger ----------------------------------------------------------


@dataclasses.dataclass
class SpanEntry:
    """One trained span: a byte range of the topic log and the training
    step whose update contains it."""

    first: int  #: starting byte offset of the span (inclusive)
    last: int  #: ending byte offset (exclusive — the next span's first)
    records: int  #: records actually trained (poison records excluded)
    step: int  #: the training step that consumed this span

    def to_json(self) -> str:
        return json.dumps({"first": self.first, "last": self.last,
                           "records": self.records, "step": self.step},
                          separators=(",", ":"))


class SpanLedger:
    """The durable account of what training has consumed.

    A JSONL sidecar (``span_ledger.jsonl``) in the checkpoint directory:
    one :class:`SpanEntry` per line, appended with flush + fsync BEFORE
    the consumer offset commits. Entries tile the consumed byte range of
    the topic contiguously and disjointly, in step order — which makes
    exactly-once training *provable from the file* (:meth:`verify`)
    rather than asserted by the code that must uphold it.

    Crash windows, by construction:

    - torn final line (died mid-append): the entry was not durable, the
      offset was not committed — the span replays and re-appends; the
      torn tail is truncated on load.
    - entries flushed, commit missed: replayed records are covered
      (``offset < end_offset``) and deduped by the stream.
    - checkpoint fell back to step N: :meth:`truncate_to_step` drops
      the orphaned ``step > N`` entries (their updates are not in the
      restored state) and the spans re-train, re-appending once.

    **Compaction** (:meth:`compact`): the ledger would otherwise grow
    one line per span for the loop's lifetime. Fully-committed history
    — entries no restorable checkpoint can ever roll back behind — is
    folded into a single *base line* at the top of the file
    (``{"compact": 1, first, last, records, step, entries}``): the
    covered range, record count, and provability survive (``verify``
    still proves contiguity ACROSS the compaction boundary: the first
    retained entry must continue exactly at the base's ``last``), only
    the per-span granularity of the folded prefix is given up. The
    caller chooses the fold horizon; it must be ≤ the oldest step a
    checkpoint restore could land on (``truncate_to_step`` below a
    compacted base cannot un-fold — it warns loudly and keeps the
    base, because the folded spans' updates are in every restorable
    checkpoint by the caller's own contract).

    Single-writer by contract (the training loop); readers (tests,
    accounting) may open their own instance against the same file.
    """

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.path = self.directory / LEDGER_FILENAME
        self._entries: list[SpanEntry] = []
        self._base: SpanEntry | None = None  # folded history (compaction)
        self._base_folded = 0  # entries the base line stands for
        self._load()

    def _load(self) -> None:
        if not self.path.exists():
            return
        raw = self.path.read_bytes()
        good_bytes = 0
        for i, line in enumerate(raw.splitlines(keepends=True)):
            if not line.endswith(b"\n"):
                break  # torn tail: the append died mid-line
            try:
                d = json.loads(line)
                if d.get("compact"):
                    # The base-offset line: valid only as line 0 (it is
                    # written only by the atomic compaction rewrite).
                    if i != 0:
                        break
                    self._base = SpanEntry(
                        first=int(d["first"]), last=int(d["last"]),
                        records=int(d["records"]), step=int(d["step"]))
                    self._base_folded = int(d.get("entries", 0))
                    good_bytes += len(line)
                    continue
                entry = SpanEntry(first=int(d["first"]), last=int(d["last"]),
                                  records=int(d["records"]),
                                  step=int(d["step"]))
            except (ValueError, KeyError, TypeError):
                break  # treat an unparsable line like a torn tail
            self._entries.append(entry)
            good_bytes += len(line)
        if good_bytes < len(raw):
            log.warning(
                "span ledger %s: truncating %d torn byte(s) after %d valid "
                "entries (the crash that tore it also left the span "
                "uncommitted — it will replay)",
                self.path, len(raw) - good_bytes, len(self._entries))
            with self.path.open("r+b") as f:
                f.truncate(good_bytes)
                f.flush()
                os.fsync(f.fileno())

    # -- reads ---------------------------------------------------------------

    @property
    def entries(self) -> list[SpanEntry]:
        return list(self._entries)

    @property
    def base(self) -> SpanEntry | None:
        """The compaction base: folded fully-committed history, or None
        when the ledger has never been compacted."""
        return self._base

    def __len__(self) -> int:
        return len(self._entries)

    def start_offset(self) -> int | None:
        if self._base is not None:
            return self._base.first
        return self._entries[0].first if self._entries else None

    def end_offset(self) -> int | None:
        """The exclusive end of the covered range — the offset training
        is durably caught up to (commit target)."""
        if self._entries:
            return self._entries[-1].last
        return self._base.last if self._base is not None else None

    def covered(self, offset: int) -> bool:
        """Is a record starting at ``offset`` inside a trained span?"""
        if (self._base is not None
                and self._base.first <= offset < self._base.last):
            return True
        firsts = [e.first for e in self._entries]
        i = bisect.bisect_right(firsts, offset) - 1
        return i >= 0 and offset < self._entries[i].last

    def records_total(self) -> int:
        base = self._base.records if self._base is not None else 0
        return base + sum(e.records for e in self._entries)

    # -- writes --------------------------------------------------------------

    def append(self, entries: list[SpanEntry]) -> None:
        """Durably append ``entries`` (flush + fsync) — the caller may
        commit the consumer offset once this returns."""
        if not entries:
            return
        prev_end = self.end_offset()
        for e in entries:
            if prev_end is not None and e.first != prev_end:
                raise ValueError(
                    f"span ledger {self.path}: entry [{e.first}, {e.last}) "
                    f"does not continue the covered range ending at "
                    f"{prev_end} — coverage must stay contiguous")
            prev_end = e.last
        with self.path.open("ab") as f:
            for e in entries:
                f.write(e.to_json().encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        self._entries.extend(entries)

    def _rewrite(self) -> None:
        """Atomically rewrite the file from memory (base line first)."""
        tmp = self.path.with_suffix(".jsonl.tmp")
        with tmp.open("wb") as f:
            if self._base is not None:
                b = self._base
                f.write(json.dumps(
                    {"compact": 1, "first": b.first, "last": b.last,
                     "records": b.records, "step": b.step,
                     "entries": self._base_folded},
                    separators=(",", ":")).encode() + b"\n")
            for e in self._entries:
                f.write(e.to_json().encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def truncate_to_step(self, step: int) -> int:
        """Drop entries trained after checkpoint ``step`` (their updates
        are not in the restored state and their spans will replay).
        Returns the number of entries dropped."""
        if self._base is not None and step < self._base.step:
            # The restore landed BEHIND compacted history. Compaction's
            # contract (fold only steps every restorable checkpoint
            # already contains) makes this unreachable in a correct
            # deployment; if it happens anyway, the folded spans cannot
            # be un-folded — keep the base, shout, and let the stream
            # resume from its end rather than double-train the fold.
            log.error(
                "span ledger %s: restore at step %d is behind the "
                "compaction base (step %d) — compacted spans cannot "
                "replay; resuming from the base boundary",
                self.path, step, self._base.step)
            step = self._base.step
        keep = [e for e in self._entries if e.step <= step]
        dropped = len(self._entries) - len(keep)
        if dropped:
            self._entries = keep
            self._rewrite()
            log.warning(
                "span ledger %s: truncated %d entr%s past step %d — their "
                "spans replay against the restored state",
                self.path, dropped, "y" if dropped == 1 else "ies", step)
        return dropped

    def compact(self, up_to_step: int, retain_entries: int = 8) -> int:
        """Fold entries with ``step <= up_to_step`` into the base line
        (always retaining the newest ``retain_entries`` for span-level
        forensics). ``up_to_step`` MUST be at most the oldest step a
        checkpoint restore can land on — folded spans can never be
        truncated back out. Returns entries folded. Crash-safe: the
        rewrite is atomic (tmp + fsync + rename), so a crash leaves
        either the old or the new file, both self-consistent."""
        foldable = [e for e in self._entries if e.step <= int(up_to_step)]
        if retain_entries > 0:
            foldable = foldable[:max(0, len(self._entries) - retain_entries)]
        if not foldable:
            return 0
        first = self._base.first if self._base is not None else foldable[0].first
        records = (self._base.records if self._base is not None else 0)
        records += sum(e.records for e in foldable)
        self._base = SpanEntry(
            first=first, last=foldable[-1].last, records=records,
            step=foldable[-1].step)
        self._base_folded += len(foldable)
        self._entries = self._entries[len(foldable):]
        self._rewrite()
        log.info(
            "span ledger %s: compacted %d entr%s into base [%d, %d) "
            "(%d live lines remain)",
            self.path, len(foldable), "y" if len(foldable) == 1 else "ies",
            self._base.first, self._base.last, len(self._entries))
        return len(foldable)

    def reset(self) -> None:
        """Fresh start (step 0 with no checkpoint): nothing trained is
        durable, so nothing may stay accounted."""
        if self._entries or self._base is not None:
            log.warning("span ledger %s: reset discarded %d entries (fresh "
                        "start with no restorable checkpoint)", self.path,
                        len(self._entries) + self._base_folded)
        self._entries = []
        self._base = None
        self._base_folded = 0
        if self.path.exists():
            self.path.unlink()

    # -- the proof -----------------------------------------------------------

    def verify(self) -> dict[str, Any]:
        """The exactly-once accounting: entries must be contiguous
        (every byte of the consumed range in exactly one span),
        disjoint (no byte twice), and step-monotonic — INCLUDING across
        the compaction boundary: the first retained entry must continue
        exactly at the base's end, at a step not before the base's. The
        chaos e2e asserts this plus external coverage (every published
        record's offset inside the range, counts matching)."""
        contiguous = disjoint = steps_monotonic = True
        chain = (
            [self._base] if self._base is not None else []
        ) + self._entries
        for a, b in zip(chain, chain[1:]):
            if b.first != a.last:
                contiguous = False
            if b.first < a.last:
                disjoint = False
            if b.step < a.step:
                steps_monotonic = False
        return {
            "entries": len(self._entries),
            "compacted_entries": self._base_folded,
            "records": self.records_total(),
            "start": self.start_offset(),
            "end": self.end_offset(),
            "contiguous": contiguous,
            "disjoint": disjoint,
            "steps_monotonic": steps_monotonic,
        }


# -- the span stream ----------------------------------------------------------


class SpanStream:
    """The resumable batch stream ``run_preemptible`` trains on.

    Implements both halves of the loop's batches contract: it is the
    *callable* (``stream(start)`` repositions from the ledger and
    returns itself) and the *resumable iterator* (``state_dict`` /
    ``load_state_dict``). The positioning protocol:

    - ``stream(0)`` (no restorable checkpoint): reset the ledger and
      rewind the source to its initial offset — everything replays into
      the fresh state.
    - ``stream(start > 0)`` (restored at ``start - 1``): truncate the
      ledger to ``step <= start - 1`` and position the source at the
      truncated end — the committed group offset is never trusted past
      a restore, the ledger is the authority.
    - ``state_dict()`` is called by ``run_preemptible`` right after a
      checkpoint save lands: it flushes the pending ledger entries
      (fsync) and THEN commits the group offset — the at-least-once
      order the whole design hangs on.

    ``__next__`` polls the streaming source until at least
    ``min_records`` fresh (non-deduped) records arrive, collates them
    into one batch, and stages the span's ledger entry. Segment
    boundaries: iteration stops at the next ``eval_every`` multiple (the
    eval gate runs between segments), at ``max_steps``, on
    ``stop_when()``, or — with ``stop_on_idle`` — once the topic stays
    drained for ``idle_grace_s``.
    """

    def __init__(
        self,
        source: Any,
        directory: str | Path,
        *,
        collate: Callable[[list], Any] | None = None,
        min_records: int = 1,
        max_records: int = 256,
        eval_every: int = 50,
        max_steps: int | None = None,
        poll_interval_s: float = 0.02,
        stop_when: Callable[[], bool] | None = None,
        stop_on_idle: bool = False,
        idle_grace_s: float = 1.0,
        compact_after: int | None = 1024,
        compact_keep_steps: int | None = None,
    ):
        if min_records < 1 or max_records < min_records:
            raise ValueError(
                f"need 1 <= min_records <= max_records, got "
                f"{min_records}/{max_records}")
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every}")
        if compact_after is not None and compact_after < 1:
            raise ValueError(
                f"compact_after must be >= 1 or None, got {compact_after}")
        self.source = source
        self.ledger = SpanLedger(directory)
        self.collate = collate
        self.min_records = min_records
        self.max_records = max_records
        self.eval_every = eval_every
        self.max_steps = max_steps
        self.poll_interval_s = poll_interval_s
        self.stop_when = stop_when
        self.stop_on_idle = stop_on_idle
        self.idle_grace_s = idle_grace_s
        # Ledger compaction: once the ledger holds more than
        # `compact_after` live lines, history older than
        # `compact_keep_steps` (default: generous — 20x the checkpoint
        # retention window of max_to_keep=3 eval segments) folds into
        # the base line. None disables.
        self.compact_after = compact_after
        self.compact_keep_steps = (
            compact_keep_steps if compact_keep_steps is not None
            else 60 * eval_every)
        self._initial_offset = source.offset
        self._step = 0
        self._segment_end = eval_every
        self._pending: list[SpanEntry] = []
        # The next byte the ledger does NOT yet cover (pending entries
        # included). Entries always start here, so coverage tiles every
        # consumed byte — even across polls that consumed only poison
        # records and parsed nothing.
        self._cursor = self._initial_offset
        self.finished = False  # a terminal stop (idle/max_steps/stop_when)

    # -- run_preemptible's callable-batches contract --------------------------

    def __call__(self, start: int) -> "SpanStream":
        self._pending.clear()
        if start == 0:
            # Fresh state: nothing the ledger accounts is in it. A
            # restarted process whose checkpoints were ALL lost still
            # holds the committed group offset — rewind to the ledger's
            # own start so the dead incarnation's spans retrain instead
            # of silently vanishing into a zero state.
            ledger_start = self.ledger.start_offset()
            self.ledger.reset()
            self.source.offset = (self._initial_offset if ledger_start is None
                                  else min(self._initial_offset, ledger_start))
        else:
            self.ledger.truncate_to_step(start - 1)
            end = self.ledger.end_offset()
            # The ledger is the restore authority: reposition at its
            # truncated end regardless of what the group offset or the
            # in-memory consumer position say.
            self.source.offset = end if end is not None else self._initial_offset
        self._cursor = self.source.offset
        self._step = start
        self._segment_end = ((start // self.eval_every) + 1) * self.eval_every
        if self.max_steps is not None:
            self._segment_end = min(self._segment_end, self.max_steps)
        return self

    # -- resumable-iterator contract ------------------------------------------

    def state_dict(self) -> dict:
        """Flush pending spans to the ledger, commit the offset, and
        snapshot the position. Called by ``run_preemptible`` right
        after the checkpoint save for the current step — the ledger
        entries become durable WITH the checkpoint, and only then does
        the group offset move."""
        if self._pending:
            self.ledger.append(self._pending)
            _m_spans.inc(len(self._pending))
            self._pending.clear()
        if (self.compact_after is not None
                and len(self.ledger) > self.compact_after):
            # Fold only steps far behind anything a checkpoint restore
            # could land on (the compaction contract): the ledger stops
            # growing a line per span forever, exactly-once stays
            # provable across the fold.
            self.ledger.compact(self._step - self.compact_keep_steps)
        end = self.ledger.end_offset()
        if end is not None:
            self.source.offset = max(int(self.source.offset), end)
        self.source.commit()
        return {"version": 1, "offset": int(self.source.offset),
                "step": self._step}

    def load_state_dict(self, state: dict) -> None:
        # __call__ already repositioned from the ledger; the sidecar
        # only cross-checks. A mismatch means the sidecar and the
        # ledger disagree about the same save — the ledger (fsynced
        # first) wins, loudly.
        if int(state.get("offset", -1)) != int(self.source.offset):
            log.warning(
                "span stream: data-state sidecar offset %s disagrees with "
                "the ledger position %s — trusting the ledger",
                state.get("offset"), self.source.offset)
        self._step = int(state.get("step", self._step))

    # -- iteration ------------------------------------------------------------

    def __iter__(self) -> "SpanStream":
        return self

    def __next__(self) -> Any:
        if self.finished:
            raise StopIteration
        if self.max_steps is not None and self._step >= self.max_steps:
            self.finished = True
            raise StopIteration
        if self._step >= self._segment_end:
            raise StopIteration  # segment boundary: the eval gate runs now
        values: list = []
        last: int | None = None
        deduped = 0
        idle_since: float | None = None
        while len(values) < self.min_records:
            if self.stop_when is not None and self.stop_when():
                self.finished = True
                if not values:
                    raise StopIteration
                break
            span = self.source.poll_span(self.max_records - len(values))
            if span is None:
                if values:
                    break  # train what arrived rather than hold the step
                if self.stop_on_idle and self.source.lag() == 0:
                    now = time.monotonic()
                    if idle_since is None:
                        idle_since = now
                    elif now - idle_since >= self.idle_grace_s:
                        self.finished = True
                        raise StopIteration
                time.sleep(self.poll_interval_s)
                continue
            idle_since = None
            # Dedupe against the coverage cursor (flushed ledger +
            # pending entries): replayed offsets below it are already
            # in the trained state.
            fresh = [(o, v) for o, v in zip(span.offsets, span.values)
                     if o >= self._cursor]
            deduped += span.records - len(fresh)
            last = span.last
            values.extend(v for _, v in fresh)
        if deduped:
            _m_records.inc(deduped, result="deduped")
            flight.record("span_replayed", stream=getattr(
                self.source, "name", "?"), deduped=deduped, step=self._step)
        if not values:
            raise StopIteration
        _m_records.inc(len(values), result="trained")
        # The entry starts at the cursor, not at the first parsed
        # record: consumed-but-unparsable bytes (poison at the head of
        # a poll, or a whole poisoned poll) stay inside the covered
        # range, or the ledger's contiguity invariant would wedge the
        # loop on exactly the wire corruption it exists to survive.
        self._pending.append(SpanEntry(
            first=int(self._cursor), last=int(last), records=len(values),
            step=self._step))
        self._cursor = int(last)
        self._step += 1
        return self.collate(values) if self.collate is not None else values


# -- publishing ----------------------------------------------------------------


class RegistryFleetPublisher:
    """Push a passing candidate to the model registry and roll it into
    the serving fleet (PR 9's breaker-judged rollout — automatic
    rollback on a canary breaker trip is its designed recovery path).

    ``export_fn(state, step, metric) -> model meta`` registers the
    version (``registry.export`` / ``registry.save_lm`` — the caller
    owns the artifact format); with a ``fleet`` handle the new version
    is then rolled out. Without one, publishing stops at the registry
    (the cutover outcome is ``pushed``).
    """

    def __init__(self, name: str,
                 export_fn: Callable[[Any, int, float], dict],
                 fleet: Any = None,
                 rollout_kwargs: dict[str, Any] | None = None):
        self.name = name
        self.export_fn = export_fn
        self.fleet = fleet
        self.rollout_kwargs = dict(rollout_kwargs or {})

    def publish(self, state: Any, step: int, metric: float) -> dict[str, Any]:
        meta = self.export_fn(state, step, metric)
        version = meta.get("version") if isinstance(meta, dict) else None
        result: dict[str, Any] = {"version": version, "outcome": "pushed"}
        if self.fleet is not None:
            summary = self.fleet.roll_out(version, **self.rollout_kwargs)
            result["outcome"] = summary["outcome"]
            result["rollout"] = summary
        return result


class _CutoverWorker:
    """FIFO background driver for cutover rollouts.

    A passed gate used to run ``publisher.publish`` inline, pausing
    training for the whole registry push + canary-judged fleet rollout
    (~2 s per passed gate on the CPU tier) — visible as a freshness-lag
    dip at the following gate. This worker moves the publish onto ONE
    background thread so the next segment trains while the fleet bakes
    the canary.

    Semantics are preserved exactly, not approximately:

    - **Version order**: one thread, one queue — rollouts reach the
      fleet in gate order, never interleaved.
    - **The comparison bar**: results are NOT folded into ``best`` by
      the worker. The training loop calls :meth:`drain` right before
      judging the next gate (and once more before returning), so every
      gate decision sees all prior cutover outcomes — the same
      happens-before as the inline call, minus the training pause.
    - **Failures**: an exception from ``publish`` is re-raised out of
      :meth:`drain` on the training thread, where the inline version
      would have raised it; results that completed first still fold.

    The reference the gate judged is the reference the publisher
    exports. A torch train step updates its state in place (the JAX
    loop's train step returns a fresh pytree, so it hands over a
    reference), and the next segment trains while this thread exports,
    so :func:`run_continuous` submits a :func:`snapshot_state` copy
    taken on the training thread before the next step can run;
    ``tests/test_torch_continuous.py::test_cutover_exports_the_judged_parameters``
    fails when the live state is submitted instead.
    """

    def __init__(self, publisher: "RegistryFleetPublisher"):
        self._publisher = publisher
        self._cond = threading.Condition()
        self._queue: list[tuple[Any, int, float] | None] = []  # guarded by: self._cond
        self._results: list[tuple[int, float, dict | None, BaseException | None]] = []  # guarded by: self._cond
        self._inflight = 0  # guarded by: self._cond
        self._thread = threading.Thread(
            target=self._run, name="continuous-cutover", daemon=True)
        self._thread.start()

    def submit(self, state: Any, step: int, metric: float) -> None:
        with self._cond:
            self._queue.append((state, step, metric))
            self._inflight += 1
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                item = self._queue.pop(0)
            if item is None:
                return
            state, step, metric = item
            cut: dict | None = None
            err: BaseException | None = None
            try:
                cut = self._publisher.publish(state, step, metric)
            except BaseException as e:  # noqa: BLE001 — surfaced via drain()
                err = e
            with self._cond:
                self._results.append((step, metric, cut, err))
                self._inflight -= 1
                self._cond.notify_all()

    def drain(self) -> list[tuple[int, float, dict | None, BaseException | None]]:
        """Block until every submitted cutover has settled; return the
        ``(step, metric, result, error)`` tuples in submission order.
        The caller folds successful results into its bookkeeping and
        then re-raises the first error — so cutovers that completed
        before a failing publish are never lost, exactly as if each had
        run inline."""
        with self._cond:
            while self._inflight > 0:
                self._cond.wait()
            settled = self._results
            self._results = []
        return settled

    def stop(self) -> None:
        with self._cond:
            self._queue.append(None)
            self._cond.notify()
        self._thread.join(timeout=30)


def snapshot_state(state: Any) -> Any:
    """A copy of ``state`` that in-place updates of ``state`` cannot
    reach: tensors cloned on their device, modules deep-copied, numpy
    arrays copied; dicts and dataclasses (a ``TrainState``) rebuilt
    around the copies. An optimizer, or any other leaf, is kept by
    reference: an exporter reads the weights. A device copy is queued on
    the current stream, so a reader on the same stream sees the values
    of the moment of the call."""
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, nn.Module):
        return copy.deepcopy(state)
    if isinstance(state, np.ndarray):
        return state.copy()
    if isinstance(state, dict):
        return {k: snapshot_state(v) for k, v in state.items()}
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **{
            f.name: snapshot_state(getattr(state, f.name))
            for f in dataclasses.fields(state) if f.init})
    return state


# -- the loop ------------------------------------------------------------------


@dataclasses.dataclass
class ContinuousResult:
    """What a bounded continuous run did (the unbounded form never
    returns): final state, step count, gate/cutover history, and the
    ledger's own accounting."""

    state: Any
    steps: int
    gates: list[dict[str, Any]]
    cutovers: list[dict[str, Any]]
    recoveries: int
    ledger: dict[str, Any]


def _improves(metric: float, best: float | None, mode: str,
              min_delta: float) -> bool:
    if best is None:
        return True
    if mode == "max":
        return metric >= best - min_delta
    return metric <= best + min_delta


def _advance_bar(best: float | None, metric: float, mode: str) -> float:
    """The new comparison bar after an ACCEPTED candidate: only genuine
    improvement moves it. A candidate merely tolerated by ``min_delta``
    must not lower the bar, or a model regressing by less than
    ``min_delta`` per gate would ratchet it down forever and the gate
    would never catch the slow slide."""
    if best is None:
        return metric
    return max(best, metric) if mode == "max" else min(best, metric)


def run_continuous(
    train_step: Callable[[Any, Any], tuple[Any, Any]],
    state: Any,
    stream: SpanStream,
    *,
    directory: str | Path,
    eval_fn: Callable[[Any], float] | None = None,
    mode: str = "max",
    min_delta: float = 0.0,
    publisher: RegistryFleetPublisher | None = None,
    save_every: int = 10,
    max_recoveries: int = 3,
    recovery_policy: Any = None,
    guard: PreemptionGuard | None = None,
) -> ContinuousResult:
    """Drive the closed loop: train on streaming spans, gate every
    ``stream.eval_every`` steps, cut passing candidates over.

    Each segment is one ``run_preemptible`` call (restore → train →
    checkpoint, with its supervisor absorbing transient faults); the
    eval gate runs between segments, on the just-checkpointed state.
    The gate compares against the last *accepted* candidate's metric:
    a regression (worse than ``min_delta`` under ``mode``) fails the
    gate and the candidate never reaches the registry or the fleet —
    the incumbent keeps serving, which IS the rollback. A candidate
    that passes but trips the canary breaker is rolled back by the
    rollout itself; its metric is then not adopted as the bar.

    Cutovers are **asynchronous**: a passed candidate is handed to a
    single FIFO background thread (:class:`_CutoverWorker`) and the
    next segment starts training immediately — the registry push and
    canary-judged fleet rollout no longer pause the stream. Outcomes
    are settled on the training thread right before the next gate (and
    before returning), so the bar every gate judges against is
    identical to the inline ordering.

    Runs until the stream finishes (``max_steps`` / ``stop_when`` /
    idle with ``stop_on_idle``) or a preemption notice arrives.
    ``mode`` is ``"max"`` (higher is better) or ``"min"``.
    """
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    from hops_tpu_torch.runtime.resilience import RetryPolicy

    policy = recovery_policy or RetryPolicy(base_delay_s=0.05, max_delay_s=2.0)
    own_guard = guard is None
    guard = guard or PreemptionGuard()
    # A preemption notice must break a __next__ that is blocked waiting
    # for records — chain the guard into the stream's stop predicate so
    # the poll-wait loop sees it at poll cadence.
    user_stop = stream.stop_when
    stream.stop_when = lambda: guard.should_stop() or (
        user_stop() if user_stop is not None else False)
    recoveries0 = _recoveries_now()
    best: float | None = None
    gates: list[dict[str, Any]] = []
    cutovers: list[dict[str, Any]] = []
    worker = _CutoverWorker(publisher) if publisher is not None else None
    done = 0

    def fold_cutovers() -> None:
        """Settle in-flight rollouts and fold their outcomes into the
        bookkeeping (cutover history, metrics, the comparison bar).
        Runs on the training thread right before each gate decision and
        once before returning — every gate judges against a bar that
        reflects all prior cutover outcomes, same as the inline call."""
        nonlocal best
        failure: BaseException | None = None
        for cstep, cmetric, cut, err in worker.drain():
            if err is not None:
                failure = failure or err
                continue
            _m_cutovers.inc(outcome=cut["outcome"])
            flight.record("cutover", step=cstep,
                          version=cut.get("version"),
                          outcome=cut["outcome"])
            cutovers.append({"step": cstep, "metric": cmetric, **cut})
            if cut["outcome"] in ("pushed", "completed"):
                best = _advance_bar(best, cmetric, mode)
            else:
                log.warning(
                    "continuous: cutover of version %s at step %d "
                    "ended %s — the fleet rolled back, the bar "
                    "stays at %.6g",
                    cut.get("version"), cstep, cut["outcome"],
                    best if best is not None else float("nan"))
        if failure is not None:
            raise failure

    try:
        while True:
            prev_done = done
            state, _, done = run_preemptible(
                train_step, state, stream,
                directory=str(directory), save_every=save_every,
                guard=guard, max_recoveries=max_recoveries,
                recovery_policy=policy)
            preempted = guard.should_stop()
            if eval_fn is not None and done > prev_done and not preempted:
                t0 = time.monotonic()
                metric = float(eval_fn(state))
                _m_gate_seconds.observe(time.monotonic() - t0)
                if worker is not None:
                    # The previous segment trained WHILE its cutover
                    # rolled out; settle the outcome now so this gate
                    # judges against the true bar.
                    fold_cutovers()
                passed = _improves(metric, best, mode, min_delta)
                outcome = "pass" if passed else "fail"
                _m_gates.inc(outcome=outcome)
                flight.record("eval_gate", step=done, outcome=outcome,
                              metric=metric, best=best)
                gates.append({"step": done, "metric": metric,
                              "outcome": outcome, "best": best,
                              "latency_s": round(time.monotonic() - t0, 4)})
                if not passed:
                    log.warning(
                        "continuous: eval gate FAILED at step %d (%s=%.6g "
                        "vs best %.6g) — candidate held back, incumbent "
                        "keeps serving", done, mode, metric, best)
                elif worker is not None:
                    # Hand the rollout to the background worker: the
                    # next segment starts training immediately while
                    # the registry push + canary bake run off-thread,
                    # on a snapshot the next step cannot update.
                    t1 = time.monotonic()
                    judged = snapshot_state(state)
                    _m_snapshot_seconds.observe(time.monotonic() - t1)
                    worker.submit(judged, done, metric)
                else:
                    best = _advance_bar(best, metric, mode)
            if stream.finished or preempted:
                break
            if done == prev_done and not stream.finished:
                # A segment that trained nothing and did not finish is
                # a wedged stream — bail rather than spin forever.
                log.warning("continuous: segment at step %d made no "
                            "progress; stopping", done)
                break
        if worker is not None:
            fold_cutovers()  # the final segment's rollout, if any
    finally:
        if worker is not None:
            worker.stop()
        if own_guard:
            guard.uninstall()
    return ContinuousResult(
        state=state, steps=done, gates=gates, cutovers=cutovers,
        recoveries=int(_recoveries_now() - recoveries0),
        ledger=stream.ledger.verify(),
    )


def _recoveries_now() -> float:
    metric = REGISTRY.get("hops_tpu_run_recoveries_total")
    if metric is None:
        return 0.0
    try:
        return metric.value(loop="preemptible")
    except Exception:  # noqa: BLE001 — label child not created yet
        return 0.0


def collate_column_batch(columns: list[str]) -> Callable[[list], dict]:
    """A convenience collate for dict-valued records: stack the given
    columns into float arrays — ``[{"x": [...], "y": 1}, ...]`` becomes
    ``{"x": (n, d), "y": (n,)}``."""

    def collate(values: list) -> dict:
        return {c: np.asarray([v[c] for v in values], dtype=np.float64)
                for c in columns}

    return collate
