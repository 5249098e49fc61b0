"""Parallel host input pipeline: staged, resumable, instrumented
(counterpart of ``hops_tpu/featurestore/loader.py``).

The device side of training runs far ahead of a host that decodes and
assembles every batch synchronously on the driver thread — the first
scaling wall the pod-scale input work identifies (arXiv:1909.09756) and
the reason tf.data treats input as a first-class pipelined subsystem
(arXiv:1605.08695). This module is that subsystem for the port:

    source (sharded readers) -> decode/transform (bounded thread pool)
      -> batch assembly (vectorized, optionally pooled host buffers)
      -> feed.prefetch_to_device (pinned staging, H2D copies on a side
         stream)

The host side is the JAX package's, line for line, so both packages
yield the byte-identical stream for a seed; only the shard source
(``parallel.multihost``'s rank and world size) and the device end
(``torch`` tensors on the card) differ.

Design rules, in priority order:

1. **Determinism** — the threaded pipeline yields the byte-identical
   batch stream of the synchronous one. Work is planned on the consumer
   thread as an ordered sequence of ``(epoch, step)`` batch tasks; the
   pool only *executes* tasks, completion order never reorders the
   stream, and all randomness (epoch permutation, per-batch transform
   RNG) is derived from ``(seed, epoch, step)`` rather than from any
   worker-local state.
2. **Resumability** — an iterator's position is exactly
   ``(seed, epoch, step)``; :meth:`LoaderIterator.state_dict` /
   :meth:`LoaderIterator.load_state_dict` snapshot and restore it, so a
   ``CheckpointManager``/preemption restore replays the exact remaining
   stream (``runtime.preemption.run_preemptible`` does this
   automatically via the checkpoint data-state sidecar).
3. **Observability** — every stage is instrumented: queue-depth gauges
   (``hops_tpu_feed_stage_queue_depth{pipeline,stage}``), a
   decode-latency histogram (``hops_tpu_feed_decode_seconds``), a
   feed-wait histogram (``hops_tpu_feed_wait_seconds``), and the
   starvation counter ``hops_tpu_feed_starved_steps_total`` derived
   from feed-wait vs step wall time.

Per-host sharding mirrors ``DataFeeder.numpy_iterator``: with
``shard_count > 1`` every process plans the SAME seed-derived global
order and materializes only its ``batch_size / shard_count`` slice of
each global batch, so host shards are disjoint by construction.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from hops_tpu_torch.runtime import faultinject
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_STATE_VERSION = 1


# -- small structural helpers (dict/tuple/list/array pytrees; no jax) ---------


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _tree_map2(fn: Callable, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def default_collate(examples: Sequence[Any]) -> Any:
    """Stack per-example pytrees (dict/tuple/list/array) into one batch
    pytree with a new leading dimension."""
    first = examples[0]
    if isinstance(first, dict):
        return {k: default_collate([e[k] for e in examples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            default_collate([e[i] for e in examples]) for i in range(len(first))
        )
    return np.stack([np.asarray(e) for e in examples])


# -- sources ------------------------------------------------------------------


class Source:
    """A random-access example store the pipeline can read in parallel.

    Implementations must be thread-safe: ``fetch``/``decode`` (or the
    vectorized ``fetch_batch`` fast path) are called concurrently from
    decode workers. Randomness must NOT live here — the loader derives
    every index and RNG from ``(seed, epoch, step)``.
    """

    def __len__(self) -> int:
        raise NotImplementedError

    def fetch(self, indices: np.ndarray) -> list:
        """Raw records for ``indices`` (the I/O stage)."""
        raise NotImplementedError

    def decode(self, raw: Any) -> Any:
        """One raw record -> one example pytree (the CPU stage)."""
        return raw

    def fetch_batch(self, indices: np.ndarray, out: Any | None = None) -> Any:
        """Optional vectorized fast path: whole batch in one call,
        assembled into ``out`` (a matching preallocated pytree) when
        given. Default: fetch + per-record decode + collate."""
        examples = [self.decode(r) for r in self.fetch(indices)]
        batch = default_collate(examples)
        if out is not None:
            return _tree_map2(lambda dst, src: np.copyto(dst, src) or dst, out, batch)
        return batch


class ArraySource(Source):
    """In-memory pytree of arrays sharing a leading example dimension —
    the whole-split path (``DataFeeder.numpy_arrays``) and the packed-LM
    path (:meth:`from_documents`)."""

    def __init__(self, arrays: Any):
        leaves = _tree_leaves(arrays)
        if not leaves:
            raise ValueError("ArraySource needs at least one array")
        n = len(leaves[0])
        if any(len(a) != n for a in leaves):
            raise ValueError("all arrays must share the leading dimension")
        self.arrays = _tree_map(np.asarray, arrays)
        self._n = n

    @classmethod
    def from_feeder(cls, feeder) -> "ArraySource":
        """Wrap a ``DataFeeder``'s materialized split: ``(x, y)`` with a
        target, bare ``x`` without."""
        x, y = feeder.numpy_arrays()
        return cls(x if y is None else (x, y))

    @classmethod
    def from_documents(
        cls, docs, seq_len: int, eos_id: int, pad_id: int = 0,
        drop_remainder: bool = True, key: str = "tokens",
    ) -> "ArraySource":
        """LM feed: greedy-pack ragged token documents via
        ``feed.pack_documents`` into ``(n, seq_len + 1)`` rows and serve
        them as ``{key: row}`` batches — the pretraining layout
        ``make_lm_train_step`` consumes."""
        from hops_tpu_torch.featurestore.feed import pack_documents

        packed = pack_documents(docs, seq_len=seq_len, eos_id=eos_id,
                                pad_id=pad_id, drop_remainder=drop_remainder)
        return cls({key: packed})

    def __len__(self) -> int:
        return self._n

    def fetch(self, indices: np.ndarray) -> list:
        idx = np.asarray(indices)
        return [_tree_map(lambda a: a[i], self.arrays) for i in idx]

    def fetch_batch(self, indices: np.ndarray, out: Any | None = None) -> Any:
        idx = np.asarray(indices)
        if out is not None:
            return _tree_map2(
                lambda a, dst: np.take(a, idx, axis=0, out=dst),
                self.arrays, out,
            )
        return _tree_map(lambda a: np.take(a, idx, axis=0), self.arrays)


@dataclasses.dataclass
class StreamSpan:
    """One polled span of a streaming topic: decoded examples plus the
    byte-offset bookkeeping the exactly-once span ledger keys on."""

    values: list  #: decoded example values, poison records already skipped
    offsets: list[int]  #: per-record starting byte offset in the topic log
    first: int  #: span start (the pre-poll byte offset; poison bytes count)
    last: int  #: span end (exclusive byte offset — the next poll's start)
    watermark: float  #: newest event/producer timestamp in the span

    @property
    def records(self) -> int:
        return len(self.values)


class StreamingSource:
    """Unbounded pubsub-topic source for continuous training.

    Where the batch sources above are random-access over a FIXED index
    space, this tails a :mod:`~hops_tpu_torch.messaging.pubsub` topic with a
    durable consumer group and yields :class:`StreamSpan`s — batches of
    decoded records annotated with their byte-offset range. The offset
    discipline is the write-through Materializer's, inverted for
    training: delivery is **at-least-once** (the group offset commits
    only after the trained span is durably recorded in the checkpoint
    sidecar ledger — the JAX package's ``pipeline/continuous.py``), and
    convergence to **effectively-once** comes from the span ledger
    deduping replayed offsets, not from the broker.

    Telemetry: ``hops_tpu_streaming_watermark_lag_seconds{stream}``
    (now minus the newest consumed event timestamp — the freshness of
    what training has seen; it rises while the trainer stalls or the
    topic idles) and ``hops_tpu_streaming_records_total{stream}``;
    byte lag rides the consumer's own
    ``hops_tpu_pubsub_consumer_lag{topic,group}`` gauge.

    ``decode(value)`` maps one record's ``value`` payload to an example
    (default: identity). Unparsable records were already skipped (and
    counted) by the consumer; records whose decode RAISES are skipped
    and counted as poison here — a poison record must stall neither the
    stream nor the offset.
    """

    def __init__(
        self,
        topic: str,
        group: str = "continuous-trainer",
        *,
        decode: Callable[[Any], Any] | None = None,
        event_time: str | None = None,
        from_beginning: bool = True,
        name: str | None = None,
    ):
        from hops_tpu_torch.messaging import pubsub

        self.topic = topic
        self.group = group
        self.name = name or topic
        self._consumer = pubsub.Consumer(
            topic, group=group, from_beginning=from_beginning)
        self._decode = decode
        self._event_time = event_time
        self._watermark = 0.0
        labels = {"stream": self.name}
        self._m_watermark = REGISTRY.gauge(
            "hops_tpu_streaming_watermark_lag_seconds",
            "Now minus the newest event timestamp a streaming source has "
            "consumed — the training-side freshness twin of the online "
            "store's materialization lag",
            labels=("stream",)).labels(**labels)
        self._m_records = REGISTRY.counter(
            "hops_tpu_streaming_records_total",
            "Records a streaming source decoded and handed to training",
            labels=("stream",)).labels(**labels)
        self._m_poison = REGISTRY.counter(
            "hops_tpu_streaming_poison_decodes_total",
            "Records whose decode raised and were skipped by a streaming "
            "source (parse-level poison is counted by the consumer)",
            labels=("stream",)).labels(**labels)

    # -- offset discipline (the span ledger drives these) ---------------------

    @property
    def offset(self) -> int:
        """The consumer's in-memory position (uncommitted)."""
        return self._consumer.offset

    @offset.setter
    def offset(self, value: int) -> None:
        self._consumer.offset = int(value)

    def commit(self) -> None:
        """Durably commit the group offset — call ONLY after the spans
        up to :attr:`offset` are recorded in the span ledger."""
        self._consumer.commit()

    def lag(self) -> int:
        """Topic bytes not yet consumed (0 = caught up)."""
        return self._consumer.lag()

    def watermark(self) -> float:
        """Newest event timestamp consumed so far (0.0 = nothing yet)."""
        return self._watermark

    def watermark_lag_s(self) -> float:
        if not self._watermark:
            return 0.0
        return max(0.0, time.time() - self._watermark)

    # -- polling --------------------------------------------------------------

    def poll_span(self, max_records: int = 256) -> StreamSpan | None:
        """Poll the next span (None when nothing was consumed).
        ``first`` is the PRE-poll offset and ``last`` the post-poll
        offset, so ``[first, last)`` covers every consumed byte —
        including parse-level poison records the consumer skipped. A
        poll that consumed ONLY poison returns an empty span (zero
        values, nonzero byte range) rather than None: the caller's
        coverage bookkeeping must still see those bytes."""
        start = self._consumer.offset
        recs = self._consumer.poll_records(max_records)
        if not recs and self._consumer.offset == start:
            self._m_watermark.set(self.watermark_lag_s())
            return None
        first = start
        last = self._consumer.offset
        values: list = []
        offsets: list[int] = []
        for at, rec in recs:
            value = rec.get("value")
            ts = None
            if self._event_time is not None and isinstance(value, dict):
                ts = value.get(self._event_time)
            if ts is None:
                ts = rec.get("ts")
            if isinstance(ts, (int, float)):
                self._watermark = max(self._watermark, float(ts))
            if self._decode is not None:
                try:
                    value = self._decode(value)
                except Exception as e:  # noqa: BLE001 — poison must not wedge the stream
                    self._m_poison.inc()
                    log.warning(
                        "stream %s: skipping record at offset %d whose "
                        "decode raised (%s: %s)", self.name, at,
                        type(e).__name__, e)
                    continue
            values.append(value)
            offsets.append(at)
        self._m_records.inc(len(values))
        self._m_watermark.set(self.watermark_lag_s())
        return StreamSpan(values=values, offsets=offsets, first=first,
                          last=last, watermark=self._watermark)


class RecordIOSource(Source):
    """Sharded RecordIO files read through the native engine's batched
    gather (``native/recordio.read_batch``: pread fan-out, one copy per
    record).

    Global index space is the concatenation of the shards in the given
    order. Each decode worker keeps its own per-shard ``RecordReader``
    (``threading.local``): the native handle is pread-based and
    shareable, but the pure-Python fallback seeks a shared file object —
    per-thread readers are uniformly safe on both paths.
    """

    def __init__(self, paths: Sequence[str | Path],
                 decode: Callable[[bytes], Any] | None = None,
                 n_io_threads: int = 4):
        from hops_tpu_torch.native.recordio import RecordReader

        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("RecordIOSource needs at least one shard path")
        self._reader_cls = RecordReader
        lengths = []
        for p in self.paths:
            with RecordReader(p) as r:
                lengths.append(len(r))
        #: per-shard record counts, and exclusive cumulative offsets for
        #: global-index -> (shard, local-index) mapping.
        self.shard_lengths = lengths
        self._starts = np.concatenate([[0], np.cumsum(lengths)])
        self._decode = decode
        self._n_io_threads = n_io_threads
        self._local = threading.local()

    def __len__(self) -> int:
        return int(self._starts[-1])

    def _reader(self, shard: int):
        cache = getattr(self._local, "readers", None)
        if cache is None:
            cache = self._local.readers = {}
        r = cache.get(shard)
        if r is None:
            r = cache[shard] = self._reader_cls(self.paths[shard])
        return r

    def fetch(self, indices: np.ndarray) -> list:
        idx = np.asarray(indices, np.int64)
        shard_ids = np.searchsorted(self._starts, idx, side="right") - 1
        out: list = [None] * len(idx)
        for shard in np.unique(shard_ids):
            pos = np.nonzero(shard_ids == shard)[0]
            local = idx[pos] - self._starts[shard]
            records = self._reader(int(shard)).read_batch(
                local.tolist(), n_threads=self._n_io_threads)
            for p, rec in zip(pos, records):
                out[int(p)] = rec
        return out

    def decode(self, raw: bytes) -> Any:
        return self._decode(raw) if self._decode is not None else raw


# -- reusable host buffers ----------------------------------------------------


class _BufferPool:
    """Free-list of preallocated batch pytrees matching one spec.

    Workers check buffers out concurrently; the consumer recycles them
    once a yielded batch falls ``ring`` yields behind (the validity
    window a ``prefetch_to_device`` consumer, which copies to device
    immediately, never notices)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: list = []  # guarded by: self._lock

    def take(self, template: Any) -> Any:
        with self._lock:
            if self._free:
                return self._free.pop()
        return _tree_map(lambda a: np.empty_like(a), template)

    def give(self, buf: Any) -> None:
        with self._lock:
            self._free.append(buf)


# -- the loader ---------------------------------------------------------------


class DataLoader:
    """Staged parallel batch pipeline over a :class:`Source`.

    ``num_workers=0`` is the synchronous reference path (decode inline
    on the consumer thread); ``num_workers>0`` runs decode/assembly in a
    bounded thread pool with at most ``queue_depth`` batches in flight.
    Both yield the identical stream for a given ``seed``.

    Per-host sharding: ``batch_size`` is the GLOBAL batch size;
    ``shard_index``/``shard_count`` (default: this process's rank and
    world size, ``multihost.process_index()/process_count()``, when
    ``process_sharded=True``)
    select the rows this host materializes — disjoint across hosts
    because every host plans the same seed-derived order.

    ``transform(batch, rng)`` runs per batch inside the worker with a
    ``numpy.random.Generator`` derived from ``(seed, epoch, step)`` —
    deterministic under any worker count. Under ``reuse_buffers=True``
    an assembly buffer is only recycled when the transform's output
    does not alias it (checked via ``np.may_share_memory``), so
    pass-through leaves are safe — they just cost the pool a fresh
    allocation.

    ``reuse_buffers=True`` assembles batches into a pooled set of
    preallocated host arrays recycled ``queue_depth + 2`` yields later:
    zero steady-state allocation, but a yielded batch is only valid
    until then — fine for consumers that copy to device immediately
    (``device_iterator``), wrong for consumers that accumulate batches.
    """

    def __init__(
        self,
        source: Source,
        batch_size: int,
        *,
        num_epochs: int | None = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        num_workers: int = 2,
        queue_depth: int = 4,
        transform: Callable[[Any, np.random.Generator], Any] | None = None,
        process_sharded: bool = False,
        shard_index: int | None = None,
        shard_count: int | None = None,
        reuse_buffers: bool = False,
        starved_threshold: float = 0.1,
        name: str = "default",
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if num_workers < 0 or queue_depth < 1:
            raise ValueError("num_workers must be >= 0 and queue_depth >= 1")
        if process_sharded and (shard_index is None or shard_count is None):
            from hops_tpu_torch.parallel import multihost

            shard_index = multihost.process_index() if shard_index is None else shard_index
            shard_count = multihost.process_count() if shard_count is None else shard_count
        self.shard_index = shard_index or 0
        self.shard_count = shard_count or 1
        if not 0 <= self.shard_index < self.shard_count:
            raise ValueError(
                f"shard_index {self.shard_index} out of range for "
                f"shard_count {self.shard_count}")
        if batch_size % self.shard_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{self.shard_count} shards")
        if self.shard_count > 1 and not drop_remainder:
            raise ValueError(
                "sharded loading requires drop_remainder=True (every "
                "host must hold an equal, full shard)")
        if reuse_buffers and not drop_remainder:
            raise ValueError("reuse_buffers requires drop_remainder=True "
                             "(pooled buffers have one static shape)")
        n = len(source)
        if n < batch_size and drop_remainder:
            raise ValueError(
                f"source holds {n} examples < batch_size {batch_size} "
                "with drop_remainder=True: the stream would be empty")
        self.source = source
        self.batch_size = batch_size
        self.local_batch_size = batch_size // self.shard_count
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        self.transform = transform
        self.reuse_buffers = reuse_buffers
        self.starved_threshold = starved_threshold
        self.process_sharded = process_sharded
        self.name = name

    @property
    def steps_per_epoch(self) -> int:
        n = len(self.source)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's global example order — a pure function of
        ``(seed, epoch)``, so restore is O(1) (no sequential RNG stream
        to replay) and every host computes the same order."""
        n = len(self.source)
        if not self.shuffle:
            return np.arange(n)
        gen = np.random.Generator(
            np.random.PCG64(np.random.SeedSequence((self.seed, epoch))))
        return gen.permutation(n)

    def _batch_rng(self, epoch: int, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.seed, epoch, step, 0x7F)))

    def __iter__(self) -> "LoaderIterator":
        return LoaderIterator(self)

    def iter_from(self, state: dict | None) -> "LoaderIterator":
        """An iterator resumed at ``state`` (a
        :meth:`LoaderIterator.state_dict` snapshot; ``None`` = fresh)."""
        return LoaderIterator(self, state=state)

    def __call__(self, start_step: int) -> "LoaderIterator":
        """``run_preemptible``'s callable-batches contract: the stream
        fast-forwarded to global step ``start_step``."""
        spe = self.steps_per_epoch
        state = {
            "version": _STATE_VERSION,
            "seed": self.seed,
            "epoch": start_step // spe,
            "step": start_step % spe,
        }
        return self.iter_from(state)

    def device_iterator(self, size: int = 2, mesh=None, axis: str = "data",
                        state: dict | None = None, device=None) -> Iterator:
        """The full pipeline: this loader behind
        ``feed.prefetch_to_device`` (``size`` batches in flight on
        ``device``; None is the trial's device inside a search trial,
        else the card), each batch a tree of ``torch`` tensors.

        Under torch's data-parallel convention every rank keeps its own
        rows of the global batch on its own card. With ``mesh`` (a
        ``parallel.mesh.Mesh``) and ``process_sharded=True`` this
        loader's batches ARE those rows: the one-time
        :func:`feed.check_process_batch_layout` guard checks that the
        mesh's ``axis`` gives this rank exactly the rows the loader
        slices (``mesh.shard_batch``'s layout), as the JAX package checks
        its sharding before assembling global arrays. With ``mesh`` and
        no process sharding the loader yields the global batch and each
        rank keeps its rows of it.
        """
        from hops_tpu_torch.featurestore.feed import local_rows, prefetch_to_device

        it: Iterator = self.iter_from(state)
        if mesh is not None:
            it = (self._checked_local(it, mesh, axis) if self.process_sharded
                  else (local_rows(mesh, axis, b) for b in it))
        return prefetch_to_device(it, size=size, device=device, name=self.name)

    def _checked_local(self, it: Iterator, mesh, axis: str) -> Iterator:
        from hops_tpu_torch.featurestore.feed import check_process_batch_layout

        lo = self.shard_index * self.local_batch_size
        checked = False
        for batch in it:
            if not checked:
                leaf = _tree_leaves(batch)[0]
                check_process_batch_layout(
                    mesh, (self.batch_size,) + np.shape(leaf)[1:],
                    lo, self.local_batch_size, axis)
                checked = True
            yield batch


class LoaderIterator:
    """Ordered, bounded, resumable execution of a :class:`DataLoader`.

    The consumer thread plans batch tasks in stream order and keeps at
    most ``queue_depth`` of them in flight on the worker pool;
    ``__next__`` always completes the OLDEST task, so completion order
    cannot reorder the stream. ``state_dict()`` is the position of the
    next batch the consumer has not yet received — in-flight batches
    are deliberately not part of the state (they are re-derived on
    restore)."""

    def __init__(self, loader: DataLoader, state: dict | None = None):
        self.loader = loader
        self._epoch = 0
        self._step = 0
        if state is not None:
            self._load_state(state)
        self._order: np.ndarray | None = None
        self._order_epoch: int | None = None
        self._plan_epoch = self._epoch  # position of the NEXT task to submit
        self._plan_step = self._step
        self._pool = self._make_pool()
        self._pending: collections.deque[Future] = collections.deque()
        self._buffers = _BufferPool() if loader.reuse_buffers else None
        self._buffer_template: Any | None = None
        self._ring: collections.deque = collections.deque()
        self._last_return: float | None = None
        self._closed = False

        labels = {"pipeline": loader.name}
        self._m_queue = REGISTRY.gauge(
            "hops_tpu_feed_stage_queue_depth",
            "Batches queued per input-pipeline stage",
            labels=("pipeline", "stage"))
        self._m_inflight = self._m_queue.labels(stage="decode", **labels)
        self._m_ready = self._m_queue.labels(stage="ready", **labels)
        self._m_decode = REGISTRY.histogram(
            "hops_tpu_feed_decode_seconds",
            "Per-batch decode + assembly latency in the input pipeline",
            labels=("pipeline",)).labels(**labels)
        self._m_wait = REGISTRY.histogram(
            "hops_tpu_feed_wait_seconds",
            "Time the consumer blocked waiting for the next batch",
            labels=("pipeline",)).labels(**labels)
        self._m_steps = REGISTRY.counter(
            "hops_tpu_feed_pipeline_batches_total",
            "Batches yielded by the parallel input pipeline",
            labels=("pipeline",)).labels(**labels)
        self._m_starved = REGISTRY.counter(
            "hops_tpu_feed_starved_steps_total",
            "Steps whose feed wait exceeded the starvation threshold "
            "fraction of step wall time",
            labels=("pipeline",)).labels(**labels)

    def _make_pool(self) -> ThreadPoolExecutor | None:
        if self.loader.num_workers == 0:
            return None
        return ThreadPoolExecutor(
            max_workers=self.loader.num_workers,
            thread_name_prefix=f"hops-feed-{self.loader.name}")

    # -- state ---------------------------------------------------------------

    def _load_state(self, state: dict) -> None:
        if state.get("version") != _STATE_VERSION:
            raise ValueError(
                f"loader state version {state.get('version')!r} != "
                f"{_STATE_VERSION}")
        if state.get("seed") != self.loader.seed:
            raise ValueError(
                f"loader state was snapshotted under seed "
                f"{state.get('seed')!r}, this loader uses "
                f"{self.loader.seed!r}: the restored stream would differ")
        self._epoch = int(state["epoch"])
        self._step = int(state["step"])

    def state_dict(self) -> dict:
        """JSON-able snapshot of the next-unyielded position. Save it
        alongside the model checkpoint; ``iter_from``/``load_state_dict``
        replays the exact remaining stream."""
        return {
            "version": _STATE_VERSION,
            "seed": self.loader.seed,
            "epoch": self._epoch,
            "step": self._step,
        }

    def load_state_dict(self, state: dict) -> None:
        """Reposition this iterator (discarding any in-flight work).
        Works on an exhausted iterator too: repositioning reopens it
        (fresh worker pool) so the restored stream actually replays."""
        self._cancel_pending()
        self._load_state(state)
        self._plan_epoch, self._plan_step = self._epoch, self._step
        self._last_return = None
        if self._closed:
            self._closed = False
            self._pool = self._make_pool()

    # -- planning ------------------------------------------------------------

    def _next_task(self) -> tuple[int, int, np.ndarray] | None:
        """The next ``(epoch, step, local indices)`` in stream order, or
        None at end of stream."""
        ld = self.loader
        spe = ld.steps_per_epoch
        while True:
            if ld.num_epochs is not None and self._plan_epoch >= ld.num_epochs:
                return None
            if self._plan_step >= spe:
                self._plan_epoch += 1
                self._plan_step = 0
                continue
            epoch, step = self._plan_epoch, self._plan_step
            if self._order_epoch != epoch:
                self._order = ld._epoch_order(epoch)
                self._order_epoch = epoch
            base = step * ld.batch_size + ld.shard_index * ld.local_batch_size
            idx = self._order[base:base + ld.local_batch_size]
            self._plan_step += 1
            return epoch, step, idx

    # -- production ----------------------------------------------------------

    def _produce(self, epoch: int, step: int, idx: np.ndarray) -> Any:
        faultinject.fire("loader.read")  # chaos: transient read failure
        ld = self.loader
        t0 = time.monotonic()
        out = None
        if self._buffers is not None and self._buffer_template is not None:
            out = self._buffers.take(self._buffer_template)
        batch = ld.source.fetch_batch(idx, out=out)
        if self._buffers is not None and self._buffer_template is None:
            # Captured PRE-transform (the spec pooled buffers must
            # match). Benign race: two workers may both build one.
            self._buffer_template = _tree_map(np.empty_like, batch)
        if ld.transform is not None:
            transformed = ld.transform(batch, ld._batch_rng(epoch, step))
            if out is not None:
                # Recycle the assembly buffer — unless the transform
                # passed any of it through (a view/pass-through leaf):
                # recycling would let the next assembly overwrite data
                # the consumer still holds. may_share_memory is the
                # fast conservative test; a false positive only costs
                # one fresh allocation.
                out_leaves = _tree_leaves(out)
                aliased = any(
                    isinstance(t, np.ndarray)
                    and any(np.may_share_memory(t, o) for o in out_leaves)
                    for t in _tree_leaves(transformed)
                )
                if not aliased:
                    self._buffers.give(out)
            batch = transformed
        self._m_decode.observe(time.monotonic() - t0)
        return batch

    def _submit(self) -> None:
        # Synchronous mode produces strictly on demand: planning ahead
        # on the consumer thread would only front-load latency and hold
        # extra batches live without any overlap to buy.
        depth = self.loader.queue_depth if self._pool is not None else 1
        while len(self._pending) < depth:
            task = self._next_task()
            if task is None:
                return
            if self._pool is None:
                f: Future = Future()
                f.set_result(self._produce(*task))
            else:
                f = self._pool.submit(self._produce, *task)
            self._pending.append(f)

    def _cancel_pending(self) -> None:
        for f in self._pending:
            f.cancel()
        self._pending.clear()

    # -- consumption ---------------------------------------------------------

    def __iter__(self) -> "LoaderIterator":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        t0 = time.monotonic()
        consumer_s = t0 - self._last_return if self._last_return is not None else None
        # Submit inside the wait window: in synchronous mode this IS
        # the on-demand decode of the batch being returned (so feed
        # wait measures the right batch and nothing is produced ahead);
        # in threaded mode it is a cheap non-blocking enqueue.
        self._submit()
        if not self._pending:
            self.close()
            raise StopIteration
        batch = self._pending.popleft().result()
        if self._pool is not None:
            self._submit()  # refill before returning: keep workers busy
        now = time.monotonic()
        wait_s = now - t0
        self._m_wait.observe(wait_s)
        self._m_inflight.set(len(self._pending))
        self._m_ready.set(sum(1 for f in self._pending if f.done()))
        self._m_steps.inc()
        if consumer_s is not None:
            # Starved step: the consumer's wall time between batches was
            # dominated (beyond the threshold fraction) by feed wait —
            # the host pipeline, not the device step, set the pace.
            step_wall = consumer_s + wait_s
            if step_wall > 0 and wait_s > self.loader.starved_threshold * step_wall:
                self._m_starved.inc()
        # Advance the consumer position AFTER the batch is in hand: the
        # snapshot must never claim a batch the consumer was not given.
        self._step += 1
        if self._step >= self.loader.steps_per_epoch:
            self._epoch += 1
            self._step = 0
        if self._buffers is not None and self.loader.transform is None:
            # Without a transform the yielded batch IS a pool buffer
            # (recycled once it falls out of the validity window); with
            # one, _produce already recycled the assembly buffer and
            # the yield is fresh arrays.
            self._ring.append(batch)
            if len(self._ring) > self.loader.queue_depth + 2:
                self._buffers.give(self._ring.popleft())
        self._last_return = time.monotonic()
        return batch

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._cancel_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        self._m_inflight.set(0)
        self._m_ready.set(0)

    def __enter__(self) -> "LoaderIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # best-effort: don't leak worker threads
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
