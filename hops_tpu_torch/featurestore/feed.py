"""Data feeder: training-dataset → device-ready batches (counterpart of
``hops_tpu/featurestore/feed.py``).

The reference fed training through ``td.tf_data(...).tf_record_dataset
(process=True, batch_size, num_epochs)`` (training_datasets.ipynb:
409-429). The port's path is :meth:`DataFeeder.numpy_iterator`:
host-side shuffled batch assembly (NumPy, optionally through the native
record-IO engine) with :func:`prefetch_to_device` overlapping
host-to-device copies with compute — static shapes, drop_remainder by
default. ``tf_record_dataset``/``tf_csv_dataset`` are provided for
tf.data users.

Where the JAX package assembles a global ``jax.Array`` from each
process's rows, the port follows torch's data-parallel convention: each
rank keeps its own rows of the global batch, as ``torch`` tensors on its
own device, laid out as ``parallel.mesh.shard_batch`` lays them out.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator

import numpy as np
import torch

from hops_tpu_torch.featurestore.loader import _tree_leaves, _tree_map, _tree_map2
from hops_tpu_torch.runtime.devices import resolve_device
from hops_tpu_torch.telemetry.metrics import REGISTRY


class DataFeeder:
    def __init__(self, td, target_name: str | None = None, split: str | None = None,
                 feature_names: list[str] | None = None, is_training: bool = True):
        self._td = td
        self.target_name = target_name.lower() if target_name else None
        self.split = split
        self.is_training = is_training
        names = [f.name for f in td.features]
        if feature_names:
            self.feature_names = [n.lower() for n in feature_names]
        else:
            self.feature_names = [n for n in names if n != self.target_name]

    # -- NumPy / torch path ---------------------------------------------------

    def numpy_arrays(self) -> tuple[np.ndarray, np.ndarray | None]:
        """Whole split as (X, y) float arrays (small-data path).

        Non-numeric features are integer-encoded against the sorted
        vocabulary of the column across the WHOLE training dataset (all
        splits), so train/test splits of the same TD agree on the
        encoding even when a split is missing some categories.
        """
        df = self._td.read(split=self.split)
        full = None  # lazy: only read the unsplit TD if a column needs a vocab
        cols = []
        for name in self.feature_names:
            s = df[name]
            try:
                col = s.to_numpy(dtype=np.float32)
            except (ValueError, TypeError):
                if full is None:
                    full = df if self.split is None else self._td.read(split=None)
                vocab = {
                    v: i for i, v in enumerate(sorted(full[name].astype(str).unique()))
                }
                col = s.astype(str).map(vocab).to_numpy(dtype=np.float32)
            cols.append(col)
        x = np.stack(cols, axis=1) if cols else np.zeros((len(df), 0), np.float32)
        y = None
        if self.target_name:
            y = df[self.target_name].to_numpy()
        return x, y

    def numpy_iterator(
        self,
        batch_size: int,
        num_epochs: int | None = 1,
        shuffle: bool | None = None,
        drop_remainder: bool = True,
        seed: int = 0,
        transform: Callable[[np.ndarray, Any], Any] | None = None,
        process_sharded: bool = False,
        mesh: Any = None,
        axis: str = "data",
        device: Any = None,
        start_step: int = 0,
    ) -> Iterator:
        """Yield ``(x, y)`` (or ``x`` when no target) NumPy batches.

        ``num_epochs=None`` repeats forever (the tf.data contract).
        Static batch shapes with ``drop_remainder=True``.

        Multihost input sharding (``process_sharded=True``):
        ``batch_size`` is the GLOBAL batch size; every process computes
        the same seed-derived epoch permutation and yields only its own
        ``batch_size / process_count`` slice of each global batch — the
        TPU answer to the reference's autoshard-OFF + per-worker
        slicing (multiworkermirroredstrategy_mnist_example.ipynb:184).
        The shard index and count are this process's rank and world
        size (``parallel.multihost``). Pass ``mesh`` (a
        ``parallel.mesh.Mesh``) and the iterator checks once that the
        mesh's ``axis`` gives this rank exactly these rows
        (:func:`check_process_batch_layout`, ``mesh.shard_batch``'s
        layout), then yields them as ``torch`` tensors on ``device``
        (default: this process's, ``multihost.device()``), so a
        ``collective_all_reduce`` step consumes the feeder directly.

        Preemption resume (``start_step``): the stream is a pure
        function of ``seed``, so ``start_step=k`` fast-forwards to
        exactly the batch a fresh iterator would yield k-th — restored
        training continues the same shuffle order mid-epoch instead of
        re-seeing early batches (pair with
        ``runtime.preemption.run_preemptible``, which knows the
        restored step count).
        """
        if shuffle is None:
            shuffle = self.is_training
        if mesh is not None and not process_sharded:
            raise ValueError("mesh requires process_sharded=True")
        shard_index, shard_count = 0, 1
        if process_sharded:
            from hops_tpu_torch.parallel import multihost

            shard_index, shard_count = multihost.process_index(), multihost.process_count()
            if batch_size % shard_count:
                raise ValueError(
                    f"global batch {batch_size} not divisible by "
                    f"{shard_count} processes"
                )
            if not drop_remainder:
                raise ValueError(
                    "process_sharded requires drop_remainder=True "
                    "(every process must hold an equal, full shard)"
                )
        local_bs = batch_size // shard_count
        lo = shard_index * local_bs
        x, y = self.numpy_arrays()
        n = len(x)
        # The permutation stream depends only on the seed, so every
        # process slices the SAME global order — shards are disjoint by
        # construction.
        rng = np.random.RandomState(seed)

        layout_checked = False
        dev = None
        if mesh is not None:
            from hops_tpu_torch.parallel import multihost

            dev = multihost.device() if device is None else torch.device(device)

        def assemble(batch):
            nonlocal layout_checked
            if not layout_checked:
                leaf = _tree_leaves(batch)[0]
                check_process_batch_layout(
                    mesh, (batch_size,) + np.shape(leaf)[1:], lo, local_bs, axis)
                layout_checked = True
            return _tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dev), batch)

        end = n - (n % batch_size) if drop_remainder else n
        steps_per_epoch = max(1, (end + batch_size - 1) // batch_size)
        skip_epochs, skip_steps = divmod(start_step, steps_per_epoch)

        # Feed throughput: rate(batches_total) is batches produced/sec,
        # the input-pipeline half of the steps/sec picture.
        m_batches = REGISTRY.counter(
            "hops_tpu_feed_batches_total",
            "Batches yielded by DataFeeder.numpy_iterator",
        ).labels()
        m_examples = REGISTRY.counter(
            "hops_tpu_feed_examples_total",
            "Examples yielded by DataFeeder.numpy_iterator (local rows)",
        ).labels()

        epoch = 0
        while num_epochs is None or epoch < num_epochs:
            order = rng.permutation(n) if shuffle else np.arange(n)
            if epoch < skip_epochs:
                # Consume this epoch's permutation draw and move on —
                # the RNG stream must stay aligned with an unskipped run.
                epoch += 1
                continue
            first = skip_steps * batch_size if epoch == skip_epochs else 0
            for start in range(first, end, batch_size):
                idx = order[start + lo:start + lo + local_bs]
                bx = x[idx]
                by = y[idx] if y is not None else None
                if transform is not None:
                    out = transform(bx, by)
                elif by is None:
                    out = bx
                else:
                    out = (bx, by)
                m_batches.inc()
                m_examples.inc(len(bx))
                yield assemble(out) if mesh is not None else out
            epoch += 1

    # -- parallel pipeline ----------------------------------------------------

    def loader(
        self,
        batch_size: int,
        num_workers: int = 2,
        **kwargs: Any,
    ):
        """The staged parallel pipeline over this feeder's materialized
        split: a :class:`hops_tpu_torch.featurestore.loader.DataLoader` with
        snapshot/restore and per-stage telemetry (shuffle defaults to
        ``is_training``). Its stream is byte-identical across the
        loader's own worker counts — but NOT to
        :meth:`numpy_iterator`'s: the two derive shuffle orders from
        different RNG streams, so a seed that reproduced one does not
        reproduce the other (mid-run migration should resume via the
        loader's own ``state_dict``, not ``start_step``). See
        ``loader.py`` for the knobs (``queue_depth``, ``transform``,
        ``process_sharded``, ``reuse_buffers``...)."""
        from hops_tpu_torch.featurestore.loader import ArraySource, DataLoader

        kwargs.setdefault("shuffle", self.is_training)
        return DataLoader(
            ArraySource.from_feeder(self), batch_size,
            num_workers=num_workers, **kwargs,
        )

    # -- tf.data compatibility ------------------------------------------------

    def tf_record_dataset(self, process: bool = False, batch_size: int | None = None,
                          num_epochs: int | None = None):
        """Reference: ``feeder.tf_record_dataset(process=True, batch_size,
        num_epochs)`` — returns a ``tf.data.Dataset``; with ``process=True``
        it is batched ``(features, label)`` ready for ``model.fit``."""
        import tensorflow as tf

        d = self._td.dir / (self.split or ("data" if not self._td.splits else next(iter(self._td.splits))))
        files = sorted(str(p) for p in d.glob("*.tfrecord"))
        if not files:
            raise FileNotFoundError(f"no tfrecord files in {d}")
        schema = self._tf_schema()
        ds = tf.data.TFRecordDataset(files)
        if not process:
            return ds.map(lambda raw: tf.io.parse_single_example(raw, schema))
        if self.target_name is None:
            raise ValueError("process=True requires target_name on the feeder")

        def to_xy(raw):
            ex = tf.io.parse_single_example(raw, schema)
            xs = [tf.cast(ex[n], tf.float32) for n in self.feature_names]
            x = tf.stack([tf.reshape(v, []) for v in xs])
            y = ex[self.target_name]
            return x, y

        ds = ds.map(to_xy, num_parallel_calls=tf.data.AUTOTUNE)
        if self.is_training:
            ds = ds.shuffle(10_000)
        ds = ds.batch(batch_size or 32, drop_remainder=True)
        ds = ds.repeat(num_epochs)
        return ds.prefetch(tf.data.AUTOTUNE)

    def tf_csv_dataset(self, process: bool = False, batch_size: int | None = None,
                       num_epochs: int | None = None):
        import tensorflow as tf

        d = self._td.dir / (self.split or ("data" if not self._td.splits else next(iter(self._td.splits))))
        files = sorted(str(p) for p in d.glob("*.csv"))
        if not files:
            raise FileNotFoundError(f"no csv files in {d}")
        ds = tf.data.experimental.make_csv_dataset(
            files, batch_size=batch_size or 32, label_name=self.target_name,
            num_epochs=num_epochs, shuffle=self.is_training)
        if process:
            def to_xy(feats, label):
                x = tf.stack([tf.cast(feats[n], tf.float32) for n in self.feature_names], axis=1)
                return x, label
            ds = ds.map(to_xy)
        return ds

    def _tf_schema(self):
        import tensorflow as tf

        schema = {}
        for f in self._td.features:
            if f.type in ("int", "bigint", "boolean"):
                schema[f.name] = tf.io.FixedLenFeature([], tf.int64)
            elif f.type in ("float", "double"):
                schema[f.name] = tf.io.FixedLenFeature([], tf.float32)
            elif f.type.startswith("array"):
                schema[f.name] = tf.io.VarLenFeature(tf.float32)
            else:
                schema[f.name] = tf.io.FixedLenFeature([], tf.string)
        return schema


def check_process_batch_layout(mesh, global_shape, lo: int, local_bs: int,
                               axis: str | tuple[str, ...] = "data") -> None:
    """Validate that ``mesh``'s ``axis`` gives THIS rank exactly global
    rows ``[lo, lo + local_bs)`` — the rows the process-sharded slicing
    yields — under ``parallel.mesh.shard_batch``'s layout (rank r of n
    data replicas holds the r-th contiguous ``1/n`` of the leading dim).
    A mismatched layout would silently permute the global batch across
    ranks. Shared by ``DataFeeder.numpy_iterator`` and the parallel
    ``loader.DataLoader`` pipeline."""
    from hops_tpu_torch.parallel.mesh import _data_slot

    index, count = _data_slot(mesh, axis)
    rows = global_shape[0]
    if rows % count:
        raise ValueError(f"global batch of {rows} rows does not split over {count} "
                         f"replicas of mesh axis {axis!r}")
    per = rows // count
    start, stop = index * per, (index + 1) * per
    if (start, stop) != (lo, lo + local_bs):
        raise ValueError(
            f"mesh axis {axis!r} assigns this rank global rows "
            f"{start}..{stop - 1}, but process-sharded slicing "
            f"yields rows {lo}..{lo + local_bs - 1}: the mesh must be "
            "rank-major over the leading dim (built from rank order, "
            "batch axis first)"
        )


def local_rows(mesh, axis: str | tuple[str, ...], batch: Any) -> Any:
    """This rank's rows of a global host batch (NumPy leaves) under
    ``mesh``'s ``axis``: ``parallel.mesh.shard_batch``'s slice, left on
    the host for :func:`prefetch_to_device` to copy."""
    from hops_tpu_torch.parallel.mesh import _data_slot

    index, count = _data_slot(mesh, axis)

    def take(a):
        a = np.asarray(a)
        if len(a) % count:
            raise ValueError(f"batch of {len(a)} rows does not split over {count} replicas")
        per = len(a) // count
        return a[index * per:(index + 1) * per]

    return _tree_map(take, batch)


class _PinnedSlot:
    """One batch's pinned host staging buffers and the event of the copy
    out of them. Owned by :func:`prefetch_to_device`: the loader's own
    buffers (``reuse_buffers``) are only ever read by a synchronous host
    copy into a slot, never by an asynchronous device copy, and a slot is
    refilled only after its copy's event has completed."""

    def __init__(self, template: Any):
        self.spec = _tree_map(lambda a: (a.shape, a.dtype.str), template)
        self.host = _tree_map(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory(), template)
        self.event: Any = None


def prefetch_to_device(
    iterator: Iterator, size: int = 2, device: Any = None, name: str = "default"
) -> Iterator:
    """Overlap host-to-device copies with compute: keep ``size`` batches
    in flight on ``device`` (None: the trial's device inside a search
    trial, else the card), yielding each batch as a tree of ``torch``
    tensors.

    On a card every batch is first copied on the host into pinned
    staging buffers this prefetcher owns, then copied to the card with
    ``non_blocking=True`` on a side stream; the consumer's current stream
    waits on that copy's event before the batch is handed over, and each
    tensor is recorded on the consumer's stream (``record_stream``) so
    the allocator never reuses its memory under the consumer. A staging
    buffer is refilled only after its copy's event has completed, so a
    host buffer is never overwritten while a copy still reads it. On the
    CPU each leaf is copied into a tensor of its own (never a view of a
    loader buffer that ``reuse_buffers`` may recycle).

    The queue refills BEFORE each yield, so the pipeline holds ``size``
    in-flight batches throughout (not ``size - 1`` after the first
    yield, which would under-overlap exactly when compute is fastest).
    Depth is exported as the ``hops_tpu_feed_prefetch_depth`` gauge,
    labelled ``pipeline=name`` so concurrent feeds (train + eval) don't
    clobber each other's series.
    """
    return _prefetch(iter(iterator), size, resolve_device(device), name)


def _prefetch(it: Iterator, size: int, dev: torch.device, name: str) -> Iterator:
    depth = REGISTRY.gauge(
        "hops_tpu_feed_prefetch_depth",
        "Batches currently in flight on device in prefetch_to_device",
        labels=("pipeline",),
    ).labels(pipeline=name)

    queue: collections.deque = collections.deque()

    if dev.type == "cuda":
        copy_stream = torch.cuda.Stream(device=dev)
        # Slots in the order of their copies: the oldest is refilled once
        # size + 1 newer batches were staged, after its event.
        ring: collections.deque = collections.deque()

        def put(batch):
            batch = _tree_map(np.asarray, batch)
            spec = _tree_map(lambda a: (a.shape, a.dtype.str), batch)
            slot = None
            if len(ring) > size:
                slot = ring.popleft()
                slot.event.synchronize()  # the copy out of its buffers is done
                if slot.spec != spec:
                    slot = None
            if slot is None:
                slot = _PinnedSlot(batch)
            _tree_map2(lambda dst, a: np.copyto(dst.numpy(), a), slot.host, batch)
            with torch.cuda.stream(copy_stream):
                out = _tree_map(lambda h: h.to(dev, non_blocking=True), slot.host)
                slot.event = torch.cuda.Event()
                slot.event.record(copy_stream)
            ring.append(slot)
            return out, slot.event

        def hand_over(item):
            out, event = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            _tree_map(lambda t: t.record_stream(consumer), out)
            return out
    else:
        def put(batch):
            return _tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), batch)

        def hand_over(item):
            return item

    def refill():
        while len(queue) < size:
            try:
                queue.append(put(next(it)))
            except StopIteration:
                return

    refill()
    while queue:
        out = queue.popleft()
        refill()
        depth.set(len(queue))
        yield hand_over(out)
    depth.set(0)


def pack_documents(
    docs: "Iterator | list",
    seq_len: int,
    eos_id: int,
    pad_id: int = 0,
    drop_remainder: bool = True,
) -> np.ndarray:
    """Greedy-pack ragged token documents into ``(n, seq_len + 1)``
    rows for next-token training -- the standard LM pretraining layout:
    documents concatenate into one stream with an ``eos_id`` separator
    after each, and the stream chunks into non-overlapping rows (the
    +1 column is the shifted-target overlap consumed by
    ``make_lm_train_step``). No padding except the final partial row,
    which is ``pad_id``-padded when ``drop_remainder=False`` and
    dropped otherwise -- note ``make_lm_train_step`` computes UNMASKED
    loss over every position, so a kept padded row trains the model to
    emit ``pad_id`` after its true tail; the default drop avoids that,
    and corpora where the remainder matters should mask the loss
    themselves. Static shapes, zero pad waste in the interior -- the
    TPU-friendly alternative to per-document padding, whose waste
    scales with length variance."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    # Vectorized concat: per-token Python loops cost minutes and GBs
    # at pretraining scale; this is one allocation + one copy.
    parts: list[np.ndarray] = []
    for doc in docs:
        parts.append(np.asarray(doc, np.int32).reshape(-1))
        parts.append(np.asarray([eos_id], np.int32))
    stream = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
    row = seq_len + 1
    n_full = len(stream) // row
    packed = stream[: n_full * row].reshape(n_full, row)
    tail = stream[n_full * row:]
    if tail.size and not drop_remainder:
        pad = np.full((1, row), pad_id, np.int32)
        pad[0, : tail.size] = tail
        packed = np.concatenate([packed, pad])
    if not packed.size:
        if not stream.size:
            raise ValueError("no input tokens: docs is empty")
        if drop_remainder:
            raise ValueError(
                f"documents too short to fill one row of {row} tokens "
                "(pass drop_remainder=False to keep a padded partial row)"
            )
        raise ValueError(
            f"documents too short to fill one row of {row} tokens"
        )
    return packed
