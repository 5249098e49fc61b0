"""The port's input pipeline (``hops_tpu_torch.featurestore.loader`` and
``feed``) against the JAX package's, on the CPU.

The host side of the pipeline is the JAX package's, so for a seed both
packages' ``DataLoader`` must yield byte-identical streams — over
``ArraySource`` and ``RecordIOSource``, with 0, 2 and 4 workers,
shuffled or not, with a ``transform`` and its rng, with
``reuse_buffers`` and with explicit shards — and identical
``state_dict()`` JSON, from which either resumes the same remaining
stream. ``device_iterator(device="cpu")`` yields ``torch`` tensors equal
to the NumPy batches. ``process_sharded=True`` takes its shard from
``parallel.multihost`` (two gloo ranks), and each rank's rows sit where
``mesh.shard_batch`` puts them. ``pack_documents`` and the feeder's
``numpy_iterator`` are identical too.
"""

from __future__ import annotations

import json
import textwrap
import time
import zlib

import numpy as np
import pytest
import torch

from hops_tpu.featurestore import feed as jax_feed
from hops_tpu.featurestore import loader as jax_loader
from hops_tpu.native.recordio import RecordWriter as JaxRecordWriter
from hops_tpu_torch import native
from hops_tpu_torch.featurestore import feed, loader
from hops_tpu_torch.featurestore.loader import ArraySource, DataLoader, RecordIOSource
from hops_tpu_torch.telemetry.metrics import REGISTRY

N, WIDTH = 24, 3


@pytest.fixture(scope="module", autouse=True)
def built():
    native.build()
    assert native.available()


def _tobytes(tree):
    if isinstance(tree, dict):
        return {k: _tobytes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tobytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        tree = tree.numpy()
    return np.asarray(tree).tobytes()


def _arrays(n=N):
    x = np.arange(n * WIDTH, dtype=np.float32).reshape(n, WIDTH)
    y = np.arange(n, dtype=np.int64)
    return x, y


def _rio_decode(raw: bytes):
    x = np.frombuffer(zlib.decompress(raw), np.float32).reshape(4)
    return x, np.int64(x[0])


@pytest.fixture(scope="module")
def rio_paths(tmp_path_factory):
    """Three RecordIO shards of compressed float32 rows, written by the
    port's writer; a record's value is its global index."""
    tmp = tmp_path_factory.mktemp("rio")
    paths, k = [], 0
    from hops_tpu_torch.native.recordio import RecordWriter

    for s, count in enumerate((5, 8, 7)):
        p = tmp / f"shard-{s}.rio"
        with RecordWriter(p) as w:
            for _ in range(count):
                w.write(zlib.compress(np.full(4, k, np.float32).tobytes()))
                k += 1
        paths.append(p)
    return paths


def _jitter(batch, rng):
    x, y = batch
    return x + rng.normal(size=x.shape).astype(np.float32), y


def _pass_y(batch, rng):
    x, y = batch
    return x * 2.0, y  # y aliases the assembly buffer


TRANSFORMS = {None: None, "jitter": _jitter, "pass_y": _pass_y}

CASES = {
    "array-sync": ("array", dict(num_workers=0)),
    "array-2": ("array", dict(num_workers=2)),
    "array-4": ("array", dict(num_workers=4, queue_depth=6)),
    "array-unshuffled": ("array", dict(num_workers=2, shuffle=False)),
    "array-transform": ("array", dict(num_workers=4, transform="jitter")),
    "array-reuse": ("array", dict(num_workers=2, reuse_buffers=True, queue_depth=2)),
    "array-reuse-transform": ("array", dict(num_workers=3, reuse_buffers=True,
                                            transform="pass_y")),
    "array-shard": ("array", dict(num_workers=2, shard_index=1, shard_count=4)),
    "rio-sync": ("rio", dict(num_workers=0)),
    "rio-2": ("rio", dict(num_workers=2)),
    "rio-4-unshuffled": ("rio", dict(num_workers=4, shuffle=False)),
    "rio-reuse": ("rio", dict(num_workers=2, reuse_buffers=True, queue_depth=2)),
    "rio-shard-transform": ("rio", dict(num_workers=4, shard_index=1, shard_count=2,
                                        transform="jitter")),
}


def _pair(case, rio_paths, batch_size=4, num_epochs=2, seed=11):
    kind, kw = CASES[case]
    kw = dict(kw, transform=TRANSFORMS[kw.get("transform")])
    if kind == "array":
        srcs = (jax_loader.ArraySource(_arrays()), ArraySource(_arrays()))
    else:
        srcs = (jax_loader.RecordIOSource(rio_paths, decode=_rio_decode),
                RecordIOSource(rio_paths, decode=_rio_decode))
    common = dict(num_epochs=num_epochs, seed=seed, name=f"t-{case}", **kw)
    return (jax_loader.DataLoader(srcs[0], batch_size, **common),
            DataLoader(srcs[1], batch_size, **common))


def _stream(ld):
    # Copied as they come: under reuse_buffers a yielded batch is valid
    # only until the loader recycles its buffer.
    return [_tobytes(b) for b in ld]


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_is_byte_identical_to_jax(case, rio_paths):
    ref, port = _pair(case, rio_paths)
    want = _stream(ref)
    assert len(want) >= 4
    assert _stream(port) == want
    assert port.steps_per_epoch == ref.steps_per_epoch


@pytest.mark.parametrize("case", ["array-2", "array-transform", "rio-reuse",
                                  "rio-shard-transform"])
@pytest.mark.parametrize("k", [1, 4, 7])
def test_state_dict_and_resume_match_jax(case, k, rio_paths):
    ref, port = _pair(case, rio_paths, num_epochs=3)
    it_ref, it_port = iter(ref), iter(port)
    for _ in range(k):
        assert _tobytes(next(it_port)) == _tobytes(next(it_ref))
    state = it_port.state_dict()
    assert json.dumps(state) == json.dumps(it_ref.state_dict())
    rest = _stream(it_ref)
    # Either package resumes the other's snapshot (through JSON) exactly.
    assert _stream(port.iter_from(json.loads(json.dumps(state)))) == rest
    assert _stream(ref.iter_from(state)) == rest
    it_port.close()


@pytest.mark.parametrize("case", ["array-2", "array-reuse", "rio-reuse", "rio-shard-transform"])
def test_device_iterator_yields_the_numpy_stream_as_tensors(case, rio_paths):
    ref, port = _pair(case, rio_paths)
    want = [_tobytes(b) for b in ref]
    got = list(port.device_iterator(size=2, device="cpu"))
    for batch in got:
        for leaf in loader._tree_leaves(batch):
            assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
    # Compared after the whole stream is in hand: a tensor that aliased a
    # recycled loader buffer would have been overwritten by now.
    assert [_tobytes(b) for b in got] == want


def test_device_iterator_resumes_from_state(rio_paths):
    _, port = _pair("rio-2", rio_paths, num_epochs=3)
    full = [_tobytes(b) for b in port]
    state = {"version": 1, "seed": 11, "epoch": 1, "step": 2}
    got = [_tobytes(b) for b in port.device_iterator(device="cpu", state=state)]
    assert got == full[port.steps_per_epoch + 2:]


def test_device_iterator_defaults_to_the_trial_device(rio_paths):
    from hops_tpu_torch.runtime import devices

    _, port = _pair("rio-2", rio_paths)
    with devices.trial_scope([torch.device("cpu")]):
        batch = next(iter(port.device_iterator()))
    assert batch[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda:0"):
            port.device_iterator()


def test_prefetch_depth_gauge(rio_paths):
    gauge = REGISTRY.gauge("hops_tpu_feed_prefetch_depth", labels=("pipeline",))
    _, port = _pair("array-2", rio_paths)
    depths = []
    for _ in port.device_iterator(size=3, device="cpu"):
        depths.append(gauge.value(pipeline="t-array-2"))
    assert depths[0] == 3 and depths[-1] == 0 and max(depths) <= 3
    assert gauge.value(pipeline="t-array-2") == 0


def test_mesh_rows_on_one_rank(rio_paths):
    """With one rank a mesh's data axis holds the whole batch; a
    process-sharded loader checks its layout against the mesh."""
    from hops_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh()
    src = ArraySource(_arrays(16))
    plain = [_tobytes(b) for b in DataLoader(src, 8, shuffle=False, num_workers=0)]
    for kw in (dict(), dict(process_sharded=True)):
        ld = DataLoader(src, 8, shuffle=False, num_workers=2, **kw)
        got = list(ld.device_iterator(device="cpu", mesh=mesh))
        assert [_tobytes(b) for b in got] == plain
    bad = mesh_lib.Mesh(np.array([[0, 1]]), ("model", "data"))  # rank 0 is data row 0 of 2
    ld = DataLoader(src, 8, shuffle=False, num_workers=0, shard_index=1, shard_count=2,
                    process_sharded=True)
    with pytest.raises(ValueError, match="assigns this rank global rows 0..3"):
        next(iter(ld.device_iterator(device="cpu", mesh=bad)))


# -- two gloo ranks: the shard comes from parallel.multihost -----------------------

WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import torch
    from hops_tpu_torch.featurestore.feed import DataFeeder
    from hops_tpu_torch.featurestore.loader import ArraySource, DataLoader
    from hops_tpu_torch.parallel import mesh as mesh_lib, multihost

    out_dir = sys.argv[1]
    rank, world = multihost.process_index(), multihost.process_count()
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    y = np.arange(64, dtype=np.int64)
    ld = DataLoader(ArraySource((x, y)), 16, num_epochs=2, seed=13, num_workers=2,
                    process_sharded=True)
    mesh = mesh_lib.make_mesh()
    batches = [tuple(t.numpy() for t in b)
               for b in ld.device_iterator(device="cpu", mesh=mesh)]

    class Td:
        class F:
            def __init__(self, name):
                self.name = name
        features = [F("a"), F("b"), F("t")]

        def read(self, split=None):
            import pandas as pd
            return pd.DataFrame({"a": x[:, 0], "b": x[:, 1], "t": y})

    fed = [tuple(t.numpy() for t in b) for b in DataFeeder(Td(), target_name="t")
           .numpy_iterator(16, num_epochs=1, seed=5, process_sharded=True, mesh=mesh,
                           device="cpu")]
    reversed_mesh = mesh_lib.Mesh(np.array(list(range(world))[::-1]), ("data",))
    try:
        next(iter(ld.device_iterator(device="cpu", mesh=reversed_mesh)))
        refused = None
    except ValueError as e:
        refused = str(e)
    result = dict(rank=rank, world=world, shard=(ld.shard_index, ld.shard_count),
                  batches=batches, fed=fed, refused=refused)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
''')


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from test_torch_grad_comms import run_ranks, shared_once

    def launch():
        d = tmp_path_factory.mktemp("loader_ranks")
        return run_ranks(d, 2, WORKER, str(d))

    return shared_once(tmp_path_factory, "loader_ranks", launch)


def test_process_sharded_takes_rank_and_world_from_multihost(two_ranks):
    src = jax_loader.ArraySource((np.arange(64 * 3, dtype=np.float32).reshape(64, 3),
                                  np.arange(64, dtype=np.int64)))
    for r, res in enumerate(two_ranks):
        assert (res["rank"], res["world"], res["shard"]) == (r, 2, (r, 2))
        ref = jax_loader.DataLoader(src, 16, num_epochs=2, seed=13, num_workers=0,
                                    shard_index=r, shard_count=2)
        assert [_tobytes(b) for b in res["batches"]] == [_tobytes(b) for b in ref]
    # Disjoint halves of every global batch.
    for b0, b1 in zip(two_ranks[0]["batches"], two_ranks[1]["batches"]):
        assert not set(b0[1].tolist()) & set(b1[1].tolist())
        assert len(b0[1]) == len(b1[1]) == 8


def test_feeder_process_sharded_rows_follow_the_mesh(two_ranks):
    td = _FakeTd()
    ref = list(jax_feed.DataFeeder(td, target_name="t").numpy_iterator(16, num_epochs=1,
                                                                       seed=5))
    for r, res in enumerate(two_ranks):
        assert len(res["fed"]) == len(ref) == 4
        for (gx, gy), (wx, wy) in zip(res["fed"], ref):
            np.testing.assert_array_equal(gx, wx[r * 8:(r + 1) * 8])
            np.testing.assert_array_equal(gy, wy[r * 8:(r + 1) * 8])


def test_a_mesh_that_permutes_ranks_is_refused(two_ranks):
    for r, res in enumerate(two_ranks):
        lo = r * 8
        assert res["refused"] is not None, r
        assert f"yields rows {lo}..{lo + 7}" in res["refused"]


class _FakeTd:
    """A training dataset as the feeder reads it: feature names and a
    frame."""

    class _F:
        def __init__(self, name):
            self.name = name

    features = [_F("a"), _F("b"), _F("t")]

    def read(self, split=None):
        import pandas as pd

        x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
        return pd.DataFrame({"a": x[:, 0], "b": x[:, 1], "t": np.arange(64, dtype=np.int64)})


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False), dict(num_epochs=2, start_step=3),
                                dict(drop_remainder=False, batch_size=10)])
def test_feeder_numpy_iterator_matches_jax(kw):
    kw = dict(kw)
    bs = kw.pop("batch_size", 16)
    td = _FakeTd()
    want = [_tobytes(b) for b in jax_feed.DataFeeder(td, target_name="t")
            .numpy_iterator(bs, seed=3, **kw)]
    got = [_tobytes(b) for b in feed.DataFeeder(td, target_name="t")
           .numpy_iterator(bs, seed=3, **kw)]
    assert got == want and len(got) >= 3


def test_feeder_loader_bridge_matches_jax():
    td = _FakeTd()
    want = _stream(jax_feed.DataFeeder(td, target_name="t").loader(8, seed=2))
    assert _stream(feed.DataFeeder(td, target_name="t").loader(8, seed=2)) == want
    with pytest.raises(ValueError, match="mesh requires process_sharded"):
        next(feed.DataFeeder(td).numpy_iterator(8, mesh=object()))


# -- pack_documents ---------------------------------------------------------------


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("seq_len", [4, 63])
def test_pack_documents_matches_jax(seq_len, drop_remainder):
    rng = np.random.default_rng(seq_len)
    docs = [rng.integers(1, 500, int(rng.integers(1, 90))) for _ in range(30)]
    kw = dict(seq_len=seq_len, eos_id=0, pad_id=7, drop_remainder=drop_remainder)
    got = feed.pack_documents(docs, **kw)
    want = jax_feed.pack_documents(docs, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    src = ArraySource.from_documents(docs, seq_len=seq_len, eos_id=0, pad_id=7,
                                     drop_remainder=drop_remainder)
    np.testing.assert_array_equal(src.arrays["tokens"], want)


def test_pack_documents_refusals_match_jax():
    for args in (([], 4), ([[1, 2]], 8), ([[1]], 0)):
        with pytest.raises(ValueError) as ref:
            jax_feed.pack_documents(args[0], seq_len=args[1], eos_id=0)
        with pytest.raises(ValueError) as got:
            feed.pack_documents(args[0], seq_len=args[1], eos_id=0)
        assert str(got.value) == str(ref.value)


def test_recordio_written_by_jax_feeds_the_port(tmp_path):
    path = tmp_path / "rows.rio"
    rows = jax_feed.pack_documents([np.arange(1, 40)] * 5, seq_len=15, eos_id=0)
    with JaxRecordWriter(path) as w:
        for row in rows:
            w.write(row.astype(np.int32).tobytes())

    def decode(raw):
        return {"tokens": np.frombuffer(raw, np.int32)}

    ld = DataLoader(RecordIOSource([path], decode=decode), 2, shuffle=False, num_workers=2)
    got = np.concatenate([b["tokens"].numpy() for b in ld.device_iterator(device="cpu")])
    np.testing.assert_array_equal(got, rows[:len(got)])


# -- the cases of tests/test_loader.py on the port ----------------------------------


def test_recordio_global_index_space(rio_paths):
    src = RecordIOSource(rio_paths, decode=_rio_decode)
    assert len(src) == 20 and src.shard_lengths == [5, 8, 7]
    seen = np.concatenate([b[0][:, 0] for b in DataLoader(src, 4, shuffle=False,
                                                           num_workers=2)])
    np.testing.assert_array_equal(seen, np.arange(20, dtype=np.float32))


def test_collate_stacks_nested_structures():
    batch = loader.default_collate([
        {"a": np.ones(2), "b": (np.zeros(1), 3)},
        {"a": np.full(2, 2.0), "b": (np.ones(1), 4)},
    ])
    assert batch["a"].shape == (2, 2) and batch["b"][0].shape == (2, 1)
    np.testing.assert_array_equal(batch["b"][1], [3, 4])


def test_state_is_seed_checked():
    ld = DataLoader(ArraySource(_arrays()), 4, seed=2, num_workers=0)
    it = iter(ld)
    next(it)
    state = json.loads(json.dumps(it.state_dict()))
    assert state == {"version": 1, "seed": 2, "epoch": 0, "step": 1}
    with pytest.raises(ValueError, match="seed"):
        DataLoader(ArraySource(_arrays()), 4, seed=3, num_workers=0).iter_from(state)


def test_callable_contract_and_revived_iterator():
    ld = DataLoader(ArraySource(_arrays(16)), 4, num_epochs=3, seed=5, num_workers=2)
    full = _stream(ld)
    for k in (0, 4, 7, 11):
        assert _stream(ld(k)) == full[k:]
    it = iter(ld)
    assert len(list(it)) == 12  # auto-closed at StopIteration
    it.load_state_dict({"version": 1, "seed": 5, "epoch": 1, "step": 2})
    assert _stream(it) == full[6:]


def test_sync_mode_produces_strictly_on_demand():
    calls = []

    class Counting(ArraySource):
        def fetch_batch(self, indices, out=None):
            calls.append(len(indices))
            return super().fetch_batch(indices, out=out)

    it = iter(DataLoader(Counting((np.zeros((32, 2)),)), 4, num_workers=0, queue_depth=4))
    next(it), next(it), next(it)
    assert len(calls) == 3
    it.close()


def test_shard_validation():
    src = ArraySource(_arrays(16))
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(src, 6, shard_index=0, shard_count=4)
    with pytest.raises(ValueError, match="out of range"):
        DataLoader(src, 8, shard_index=4, shard_count=4)
    with pytest.raises(ValueError, match="drop_remainder"):
        DataLoader(src, 8, shard_index=0, shard_count=2, drop_remainder=False)


def test_reuse_buffers_recycle():
    ids = set()
    for bx, _ in DataLoader(ArraySource(_arrays()), 4, num_epochs=3, seed=4, queue_depth=2,
                            num_workers=2, reuse_buffers=True):
        ids.add(id(bx))
    assert len(ids) < 18


def test_queue_depth_and_worker_exception():
    gauge = REGISTRY.gauge("hops_tpu_feed_stage_queue_depth", labels=("pipeline", "stage"))
    for _ in DataLoader(ArraySource(_arrays(40)), 4, num_epochs=2, num_workers=3,
                        queue_depth=3, name="t-depth"):
        assert gauge.value(pipeline="t-depth", stage="decode") <= 3

    class Boom(ArraySource):
        def fetch_batch(self, indices, out=None):
            raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(DataLoader(Boom((np.zeros((8, 2)),)), 4, num_workers=2))


def test_slow_source_starves_fast_consumer():
    class Slow(ArraySource):
        def fetch_batch(self, indices, out=None):
            time.sleep(0.03)
            return super().fetch_batch(indices, out=out)

    counter = REGISTRY.counter("hops_tpu_feed_starved_steps_total", labels=("pipeline",))
    before = counter.value(pipeline="t-starved")
    steps = sum(1 for _ in DataLoader(Slow((np.zeros((32, 2), np.float32),)), 4,
                                      num_workers=1, queue_depth=1, name="t-starved"))
    assert steps == 8 and counter.value(pipeline="t-starved") - before >= steps - 2


def test_decode_latency_histogram_observes(rio_paths):
    child = REGISTRY.histogram("hops_tpu_feed_decode_seconds",
                               labels=("pipeline",)).labels(pipeline="t-decode-hist")
    n0 = child.count
    list(DataLoader(RecordIOSource(rio_paths, decode=_rio_decode), 5, num_workers=2,
                    name="t-decode-hist"))
    assert child.count - n0 == 4


def test_run_preemptible_resumes_exact_loader_stream(tmp_path):
    from hops_tpu_torch.runtime.preemption import PreemptionGuard, run_preemptible

    ld = DataLoader(ArraySource(_arrays(16)), 4, num_epochs=3, seed=21, num_workers=2)
    reference = _stream(ld)
    seen: list = []

    def make_step(guard, stop_at):
        def train_step(state, batch):
            seen.append(_tobytes(batch))
            if guard is not None and len(seen) == stop_at:
                guard.notice()
            return {"w": state["w"] + 1.0}, {"loss": torch.zeros(())}
        return train_step

    state0 = {"w": torch.zeros(2)}
    guard = PreemptionGuard(install=False)
    _, _, done = run_preemptible(make_step(guard, 5), state0, ld,
                                 directory=str(tmp_path / "ckpts"), save_every=2,
                                 sync=False, guard=guard)
    assert done == 5
    state1, _, total = run_preemptible(make_step(None, -1), state0, ld,
                                       directory=str(tmp_path / "ckpts"), save_every=2,
                                       sync=False, guard=PreemptionGuard(install=False))
    assert total == 12 and seen == reference
    torch.testing.assert_close(state1["w"], torch.full((2,), 12.0))

