"""The port's online feature serving (``hops_tpu_torch.featurestore.online``
and ``online_serving``, the serving host's ``feature_config``) against the
JAX package's, each in its own workspace, on the scenarios of
``tests/test_online_serving.py``: ``crc32 % N`` routes every key to the
same shard, ``multi_get`` rows, TTL eviction and event-time-guarded
upserts match, snapshots carry the same manifest, the ``Materializer``
converges under duplicates and replays, ``FeatureJoinPredictor`` builds
the same vectors and errors under every missing-key policy, the port's
remote shards read the JAX package's ``shardd`` servers, and over HTTP
the joined endpoints answer as JAX's do — the echo predictor's
predictions, WideAndDeep's logits (JAX's parameters in the port's
module) within ``atol 1e-5``, the chaos case's status codes and counters,
and ``model_server="LM"``'s refusal.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import hops_tpu.featurestore as jax_hsfs
from hops_tpu.featurestore import online as jax_online
from hops_tpu.featurestore import online_serving as jax_os
from hops_tpu.jobs.placement.shardd import ShardServer
from hops_tpu.messaging import pubsub as jax_pubsub
from hops_tpu.modelrepo import serving as jax_serving
from hops_tpu.models.widedeep import WideAndDeep as JaxWideAndDeep
from hops_tpu.runtime import faultinject as jax_faultinject
from hops_tpu.runtime import qos as jax_qos
from hops_tpu.telemetry.metrics import REGISTRY as JAX_REGISTRY

import hops_tpu_torch.featurestore as hsfs
from hops_tpu_torch.featurestore import online
from hops_tpu_torch.featurestore import online_serving as tos
from hops_tpu_torch.messaging import pubsub
from hops_tpu_torch.models.convert import save_npz
from hops_tpu_torch.modelrepo import serving
from hops_tpu_torch.native import kvstore
from hops_tpu_torch.runtime import config, faultinject, qos
from hops_tpu_torch.runtime.checkpoint import CheckpointCorruptError
from hops_tpu_torch.telemetry.metrics import REGISTRY

from test_torch_featurestore import _normal, err, same

PKGS = {
    "jax": SimpleNamespace(name="hops_tpu", hsfs=jax_hsfs, online=jax_online, os=jax_os,
                           pubsub=jax_pubsub, serving=jax_serving, faultinject=jax_faultinject,
                           qos=jax_qos, registry=JAX_REGISTRY),
    "torch": SimpleNamespace(name="hops_tpu_torch", hsfs=hsfs, online=online, os=tos,
                             pubsub=pubsub, serving=serving, faultinject=faultinject, qos=qos,
                             registry=REGISTRY),
}
WAIT_S = 30.0  # the bound on every drain, join and request


@pytest.fixture(autouse=True)
def torch_workspace(tmp_path, monkeypatch):
    """The port's config in a workspace of its own (tests/conftest.py
    points the JAX package's at ``tmp_path/workspace``); faults disarmed
    in both packages afterwards."""
    torch.set_num_threads(1)
    monkeypatch.setattr(config, "_current", config.runtime())
    config.configure(workspace=str(tmp_path / "torch_ws"), project="testproj")
    yield tmp_path / "torch_ws"
    for pkg in PKGS.values():
        pkg.faultinject.disarm()


def both(scenario, tmp_path: Path | None = None):
    """``scenario(name, pkg)`` (with a scratch directory of its own when
    ``tmp_path`` is given) in each package; the outputs must be equal.
    Returns the port's."""
    outs = {}
    for name, pkg in PKGS.items():
        if tmp_path is None:
            outs[name] = scenario(name, pkg)
        else:
            tmp = tmp_path / f"scratch_{name}"
            tmp.mkdir()
            outs[name] = _normal(scenario(name, pkg, tmp), tmp, pkg.name)
    same(outs["jax"], outs["torch"])
    return outs["torch"]


def users_df(n: int = 16) -> pd.DataFrame:
    return pd.DataFrame({
        "user_id": np.arange(n),
        "score": np.arange(n, dtype=np.float64) / 4.0,
        "clicks": np.arange(n) * 3,
    })


def counter(p, name: str, **labels) -> float:
    return p.registry.counter(name, labels=tuple(labels)).value(**labels)


# -- the sharded store ---------------------------------------------------------


def test_crc32_routes_every_key_to_the_same_shard():
    entries = [{"user_id": i} for i in range(200)] + [{"user_id": f"u{i}"} for i in range(50)]

    def scenario(name, p):
        out = []
        for n in (1, 3, 4, 7):
            s = p.os.ShardedOnlineStore(f"route{n}", 1, primary_key=["user_id"], shards=n)
            out.append([s.shard_index(e) for e in entries])
            s.close()
        return out

    routes = both(scenario)
    assert len(set(routes[2])) == 4


def test_roundtrip_spread_and_scan_match_jax():
    def scenario(name, p):
        s = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=4)
        applied = s.put_dataframe(users_df(64))
        out = (applied, s.count(), s.get({"user_id": 7}), [sh.count() for sh in s._shards],
               sorted(r["user_id"] for r in s.scan()),
               s.multi_get([{"user_id": 5}, {"user_id": 99}, {"user_id": 0}]),
               err(lambda: s.get({"wrong": 1})))
        s.close()
        return out

    out = both(scenario)
    assert out[2] == {"user_id": 7, "score": 1.75, "clicks": 21} and min(out[3]) > 0


def test_event_time_guarded_upserts_match_jax():
    t0 = 1_700_000_000.0

    def scenario(name, p):
        s = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2)
        new = [{"user_id": 1, "score": 2.0, "event_time": t0 + 10}]
        out = [s.upsert_rows(new, event_ts="event_time"),
               s.upsert_rows(new, event_ts="event_time"),
               s.upsert_rows([{"user_id": 1, "score": -5.0, "event_time": t0}],
                             event_ts="event_time"),
               s.get({"user_id": 1}), s.watermark]
        # an older duplicate behind a newer row in one batch loses
        out.append(s.upsert_rows([{"user_id": 2, "score": 7.0, "event_time": t0 + 20},
                                  {"user_id": 2, "score": -1.0, "event_time": t0}],
                                 event_ts="event_time"))
        out += [s.get({"user_id": 2}), s.watermark]
        # partial rows merge; a new partial row stores only its columns
        s.upsert_rows([{"user_id": 3, "score": 1.0, "clicks": 3}])
        s.upsert_rows([{"user_id": 3, "score": 2.5}, {"user_id": 4, "score": 9.0, "clicks": 7}])
        s.upsert_rows([{"user_id": 5, "score": 4.0}, {"user_id": 6, "score": 5.0, "clicks": 11}])
        out += [s.get({"user_id": i}) for i in (3, 4, 5, 6)]
        s.close()
        return out

    out = both(scenario)
    assert out[3]["score"] == 2.0 and out[6]["score"] == 7.0 and out[-2] == {
        "user_id": 5, "score": 4.0}


def test_concurrent_upserts_never_roll_back_in_the_port():
    s = tos.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=1)
    t0 = time.time()
    barrier = threading.Barrier(2)
    errors: list[BaseException] = []

    def upsert(score: float, ts: float) -> None:
        try:
            barrier.wait(timeout=WAIT_S)
            for _ in range(50):
                s.upsert_rows([{"user_id": 1, "score": score, "event_time": ts}],
                              event_ts="event_time")
        except BaseException as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=upsert, args=a) for a in ((-1.0, t0), (8.0, t0 + 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert s.get({"user_id": 1})["score"] == 8.0
    s.close()


def test_ttl_expiry_and_sweep_match_jax():
    def scenario(name, p):
        s = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2, ttl_s=0.08)
        s.put_dataframe(users_df(6))
        fresh = s.get({"user_id": 2})
        expired0 = counter(p, "hops_tpu_online_lookup_total", store="users_1", result="expired")
        evicted0 = counter(p, "hops_tpu_online_evicted_rows_total", store="users_1")
        time.sleep(0.12)
        out = [fresh, s.get({"user_id": 2}),
               counter(p, "hops_tpu_online_lookup_total", store="users_1",
                       result="expired") - expired0,
               s.evict_expired(), s.count(),
               counter(p, "hops_tpu_online_evicted_rows_total", store="users_1") - evicted0]
        s.close()
        return out

    assert both(scenario)[1:] == [None, 1.0, 6, 0, 6.0]


class _FixedClock:
    """The ``time`` module with ``time()`` pinned: the stamps a store
    writes are then the same in both packages."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time() -> float:
        return 1_700_000_000.5


def test_snapshot_manifests_and_restore_match_jax(tmp_path, monkeypatch):
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.os, "time", _FixedClock())

    def scenario(name, p, tmp):
        s = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=4)
        s.put_dataframe(users_df(32))
        snap = s.snapshot(tmp / "snap")
        manifest = (snap / "manifest.json").read_text()
        s2 = p.os.ShardedOnlineStore("users_replica", 1, primary_key=["user_id"], shards=2,
                                     root=tmp / "replica")
        out = [manifest, s2.restore_snapshot(snap), s2.count(), s2.get({"user_id": 9}),
               s2.watermark]
        victim = sorted(snap.glob("shard*.jsonl"))[0]
        data = victim.read_bytes()
        victim.write_bytes(bytes([data[0] ^ 0xFF]) + data[1:])
        s3 = p.os.ShardedOnlineStore("users_r3", 1, primary_key=["user_id"], root=tmp / "r")
        out.append(err(lambda: s3.restore_snapshot(snap)))
        s.close(); s2.close(); s3.close()
        return out

    out = both(scenario, tmp_path)
    assert out[1] == 32 and out[-1][0] == "CheckpointCorruptError"
    assert CheckpointCorruptError.__name__ == out[-1][0]


def test_dead_shard_degrades_and_breaker_opens_as_in_jax(monkeypatch):
    def scenario(name, p):
        s = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2,
                                    breaker_failures=2, breaker_reset_s=30.0)
        s.put_dataframe(users_df(8))
        monkeypatch.setattr(s._shards[0], "get_many",
                            lambda pks: (_ for _ in ()).throw(OSError("shard down")))
        entries = [{"user_id": i} for i in range(8)]
        rounds = [s.multi_get(entries) for _ in range(3)]
        out = (rounds, [s.shard_index(e) for e in entries],
               [b.state for b in s._breakers])
        s.close()
        return out

    rounds, shards, states = both(scenario)
    assert states == ["open", "closed"]
    assert all((row is None) == (sh == 0) for row, sh in zip(rounds[-1], shards))


def test_lookup_deadline_degrades_to_missing_in_the_port(monkeypatch):
    s = tos.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=1)
    s.put_dataframe(users_df(4))

    def slow_lookup(shard, pk_lists):
        time.sleep(0.5)
        return [None] * len(pk_lists)

    monkeypatch.setattr(tos.ShardedOnlineStore, "_shard_lookup", staticmethod(slow_lookup))
    t0 = time.perf_counter()
    assert s.multi_get([{"user_id": 1}], deadline_s=0.05) == [None]
    assert time.perf_counter() - t0 < 0.4
    s.close()


@pytest.mark.parametrize("fanout", [False, True])
def test_fault_point_feeds_missing_policy_as_in_jax(fanout):
    def scenario(name, p):
        s = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2,
                                    fanout=fanout)
        s.put_dataframe(users_df(4))
        entries = [{"user_id": i} for i in range(4)]
        p.faultinject.arm("online.lookup=error:OSError@times=2")
        faulted = s.multi_get(entries)
        p.faultinject.disarm()
        out = (faulted, s.multi_get(entries))
        s.close()
        return out

    faulted, healthy = both(scenario)
    assert faulted == [None] * 4 and all(r is not None for r in healthy)


def test_fanout_results_match_sequential_and_jax():
    def scenario(name, p):
        out = []
        for fanout in (False, True):
            s = p.os.ShardedOnlineStore(f"fo_{fanout}", 1, primary_key=["user_id"], shards=4,
                                        fanout=fanout)
            s.put_dataframe(users_df(32))
            entries = [{"user_id": i} for i in range(40)]
            out.append((s.multi_get(entries), s.multi_get(entries, deadline_s=5.0)))
            s.close()
        return out

    seq, fan = both(scenario)
    assert seq == fan


def test_straggler_is_hedged_in_the_port():
    s = tos.ShardedOnlineStore("fo_hedge", 1, primary_key=["user_id"], shards=4)
    s.put_dataframe(users_df(32))
    entries = [{"user_id": i} for i in range(32)]
    for _ in range(12):
        s.multi_get(entries)
    hedges = REGISTRY.counter("hops_tpu_online_shard_hedges_total", labels=("store",))
    base = hedges.value(store=s.label)
    faultinject.arm("shard.lookup=latency:0.4@key=2,times=1")
    t0 = time.perf_counter()
    rows = s.multi_get(entries, deadline_s=2.0)
    assert all(r is not None for r in rows) and time.perf_counter() - t0 < 0.35
    assert hedges.value(store=s.label) - base >= 1 and s._breakers[2].state == "closed"
    s.close()


def test_brownout_shrinks_the_join_deadline_in_the_port(monkeypatch):
    s = tos.ShardedOnlineStore("fo_brown", 1, primary_key=["user_id"], shards=4, hedge=False)
    s.put_dataframe(users_df(32))
    predictor = tos.FeatureJoinPredictor(
        lambda vectors: vectors,
        {"groups": [{"name": "fo_brown", "primary_key": ["user_id"], "features": ["f0"]}],
         "order": ["f0"], "missing": "default", "defaults": {"f0": -1.0},
         "brownout_lookup_deadline_s": 0.05},
        model="brownout-test", stores={"fo_brown": s})
    monkeypatch.setattr(tos.ShardedOnlineStore, "_shard_lookup",
                        staticmethod(lambda shard, pks: time.sleep(0.4) or [None] * len(pks)))
    qos.set_brownout(qos.DEGRADE, hold_s=30.0)
    try:
        t0 = time.perf_counter()
        assert predictor.join([{"user_id": 1}]) == [[-1.0]]
        assert time.perf_counter() - t0 < 0.3
    finally:
        qos.set_brownout(0)
        s.close()


def test_port_reads_a_store_the_jax_package_wrote(tmp_path):
    """One directory, both packages: the port's store adopts the layout
    JAX's wrote (its shard count from the meta file) and reads every row
    from the native shard files."""
    root = tmp_path / "online"
    w = jax_os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=3, root=root)
    w.put_dataframe(users_df(40))
    entries = [{"user_id": i} for i in range(45)]
    want = w.multi_get(entries)
    w.close()
    r = tos.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=8, root=root)
    assert len(r._shards) == 3
    assert r.multi_get(entries) == want and r.count() == 40
    assert all(isinstance(sh._impl, kvstore.NativeKV) for sh in r._shards)
    r.close()


# -- row decode and formats ----------------------------------------------------


def test_batched_row_decode_matches_jax():
    def scenario(name, p):
        return (p.online._decode_rows(['{"a": 1}', None, '{"b": [2, 3]}', '{"c": "x,y"}', None]),
                p.online._decode_rows([None, None]),
                err(lambda: p.online._decode_rows(['{"a": 1}', "1,2", '{"b": 2}']))[0],
                err(lambda: p.online._decode_rows(['{"a": 1}', '{"broken']))[0])

    both(scenario)


def test_mixed_row_formats_match_jax(tmp_path, monkeypatch):
    def scenario(name, p, tmp):
        store = p.online.OnlineStore(tmp / "mix")
        monkeypatch.setenv("HOPS_TPU_ONLINE_ROW_FORMAT", "json")
        store.put_dataframe(users_df(8), primary_key=["user_id"])
        monkeypatch.setenv("HOPS_TPU_ONLINE_ROW_FORMAT", "packed")
        store.put_dataframe(users_df(16).iloc[8:], primary_key=["user_id"])
        out = (store.get_many([[k] for k in range(17)]),
               sorted(store.scan(), key=lambda r: r["user_id"]))
        monkeypatch.setenv("HOPS_TPU_ONLINE_ROW_FORMAT", "msgpack")
        out += (err(lambda: store.put_dataframe(users_df(2), primary_key=["user_id"])),)
        monkeypatch.delenv("HOPS_TPU_ONLINE_ROW_FORMAT")
        store.close()
        return out

    rows, scanned, refused = both(scenario, tmp_path)
    assert {type(r["score"]) for r in scanned} == {float} and rows[-1] is None
    assert refused[0] == "ValueError"


@pytest.mark.parametrize("backend", ["sqlite", "native"])
def test_online_store_reads_race_no_flush_in_the_port(backend, tmp_path, monkeypatch):
    if backend == "sqlite":
        monkeypatch.setattr(kvstore, "available", lambda: False)
    store = online.OnlineStore(tmp_path / backend)
    assert store._impl.reader_safe == (backend == "sqlite")
    errors: list[BaseException] = []
    done = threading.Event()

    def writer() -> None:
        try:
            for version in range(25):
                store.put_dataframe(pd.DataFrame({"id": np.arange(20),
                                                  "v": np.full(20, version)}), ["id"])
        except BaseException as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)
        finally:
            done.set()

    def reader() -> None:
        try:
            while not done.is_set():
                store.get([3])
                store.count()
                for _ in store.scan():
                    pass
        except BaseException as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader)
                                                   for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert store.count() == 20 and store.get([3])["v"] == 24
    store.close()
    if backend == "sqlite":
        assert store._impl._readers == []


def test_kvstore_binds_once_across_threads_in_the_port():
    old = kvstore._bound
    try:
        with kvstore._bind_lock:
            kvstore._bound = None
        results: list = []
        barrier = threading.Barrier(8)

        def bind() -> None:
            barrier.wait(timeout=WAIT_S)
            results.append(kvstore._lib())

        threads = [threading.Thread(target=bind) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert len(results) == 8 and len({id(r) for r in results}) == 1
    finally:
        with kvstore._bind_lock:
            kvstore._bound = old


# -- the materializer ----------------------------------------------------------


def test_write_through_consistency_matches_jax():
    def scenario(name, p):
        fs = p.hsfs.connection().get_feature_store()
        fg = fs.create_feature_group("trips", version=1, primary_key=["trip_id"])
        df1 = pd.DataFrame({"trip_id": [1, 2, 3], "fare": [10.0, 20.0, 30.0]})
        fg.save(df1)
        store = p.os.ShardedOnlineStore("trips", 1, primary_key=["trip_id"], shards=3)
        topic = p.pubsub.create_topic("trips-updates")
        producer = p.pubsub.Producer(topic)
        t_mark = time.time()
        for rec in df1.to_dict(orient="records"):
            producer.send({**rec, "event_time": t_mark})
        daemon = p.os.Materializer(store, topic, event_time="event_time").start()
        drained = [daemon.drain(WAIT_S)]
        df2 = pd.DataFrame({"trip_id": [2, 4], "fare": [25.0, 40.0]})
        fg.insert(df2)
        t_mark2 = time.time()
        for rec in df2.to_dict(orient="records"):
            producer.send({**rec, "event_time": t_mark2})
        drained.append(daemon.drain(WAIT_S))
        daemon.stop()
        offline = fg.read().sort_values("trip_id", ignore_index=True)
        online_rows = pd.DataFrame(sorted(store.scan(), key=lambda r: r["trip_id"]))
        wm = store.watermark
        store.close()
        assert wm == pytest.approx(t_mark2)
        return drained, offline, online_rows.drop(columns=["event_time"])

    drained, offline, online_rows = both(scenario)
    assert drained == [True, True]
    pd.testing.assert_frame_equal(offline, online_rows)


def test_replays_duplicates_and_poison_converge_as_in_jax():
    def scenario(name, p):
        store = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2)
        topic = p.pubsub.create_topic("users-updates")
        producer = p.pubsub.Producer(topic)
        for i in range(6):
            producer.send({"user_id": i, "score": float(i)})
            producer.send({"user_id": i, "score": float(i)})  # a duplicate
        producer.send("not-a-row")
        producer.send({"score": 3.0})  # no primary key
        d1 = p.os.Materializer(store, topic, group="g1").start()
        out = [d1.drain(WAIT_S), d1.alive]
        d1.stop()
        out.append(sorted(store.scan(), key=lambda r: r["user_id"]))
        d2 = p.os.Materializer(store, topic, group="g2").start()  # a whole-topic replay
        out.append(d2.drain(WAIT_S))
        d2.stop()
        out.append(sorted(store.scan(), key=lambda r: r["user_id"]))
        producer.send({"user_id": 9, "score": 9.0})
        c = p.pubsub.Consumer(topic, group="g1", from_beginning=True)
        out.append(0 < c.offset < c.end_offset())  # a restarted group resumes at its commit
        d3 = p.os.Materializer(store, topic, group="g1").start()
        out.append(d3.drain(WAIT_S))
        d3.stop()
        out.append(store.count())
        store.close()
        return out

    out = both(scenario)
    assert out[2] == out[4] and out[-1] == 7 and out[5]


def test_daemon_survives_injected_faults_as_in_jax():
    def scenario(name, p):
        store = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2)
        topic = p.pubsub.create_topic("users-updates")
        p.pubsub.Producer(topic).send({"user_id": 7, "score": 1.0})
        p.faultinject.arm("online.materialize=error:OSError@times=2")
        daemon = p.os.Materializer(store, topic, poll_interval_s=0.01).start()
        out = [daemon.drain(WAIT_S), daemon.alive]
        daemon.stop()
        p.faultinject.disarm()
        out.append(store.get({"user_id": 7}))
        store.close()
        return out

    assert both(scenario) == [True, True, {"user_id": 7, "score": 1.0}]


# -- the join ------------------------------------------------------------------


def _join_store(p):
    s = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2)
    s.put_dataframe(users_df(8))
    return s


@pytest.mark.parametrize("policy", ["default", "reject", "passthrough"])
def test_join_vectors_and_errors_match_jax(policy):
    entries = [{"user_id": 4}, {"user_id": 99}, {"user_id": 1}]

    def scenario(name, p):
        s = _join_store(p)
        fj = p.os.FeatureJoinPredictor(
            lambda vecs: vecs,
            {"groups": [{"name": "users", "version": 1, "primary_key": ["user_id"],
                         "features": ["score", "clicks"]}],
             "missing": policy, "defaults": {"score": -1.0}},
            model=f"m-{policy}", stores={"users": s})
        before = counter(p, "hops_tpu_online_missing_keys_total", model=f"m-{policy}",
                         policy=policy)
        out = [fj.order, fj.predict(entries[:1])]
        out.append(err(lambda: fj.predict(entries)) if policy == "reject"
                   else fj.predict(entries))
        out.append(counter(p, "hops_tpu_online_missing_keys_total", model=f"m-{policy}",
                           policy=policy) - before)
        s.close()
        return out

    out = both(scenario)
    # reject raises at the first missing feature; the others count both
    assert out[1] == [[1.0, 12]] and out[-1] == (1.0 if policy == "reject" else 2.0)


def test_two_group_join_and_inner_callable_match_jax():
    def scenario(name, p):
        users = _join_store(p)
        items = p.os.ShardedOnlineStore("items", 1, primary_key=["item_id"], shards=2)
        items.put_dataframe(pd.DataFrame({"item_id": [0, 1], "price": [9.5, 19.5]}))
        fj = p.os.FeatureJoinPredictor(
            lambda vecs: [sum(v) for v in vecs],
            {"groups": [
                {"name": "users", "version": 1, "primary_key": ["user_id"],
                 "features": ["score"]},
                {"name": "items", "version": 1, "primary_key": ["item_id"],
                 "features": ["price"]}]},
            stores={"users": users, "items": items})
        out = (fj.join([{"user_id": 2, "item_id": 1}, {"user_id": 3, "item_id": 0}]),
               fj.predict([{"user_id": 2, "item_id": 1}]))
        users.close(); items.close()
        return out

    assert both(scenario) == ([[0.5, 19.5], [0.75, 9.5]], [20.0])


def test_validate_feature_config_matches_jax():
    bad = [
        {"groups": [{"name": "u", "primary_key": ["id"], "features": ["a"]}],
         "missing": "explode"},
        {"missing": "default"},
        {"groups": [{"name": "u"}]},
        {"groups": [{"name": "u", "primary_key": ["id"]}]},
        {"groups": [{"name": "u", "primary_key": ["id"], "features": ["a"],
                     "endpoints": ["ftp://x"]}]},
    ]

    def scenario(name, p):
        good = p.os.validate_feature_config({"groups": [
            {"name": "U", "primary_key": ["ID"], "features": ["A"]}], "order": ["A"]})
        return good, [err(lambda c=c: p.os.validate_feature_config(c)) for c in bad]

    _, errors = both(scenario)
    assert [e[0] for e in errors] == ["ValueError"] * len(bad)


# -- remote shards ---------------------------------------------------------------


def test_remote_shards_read_the_jax_shard_servers(tmp_path):
    """The port's ``_RemoteShard`` against the JAX package's ``shardd``:
    the same rows as the local store, over packed and JSON replies, and
    a stamped stale generation degrades to missing keys."""
    local = tos.ShardedOnlineStore("profile", 1, primary_key=["uid"], shards=3,
                                   root=tmp_path / "local")
    df = pd.DataFrame({"uid": np.arange(30), "f": np.arange(30) / 8.0})
    local.put_dataframe(df)
    entries = [{"uid": i} for i in range(34)]
    want = local.multi_get(entries)
    servers = []
    try:
        for i, codecs in enumerate((["json", "packed"], ["json"], ["json", "packed"])):
            srv = ShardServer({"store": "profile", "version": 1, "shard_index": i, "shards": 3,
                               "primary_key": ["uid"], "root": str(tmp_path / f"srv{i}"),
                               "codecs": codecs, "slot": f"profile/{i}", "generation": 1})
            srv._put_rows([r for r in df.to_dict(orient="records")
                           if local.shard_index({"uid": r["uid"]}) == i])
            servers.append(srv)
        endpoints = [f"http://127.0.0.1:{s.port}" for s in servers]
        remote = tos.ShardedOnlineStore("profile", 1, primary_key=["uid"],
                                        endpoints=endpoints, root=tmp_path / "client")
        jax_remote = jax_os.ShardedOnlineStore("profile", 1, primary_key=["uid"],
                                               endpoints=endpoints, root=tmp_path / "jclient")
        got = remote.multi_get(entries)
        assert got == want == jax_remote.multi_get(entries)
        assert remote.count() == 30
        stale = tos._RemoteShard(endpoints[0], generation_token="profile/0:0")
        with pytest.raises(tos.GenerationSupersededError):
            stale.get_many([[0]])
        stale.close()
        remote.close()
        jax_remote.close()
    finally:
        for s in servers:
            s.stop()
        local.close()


# -- the serving host ----------------------------------------------------------

ECHO = "class Predict:\n    def predict(self, instances):\n        return instances\n"

JAX_WIDEDEEP = '''
import jax
import jax.numpy as jnp

from hops_tpu.models.widedeep import WideAndDeep, batch_from_vectors


class Predict:
    def __init__(self):
        self._model = WideAndDeep(vocab_sizes=(8, 8), embed_dim=4, hidden=(16,),
                                  dtype=jnp.float32)
        self._params = self._model.init(
            jax.random.PRNGKey(0),
            {"dense": jnp.zeros((1, 3), jnp.float32),
             "categorical": jnp.zeros((1, 2), jnp.int32)})["params"]

    def predict(self, instances):
        out = self._model.apply({"params": self._params},
                                batch_from_vectors(instances, num_dense=3))
        return [list(map(float, row)) for row in out]
'''

TORCH_WIDEDEEP = '''
from pathlib import Path

import torch

from hops_tpu_torch.models.convert import params_from_flax
from hops_tpu_torch.models.widedeep import WideAndDeep, batch_from_vectors


class Predict:
    def __init__(self):
        self._model = WideAndDeep((8, 8), embed_dim=4, hidden=(16,), dtype="float32",
                                  num_dense=3, device="cpu")
        self._model.load_state_dict(params_from_flax(Path(__file__).parent / "params.npz"))

    @torch.inference_mode()
    def predict(self, instances):
        return self._model(batch_from_vectors(instances, num_dense=3)).tolist()
'''

WD_ORDER = ["d0", "d1", "d2", "c0", "c1"]


def _model_dir(tmp: Path, body: str) -> Path:
    d = tmp / "model"
    d.mkdir()
    (d / "predictor.py").write_text(body)
    return d


def _create(p, name: str, model_dir: Path, feature_config: dict, **kw):
    extra = {"device": "cpu"} if p.name == "hops_tpu_torch" else {}
    p.serving.create_or_update(name, model_path=str(model_dir), model_server="PYTHON",
                               feature_config=feature_config, **kw, **extra)


def test_echo_endpoint_joins_as_jax_does(tmp_path):
    def scenario(name, p, tmp):
        store = p.os.ShardedOnlineStore("users", 1, primary_key=["user_id"], shards=2)
        store.put_dataframe(users_df(8))
        store.close()
        _create(p, "joined", _model_dir(tmp, ECHO), {
            "groups": [{"name": "users", "version": 1, "primary_key": ["user_id"],
                        "features": ["score", "clicks"]}],
            "missing": "default"}, batching_enabled=True)
        p.serving.start("joined")
        try:
            return [p.serving.make_inference_request(
                "joined", {"instances": [{"user_id": i} for i in ids]})
                for ids in ([2, 5], [7], [99, 0, 3])]
        finally:
            p.serving.stop("joined")

    out = both(scenario, tmp_path)
    assert out[0]["predictions"] == [[0.5, 6], [1.25, 15]]


def test_widedeep_endpoint_matches_jax(tmp_path):
    """JAX's WideAndDeep behind JAX's endpoint and the port's, loaded
    with the same parameters, behind the port's: a request of entity IDs
    gives logits within 1e-5 (fp32), and the port's equal its own module
    on the offline-assembled vectors bit for bit."""
    rs = np.random.RandomState(7)
    n = 12
    df = pd.DataFrame({"user_id": np.arange(n), "d0": rs.randn(n), "d1": rs.randn(n),
                       "d2": rs.randn(n), "c0": rs.randint(0, 8, n), "c1": rs.randint(0, 8, n)})
    params = JaxWideAndDeep(vocab_sizes=(8, 8), embed_dim=4, hidden=(16,),
                            dtype=jnp.float32).init(
        jax.random.PRNGKey(0), {"dense": jnp.zeros((1, 3), jnp.float32),
                                "categorical": jnp.zeros((1, 2), jnp.int32)})["params"]
    entities = [3, 0, 11, 7, 5]
    body = {"jax": JAX_WIDEDEEP, "torch": TORCH_WIDEDEEP}
    out, offline = {}, {}
    for name, p in PKGS.items():
        tmp = tmp_path / f"scratch_{name}"
        tmp.mkdir()
        fg = p.hsfs.connection().get_feature_store().create_feature_group(
            "wd_users", version=1, primary_key=["user_id"])
        fg.save(df)
        store = p.os.ShardedOnlineStore("wd_users", 1, primary_key=["user_id"], shards=4)
        topic = p.pubsub.create_topic("wd-users-updates")
        producer = p.pubsub.Producer(topic)
        for rec in df.to_dict(orient="records"):
            producer.send(rec)
        daemon = p.os.Materializer(store, topic).start()
        assert daemon.drain(WAIT_S)
        daemon.stop()
        store.close()
        offline[name] = fg.read()
        model_dir = _model_dir(tmp, body[name])
        save_npz(model_dir / "params.npz", params)
        _create(p, "widedeep", model_dir, {
            "groups": [{"name": "wd_users", "version": 1, "primary_key": ["user_id"],
                        "features": WD_ORDER, "shards": 4}],
            "order": WD_ORDER, "missing": "reject"})
        p.serving.start("widedeep")
        try:
            out[name] = p.serving.make_inference_request(
                "widedeep", {"instances": [{"user_id": e} for e in entities]})["predictions"]
        finally:
            p.serving.stop("widedeep")
    pd.testing.assert_frame_equal(offline["torch"], offline["jax"])
    np.testing.assert_allclose(out["torch"], out["jax"], atol=1e-5, rtol=0)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "wd_twin", tmp_path / "scratch_torch" / "model" / "predictor.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    by_id = offline["torch"].set_index("user_id")
    vectors = [[float(by_id.loc[e, f]) for f in WD_ORDER] for e in entities]
    assert out["torch"] == twin.Predict().predict(vectors)


def test_chaos_case_answers_as_jax_does(tmp_path):
    """Lookups broken by the ``online.lookup`` fault point and the daemon
    killed: every request still answers 200 with the defaults, the
    missing-key counter rises by the same count, the lag rises."""
    def scenario(name, p, tmp):
        fg = p.hsfs.connection().get_feature_store().create_feature_group(
            "ch_users", version=1, primary_key=["user_id"])
        fg.save(users_df(8))
        store = p.os.ShardedOnlineStore("ch_users", 1, primary_key=["user_id"], shards=2)
        topic = p.pubsub.create_topic("ch-users-updates")
        producer = p.pubsub.Producer(topic)
        t_mark = time.time()
        for rec in users_df(8).to_dict(orient="records"):
            producer.send({**rec, "event_time": t_mark})
        daemon = p.os.Materializer(store, topic, event_time="event_time").start()
        assert daemon.drain(WAIT_S)
        _create(p, "chaos-joined", _model_dir(tmp, ECHO), {
            "groups": [{"name": "ch_users", "version": 1, "primary_key": ["user_id"],
                        "features": ["score", "clicks"], "shards": 2}],
            "missing": "default", "defaults": {"score": -1.0, "clicks": -1.0}})
        p.serving.start("chaos-joined")
        lag = p.registry.gauge("hops_tpu_online_freshness_lag_seconds", labels=("store",))
        try:
            out = [p.serving.make_inference_request("chaos-joined",
                                                    {"instances": [{"user_id": 1}]})]
            lag0 = lag.value(store="ch_users_1")
            daemon.stop()
            producer.send({"user_id": 1, "score": 9.9, "clicks": 99, "event_time": time.time()})
            p.faultinject.arm(p.faultinject.FaultPlan.parse("online.lookup=error:OSError"))
            before = counter(p, "hops_tpu_online_missing_keys_total", model="chaos-joined",
                             policy="default")
            time.sleep(0.3)
            port = p.serving._servers["chaos-joined"].port
            for uid in range(4):
                out.append(p.serving.make_inference_request(
                    "chaos-joined", {"instances": [{"user_id": uid}]}))
            out.append(counter(p, "hops_tpu_online_missing_keys_total", model="chaos-joined",
                               policy="default") - before)
            lag1 = lag.value(store="ch_users_1")
            out.append(lag1 > lag0 and lag1 >= 0.3)
            import urllib.request

            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/models/chaos-joined:predict",
                data=b'{"instances": [{"user_id": 2}]}',
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                out.append(r.status)
            return out
        finally:
            p.faultinject.disarm()
            p.serving.stop("chaos-joined")
            store.close()

    out = both(scenario, tmp_path)
    assert out[0]["predictions"] == [[0.25, 3]]
    assert out[1:5] == [{"predictions": [[-1.0, -1.0]]}] * 4 and out[5:] == [8.0, True, 200]


def test_lm_server_refuses_feature_config_as_jax_does():
    def scenario(name, p):
        return err(lambda: p.serving.create_or_update(
            "lm-joined", model_path="x", model_server="LM",
            feature_config={"groups": [{"name": "u", "primary_key": ["id"],
                                        "features": ["a"]}]}))

    kind, message = both(scenario)
    assert kind == "ValueError" and "token stream" in message
