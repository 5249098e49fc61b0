"""The port's placement control plane (``hops_tpu_torch.jobs.placement``)
held to the JAX package's: every scenario of ``tests/test_placement.py``
— the host registry, the lease, hostd's verbs, the placement client, the
placed fleet's joined predictions bit-identical to local placement, a
host killed and partitioned mid-traffic, the codec handshake, and the
multi-host bench tier — runs through both packages in this process, each
in its own workspace (the harness of ``tests/test_torch_fleet.py``).
Process units are checked to run the package's own modules.
"""

from __future__ import annotations

import json
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import pandas as pd
import pytest

from hops_tpu.featurestore.online_serving import ShardedOnlineStore as j_ShardedOnlineStore
from hops_tpu.jobs import placement as j_placement
from hops_tpu.modelrepo import fleet as j_fleet
from hops_tpu.modelrepo import registry as j_registry
from hops_tpu.modelrepo import serving as j_serving
from hops_tpu.modelrepo.fleet.autoscale import AutoscalePolicy as j_AutoscalePolicy
from hops_tpu.runtime import faultinject as j_faultinject
from hops_tpu.runtime import flight as j_flight
from hops_tpu.runtime import wirecodec as j_wirecodec
from hops_tpu.telemetry.metrics import REGISTRY as j_REGISTRY

from hops_tpu_torch.featurestore.online_serving import ShardedOnlineStore as t_ShardedOnlineStore
from hops_tpu_torch.jobs import placement as t_placement
from hops_tpu_torch.modelrepo import fleet as t_fleet
from hops_tpu_torch.modelrepo import registry as t_registry
from hops_tpu_torch.modelrepo import serving as t_serving
from hops_tpu_torch.modelrepo.fleet.autoscale import AutoscalePolicy as t_AutoscalePolicy
from hops_tpu_torch.runtime import faultinject as t_faultinject
from hops_tpu_torch.runtime import flight as t_flight
from hops_tpu_torch.runtime import wirecodec as t_wirecodec
from hops_tpu_torch.telemetry.metrics import REGISTRY as t_REGISTRY
from test_torch_fleet import bench_tier, in_both, worker_module

NAMES = {
    pkg: dict(ShardedOnlineStore=store, placement=placement, fleet=fleet,
              registry=registry, serving=serving,
              AutoscalePolicy=policy, faultinject=fi, flight=flight,
              wirecodec=codec, REGISTRY=metrics, METRICS=metrics)
    for pkg, store, placement, fleet, registry, serving, policy, fi, flight,
    codec, metrics in [
        ("jax", j_ShardedOnlineStore, j_placement, j_fleet, j_registry,
         j_serving, j_AutoscalePolicy, j_faultinject, j_flight, j_wirecodec,
         j_REGISTRY),
        ("torch", t_ShardedOnlineStore, t_placement, t_fleet, t_registry,
         t_serving, t_AutoscalePolicy, t_faultinject, t_flight, t_wirecodec,
         t_REGISTRY),
    ]
}
# Bound per run by the harness; these module values only serve linters.
globals().update(NAMES["torch"])
PKG = "hops_tpu_torch"


def _fx_hostds(tmp_path):
    """Two in-process hostd agents (the fast unit tier: the control
    plane is the real HTTP surface under test; units skip fork+import)."""
    agents = [
        placement.Hostd(f"h{i}", inprocess_units=True,
                        unit_root=tmp_path / f"h{i}")
        for i in range(2)
    ]
    yield agents
    for a in agents:
        try:
            a.stop()
        except Exception:  # noqa: BLE001 — one may be chaos-killed
            pass


def _client(agents, **kw):
    return placement.PlacementClient(
        placement.HostRegistry(hosts=[a.host() for a in agents]), **kw)


def _export(name: str, body: str) -> int:
    d = Path(tempfile.mkdtemp(prefix="placement_art_"))
    (d / "p.py").write_text(
        "class Predict:\n"
        "    def predict(self, instances):\n"
        f"        {body}\n"
    )
    return registry.export(d, name, metrics={"v": 1.0})["version"]


def _shard_cfg(store: str, i: int, n: int, root: Path,
               snapshot: Path | None = None) -> dict:
    cfg = {"store": store, "version": 1, "shard_index": i, "shards": n,
           "primary_key": ["user_id"], "root": str(root), "port": 0}
    if snapshot is not None:
        cfg["snapshot"] = str(snapshot)
    return cfg


class _Traffic:
    """Client threads hammering a fleet; every response recorded."""

    def __init__(self, f, expect_fn, clients: int = 3, period_s: float = 0.004):
        self.f = f
        self.expect_fn = expect_fn
        self.period_s = period_s
        self.errors: list[BaseException] = []
        self.bad: list = []
        self.done = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True)
            for i in range(clients)
        ]

    def _run(self, seed: int) -> None:
        i = seed
        while not self._stop.is_set():
            i += 1
            try:
                out = self.f.predict([[i]], timeout_s=10.0)
                with self._lock:
                    self.done += 1
                if out["predictions"] != self.expect_fn(i):
                    with self._lock:
                        self.bad.append((i, out["predictions"]))
            except BaseException as e:  # noqa: BLE001 — recorded, asserted on
                with self._lock:
                    self.errors.append(e)
            self._stop.wait(self.period_s)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)


def users_df(n: int = 16) -> pd.DataFrame:
    return pd.DataFrame({
        "user_id": list(range(n)),
        "score": [i * 0.25 for i in range(n)],
        "clicks": [i * 3 for i in range(n)],
    })


# -- host registry ------------------------------------------------------------


@in_both
class TestHostRegistry:
    def test_static_config_and_endpoints(self, tmp_path):
        reg = placement.HostRegistry.from_config([
            {"name": "b", "address": "10.0.0.5", "port": 7071},
            {"name": "a", "port": 7070},
        ])
        hosts = reg.hosts()
        assert [h.name for h in hosts] == ["a", "b"]  # sorted, stable
        assert hosts[0].address == "127.0.0.1"  # default
        assert hosts[1].endpoint == "http://10.0.0.5:7071"
        # The same shape round-trips through a JSON file.
        p = tmp_path / "hosts.json"
        p.write_text(json.dumps(
            [{"name": h.name, "address": h.address, "port": h.port}
             for h in hosts]))
        assert placement.HostRegistry.from_config(p).hosts() == hosts

    def test_announce_join_ttl_ageout_and_retract(self, tmp_path):
        d = tmp_path / "announce"
        now = [0.0]
        reg = placement.HostRegistry(announce_dir=d, ttl_s=5.0,
                                     clock=lambda: now[0])
        assert reg.hosts() == []
        a = placement.Hostd("ann0", inprocess_units=True, announce_dir=d,
                            unit_root=tmp_path / "u")
        try:
            assert [h.name for h in reg.hosts()] == ["ann0"]
            assert reg.get("ann0").port == a.port
        finally:
            a.stop()
        # Clean shutdown retracts the announce entirely.
        assert not (d / "ann0.json").exists()
        assert reg.hosts() == []
        # A crashed host never retracts — it just goes silent: its
        # record stops changing and ages out ttl_s after the registry
        # last observed fresh content (receiver-side arrival aging).
        placement.HostRegistry.announce(
            d, placement.Host("dead", "127.0.0.1", 7070))
        assert [h.name for h in reg.hosts()] == ["dead"]
        now[0] += 5.1
        assert reg.hosts() == []
        # A re-announce (fresh content) rejoins immediately.
        placement.HostRegistry.announce(
            d, placement.Host("dead", "127.0.0.1", 7070))
        assert [h.name for h in reg.hosts()] == ["dead"]

    def test_announce_aging_by_arrival_not_sender_ts(self, tmp_path):
        """The sender's ``ts`` stamp is display metadata: a hostd with a
        wall clock hours behind (or ahead) must neither be prematurely
        expired nor immortalized — liveness is 'the content changed
        within ttl_s of OUR monotonic clock'."""
        d = tmp_path / "announce"
        now = [100.0]
        reg = placement.HostRegistry(announce_dir=d, ttl_s=5.0,
                                     clock=lambda: now[0])
        placement.HostRegistry.announce(
            d, placement.Host("skew", "127.0.0.1", 7070))
        p = d / "skew.json"
        rec = json.loads(p.read_text())
        # An hour behind: sender-clock aging would call this long dead.
        rec["ts"] -= 3600.0
        p.write_text(json.dumps(rec))
        assert [h.name for h in reg.hosts()] == ["skew"]
        # Two hours ahead: sender-clock aging would immortalize it.
        rec["ts"] += 7200.0
        p.write_text(json.dumps(rec))
        assert [h.name for h in reg.hosts()] == ["skew"]
        # Unchanged content + our clock advancing is the ONLY age-out.
        now[0] += 4.9
        assert [h.name for h in reg.hosts()] == ["skew"]
        now[0] += 0.2
        assert reg.hosts() == []

    def test_static_and_announce_compose(self, tmp_path):
        d = tmp_path / "announce"
        placement.HostRegistry.announce(
            d, placement.Host("live", "127.0.0.1", 7171))
        reg = placement.HostRegistry(
            hosts=[placement.Host("fixed", "127.0.0.1", 7070)],
            announce_dir=d)
        assert [h.name for h in reg.hosts()] == ["fixed", "live"]


# -- the lease (hostd's suicide pact) -----------------------------------------


@in_both
class TestLease:
    def test_expiry_fence_latch_and_rejoin(self):
        now = [0.0]
        lease = placement.Lease("h0", 1.0, clock=lambda: now[0])
        # Construction is the first grant.
        assert not lease.expired()
        assert lease.remaining_s() == pytest.approx(1.0)
        now[0] = 0.5
        lease.renew()
        now[0] = 1.4  # 0.9s since renewal: still granted
        assert not lease.expired()
        lease.renewal_failed()  # a failed announce does not extend it
        now[0] = 1.6
        assert lease.expired() and lease.remaining_s() < 0
        # The fence decision latches exactly once per expiry episode.
        assert lease.mark_fenced() is True
        assert lease.mark_fenced() is False
        assert lease.fenced
        # The renewal after a heal un-latches: host rejoins (empty).
        lease.renew()
        assert not lease.fenced and not lease.expired()
        now[0] = 2.7
        assert lease.expired() and lease.mark_fenced() is True

    def test_wall_clock_step_is_invisible(self, monkeypatch):
        """The lease measures on time.monotonic: an NTP step — hours
        forward or back — can neither fire a spurious fence nor hold
        one open."""
        lease = placement.Lease("h1", 60.0)
        monkeypatch.setattr(time, "time", lambda: 1e12)  # step forward
        assert not lease.expired()
        assert lease.remaining_s() == pytest.approx(60.0, abs=1.0)
        monkeypatch.setattr(time, "time", lambda: 0.0)  # step back
        assert not lease.expired()

    def test_invalid_ttl_rejected(self):
        with pytest.raises(ValueError, match="ttl"):
            placement.Lease("h", 0.0)


# -- hostd verbs over the real HTTP surface -----------------------------------


@in_both
class TestHostd:
    def test_spawn_units_health_reap_shard_unit(self, hostds, tmp_path):
        client = _client(hostds)
        host = hostds[0].host()
        assert client.probe(host) is True
        unit = client.spawn("shard", _shard_cfg("hd_users", 0, 1,
                                                tmp_path / "s0"))
        assert unit.kind == "shard" and unit.port > 0
        recs = client.units(unit.host)
        assert [r["uid"] for r in recs] == [unit.uid]
        assert recs[0]["state"] == "ready"
        client.reap(unit)
        assert client.units(unit.host) == []
        return unit.kind, recs[0]["state"]

    def test_unknown_kind_rejected_not_breaker_strike(self, hostds):
        client = _client(hostds)
        with pytest.raises(placement.PlacementError, match="unknown unit kind"):
            client.spawn("gpu", {})
        # A 400-shaped reject is the caller's bug, not host failure:
        # every host stays healthy.
        assert len(client.healthy_hosts()) == 2
        return [h.name for h in client.healthy_hosts()]

    def test_replica_unit_spawn_drain_reap(self, hostds):
        _export("hostd-rep", "return [[v[0] * 2] for v in instances]")
        serving.create_or_update("hostd-rep", model_name="hostd-rep",
                                 model_version=1, model_server="PYTHON")
        client = _client(hostds)
        cfg = serving._load_registry()["hostd-rep"]
        unit = client.spawn("replica", cfg)
        try:
            req = urllib.request.Request(
                f"http://{unit.address}:{unit.port}"
                "/v1/models/hostd-rep:predict",
                data=json.dumps({"instances": [[3]]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as r:
                resp = json.loads(r.read())
            assert resp["predictions"] == [[6]]
            client.drain(unit)
        finally:
            client.reap(unit)
        return resp["predictions"]

    def test_process_units_run_the_package_modules(self, tmp_path, workspace):
        """A hostd's process units are ``python -m`` children: the
        replica must run the package's ``serving_host`` and the shard
        its ``shardd`` (a worker argv naming the JAX modules would run
        the port's units on the JAX package)."""
        _export("proc-rep", "return [[v[0] * 2] for v in instances]")
        serving.create_or_update("proc-rep", model_name="proc-rep",
                                 model_version=1, model_server="PYTHON")
        agent = placement.Hostd("hp", unit_root=tmp_path / "hp",
                                spawn_timeout_s=120.0)
        client = _client([agent])
        units = []
        try:
            units.append(client.spawn(
                "replica", serving._load_registry()["proc-rep"]))
            units.append(client.spawn(
                "shard", _shard_cfg("proc_users", 0, 1, tmp_path / "ps0")))
            pids = {r["kind"]: r["pid"] for r in client.units(agent.host())}
            assert worker_module(pids["replica"]) == \
                f"{PKG}.modelrepo.serving_host"
            assert worker_module(pids["shard"]) == \
                f"{PKG}.jobs.placement.shardd"
            req = urllib.request.Request(
                f"http://{units[0].address}:{units[0].port}"
                "/v1/models/proc-rep:predict",
                data=json.dumps({"instances": [[4]]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                preds = json.loads(r.read())["predictions"]
        finally:
            for u in units:
                client.reap(u)
            agent.stop()
        return preds


# -- placement client policy --------------------------------------------------


@in_both
class TestPlacementClient:
    def test_least_placed_spread(self, hostds, tmp_path):
        client = _client(hostds)
        units = [
            client.spawn("shard", _shard_cfg("sp_users", i, 4,
                                             tmp_path / f"sp{i}"))
            for i in range(4)
        ]
        by_host = {}
        for u in units:
            by_host[u.host.name] = by_host.get(u.host.name, 0) + 1
        assert by_host == {"h0": 2, "h1": 2}
        for u in units:
            client.reap(u)
        return [u.host.name for u in units]

    def test_partitioned_host_ejected_spawn_lands_on_survivor(
            self, hostds, tmp_path):
        client = _client(hostds, breaker_failures=2, rpc_timeout_s=2.0)
        # Partition h0 deterministically: every placement RPC to it dies
        # in transit (the fault fires client-side, keyed by host name).
        faultinject.arm("placement.rpc=error:OSError@key=h0")
        unit = client.spawn("shard", _shard_cfg("pt_users", 0, 1,
                                                tmp_path / "pt0"))
        assert unit.host.name == "h1"  # placed on the survivor
        # Feed the breaker to open: h0 drops out of the healthy set.
        for _ in range(3):
            client.probe(client.registry.get("h0"))
        assert [h.name for h in client.healthy_hosts()] == ["h1"]
        assert REGISTRY.gauge(
            "hops_tpu_placement_hosts", labels=("state",)
        ).value(state="ejected") == 1
        assert REGISTRY.counter(
            "hops_tpu_placement_rpc_total", labels=("host", "verb", "outcome")
        ).value(host="h0", verb="spawn", outcome="error") >= 1
        faultinject.disarm()
        client.reap(unit)
        return unit.host.name, [h.name for h in client.healthy_hosts()]

    def test_no_healthy_host_is_a_typed_error(self, tmp_path):
        client = placement.PlacementClient(
            placement.HostRegistry(), rpc_timeout_s=0.5)
        with pytest.raises(placement.PlacementError, match="no healthy host"):
            client.spawn("shard", _shard_cfg("nh", 0, 1, tmp_path / "nh"))


# -- placed fleet + placed shards: the e2e acceptance -------------------------


@in_both
class TestPlacedServingE2E:
    def test_placed_fleet_joined_predictions_bit_identical_to_local(
            self, hostds, tmp_path, workspace):
        """Acceptance: >= 2 hostd-placed replicas joining features from
        >= 2 remote shard servers answer bit-identically to the same
        model + data on the local-placement path (local replicas, local
        shard files)."""
        df = users_df(16)
        local_store = ShardedOnlineStore(
            "pl_users", primary_key=["user_id"], shards=2)
        local_store.put_dataframe(df)
        snap = local_store.snapshot(tmp_path / "snap")

        client = _client(hostds)
        shard_units = [
            client.spawn("shard", _shard_cfg("pl_users", i, 2,
                                             tmp_path / f"ps{i}", snap))
            for i in range(2)
        ]
        endpoints = [f"http://{u.address}:{u.port}" for u in shard_units]
        assert {u.host.name for u in shard_units} == {"h0", "h1"}

        _export("pl-joined", "return [[float(sum(v))] for v in instances]")
        group = {"name": "pl_users", "version": 1,
                 "primary_key": ["user_id"],
                 "features": ["score", "clicks"], "shards": 2}
        serving.create_or_update(
            "pl-joined", model_name="pl-joined", model_version=1,
            model_server="PYTHON",
            feature_config={"groups": [dict(group, endpoints=endpoints)],
                            "missing": "reject"})
        entities = [{"user_id": e} for e in (3, 0, 11, 7, 15)]
        try:
            with fleet.start_fleet("pl-joined", 2, placement=client,
                                   scrape_interval_s=0.05) as f:
                assert len(f.manager.ready()) == 2
                # Both replicas are placed units, spread across hosts.
                assert {r.unit.host.name for r in f.manager.ready()} == \
                    {"h0", "h1"}
                placed = [f.predict(entities)["predictions"]
                          for _ in range(4)]  # hit both replicas
            # The local twin: same model, same data, local placement.
            serving.create_or_update(
                "pl-joined", model_name="pl-joined", model_version=1,
                model_server="PYTHON",
                feature_config={"groups": [group], "missing": "reject"})
            with fleet.start_fleet("pl-joined", 2, inprocess=True,
                                   scrape_interval_s=0.05) as f_local:
                local = f_local.predict(entities)["predictions"]
            expected = [[float(r["score"] + r["clicks"])]
                        for r in df.iloc[[3, 0, 11, 7, 15]].to_dict("records")]
            assert local == expected
            for p in placed:
                assert p == local  # bit-identical, every replica
        finally:
            for u in shard_units:
                client.reap(u)
            local_store.close()
        return placed

    def test_shard_warm_start_refuses_corrupt_snapshot(self, hostds, tmp_path):
        store = ShardedOnlineStore(
            "ws_users", primary_key=["user_id"], shards=2,
            root=tmp_path / "ws_local")
        store.put_dataframe(users_df(8))
        snap = store.snapshot(tmp_path / "ws_snap")
        store.close()
        (snap / "shard0.jsonl").write_bytes(b'{"user_id": 0}\n')  # bitrot
        client = _client(hostds)
        with pytest.raises(placement.PlacementError, match="Snapshot|snapshot"):
            client.spawn("shard", _shard_cfg("ws_users", 0, 2,
                                             tmp_path / "ws0", snap))
        # Shard 1's file is intact: its spawn still warm-starts.
        unit = client.spawn("shard", _shard_cfg("ws_users", 1, 2,
                                                tmp_path / "ws1", snap))
        client.reap(unit)


# -- chaos: host death + partition mid-traffic --------------------------------


@in_both
class TestPlacementChaos:
    def test_host_killed_and_partitioned_mid_traffic_zero_client_errors(
            self, hostds, tmp_path, workspace):
        """Acceptance: a remote host SIGKILLed AND partitioned (the
        ``placement.rpc`` fault point) mid-traffic — the router's
        breakers absorb the dead replicas, the placement breaker ejects
        the host, and the autoscaler re-places on the survivor with
        zero client-visible errors."""
        _export("pl-chaos", "return [[v[0] * 2] for v in instances]")
        serving.create_or_update("pl-chaos", model_name="pl-chaos",
                                 model_version=1, model_server="PYTHON")
        client = _client(hostds, breaker_failures=2, rpc_timeout_s=2.0)
        policy = AutoscalePolicy(min_replicas=2, max_replicas=4,
                                 target_load=50.0)  # heal-only: wide band
        expect = lambda i: [[i * 2]]  # noqa: E731
        with fleet.start_fleet("pl-chaos", 2, placement=client,
                               scrape_interval_s=0.05, autoscale=policy,
                               autoscale_interval_s=0.05) as f:
            victim_host = f.manager.ready()[0].unit.host.name
            victim_agent = next(a for a in hostds if a.name == victim_host)
            survivor = next(n for n in ("h0", "h1") if n != victim_host)
            with _Traffic(f, expect, clients=4) as traffic:
                time.sleep(0.15)
                # Machine death: the agent and every unit on it die
                # abruptly; placement RPCs to it are partitioned too.
                faultinject.arm(
                    f"placement.rpc=error:OSError@key={victim_host}")
                victim_agent.chaos_kill()
                # The autoscaler's reconcile + heal re-places on the
                # survivor.
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline:
                    ready = f.manager.ready()
                    if (len(ready) >= 2 and all(
                            r.unit is not None
                            and r.unit.host.name == survivor
                            for r in ready)):
                        break
                    time.sleep(0.05)
                time.sleep(0.2)  # steady traffic on the healed fleet
            faultinject.disarm()
            ready = f.manager.ready()
            assert len(ready) >= 2
            assert all(r.unit.host.name == survivor for r in ready)
            assert traffic.errors == []  # ZERO client-visible failures
            assert traffic.bad == []
            assert traffic.done > 30
            assert f.predict([[5]])["predictions"] == [[10]]
        # The placement layer saw and ejected the dead host.
        assert REGISTRY.counter(
            "hops_tpu_placement_rpc_total", labels=("host", "verb", "outcome")
        ).value(host=victim_host, verb="spawn", outcome="error") + REGISTRY.counter(
            "hops_tpu_placement_rpc_total", labels=("host", "verb", "outcome")
        ).value(host=victim_host, verb="spawn", outcome="rejected") >= 1


# -- bench tier ---------------------------------------------------------------


@in_both
def test_bench_multi_host_smoke(workspace):
    """`bench.py --multi-host --smoke` runs the whole tier — local vs
    placed fleet, local vs placed shard fan-out, warm-start identity —
    and emits a sane line."""
    result = bench_tier("run_multi_host_bench", PKG)(smoke=True)
    assert result["errors"] == 0
    assert result["rows_match"] is True
    assert result["local_rps"] > 0 and result["placed_rps"] > 0
    assert result["placement_rpcs"] >= result["replicas"]
    assert result["placed_lookups_per_sec"] > 0


@in_both
class TestPackedShardWire:
    """Codec negotiation on the remote-shard RPC: shardd advertises its
    codecs at the healthz handshake, a packed-capable shard answers
    get_many as a packed columnar frame, a JSON-only shard falls back —
    with no client-visible difference between the two."""

    def test_mixed_codec_shards_answer_identically(
            self, hostds, tmp_path, workspace):

        df = users_df(12)
        local = ShardedOnlineStore("mx_users", primary_key=["user_id"],
                                   shards=2)
        local.put_dataframe(df)
        snap = local.snapshot(tmp_path / "mx_snap")

        client = _client(hostds)
        units = [
            client.spawn("shard", _shard_cfg("mx_users", 0, 2,
                                             tmp_path / "mx0", snap)),
            # Shard 1 predates the codec: JSON-only, by config.
            client.spawn("shard", dict(
                _shard_cfg("mx_users", 1, 2, tmp_path / "mx1", snap),
                codecs=["json"])),
        ]
        remote = ShardedOnlineStore(
            "mx_users", primary_key=["user_id"],
            endpoints=[f"http://{u.address}:{u.port}" for u in units])
        try:
            keys = [{"user_id": k} for k in (3, 999, 0, 7, 11, 2)]
            decoded_before = METRICS.get(
                "hops_tpu_wire_decode_seconds").labels().count
            got = remote.multi_get(keys)
            want = local.multi_get(keys)
            assert got == want  # misses included, order preserved
            rows = got
            # The handshake split the fleet: shard 0 negotiated packed,
            # shard 1 stayed on JSON — and the packed leg actually ran.
            assert "packed" in remote._shards[0]._handshake()
            assert remote._shards[1]._handshake() == frozenset({"json"})
            assert METRICS.get(
                "hops_tpu_wire_decode_seconds").labels().count \
                > decoded_before
        finally:
            for u in units:
                client.reap(u)
            local.close()
        return rows

    def test_codecs_config_must_keep_json(self, hostds, tmp_path):
        client = _client(hostds)
        with pytest.raises(placement.PlacementError, match="json"):
            client.spawn("shard", dict(
                _shard_cfg("cx_users", 0, 1, tmp_path / "cx0"),
                codecs=["packed"]))
        # A config-shaped reject is the caller's bug, not host failure.
        assert len(client.healthy_hosts()) == 2


def test_port_spawns_in_flight_count_as_units_on_their_host(tmp_path, monkeypatch):
    """Two spawns in flight at once (a fleet starting its replicas side
    by side): the port's client counts each as a unit on the host it is
    placing on, so they land on h0 and h1, not both on h0."""
    agents = [placement.Hostd(f"h{i}", inprocess_units=True, unit_root=tmp_path / f"h{i}")
              for i in range(2)]
    try:
        client = _client(agents)
        both = threading.Barrier(2)

        def rpc(host, verb, method, path, body, timeout_s=None):
            both.wait(timeout=10)  # each answers once the other is in flight too
            return {"uid": f"u-{host.name}", "port": 1, "pid": None}

        monkeypatch.setattr(client, "_rpc", rpc)
        hosts: list[str] = []
        threads = [threading.Thread(
            target=lambda: hosts.append(client.spawn("replica", {}).host.name))
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(hosts) == ["h0", "h1"]
        assert client._placing == {"h0": 0, "h1": 0}
        assert client._placed == {"h0": 1, "h1": 1}
    finally:
        for a in agents:
            a.stop()
