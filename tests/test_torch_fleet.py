"""The port's serving fleet (``hops_tpu_torch.modelrepo.fleet``) held to
the JAX package's: every scenario of ``tests/test_fleet.py`` — router
policy, rate limits, the zero-copy relay, autoscaling, rollouts, process
workers, hedging, ejection, QoS and the chaos acceptance runs — runs
through both packages in this process, each in its own workspace, on the
same PYTHON predictors (see ``in_both`` below). Left out: the hot-path
bound tier, which times the JAX package's root ``bench.py``
(``run_hot_path_bench``). The two bench-tier cases run the tier's code
from ``bench.py`` with its imports bound to each package (``bench_tier``).
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import hops_tpu.modelrepo.fleet as j_fleet
from hops_tpu.modelrepo import registry as j_registry
from hops_tpu.modelrepo import serving as j_serving
from hops_tpu.modelrepo.fleet import router as j_router
from hops_tpu.modelrepo.fleet.autoscale import Autoscaler as j_Autoscaler
from hops_tpu.modelrepo.fleet.autoscale import AutoscalePolicy as j_AutoscalePolicy
from hops_tpu.modelrepo.fleet.replicas import FleetSpawnError as j_FleetSpawnError
from hops_tpu.modelrepo.fleet.replicas import ReplicaManager as j_ReplicaManager
from hops_tpu.runtime import faultinject as j_faultinject
from hops_tpu.runtime import flight as j_flight
from hops_tpu.runtime import qos as j_qos
from hops_tpu.runtime import wirecodec as j_wirecodec
from hops_tpu.telemetry import tracing as j_tracing
from hops_tpu.telemetry import workload as j_workload
from hops_tpu.telemetry.metrics import REGISTRY as j_REGISTRY

import hops_tpu_torch.modelrepo.fleet as t_fleet
from hops_tpu_torch.modelrepo import registry as t_registry
from hops_tpu_torch.modelrepo import serving as t_serving
from hops_tpu_torch.modelrepo.fleet import router as t_router
from hops_tpu_torch.modelrepo.fleet.autoscale import Autoscaler as t_Autoscaler
from hops_tpu_torch.modelrepo.fleet.autoscale import AutoscalePolicy as t_AutoscalePolicy
from hops_tpu_torch.modelrepo.fleet.replicas import FleetSpawnError as t_FleetSpawnError
from hops_tpu_torch.modelrepo.fleet.replicas import ReplicaManager as t_ReplicaManager
from hops_tpu_torch.runtime import config as t_config
from hops_tpu_torch.runtime import faultinject as t_faultinject
from hops_tpu_torch.runtime import flight as t_flight
from hops_tpu_torch.runtime import qos as t_qos
from hops_tpu_torch.runtime import wirecodec as t_wirecodec
from hops_tpu_torch.telemetry import tracing as t_tracing
from hops_tpu_torch.telemetry import workload as t_workload
from hops_tpu_torch.telemetry.metrics import REGISTRY as t_REGISTRY

PKG_NAMES = {"jax": "hops_tpu", "torch": "hops_tpu_torch"}


def _names(fleet, registry, serving, router, Autoscaler, AutoscalePolicy,
           FleetSpawnError, ReplicaManager, faultinject, flight, qos,
           wirecodec, tracing, workload, REGISTRY) -> dict:
    return dict(
        fleet=fleet, registry=registry, serving=serving, router_mod=router,
        Router=router.Router, TenantRateLimiter=router.TenantRateLimiter,
        TokenBucket=router.TokenBucket, HedgePolicy=router.HedgePolicy,
        EjectionPolicy=router.EjectionPolicy,
        _relay_headers=router._relay_headers,
        _relayed_with_ctype=router._relayed_with_ctype,
        Autoscaler=Autoscaler, AutoscalePolicy=AutoscalePolicy,
        FleetSpawnError=FleetSpawnError, ReplicaManager=ReplicaManager,
        faultinject=faultinject, flight=flight, qos=qos, wirecodec=wirecodec,
        tracing=tracing, workload=workload,
        WorkloadRecorder=workload.WorkloadRecorder, REGISTRY=REGISTRY)


NAMES = {
    "jax": _names(j_fleet, j_registry, j_serving, j_router, j_Autoscaler,
                  j_AutoscalePolicy, j_FleetSpawnError, j_ReplicaManager,
                  j_faultinject, j_flight, j_qos, j_wirecodec, j_tracing,
                  j_workload, j_REGISTRY),
    "torch": _names(t_fleet, t_registry, t_serving, t_router, t_Autoscaler,
                    t_AutoscalePolicy, t_FleetSpawnError, t_ReplicaManager,
                    t_faultinject, t_flight, t_qos, t_wirecodec, t_tracing,
                    t_workload, t_REGISTRY),
}
# Bound per run by ``package_globals``; these module values only serve
# linters and the helpers' defaults.
globals().update(NAMES["torch"])
PKG = "hops_tpu_torch"

# -- one body, two packages ---------------------------------------------------
#
# Each test below is the JAX test's body. ``in_both`` runs it twice in this
# process: first with the module's package names (``fleet``, ``serving``,
# ``REGISTRY``, ...) bound to the JAX package's modules in the JAX
# workspace (tests/conftest.py), then bound to the port's in a workspace of
# its own. Both runs must pass the same assertions, and what a body returns
# (predictions, status codes, Retry-After, counter deltas, lifecycle
# states) must be equal across the two. ``tests/test_torch_continuous.py``
# and ``tests/test_torch_placement.py`` use the same harness.


def _rebind(fn: types.FunctionType, g: dict) -> types.FunctionType:
    """``fn`` with its global names resolved in ``g``."""
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def _rebound_class(cls: type, g: dict) -> type:
    methods = {k: _rebind(getattr(v, "__original__", v), g)
               for k, v in vars(cls).items() if isinstance(v, types.FunctionType)}
    return type(cls.__name__, (cls,), methods)


def package_globals(mod, pkg: str) -> dict:
    """The module's globals with its package names bound to ``pkg``'s
    modules, and its helper functions and classes rebound to them."""
    g = dict(vars(mod))
    g.update(mod.NAMES[pkg])
    g["PKG"] = PKG_NAMES[pkg]
    for k, v in vars(mod).items():
        if getattr(v, "__module__", None) != mod.__name__ or hasattr(v, "__original__"):
            continue
        if isinstance(v, types.FunctionType):
            g[k] = _rebind(v, g)
        elif isinstance(v, type) and not k.startswith("Test"):
            g[k] = _rebound_class(v, g)
    return g


def normal(x, pkg: str):
    """Package names made comparable across the two runs."""
    if isinstance(x, str):
        return x.replace(PKG_NAMES[pkg], "hops_tpu")
    if isinstance(x, dict):
        return {normal(k, pkg): normal(v, pkg) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(normal(v, pkg) for v in x)
    return x


def _use_workspace(pkg: str, request) -> Path:
    """Point ``pkg``'s runtime config (and the workspace variable its
    child processes inherit) at a workspace of its own."""
    if pkg == "jax":
        return request.getfixturevalue("workspace")
    mp = request.getfixturevalue("monkeypatch")
    ws = request.getfixturevalue("tmp_path") / "torch_ws"
    mp.setattr(t_config, "_current", t_config.runtime())
    t_config.configure(workspace=str(ws), project="testproj")
    mp.setenv("HOPS_TPU_WORKSPACE", str(ws))
    return ws


def _run_both(fn, owner, request):
    mod = sys.modules[fn.__module__]
    outs = {}
    for pkg in ("jax", "torch"):
        for fi in (j_faultinject, t_faultinject):
            fi.disarm()
        ws = _use_workspace(pkg, request)
        g = package_globals(mod, pkg)
        finalizers: list = []

        def value(name: str):
            if name == "workspace":
                return ws
            if name == "tmp_path":
                p = request.getfixturevalue("tmp_path") / pkg
                p.mkdir(exist_ok=True)
                return p
            if name in ("monkeypatch", "caplog"):
                return request.getfixturevalue(name)
            gen = g["_fx_" + name]
            it = gen(*(value(p) for p in inspect.signature(gen).parameters))
            finalizers.append(it)
            return next(it)

        body = _rebind(fn, g)
        params = [p for p in inspect.signature(fn).parameters if p != "self"]
        try:
            args = {p: value(p) for p in params}
            if owner is None:
                out = body(**args)
            else:
                out = body(_rebound_class(owner, g)(), **args)
        finally:
            for it in reversed(finalizers):
                next(it, None)
            for fi in (j_faultinject, t_faultinject):
                fi.disarm()
        outs[pkg] = normal(out, pkg)
    assert outs["torch"] == outs["jax"], (
        f"the port's outcome differs from the JAX package's:\n"
        f"  jax:   {outs['jax']!r}\n  torch: {outs['torch']!r}")


def _both(fn, owner=None):
    if owner is None:
        def test(request):
            _run_both(fn, None, request)
    else:
        def test(self, request):
            _run_both(fn, owner, request)
    test.__name__, test.__qualname__, test.__doc__ = fn.__name__, fn.__qualname__, fn.__doc__
    test.__original__ = fn
    test.pytestmark = getattr(fn, "pytestmark", [])
    return test


def in_both(obj):
    """Class or function decorator: each test runs in both packages."""
    if isinstance(obj, type):
        for k, v in list(vars(obj).items()):
            if k.startswith("test") and isinstance(v, types.FunctionType):
                setattr(obj, k, _both(v, obj))
        return obj
    return _both(obj)


def worker_module(pid: int) -> str:
    """The module a ``python -m`` worker process runs, from its
    ``/proc/<pid>/cmdline``."""
    argv = Path(f"/proc/{pid}/cmdline").read_bytes().decode().split("\0")
    return argv[argv.index("-m") + 1]


_BENCH = None


def bench_tier(name: str, pkg: str):
    """A tier function of the root ``bench.py`` with its imports bound to
    ``pkg``: the JAX function as it is, or the same source with
    ``hops_tpu.`` imports renamed to the port."""
    global _BENCH
    if _BENCH is None:
        spec = importlib.util.spec_from_file_location(
            "_bench_tiers", Path(__file__).resolve().parents[1] / "bench.py")
        _BENCH = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_BENCH)
    fn = getattr(_BENCH, name)
    if pkg == "hops_tpu":
        return fn
    ns = dict(vars(_BENCH))
    exec(compile(inspect.getsource(fn).replace("hops_tpu.", "hops_tpu_torch."),
                 f"<bench.py:{name} on the port>", "exec"), ns)
    return ns[name]


def _export_version(name: str, body: str) -> int:
    """Export one predictor-script version to the model registry;
    returns the version number."""
    d = Path(tempfile.mkdtemp(prefix="fleet_art_"))
    (d / "p.py").write_text(
        "class Predict:\n"
        "    def predict(self, instances):\n"
        f"        {body}\n"
    )
    return registry.export(d, name, metrics={"v": 1.0})["version"]


def _fx_fleet_model(workspace):
    """A serving definition 'flt' whose v1 predictor doubles inputs."""
    _export_version("flt", "return [[v[0] * 2] for v in instances]")
    serving.create_or_update("flt", model_name="flt", model_version=1,
                             model_server="PYTHON")
    yield "flt"


def _start(name: str, replicas: int = 2, **kw) -> fleet.ServingFleet:
    kw.setdefault("inprocess", True)
    kw.setdefault("scrape_interval_s", 0.05)
    return fleet.start_fleet(name, replicas, **kw)


# -- token buckets / rate limiting --------------------------------------------


@in_both
class TestTokenBucket:
    def test_refill_math_under_injected_clock(self):
        now = [0.0]
        b = TokenBucket(rate_rps=10.0, burst=2.0, clock=lambda: now[0])
        assert b.acquire() == 0.0
        assert b.acquire() == 0.0  # burst spent
        # Empty: next token exists in 1/rate seconds.
        assert b.acquire() == pytest.approx(0.1)
        now[0] += 0.05  # half a token refilled
        assert b.acquire() == pytest.approx(0.05)
        now[0] += 0.15  # 1.5 more tokens -> 2.0, capped at burst
        assert b.tokens == pytest.approx(2.0)
        assert b.acquire() == 0.0
        # Refill never exceeds burst no matter how long the idle gap.
        now[0] += 1e6
        assert b.tokens == pytest.approx(2.0)
        return round(b.tokens, 9)

    def test_rejects_nonpositive_config(self):
        with pytest.raises(ValueError):
            TokenBucket(rate_rps=0, burst=1)
        with pytest.raises(ValueError):
            TokenBucket(rate_rps=1, burst=0)

    def test_limiter_default_covers_unnamed_tenants_separately(self):
        now = [0.0]
        lim = TenantRateLimiter(
            {"default": {"rate_rps": 1.0, "burst": 1.0}},
            clock=lambda: now[0])
        assert lim.acquire("a") == 0.0
        assert lim.acquire("a") == pytest.approx(1.0)
        # Tenant b has its OWN bucket under the default spec.
        assert lim.acquire("b") == 0.0

    def test_limiter_bounds_bucket_map_against_untrusted_tenants(self):
        # X-Tenant is client input: past max_buckets distinct tenants,
        # fully-refilled buckets are pruned (a full bucket admits
        # exactly like a fresh one), so memory stays bounded.
        t = [0.0]
        lim = TenantRateLimiter({"default": {"rate_rps": 10, "burst": 2}},
                                clock=lambda: t[0], max_buckets=4)
        for i in range(4):
            assert lim.acquire(f"spray-{i}") == 0.0
        t[0] += 10.0  # everything refills to full burst
        assert lim.acquire("spray-99") == 0.0
        assert len(lim._buckets) == 1  # the 4 full buckets were pruned
        # A tenant mid-limit (empty bucket) that stays active survives
        # later cap pressure: full buckets prune first, and the LRU
        # fallback evicts colder tenants, not it.
        assert lim.acquire("spray-99") == 0.0
        wait = lim.acquire("spray-99")
        assert wait > 0
        for i in range(3):
            t[0] += 0.01
            lim.acquire(f"again-{i}")
        t[0] += 0.01
        lim.acquire("spray-99")  # stays recent
        t[0] += 0.01
        lim.acquire("again-3")  # at cap: evicts the coldest (again-0)
        assert "spray-99" in lim._buckets
        assert "again-0" not in lim._buckets
        assert lim.acquire("spray-99") > 0  # still limited, not reset

    def test_limiter_cap_is_a_hard_bound_under_unique_tenant_spray(self):
        # A spray of unique tenants leaves every bucket mid-limit
        # (nothing refilled, nothing prunable) — the cap must hold
        # anyway, via LRU eviction. A real tenant that keeps acquiring
        # stays recent and survives every pass, limit intact.
        t = [0.0]
        lim = TenantRateLimiter({"default": {"rate_rps": 10, "burst": 2}},
                                clock=lambda: t[0], max_buckets=4)
        lim.acquire("hot")
        lim.acquire("hot")  # burst spent: mid-limit, not prunable
        for i in range(100):
            t[0] += 0.001  # nothing ever refills to full burst
            lim.acquire(f"spray-{i}")
            lim.acquire("hot")  # stays the most recently used
            assert len(lim._buckets) <= 4
        assert "hot" in lim._buckets
        assert lim.acquire("hot") > 0  # still limited — never reset

    def test_limiter_without_entry_is_unlimited(self):
        lim = TenantRateLimiter({"paid": {"rate_rps": 1.0, "burst": 1.0}})
        for _ in range(50):
            assert lim.acquire("free-for-all") == 0.0


@in_both
class TestRouterRateLimit:
    def test_429_with_retry_after_and_counter(self, fleet_model):
        base = REGISTRY.counter(
            "hops_tpu_fleet_rate_limited_total", labels=("tenant",)
        ).value(tenant="t1")
        with _start(fleet_model, replicas=1,
                    rate_limits={"t1": {"rate_rps": 1.0, "burst": 2.0}}) as f:
            assert f.predict([[1]], tenant="t1")["predictions"] == [[2]]
            assert f.predict([[1]], tenant="t1")["predictions"] == [[2]]
            with pytest.raises(urllib.error.HTTPError) as e:
                f.predict([[1]], tenant="t1")
            assert e.value.code == 429
            assert float(e.value.headers["Retry-After"]) >= 1
            # Unlimited tenant is untouched by t1's empty bucket.
            assert f.predict([[1]], tenant="other")["predictions"] == [[2]]
        limited = REGISTRY.counter(
            "hops_tpu_fleet_rate_limited_total", labels=("tenant",)
        ).value(tenant="t1")
        assert limited - base == 1
        return {"code": e.value.code,
                "retry_after": e.value.headers["Retry-After"],
                "limited": limited - base}

    def test_rate_limited_counter_collapses_default_spec_tenants(
            self, fleet_model):
        # X-Tenant is untrusted: only explicitly configured tenants get
        # their own counter child; a spray of fabricated names under
        # the "default" spec lands on ONE label value instead of
        # minting unbounded children in the exported registry.
        counter = REGISTRY.counter(
            "hops_tpu_fleet_rate_limited_total", labels=("tenant",))
        base = counter.value(tenant="default")
        with _start(fleet_model, replicas=1,
                    rate_limits={"default": {"rate_rps": 0.01,
                                             "burst": 1.0}}) as f:
            for i in range(3):
                tenant = f"sprayed-{i}"
                assert f.predict([[1]], tenant=tenant)["predictions"] == [[2]]
                with pytest.raises(urllib.error.HTTPError) as e:
                    f.predict([[1]], tenant=tenant)
                assert e.value.code == 429
        assert counter.value(tenant="default") - base == 3
        assert counter.value(tenant="sprayed-0") == 0
        return {"code": e.value.code,
                "retry_after": e.value.headers["Retry-After"],
                "default": counter.value(tenant="default") - base}


# -- zero-copy relay ----------------------------------------------------------


@in_both
class TestZeroCopyRelay:
    """The forward path relays bodies as verbatim bytes (no parse /
    re-serialize); the lazy-parse paths (capture summaries, timeline
    merge) still see the object they need."""

    def _get_bytes(self, url: str, body: bytes) -> tuple[int, bytes]:
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def test_200_relays_replica_bytes_verbatim(self, fleet_model):
        with _start(fleet_model, replicas=1) as f:
            rep = f.manager.replicas()[0]
            body = json.dumps({"instances": [[3]]}).encode()
            code_d, direct = self._get_bytes(
                f"http://127.0.0.1:{rep.port}/v1/models/flt:predict", body)
            code_r, routed = self._get_bytes(
                f"{f.router.endpoint}/predict", body)
            assert code_d == code_r == 200
            assert routed == direct  # byte-for-byte, not just value-equal
            return routed.decode()

    def test_4xx_and_5xx_relay_verbatim(self, fleet_model):
        # 400: serving rejects a bodyless instances list; 500: the
        # predictor raises. Both replica-authored bodies must reach
        # the client untouched (they used to be parsed + re-dumped).
        v_err = _export_version("flt", "raise RuntimeError('boom-xyz')")
        serving.create_or_update("flt", model_name="flt",
                                 model_version=v_err, model_server="PYTHON")
        with _start(fleet_model, replicas=1, max_attempts=1) as f:
            rep = f.manager.replicas()[0]
            bad = json.dumps({"bogus": True}).encode()
            code_d, direct = self._get_bytes(
                f"http://127.0.0.1:{rep.port}/v1/models/flt:predict", bad)
            code_r, routed = self._get_bytes(
                f"{f.router.endpoint}/predict", bad)
            assert code_d == code_r and code_d >= 400
            assert routed == direct
            good = json.dumps({"instances": [[1]]}).encode()
            code_d, direct = self._get_bytes(
                f"http://127.0.0.1:{rep.port}/v1/models/flt:predict", good)
            code_r, routed = self._get_bytes(
                f"{f.router.endpoint}/predict", good)
            assert code_d == code_r == 500
            assert b"boom-xyz" in routed
            assert routed == direct
            return code_d, json.loads(routed)["error"].split(":")[0]

    def test_timeline_merge_still_parses_lazily(self, fleet_model):
        # The ONE success path that needs the object: an explicit
        # X-Hops-Debug ask still gets the merged router+replica
        # timeline out of the relayed bytes.
        with _start(fleet_model, replicas=1) as f:
            req = urllib.request.Request(
                f"{f.router.endpoint}/predict",
                data=json.dumps({"instances": [[2]]}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Hops-Debug": "timeline"},
            )
            with urllib.request.urlopen(req, timeout=10) as resp:
                payload = json.loads(resp.read())
            assert payload["predictions"] == [[4]]
            names = {r.get("name") for r in payload["debug"]["timeline"]}
            assert "fleet.request" in names  # router's own span merged
            assert "fleet.forward" in names
            return payload["predictions"]

    def test_capture_shape_summaries_survive_byte_relay(self, fleet_model):
        # The recorder's shape summaries parse the REQUEST body lazily
        # (armed captures only) — the zero-copy path must not starve
        # them.

        d = Path(tempfile.mkdtemp(prefix="relay_cap_"))
        with _start(fleet_model, replicas=1) as f:
            workload.start_capture(d)
            try:
                assert f.predict([[5]])["predictions"] == [[10]]
            finally:
                workload.stop_capture()
        records = [
            json.loads(line)
            for seg in sorted(d.glob("segment_*.jsonl"))
            for line in seg.read_text().splitlines()
        ]
        front = [r for r in records if r.get("surface") == "router"]
        assert front and front[0]["payload"]["instances"] == [[5]]
        assert front[0]["status"] == 200
        return front[0]["payload"], front[0]["status"]


# -- least-loaded selection ---------------------------------------------------


class _StubRep:
    def __init__(self, rid, port=None, state="ready"):
        self.rid, self.port, self.state = rid, port, state
        self.version = None


class _StubManager:
    name = "stub"

    def __init__(self, reps):
        self.reps = reps

    def replicas(self):
        return [r for r in self.reps if r.state not in ("stopped", "failed")]


@in_both
class TestRouterSelection:
    def _router(self, reps) -> Router:
        # Long scrape interval: these tests drive the views directly.
        return Router(_StubManager(reps), scrape_interval_s=30.0)

    def test_pick_prefers_lowest_score(self):
        reps = [_StubRep("a", 1), _StubRep("b", 2), _StubRep("c", 3)]
        r = self._router(reps)
        try:
            r._view("a").inflight = 5
            r._view("b").inflight = 1
            r._view("c").queue_depth = 3.0
            assert r.pick().rid == "b"
            assert r.pick(exclude={"b"}).rid == "c"  # c=3 beats a=5
            assert r.pick(exclude={"b", "c"}).rid == "a"
            assert r.pick(exclude={"a", "b", "c"}) is None
        finally:
            r.stop()

    def test_open_breaker_and_nonready_states_unroutable(self):
        reps = [_StubRep("a", 1), _StubRep("b", 2),
                _StubRep("d", 4, state="draining"),
                _StubRep("s", 5, state="starting")]
        r = self._router(reps)
        try:
            for _ in range(r.breaker_failures):
                r._view("a").breaker.record_failure()
            assert r.breaker_state("a") == "open"
            assert [x.rid for x in r.routable()] == ["b"]
            assert r.pick().rid == "b"
        finally:
            r.stop()

    def test_inflight_counting_is_thread_safe(self):
        # += on the view attribute is load/add/store — without the
        # count lock, racing handler threads lose increments and drive
        # the count negative, permanently skewing least-loaded.
        r = self._router([_StubRep("a", 1)])
        try:
            view = r._view("a")

            def churn():
                for _ in range(5000):
                    view.inflight_inc()
                    view.inflight_dec()

            threads = [threading.Thread(target=churn) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert view.inflight == 0
            assert view.score() == 0.0
        finally:
            r.stop()

    def test_relayed_replica_headers_drop_content_framing(self):
        # _reply frames the re-serialized body itself: relaying the
        # replica's Content-Length would send two conflicting framings.

        relayed = _relay_headers({
            "Content-Length": "999", "Content-Type": "text/html",
            "Transfer-Encoding": "chunked", "Connection": "close",
            "Retry-After": "2", "X-Custom": "kept",
        })
        assert relayed == {"Retry-After": "2", "X-Custom": "kept"}

    def test_byte_relay_keeps_replica_content_type(self):
        # A verbatim byte body travels with the replica's DECLARED
        # type (an HTML error page must not be stamped
        # application/json); Content-Length alone is recomputed.

        relayed = _relayed_with_ctype({
            "Content-Length": "999", "Content-Type": "text/html",
            "Connection": "close", "X-Custom": "kept",
        })
        assert relayed == {"Content-Type": "text/html", "X-Custom": "kept"}
        assert _relayed_with_ctype({"X-Custom": "v"}) == {"X-Custom": "v"}
        # HTTP header casing is not ours to assume.
        lower = _relayed_with_ctype({"content-type": "text/plain"})
        assert lower == {"Content-Type": "text/plain"}

    def test_merge_debug_relays_non_object_json_bytes_untouched(self):
        # Valid-JSON-but-not-an-object bodies have nothing to merge
        # into: the ORIGINAL bytes relay (no parse→re-serialize drift).
        r = self._router([])
        try:
            raw = b'[1,  2]'  # whitespace would not survive a re-dump
            assert r._merge_debug(raw, None) is raw
            assert r._merge_debug(b'not json', None) == b'not json'
        finally:
            r.stop()

    def test_views_pruned_for_vanished_replicas(self):
        # Every rollout/autoscale churn mints fresh rids; views for
        # reaped replicas must not accumulate for the router's lifetime.
        reps = [_StubRep("a", 1), _StubRep("b", 2)]
        r = self._router(reps)
        try:
            r._view("a")
            r._view("b")
            r._view("ghost")  # e.g. spawned, then killed before a scrape
            reps[0].state = "stopped"  # "a" reaped
            r.scrape_once()
            assert set(r._views) == {"b"}
        finally:
            r.stop()

    def test_route_with_nothing_routable_is_503(self):
        r = self._router([])
        try:
            code, payload, headers = r.route(b"{}")
            assert code == 503
            assert headers["Retry-After"]
            return code, headers["Retry-After"]
        finally:
            r.stop()

    def test_scrape_feeds_view_from_metrics_json(self, fleet_model):
        with _start(fleet_model, replicas=1) as f:
            rep = f.manager.replicas()[0]
            f.predict([[1]])
            f.router.scrape_once()
            view = f.router._view(rep.rid)
            assert view.scrape_ok
            # Idle endpoint: zero queue depth and zero in-flight.
            assert view.queue_depth == 0.0
            assert view.scraped_inflight == 0.0
            return view.queue_depth, view.scraped_inflight


# -- routing around failure ---------------------------------------------------


@in_both
class TestRouterResilience:
    def test_killed_replica_routed_around_with_zero_errors(self, fleet_model):
        with _start(fleet_model, replicas=3) as f:
            victim = f.manager.replicas()[0]
            f.manager.kill(victim.rid)
            for i in range(12):
                assert f.predict([[i]])["predictions"] == [[i * 2]]
            assert len(f.manager.ready()) == 2
            return [r.state for r in f.manager.replicas()]

    def test_draining_replica_stops_admitting_but_fleet_serves(self, fleet_model):
        with _start(fleet_model, replicas=2) as f:
            rid = f.manager.replicas()[0].rid
            f.manager.drain(rid)
            assert f.manager.healthz(rid) == "draining"
            assert f.manager.drained(rid)  # nothing was in flight
            forwards = REGISTRY.counter(
                "hops_tpu_fleet_forwards_total", labels=("model", "replica"))
            base = forwards.value(model=fleet_model, replica=rid)
            for i in range(6):
                assert f.predict([[i]])["predictions"] == [[i * 2]]
            # The drained replica took none of that traffic.
            assert forwards.value(model=fleet_model, replica=rid) == base
            return [(r.rid, r.state) for r in f.manager.replicas()]

    def test_router_forward_latency_fault_delays_not_fails(self, fleet_model):
        with _start(fleet_model, replicas=1) as f:
            faultinject.arm("router.forward=latency:0.2@times=1")
            t0 = time.monotonic()
            assert f.predict([[3]])["predictions"] == [[6]]
            assert time.monotonic() - t0 >= 0.2

    def test_router_forward_error_fault_retries_elsewhere(self, fleet_model):
        with _start(fleet_model, replicas=2) as f:
            faultinject.arm("router.forward=error:OSError@times=1")
            # The injected transport failure strikes one replica's
            # breaker and the request retries on the other — the
            # client sees only latency.
            assert f.predict([[4]])["predictions"] == [[8]]
            retried = REGISTRY.counter(
                "hops_tpu_fleet_retries_total", labels=("model", "reason")
            ).value(model=fleet_model, reason="connect")
            assert retried >= 1
            return f.predict([[4]])["predictions"]

    def test_injected_fault_leaves_causal_flight_story(
        self, fleet_model, tmp_path
    ):
        """Flight-recorder ⇄ fault-injection contract: after an
        injected-fault run, the recorder's dump holds the fired fault,
        the breaker transition it caused, and the retry that healed the
        request — in causal (sequence) order, all stitched to the ONE
        trace the client request rode."""

        base = flight.FLIGHT.seq
        client = tracing.TraceContext(
            tracing.new_trace_id(), tracing.new_span_id())
        with _start(fleet_model, replicas=2, breaker_failures=1) as f:
            faultinject.arm("router.forward=error:OSError@times=1")
            req = urllib.request.Request(
                f"{f.endpoint}/predict",
                data=json.dumps({"instances": [[4]]}).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": client.traceparent()},
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read())["predictions"] == [[8]]

        out = flight.FLIGHT.dump(tmp_path / "flight.json", reason="chaos")
        body = json.loads(out.read_text())
        events = [e for e in body["events"] if e["seq"] > base]
        assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)

        fault = next(e for e in events if e["kind"] == "fault_fired"
                     and e["data"]["point"] == "router.forward")
        trip = next(e for e in events if e["kind"] == "breaker_transition"
                    and e["data"]["to"] == "open")
        retry = next(e for e in events if e["kind"] == "retry"
                     and e["data"]["op"] == "router.forward")
        # Causal order: the fault fired first, then the breaker it
        # struck opened, then the retry onto the next-best replica.
        assert fault["seq"] < trip["seq"] < retry["seq"]
        # All three carry the request's trace id — the dump and
        # GET /debug/traces tell one story.
        assert {fault["trace_id"], trip["trace_id"], retry["trace_id"]} \
            == {client.trace_id}
        return [e["kind"] for e in (fault, trip, retry)]

    def test_fleet_view_serves_scrape_and_breaker_ages(self, fleet_model):
        """`GET /fleet`: per-replica last-scrape age and breaker state
        age — a stale scrape must be distinguishable from a healthy
        idle replica."""
        with _start(fleet_model, replicas=2) as f:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with urllib.request.urlopen(
                    f"{f.endpoint}/fleet", timeout=10
                ) as resp:
                    view = json.loads(resp.read())
                if all(r["last_scrape_age_s"] is not None
                       for r in view["replicas"]):
                    break
                time.sleep(0.05)
            for rep in view["replicas"]:
                # Scrapes run every 0.05s here: a live replica's age
                # stays far under the staleness any operator would
                # squint at.
                assert rep["last_scrape_age_s"] is not None
                assert 0.0 <= rep["last_scrape_age_s"] < 5.0
                assert rep["breaker"] == "closed"
                assert rep["breaker_state_age_s"] >= 0.0


# -- replica manager ----------------------------------------------------------


@in_both
class TestReplicaManager:
    def test_requires_existing_serving_definition(self, workspace):
        with pytest.raises(KeyError):
            ReplicaManager("ghost", inprocess=True)

    def test_spawn_fault_fails_that_attempt(self, fleet_model):
        mgr = ReplicaManager(fleet_model, inprocess=True)
        try:
            faultinject.arm("fleet.spawn=error:OSError@times=1")
            with pytest.raises(FleetSpawnError):
                mgr.spawn()
            faultinject.disarm()
            rep = mgr.spawn()  # next attempt is clean
            assert rep.state == "ready"
            # The failed replica is not in the live set.
            assert [r.rid for r in mgr.replicas()] == [rep.rid]
            return rep.rid, rep.state
        finally:
            mgr.stop()

    def test_stopped_manager_rejects_spawn(self, fleet_model):
        # stop() closes the manager; a spawn that races it (e.g. a
        # blocked autoscaler tick) must fail and not orphan a worker.
        mgr = ReplicaManager(fleet_model, inprocess=True)
        mgr.spawn()
        mgr.stop()
        with pytest.raises(FleetSpawnError, match="stopped"):
            mgr.spawn()
        assert mgr.replicas() == []
        return [r.rid for r in mgr.replicas()]

    def test_spawn_racing_stop_tears_down_its_own_worker(
            self, fleet_model, monkeypatch):
        # stop() landing MID-spawn reaps-and-forgets the starting rid
        # before its server exists; the spawn's post-check must tear
        # down the worker it just created via the LOCAL rep object — a
        # book lookup would no-op on the forgotten rid and leak it.
        mgr = ReplicaManager(fleet_model, inprocess=True)
        orig = serving._RunningServing
        created = {}

        def hooked(cfg):
            mgr.stop()  # the race: manager closes while spawn is in flight
            created["srv"] = orig(cfg)
            return created["srv"]

        monkeypatch.setattr(serving, "_RunningServing", hooked)
        with pytest.raises(FleetSpawnError, match="stopped during spawn"):
            mgr.spawn()
        assert mgr.replicas() == []
        # The worker the racing spawn created is DOWN, not orphaned.
        with pytest.raises(OSError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{created['srv'].port}/healthz", timeout=2)

    def test_replica_state_gauge_tracks_lifecycle(self, fleet_model):
        gauge = REGISTRY.gauge(
            "hops_tpu_fleet_replicas", labels=("model", "state"))
        mgr = ReplicaManager(fleet_model, inprocess=True)
        try:
            mgr.spawn()
            mgr.spawn()
            assert gauge.value(model=fleet_model, state="ready") == 2
            rid = mgr.replicas()[0].rid
            mgr.drain(rid)
            assert gauge.value(model=fleet_model, state="draining") == 1
            mgr.reap(rid)
            assert gauge.value(model=fleet_model, state="ready") == 1
            return {st: gauge.value(model=fleet_model, state=st)
                    for st in ("starting", "ready", "draining", "stopped")}
        finally:
            mgr.stop()

    def test_reaped_replicas_are_pruned_and_drain_tolerates_them(self, fleet_model):
        # Rollouts and autoscale churn mint a fresh rid each time:
        # dead entries (each holding a Popen) must not accumulate for
        # the manager's lifetime, and a drain aimed at an
        # already-reaped rid (a scale-down racing a rollout that
        # snapshotted it) is a tolerated no-op, not a KeyError — and
        # never resurrects the replica into the live set.
        mgr = ReplicaManager(fleet_model, inprocess=True)
        try:
            keeper = mgr.spawn()
            rep = mgr.spawn()
            mgr.reap(rep.rid)
            assert mgr.get(rep.rid) is None
            mgr.drain(rep.rid)  # no KeyError, no resurrection
            assert [r.rid for r in mgr.replicas()] == [keeper.rid]
            killed = mgr.spawn()
            mgr.kill(killed.rid)
            assert mgr.get(killed.rid) is None
            faultinject.arm("fleet.spawn=error:OSError@times=1")
            with pytest.raises(FleetSpawnError):
                mgr.spawn()
            faultinject.disarm()
            # The book holds exactly the live replica — nothing dead.
            assert set(mgr._replicas) == {keeper.rid}
            return sorted(mgr._replicas)
        finally:
            mgr.stop()

    def test_version_pinned_spawn_resolves_registry_artifact(self, fleet_model):
        v2 = _export_version("flt", "return [[v[0] * 3] for v in instances]")
        mgr = ReplicaManager(fleet_model, inprocess=True)
        try:
            rep = mgr.spawn(v2)
            assert rep.version == v2
            req = urllib.request.Request(
                f"http://127.0.0.1:{rep.port}/v1/models/flt:predict",
                data=json.dumps({"instances": [[5]]}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert json.loads(resp.read())["predictions"] == [[15]]
            return rep.version
        finally:
            mgr.stop()


# -- autoscaler ---------------------------------------------------------------


class _ScalerStub:
    """Recording stand-in for ReplicaManager in autoscaler unit tests."""

    name = "stub"

    def __init__(self, n_ready: int):
        self._n = 0
        self.reps: list[_StubRep] = []
        self.calls: list[tuple[str, str]] = []
        self.drain_done: set[str] = set()
        for _ in range(n_ready):
            self.spawn()
        self.calls.clear()  # setup spawns are not decisions under test

    def spawn(self, version=None):
        rep = _StubRep(f"r{self._n}", port=1000 + self._n)
        self._n += 1
        self.reps.append(rep)
        self.calls.append(("spawn", rep.rid))
        return rep

    def replicas(self):
        return [r for r in self.reps if r.state not in ("stopped", "failed")]

    def ready(self):
        return [r for r in self.replicas() if r.state == "ready"]

    def drain(self, rid):
        self.calls.append(("drain", rid))
        next(r for r in self.reps if r.rid == rid).state = "draining"

    def drained(self, rid):
        return rid in self.drain_done

    def reap(self, rid):
        self.calls.append(("reap", rid))
        next(r for r in self.reps if r.rid == rid).state = "stopped"


@in_both
class TestAutoscaler:
    def _scaler(self, stub, policy, load):
        now = [0.0]
        scaler = Autoscaler(
            stub, None, policy, clock=lambda: now[0],
            load_fn=lambda: load[0],
        )
        return scaler, now

    def test_scale_up_needs_consecutive_breaches_and_cooldown(self):
        stub = _ScalerStub(2)
        load = [100.0]
        policy = AutoscalePolicy(min_replicas=1, max_replicas=4,
                                 target_load=4.0, breaches_to_scale=2,
                                 up_cooldown_s=10.0)
        scaler, now = self._scaler(stub, policy, load)
        assert scaler.tick() is None  # breach 1 of 2
        assert scaler.tick() == "up"  # breach 2 -> spawn
        assert len(stub.ready()) == 3
        now[0] += 1.0
        assert scaler.tick() is None  # breach 1 (reset) ...
        assert scaler.tick() is None  # ... breach 2, but inside cooldown
        now[0] += 10.0
        assert scaler.tick() == "up"
        assert len(stub.ready()) == 4
        # At max_replicas nothing more happens no matter the load.
        now[0] += 100.0
        assert scaler.tick() is None and scaler.tick() is None
        assert scaler.target == 4
        return stub.calls

    def test_scale_down_drains_then_reaps_at_inflight_zero(self):
        stub = _ScalerStub(3)
        load = [0.0]
        policy = AutoscalePolicy(min_replicas=1, max_replicas=4,
                                 target_load=4.0, breaches_to_scale=2,
                                 down_cooldown_s=0.0)
        scaler, now = self._scaler(stub, policy, load)
        assert scaler.tick() is None
        assert scaler.tick() == "down"
        drained_rid = [rid for verb, rid in stub.calls if verb == "drain"][0]
        # Still mid-drain: the replica keeps its in-flight work.
        assert ("reap", drained_rid) not in stub.calls
        assert scaler._reap_drained() is None
        stub.drain_done.add(drained_rid)
        now[0] += 1.0
        scaler.tick()
        assert ("reap", drained_rid) in stub.calls
        return stub.calls

    def test_never_scales_below_min(self):
        stub = _ScalerStub(1)
        load = [0.0]
        policy = AutoscalePolicy(min_replicas=1, max_replicas=4,
                                 target_load=4.0, breaches_to_scale=1,
                                 down_cooldown_s=0.0)
        scaler, _ = self._scaler(stub, policy, load)
        for _ in range(4):
            assert scaler.tick() != "down"
        assert len(stub.ready()) == 1

    def test_heals_fleet_below_floor_regardless_of_load(self):
        stub = _ScalerStub(3)
        load = [0.0]  # low load would argue scale-DOWN
        policy = AutoscalePolicy(min_replicas=3, max_replicas=4,
                                 target_load=4.0)
        scaler, _ = self._scaler(stub, policy, load)
        stub.reps[0].state = "failed"  # chaos took one
        assert scaler.tick() == "heal"
        assert len(stub.ready()) == 3
        return stub.calls

    def test_p99_trigger_scales_up_without_load_breach(self):
        stub = _ScalerStub(1)
        load = [0.0]

        class _R:
            @staticmethod
            def recent_p99_ms():
                return 500.0

            @staticmethod
            def fleet_load():
                return 0.0

        policy = AutoscalePolicy(min_replicas=1, max_replicas=2,
                                 target_load=4.0, breaches_to_scale=1,
                                 up_cooldown_s=0.0, p99_target_ms=100.0)
        now = [0.0]
        scaler = Autoscaler(stub, _R(), policy, clock=lambda: now[0],
                            load_fn=lambda: load[0])
        assert scaler.tick() == "up"
        events = REGISTRY.counter(
            "hops_tpu_fleet_scale_events_total", labels=("model", "direction")
        ).value(model="stub", direction="up")
        assert events >= 1

    def test_policy_validation(self):
        with pytest.raises(ValueError):
            AutoscalePolicy(min_replicas=0)
        with pytest.raises(ValueError):
            AutoscalePolicy(min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError):
            AutoscalePolicy(low_factor=1.5, high_factor=1.25)


# -- rollouts -----------------------------------------------------------------


@in_both
class TestRollout:
    def test_completed_rollout_replaces_every_replica(self, fleet_model):
        v2 = _export_version("flt", "return [[v[0] * 3] for v in instances]")
        with _start(fleet_model, replicas=2) as f:
            assert f.predict([[5]])["predictions"] == [[10]]
            summary = f.roll_out(v2, canary_requests=1, canary_window_s=5)
            assert summary["outcome"] == "completed"
            assert len(summary["replaced"]) == 2
            assert f.predict([[5]])["predictions"] == [[15]]
            assert all(r.version == v2 for r in f.manager.ready())
            return summary["outcome"], len(summary["replaced"]), v2

    def test_rollout_resolves_model_name_not_endpoint_name(self, workspace):
        # The model registry is keyed by MODEL name; an endpoint created
        # with model_name= must roll out via that, not its own name.
        v1 = _export_version("mdl9", "return [[v[0] * 2] for v in instances]")
        v2 = _export_version("mdl9", "return [[v[0] * 3] for v in instances]")
        serving.create_or_update("ep9", model_name="mdl9", model_version=v1,
                                 model_server="PYTHON")
        with _start("ep9", replicas=1) as f:
            assert f.predict([[2]])["predictions"] == [[4]]
            summary = f.roll_out(v2, canary_requests=1, canary_window_s=1)
            assert summary["outcome"] == "completed"
            assert f.predict([[2]])["predictions"] == [[6]]
            # commit_version persisted the v2 artifact for future heals.
            cfg = serving._load_registry()["ep9"]
            assert cfg["model_version"] == v2
            # A post-rollout heal spawn hosts v2, not the old version.
            rep = f.manager.spawn()
            assert rep.version == v2
            return summary["outcome"], cfg["model_version"], rep.version

    def test_rollout_sweeps_old_version_replica_spawned_mid_canary(
            self, fleet_model):
        # An autoscaler heal that reads the serving definition BEFORE
        # the rollout commits the new version lands an old-version
        # replica outside the rollout's starting snapshot. A completed
        # rollout must not leave it serving: the straggler sweep
        # drains it (without a replacement — it was autoscaler-added
        # capacity) and the fleet ends homogeneous on the new version.
        v2 = _export_version("flt", "return [[v[0] * 3] for v in instances]")
        with _start(fleet_model, replicas=1) as f:
            healed: list[str] = []

            def heal():
                time.sleep(0.3)  # lands inside the canary window
                healed.append(f.manager.spawn().rid)

            t = threading.Thread(target=heal)
            t.start()
            # No traffic -> the canary window runs its full length,
            # guaranteeing the heal happens mid-rollout, pre-commit.
            summary = f.roll_out(v2, canary_requests=100,
                                 canary_window_s=1.5)
            t.join(timeout=10)
            assert summary["outcome"] == "completed"
            assert healed and healed[0] in summary["replaced"]
            assert all(r.version == v2 for r in f.manager.ready())
            assert f.predict([[2]])["predictions"] == [[6]]
            return summary["outcome"], sorted(summary["replaced"])

    def test_rollout_needs_a_ready_fleet(self, fleet_model):
        mgr = ReplicaManager(fleet_model, inprocess=True)
        router = Router(mgr, scrape_interval_s=30.0)
        try:
            with pytest.raises(fleet.RolloutError):
                fleet.roll_out(mgr, router, None)
        finally:
            router.stop()
            mgr.stop()

    def test_canary_spawn_failure_raises_and_keeps_fleet(self, fleet_model):
        with _start(fleet_model, replicas=2) as f:
            faultinject.arm("fleet.spawn=error:OSError@times=1")
            with pytest.raises(fleet.RolloutError):
                f.roll_out(None)
            faultinject.disarm()
            assert len(f.manager.ready()) == 2
            assert f.predict([[2]])["predictions"] == [[4]]
            return [r.state for r in f.manager.replicas()]


# -- acceptance: zero-downtime rollout under traffic --------------------------


class _Traffic:
    """Client threads hammering the fleet; every response recorded."""

    def __init__(self, f: fleet.ServingFleet, expect_fn, clients: int = 3,
                 period_s: float = 0.004):
        self.f = f
        self.expect_fn = expect_fn
        self.period_s = period_s
        self.errors: list[BaseException] = []
        self.bad: list = []
        self.done_t: list[float] = []
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
                    self.done_t.append(time.monotonic())
                if out["predictions"] not in self.expect_fn(i):
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


@in_both
class TestFleetE2E:
    def test_rollout_serves_continuously_and_drains_clean(
            self, fleet_model, caplog):
        """Acceptance: cutover serves continuously — no sampled window
        with fewer ready replicas than the starting count, zero client
        errors, drained replicas exit at in-flight zero (no force-reap
        in the logs), and the new version is live at the end."""
        v2 = _export_version("flt", "return [[v[0] * 3] for v in instances]")
        ready_samples: list[int] = []
        sampling = threading.Event()
        stop_sampling = threading.Event()

        with _start(fleet_model, replicas=2) as f:
            def sample():
                while not stop_sampling.is_set():
                    if sampling.is_set():
                        ready_samples.append(len(f.manager.ready()))
                    stop_sampling.wait(0.005)

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            # Mid-rollout either version may answer; both are valid.
            expect = lambda i: ([[i * 2]], [[i * 3]])  # noqa: E731
            with _Traffic(f, expect) as traffic:
                time.sleep(0.1)
                sampling.set()
                summary = f.roll_out(v2, canary_requests=2, canary_window_s=10)
                sampling.clear()
                time.sleep(0.1)
            stop_sampling.set()
            sampler.join(timeout=5)

            assert summary["outcome"] == "completed"
            assert traffic.errors == []
            assert traffic.bad == []
            assert len(traffic.done_t) > 20
            # Capacity never dipped below the starting count.
            assert ready_samples and min(ready_samples) >= 2
            # Every drain completed at in-flight zero — no force reap.
            assert "force-reaping" not in caplog.text
            assert f.predict([[10]])["predictions"] == [[30]]

    def test_canary_breaker_trip_rolls_back_with_zero_client_errors(
            self, fleet_model):
        """Acceptance: a canary whose error rate trips its breaker is
        reaped and the fleet rolls back — clients saw retried requests,
        never a failure."""
        bad = _export_version("flt", "raise RuntimeError('poisoned build')")
        with _start(fleet_model, replicas=2) as f:
            expect = lambda i: ([[i * 2]],)  # noqa: E731
            with _Traffic(f, expect) as traffic:
                summary = f.roll_out(bad, canary_requests=50,
                                     canary_window_s=20)
            assert summary["outcome"] == "rolled_back"
            assert traffic.errors == []
            assert traffic.bad == []
            # The reaped canary is pruned from the book entirely.
            assert f.manager.get(summary["canary"]) is None
            assert len(f.manager.ready()) == 2
            assert f.predict([[9]])["predictions"] == [[18]]
            rollbacks = REGISTRY.counter(
                "hops_tpu_fleet_rollouts_total", labels=("model", "outcome")
            ).value(model=fleet_model, outcome="rolled_back")
            assert rollbacks >= 1
            return summary["outcome"], traffic.errors, traffic.bad

    def test_chaos_replica_killed_mid_traffic_mid_rollout(
            self, fleet_model, tmp_path):
        """Acceptance: sustained traffic + a replica KILLED mid-flight
        + a rollout in progress -> the router completes every request
        and the autoscaler heals the fleet back to target size. Runs
        with workload capture ARMED: recording the stream must not
        change the zero-client-visible-failures outcome, and the
        chaos run's capture must come out replayable."""

        v2 = _export_version("flt", "return [[v[0] * 3] for v in instances]")
        policy = AutoscalePolicy(min_replicas=3, max_replicas=5,
                                 target_load=50.0)  # heal-only: wide band
        workload.start_capture(tmp_path / "chaos_capture")
        try:
            with _start(fleet_model, replicas=3, autoscale=policy,
                        autoscale_interval_s=0.05) as f:
                expect = lambda i: ([[i * 2]], [[i * 3]])  # noqa: E731
                with _Traffic(f, expect, clients=4) as traffic:
                    time.sleep(0.15)
                    # Kill a replica mid-flight (no drain, no goodbye) ...
                    victim = f.manager.ready()[0]
                    f.manager.kill(victim.rid)
                    # ... while a rollout is in progress.
                    summary = f.roll_out(v2, canary_requests=2,
                                         canary_window_s=10)
                    # Let the autoscaler heal back to the floor.
                    deadline = time.monotonic() + 15
                    while time.monotonic() < deadline:
                        if len(f.manager.ready()) >= 3:
                            break
                        time.sleep(0.05)
                assert summary["outcome"] == "completed"
                assert traffic.errors == []  # ZERO failed requests
                assert traffic.bad == []
                assert len(traffic.done_t) > 30
                assert len(f.manager.ready()) >= 3
                # A completed rollout leaves the fleet HOMOGENEOUS: the
                # version commits before the shift (so mid-rollout heals
                # resolve the new artifact) and the straggler sweep drains
                # any old-version replica a heal landed during the canary.
                assert all(r.version == v2 for r in f.manager.ready())
                assert f.predict([[4]])["predictions"] == [[12]]
        finally:
            workload.stop_capture()
        # The chaos run's capture verifies and holds the front-door
        # stream — every client request, zero 5xx outcomes (retries
        # were invisible), ready to replay through bench.py --replay.
        loaded = workload.load_artifact(tmp_path / "chaos_capture")
        router_recs = [r for r in loaded["records"]
                       if r["surface"] == "router"]
        assert len(router_recs) >= len(traffic.done_t)
        assert all(r["status"] < 500 for r in router_recs
                   if r.get("path") == "/predict")


# -- out-of-process workers ---------------------------------------------------


@in_both
class TestProcessWorkers:
    def test_fleet_worker_process_spawn_predict_drain_reap(self, fleet_model):
        mgr = ReplicaManager(fleet_model, spawn_timeout_s=120.0)
        router = Router(mgr, scrape_interval_s=0.1)
        try:
            rep = mgr.spawn()
            assert rep.proc is not None and rep.pid is not None
            assert rep.state == "ready"
            # The worker runs the package under test: a worker argv left
            # at the JAX module would serve every port replica from JAX.
            assert worker_module(rep.pid) == f"{PKG}.modelrepo.serving_host"
            # The worker announced its port via state.json and serves
            # the TF-Serving path through the router.
            code, payload, _ = router.route(
                json.dumps({"instances": [[8]]}).encode())
            # Zero-copy relay: the routed payload is the replica's
            # verbatim bytes.
            assert code == 200
            assert json.loads(payload)["predictions"] == [[16]]
            # Its OWN process registry answers the scrape.
            router.scrape_once()
            assert router._view(rep.rid).scrape_ok
            # Drain over HTTP flips the worker's /healthz to draining.
            mgr.drain(rep.rid)
            assert mgr.healthz(rep.rid) == "draining"
            assert mgr.drained(rep.rid)
            mgr.reap(rep.rid)
            assert rep.proc.poll() is not None  # actually terminated
            return json.loads(payload)["predictions"], rep.state
        finally:
            router.stop()
            mgr.stop()


# -- bench tier ---------------------------------------------------------------


@in_both
def test_bench_serving_fleet_smoke(workspace):
    """`bench.py --serving-fleet --smoke` runs the whole tier — scale-up,
    steady-state measurement, mid-load rollout — and emits a sane line."""
    result = bench_tier("run_serving_fleet_bench", PKG)(smoke=True)
    assert result["errors"] == 0
    assert result["requests_per_sec"] > 0
    assert result["p99_ms"] >= result["p50_ms"] > 0
    assert result["replicas"] >= 2
    assert result["rollout_outcome"] == "completed"
    assert result["speedup_vs_single"] > 0
    assert 0 < result["balance_min_over_max"] <= 1.0


# -- gray-failure tolerance: hedging, ejection, QoS ---------------------------


def _mini_server(delay_s=0.0, code=200, body=b'{"predictions": [[2]]}'):
    """A one-trick replica: sleeps, then answers. HTTP/1.1 so the
    router's connection pool exercises its keep-alive path."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True  # no delayed-ACK stall in timings

        def log_message(self, *a):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            self.rfile.read(length)
            time.sleep(delay_s)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _seed_latency(router, rid, seconds, n=10):
    view = router._view(rid)
    for _ in range(n):
        view.latency.observe(seconds)


def _wait_until(pred, timeout_s=15.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return False


@in_both
class TestHedging:
    """Adaptive hedging + the hedge/abandon races: the abandoned loser
    completing (or transport-failing) after the winner must not strike
    a breaker, leak an inflight count, or double-answer the client —
    and capture/workload recording sits ABOVE route(), so one request
    stays one recorded entry no matter how many attempts raced."""

    def _router(self, reps, **hedge_kw):

        hedge_kw.setdefault("min_samples", 8)
        hedge_kw.setdefault("budget_frac", 0.5)
        hedge_kw.setdefault("budget_burst", 5.0)
        r = Router(_StubManager(reps), scrape_interval_s=30.0,
                   forward_timeout_s=5.0, hedge=HedgePolicy(**hedge_kw))
        for rep in reps:
            _seed_latency(r, rep.rid, 0.01)
        return r

    def test_hedge_fires_after_adaptive_delay_and_wins(self):
        slow = _mini_server(delay_s=0.4)
        fast = _mini_server(body=b'{"predictions": [["fast"]]}')
        reps = [_StubRep("slow", slow.server_address[1]),
                _StubRep("fast", fast.server_address[1])]
        r = self._router(reps)
        try:
            # Bias selection to the slow replica so the hedge has a
            # rescue to perform.
            r._view("fast").queue_depth = 0.5
            won0 = REGISTRY.counter(
                "hops_tpu_fleet_hedges_total", labels=("model", "outcome")
            ).value(model="stub", outcome="won")
            t0 = time.perf_counter()
            code, payload, _ = r.route(b'{"instances": [[1]]}')
            dt = time.perf_counter() - t0
            assert code == 200
            assert json.loads(payload) == {"predictions": [["fast"]]}
            assert dt < 0.35  # the 0.4s primary did NOT gate the reply
            assert REGISTRY.counter(
                "hops_tpu_fleet_hedges_total", labels=("model", "outcome")
            ).value(model="stub", outcome="won") - won0 == 1
            # The abandoned loser finishes on its own thread: inflight
            # drains to zero, the breaker takes no strike, and its slow
            # completion lands in the latency stats (the ejection
            # detector's gray signal).
            n0 = r._view("slow").latency.sample_count()
            assert _wait_until(lambda: r._view("slow").inflight == 0
                               and r._view("fast").inflight == 0)
            assert _wait_until(
                lambda: r._view("slow").latency.sample_count() > n0, 5)
            assert r._view("slow").breaker.state == "closed"
            assert r._view("fast").breaker.state == "closed"
        finally:
            r.stop()
            slow.shutdown()
            slow.server_close()
            fast.shutdown()
            fast.server_close()

    def test_abandoned_loser_transport_failure_never_strikes(self):
        # The loser times out AFTER the hedge already answered: a
        # breaker strike here would punish a replica for a request the
        # client never missed.
        wedged = _mini_server(delay_s=3.0)
        fast = _mini_server()
        reps = [_StubRep("wedged", wedged.server_address[1]),
                _StubRep("fast", fast.server_address[1])]

        r = Router(_StubManager(reps), scrape_interval_s=30.0,
                   forward_timeout_s=0.5,
                   hedge=HedgePolicy(min_samples=8, budget_frac=0.5,
                                     budget_burst=5.0))
        for rep in reps:
            _seed_latency(r, rep.rid, 0.01)
        retries = REGISTRY.counter(
            "hops_tpu_fleet_retries_total", labels=("model", "reason"))
        try:
            r._view("fast").queue_depth = 0.5
            connect0 = retries.value(model="stub", reason="connect")
            code, payload, _ = r.route(b"{}")
            assert code == 200
            # Wait past the loser's forward timeout; its failure must
            # be swallowed (abandoned), not accounted.
            time.sleep(0.8)
            assert r._view("wedged").breaker.state == "closed"
            assert retries.value(model="stub", reason="connect") == connect0
            assert _wait_until(lambda: r._view("wedged").inflight == 0)
        finally:
            r.stop()
            wedged.shutdown()
            wedged.server_close()
            fast.shutdown()
            fast.server_close()

    def test_hedge_budget_denies_past_the_cap(self):
        slow = _mini_server(delay_s=0.15)
        fast = _mini_server()
        reps = [_StubRep("slow", slow.server_address[1]),
                _StubRep("fast", fast.server_address[1])]
        r = self._router(reps, budget_frac=0.01, budget_burst=1.0)
        try:
            r._view("fast").queue_depth = 0.5
            hedges = REGISTRY.counter(
                "hops_tpu_fleet_hedges_total", labels=("model", "outcome"))
            denied0 = hedges.value(model="stub", outcome="denied")
            fired0 = (hedges.value(model="stub", outcome="won")
                      + hedges.value(model="stub", outcome="lost"))
            for _ in range(3):
                code, _, _ = r.route(b"{}")
                assert code == 200
                # Let the abandoned loser drain so the slow replica is
                # re-picked as primary (score = live inflight) and the
                # next request needs a hedge again.
                assert _wait_until(lambda: r._view("slow").inflight == 0)
            # One token existed at start; once spent, refill at 0.01
            # per request can never mint another inside this test.
            fired = (hedges.value(model="stub", outcome="won")
                     + hedges.value(model="stub", outcome="lost")) - fired0
            assert fired <= 1
            assert hedges.value(model="stub", outcome="denied") - denied0 >= 1
        finally:
            r.stop()
            slow.shutdown()
            slow.server_close()
            fast.shutdown()
            fast.server_close()

    def test_hedging_disabled_without_latency_history(self):
        # min_samples unmet -> _hedge_delay_s is None -> pure sync path.
        fast = _mini_server()
        reps = [_StubRep("only", fast.server_address[1])]

        r = Router(_StubManager(reps), scrape_interval_s=30.0,
                   hedge=HedgePolicy(min_samples=64))
        try:
            assert r._hedge_delay_s() is None
            code, _, _ = r.route(b"{}")
            assert code == 200
        finally:
            r.stop()
            fast.shutdown()
            fast.server_close()


@in_both
class TestEjection:
    """Gray-failure outlier detection: latency probation is a DISTINCT
    state machine from breaker-open — it opens on slow-but-200 evidence
    and heals only on shadow-probe evidence."""

    def _router(self, reps, **ej_kw):

        ej_kw.setdefault("min_samples", 4)
        ej_kw.setdefault("floor_ms", 5.0)
        ej_kw.setdefault("readmit_probes", 2)
        ej_kw.setdefault("probe_interval_s", 0.01)
        ej_kw.setdefault("readmit_slack_ms", 30.0)
        return Router(_StubManager(reps), scrape_interval_s=30.0,
                      ejection=EjectionPolicy(**ej_kw))

    def test_latency_outlier_ejected_into_probation(self):

        reps = [_StubRep("a", 1), _StubRep("b", 2), _StubRep("c", 3)]
        r = self._router(reps)
        try:
            base = REGISTRY.counter(
                "hops_tpu_fleet_ejections_total", labels=("model",)
            ).value(model="stub")
            _seed_latency(r, "a", 0.005)
            _seed_latency(r, "b", 0.006)
            _seed_latency(r, "c", 0.2)  # 200 ms vs ~5-6 ms peers
            r._eject_tick()
            view = r._view("c")
            assert view.probation is True
            assert view.breaker.state == "closed"  # NOT the breaker
            assert REGISTRY.counter(
                "hops_tpu_fleet_ejections_total", labels=("model",)
            ).value(model="stub") - base == 1
            assert "c" not in [rep.rid for rep in r.routable()]
            ejected = [e for e in flight.FLIGHT.events("replica_ejected")
                       if e["data"].get("replica") == "c"]
            assert ejected
            desc = {d["rid"]: d for d in r.describe()["replicas"]}
            assert desc["c"]["probation"] is True
            assert desc["a"]["probation"] is False
            assert r.describe()["qos"]["probation"] == 1
        finally:
            r.stop()

    def test_ejection_capped_never_empties_the_fleet(self):
        reps = [_StubRep("a", 1), _StubRep("b", 2)]
        r = self._router(reps)
        try:
            _seed_latency(r, "a", 0.004)
            _seed_latency(r, "b", 0.5)
            r._eject_tick()
            r._eject_tick()
            in_probation = [rid for rid in ("a", "b")
                            if r._view(rid).probation]
            assert in_probation == ["b"]  # never the last healthy one
            assert r.routable()
        finally:
            r.stop()

    def test_idle_uniform_fleet_never_ejects(self):
        reps = [_StubRep("a", 1), _StubRep("b", 2), _StubRep("c", 3)]
        r = self._router(reps, floor_ms=25.0)
        try:
            # Microsecond-scale jitter on an idle fleet: 'c' is 3x its
            # peers but far under the absolute floor.
            _seed_latency(r, "a", 0.000005)
            _seed_latency(r, "b", 0.000005)
            _seed_latency(r, "c", 0.00002)
            r._eject_tick()
            assert not any(r._view(x).probation for x in ("a", "b", "c"))
        finally:
            r.stop()

    def test_shadow_probes_readmit_a_healed_replica(self):

        healed = _mini_server(delay_s=0.0)
        reps = [_StubRep("a", 1), _StubRep("b", 2),
                _StubRep("c", healed.server_address[1])]
        r = self._router(reps)
        try:
            _seed_latency(r, "a", 0.005)
            _seed_latency(r, "b", 0.006)
            _seed_latency(r, "c", 0.3)
            r._eject_tick()
            view = r._view("c")
            assert view.probation is True
            base = REGISTRY.counter(
                "hops_tpu_fleet_readmissions_total", labels=("model",)
            ).value(model="stub")
            rep_c = reps[2]
            for _ in range(2):
                r._shadow_probe(rep_c, view, b'{"instances": [[1]]}', None)
            assert view.probation is False
            assert view.latency.sample_count() == 0  # history reset
            assert REGISTRY.counter(
                "hops_tpu_fleet_readmissions_total", labels=("model",)
            ).value(model="stub") - base == 1
            assert [e for e in flight.FLIGHT.events("replica_readmitted")
                    if e["data"].get("replica") == "c"]
            assert "c" in [rep.rid for rep in r.routable()]
        finally:
            r.stop()
            healed.shutdown()
            healed.server_close()

    def test_slow_probe_does_not_readmit(self):
        still_slow = _mini_server(delay_s=0.2)
        reps = [_StubRep("a", 1), _StubRep("b", 2),
                _StubRep("c", still_slow.server_address[1])]
        r = self._router(reps, readmit_slack_ms=5.0, readmit_factor=1.5)
        try:
            _seed_latency(r, "a", 0.005)
            _seed_latency(r, "b", 0.006)
            _seed_latency(r, "c", 0.3)
            r._eject_tick()
            view = r._view("c")
            for _ in range(3):
                r._shadow_probe(reps[2], view, b"{}", None)
            assert view.probation is True  # still gray, stays out
            assert view.probe_oks == 0
        finally:
            r.stop()
            still_slow.shutdown()
            still_slow.server_close()


@in_both
class TestSyntheticProbes:
    """Zero-traffic probation re-admission: with no live requests to
    shadow, the scrape loop synthesizes probe bodies from a captured
    workload artifact — otherwise a quiet fleet's probation is a life
    sentence."""

    def _workload(self, tmp_path):

        rec = WorkloadRecorder(tmp_path / "cap")
        for i in range(3):
            rec.record(surface="router", endpoint="stub",
                       payload={"instances": [[float(i), 2.0]]},
                       instances=[[float(i), 2.0]], status=200,
                       latency_ms=2.0)
        rec.stop()
        return tmp_path / "cap"

    def _router(self, reps, probe_workload, **ej_kw):

        ej_kw.setdefault("min_samples", 4)
        ej_kw.setdefault("floor_ms", 5.0)
        ej_kw.setdefault("readmit_probes", 2)
        ej_kw.setdefault("probe_interval_s", 0.01)
        ej_kw.setdefault("readmit_slack_ms", 30.0)
        return Router(_StubManager(reps), scrape_interval_s=30.0,
                      ejection=EjectionPolicy(**ej_kw),
                      probe_workload=probe_workload)

    def test_zero_traffic_probation_readmitted_by_synthetic_probes(
            self, tmp_path):
        healed = _mini_server(delay_s=0.0)
        reps = [_StubRep("a", 1), _StubRep("b", 2),
                _StubRep("c", healed.server_address[1])]
        r = self._router(reps, self._workload(tmp_path))
        try:
            _seed_latency(r, "a", 0.005)
            _seed_latency(r, "b", 0.006)
            _seed_latency(r, "c", 0.3)
            r._eject_tick()
            assert r._view("c").probation is True
            base = REGISTRY.counter(
                "hops_tpu_fleet_synthetic_probes_total", labels=("model",)
            ).value(model="stub")
            # The captured bodies re-materialize deterministically.
            pool = r._probe_body_pool()
            assert [json.loads(b) for b in pool] == [
                {"instances": [[float(i), 2.0]]} for i in range(3)]
            # NO live traffic at all: only the scrape-loop tick fires
            # probes, and they alone must heal the replica.
            deadline = time.monotonic() + 10
            while r._view("c").probation and time.monotonic() < deadline:
                r._synthetic_probe_tick()
                time.sleep(0.02)
            assert r._view("c").probation is False
            assert "c" in [rep.rid for rep in r.routable()]
            assert REGISTRY.counter(
                "hops_tpu_fleet_synthetic_probes_total", labels=("model",)
            ).value(model="stub") - base >= 2  # readmit_probes
        finally:
            r.stop()
            healed.shutdown()
            healed.server_close()

    def test_tick_is_noop_without_probation_or_workload(self, tmp_path):
        reps = [_StubRep("a", 1), _StubRep("b", 2)]
        base = REGISTRY.counter(
            "hops_tpu_fleet_synthetic_probes_total", labels=("model",)
        ).value(model="stub")
        # Healthy fleet: the pool is never even materialized.
        r = self._router(reps, self._workload(tmp_path))
        try:
            r._synthetic_probe_tick()
            assert r._probe_bodies is None
        finally:
            r.stop()
        # Probation but no configured workload: live probes only.
        r2 = self._router(reps, None)
        try:
            _seed_latency(r2, "a", 0.005)
            _seed_latency(r2, "b", 0.5)
            r2._eject_tick()
            assert r2._view("b").probation is True
            r2._synthetic_probe_tick()
        finally:
            r2.stop()
        assert REGISTRY.counter(
            "hops_tpu_fleet_synthetic_probes_total", labels=("model",)
        ).value(model="stub") == base

    def test_unusable_artifact_disables_probes_not_the_router(
            self, tmp_path):
        (tmp_path / "junk").mkdir()
        reps = [_StubRep("a", 1), _StubRep("b", 2)]
        r = self._router(reps, tmp_path / "junk")
        try:
            _seed_latency(r, "a", 0.005)
            _seed_latency(r, "b", 0.5)
            r._eject_tick()
            assert r._view("b").probation is True
            r._synthetic_probe_tick()  # logs once, no crash
            assert r._probe_body_pool() == []
            # Live-traffic shadow probes still work as before.
            assert r._view("b").probation is True
        finally:
            r.stop()


@in_both
class TestQoSRouting:
    def test_batch_class_bucket_answers_429_before_replicas(self, fleet_model):
        shed = REGISTRY.counter(
            "hops_tpu_fleet_qos_shed_total",
            labels=("model", "priority", "reason"))
        base = shed.value(model="flt", priority="batch", reason="rate")
        with _start(fleet_model, replicas=1,
                    class_limits={"batch": {"rate_rps": 0.01,
                                            "burst": 1.0}}) as f:
            assert f.predict([[1]], priority="batch")["predictions"] == [[2]]
            with pytest.raises(urllib.error.HTTPError) as e:
                f.predict([[1]], priority="batch")
            assert e.value.code == 429
            assert float(e.value.headers["Retry-After"]) >= 1
            # Interactive traffic is untouched by the batch bucket.
            assert f.predict([[1]])["predictions"] == [[2]]
        assert shed.value(
            model="flt", priority="batch", reason="rate") - base == 1
        return (e.value.code, e.value.headers["Retry-After"],
                shed.value(model="flt", priority="batch", reason="rate") - base)

    def test_tenant_config_wins_header_can_only_demote(self, fleet_model):
        # Tenant configured batch + an interactive header claim: the
        # claim must NOT jump the queue — the batch bucket still
        # applies.
        with _start(fleet_model, replicas=1,
                    rate_limits={"bt": {"priority": "batch"}},
                    class_limits={"batch": {"rate_rps": 0.01,
                                            "burst": 1.0}}) as f:
            assert f.predict([[1]], tenant="bt", priority="interactive")[
                "predictions"] == [[2]]
            with pytest.raises(urllib.error.HTTPError) as e:
                f.predict([[1]], tenant="bt", priority="interactive")
            assert e.value.code == 429
            return e.value.code, e.value.headers["Retry-After"]

    def test_brownout_shed_level_refuses_batch_first(self, fleet_model):
        shed = REGISTRY.counter(
            "hops_tpu_fleet_qos_shed_total",
            labels=("model", "priority", "reason"))
        base = shed.value(model="flt", priority="batch", reason="brownout")
        with _start(fleet_model, replicas=1,
                    brownout={"slo_p99_ms": 50.0}) as f:
            f.router._brownout.level = 2  # force SHED (controller-owned)
            with pytest.raises(urllib.error.HTTPError) as e:
                f.predict([[1]], priority="batch")
            assert e.value.code == 503
            # Interactive rides through a full brownout.
            assert f.predict([[1]])["predictions"] == [[2]]
        assert shed.value(
            model="flt", priority="batch", reason="brownout") - base == 1
        return e.value.code, shed.value(
            model="flt", priority="batch", reason="brownout") - base

    def test_brownout_scoped_per_fleet_in_shared_process(self, fleet_model):
        """Regression: two fleets in one process — one fleet's SHED
        must not brown out its neighbor. The browned-out fleet's
        router sheds ITS batch traffic and its replicas adopt the
        relayed level under their own scope; the neighbor's endpoints
        (and the process-global scope) stay at full quality."""

        _export_version("flt2", "return [[v[0] * 3] for v in instances]")
        serving.create_or_update("flt2", model_name="flt2",
                                 model_version=1, model_server="PYTHON")
        with _start(fleet_model, replicas=1,
                    brownout={"slo_p99_ms": 50.0}) as fa, \
                _start("flt2", replicas=1,
                       brownout={"slo_p99_ms": 50.0}) as fb:
            fa.router._brownout.level = 2  # force SHED (controller-owned)
            with pytest.raises(urllib.error.HTTPError) as e:
                fa.predict([[1]], priority="batch")
            assert e.value.code == 503
            # Interactive rides through; the forward stamps the level
            # and the replica adopts it under scope "flt".
            assert fa.predict([[1]])["predictions"] == [[2]]
            assert qos.brownout_level(scope="flt") >= qos.DEGRADE
            # The neighbor fleet and the global scope are untouched —
            # the old process-global level would have browned out both.
            assert qos.brownout_level(scope="flt2") == 0
            assert qos.brownout_level() == 0
            # flt2's batch traffic is NOT shed.
            assert fb.predict([[1]], priority="batch")[
                "predictions"] == [[3]]
            return (e.value.code, qos.brownout_level(scope="flt"),
                    qos.brownout_level(scope="flt2"))

    def test_histogram_p99_estimates_from_bucket_deltas(self):

        reps = [_StubRep("a", 1)]
        r = Router(_StubManager(reps), scrape_interval_s=30.0)
        try:
            child = router_mod._m_request_seconds.labels(
                model="stub", priority="interactive")
            for _ in range(99):
                child.observe(0.010)
            child.observe(5.0)
            p99 = r.histogram_p99_ms(priority="interactive")
            assert p99 is not None
            # The mass sits in the ~10ms bucket; the single 5s outlier
            # pulls the estimate above the p50 region but the answer
            # must stay in the low-latency bucket's range.
            assert 5.0 <= p99 <= 100.0
        finally:
            r.stop()


@in_both
class TestGrayFailureChaos:
    def test_gray_replica_ejection_probation_readmission_mid_traffic(
            self, fleet_model):
        """The acceptance chaos scenario: a replica turns gray (slow,
        every answer still a 200) MID-TRAFFIC; the fleet hedges around
        it, ejects it into probation, keeps serving with zero
        client-visible errors, and — once it heals — shadow probes
        readmit it."""
        ejections = REGISTRY.counter(
            "hops_tpu_fleet_ejections_total", labels=("model",))
        readmissions = REGISTRY.counter(
            "hops_tpu_fleet_readmissions_total", labels=("model",))
        ej0 = ejections.value(model="flt")
        re0 = readmissions.value(model="flt")
        with _start(
            fleet_model, replicas=3,
            hedge=fleet.HedgePolicy(min_samples=8, budget_frac=0.05,
                                    budget_burst=5.0),
            ejection=fleet.EjectionPolicy(
                min_samples=5, factor=3.0, floor_ms=5.0,
                probe_interval_s=0.05, readmit_probes=2,
                readmit_slack_ms=30.0),
        ) as f:
            errors: list = []
            stop = threading.Event()

            def client():
                while not stop.is_set():
                    try:
                        out = f.predict([[3]], timeout_s=20.0)
                        if out["predictions"] != [[6]]:
                            errors.append(("bad", out))
                    except Exception as e:  # noqa: BLE001 — the assert
                        errors.append(repr(e))

            threads = [threading.Thread(target=client) for _ in range(4)]
            for t in threads:
                t.start()
            try:
                time.sleep(0.7)  # healthy warmup: latency stats seeded
                gray = f.manager.ready()[-1]
                faultinject.arm(
                    f"serving.handle=latency:0.25@key={gray.port}")
                assert _wait_until(
                    lambda: ejections.value(model="flt") > ej0, 20.0), \
                    "gray replica was never ejected"
                desc = {d["rid"]: d for d in f.describe()["replicas"]}
                assert desc[gray.rid]["probation"] is True
                assert desc[gray.rid]["breaker"] == "closed"  # gray != down
                # The replica heals: probes must readmit it.
                faultinject.disarm()
                assert _wait_until(
                    lambda: readmissions.value(model="flt") > re0, 20.0), \
                    "healed replica was never readmitted"
                assert _wait_until(
                    lambda: not f.router._view(gray.rid).probation, 10.0)
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=10)
            assert errors == [], f"client-visible errors: {errors[:5]}"


@in_both
def test_bench_tail_smoke(workspace):
    """`bench.py --tail --smoke` pin: the tail tier's acceptance gates —
    hedged p99 >= 2x better than unhedged at hedge rate <= 5% (+ burst),
    an ejection observed, zero client-visible errors in every phase,
    batch shedding first while interactive sheds nothing, the brownout
    engaging, and the fan-out store beating sequential probing."""
    d = bench_tier("run_tail_bench", PKG)(smoke=True)
    assert d["p99_improvement"] >= 2.0
    # The budget invariant itself: hedges <= budget_frac * requests
    # + the burst (the burst amortizes away at production request
    # counts; at smoke counts it must be priced in explicitly).
    requests = d["hedged"]["requests"]
    assert d["hedged"]["hedges_fired"] <= 0.05 * requests + 5.0
    assert d["hedged"]["ejections"] >= 1
    assert d["unhedged"]["errors"] == 0 and d["hedged"]["errors"] == 0
    qos = d["qos"]
    assert qos["interactive"]["errors"] == 0
    assert qos["batch"]["errors"] == 0
    assert qos["interactive"]["sheds"] == 0
    batch_sheds = (qos["batch"]["sheds"]
                   + qos["router_sheds"]["batch_rate"]
                   + qos["router_sheds"]["batch_brownout"])
    assert batch_sheds > 0
    assert qos["router_sheds"]["interactive_rate"] == 0
    assert qos["router_sheds"]["interactive_brownout"] == 0
    assert qos["brownout_level_seen"] >= 1
    assert d["store"]["fanout_mean_ms"] <= d["store"]["sequential_mean_ms"] * 0.8


@in_both
class TestGrayScrapePath:
    def test_scrape_latency_fault_stales_the_view_not_routing(
            self, fleet_model):
        """`router.scrape=latency` keyed by replica port: the gray
        metrics path makes that replica's scrape time out — its view
        goes stale (scrape_ok False, deprioritized by score) — while
        requests keep flowing and the OTHER replicas keep scraping."""
        with _start(fleet_model, replicas=2,
                    scrape_interval_s=0.05) as f:
            # Let healthy scrapes land first.
            reps = f.manager.ready()
            assert _wait_until(lambda: all(
                f.router._view(r.rid).last_scrape_mono is not None
                for r in reps), 10.0)
            victim, healthy = reps[0], reps[1]
            faultinject.arm(
                f"router.scrape=latency:1.0@key={victim.port}")
            assert _wait_until(
                lambda: not f.router._view(victim.rid).scrape_ok, 10.0), \
                "gray scrape never staled the victim's view"
            # Routing never stalled: requests answer while the scrape
            # path is wedged, and the healthy replica's scrape stays ok.
            assert f.predict([[5]], timeout_s=10.0)["predictions"] == [[10]]
            assert f.router._view(healthy.rid).scrape_ok
            faultinject.disarm()
            assert _wait_until(
                lambda: f.router._view(victim.rid).scrape_ok, 10.0)


@in_both
class TestPackedWireRelay:
    """Packed frames through the full router→replica→batcher chain:
    the relay stays zero-copy (negotiation headers forwarded, bytes
    untouched), answers are bit-identical to the JSON path, and the
    armed capture tap summarizes packed bodies instead of warning."""

    def _post(self, url: str, body: bytes,
              headers: dict) -> tuple[int, dict, bytes]:
        req = urllib.request.Request(url, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, dict(resp.headers.items()), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers.items()), e.read()

    def test_packed_parity_through_router_and_batcher(self, fleet_model):
        import numpy as np


        with _start(fleet_model, replicas=1) as f:
            rep = f.manager.replicas()[0]
            arr = np.asarray([[1.5], [2.25], [-3.75]], dtype=np.float32)
            frame = wirecodec.encode_instances(arr)
            hdrs = {"Content-Type": wirecodec.MEDIA_TYPE,
                    "Accept": wirecodec.MEDIA_TYPE}
            code_d, _, direct = self._post(
                f"http://127.0.0.1:{rep.port}/v1/models/flt:predict",
                frame, hdrs)
            code_r, rhdrs, routed = self._post(
                f"{f.router.endpoint}/predict", frame, hdrs)
            assert code_d == code_r == 200
            assert routed == direct  # zero-copy: byte-for-byte relay
            assert rhdrs.get("Content-Type") == wirecodec.MEDIA_TYPE
            packed = wirecodec.decode_predictions(routed)
            code_j, jhdrs, raw_j = self._post(
                f"{f.router.endpoint}/predict",
                json.dumps({"instances": arr.tolist()}).encode(),
                {"Content-Type": "application/json"})
            assert code_j == 200 and "json" in jhdrs.get("Content-Type", "")
            preds_json = json.loads(raw_j)["predictions"]
            # Bit-identical after the f32 cast both paths share (the
            # predictor doubles; *2 is exact in either precision).
            assert np.asarray(packed, dtype=np.float32).tolist() == \
                np.asarray(preds_json, dtype=np.float32).tolist()
            return routed.hex(), rhdrs.get("Content-Type"), preds_json

    def test_armed_capture_summarizes_packed_bodies(self, fleet_model):
        import numpy as np


        d = Path(tempfile.mkdtemp(prefix="relay_pk_"))
        with _start(fleet_model, replicas=1) as f:
            workload.start_capture(d)
            try:
                arr = np.zeros((6, 3), dtype=np.float32)
                code, _, _ = self._post(
                    f"{f.router.endpoint}/predict",
                    wirecodec.encode_instances(arr),
                    {"Content-Type": wirecodec.MEDIA_TYPE,
                     "Accept": wirecodec.MEDIA_TYPE})
                assert code == 200
            finally:
                workload.stop_capture()
        records = [
            json.loads(line)
            for seg in sorted(d.glob("segment_*.jsonl"))
            for line in seg.read_text().splitlines()
        ]
        front = [r for r in records if r.get("surface") == "router"]
        assert front and front[0]["wire_format"] == "packed"
        summary = front[0]["payload_summary"]
        assert summary["instances"] == 6
        assert summary["instance"] == {"kind": "list", "shape": [3]}
        assert summary["dtype"] == "<f4"
        assert "payload" not in front[0]  # tensor body never JSONs
        return summary


def test_port_process_fleet_starts_its_replicas_side_by_side(request):
    """The port's ``start_fleet`` spawns process workers in parallel: the
    two spawns overlap in time, both workers serve, and both are reaped."""
    _use_workspace("torch", request)
    _export_version("flt", "return [[v[0] * 2] for v in instances]")
    t_serving.create_or_update("flt", model_name="flt", model_version=1,
                               model_server="PYTHON")
    spans: list[tuple[float, float]] = []
    spawn_process = t_ReplicaManager._spawn_process

    def timed(self, rep, cfg):
        t0 = time.monotonic()
        try:
            spawn_process(self, rep, cfg)
        finally:
            spans.append((t0, time.monotonic()))

    mp = request.getfixturevalue("monkeypatch")
    mp.setattr(t_ReplicaManager, "_spawn_process", timed)
    f = t_fleet.start_fleet("flt", 2, spawn_timeout_s=120.0, scrape_interval_s=0.05)
    try:
        reps = f.manager.ready()
        assert sorted(r.rid for r in reps) == ["r0", "r1"]
        assert len({r.pid for r in reps}) == 2
        assert {worker_module(r.pid) for r in reps} == {"hops_tpu_torch.modelrepo.serving_host"}
        (a0, a1), (b0, b1) = sorted(spans)
        assert b0 < a1, f"the second spawn began after the first ended: {spans}"
        assert [f.predict([[v]])["predictions"] for v in (3, 4)] == [[[6]], [[8]]]
    finally:
        f.stop()
    assert all(r.proc.poll() is not None for r in reps)


def test_port_workers_start_warm_from_a_spare(request):
    """After a start the port's manager keeps a spare worker that has
    imported torch: the next spawn runs in it (the same module, its own
    log and session, ready and serving), a changed environment starts
    cold and drops the stale spare, and stop() ends the last spare."""
    import os

    _use_workspace("torch", request)
    _export_version("flt", "return [[v[0] * 2] for v in instances]")
    t_serving.create_or_update("flt", model_name="flt", model_version=1,
                               model_server="PYTHON")
    mgr = t_ReplicaManager("flt", spawn_timeout_s=120.0)
    router = t_router.Router(mgr, scrape_interval_s=0.1)
    try:
        first = mgr.spawn()
        spare = mgr.starter._spare[0]
        second = mgr.spawn()
        assert second.proc is spare and (mgr.starter.warm, mgr.starter.cold) == (1, 1)
        assert worker_module(second.pid) == "hops_tpu_torch.modelrepo.serving_host"
        assert os.getsid(second.pid) == second.pid != os.getsid(0)
        announced = (mgr._fleet_dir() / second.rid / "worker.log").read_text().splitlines()
        assert json.loads(announced[-1])["pid"] == second.pid
        mgr.reap(first.rid)
        code, payload, _ = router.route(json.dumps({"instances": [[8]]}).encode())
        assert code == 200 and json.loads(payload)["predictions"] == [[16]]
        stale = mgr.starter._spare[0]
        request.getfixturevalue("monkeypatch").setenv("HOPS_SPARE_TEST", "1")
        third = mgr.spawn()
        assert third.proc is not stale and stale.poll() is not None
        assert (mgr.starter.warm, mgr.starter.cold) == (1, 2)
        last = mgr.starter._spare[0]
    finally:
        router.stop()
        mgr.stop()
    assert last.poll() is not None and mgr.starter._spare is None
    assert all(r.proc.poll() is not None for r in (first, second, third))
