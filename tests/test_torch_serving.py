"""The port's HTTP serving host (``hops_tpu_torch.modelrepo.serving``)
against the JAX package's (``hops_tpu.modelrepo.serving``), each in its
own workspace: the LM endpoint returns the same greedy tokens for
concurrent and prefix requests; the classifier endpoint returns
``FlaxPredictor``'s logits for the converted bundle, with and without
dynamic batching; shedding, deadlines, the breaker, draining and the
routes answer with the same status codes; the endpoint lifecycle goes
through the same states; a standalone host serves and stops; and an
endpoint given no device raises where there is no card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from importlib import import_module
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.models import mnist as jax_mnist
from hops_tpu.models import resnet as jax_resnet
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.modelrepo import registry as jax_registry
from hops_tpu.modelrepo import serving as jax_serving
from hops_tpu.runtime import faultinject as jax_faultinject
from hops_tpu.runtime import qos as jax_qos
from hops_tpu_torch.models.convert import params_to_flax, random_params
from hops_tpu_torch.modelrepo import registry, serving
from hops_tpu_torch.runtime import config, faultinject, qos, wirecodec

TINY = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
WAIT_S = 60  # the bound on every wait for a thread or a request

PKGS = {
    "jax": SimpleNamespace(name="hops_tpu", serving=jax_serving, faultinject=jax_faultinject,
                           qos=jax_qos),
    "torch": SimpleNamespace(name="hops_tpu_torch", serving=serving, faultinject=faultinject,
                             qos=qos),
}


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


def _request(port: int, path: str, body: bytes | None = None,
             headers: dict | None = None, timeout: float = WAIT_S):
    """(status, body bytes, headers) of a GET (no body) or POST."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _post(port: int, name: str, instances, headers: dict | None = None):
    code, body, hdrs = _request(port, f"/v1/models/{name}:predict",
                                json.dumps({"instances": instances}).encode(),
                                {"Content-Type": "application/json", **(headers or {})})
    return code, json.loads(body), hdrs


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()


# -- (1) LM parity ------------------------------------------------------------


def test_lm_endpoint_matches_jax_over_http(tmp_path):
    """The JAX package's ``test_lm_model_server_end_to_end`` scenario in
    both packages: concurrent HTTP requests on 2 slots, and requests
    that name a registered prefix, answer the same tokens."""
    model = JaxLM(**TINY, dtype=jnp.float32, attention_impl="reference")
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 64, (n,)).tolist() for n in (4, 9, 6)]
    budgets = [7, 3, 5]
    prefix = rs.randint(0, 64, (6,)).tolist()
    lm_config = {"slots": 2, "prefill_buckets": [8, 16], "prefixes": {"sys": prefix}}
    requests = [{"prompt": p, "max_new_tokens": b} for p, b in zip(prompts, budgets)]
    requests += [{"prompt": prompts[0], "max_new_tokens": 6, "prefix_id": "sys"},
                 {"prompt": prompts[2][:3], "max_new_tokens": 4, "prefix_id": "sys"}]

    jax_registry.save_flax(model, variables["params"], "cb-lm")
    registry.save_lm(dict(TINY, dtype="float32"), variables, "cb-lm")
    answers = {}
    for key, pkg in PKGS.items():
        kw = {} if key == "jax" else {"device": "cpu"}
        pkg.serving.create_or_update("cb-lm", model_name="cb-lm", model_server="LM",
                                     lm_config=lm_config, **kw)
        with pytest.raises(ValueError, match="continuous"):
            pkg.serving.create_or_update("cb-lm-bad", model_name="cb-lm", model_server="LM",
                                         batching_enabled=True, **kw)
        pkg.serving.start("cb-lm")
        try:
            got: dict[int, list] = {}

            def call(i, pkg=pkg, got=got):
                resp = pkg.serving.make_inference_request("cb-lm", {"instances": [requests[i]]})
                got[i] = resp["predictions"][0]

            threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            _join(threads)
            for i in (3, 4):  # the first prefix request prefills it, the second hits it
                call(i)
            stats = pkg.serving.get_model_status("cb-lm")["engine"]
        finally:
            pkg.serving.stop("cb-lm")
        answers[key] = [got[i] for i in range(len(requests))]
        assert stats["prefix_hits"] >= 1, key
    assert answers["torch"] == answers["jax"]
    assert [len(a) for a in answers["torch"]] == budgets + [6, 4]


# -- (2) classifier parity ----------------------------------------------------


def _jax_classifier(kind: str):
    """A JAX classifier, its variables (numpy) and seeded inputs; the
    ResNet's BatchNorm scales and statistics are redrawn so that eval
    mode reads them."""
    if kind == "cnn":
        model, shape = jax_mnist.CNN(dtype=jnp.float32), (28, 28, 1)
    else:
        model, shape = jax_resnet.ResNet18ish(num_classes=10, dtype=jnp.float32), (32, 32, 3)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros((1, *shape))))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(2)
    draws = {"mean": lambda a: rng.normal(0, 0.2, a.shape),
             "var": lambda a: rng.uniform(0.5, 1.5, a.shape),
             "scale": lambda a: rng.uniform(0.5, 1.0, a.shape)}

    def redraw(tree):
        return {k: redraw(v) if isinstance(v, dict)
                else draws.get(k, lambda a: a)(v).astype(np.float32) for k, v in tree.items()}

    if "batch_stats" in variables:
        variables = {col: redraw(tree) for col, tree in variables.items()}
    x = np.random.default_rng(3).standard_normal((5, *shape)).astype(np.float32)
    return model, variables, x


@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_classifier_endpoint_matches_flax_predictor(kind):
    """A JAX ``save_flax`` bundle served by ``FlaxPredictor``, and the
    converted bundle served by the port on the CPU with and without
    batching: the logits agree to 1e-4, JSON and packed replies alike."""
    model, variables, x = _jax_classifier(kind)
    extra = {k: v for k, v in variables.items() if k != "params"}
    jax_registry.save_flax(model, variables["params"], "clf", extra_variables=extra)
    jax_serving.create_or_update("clf", model_name="clf")
    jax_serving.start("clf")
    try:
        want = np.asarray(jax_serving.make_inference_request(
            "clf", {"instances": x.tolist()})["predictions"])
    finally:
        jax_serving.stop("clf")

    # The converter takes what a JAX bundle holds, as numpy: the class
    # name, the dataclass fields and the variables.
    bundle = jax_registry.load_flax("clf")
    module = bundle["module"]
    fields = {f.name: getattr(module, f.name) for f in dataclasses.fields(module)}
    registry.save_classifier(type(module).__name__, fields,
                             {"params": jax.device_get(bundle["params"]),
                              **jax.device_get(bundle["extra_variables"])}, "clf")
    for batching in (False, True):
        name = f"clf-{int(batching)}"
        serving.create_or_update(name, model_name="clf", device="cpu",
                                 batching_enabled=batching,
                                 batching_config={"max_batch_size": 4, "timeout_ms": 20})
        cfg = serving.start(name)
        try:
            assert cfg["device"] == "cpu" and cfg["model_server"] == serving.FLAX
            got = np.asarray(serving.make_inference_request(
                name, {"instances": x.tolist()})["predictions"])
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
            rows: dict[int, list] = {}

            def one(i, name=name, rows=rows):
                rows[i] = serving.make_inference_request(
                    name, {"instances": [x[i].tolist()]})["predictions"][0]

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(x))]
            for t in threads:
                t.start()
            _join(threads)
            np.testing.assert_allclose(np.asarray([rows[i] for i in range(len(x))]), want,
                                       atol=1e-4, rtol=0)
            code, body, hdrs = _request(
                cfg["port"], f"/v1/models/{name}:predict", wirecodec.encode_instances(x),
                {"Content-Type": wirecodec.MEDIA_TYPE, "Accept": wirecodec.MEDIA_TYPE})
            assert code == 200 and hdrs["Content-Type"] == wirecodec.MEDIA_TYPE
            np.testing.assert_array_equal(wirecodec.decode_predictions(body), got)
            if batching:  # every row went through the batcher
                assert serving._servers[name].batcher.rows_run == 3 * len(x)
        finally:
            serving.stop(name)


def test_classifier_bundle_round_trips_a_port_module():
    from hops_tpu_torch.models.resnet import ResNet

    model = ResNet([1, 1, 1, 1], num_classes=10, width=8, dtype="float32", device="cpu", seed=4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape) + 0.5)
    fields = {"stage_sizes": [1, 1, 1, 1], "num_classes": 10, "width": 8,
              "dtype": torch.float32}
    meta = registry.save_classifier("ResNet", fields, params_to_flax(model), "rn")
    loaded = registry.load_classifier("rn", device="cpu")
    assert not loaded.training
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 16, 3)).astype(
        np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(loaded(x), model.eval()(x), atol=0, rtol=0)
    spec = json.loads((Path(meta["path"]) / "classifier.json").read_text())
    assert spec == {"module": "ResNet", "fields": dict(fields, dtype="float32", in_channels=3)}
    with pytest.raises(ValueError, match="unknown classifier"):
        registry.save_classifier("MLP", {}, {}, "bad")
    registry.save_lm(dict(TINY, dtype="float32"), random_params(**TINY), "lm")
    with pytest.raises(ValueError, match="not a classifier"):
        registry.load_classifier("lm", device="cpu")


# -- (3) batcher behaviour and fault status codes -----------------------------


def _batch_sizes(serving_mod) -> list[int]:
    """Batches a DynamicBatcher runs (max 4 rows) when requests of 1, 1,
    2, 2 and 5 rows queue behind a blocked first batch: coalescing under
    the cap, a request that would overflow it seeding the next batch,
    and an over-cap request run alone."""
    release = threading.Event()
    sizes: list[int] = []

    def predict(rows):
        sizes.append(len(rows))
        if len(sizes) == 1:
            assert release.wait(WAIT_S)
        return list(rows)

    b = serving_mod.DynamicBatcher(predict, max_batch_size=4, timeout_ms=100)
    out: dict[int, list] = {}
    threads = []
    try:
        for i, n in enumerate((1, 1, 2, 2, 5)):
            rows = [[i, j] for j in range(n)]
            t = threading.Thread(target=lambda i=i, rows=rows: out.__setitem__(
                i, b.predict(rows)))
            t.start()
            threads.append(t)
            deadline = time.monotonic() + WAIT_S
            # Each request queues before the next is sent (the first is
            # taken by the blocked batch at once).
            while (len(sizes) < 1 if i == 0 else b._queue.qsize() < i):
                assert time.monotonic() < deadline
                time.sleep(0.005)
        release.set()
        _join(threads)
    finally:
        release.set()
        b.stop()
    assert all(out[i] == [[i, j] for j in range(len(out[i]))] for i in out)
    return sizes


def test_batcher_coalesces_under_the_cap_like_jax():
    want = _batch_sizes(jax_serving)
    assert want == [1, 3, 2, 5]
    assert _batch_sizes(serving) == want


def _eviction(pkg) -> dict[str, str]:
    """A full batch queue (bound 1) sheds its batch-class item for an
    interactive one: the evicted waiter gets ``qos.ShedError``."""
    release = threading.Event()
    started = threading.Event()

    def predict(rows):
        started.set()
        assert release.wait(WAIT_S)
        return list(rows)

    b = pkg.serving.DynamicBatcher(predict, max_batch_size=1, timeout_ms=1, queue_bound=1)
    outcomes: dict[str, str] = {}

    def submit(tag, priority):
        with pkg.qos.priority_scope(priority):
            try:
                b.predict([[tag]])
                outcomes[tag] = "ok"
            except pkg.qos.ShedError as e:
                outcomes[tag] = type(e).__name__

    threads = [threading.Thread(target=submit, args=("head", "interactive"))]
    try:
        threads[0].start()
        assert started.wait(WAIT_S)
        for tag, prio in (("victim", "batch"), ("vip", "interactive")):
            threads.append(threading.Thread(target=submit, args=(tag, prio)))
            threads[-1].start()
            deadline = time.monotonic() + WAIT_S
            while b._queue.qsize() < 1 and tag == "victim":
                assert time.monotonic() < deadline
                time.sleep(0.005)
        deadline = time.monotonic() + WAIT_S
        while "victim" not in outcomes:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        release.set()
        _join(threads)
    finally:
        release.set()
        b.stop()
    return outcomes


def test_batch_queue_eviction_like_jax():
    want = _eviction(PKGS["jax"])
    assert want == {"head": "ok", "victim": "ShedError", "vip": "ok"}
    assert _eviction(PKGS["torch"]) == want


SCRIPT = """\
import time
from {pkg}.runtime import qos


class Predict:
    def predict(self, instances):
        tag = instances[0][0] if instances and instances[0] else None
        if tag == "slow":
            time.sleep(1.0)
        if tag == "shed":
            raise qos.ShedError("evicted")
        if tag == "full":
            raise qos.QueueFullError("submit queue full")
        return instances
"""


def _python_endpoint(pkg, tmp_path, name: str, **kw) -> int:
    d = tmp_path / f"{pkg.name}_{name}"
    d.mkdir()
    (d / "predictor.py").write_text(SCRIPT.format(pkg=pkg.name))
    pkg.serving.create_or_update(name, model_path=str(d), model_server="PYTHON", **kw)
    return pkg.serving.start(name)["port"]


def _healthz(port: int):
    code, body, hdrs = _request(port, "/healthz")
    return code, json.loads(body).get("status"), "Retry-After" in hdrs


def _inflight(pkg, name: str, n: int) -> None:
    """Wait (bounded) until ``n`` predicts are in flight on ``name``."""
    deadline = time.monotonic() + WAIT_S
    while pkg.serving._servers[name].inflight != n:
        assert time.monotonic() < deadline
        time.sleep(0.005)


def _overload(pkg, port, name):
    pkg.faultinject.arm("serving.handle=latency:1.0@times=1")
    results = []
    t = threading.Thread(target=lambda: results.append(_post(port, name, [[1]])))
    t.start()
    _inflight(pkg, name, 1)  # the slow request holds the only slot
    code, _, hdrs = _post(port, name, [[2]])
    _join([t])
    return [(code, "Retry-After" in hdrs), results[0][0], _post(port, name, [[3]])[0]]


def _qos_shed(pkg, port, name):
    out = []
    for tag in ("shed", "full", "full", "full"):
        code, body, hdrs = _post(port, name, [[tag]])
        out.append((code, hdrs.get("Retry-After"), body["error"].split(":")[0]))
    code, body, _ = _post(port, name, [[5]])
    return out + [code, body["predictions"], _healthz(port)]


def _deadline(pkg, port, name):
    out = [_post(port, name, [["slow"]])[0]]
    code, _, hdrs = _post(port, name, [[1]])
    out.append((code, "Retry-After" in hdrs))  # the abandoned predict holds the slot
    _inflight(pkg, name, 0)  # until it finishes
    return out + [_post(port, name, [[2]])[0]]


def _breaker(pkg, port, name):
    out = [_healthz(port)]
    pkg.faultinject.arm("serving.handle=error:RuntimeError@times=2")
    out += [_post(port, name, [[1]])[0] for _ in range(2)]
    code, _, hdrs = _post(port, name, [[1]])
    code_h, body, _ = _request(port, "/healthz")
    out += [(code, "Retry-After" in hdrs), (code_h, json.loads(body))]
    time.sleep(1.05)  # past breaker_reset_s: the next request is the half-open probe
    code, body, _ = _post(port, name, [[7]])
    return out + [(code, body["predictions"]), _healthz(port)]


def _drain(pkg, port, name):
    code, body, _ = _request(port, "/admin/drain", b"{}", {"Content-Type": "application/json"})
    code_p, _, hdrs = _post(port, name, [[1]])
    return [(code, json.loads(body)), (code_p, "Retry-After" in hdrs), _healthz(port)]


def _routes(pkg, port, name):
    out = [_request(port, "/v1/models/nope:predict", b"{}")[0],
           _request(port, f"/v1/models/{name}:predict", b'{"rows": []}')[0],
           _request(port, f"/v1/models/{name}:predict", b"\x89HWC\x01",
                    {"Content-Type": wirecodec.MEDIA_TYPE})[0]]
    code, body, _ = _request(port, f"/v1/models/{name}")
    out.append((code, json.loads(body)))
    out += [_request(port, f"/v1/models/{name}/versions/{v}")[0] for v in (1, 9)]
    out.append(_request(port, "/junk")[0])
    code, body, _ = _request(port, "/metrics")
    # The host label is the package's own (JAX: its process index).
    out.append((code, re.search(
        rf'^hops_tpu_serving_requests_total{{host="h[^"]*",model="{name}"}} 0', body.decode(),
        re.M) is not None))
    return out


def _batched(pkg, port, name):
    out = [_post(port, name, [[1], [2], [3]])]  # over the cap of 2: runs alone
    got: dict[int, tuple] = {}
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, _post(port, name, [[i]])))
               for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    return [(c, b) for c, b, _ in out] + [(got[i][0], got[i][1]) for i in range(4)]


SCENARIOS = {
    "overload": (_overload, {"max_inflight": 1}, {}),
    "qos_shed": (_qos_shed, {"breaker_failures": 2}, {}),
    "deadline": (_deadline, {"max_inflight": 1, "deadline_s": 0.15, "breaker_failures": 100}, {}),
    "breaker": (_breaker, {"breaker_failures": 2, "breaker_reset_s": 1.0}, {}),
    "drain": (_drain, {}, {}),
    "routes": (_routes, {}, {}),
    "batched": (_batched, {}, {"batching_enabled": True,
                               "batching_config": {"max_batch_size": 2, "timeout_ms": 20}}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fault_status_codes_match_jax(tmp_path, scenario):
    run, rcfg, kw = SCENARIOS[scenario]
    seen = {}
    for key, pkg in PKGS.items():
        name = f"chaos-{scenario}"
        port = _python_endpoint(pkg, tmp_path, name, resilience_config=rcfg, **kw)
        try:
            seen[key] = run(pkg, port, name)
        finally:
            pkg.faultinject.disarm()
            pkg.serving.stop(name)
    assert seen["torch"] == seen["jax"]


def _pooled(pkg, port: int, name: str) -> list:
    """Four exchanges through one package's keep-alive pool against the
    other package's endpoint: statuses as data, the connection reused."""
    pool = import_module(f"{pkg.name}.runtime.httpclient").HTTPPool(identity="test")
    base = f"http://127.0.0.1:{port}"
    try:
        out = [pool.request("POST", f"{base}/v1/models/{name}:predict",
                            json.dumps({"instances": [[i]]}).encode(),
                            {"Content-Type": "application/json"}, timeout_s=WAIT_S)[:2]
               for i in range(2)]
        out.append(pool.request("GET", f"{base}/junk", timeout_s=WAIT_S)[0])
        out.append(pool.request("GET", f"{base}/healthz", timeout_s=WAIT_S)[0])
        return out + [pool.created, pool.reused]
    finally:
        pool.close()


def test_pooled_client_matches_jax(tmp_path):
    """The port's ``runtime.httpclient`` (a copy) and the JAX package's,
    each against the other package's endpoint."""
    ports = {k: _python_endpoint(pkg, tmp_path, "pooled") for k, pkg in PKGS.items()}
    try:
        got = _pooled(PKGS["torch"], ports["jax"], "pooled")
        want = _pooled(PKGS["jax"], ports["torch"], "pooled")
    finally:
        for pkg in PKGS.values():
            pkg.serving.stop("pooled")
    assert got == want
    assert got[2:] == [404, 200, 1, 3]


# -- (4) lifecycle ------------------------------------------------------------


def _lifecycle(pkg, tmp_path) -> list:
    s = pkg.serving
    out = []
    d = tmp_path / f"{pkg.name}_life"
    d.mkdir()
    (d / "p.py").write_text(SCRIPT.format(pkg=pkg.name))
    cfg = s.create_or_update("life", model_path=str(d), model_server="python")
    out += [cfg["status"], cfg["model_server"], cfg["topic"], s.exists("life"),
            s.get_status("life"), s.get_kafka_topic("life")]
    s.start("life")
    out += [s.get_status("life"), s.make_inference_request("life", {"instances": [[4]]})]
    s.stop("life")
    # The inference log: the request and response pair on the topic.
    pubsub = import_module(f"{pkg.name}.messaging.pubsub")
    out.append([(r["key"], r["value"]) for r in
                pubsub.Consumer(cfg["topic"], from_beginning=True).poll()])
    out += [s.get_status("life"), s._load_registry()["life"]["status"]]
    # The hosting process dies: the record says Running over a dead port.
    s.start("life")
    with s._lock:
        dead = s._servers.pop("life")
    dead.stop()
    out += [s._load_registry()["life"]["status"], s.get_status("life"),
            s._load_registry()["life"]["status"]]
    out += [s.restore(), s.get_status("life")]
    # Another process stops it: the record flips; reconcile honours it.
    reg = s._load_registry()
    reg["life"]["status"] = "Stopped"
    s._save_registry(reg)
    out += [s.reconcile(), s.get_status("life"), s.restore(),
            [c["name"] for c in s.get_all()]]
    s.delete("life")
    out.append(s.exists("life"))
    with pytest.raises(KeyError):
        s.get_status("life")
    with pytest.raises(KeyError):
        s.start("ghost")
    return out


def test_lifecycle_states_match_jax(tmp_path):
    want = _lifecycle(PKGS["jax"], tmp_path)
    assert want[:2] == ["Stopped", "PYTHON"]
    assert _lifecycle(PKGS["torch"], tmp_path) == want


def test_feature_config_is_a_later_slice():
    """``feature_config`` is checked where the endpoint is defined, as the
    JAX package checks it: the same errors for an LM server and for bad
    configs, and a good config recorded as given."""
    good = {"groups": [{"name": "U", "primary_key": ["ID"], "features": ["A"]}],
            "missing": "reject"}
    bad = [dict(good, missing="explode"), {"groups": []}, {"groups": [{"name": "u"}]}]
    for pkg in PKGS.values():
        pkg.serving.create_or_update("fj", model_path="x", model_server="PYTHON",
                                     feature_config=good)
    assert (serving.get_all()[0]["feature_config"]
            == jax_serving.get_all()[0]["feature_config"] == good)
    for cfg, server in [(good, "LM")] + [(c, "PYTHON") for c in bad]:
        errors = []
        for pkg in PKGS.values():
            with pytest.raises(ValueError) as e:
                pkg.serving.create_or_update("fj", model_path="x", model_server=server,
                                             feature_config=cfg)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


# -- (5) standalone host ------------------------------------------------------


def _cnn_bundle(name: str) -> np.ndarray:
    from hops_tpu_torch.models.mnist import CNN

    model = CNN(dtype="float32", device="cpu", seed=6)
    registry.save_classifier("CNN", {"num_classes": 10, "dropout_rate": 0.5,
                                     "dtype": "float32"}, params_to_flax(model), name)
    return np.random.default_rng(7).standard_normal((2, 28, 28, 1)).astype(np.float32)


def test_standalone_host_serves_and_stops():
    x = _cnn_bundle("solo")
    serving.create_or_update("solo", model_name="solo", device="cpu")
    serving.start("solo")
    try:
        want = serving.make_inference_request("solo", {"instances": x.tolist()})
    finally:
        serving.stop("solo")
    cfg = serving.start("solo", standalone=True, timeout_s=WAIT_S)
    pid, port = cfg["pid"], cfg["port"]
    try:
        assert cfg["host"] == "standalone" and pid != os.getpid()
        assert serving.get_status("solo") == "Running"
        assert "solo" not in serving._servers
        got = serving.make_inference_request("solo", {"instances": x.tolist()})
        np.testing.assert_allclose(got["predictions"], want["predictions"], atol=1e-6, rtol=0)
    finally:
        serving.stop("solo")
    assert serving.get_status("solo") == "Stopped"
    assert not serving._pid_alive(pid)
    assert not serving._port_alive(port)


def test_importing_the_host_starts_nothing():
    code = ("import threading, hops_tpu_torch.modelrepo.serving_host as h\n"
            "print(threading.active_count(), callable(h.main))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=WAIT_S, cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "True"]


# -- (6) no card --------------------------------------------------------------


@pytest.mark.parametrize("model_server", ["FLAX", "LM"])
def test_endpoint_without_a_device_raises_without_a_card(model_server):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    if model_server == "LM":
        registry.save_lm(dict(TINY, dtype="float32"), random_params(**TINY), "card")
    else:
        _cnn_bundle("card")
    cfg = serving.create_or_update("card", model_name="card", model_server=model_server)
    assert cfg["device"] == "cuda:0"
    with pytest.raises(RuntimeError, match="cuda"):
        serving.start("card")
    assert serving.get_status("card") == "Stopped"
    assert "card" not in serving._servers
