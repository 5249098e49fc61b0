"""Workload capture and replay through the port's serving host
(``hops_tpu_torch.telemetry.workload``, a copy, on
``hops_tpu_torch.modelrepo.serving``): traffic captured at a live
endpoint replays through it with the same responses, the port records
what the JAX package records for the same traffic, and each package
replays the other's artifact.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hops_tpu.modelrepo import serving as jax_serving
from hops_tpu.telemetry import workload as jax_workload
from hops_tpu_torch.models.convert import random_params
from hops_tpu_torch.modelrepo import registry, serving
from hops_tpu_torch.runtime import config, wirecodec
from hops_tpu_torch.telemetry import workload

TINY = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64,
            dtype="float32")
# Fields of a record that depend on the run, not on the traffic.
RUN_FIELDS = {"seq", "t_mono", "t_wall", "latency_ms", "trace_id", "pid", "host"}


@pytest.fixture(autouse=True)
def torch_workspace(tmp_path, monkeypatch):
    """The port's config in its own workspace; capture disarmed in both
    packages before and after."""
    torch.set_num_threads(1)
    monkeypatch.setattr(config, "_current", config.runtime())
    config.configure(workspace=str(tmp_path / "torch_ws"), project="testproj")
    for w in (workload, jax_workload):
        w.stop_capture()
    yield
    for w in (workload, jax_workload):
        w.stop_capture()


def _send(base: str, body: bytes, headers: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(base, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_json(url: str, payload: dict, headers: dict | None = None) -> tuple[int, dict]:
    code, body = _send(url, json.dumps(payload).encode(),
                       {"Content-Type": "application/json", **(headers or {})})
    return code, json.loads(body)


def _replay_responses(records, url: str) -> tuple[dict, dict]:
    """Replay ``records`` against ``url``; (report, response body by seq)."""
    seen: dict[int, bytes] = {}

    def target(item):
        code, body = _send(url, item["body"], item["headers"])
        seen[item["seq"]] = body
        return code

    report = workload.replay(records, target, speed=100.0)
    return report, seen


def _python_endpoint(serving_mod, tmp_path, pkg: str, name: str) -> str:
    d = tmp_path / f"{pkg}_{name}"
    d.mkdir()
    (d / "p.py").write_text(
        "class Predict:\n"
        "    def predict(self, instances):\n"
        "        if instances[0] == ['boom']:\n"
        "            raise RuntimeError('boom')\n"
        "        return [[v[0] * 2] for v in instances]\n")
    serving_mod.create_or_update(name, model_path=str(d), model_server="PYTHON")
    return f"http://127.0.0.1:{serving_mod.start(name)['port']}"


TRAFFIC = [({"instances": [[float(i)]]}, {"X-Tenant": "acme" if i % 2 else "beta"})
           for i in range(4)] + [({"instances": [["boom"]]}, {})]


def _capture(serving_mod, workload_mod, tmp_path, pkg: str) -> list[dict]:
    """TRAFFIC through a Python endpoint of one package, captured over
    its admin routes."""
    base = _python_endpoint(serving_mod, tmp_path, pkg, "cap")
    try:
        code, st = _post_json(f"{base}/admin/capture/start", {"dir": str(tmp_path / pkg)})
        assert code == 200 and st["capturing"] is True
        for payload, headers in TRAFFIC:
            _post_json(f"{base}/v1/models/cap:predict", payload, headers)
        with urllib.request.urlopen(f"{base}/debug/workload", timeout=10) as r:
            assert json.loads(r.read())["requests"] == len(TRAFFIC)
        # A sloppy admin body degrades to {}.
        code, final = _send(f"{base}/admin/capture/stop", b"not json", {})
        assert code == 200 and json.loads(final)["capturing"] is False
    finally:
        serving_mod.stop("cap")
    return workload_mod.load_artifact(tmp_path / pkg)["records"]


def test_capture_records_what_jax_records(tmp_path):
    want = _capture(jax_serving, jax_workload, tmp_path, "jax")
    got = _capture(serving, workload, tmp_path, "torch")
    assert [r["status"] for r in got] == [200] * 4 + [500]
    assert [{k: v for k, v in r.items() if k not in RUN_FIELDS} for r in got] == \
        [{k: v for k, v in r.items() if k not in RUN_FIELDS} for r in want]
    assert all(r["latency_ms"] > 0 and r["trace_id"] for r in got)
    # Each package replays the other's artifact.
    assert workload.load_artifact(tmp_path / "jax")["records"] == want
    assert jax_workload.load_artifact(tmp_path / "torch")["records"] == got


def test_python_capture_replays_with_the_same_responses(tmp_path):
    records = _capture(serving, workload, tmp_path, "torch")
    base = _python_endpoint(serving, tmp_path, "torch2", "cap")
    try:
        report, seen = _replay_responses(records, f"{base}/v1/models/cap:predict")
    finally:
        serving.stop("cap")
    assert report["replayed"]["status_mix"] == report["recorded"]["status_mix"] == \
        {"200": 4, "500": 1}
    for rec, (payload, _) in zip(records, TRAFFIC[:4]):
        assert json.loads(seen[rec["seq"]]) == {"predictions": [[2 * payload["instances"][0][0]]]}


def test_lm_capture_replays_with_the_same_responses(tmp_path):
    """Greedy generation over HTTP: the replayed stream answers the
    captured requests token for token."""
    registry.save_lm(TINY, random_params(**TINY, seed=3), "lm")
    serving.create_or_update("lm", model_name="lm", model_server="LM", device="cpu",
                             lm_config={"slots": 2})
    base = f"http://127.0.0.1:{serving.start('lm')['port']}/v1/models/lm:predict"
    rs = np.random.RandomState(1)
    try:
        workload.start_capture(tmp_path / "lm_cap")
        answers = []
        for n, new in ((5, 4), (9, 3), (3, 6)):
            code, body = _post_json(base, {"instances": [
                {"prompt": rs.randint(0, 64, (n,)).tolist(), "max_new_tokens": new}]})
            assert code == 200
            answers.append(body)
        workload.stop_capture()
        records = workload.load_artifact(tmp_path / "lm_cap")["records"]
        report, seen = _replay_responses(records, base)
    finally:
        serving.stop("lm")
    # Under the payload cap a record keeps the body itself.
    assert [len(r["payload"]["instances"][0]["prompt"]) for r in records] == [5, 9, 3]
    assert report["replayed"]["status_mix"] == {"200": 3}
    assert [json.loads(seen[r["seq"]]) for r in records] == answers


def test_packed_capture_replays_as_packed_frames(tmp_path):
    """A packed request to the classifier endpoint is captured as its
    shape summary and replays as a packed frame of that shape, answered
    with packed predictions of the same shape."""
    from hops_tpu_torch.models.convert import params_to_flax
    from hops_tpu_torch.models.mnist import FFN

    model = FFN(dtype="float32", in_features=12, device="cpu", seed=2)
    registry.save_classifier("FFN", {"num_classes": 10, "hidden": 128, "dtype": "float32"},
                             params_to_flax(model), "ffn")
    serving.create_or_update("ffn", model_name="ffn", device="cpu")
    base = f"http://127.0.0.1:{serving.start('ffn')['port']}/v1/models/ffn:predict"
    x = np.random.default_rng(4).standard_normal((3, 12)).astype(np.float32)
    try:
        workload.start_capture(tmp_path / "pk")
        code, body = _send(base, wirecodec.encode_instances(x),
                           {"Content-Type": wirecodec.MEDIA_TYPE})
        assert code == 200
        workload.stop_capture()
        (rec,) = workload.load_artifact(tmp_path / "pk")["records"]
        assert rec["wire_format"] == "packed" and rec["status"] == 200
        report, seen = _replay_responses([rec], base)
    finally:
        serving.stop("ffn")
    assert report["replayed"]["status_mix"] == {"200": 1}
    preds = wirecodec.decode_predictions(seen[rec["seq"]])
    assert preds.shape == (3, 10) and np.isfinite(preds).all()
    with torch.inference_mode():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(json.loads(body)["predictions"]), want, atol=1e-6)


def test_crash_handler_flushes_open_segment_for_postmortem(tmp_path):
    """The JAX package's crash-flush case on the port: an unhandled
    exception in a thread finalizes the active capture segment and
    manifest, and leaves a ``workload_<pid>.json`` pointer next to the
    flight dump, so the crashed run's traffic replays post-mortem."""
    import os
    import threading
    import time
    from pathlib import Path

    from hops_tpu_torch.runtime import flight, rundir

    flight.install_crash_handler()
    workload.start_capture(tmp_path / "crashcap")
    workload.record_request(surface="serving", endpoint="m",
                            payload={"instances": [[1.0]]}, status=200)
    # Before the crash the open segment is not yet manifested: the
    # artifact verifies but replays as empty.
    assert workload.load_artifact(tmp_path / "crashcap")["records"] == []

    def boom():
        raise RuntimeError("chaos: unhandled for workload flush")

    t = threading.Thread(target=boom, name="wl-crash", daemon=True)
    t.start()
    t.join(timeout=10)
    deadline = time.monotonic() + 5
    records: list = []
    while time.monotonic() < deadline and not records:
        records = workload.load_artifact(tmp_path / "crashcap")["records"]
        time.sleep(0.05)
    assert len(records) == 1
    # Capture survives another thread's crash still armed.
    assert workload.capturing()
    pointer = json.loads(
        (Path(rundir.logdir()) / f"workload_{os.getpid()}.json").read_text())
    assert pointer["workload_artifact"] == str(tmp_path / "crashcap")
    assert pointer["flight_dump"].endswith(f"flight_{os.getpid()}.json")
