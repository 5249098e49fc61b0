"""The port's job API (``hops_tpu_torch.jobs``) held to the JAX package's:
every scenario of ``tests/test_jobs.py`` — executions and their states,
exit codes and logs, stop, the newest-first listing, the DAG operators
(fan-out/fan-in, fail-fast skipping, the feature-validation gate, cycles),
dataset staging and the checkpointed streaming runner — runs through
both packages in this process, each in its own workspace (the harness of
``tests/test_torch_fleet.py``), and must give the same outcome. Then a
job and its executions registered by one package are read by the other,
both ways, and a DAG whose job trains a 2-layer LM in a child process
gives JAX's losses.

Every job child here is a plain-Python app that imports no torch, but
the training DAG's, and every wait has a timeout.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import hops_tpu.featurestore as j_hsfs
from hops_tpu import jobs as j_jobs
from hops_tpu.featurestore.validation import Rule as j_Rule
from hops_tpu.jobs import api as j_api
from hops_tpu.jobs import dag as j_dag
from hops_tpu.jobs import dataset as j_dataset
from hops_tpu.jobs import streaming as j_streaming
from hops_tpu.messaging import pubsub as j_pubsub
from hops_tpu.runtime import fs as j_fs

import hops_tpu_torch.featurestore as t_hsfs
from hops_tpu_torch import jobs as t_jobs
from hops_tpu_torch.featurestore.validation import Rule as t_Rule
from hops_tpu_torch.jobs import api as t_api
from hops_tpu_torch.jobs import dag as t_dag
from hops_tpu_torch.jobs import dataset as t_dataset
from hops_tpu_torch.jobs import streaming as t_streaming
from hops_tpu_torch.messaging import pubsub as t_pubsub
from hops_tpu_torch.runtime import config as t_config
from hops_tpu_torch.runtime import fs as t_fs
from test_torch_fleet import in_both

NAMES = {
    "jax": dict(jobs=j_jobs, api=j_api, dag=j_dag, dataset=j_dataset, streaming=j_streaming,
                pubsub=j_pubsub, fs=j_fs, hsfs=j_hsfs, Rule=j_Rule),
    "torch": dict(jobs=t_jobs, api=t_api, dag=t_dag, dataset=t_dataset, streaming=t_streaming,
                  pubsub=t_pubsub, fs=t_fs, hsfs=t_hsfs, Rule=t_Rule),
}
# Bound per run by the harness; these module values only serve linters.
globals().update(NAMES["torch"])
PKG = "hops_tpu_torch"
WAIT_S = 30


@pytest.fixture(autouse=True)
def _fresh_runners(monkeypatch):
    """Each test starts with no named streaming runner in either package
    and leaves none behind: ``create_runner`` hands back a runner of the
    same name, so one left in this worker would capture a later test's
    ``create_runner("fl", ...)`` (``tests/test_compat.py``)."""
    for mod in (j_streaming, t_streaming):
        monkeypatch.setattr(mod, "_runners", {})
    yield
    for mod in (j_streaming, t_streaming):
        for runner in list(mod._runners.values()):
            runner.stop(drain=False)


def _write_app(tmp_path, body: str, name="app.py") -> str:
    p = tmp_path / name
    p.write_text(body)
    return str(p)


def _wait_sink(runner, n: int) -> None:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(runner.read_sink()) < n:
        time.sleep(0.05)


# -- the scenarios of tests/test_jobs.py ---------------------------------------


@in_both
def test_create_start_and_finish(tmp_path):
    app = _write_app(tmp_path, "import sys; print('hello', sys.argv[1:])")
    jobs.create_job("hello", api.JobConfig(app_file=app, default_args=["a", "b"]))
    assert "hello" in jobs.get_jobs()
    ex = jobs.start_job("hello")
    done = jobs.wait_for_completion("hello", ex.execution_id, timeout_s=WAIT_S)
    assert done.state == "FINISHED" and done.exit_code == 0
    assert "hello ['a', 'b']" in done.stdout()
    return {"jobs": jobs.get_jobs(), "state": done.state, "exit_code": done.exit_code,
            "args": done.args, "stdout": done.stdout()}


@in_both
def test_job_sibling_import_and_main_semantics(tmp_path):
    """The bootstrap must preserve `python app.py` semantics: the app
    dir on sys.path (sibling imports) and __name__ == "__main__"."""
    (tmp_path / "sibling.py").write_text("VALUE = 41\n")
    app = _write_app(
        tmp_path,
        "import sibling\n"
        "if __name__ == '__main__':\n"
        "    print('got', sibling.VALUE + 1)\n",
    )
    jobs.create_job("sib", api.JobConfig(app_file=app))
    ex = jobs.start_job("sib")
    done = jobs.wait_for_completion("sib", ex.execution_id, timeout_s=WAIT_S)
    assert done.state == "FINISHED", done.stdout()
    assert "got 42" in done.stdout()
    return {"state": done.state, "stdout": done.stdout()}


@in_both
def test_failing_job_marked_failed(tmp_path):
    app = _write_app(tmp_path, "raise SystemExit(3)")
    jobs.create_job("boom", api.JobConfig(app_file=app))
    ex = jobs.start_job("boom")
    done = jobs.wait_for_completion("boom", ex.execution_id, timeout_s=WAIT_S)
    assert done.state == "FAILED" and done.exit_code == 3
    return {"state": done.state, "exit_code": done.exit_code, "final": done.final}


@in_both
def test_stop_job_kills_running_execution(tmp_path):
    app = _write_app(tmp_path, "import time; time.sleep(60)")
    jobs.create_job("sleeper", api.JobConfig(app_file=app))
    ex = jobs.start_job("sleeper")
    time.sleep(0.3)
    t0 = time.monotonic()
    jobs.stop_job("sleeper")
    done = jobs.wait_for_completion("sleeper", ex.execution_id, timeout_s=WAIT_S)
    assert done.state == "KILLED"
    assert time.monotonic() - t0 < 10
    return {"state": done.state, "signalled": done.exit_code < 0}


class _ReapAfterStop:
    """A stand-in for the port's ``_procs_lock`` that keeps the reaper
    thread out until ``stop_job`` has written its verdict: the ordering
    in which the KILLED record is written first."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stopped = threading.Event()

    def __enter__(self):
        if threading.current_thread().name.startswith("job-reap-"):
            assert self.stopped.wait(WAIT_S), "stop_job never let the reaper in"
        self._lock.acquire()

    def __exit__(self, *exc):
        self._lock.release()


def test_stop_job_record_carries_the_exit_code_before_the_reaper(tmp_path, monkeypatch):
    """The port alone: when ``stop_job`` takes the lock before the
    reaper, the final KILLED record it writes already holds the signal's
    exit code, and the reaper leaves both as they are."""
    monkeypatch.setattr(t_config, "_current", t_config.runtime())
    t_config.configure(workspace=str(tmp_path / "ws"), project="testproj")
    gate = _ReapAfterStop()
    monkeypatch.setattr(t_api, "_procs_lock", gate)
    app = _write_app(tmp_path, "import time; time.sleep(60)")
    t_jobs.create_job("sleeper", t_api.JobConfig(app_file=app))
    ex = t_jobs.start_job("sleeper")
    time.sleep(0.3)
    t_jobs.stop_job("sleeper")
    first = t_api.get_execution("sleeper", ex.execution_id)
    assert first.final and first.state == "KILLED"
    assert first.exit_code is not None and first.exit_code < 0
    gate.stopped.set()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and f"sleeper/{ex.execution_id}" in t_api._procs:
        time.sleep(0.05)
    assert f"sleeper/{ex.execution_id}" not in t_api._procs, "the reaper never ran"
    last = t_api.get_execution("sleeper", ex.execution_id)
    assert (last.state, last.exit_code) == ("KILLED", first.exit_code)


@in_both
def test_executions_newest_first(tmp_path):
    app = _write_app(tmp_path, "print('ok')")
    jobs.create_job("multi", api.JobConfig(app_file=app))
    e1 = jobs.start_job("multi")
    jobs.wait_for_completion("multi", e1.execution_id, timeout_s=WAIT_S)
    time.sleep(0.01)
    e2 = jobs.start_job("multi")
    jobs.wait_for_completion("multi", e2.execution_id, timeout_s=WAIT_S)
    exs = jobs.get_executions("multi")
    assert [e.execution_id for e in exs] == [e2.execution_id, e1.execution_id]
    return [(e.state, e.exit_code) for e in exs]


@in_both
def test_dag_fan_out_fan_in(tmp_path):
    """The launch_jobs.py shape: task0 >> [task1, task2] >> sensor >> task3."""
    app = _write_app(tmp_path, "print('ok')")
    for name in ("j0", "j1", "j2", "j3"):
        jobs.create_job(name, api.JobConfig(app_file=app))
    with dag.DAG("pipeline") as d:
        t0 = dag.JobLaunchOperator("t0", "j0", dag=d)
        t1 = dag.JobLaunchOperator("t1", "j1", dag=d)
        t2 = dag.JobLaunchOperator("t2", "j2", dag=d)
        sensor = dag.JobSuccessSensor("sense", "j2", timeout_s=WAIT_S, dag=d)
        t3 = dag.JobLaunchOperator("t3", "j3", dag=d)
        t0 >> [t1, t2]
        [t1, t2] >> sensor
        sensor >> t3
    ctx = d.run()
    assert all(t.state == "SUCCESS" for t in d.tasks)
    assert "t3" in ctx
    return {"states": [(t.task_id, t.state) for t in d.tasks], "context": sorted(ctx),
            "upstream": [(t.task_id, [u.task_id for u in t.upstream]) for t in d.tasks]}


@in_both
def test_dag_failure_skips_downstream(tmp_path):
    ok = _write_app(tmp_path, "print('ok')", "ok.py")
    bad = _write_app(tmp_path, "raise SystemExit(1)", "bad.py")
    jobs.create_job("okj", api.JobConfig(app_file=ok))
    jobs.create_job("badj", api.JobConfig(app_file=bad))
    with dag.DAG("failing") as d:
        a = dag.JobLaunchOperator("a", "badj", dag=d)
        b = dag.JobLaunchOperator("b", "okj", dag=d)
        a >> b
    with pytest.raises(RuntimeError) as e:
        d.run()
    assert d.tasks[0].state == "FAILED" and d.tasks[1].state == "SKIPPED"
    return {"states": [t.state for t in d.tasks], "error": str(e.value).split(" execution ")[0],
            "okj_runs": len(jobs.get_executions("okj"))}


@in_both
def test_feature_validation_gate():
    import pandas as pd

    store = hsfs.connection().get_feature_store()
    exp = store.create_expectation(
        "nonneg", features=["x"], rules=[Rule(name="HAS_MIN", level="ERROR", min=0)]
    ).save()
    fg = store.create_feature_group(
        "gated", version=1, primary_key=["id"], expectations=[exp], validation_type="ALL"
    )
    fg.save(pd.DataFrame({"id": [1, 2], "x": [1.0, 2.0]}))
    with dag.DAG("gate") as d:
        dag.FeatureValidationResult("check", "gated", dag=d)
    ctx = d.run()
    assert ctx["check"]["status"] in ("SUCCESS", "WARNING")
    return {"status": ctx["check"]["status"], "state": d.tasks[0].state}


@in_both
def test_dataset_upload_roundtrip(tmp_path):
    import zipfile

    src = tmp_path / "payload"
    src.mkdir()
    (src / "code.py").write_text("print(1)")
    (src / "util.py").write_text("x = 2")
    staged = dataset.upload_workspace(src, "Resources")
    assert Path(staged).exists()
    out = dataset.extract(staged, tmp_path / "out")
    assert (Path(out) / "code.py").read_text() == "print(1)"
    single = dataset.upload(src / "code.py", "Resources")
    assert Path(single).read_text() == "print(1)"
    with zipfile.ZipFile(staged) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    return {"staged": Path(staged).relative_to(fs.workspace_root()).as_posix(),
            "members": members,
            "extracted": {p.name: p.read_bytes() for p in sorted(Path(out).iterdir())},
            "single": Path(single).read_bytes()}


@in_both
def test_streaming_runner_checkpointed_sink():
    pubsub.create_topic("events")
    prod = pubsub.Producer("events")
    for i in range(5):
        prod.send({"i": i, "v": i * 2.0})
    prod.flush()
    runner = streaming.create_runner("sink1", "events", poll_interval_s=0.02)
    streaming.start_runner("sink1")
    _wait_sink(runner, 5)
    streaming.stop_runner("sink1")
    df = runner.read_sink()
    assert len(df) == 5 and sorted(df["i"]) == [0, 1, 2, 3, 4]

    # Restart resumes from the checkpoint, not the beginning.
    for i in range(5, 8):
        prod.send({"i": i, "v": i * 2.0})
    prod.flush()
    runner2 = streaming.StreamingRunner("sink1", "events", sink_dir=str(runner.sink_dir),
                                        poll_interval_s=0.02)
    runner2.start()
    _wait_sink(runner2, 8)
    runner2.stop()
    df = runner2.read_sink()
    assert len(df) == 8, "restart must not duplicate or drop records"
    ck = json.loads((runner2.sink_dir / "_checkpoint.json").read_text())
    # Offsets are bytes of the topic log, whose records carry timestamps:
    # each package's own log end is what its checkpoint must hold.
    end = pubsub.Consumer("events", group="probe", from_beginning=True).end_offset()
    return {"rows": df.sort_values("i").to_dict("list"), "dtypes": df.dtypes.astype(str).to_dict(),
            "offset_at_end": ck["offset"] == end, "next_part": ck["next_part"] >= 2,
            "state": runner2.state}


@in_both
def test_dag_cycle_raises():
    with dag.DAG("cyclic") as d:
        a = dag.PythonOperator("a", lambda: 1, dag=d)
        b = dag.PythonOperator("b", lambda: 2, dag=d)
        a >> b
        b >> a
    with pytest.raises(RuntimeError, match="unsatisfiable") as e:
        d.run()
    return str(e.value)


@in_both
def test_create_runner_topic_conflict_raises():
    pubsub.create_topic("t_a")
    pubsub.create_topic("t_b")
    streaming.create_runner("conflict_r", "t_a")
    with pytest.raises(ValueError, match="already consumes") as e:
        streaming.create_runner("conflict_r", "t_b")
    return str(e.value)


@in_both
def test_producer_each_send_reaches_the_log():
    """Each record is in the topic log when ``send`` returns, and two
    producers on one topic append whole lines in the order sent."""
    pubsub.create_topic("interleave")
    a, b = pubsub.Producer("interleave"), pubsub.Producer("interleave")
    consumer = pubsub.Consumer("interleave", group="g", from_beginning=True)
    seen = []
    for i in range(6):
        (a if i % 2 else b).send({"i": i, "text": "é" * i}, key=f"k{i}")
        seen.append([(r["key"], r["value"]) for r in consumer.poll()])
    return seen


# -- the on-disk layout: one package registers, the other reads ----------------


@pytest.fixture
def shared(workspace, monkeypatch):
    """Both packages pointed at the JAX package's workspace."""
    monkeypatch.setattr(t_config, "_current", t_config.runtime())
    t_config.configure(workspace=str(workspace), project="testproj")
    return workspace


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_job_registered_by_one_package_reads_in_the_other(writer, shared, tmp_path):
    w, r = NAMES[writer], NAMES["torch" if writer == "jax" else "jax"]
    app = _write_app(tmp_path, "import sys; print('ran', sys.argv[1:]); raise SystemExit(2)")
    w["jobs"].create_job("shared", {"app_file": app, "default_args": ["x"],
                                    "env": {"K": "v"}, "chips": 2})
    ex = w["jobs"].start_job("shared")
    w["jobs"].wait_for_completion("shared", ex.execution_id, timeout_s=WAIT_S)
    assert r["jobs"].get_jobs() == ["shared"]
    job = r["jobs"].get_job("shared")
    assert (job.config.app_file, job.config.default_args, job.config.env, job.config.chips,
            job.config.job_type) == (app, ["x"], {"K": "v"}, 2, "PYTHON")
    [got] = r["jobs"].get_executions("shared")
    assert (got.execution_id, got.state, got.exit_code, got.args) == \
        (ex.execution_id, "FAILED", 2, ["x"])
    assert got.stdout() == "ran ['x']\n"
    # The reader starts the next execution of the same job; the writer
    # lists both, newest first.
    ex2 = r["jobs"].start_job("shared", ["y"])
    r["jobs"].wait_for_completion("shared", ex2.execution_id, timeout_s=WAIT_S)
    assert [e.execution_id for e in w["jobs"].get_executions("shared")] == \
        [ex2.execution_id, ex.execution_id]
    assert w["api"].get_execution("shared", ex2.execution_id).stdout() == "ran ['y']\n"


# -- a DAG whose job trains the LM ---------------------------------------------

LM = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2, max_decode_len=16)
LM_SEQ = 12
LM_STEPS = 3
LM_LR = 0.05
TOL = dict(rtol=1e-4, atol=1e-5)

# The job's app: 3 SGD-with-momentum steps of the 2-layer LM from the
# weights in argv[1] on the batch in argv[2], through the compat
# ``experiment.launch``; the losses go to argv[3]. The same program in
# each package (Adam's ``sqrt(v) + eps`` turns last-bit gradient
# differences into weight differences up to lr; SGD does not).
TRAIN_APP = {
    "jax": """\
import json, sys
import numpy as np
import jax, jax.numpy as jnp, optax
from hops_tpu.compat import experiment
from hops_tpu.models import common
from hops_tpu.models.transformer import TransformerLM, make_lm_train_step

LM, STEPS, LR = {lm!r}, {steps}, {lr}

def nest(flat):
    tree = {{}}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = jnp.asarray(v)
    return tree

def train():
    params = nest(dict(np.load(sys.argv[1])))
    tokens = np.load(sys.argv[2])
    model = TransformerLM(**LM, dtype=jnp.float32)
    state = common.TrainState.create(apply_fn=model.apply, params=params,
                                     tx=optax.sgd(LR, momentum=0.9), rng=jax.random.PRNGKey(1))
    step = jax.jit(make_lm_train_step())
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, {{"tokens": tokens}})
        losses.append(float(metrics["loss"]))
    return {{"loss": losses[-1], "losses": losses}}

_, metrics = experiment.launch(train, name="dag-lm", metric_key="loss")
open(sys.argv[3], "w").write(json.dumps(metrics["losses"]))
""",
    "torch": """\
import json, sys
import numpy as np
import torch
from hops_tpu_torch.compat import experiment
from hops_tpu_torch.models.common import TrainState
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step

LM, STEPS, LR = {lm!r}, {steps}, {lr}

def train():
    torch.set_num_threads(1)
    flat = dict(np.load(sys.argv[1]))
    model = TransformerLM(**LM, dtype="float32", device="cpu").load_flax(flat)
    state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=LR,
                                                              momentum=0.9))
    step = make_lm_train_step()
    batch = {{"tokens": torch.from_numpy(np.load(sys.argv[2])).long()}}
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return {{"loss": losses[-1], "losses": losses}}

_, metrics = experiment.launch(train, name="dag-lm", metric_key="loss")
open(sys.argv[3], "w").write(json.dumps(metrics["losses"]))
""",
}


def _train_dag(pkg: str, tmp_path: Path, weights: Path, tokens: Path) -> dict:
    """``train >> sensor >> gate >> read`` in ``pkg``: the train job runs
    the LM app in a child process."""
    n = NAMES[pkg]
    d = tmp_path / pkg
    d.mkdir()
    app = d / "train_lm.py"
    app.write_text(TRAIN_APP[pkg].format(lm=LM, steps=LM_STEPS, lr=LM_LR))
    out = d / "losses.json"
    n["jobs"].create_job("train-lm", {"app_file": str(app),
                                      "default_args": [str(weights), str(tokens), str(out)],
                                      "env": {"OMP_NUM_THREADS": "1"}})
    import pandas as pd

    store = n["hsfs"].connection().get_feature_store()
    exp = store.create_expectation(
        "finite", features=["loss"], rules=[n["Rule"](name="HAS_MIN", level="ERROR", min=0)]
    ).save()
    with n["dag"].DAG("train-then-read") as g:
        train = n["dag"].JobLaunchOperator("train", "train-lm", timeout_s=240, dag=g)
        sensor = n["dag"].JobSuccessSensor("sensor", "train-lm", timeout_s=WAIT_S, dag=g)

        def record():
            fg = store.create_feature_group("lm_losses", version=1, primary_key=["step"],
                                            expectations=[exp], validation_type="ALL")
            losses = json.loads(out.read_text())
            fg.save(pd.DataFrame({"step": range(len(losses)), "loss": losses}))
            return losses

        rec = n["dag"].PythonOperator("record", record, dag=g)
        gate = n["dag"].FeatureValidationResult("gate", "lm_losses", dag=g)
        train >> sensor >> rec >> gate
    try:
        ctx = g.run()
    except Exception:
        [ex] = n["jobs"].get_executions("train-lm")
        raise AssertionError(f"{pkg} DAG failed; the job's log:\n{ex.stdout()[-4000:]}")
    return {"losses": ctx["record"], "states": [t.state for t in g.tasks],
            "gate": ctx["gate"]["status"]}


def test_a_dag_trains_the_lm_as_in_jax(tmp_path, request):
    """A DAG whose job trains the 2-layer LM (d_model 32, fp32) in a child
    process of each package, from the same weights and batch: the losses
    at ``rtol 1e-4, atol 1e-5``, the same task states and gate verdict."""
    import jax
    import jax.numpy as jnp

    from hops_tpu.models import common as jax_common
    from hops_tpu.models.transformer import TransformerLM as JaxLM
    from hops_tpu_torch.models import convert
    from test_torch_fleet import _use_workspace

    params = jax.device_get(jax_common.create_train_state(
        JaxLM(**LM, dtype=jnp.float32), jax.random.PRNGKey(0), (1, 8),
        input_dtype=jnp.int32).params)
    weights, tokens = tmp_path / "weights.npz", tmp_path / "tokens.npy"
    np.savez(weights, **{k: np.asarray(v) for k, v in convert.flatten(params).items()})
    np.save(tokens, np.random.default_rng(0).integers(
        0, LM["vocab_size"], (4, LM_SEQ + 1)).astype(np.int32))
    got = {}
    for pkg in ("jax", "torch"):
        _use_workspace(pkg, request)
        got[pkg] = _train_dag(pkg, tmp_path, weights, tokens)
    ref, out = got["jax"], got["torch"]
    assert len(ref["losses"]) == len(out["losses"]) == LM_STEPS
    np.testing.assert_allclose(out["losses"], ref["losses"], **TOL)
    assert ref["losses"][-1] < ref["losses"][0]
    assert out["states"] == ref["states"] == ["SUCCESS"] * 4
    assert out["gate"] == ref["gate"]


def test_the_job_child_imports_neither_torch_nor_the_port(tmp_path, request):
    """The port's execution bootstrap starts a plain-Python app without
    importing torch or ``hops_tpu_torch`` (a job child is an interpreter's
    start-up, not torch's)."""
    from test_torch_fleet import _use_workspace

    _use_workspace("torch", request)
    app = _write_app(tmp_path, "import os, sys\n"
                               "print(sorted(m for m in ('torch', 'hops_tpu_torch', 'jax')\n"
                               "             if m in sys.modules))\n"
                               "print([os.environ[k] for k in ('HOPS_TPU_WORKSPACE',\n"
                               "       'HOPS_TPU_PROJECT', 'HOPS_TPU_JOB_NAME')])\n"
                               "print(os.environ['HOPS_TPU_EXECUTION_ID'])\n")
    t_jobs.create_job("bare", {"app_file": app})
    ex = t_jobs.start_job("bare")
    done = t_jobs.wait_for_completion("bare", ex.execution_id, timeout_s=WAIT_S)
    assert done.state == "FINISHED", done.stdout()
    assert done.stdout().splitlines() == [
        "[]", str([str(t_fs.workspace_root()), "testproj", "bare"]), ex.execution_id]


def test_port_producer_keeps_one_log_open_until_close(shared):
    """The port's producer opens its topic log at the first send and
    keeps it; ``close`` releases it, and a later send opens it again."""
    prod = t_pubsub.Producer("held")
    prod.send({"i": 0})
    log = prod._f
    prod.send({"i": 1})
    assert prod._f is log and not log.closed
    prod.close()
    assert log.closed and prod._f is None
    prod.close()  # a second close is a no-op
    prod.send({"i": 2})
    prod.close()
    recs = t_pubsub.Consumer("held", group="g", from_beginning=True).poll()
    assert [r["value"]["i"] for r in recs] == [0, 1, 2]
