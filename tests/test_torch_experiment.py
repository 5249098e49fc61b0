"""The port's experiment launcher, on the CPU.

The launch cases of ``tests/test_experiment.py`` against
``hops_tpu_torch.experiment``, the launcher's metrics, a CUDA-free
wrapper that stays CUDA-free, and cross-package parity: one
framework-free wrapper launched by ``hops_tpu.experiment.launch`` and by
the port's, each under its own project root, leaves the same registry
records (but ``run_id``, ``time``, ``duration_s`` and ``path``), the
same files in the run directory and the same ``output.log``.
The
distributed launchers' cases (``TestDistributedLaunchers``) run in one
process and, through ``python -m hops_tpu_torch.launch --platform cpu``,
in two gloo ranks that write into one session directory.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hops_tpu import experiment as jax_experiment
from hops_tpu.experiment import tensorboard as jax_tensorboard
from hops_tpu.runtime import config as jax_config
from hops_tpu_torch import experiment
from hops_tpu_torch.experiment import registry, tensorboard
from hops_tpu_torch.parallel import ParameterServerStrategy, get_strategy, multihost
from hops_tpu_torch.runtime import config
from hops_tpu_torch.runtime.logging import read_metrics
from hops_tpu_torch.telemetry.metrics import REGISTRY


@pytest.fixture(autouse=True)
def port_workspace(tmp_path):
    """The port's own workspace, as tests/conftest.py gives the JAX
    package its own."""
    before = config.runtime()
    config.configure(workspace=str(tmp_path / "port_ws"), project="testproj")
    yield tmp_path / "port_ws"
    config.configure(workspace=before.workspace, project=before.project)


@pytest.fixture
def cpu_process():
    """This process's device is the CPU (as ``launch --platform cpu``
    makes it); forgotten again after the test."""
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


def test_launch_returns_path_and_metrics():
    def train_fn():
        print("hello from wrapper")
        tensorboard.scalar(0, "loss", 1.0)
        return {"accuracy": 0.92}

    path, metrics = experiment.launch(train_fn, name="mnist", metric_key="accuracy")
    assert "Experiments" in path and "port_ws" in path
    assert metrics["accuracy"] == 0.92
    assert metrics["metric"] == 0.92
    assert "hello from wrapper" in Path(metrics["log"]).read_text()
    events = (Path(path) / "metrics.jsonl").read_text()
    assert json.loads(events.splitlines()[0])["tag"] == "loss"


def test_launch_with_args():
    def train_fn(lr, steps):
        return {"lr_used": lr, "steps": steps}

    _, metrics = experiment.launch(train_fn, args={"lr": 0.1, "steps": 5})
    assert metrics["lr_used"] == 0.1


def test_scalar_return_becomes_metric():
    _, metrics = experiment.launch(lambda: 0.5)
    assert metrics["metric"] == 0.5


def test_registry_records_run():
    experiment.launch(lambda: {"m": 1.0}, name="reg-test", metric_key="m")
    runs = registry.list_runs("reg-test")
    assert len(runs) == 1
    assert runs[0]["status"] == "FINISHED"
    assert runs[0]["metrics"]["m"] == 1.0


def test_failure_registered_and_reraised():
    def bad():
        print("about to fail")
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        experiment.launch(bad, name="fail-test")
    runs = registry.list_runs("fail-test")
    assert runs[0]["status"] == "FAILED"
    log = (Path(runs[0]["path"]) / "output.log").read_text()
    assert "about to fail" in log and "RuntimeError: boom" in log


def test_best_run():
    experiment.launch(lambda: {"acc": 0.5}, name="best", metric_key="acc")
    experiment.launch(lambda: {"acc": 0.9}, name="best", metric_key="acc")
    best = registry.best_run("best", metric="acc")
    assert best["metrics"]["acc"] == 0.9
    worst = registry.best_run("best", metric="acc", direction="min")
    assert worst["metrics"]["acc"] == 0.5


def test_scalars_land_in_metrics_jsonl():
    def train_fn():
        for step in range(3):
            tensorboard.scalar(step, "loss", 1.0 / (step + 1))
            tensorboard.scalar(step, "acc", torch.tensor(0.25 * step))
        return None

    path, metrics = experiment.launch(train_fn, name="scalars")
    assert metrics["metric"] is None
    events = read_metrics(Path(path) / "metrics.jsonl")
    assert [(e["step"], e["tag"]) for e in events] == [
        (s, t) for s in range(3) for t in ("loss", "acc")]
    assert events[-1]["value"] == 0.5


def test_launcher_metrics_count_runs_and_time_them():
    runs = REGISTRY.counter("hops_tpu_experiment_runs_total", labels=("kind", "status"))
    fin0, fail0 = runs.value(kind="launch", status="FINISHED"), runs.value(
        kind="launch", status="FAILED")
    hist = REGISTRY.get("hops_tpu_experiment_duration_seconds")
    count0 = _hist_count(hist)
    experiment.launch(lambda: 1.0)
    with pytest.raises(ValueError):
        experiment.launch(lambda: (_ for _ in ()).throw(ValueError("x")))
    assert runs.value(kind="launch", status="FINISHED") == fin0 + 1
    assert runs.value(kind="launch", status="FAILED") == fail0 + 1
    hist = REGISTRY.get("hops_tpu_experiment_duration_seconds")
    assert _hist_count(hist) == count0 + 2


def _hist_count(hist):
    if hist is None:
        return 0
    return sum(v for name, labels, v in hist.samples()
               if name.endswith("_count") and labels.get("kind") == "launch")


def test_a_wrapper_that_never_touches_the_card_does_not_initialize_cuda():
    experiment.launch(lambda: {"m": 1.0})
    assert not torch.cuda.is_initialized()


def test_profile_writes_a_trace_into_the_run_dir():
    def train_fn():
        with tensorboard.profile("trace"):
            torch.ones(8, 8).sum()
        return None

    path, _ = experiment.launch(train_fn)
    traces = list((Path(path) / "trace").glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize("kind", ["mirrored", "collective_all_reduce", "parameter_server"])
def test_distributed_launchers_are_a_later_slice(kind, cpu_process):
    """The launchers run since the distribution layer was ported, and
    since the gradient-communication slice their ``grad_comms`` /
    ``update_sharding`` arguments reach the strategy the wrapper sees."""
    from hops_tpu_torch.parallel.grad_comms import GradCommsConfig

    _, metrics = getattr(experiment, kind)(lambda: {"ok": 1.0}, name=kind)
    assert metrics["ok"] == 1.0
    cfg = GradCommsConfig(quantize=True)
    args, want = {"mirrored": (dict(grad_comms=cfg), "quantized"),
                  "collective_all_reduce": (dict(grad_comms=cfg, update_sharding="cross_replica"),
                                            "quantized+zero1"),
                  "parameter_server": (None, "quantized")}[kind]
    if args is None:
        assert ParameterServerStrategy(grad_comms=cfg).grad_comms.mode == want
    else:
        _, got = getattr(experiment, kind)(lambda: {"mode": get_strategy().grad_comms.mode},
                                           name=kind, **args)
        assert got["mode"] == want


class TestDistributedLaunchers:
    """``tests/test_experiment.py``'s cases on the port, in one process
    (one rank)."""

    def test_mirrored_exposes_strategy(self, cpu_process):
        def train_fn():
            s = get_strategy()
            return {"replicas": s.num_replicas_in_sync}

        _, metrics = experiment.mirrored(train_fn, name="mir")
        assert metrics["replicas"] == 1
        assert registry.list_runs("mir")[0]["kind"] == "mirrored"

    def test_collective_all_reduce_trains(self, cpu_process):
        """End-to-end: data-parallel training of a tiny linear model
        inside the launcher."""

        def train_fn():
            s = get_strategy()
            w = s.replicate(torch.zeros(4))
            rs = np.random.RandomState(0)
            x = rs.randn(64, 4).astype("float32")
            y = x @ np.array([1.0, -2.0, 3.0, 0.5], "float32")

            def step(w, batch):
                loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
                (g,) = torch.autograd.grad(loss, w)
                return w - 0.1 * g, {"loss": loss.detach()}

            compiled = s.step(step, donate_state=False)
            for _ in range(100):
                w, m = compiled(w, s.distribute_batch({"x": x, "y": y}))
            return {"final_loss": float(m["loss"])}

        _, metrics = experiment.collective_all_reduce(train_fn, name="car")
        assert metrics["final_loss"] < 1e-3

    def test_parameter_server_alias(self, cpu_process):
        _, metrics = experiment.parameter_server(lambda: {"ok": 1.0}, name="ps")
        assert metrics["ok"] == 1.0
        assert registry.list_runs("ps")[0]["kind"] == "collective_all_reduce"


WORKER = """
import json, sys
from hops_tpu_torch import experiment
from hops_tpu_torch.parallel import current_strategy, multihost
from hops_tpu_torch.runtime import config, rundir

config.configure(workspace=sys.argv[1], project="testproj")


def train_fn():
    s = current_strategy()
    rundir.logdir()
    open(f"rank{multihost.process_index()}.txt", "w").write("hi")
    return {"replicas": s.num_replicas_in_sync, "procs": multihost.process_count()}


path, metrics = experiment.collective_all_reduce(train_fn, name="mh_integration")
print("WORKER_OK", json.dumps({"path": path, "replicas": metrics["replicas"],
                               "procs": metrics["procs"], "session": rundir.session_id()}),
      flush=True)
"""


def test_two_processes_write_one_session_directory(tmp_path):
    """Two ranks through ``python -m hops_tpu_torch.launch --platform cpu``
    run ``experiment.collective_all_reduce`` (as
    ``tests/test_multihost_integration.py`` does for the JAX package):
    they agree on the session, write into one run directory, and rank 0
    alone registers the run."""
    import os
    import socket
    import subprocess
    import sys

    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hops_tpu_torch.launch", "--platform", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), str(worker), str(tmp_path / "ws")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(root),
    ) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in out, f"rank {i}:\n{out[-3000:]}"
    got = [json.loads(out.split("WORKER_OK", 1)[1].splitlines()[0]) for out in outs]
    assert {g["replicas"] for g in got} == {g["procs"] for g in got} == {2}
    assert len({g["session"] for g in got}) == 1
    (path,) = {g["path"] for g in got}
    assert (Path(path) / "rank0.txt").is_file() and (Path(path) / "rank1.txt").is_file()
    index = tmp_path / "ws" / "testproj" / "Experiments" / "index.jsonl"
    recs = [json.loads(line) for line in index.read_text().splitlines() if line.strip()]
    assert [r["status"] for r in recs] == ["RUNNING", "FINISHED"]
    assert recs[-1]["num_replicas"] == 2


def _wrapper(tb):
    def train_fn(steps):
        for step in range(steps):
            print(f"step {step} loss {1.0 / (step + 1):.4f}")
            tb.scalar(step, "loss", 1.0 / (step + 1))
        return {"loss": 1.0 / steps, "steps": steps}

    return train_fn


def _records(index: Path):
    drop = {"run_id", "time", "duration_s", "path"}
    return [{k: v for k, v in json.loads(line).items() if k not in drop}
            for line in index.read_text().splitlines() if line.strip()]


def _files(run: Path):
    return sorted(p.relative_to(run).as_posix() for p in run.rglob("*"))


@pytest.mark.parametrize("fail", [False, True], ids=["finished", "failed"])
def test_launch_matches_the_jax_package(tmp_path, fail):
    jax_config.configure(workspace=str(tmp_path / "jax_ws"), project="parity")
    config.configure(workspace=str(tmp_path / "port_ws"), project="parity")
    out = {}
    for name, launch, tb in (("jax", jax_experiment.launch, jax_tensorboard),
                             ("port", experiment.launch, tensorboard)):
        fn = _wrapper(tb)
        if fail:
            def fn(steps, _inner=fn):
                _inner(steps)
                raise KeyError("no such column")
        try:
            path, metrics = launch(fn, args={"steps": 3}, name="parity", metric_key="loss")
        except KeyError:
            path = None
        index = tmp_path / f"{name}_ws" / "parity" / "Experiments" / "index.jsonl"
        recs = _records(index)
        run = Path(json.loads(index.read_text().splitlines()[-1])["path"])
        log = (run / "output.log").read_text()
        if not fail:
            assert path == str(run) and metrics["metric"] == pytest.approx(1 / 3)
        out[name] = recs, _files(run), log
    assert out["port"][0] == out["jax"][0]
    assert [r["status"] for r in out["port"][0]] == ["RUNNING", "FAILED" if fail else "FINISHED"]
    assert out["port"][1] == out["jax"][1]
    if fail:
        # The traceback names each package's own launcher file.
        out = {k: (r, f, log.split("Traceback")[0]) for k, (r, f, log) in out.items()}
    assert out["port"][2] == out["jax"][2]
    assert "step 2 loss 0.3333" in out["port"][2]
