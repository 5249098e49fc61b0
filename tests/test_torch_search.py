"""The port's hyperparameter search (``hops_tpu_torch.search``) against
the JAX package's, on the CPU.

One pure-Python wrapper runs under both packages' ``grid_search``,
``differential_evolution`` and ``lagom`` (random search and ASHA) with
``max_parallel=1``: the summaries must be identical (trial ids, params,
metrics, best config and metric, early stops). Then ``grid_search`` over
two learning rates trains a 2-layer TransformerLM in each package, JAX's
weights loaded into the port, each package's own ``DataLoader`` reading
one RecordIO file with one seed: per-trial losses within the train
step's tolerance, ``rtol 1e-4, atol 1e-5``. The cases of
``tests/test_search.py`` (and the search cases of ``tests/test_chaos.py``)
run on the port, trials on explicit CPU devices — the counterpart of the
fake 8-device mesh the JAX tests run on.
"""

from __future__ import annotations

import json
import random
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hops_tpu.featurestore.feed import pack_documents as jax_pack_documents
from hops_tpu.featurestore.loader import DataLoader as JaxDataLoader
from hops_tpu.featurestore.loader import RecordIOSource as JaxRecordIOSource
from hops_tpu.models import common as jax_common
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.models.transformer import make_lm_train_step as jax_train_step
from hops_tpu.native.recordio import RecordWriter as JaxRecordWriter
from hops_tpu.search import Searchspace as JaxSearchspace
from hops_tpu.search import drivers as jax_drivers
from hops_tpu_torch import experiment
from hops_tpu_torch.experiment import registry
from hops_tpu_torch.featurestore.loader import DataLoader, RecordIOSource
from hops_tpu_torch.messaging.rpc import RpcClient, RpcServer
from hops_tpu_torch.models.common import create_train_state
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
from hops_tpu_torch.runtime import config, devices, faultinject
from hops_tpu_torch.runtime.resilience import RetryPolicy
from hops_tpu_torch.search import (
    ASHA,
    AblationStudy,
    DifferentialEvolution,
    GridSearch,
    MedianEarlyStopper,
    Searchspace,
    differential_evolution,
    grid_search,
    lagom,
)
from hops_tpu_torch.search.ablation import LOCOAblator
from hops_tpu_torch.search.optimizers import TrialResult

CPUS = [torch.device("cpu")] * 8  # the counterpart of the fake 8-device mesh
TOL = dict(rtol=1e-4, atol=1e-5)  # the LM train step's (tests/test_torch_train.py)


@pytest.fixture(autouse=True)
def port_workspace(tmp_path):
    """The port's own workspace, as tests/conftest.py gives the JAX
    package its own."""
    before = config.runtime()
    config.configure(workspace=str(tmp_path / "port_ws"), project="testproj")
    yield tmp_path / "port_ws"
    config.configure(workspace=before.workspace, project=before.project)


@pytest.fixture
def disarm():
    yield
    faultinject.disarm()


# -- the same wrapper under both packages ------------------------------------------


def _trials(summary: dict) -> dict:
    return {tid: (t["params"], t["metric"], t["stopped_early"])
            for tid, t in summary["trials"].items()}


def _same_summary(port: dict, ref: dict) -> None:
    for key in ("num_trials", "best_id", "best_config", "best_metric", "early_stopped",
                "direction"):
        assert port[key] == ref[key], key
    assert _trials(port) == _trials(ref)


def _quadratic(x, width):
    return {"loss": (x - 0.3) ** 2 + 0.1 * width}


def test_grid_search_summary_matches_jax():
    grid = {"x": [0.1, 0.25, 0.5, 0.9], "width": [1, 2, 3]}
    _, ref = jax_drivers.grid_search(_quadratic, grid, direction="min",
                                     optimization_key="loss", max_parallel=1)
    _, got = grid_search(_quadratic, grid, direction="min", optimization_key="loss",
                         max_parallel=1, devices=CPUS)
    _same_summary(got, ref)
    assert got["num_trials"] == 12 and got["best_config"] == {"x": 0.25, "width": 1}


def test_differential_evolution_summary_matches_jax():
    bounds = {"x": [-2.0, 2.0], "width": [1, 4]}
    _, ref = jax_drivers.differential_evolution(
        _quadratic, bounds, generations=4, population=5, direction="min",
        optimization_key="loss", max_parallel=1)
    _, got = differential_evolution(
        _quadratic, bounds, generations=4, population=5, direction="min",
        optimization_key="loss", max_parallel=1, devices=CPUS)
    _same_summary(got, ref)
    assert got["num_trials"] == 20


@pytest.mark.parametrize("optimizer,num_trials", [("randomsearch", 8), ("asha", 9)])
def test_lagom_summary_matches_jax(optimizer, num_trials):
    def train_fn(lr, dropout, reporter, budget=1):
        for step in range(3):
            reporter.broadcast(metric=lr * (step + 1) - dropout, step=step)
        return lr * 3 * budget - dropout

    spaces = [cls(lr=("DOUBLE", [0.0, 1.0]), dropout=("DISCRETE", [0.0, 0.1, 0.2]))
              for cls in (JaxSearchspace, Searchspace)]
    kw = dict(optimizer=optimizer, num_trials=num_trials, es_min=100, max_parallel=1,
              hb_interval=0.0)
    ref = jax_drivers.lagom(train_fn, searchspace=spaces[0], name="lagom-parity", **kw)
    got = lagom(train_fn, searchspace=spaces[1], name="lagom-parity", devices=CPUS, **kw)
    _same_summary(got, ref)
    assert got["num_trials"] == (13 if optimizer == "asha" else 8)


# -- LM trials: the same model, weights and data under both packages ---------------

LM = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
SEQ, BATCH, STEPS, LRS = 64, 4, 3, [1e-3, 3e-3]


def _decode_row(raw: bytes) -> dict:
    return {"tokens": np.frombuffer(raw, np.int32)}


@pytest.fixture(scope="module")
def lm_setup(tmp_path_factory):
    jm = JaxLM(**LM, dtype=jnp.float32)
    state = jax_common.create_train_state(jm, jax.random.PRNGKey(0), (1, 8),
                                          input_dtype=jnp.int32)
    rng = np.random.default_rng(7)
    docs = [rng.integers(1, LM["vocab_size"], int(rng.integers(10, 150)))
            for _ in range(40)]
    rows = jax_pack_documents(docs, seq_len=SEQ, eos_id=0)
    assert len(rows) >= BATCH * STEPS
    path = tmp_path_factory.mktemp("lm_data") / "rows.rio"
    with JaxRecordWriter(path) as w:
        for row in rows:
            w.write(row.astype(np.int32).tobytes())
    return jm, jax.device_get(state.params), path


def test_lm_trials_match_jax(lm_setup):
    jm, params, path = lm_setup
    jstep = jax.jit(jax_train_step())
    step = make_lm_train_step()
    jax_losses, port_losses, where = {}, {}, {}

    def jax_trial(lr):
        st = jax_common.TrainState.create(apply_fn=jm.apply, params=params,
                                          tx=optax.adam(lr), rng=jax.random.PRNGKey(1))
        ld = JaxDataLoader(JaxRecordIOSource([path], decode=_decode_row), BATCH, seed=3,
                           num_workers=2, name="jax-lm-trial")
        losses = []
        for batch in ld.device_iterator():
            st, m = jstep(st, batch)
            losses.append(float(m["loss"]))
            if len(losses) == STEPS:
                break
        jax_losses[lr] = losses
        return {"loss": losses[-1]}

    def port_trial(lr):
        dev = devices.resolve_device(None)  # the trial's device
        where[lr] = dev
        model = TransformerLM(**LM, dtype="float32", device=dev).load_flax(params)
        st = create_train_state(model, seed=1, learning_rate=lr)
        ld = DataLoader(RecordIOSource([path], decode=_decode_row), BATCH, seed=3,
                        num_workers=2, reuse_buffers=True, name="port-lm-trial")
        losses = []
        it = ld.device_iterator()
        for batch in it:
            assert isinstance(batch["tokens"], torch.Tensor)
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
            if len(losses) == STEPS:
                break
        it.close()
        port_losses[lr] = losses
        return {"loss": losses[-1]}

    _, ref = jax_drivers.grid_search(jax_trial, {"lr": LRS}, direction="min",
                                     optimization_key="loss", max_parallel=1)
    _, got = grid_search(port_trial, {"lr": LRS}, direction="min", optimization_key="loss",
                         max_parallel=1, devices=CPUS)
    assert got["best_config"] == ref["best_config"]
    assert set(where.values()) == {torch.device("cpu")}
    for lr in LRS:
        np.testing.assert_allclose(port_losses[lr], jax_losses[lr], err_msg=str(lr), **TOL)
    for tid, t in got["trials"].items():
        np.testing.assert_allclose(t["metric"], ref["trials"][tid]["metric"], **TOL)
    assert port_losses[LRS[0]] != port_losses[LRS[1]]


# -- devices: the trial scope -------------------------------------------------------


def test_trials_run_on_disjoint_device_groups():
    """Concurrent trials lease disjoint groups (4 of 8 devices each); inside
    a trial ``scoped_devices()`` is its group and ``resolve_device(None)``
    the group's first device. Eight indexed CPU devices stand in for eight
    cards (a CPU tensor ignores the index)."""
    cpus = [torch.device("cpu", i) for i in range(8)]
    barrier = threading.Barrier(2, timeout=30)
    seen: dict[int, tuple] = {}

    def train_fn(x):
        group = devices.scoped_devices()
        first = devices.resolve_device(None)
        barrier.wait()  # two trials really run at once
        seen[x] = (tuple(d.index for d in group), first.index)
        return {"metric": float(torch.arange(4.0, device=first).sum()) + x}

    _, summary = grid_search(train_fn, {"x": [0, 1, 2, 3]}, optimization_key="metric",
                             devices_per_trial=4, devices=cpus)
    assert summary["num_trials"] == 4 and summary["best_metric"] == 9.0
    groups = {g for g, _ in seen.values()}
    assert len(seen) == 4 and len(groups) == 2
    g1, g2 = groups
    assert len(g1) == len(g2) == 4 and not set(g1) & set(g2)
    assert set(g1) | set(g2) == set(range(8))
    for group, first in seen.values():
        assert first == group[0]
    assert devices.scoped_devices() is None


def test_trial_scope_nests_and_restores():
    with devices.trial_scope(["cpu:2", "cpu:3"]) as group:
        assert group == [torch.device("cpu", 2), torch.device("cpu", 3)]
        assert devices.resolve_device(None) == torch.device("cpu", 2)
        with devices.trial_scope([torch.device("cpu", 5)]):
            assert devices.scoped_devices() == [torch.device("cpu", 5)]
        assert devices.resolve_device(None) == torch.device("cpu", 2)
        assert devices.resolve_device("cpu") == torch.device("cpu")
        seen = []
        t = threading.Thread(target=lambda: seen.append(devices.scoped_devices()))
        t.start()
        t.join()
        assert seen == [None]  # per thread
    assert devices.scoped_devices() is None
    with pytest.raises(ValueError):
        with devices.trial_scope([]):
            pass


def test_outside_a_trial_the_default_is_still_the_card():
    assert devices.default_device() == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda:0"):
            devices.resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            grid_search(lambda x: {"m": x}, {"x": [1]})


def test_devices_per_trial_validation():
    with pytest.raises(ValueError, match="devices_per_trial"):
        grid_search(lambda x: {"m": x}, {"x": [1]}, devices_per_trial=len(CPUS) + 1,
                    devices=CPUS)
    with pytest.raises(ValueError, match="devices_per_trial"):
        grid_search(lambda x: {"m": x}, {"x": [1]}, devices_per_trial=0, devices=CPUS)


def test_trial_objects_are_freed_when_it_returns(lm_setup):
    """A trial's model, optimizer state and loader — of a trial that
    finishes and of one stopped early — are freed by reference counting
    as soon as the trial returns (the cyclic collector is off): nothing
    the driver keeps (history, results, meta, a traceback) holds them, so
    trials of a full-width model can follow each other on one card."""
    import gc
    import weakref

    _, params, path = lm_setup
    refs: dict = {}
    step = make_lm_train_step()

    def train_fn(lr, reporter):
        model = TransformerLM(**LM, dtype="float32", device=devices.resolve_device(None))
        state = create_train_state(model.load_flax(params), seed=1, learning_rate=lr)
        ld = DataLoader(RecordIOSource([path], decode=_decode_row), BATCH, num_epochs=None,
                        num_workers=2, reuse_buffers=True, name="freed")
        batches = ld.device_iterator()
        refs[lr] = [weakref.ref(o) for o in (model, state.optimizer, ld)]
        for i in range(40):
            state, metrics = step(state, next(batches))
            reporter.broadcast(metric=metrics["loss"] * (1 if lr < 1 else 100), step=i)
            if lr < 1 and i == 1:
                break
            time.sleep(0.02)
        return {"loss": metrics["loss"]}

    lrs = [1e-3, 3e-3, 1.0]
    # torch's first optimizer imports torch._dynamo, and that import leaves
    # its frames (the caller's with them) in a cycle for the collector: a
    # one-time cost, taken here before the collector is switched off.
    create_train_state(TransformerLM(**LM, dtype="float32", device="cpu").load_flax(params),
                       seed=1, learning_rate=1e-3)
    gc.collect()
    gc.disable()
    try:
        summary = lagom(train_fn, searchspace=Searchspace(lr=("DISCRETE", lrs)),
                        optimizer=GridSearch({"lr": lrs}, "min"), direction="min",
                        name="freed", es_min=2, es_interval=0.02, hb_interval=0.0,
                        devices=CPUS)
        alive = {lr: [r() is not None for r in rs] for lr, rs in refs.items()}
    finally:
        gc.enable()
    assert summary["early_stopped"] == 1 and summary["num_trials"] == 3
    assert alive == {lr: [False] * 3 for lr in lrs}


# -- tests/test_search.py on the port ------------------------------------------------


class TestSearchspace:
    def test_types_case_insensitive(self):
        sp = Searchspace(kernel=("integer", [2, 8]))
        sp.add("dropout", ("DOUBLE", [0.01, 0.99]))
        sp.add("act", ("CATEGORICAL", ["relu", "gelu"]))
        s = sp.sample(random.Random(0))
        assert 2 <= s["kernel"] <= 8 and isinstance(s["kernel"], int)
        assert 0.01 <= s["dropout"] <= 0.99
        assert s["act"] in ("relu", "gelu")

    def test_bad_specs(self):
        with pytest.raises(ValueError):
            Searchspace(x=("WAT", [1, 2]))
        with pytest.raises(ValueError):
            Searchspace(x=("INTEGER", [5, 1]))

    def test_grid_and_clip(self):
        sp = Searchspace(a=("INTEGER", [1, 2]), b=("DISCRETE", [10, 20]))
        assert len(list(sp.grid())) == 4
        assert sp.clip({"a": 99.7, "b": 10})["a"] == 2

    def test_samples_match_jax(self):
        spec = dict(k=("INTEGER", [2, 8]), d=("DOUBLE", [0.0, 1.0]), a=("CATEGORICAL", ["x", "y"]))
        got = [Searchspace(**spec).sample(random.Random(s)) for s in range(5)]
        want = [JaxSearchspace(**spec).sample(random.Random(s)) for s in range(5)]
        assert got == want


class TestRpc:
    def test_roundtrip_and_errors(self):
        server = RpcServer()
        server.register("add", lambda a, b: a + b)
        server.start()
        client = RpcClient(server.address)
        assert client.call("add", a=2, b=3) == 5
        with pytest.raises(RuntimeError, match="KeyError"):
            client.call("missing")
        client.close()
        server.stop()

    def test_concurrent_clients(self):
        server = RpcServer()
        server.register("echo", lambda x: x)
        server.start()
        results = []

        def worker(i):
            c = RpcClient(server.address)
            results.append(c.call("echo", x=i))
            c.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == list(range(8))
        server.stop()


class TestOptimizers:
    def test_de_converges_on_quadratic(self):
        sp = Searchspace(x=("DOUBLE", [-5, 5]), y=("DOUBLE", [-5, 5]))
        opt = DifferentialEvolution(sp, generations=10, population=8, direction="min")
        i = 0
        while not opt.finished():
            params = opt.ask()
            if params is None:
                break
            opt.tell(TrialResult(f"t{i}", params, params["x"] ** 2 + params["y"] ** 2,
                                 meta=params))
            i += 1
        assert min(f for f in opt._fitness if f is not None) < 1.0

    def test_asha_promotes_top_fraction(self):
        sp = Searchspace(lr=("DOUBLE", [0.0, 1.0]))
        opt = ASHA(sp, num_trials=9, min_budget=1, eta=3, direction="max")
        budgets, i = [], 0
        while not opt.finished() and i < 100:
            params = opt.ask()
            if params is None:
                break
            budgets.append(params["budget"])
            opt.tell(TrialResult(f"t{i}", params, params["lr"], meta=params))
            i += 1
        assert (budgets.count(1), budgets.count(3), budgets.count(9)) == (9, 3, 1)

    def test_median_early_stopper(self):
        es = MedianEarlyStopper("max", es_min=3)
        assert not es.should_stop(0.1, [0.5, 0.6])
        assert es.should_stop(0.1, [0.5, 0.6, 0.7])
        assert not es.should_stop(0.9, [0.5, 0.6, 0.7])

    def test_de_population_validation(self):
        with pytest.raises(ValueError, match="population"):
            DifferentialEvolution(Searchspace(x=("DOUBLE", [0, 1])), population=3)


class TestDrivers:
    def test_grid_search_finds_best(self):
        def train_fn(lr, width):
            return {"accuracy": lr * width}

        path, summary = grid_search(train_fn, {"lr": [0.1, 0.2], "width": [1, 2, 3]},
                                    optimization_key="accuracy", devices=CPUS)
        assert summary["num_trials"] == 6
        assert summary["best_config"] == {"lr": 0.2, "width": 3}
        assert summary["best_metric"] == pytest.approx(0.6)
        assert len(list(Path(path).glob("trial_*/trial.json"))) == 6
        assert json.loads((Path(path) / "result.json").read_text())["num_trials"] == 6
        runs = registry.list_runs("grid_search")
        assert runs and runs[-1]["status"] == "FINISHED"

    def test_differential_evolution_driver(self):
        _, summary = differential_evolution(
            lambda x: {"loss": (x - 2.0) ** 2}, {"x": [-10.0, 10.0]}, generations=6,
            population=6, direction="min", optimization_key="loss", devices=CPUS)
        assert summary["best_metric"] < 0.5
        assert abs(summary["best_config"]["x"] - 2.0) < 1.0

    def test_lagom_randomsearch_with_reporter(self):
        def train_fn(lr, reporter):
            for step in range(3):
                reporter.broadcast(metric=lr * (step + 1), step=step)
            return lr * 3

        summary = lagom(train_fn, searchspace=Searchspace(lr=("DOUBLE", [0.0, 1.0])),
                        optimizer="randomsearch", num_trials=6, name="lagom-test", es_min=100,
                        devices=CPUS)
        assert summary["num_trials"] == 6 and summary["best_metric"] > 0
        runs = registry.list_runs("lagom-test")
        assert runs and runs[-1]["status"] == "FINISHED"

    def test_lagom_early_stops_slow_trials(self, monkeypatch):
        from hops_tpu_torch.search import drivers

        heartbeats = []
        real = drivers.TrialDriver._on_heartbeat

        def counted(self, trial_id, step, metric):
            heartbeats.append((trial_id, step))
            return real(self, trial_id, step, metric)

        def train_fn(q, reporter):
            for step in range(50):
                reporter.broadcast(metric=q, step=step)
                time.sleep(0.01)
            return q

        monkeypatch.setattr(drivers.TrialDriver, "_on_heartbeat", counted)
        summary = lagom(train_fn, searchspace=Searchspace(q=("DOUBLE", [0.0, 1.0])),
                        num_trials=10, name="es-test", es_min=2, es_interval=0.05,
                        hb_interval=0.0, max_parallel=2, devices=CPUS)
        assert summary["early_stopped"] > 0 and summary["num_trials"] == 10
        assert len(heartbeats) > 10  # every broadcast reached the driver's server

    def test_lagom_explicit_grid_stops_the_diverging_trial(self):
        """Phase 15 (c)'s shape on the CPU: an explicit GridSearch, direction
        min, the diverging trial stopped at a step boundary."""
        steps_run = {}

        def train_fn(lr, reporter):
            loss = 1.0
            for step in range(40):
                loss = loss * (1.0 - lr) if lr < 1 else loss * 2.0
                steps_run[lr] = step + 1
                reporter.broadcast(metric=loss, step=step)
                time.sleep(0.01)
            return loss

        lrs = [0.1, 0.05, 1.0]
        summary = lagom(train_fn, searchspace=Searchspace(lr=("DISCRETE", lrs)),
                        optimizer=GridSearch({"lr": lrs}, "min"), direction="min",
                        name="es-grid", es_min=2, es_interval=0.05, hb_interval=0.0,
                        max_parallel=1, devices=CPUS)
        assert summary["early_stopped"] == 1
        stopped = [t for t in summary["trials"].values() if t["stopped_early"]]
        assert stopped[0]["params"] == {"lr": 1.0} and steps_run[1.0] < 40
        assert summary["best_config"] == {"lr": 0.1}

    def test_lagom_asha(self):
        summary = lagom(lambda lr, budget: lr * budget,
                        searchspace=Searchspace(lr=("DOUBLE", [0.0, 1.0])), optimizer="asha",
                        num_trials=9, name="asha-test", devices=CPUS)
        assert summary["num_trials"] == 13

    def test_failing_trial_does_not_kill_search(self):
        def train_fn(a):
            if a == 2:
                raise RuntimeError("bad hparam")
            return {"m": float(a)}

        path, summary = grid_search(train_fn, {"a": [1, 2, 3]}, optimization_key="m",
                                    devices=CPUS)
        assert summary["num_trials"] == 3 and summary["best_metric"] == 3.0
        meta = [json.loads(p.read_text()) for p in Path(path).glob("trial_*/trial.json")]
        errors = [t["error"] for t in meta if t.get("error")]
        assert len(errors) == 1 and "bad hparam" in errors[0]

    def test_ablation_prefix_expansion(self):
        study = AblationStudy("td")
        study.model.layers.include("conv_1", "conv_2", "dense_1")
        study.model.layers.include_groups(prefix="conv")
        trials = LOCOAblator(study).trials()
        assert {"ablated_feature": None, "ablated_layer": ["conv_1", "conv_2"]} in trials
        bad = AblationStudy("td")
        bad.model.layers.include_groups(prefix="ghost")
        with pytest.raises(ValueError, match="matched no included layer"):
            LOCOAblator(bad).trials()

    def test_ablation_loco(self):
        study = AblationStudy("titanic", 1, label_name="survived")
        study.features.include("age", "fare")
        study.model.layers.include("dense_1")
        assert len(LOCOAblator(study).trials()) == 4

        def train_fn(ablated_feature, ablated_layer):
            return (0.9 - 0.1 * (ablated_feature is not None)
                    - 0.2 * (ablated_layer is not None))

        summary = lagom(train_fn, experiment_type="ablation", ablation_study=study,
                        name="loco-test", devices=CPUS)
        assert summary["num_trials"] == 4
        assert summary["best_config"] == {"ablated_feature": None, "ablated_layer": None}
        assert summary["best_metric"] == pytest.approx(0.9)

    def test_flaky_trial_retried_before_failure(self, disarm):
        faultinject.arm("search.trial=error:OSError@times=1")
        _, summary = grid_search(
            lambda lr: {"metric": lr * 2}, {"lr": [1.0, 2.0]}, max_parallel=1, devices=CPUS,
            retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.01, seed=0))
        assert summary["num_trials"] == 2
        assert all(t["metric"] is not None for t in summary["trials"].values())
        assert summary["best_metric"] == 4.0

    def test_exhausted_retries_still_mark_failed_not_crash(self, disarm):
        faultinject.arm("search.trial=error:OSError")
        _, summary = grid_search(
            lambda lr: {"metric": lr}, {"lr": [1.0]}, max_parallel=1, devices=CPUS,
            retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.01, seed=0))
        assert summary["num_trials"] == 1 and summary["best_metric"] is None


def test_experiment_module_exports():
    _, summary = experiment.grid_search(lambda a: {"m": a}, {"a": [1, 2]},
                                        optimization_key="m", devices=CPUS)
    assert summary["best_metric"] == 2
    assert callable(experiment.differential_evolution) and callable(experiment.lagom)
