"""The async trial driver and its public entry points (counterpart of
``hops_tpu/search/drivers.py``).

Architecture (SURVEY.md §3.3): a driver-side optimizer loop + RPC
heartbeat server; executor threads run trials on **disjoint device
groups** — the devices (``devices=``; default every visible card)
partition into groups of ``devices_per_trial``, each concurrent trial
leases one group from a pool, and inside the trial the thread runs in
that group's :func:`~hops_tpu_torch.runtime.devices.trial_scope`:
``resolve_device(None)`` (so every entry point's default device) is the
group's first device, ``scoped_devices()`` the whole group, and on a
card the thread's current CUDA device is the group's first. A trial so
never touches its neighbours' cards (SURVEY.md §7 hard part #2). Reporters stream metrics back at ``hb_interval``; an early stopper
flags underperformers, which die cooperatively at their next step
boundary. No barrier between trials — completions feed the optimizer as
they land (lagom semantics).

Entry points: :func:`lagom` (maggy, SURVEY.md §2.4), :func:`grid_search`
and :func:`differential_evolution` (``hops.experiment``, SURVEY.md §2.3).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import inspect
import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from hops_tpu_torch.experiment import registry
from hops_tpu_torch.messaging.rpc import RpcServer
from hops_tpu_torch.runtime import devices as devices_lib
from hops_tpu_torch.runtime import rundir
from hops_tpu_torch.runtime.logging import get_logger, scalarize
from hops_tpu_torch.search.ablation import AblationStudy, LOCOAblator
from hops_tpu_torch.search.earlystop import MedianEarlyStopper, NoEarlyStop
from hops_tpu_torch.search.optimizers import (
    DifferentialEvolution,
    GridSearch,
    Optimizer,
    TrialResult,
    make_optimizer,
)
from hops_tpu_torch.search.reporter import Reporter, TrialStopped
from hops_tpu_torch.search.searchspace import Searchspace
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)


class _TrialDir:
    """Shim with the RunDir interface rundir.activate() needs, rooted
    inside the parent experiment's directory."""

    def __init__(self, path: Path):
        path.mkdir(parents=True, exist_ok=True)
        self.logdir = str(path)


class TrialDriver:
    def __init__(
        self,
        train_fn: Callable[..., Any],
        optimizer: Optimizer,
        name: str = "search",
        kind: str = "lagom",
        direction: str = "max",
        optimization_key: str | None = None,
        hb_interval: float = 1.0,
        es_interval: float = 1.0,
        early_stopper: Any = None,
        max_parallel: int | None = None,
        devices_per_trial: int = 1,
        use_rpc: bool = True,
        retry_policy: Any = None,
        devices: Sequence[str | torch.device] | None = None,
    ):
        self.train_fn = train_fn
        self.optimizer = optimizer
        # Transient trial failures (device hiccup, flaky I/O) retry
        # under the policy before the trial is marked failed; an
        # early-stop signal is never a failure, so never retried.
        self.retry_policy = (
            None if retry_policy is None
            else dataclasses.replace(
                retry_policy,
                no_retry_on=tuple(retry_policy.no_retry_on) + (TrialStopped,),
            )
        )
        self.name = name
        self.kind = kind
        self.direction = direction.lower()
        self.optimization_key = optimization_key
        self.hb_interval = hb_interval
        self.es_interval = es_interval
        self.early_stopper = early_stopper or NoEarlyStop()
        self.devices = (
            devices_lib.visible_devices() if devices is None
            else [torch.device(d) for d in devices]
        )
        if devices_per_trial < 1 or devices_per_trial > len(self.devices):
            raise ValueError(
                f"devices_per_trial={devices_per_trial} with "
                f"{len(self.devices)} visible devices"
            )
        # Disjoint contiguous groups, in the order given (cards in index
        # order by default, so a group's cards are neighbours).
        n_groups = len(self.devices) // devices_per_trial
        self.device_groups = [
            tuple(self.devices[i * devices_per_trial : (i + 1) * devices_per_trial])
            for i in range(n_groups)
        ]
        self.max_parallel = min(max_parallel or n_groups, n_groups)
        self.use_rpc = use_rpc
        self._wants_reporter = "reporter" in inspect.signature(train_fn).parameters
        self._reporters: dict[str, Reporter] = {}
        self._finished_finals: list[float] = []
        self._lock = threading.Lock()
        # Trial lifecycle counters: started / finished / early_stopped /
        # failed, per driver kind (lagom, grid_search, ...). rate() on
        # "finished" is search throughput.
        self._m_trials = REGISTRY.counter(
            "hops_tpu_search_trials_total",
            "Search trials by lifecycle event",
            labels=("kind", "event"),
        )

    # -- heartbeat handler (driver side of the RPC channel) -------------------

    def _on_heartbeat(self, trial_id: str, step: int, metric: float | None) -> dict:
        with self._lock:
            rep = self._reporters.get(trial_id)
            stop = rep is not None and rep._stop.is_set()
        return {"stop": stop}

    # -- trial execution (executor-thread side) --------------------------------

    def _run_trial(
        self,
        trial_id: str,
        params: dict[str, Any],
        group: tuple[Any, ...],
        parent_dir: Path,
        rpc_address: tuple[str, int] | None,
    ) -> TrialResult:
        self._m_trials.inc(kind=self.kind, event="started")
        reporter = Reporter(trial_id, rpc_address, self.hb_interval)
        with self._lock:
            self._reporters[trial_id] = reporter
        visible = {k: v for k, v in params.items() if not k.startswith("_")}
        kwargs = dict(visible)
        if self._wants_reporter:
            kwargs["reporter"] = reporter
        trial_dir = _TrialDir(parent_dir / trial_id)
        stopped = False
        error: str | None = None
        metric: float | None = None
        try:
            from hops_tpu_torch.runtime import faultinject

            def _attempt():
                faultinject.fire("search.trial")  # chaos: flaky trial
                # Entered on the executor thread: the CUDA current device
                # is per thread.
                with devices_lib.trial_scope(group), rundir.activate(trial_dir):
                    return self.train_fn(**kwargs)

            if self.retry_policy is None:
                result = _attempt()
            else:
                result = self.retry_policy.call(_attempt, op="search.trial")
            metric = self._extract_metric(result)
        except TrialStopped:
            stopped = True
            metric = reporter.latest
        except Exception as e:  # noqa: BLE001 — one bad trial must not kill the search
            error = f"{type(e).__name__}: {e}"
            log.warning("trial %s failed: %s", trial_id, error)
        finally:
            reporter.finalize(metric)
            from hops_tpu_torch.experiment import tensorboard as _tb

            _tb.close(trial_dir.logdir)
        self._m_trials.inc(
            kind=self.kind,
            event=(
                "early_stopped" if stopped
                else "failed" if error is not None
                else "finished"
            ),
        )
        (Path(trial_dir.logdir) / "trial.json").write_text(
            json.dumps(
                {
                    "trial_id": trial_id,
                    "params": {k: scalarize(v) for k, v in visible.items()},
                    "metric": metric,
                    "stopped_early": stopped,
                    "error": error,
                    "history": reporter.history,
                },
                default=str,
            )
        )
        return TrialResult(
            trial_id, params, metric, stopped_early=stopped, meta={**params, "error": error}
        )

    def _extract_metric(self, result: Any) -> float | None:
        if isinstance(result, dict):
            if self.optimization_key is not None:
                v = result.get(self.optimization_key)
            elif len(result) == 1:
                v = next(iter(result.values()))
            else:
                v = result.get("metric")
            return None if v is None else float(v)
        return None if result is None else float(result)

    # -- the async driver loop -------------------------------------------------

    def run(self) -> tuple[str, dict[str, Any]]:
        run = rundir.new_run(name=self.name)
        parent_dir = Path(run.logdir)
        registry.register(
            {"run_id": run.run_id, "name": self.name, "kind": self.kind, "status": "RUNNING"}
        )
        server = None
        rpc_address = None
        if self.use_rpc:
            server = RpcServer()
            server.register("heartbeat", self._on_heartbeat)
            server.start()
            rpc_address = server.address

        start = time.time()
        results: list[TrialResult] = []
        trial_seq = 0
        pending: dict[cf.Future, str] = {}
        free_groups = list(self.device_groups)
        leased: dict[str, tuple[Any, ...]] = {}
        self._last_sweep = time.monotonic()
        try:
            with cf.ThreadPoolExecutor(max_workers=self.max_parallel) as pool:
                while True:
                    # Issue every trial the optimizer can produce right
                    # now, each leasing a free device group.
                    while len(pending) < self.max_parallel and free_groups:
                        params = self.optimizer.ask()
                        if params is None:
                            break
                        tid = f"trial_{trial_seq:04d}"
                        trial_seq += 1
                        group = free_groups.pop()
                        leased[tid] = group
                        fut = pool.submit(
                            self._run_trial, tid, params, group, parent_dir, rpc_address
                        )
                        pending[fut] = tid
                    if not pending:
                        if self.optimizer.finished():
                            break
                        time.sleep(0.005)
                        continue
                    done, _ = cf.wait(
                        pending, timeout=self.es_interval, return_when=cf.FIRST_COMPLETED
                    )
                    for fut in done:
                        tid = pending.pop(fut)
                        free_groups.append(leased.pop(tid))
                        result = fut.result()
                        results.append(result)
                        with self._lock:
                            self._reporters.pop(tid, None)
                            if result.metric is not None and not result.stopped_early:
                                self._finished_finals.append(result.metric)
                        self.optimizer.tell(result)
                    self._early_stop_sweep()
        finally:
            if server is not None:
                server.stop()

        scored = [r for r in results if r.metric is not None]
        best = None
        if scored:
            pick = max if self.direction == "max" else min
            best = pick(scored, key=lambda r: r.metric)
        summary = {
            "best_id": best.trial_id if best else None,
            "best_config": (
                {k: v for k, v in best.params.items() if not k.startswith("_")} if best else None
            ),
            "best_metric": best.metric if best else None,
            "num_trials": len(results),
            "early_stopped": sum(r.stopped_early for r in results),
            # direction + per-trial params travel with the summary so
            # downstream tooling (hops_tpu.plotting.plot_trials /
            # collect) can orient the best-so-far envelope and plot
            # metric-vs-param without re-reading trial dirs.
            "direction": self.direction,
            "trials": {
                r.trial_id: {
                    "metric": r.metric,
                    "stopped_early": r.stopped_early,
                    "params": {
                        k: v for k, v in r.params.items()
                        if not k.startswith("_")
                    },
                }
                for r in results
            },
        }
        (parent_dir / "result.json").write_text(json.dumps(summary, indent=2, default=str))
        final_path = run.finalize()
        registry.register(
            {
                "run_id": run.run_id,
                "name": self.name,
                "kind": self.kind,
                "status": "FINISHED",
                "metrics": {"metric": best.metric if best else None},
                "best_config": summary["best_config"],
                "duration_s": time.time() - start,
                "path": final_path,
            }
        )
        return final_path, summary

    def _early_stop_sweep(self) -> None:
        if time.monotonic() - self._last_sweep < self.es_interval:
            return
        self._last_sweep = time.monotonic()
        with self._lock:
            finals = list(self._finished_finals)
            for rep in self._reporters.values():
                if self.early_stopper.should_stop(rep.latest, finals):
                    rep.request_stop()


# -- public entry points ------------------------------------------------------


def lagom(
    train_fn: Callable[..., Any] | None = None,
    searchspace: Searchspace | None = None,
    optimizer: str | Optimizer = "randomsearch",
    direction: str = "max",
    num_trials: int = 10,
    name: str = "lagom",
    hb_interval: float = 1.0,
    es_interval: float = 1.0,
    es_min: int = 5,
    experiment_type: str = "optimization",
    ablation_study: AblationStudy | None = None,
    ablator: str = "loco",
    optimization_key: str | None = None,
    max_parallel: int | None = None,
    devices_per_trial: int = 1,
    retry_policy: Any = None,
    devices: Sequence[str | torch.device] | None = None,
) -> dict[str, Any]:
    """Async parallel trials (reference: ``maggy.experiment.lagom``,
    maggy-fashion-mnist-example.ipynb:318-327).

    ``devices_per_trial`` places each trial on its own disjoint group
    of that many of ``devices`` (default: every visible card; raises
    where there is none); inside the trial ``resolve_device(None)`` is
    the group's first device and ``scoped_devices()`` the group.
    ``retry_policy`` (a ``runtime.resilience.RetryPolicy``) retries a
    trial that raised before marking it failed."""
    if experiment_type == "ablation":
        if ablation_study is None:
            raise ValueError("experiment_type='ablation' requires ablation_study=")
        if ablator.lower() != "loco":
            raise ValueError(f"unknown ablator {ablator!r}")
        opt = GridSearch.from_trials(LOCOAblator(ablation_study).trials(), direction)
    else:
        if searchspace is None:
            raise ValueError("optimization experiments require searchspace=")
        opt = make_optimizer(optimizer, searchspace, num_trials, direction)
    driver = TrialDriver(
        train_fn,
        opt,
        name=name,
        kind="lagom" if experiment_type == "optimization" else "ablation",
        direction=direction,
        optimization_key=optimization_key,
        hb_interval=hb_interval,
        es_interval=es_interval,
        early_stopper=MedianEarlyStopper(direction, es_min),
        max_parallel=max_parallel,
        devices_per_trial=devices_per_trial,
        retry_policy=retry_policy,
        devices=devices,
    )
    path, summary = driver.run()
    summary["path"] = path
    return summary


def grid_search(
    train_fn: Callable[..., Any],
    args_dict: dict[str, list[Any]],
    direction: str = "max",
    optimization_key: str | None = None,
    name: str = "grid_search",
    max_parallel: int | None = None,
    devices_per_trial: int = 1,
    retry_policy: Any = None,
    devices: Sequence[str | torch.device] | None = None,
) -> tuple[str, dict[str, Any]]:
    """Exhaustive sweep (reference: ``experiment.grid_search``,
    grid_search_fashion_mnist.ipynb:311 — args_dict keys are wrapper
    kwargs, values are candidate lists)."""
    driver = TrialDriver(
        train_fn,
        GridSearch(args_dict, direction),
        name=name,
        kind="grid_search",
        direction=direction,
        optimization_key=optimization_key,
        max_parallel=max_parallel,
        devices_per_trial=devices_per_trial,
        retry_policy=retry_policy,
        devices=devices,
    )
    return driver.run()


def differential_evolution(
    train_fn: Callable[..., Any],
    searchdict: dict[str, list[Any]] | Searchspace,
    generations: int = 4,
    population: int = 5,
    direction: str = "max",
    optimization_key: str | None = None,
    local_logdir: bool = False,  # accepted for reference parity; trials live in the run dir
    name: str = "differential_evolution",
    max_parallel: int | None = None,
    devices_per_trial: int = 1,
    retry_policy: Any = None,
    devices: Sequence[str | torch.device] | None = None,
) -> tuple[str, dict[str, Any]]:
    """Genetic search (reference: ``experiment.differential_evolution``,
    evolutionary_search_mnist.ipynb:267, generations/population semantics
    from Parallel_Experiments/PyTorch/differential_evolution/mnist.ipynb:230).

    ``searchdict`` may be a ``{"lr": [lo, hi]}`` bounds dict (numeric
    axes become DOUBLE ranges) or a full :class:`Searchspace`."""
    if isinstance(searchdict, Searchspace):
        space = searchdict
    else:
        space = Searchspace()
        for k, bounds in searchdict.items():
            if all(isinstance(b, (int, float)) for b in bounds) and len(bounds) == 2:
                kind = "INTEGER" if all(isinstance(b, int) for b in bounds) else "DOUBLE"
                space.add(k, (kind, list(bounds)))
            else:
                space.add(k, ("DISCRETE", list(bounds)))
    driver = TrialDriver(
        train_fn,
        DifferentialEvolution(space, generations, population, direction),
        name=name,
        kind="differential_evolution",
        direction=direction,
        optimization_key=optimization_key,
        max_parallel=max_parallel,
        devices_per_trial=devices_per_trial,
        retry_policy=retry_policy,
        devices=devices,
    )
    return driver.run()
