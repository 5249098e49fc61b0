"""Experiment launchers (counterpart of ``hops_tpu/experiment/core.py``).

The reference's core UX (SURVEY.md §2.3): the user hands the launcher a
**wrapper function containing the whole training program**; the launcher
provisions the run (directory, logging), executes it, collects the
returned metrics dict, syncs the logdir into the project's Experiments
dataset, registers the run, and returns ``(experiment_dir,
metrics_dict)`` where the dict carries a ``'log'`` path — e.g.
``('…/Experiments/application_…_3', {'accuracy': 0.83, 'log':
'…/output.log'})``. Run directories and ``Experiments/index.jsonl``
records have the JAX package's layout.

``launch`` runs the wrapper in this process, on the card its code picks
(``cuda:0`` by default). The data-parallel launchers (``mirrored``,
``collective_all_reduce``, ``parameter_server``) run it inside a
strategy's ``scope()`` (``parallel.get_strategy()`` returns it) in every
process of the run (``python -m hops_tpu_torch.launch``): rank 0
registers the run, and every rank writes into the one run directory
that the shared session id names.
"""

from __future__ import annotations

import contextlib
import io
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch

from hops_tpu_torch.experiment import registry
from hops_tpu_torch.parallel import multihost
from hops_tpu_torch.parallel.strategy import (
    CollectiveAllReduceStrategy,
    MirroredStrategy,
    Strategy,
)
from hops_tpu_torch.runtime import rundir
from hops_tpu_torch.runtime.logging import attach_run_log, detach_run_log, get_logger, scalarize
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

#: Experiments span seconds (smoke tests) to hours (real training).
_DURATION_BUCKETS = (0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0, 7200.0)


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _normalize_metrics(result: Any, metric_key: str | None) -> dict[str, Any]:
    if result is None:
        metrics: dict[str, Any] = {"metric": None}
    elif isinstance(result, dict):
        metrics = dict(result)
        if metric_key is not None:
            metrics["metric"] = metrics.get(metric_key)
        elif "metric" not in metrics and len(metrics) == 1:
            metrics["metric"] = next(iter(metrics.values()))
    else:
        metrics = {"metric": result}
    return metrics


def _run_wrapper(
    fn: Callable[..., Any],
    kwargs: dict[str, Any] | None,
    name: str,
    kind: str,
    local_logdir: bool,
    metric_key: str | None,
    strategy: Strategy | None,
) -> tuple[str, dict[str, Any]]:
    """Shared launcher mechanics for all experiment kinds."""
    run = rundir.new_run(name=name, local_logdir=local_logdir)
    chief = multihost.is_chief()
    if chief:
        registry.register(
            {"run_id": run.run_id, "name": name, "kind": kind, "status": "RUNNING"}
        )
    start = time.time()
    out_path = Path(run.logdir) / "output.log"
    handler = attach_run_log(out_path)
    status, metrics, err = "FINISHED", {}, None
    with rundir.activate(run):
        out_file = out_path.open("a")
        tee_out = _Tee(sys.stdout, out_file)
        try:
            with contextlib.redirect_stdout(tee_out):
                ctx = strategy.scope() if strategy is not None else contextlib.nullcontext()
                with ctx:
                    result = fn(**kwargs) if kwargs else fn()
                # CUDA reports a kernel's fault when the stream is next
                # synchronized: wait for the wrapper's queued work here,
                # so its fault fails the run rather than surfacing after
                # the run was registered FINISHED. A wrapper that never
                # touched the card does not initialize CUDA.
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            metrics = _normalize_metrics(result, metric_key)
        except Exception as e:  # noqa: BLE001 — failures must land in the registry
            status, err = "FAILED", e
            tee_out.write(traceback.format_exc())
        finally:
            tee_out.flush()
            out_file.close()
            detach_run_log(handler)
            from hops_tpu_torch.experiment import tensorboard as _tb

            _tb.close(run.logdir)
    final_path = run.finalize()
    # Launcher telemetry: run outcomes by kind, and wall time. Step
    # cadence (step time / steps/sec) rides the tensorboard.scalar
    # stream and run_preemptible's StepTimer, not the launcher.
    REGISTRY.counter(
        "hops_tpu_experiment_runs_total",
        "Experiment runs by launcher kind and final status",
        labels=("kind", "status"),
    ).inc(kind=kind, status=status)
    REGISTRY.histogram(
        "hops_tpu_experiment_duration_seconds",
        "Wall time of experiment runs",
        labels=("kind",), buckets=_DURATION_BUCKETS,
    ).observe(time.time() - start, kind=kind)
    if chief:
        registry.register(
            {
                "run_id": run.run_id,
                "name": name,
                "kind": kind,
                "status": status,
                "metrics": {k: scalarize(v) for k, v in metrics.items()},
                "metric_key": metric_key,
                "duration_s": time.time() - start,
                "path": final_path,
                "num_replicas": strategy.num_replicas_in_sync if strategy else 1,
            }
        )
    if err is not None:
        raise err
    metrics["log"] = str(Path(final_path) / "output.log")
    return final_path, metrics


def launch(
    fn: Callable[..., Any],
    args: dict[str, Any] | None = None,
    name: str = "no-name",
    local_logdir: bool = False,
    metric_key: str | None = None,
) -> tuple[str, dict[str, Any]]:
    """Single experiment (reference: ``experiment.launch``,
    notebooks/ml/Experiment/Tensorflow/mnist.ipynb:228)."""
    return _run_wrapper(fn, args, name, "launch", local_logdir, metric_key, None)


def mirrored(
    fn: Callable[..., Any],
    args: dict[str, Any] | None = None,
    name: str = "no-name",
    local_logdir: bool = False,
    metric_key: str | None = None,
    grad_comms: Any | None = None,
) -> tuple[str, dict[str, Any]]:
    """Single-host data-parallel training over this host's ranks
    (reference: ``experiment.mirrored`` + ``MirroredStrategy``,
    mirroredstrategy_mnist_example.ipynb:231). The wrapper sees the
    strategy via ``parallel.get_strategy()``. ``grad_comms`` (a
    ``parallel.grad_comms.GradCommsConfig``) becomes the strategy's
    default for ``strategy.step``."""
    return _run_wrapper(
        fn, args, name, "mirrored", local_logdir, metric_key,
        MirroredStrategy(grad_comms=grad_comms),
    )


def collective_all_reduce(
    fn: Callable[..., Any],
    args: dict[str, Any] | None = None,
    name: str = "no-name",
    local_logdir: bool = False,
    metric_key: str | None = None,
    grad_comms: Any | None = None,
    update_sharding: str = "replicated",
) -> tuple[str, dict[str, Any]]:
    """Data-parallel training over every rank of the run; gradients
    all-reduced by DDP (reference: multi-worker ``experiment.mirrored``
    with ``MultiWorkerMirroredStrategy`` + NCCL, and the
    ``collective_all_reduce`` mode). ``grad_comms`` and
    ``update_sharding`` (``"cross_replica"``: ZeRO-1) pass through to
    :class:`~hops_tpu_torch.parallel.CollectiveAllReduceStrategy`."""
    return _run_wrapper(
        fn, args, name, "collective_all_reduce", local_logdir, metric_key,
        CollectiveAllReduceStrategy(update_sharding=update_sharding, grad_comms=grad_comms),
    )


def parameter_server(
    fn: Callable[..., Any],
    args: dict[str, Any] | None = None,
    name: str = "no-name",
    local_logdir: bool = False,
    metric_key: str | None = None,
) -> tuple[str, dict[str, Any]]:
    """Alias of :func:`collective_all_reduce` — parameter servers have no
    counterpart here; the docs-only reference mode lowers to the same
    collective path (and registers its run under that kind)."""
    return collective_all_reduce(fn, args, name, local_logdir, metric_key)
