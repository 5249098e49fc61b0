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
``collective_all_reduce``, ``parameter_server``) need the distribution
layer, a later slice of the port: they raise ``NotImplementedError``.
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
                "num_replicas": 1,
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
    return _run_wrapper(fn, args, name, "launch", local_logdir, metric_key)


def _later_slice(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"experiment.{kind} needs the distribution layer (strategies and "
        "gradient communication), which is a later slice of the port"
    )


def mirrored(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> tuple[str, dict[str, Any]]:
    """Single-host data-parallel training: a later slice."""
    raise _later_slice("mirrored")


def collective_all_reduce(
    fn: Callable[..., Any], *args: Any, **kwargs: Any
) -> tuple[str, dict[str, Any]]:
    """Whole-slice data-parallel training: a later slice."""
    raise _later_slice("collective_all_reduce")


def parameter_server(
    fn: Callable[..., Any], *args: Any, **kwargs: Any
) -> tuple[str, dict[str, Any]]:
    """Alias of :func:`collective_all_reduce`: a later slice."""
    raise _later_slice("parameter_server")
