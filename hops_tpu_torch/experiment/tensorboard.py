"""TensorBoard-contract module: per-run logdir + scalar/profiler APIs
(counterpart of ``hops_tpu/experiment/tensorboard.py``).

Matches the surface of the reference's ``hops.tensorboard``
(``tensorboard.logdir()`` — notebooks/ml/Experiment/Tensorflow/
mnist.ipynb:55-61, SURVEY.md §2.3): user code asks for the current
run's directory and writes logs/checkpoints/events there. Scalars go to
a JSONL event stream readable by the registry tooling; profiler traces
use ``torch.profiler`` into the same dir (a Chrome trace, viewable in
Perfetto or TensorBoard — the reference's `profile_batch` equivalent,
SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import os
import threading
from pathlib import Path
from typing import Iterator

from hops_tpu_torch.runtime import rundir
from hops_tpu_torch.runtime.logging import MetricLogger
from hops_tpu_torch.telemetry.spans import StepTimer

_writers: dict[str, MetricLogger] = {}
# Step-cadence telemetry derived from the scalar stream: the first
# scalar() of each NEW step marks a step boundary, so existing training
# wrappers feed hops_tpu_step_seconds / hops_tpu_steps_total (and the
# heartbeat gauge) without code changes. One timer PER RUN DIR: search
# trials log concurrently from a thread pool, and a shared clock would
# measure inter-trial gaps instead of step times (they still feed the
# same loop="experiment" series).
_step_timers: dict[str, StepTimer] = {}
_last_step: dict[str, int] = {}
_step_lock = threading.Lock()


def logdir() -> str:
    """The active run's log/checkpoint/working directory."""
    return rundir.logdir()


def _writer() -> MetricLogger:
    ld = logdir()
    if ld not in _writers:
        _writers[ld] = MetricLogger(Path(ld) / "metrics.jsonl")
    return _writers[ld]


def scalar(step: int, tag: str, value) -> None:
    """Log a scalar event into the run's metric stream (and tick the
    step-telemetry clock when ``step`` advances)."""
    ld = logdir()
    _writer().log(step, tag, value)
    with _step_lock:
        last = _last_step.get(ld)
        if last is not None and step <= last:
            return
        _last_step[ld] = step
        timer = _step_timers.get(ld)
        if timer is None:
            timer = _step_timers[ld] = StepTimer(loop="experiment")
        if last is None:  # first scalar of a run only arms the clock
            timer.arm()
        else:
            timer.tick()


def flush() -> None:
    for w in _writers.values():
        w.flush()


def close(run_logdir: str | None = None) -> None:
    """Close and evict the writer for ``run_logdir`` (default: the active
    run). Launchers call this when a run finalizes so long-lived drivers
    don't accumulate open file handles."""
    key = run_logdir or rundir.logdir()
    with _step_lock:
        _last_step.pop(key, None)
        _step_timers.pop(key, None)
    w = _writers.pop(key, None)
    if w is not None:
        w.close()


@contextlib.contextmanager
def profile(tag: str = "trace") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace window into the run dir as
    ``<logdir>/<tag>/trace_<pid>.json`` (the reference's Keras
    ``profile_batch='5,10'`` — SURVEY.md §5). Records the card's
    kernels too where CUDA is available."""
    import torch
    from torch.profiler import ProfilerActivity

    target = Path(logdir()) / tag
    target.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(target / f"trace_{os.getpid()}.json"))
