"""Job registry + supervised execution (counterpart of
``hops_tpu/jobs/api.py``; the on-disk layout is the same, so a job that
one package registers reads in the other).

API surface mirrors the verbs the reference's REST clients exercised:
``jobs.create_job`` / ``start_job`` (jobs_spark_client.py:53-54),
``jobs.get_executions`` / ``stop_job`` (jobs_flink_client.py:33-41,55),
with the templated-JSON job config (jobs_spark_client.py:28-37)
replaced by the typed config layer (``runtime.config``).

A job runs a Python application file in a supervised subprocess whose
stdout/stderr land in the execution's log file under the project's
``Jobs`` dataset; execution state transitions
INITIALIZING → RUNNING → FINISHED/FAILED/KILLED match the states the
Flink client polled for (jobs_flink_client.py:55-61).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import Any

from hops_tpu_torch.runtime import config as config_lib
from hops_tpu_torch.runtime import fs
from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)

_procs: dict[str, subprocess.Popen] = {}

# Execution bootstrap: runs the app file as __main__ with its argv, the
# app's directory first on sys.path (``python app.py`` semantics). It
# imports neither torch nor the port, so a plain-Python job starts in an
# interpreter's time.
_BOOTSTRAP = """\
import os, sys, runpy
sys.argv = sys.argv[1:]
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[0])))
runpy.run_path(sys.argv[0], run_name="__main__")
"""
_procs_lock = threading.Lock()


@dataclasses.dataclass
class JobConfig:
    """Typed job config — the reference's ``job_config.json`` template.

    ``app_file`` is the Python entry file (the reference's
    ``{APP_FILE}`` placeholder); ``dependencies`` are extra files/dirs
    staged next to it; ``chips`` is recorded with the job and read by
    nothing yet (as in the JAX package, whose ``start_job`` ignores it).
    """

    app_file: str = ""
    default_args: list[str] = dataclasses.field(default_factory=list)
    dependencies: list[str] = dataclasses.field(default_factory=list)
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    chips: int = 0
    job_type: str = "PYTHON"  # PYTHON | STREAMING


def _jobs_root() -> Path:
    p = Path(fs.project_path("Jobs"))
    p.mkdir(parents=True, exist_ok=True)
    return p


def _job_dir(name: str) -> Path:
    return _jobs_root() / name


@dataclasses.dataclass
class Execution:
    """One run of a job (the reference's execution record)."""

    job_name: str
    execution_id: str
    state: str = "INITIALIZING"
    submitted_at: float = 0.0
    finished_at: float | None = None
    args: list[str] = dataclasses.field(default_factory=list)
    exit_code: int | None = None
    log_path: str = ""

    @property
    def final(self) -> bool:
        return self.state in ("FINISHED", "FAILED", "KILLED")

    def _path(self) -> Path:
        return _job_dir(self.job_name) / "executions" / f"{self.execution_id}.json"

    def save(self) -> None:
        # Atomic replace: wait_for_completion polls this file at 10 Hz,
        # so a truncate-then-write would expose empty/partial JSON.
        path = self._path()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(dataclasses.asdict(self), indent=2))
        os.replace(tmp, path)

    def stdout(self) -> str:
        p = Path(self.log_path)
        return p.read_text() if p.exists() else ""


class Job:
    def __init__(self, name: str, config: JobConfig):
        self.name = name
        self.config = config

    def save(self) -> "Job":
        d = _job_dir(self.name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "job.json").write_text(
            json.dumps({"name": self.name, "config": config_lib.to_dict(self.config)}, indent=2)
        )
        return self

    @classmethod
    def load(cls, name: str) -> "Job":
        meta = json.loads((_job_dir(name) / "job.json").read_text())
        return cls(name, config_lib.from_dict(JobConfig, meta["config"]))


def create_job(name: str, config: JobConfig | dict[str, Any]) -> Job:
    """Register (or update) a job; mirrors ``jobs.create_job``."""
    if isinstance(config, dict):
        config = config_lib.from_dict(JobConfig, config)
    app = Path(config.app_file)
    if not app.is_absolute():
        config.app_file = str(Path(fs.project_path()) / app)
    return Job(name, config).save()


def get_job(name: str) -> Job:
    return Job.load(name)


def get_jobs() -> list[str]:
    return sorted(p.name for p in _jobs_root().iterdir() if (p / "job.json").exists())


def delete_job(name: str) -> None:
    fs.rmr(_job_dir(name))


def _child_pythonpath(existing: str | None) -> str:
    """Import path for child processes: inherited ``PYTHONPATH``, then
    the port's own location, then the parent's on-disk ``sys.path``
    entries.

    A clean checkout is neither pip-installed nor on ``PYTHONPATH``, so
    without this a child could not ``import hops_tpu_torch`` at all.
    """
    import hops_tpu_torch

    # An inherited PYTHONPATH keeps precedence over everything, so a
    # caller can pin its own staged dependencies; the port's root after
    # that covers the bare-checkout case; sys.path[0] (the parent
    # script's directory) is excluded so stray modules next to the
    # launcher don't shadow the child's imports.
    entries = existing.split(os.pathsep) if existing else []
    entries.append(str(Path(hops_tpu_torch.__file__).resolve().parent.parent))
    entries += [p for p in sys.path[1:] if p and Path(p).exists()]
    return os.pathsep.join(dict.fromkeys(entries))


def start_job(name: str, args: list[str] | None = None) -> Execution:
    """Launch an execution as a supervised subprocess; returns immediately.

    The child inherits the project workspace (``HOPS_TPU_WORKSPACE``)
    so its runs/artifacts land in the same project tree the parent
    sees — the in-cluster stand-in for the REST submission hop.
    """
    job = Job.load(name)
    ex = Execution(
        job_name=name,
        execution_id=uuid.uuid4().hex[:12],
        args=list(args or job.config.default_args),
        submitted_at=time.time(),
    )
    logdir = _job_dir(name) / "executions"
    logdir.mkdir(parents=True, exist_ok=True)
    ex.log_path = str(logdir / f"{ex.execution_id}.log")
    ex.save()

    env = dict(os.environ)
    env.update(job.config.env)
    env["HOPS_TPU_WORKSPACE"] = str(fs.workspace_root())
    env["HOPS_TPU_PROJECT"] = fs.project_name()
    env["HOPS_TPU_JOB_NAME"] = name
    env["HOPS_TPU_EXECUTION_ID"] = ex.execution_id
    env["PYTHONPATH"] = _child_pythonpath(env.get("PYTHONPATH"))

    logfile = open(ex.log_path, "w")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", _BOOTSTRAP, job.config.app_file, *ex.args],
            stdout=logfile,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=str(_job_dir(name)),
        )
    except OSError as e:
        logfile.write(f"spawn failed: {e}\n")
        logfile.close()
        ex.state, ex.finished_at, ex.exit_code = "FAILED", time.time(), -1
        ex.save()
        return ex

    with _procs_lock:
        _procs[f"{name}/{ex.execution_id}"] = proc
    ex.state = "RUNNING"
    ex.save()

    def _reap():
        code = proc.wait()
        logfile.close()
        # The record read-modify-write races with stop_job's KILLED
        # verdict; _procs_lock serializes both.
        with _procs_lock:
            cur = get_execution(name, ex.execution_id)
            cur.exit_code = code
            cur.finished_at = time.time()
            if cur.state != "KILLED":
                cur.state = "FINISHED" if code == 0 else "FAILED"
            cur.save()
            _procs.pop(f"{name}/{ex.execution_id}", None)

    threading.Thread(target=_reap, daemon=True, name=f"job-reap-{name}").start()
    return ex


def get_execution(name: str, execution_id: str) -> Execution:
    p = _job_dir(name) / "executions" / f"{execution_id}.json"
    return Execution(**json.loads(p.read_text()))


def get_executions(name: str) -> list[Execution]:
    """Newest-first execution list; mirrors ``jobs.get_executions``."""
    d = _job_dir(name) / "executions"
    if not d.exists():
        return []
    exs = [Execution(**json.loads(p.read_text())) for p in d.glob("*.json")]
    return sorted(exs, key=lambda e: e.submitted_at, reverse=True)


def stop_job(name: str, execution_id: str | None = None) -> None:
    """Kill running execution(s) of a job; mirrors ``jobs.stop_job``."""
    for ex in get_executions(name):
        if ex.final or (execution_id and ex.execution_id != execution_id):
            continue
        with _procs_lock:
            proc = _procs.get(f"{name}/{ex.execution_id}")
        killed = False
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            killed = True
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        # Only overwrite the record when we actually signaled it — the
        # process may have exited on its own between the listing and the
        # signal, in which case _reap's FINISHED/FAILED verdict stands.
        # The KILLED record is final, so it carries the exit code itself:
        # _reap may take the lock after it.
        if killed:
            with _procs_lock:
                cur = get_execution(name, ex.execution_id)
                cur.state = "KILLED"
                if cur.exit_code is None:
                    cur.exit_code = proc.returncode
                cur.finished_at = cur.finished_at or time.time()
                cur.save()


def wait_for_completion(name: str, execution_id: str, timeout_s: float = 600.0) -> Execution:
    """Poll an execution to a final state (the Flink client's 90 s poll
    loop, jobs_flink_client.py:55-61, with a configurable budget)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ex = get_execution(name, execution_id)
        if ex.final:
            return ex
        time.sleep(0.1)
    raise TimeoutError(f"execution {name}/{execution_id} not done after {timeout_s}s")
