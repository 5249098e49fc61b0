"""Warm starts for fleet workers: a spare ``serving_host`` process that
has imported torch and waits for its job.

Most of a worker's start is its interpreter importing torch, before a
weight is read, and a fleet starts workers when it can least wait: a
rollout's surge, a heal after a kill, a re-placement after a lost host.
A :class:`WorkerStarter` hands each start to its spare when one is up and
starts the next spare; with none up it starts the worker cold. Either way
the worker is a ``Popen`` child of the caller running
``python -m hops_tpu_torch.modelrepo.serving_host``, in the caller's
process group or, with ``new_session``, in a session of its own, as a
cold start puts it.

A spare (``serving_host --spare``) imports torch, reads one JSON line on
its stdin — the worker's arguments, its environment, its log file and
whether it leads a session of its own — takes them on, and runs as the
worker. It is kept for one environment (the caller's, bar the variables
each worker gets at hand-off) and dropped when that changes; it exits
when its stdin closes, so it never outlives its starter's process, and
:meth:`WorkerStarter.close` ends it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

WORKER_MODULE = "hops_tpu_torch.modelrepo.serving_host"
#: Variables each worker gets at hand-off: a spare started under other
#: values of these is still the right process.
PER_WORKER_ENV = ("HOPS_TPU_WORKSPACE", "HOPS_TPU_PROJECT")


def _env_key(env: dict[str, str]) -> tuple:
    return tuple(sorted((k, v) for k, v in env.items() if k not in PER_WORKER_ENV))


class WorkerStarter:
    """Starts fleet workers, warm from a spare when one is up."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spare: tuple[subprocess.Popen, tuple] | None = None  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock
        self._renewing = False  # a spare is being started; guarded by: self._lock
        #: Starts handed to a spare, and started cold.
        self.warm = self.cold = 0  # guarded by: self._lock

    def start(self, args: list[str], env: dict[str, str], log: Path, *,
              new_session: bool) -> subprocess.Popen:
        """``python -m serving_host *args`` under ``env``, its output
        appended to ``log``; then a spare for the next start."""
        key = _env_key(env)
        with self._lock:
            spare, self._spare = self._spare, None
        proc = None
        if spare is not None and spare[1] == key and spare[0].poll() is None:
            job = {"args": list(args), "env": env, "log": str(log), "new_session": new_session}
            try:
                spare[0].stdin.write((json.dumps(job) + "\n").encode())
                spare[0].stdin.close()
                proc = spare[0]
            except OSError:  # it died since the poll: start cold
                pass
        if spare is not None and proc is None:
            _end(spare[0])
        warm = proc is not None
        if not warm:
            with open(log, "a") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-m", WORKER_MODULE, *args], stdout=out,
                    stderr=subprocess.STDOUT, env=env, start_new_session=new_session)
        with self._lock:
            self.warm += warm
            self.cold += not warm
            renew = not (self._closed or self._renewing or self._spare is not None)
            self._renewing |= renew
        if renew:
            new = subprocess.Popen(
                [sys.executable, "-m", WORKER_MODULE, "--spare"], stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env)
            with self._lock:
                self._renewing = False
                if not self._closed:
                    self._spare, new = (new, key), None
            if new is not None:  # closed meanwhile
                _end(new)
        return proc

    def close(self) -> None:
        """End the spare; later starts are all cold and keep none."""
        with self._lock:
            self._closed = True
            spare, self._spare = self._spare, None
        if spare is not None:
            _end(spare[0])


def _end(proc: subprocess.Popen) -> None:
    proc.kill()
    proc.wait()
    if not proc.stdin.closed:
        proc.stdin.close()
