"""Per-run directory manager.

Implements the contract of the reference's ``hops.tensorboard.logdir()``
(reference: notebooks/ml/Experiment/Tensorflow/mnist.ipynb:55-61,
SURVEY.md §2.3): every experiment run gets a directory that serves as
log dir, checkpoint dir and working dir, is exposed to the user's
wrapper function while it runs, and is durably synced into the project's
``Experiments`` dataset when the run ends.

Run ids follow the reference's ``<app_id>_<run_number>`` shape, with the
Spark application id replaced by a session id.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import shutil
import tempfile
import threading
import time
import uuid
from pathlib import Path
from typing import Iterator

from hops_tpu_torch.runtime import fs

_session_id: str | None = None
_run_counter = 0
# Per-context (thread/task) stack so concurrent trials each see their own
# active run; a fresh thread starts with an empty stack.
_active: contextvars.ContextVar[tuple["RunDir", ...]] = contextvars.ContextVar(
    "hops_tpu_active_runs", default=()
)
_state_lock = threading.Lock()
_live_activations = 0


def session_id() -> str:
    """Stable per-process session id (the reference's YARN app id).

    On a multi-host slice every host must agree on the id so run
    artifacts land in one shared directory — ``multihost.initialize``
    broadcasts the chief's id via :func:`set_session_id`, and the
    ``HOPS_TPU_SESSION_ID`` env var lets an external launcher pin it.
    """
    global _session_id
    if _session_id is None:
        _session_id = os.environ.get(
            "HOPS_TPU_SESSION_ID", f"application_{int(time.time())}_{uuid.uuid4().hex[:6]}"
        )
    return _session_id


def set_session_id(sid: str | None) -> None:
    global _session_id
    _session_id = sid


def experiments_root() -> Path:
    p = Path(fs.project_path("Experiments"))
    p.mkdir(parents=True, exist_ok=True)
    return p


class RunDir:
    """A single run's working directory.

    ``local_logdir=True`` mirrors the reference knob of the same name
    (PyTorch mnist.ipynb:251): work on fast local disk, upload to the
    Experiments dataset afterwards. ``False`` writes directly into the
    Experiments dataset.
    """

    def __init__(self, run_id: str, local_logdir: bool = False):
        self.run_id = run_id
        self.final_path = experiments_root() / run_id
        if local_logdir:
            self._work = Path(tempfile.mkdtemp(prefix=f"hops_tpu_{run_id}_"))
        else:
            self.final_path.mkdir(parents=True, exist_ok=True)
            self._work = self.final_path
        self.local_logdir = local_logdir
        self._finalized = False

    @property
    def logdir(self) -> str:
        return str(self._work)

    @property
    def checkpoint_dir(self) -> str:
        p = self._work / "checkpoints"
        p.mkdir(exist_ok=True)
        return str(p)

    def finalize(self) -> str:
        """Sync to the Experiments dataset; returns the durable path.
        Idempotent — a second call is a no-op."""
        if not self._finalized and self.local_logdir and self._work != self.final_path:
            self.final_path.mkdir(parents=True, exist_ok=True)
            shutil.copytree(self._work, self.final_path, dirs_exist_ok=True)
            shutil.rmtree(self._work, ignore_errors=True)
        self._finalized = True
        return str(self.final_path)


def new_run(name: str = "run", local_logdir: bool = False) -> RunDir:
    global _run_counter
    with _state_lock:
        _run_counter += 1
        n = _run_counter
    return RunDir(f"{session_id()}_{n}", local_logdir=local_logdir)


def logdir() -> str:
    """The active run's log/checkpoint/working dir — valid only inside a
    launched wrapper function (reference: ``tensorboard.logdir()``)."""
    stack = _active.get()
    if stack:
        return stack[-1].logdir
    # Outside a run (interactive use): fall back to a scratch dir, like
    # the reference did when called outside an experiment.
    scratch = Path(tempfile.gettempdir()) / "hops_tpu_scratch"
    scratch.mkdir(exist_ok=True)
    return str(scratch)


@contextlib.contextmanager
def activate(run: RunDir) -> Iterator[RunDir]:
    """Make ``run`` the current run for ``logdir()`` lookups.

    The process cwd is switched into the run dir (so relative writes get
    synced) only for the first concurrent activation — cwd is
    process-global, so under the parallel trial driver only ``logdir()``
    is a reliable base; concurrent trials keep the outer cwd.
    """
    global _live_activations
    token = _active.set(_active.get() + (run,))
    prev_cwd = os.getcwd()
    did_chdir = False
    with _state_lock:
        # Claim the cwd only when NO other activation is live — otherwise
        # a later trial would yank the cwd from under a running one.
        if _live_activations == 0:
            os.chdir(run.logdir)
            did_chdir = True
        _live_activations += 1
    try:
        yield run
    finally:
        _active.reset(token)
        with _state_lock:
            _live_activations -= 1
            if did_chdir:
                os.chdir(prev_cwd)
