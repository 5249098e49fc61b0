"""Trial reporter: live metric stream + cooperative cancellation (a copy of
``hops_tpu/search/reporter.py``: the module imports no JAX, and the port imports nothing
of the JAX package).

Reference contract (SURVEY.md §2.4): the trial function receives a
``reporter``; ``reporter.broadcast(metric=...)`` streams the current
metric to the driver at heartbeat granularity, and the driver's early
stopper can kill the trial mid-flight. Spark killed the executor task;
on TPU a jitted loop can't be killed externally, so cancellation is
cooperative: the stop flag raises :class:`TrialStopped` inside the next
``broadcast``/``check`` call at a step boundary (SURVEY.md §7 hard
part #3).
"""

from __future__ import annotations

import threading
import time
from typing import Any

from hops_tpu_torch.messaging.rpc import RpcClient


class TrialStopped(Exception):
    """Raised inside a trial when the driver early-stops it."""


class Reporter:
    def __init__(
        self,
        trial_id: str,
        rpc_address: tuple[str, int] | None = None,
        hb_interval: float = 1.0,
        log_fn=print,
    ):
        self.trial_id = trial_id
        self.hb_interval = hb_interval
        self._log_fn = log_fn
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._latest: float | None = None
        self._step = 0
        self.history: list[tuple[int, float]] = []
        self._client = RpcClient(rpc_address) if rpc_address else None
        self._last_hb = 0.0

    # -- trial-side API (reference: reporter.broadcast / reporter.log) -------

    def broadcast(self, metric: float | None = None, step: int | None = None) -> None:
        """Stream the current metric; raises TrialStopped if the driver
        flagged this trial. Call once per step/epoch boundary."""
        with self._lock:
            if metric is not None:
                self._step = step if step is not None else self._step + 1
                self._latest = float(metric)
                self.history.append((self._step, self._latest))
        self._heartbeat(force=False)
        self.check()

    def log(self, msg: str) -> None:
        self._log_fn(f"[{self.trial_id}] {msg}")

    def check(self) -> None:
        if self._stop.is_set():
            raise TrialStopped(self.trial_id)

    # -- driver-side API -------------------------------------------------------

    def request_stop(self) -> None:
        self._stop.set()

    @property
    def latest(self) -> float | None:
        return self._latest

    def _heartbeat(self, force: bool) -> None:
        if self._client is None:
            return
        now = time.time()
        if not force and now - self._last_hb < self.hb_interval:
            return
        self._last_hb = now
        reply = self._client.call(
            "heartbeat", trial_id=self.trial_id, step=self._step, metric=self._latest
        )
        if isinstance(reply, dict) and reply.get("stop"):
            self._stop.set()

    def finalize(self, metric: float | None = None) -> None:
        if metric is not None:
            with self._lock:
                self._latest = float(metric)
        if self._client is not None:
            try:
                self._heartbeat(force=True)
            finally:
                self._client.close()
                self._client = None


class KerasBatchEnd:
    """Adapter matching the reference's ``KerasBatchEnd(reporter,
    metric=...)`` callback shape (maggy-fashion-mnist-example.ipynb:157)
    for training loops that invoke callbacks with a logs dict."""

    def __init__(self, reporter: Reporter, metric: str = "accuracy"):
        self.reporter = reporter
        self.metric = metric

    def on_batch_end(self, batch: int, logs: dict[str, Any] | None = None) -> None:
        if logs and self.metric in logs:
            self.reporter.broadcast(metric=float(logs[self.metric]), step=batch)
