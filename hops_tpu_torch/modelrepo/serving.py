"""Model serving with the TF-Serving REST contract (counterpart of
``hops_tpu/modelrepo/serving.py``).

``create_or_update(name, model_path, model_server=..., ...)`` defines an
endpoint in the project's ``Serving/servings.json``; ``start`` /
``stop`` / ``get_status`` / ``get_all`` / ``restore`` / ``reconcile``
run its lifecycle; ``make_inference_request(name, {"instances":
[...]})`` answers ``{"predictions": [...]}``, and every request and
response is tee'd onto a per-serving pubsub topic
(``get_kafka_topic``).

Each started serving is an HTTP server (:mod:`~hops_tpu_torch.runtime.httpserver`)
exposing ``POST /v1/models/<name>:predict`` (JSON, or the packed
columnar frame of :mod:`~hops_tpu_torch.runtime.wirecodec`),
``GET /v1/models/<name>``, ``GET /healthz``, ``GET /metrics`` and the
``/debug`` and ``/admin`` routes, in front of one of three predictors:

- ``LM`` — :class:`LMEnginePredictor`, the continuous-batching engine
  over an artifact of ``lm_config.json`` and ``params.npz`` (the
  TransformerLM fields and flat ``'/'``-joined flax parameter names,
  :func:`hops_tpu_torch.models.convert.save_npz`);
- ``FLAX`` — :class:`ClassifierPredictor`, a classifier bundle of
  ``classifier.json`` and ``params.npz`` (:func:`save_classifier_artifact`);
  the constant keeps its name so that one endpoint definition serves in
  both packages;
- ``PYTHON`` — :class:`PythonPredictor`, a user script's ``Predict``.

A dynamic batcher (:class:`DynamicBatcher`, ``batching_enabled``)
coalesces concurrent requests for the classifier and Python predictors.
The endpoint's ``device`` (``None``: the card) is stored in its record
and handed to the predictor: a restored or standalone endpoint runs
where its definition says, and raises where that card is missing.
``feature_config`` wraps the built predictor in the feature store's
serving-time join (:class:`~hops_tpu_torch.featurestore.online_serving.FeatureJoinPredictor`),
under the batcher: requests carry entity IDs, and a coalesced batch of
them becomes one multi-get of the sharded online store.
"""

from __future__ import annotations

import contextlib
import fcntl
import importlib.util
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from hops_tpu_torch.messaging import pubsub
from hops_tpu_torch.models.convert import flatten, load_npz, params_from_flax, save_npz
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo import registry
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.runtime import faultinject, flight, fs, qos, wirecodec
from hops_tpu_torch.runtime.devices import default_device, resolve_device
from hops_tpu_torch.runtime.httpserver import HTTPServer
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.runtime.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    with_deadline,
)
from hops_tpu_torch.telemetry import export as telemetry_export
from hops_tpu_torch.telemetry import tracing
from hops_tpu_torch.telemetry import workload
from hops_tpu_torch.telemetry.metrics import RATIO_BUCKETS, REGISTRY
from hops_tpu_torch.telemetry.spans import span

log = get_logger(__name__)

FLAX = "FLAX"  # a classifier bundle (ClassifierPredictor)
PYTHON = "PYTHON"
LM = "LM"  # continuous-batching text generation (lm_engine.LMEngine)
TENSORFLOW_SERVING = FLAX

_servers: dict[str, "_RunningServing"] = {}  # guarded by: _lock
_lock = threading.Lock()
#: Names whose _RunningServing is mid-construction (single-flight):
#: the constructing thread holds the name here — NOT _lock — while it
#: loads the model, so unrelated start()/stop()/status calls never queue
#: behind a model load. The Event is set when construction ends (either
#: way).
_starting: dict[str, threading.Event] = {}  # guarded by: _lock


def _servings_file() -> Path:
    p = Path(fs.project_path("Serving"))
    p.mkdir(parents=True, exist_ok=True)
    return p / "servings.json"


@contextlib.contextmanager
def _registry_lock():
    """Cross-process lock for registry read-modify-write cycles.

    Atomic replace in _save_registry keeps READERS consistent, but two
    processes interleaving load-modify-save (a supervisor reviving A
    while a notebook stops B) would lose updates without this.
    """
    lockfile = _servings_file().with_suffix(".lock")
    with open(lockfile, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _load_registry() -> dict[str, dict[str, Any]]:
    f = _servings_file()
    return json.loads(f.read_text()) if f.exists() else {}


def _save_registry(reg: dict[str, dict[str, Any]]) -> None:
    # Atomic replace: standalone starts and supervisors poll this file
    # from other processes at 10 Hz.
    f = _servings_file()
    tmp = f.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(reg, indent=2, default=str))
    os.replace(tmp, f)


# -- artifacts ----------------------------------------------------------------


def save_lm_artifact(
    artifact_dir: str | Path, lm_config: Mapping[str, Any], params: Mapping[str, Any]
) -> Path:
    """Write ``lm_config.json`` and ``params.npz`` into ``artifact_dir``."""
    artifact_dir = Path(artifact_dir)
    artifact_dir.mkdir(parents=True, exist_ok=True)
    (artifact_dir / "lm_config.json").write_text(json.dumps(dict(lm_config), indent=1))
    save_npz(artifact_dir / "params.npz", params)
    return artifact_dir


def load_lm_artifact(artifact_dir: str | Path, device: torch.device,
                     **changes: Any) -> TransformerLM:
    """The artifact's TransformerLM on ``device``, with ``changes``
    applied to its fields."""
    artifact_dir = Path(artifact_dir)
    cfg = json.loads((artifact_dir / "lm_config.json").read_text())
    module = TransformerLM(**{**cfg, **changes}, device=device)
    return module.load_flax(load_npz(artifact_dir / "params.npz"))


def _classifier_classes() -> dict[str, Any]:
    from hops_tpu_torch.models import mnist, resnet

    return {"CNN": mnist.CNN, "FFN": mnist.FFN, "ResNet": resnet.ResNet}


def _field(value: Any) -> Any:
    """A constructor field as JSON: numbers, strings, lists, and a dtype
    (numpy's, JAX's or torch's) by its name."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_field(v) for v in value]
    if isinstance(value, torch.dtype):
        return str(value).rsplit(".", 1)[-1]
    try:
        return np.dtype(value).name
    except TypeError:
        raise ValueError(f"cannot store constructor field {value!r}") from None


def save_classifier_artifact(
    artifact_dir: str | Path, module: str, fields: Mapping[str, Any],
    variables: Mapping[str, Any],
) -> Path:
    """Write a classifier bundle into ``artifact_dir``: ``classifier.json``
    (the module's class name, ``CNN``, ``FFN`` or ``ResNet``, and its
    constructor fields) and ``params.npz`` (the flax-named weights,
    ``batch_stats`` merged in, as
    :func:`~hops_tpu_torch.models.convert.flatten` writes them).

    ``variables`` is a JAX module's ``{"params": ..., "batch_stats":
    ...}`` trees as numpy arrays (the ``params`` and ``extra_variables``
    of a ``save_flax`` bundle), or
    :func:`~hops_tpu_torch.models.convert.params_to_flax` of a port
    module. ``fields`` are the JAX module's dataclass fields (flax's own
    ``parent`` and ``name`` are dropped); the inputs' widths, which the
    JAX modules read off their first batch, are read off the weights."""
    classes = _classifier_classes()
    if module not in classes:
        raise ValueError(f"unknown classifier module {module!r} (one of {sorted(classes)})")
    flat = flatten(variables)
    kw = {k: _field(v) for k, v in fields.items() if k not in ("parent", "name")}
    if module == "CNN":
        kw["in_channels"] = int(flat["Conv_0/kernel"].shape[2])  # HWIO
        kw["image_size"] = 4 * math.isqrt(int(flat["Dense_0/kernel"].shape[0]) // 64)
    elif module == "FFN":
        kw["in_features"] = int(flat["Dense_0/kernel"].shape[0])
    else:
        kw["in_channels"] = int(flat["stem_conv"].shape[2])
    artifact_dir = Path(artifact_dir)
    artifact_dir.mkdir(parents=True, exist_ok=True)
    (artifact_dir / "classifier.json").write_text(
        json.dumps({"module": module, "fields": kw}, indent=1))
    save_npz(artifact_dir / "params.npz", flat)
    return artifact_dir


def load_classifier_artifact(artifact_dir: str | Path,
                             device: str | torch.device | None) -> torch.nn.Module:
    """The bundle's classifier on ``device`` (``None``: the card), in
    eval mode (BatchNorm normalizes by its running statistics)."""
    artifact_dir = Path(artifact_dir)
    spec = json.loads((artifact_dir / "classifier.json").read_text())
    model = _classifier_classes()[spec["module"]](**spec["fields"], device=device)
    model.load_state_dict(params_from_flax(artifact_dir / "params.npz"))
    return model.eval()


# -- predictors ---------------------------------------------------------------


class ClassifierPredictor:
    """Serves a classifier bundle (:func:`save_classifier_artifact`) —
    the counterpart of the JAX package's ``FlaxPredictor``.

    Batch sizes are bucketed to the next power of two (padded with the
    first row, result sliced back), as ``FlaxPredictor`` does: the model
    runs in eval mode, so a pad row changes no other row's logits.
    The forward runs under ``torch.inference_mode()``, entered in the
    thread that calls :meth:`predict` (the batcher's, or a handler's
    when batching is off). Predictions are fp32 logits as host lists.
    """

    def __init__(self, artifact_dir: str | Path, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = load_classifier_artifact(artifact_dir, self.device)

    def predict(self, instances: Any) -> list[Any]:
        n = len(instances)
        if n == 0:
            return []
        bucket = 1 << max(0, (n - 1)).bit_length()
        # Row 0 converts first to learn the row shape (and to fail on
        # malformed input before the batch is assembled).
        row0 = np.asarray(instances[0], dtype=np.float32)
        x = np.empty((bucket, *row0.shape), np.float32)
        x[0] = row0
        if n > 1:
            x[1:n] = instances[1:]
        if bucket != n:
            x[n:] = row0  # pad rows: any valid row keeps the bucket's shape
        with torch.inference_mode():
            logits = self.model(torch.from_numpy(x).to(self.device))[:n]
            return logits.to("cpu", torch.float32).tolist()


class PythonPredictor:
    """Loads a user script defining ``class Predict`` with
    ``__init__/predict`` (and optionally ``classify``/``regress``) —
    the reference's Python-model-server contract."""

    def __init__(self, script_path: Path):
        spec = importlib.util.spec_from_file_location("hops_tpu_torch_predictor", script_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self._impl = mod.Predict()

    def predict(self, instances: list[Any]) -> list[Any]:
        return self._impl.predict(instances)


class LMEnginePredictor:
    """Continuous-batching text generation behind the serving contract.

    Loads the artifact's TransformerLM with ``ragged_decode=True`` onto
    ``device`` (``None`` = the card) and drives an :class:`LMEngine` from
    a single driver thread. Callers of :meth:`predict` submit requests
    and sleep on a condition variable; every engine iteration serves all
    live requests in one decode step.

    Instance format: ``{"prompt": [ids], "max_new_tokens": 32,
    "eos_id": null, "temperature": 0.0, "top_k": null, "top_p": null,
    "seed": 0}`` (a bare token list is shorthand for just the prompt).
    Predictions are generated-token lists, prompt excluded.

    ``lm_config`` holds the engine options: ``slots`` (default 4),
    ``prefill_buckets``, ``max_queue``, ``decode_horizon``,
    ``kv_cache_dtype`` (``"int8"``: the quantized KV cache, for the
    target and the draft), the paged cache with chunked prefill
    (``kv_page_size``, ``kv_pool_blocks``, ``prefill_chunk``),
    speculative decoding (``draft_model``: a registry name, resolved in
    the current project, ``draft_version``, default the newest, and
    ``spec_k``, default 4), ``prefixes`` (``{name: [ids]}``, registered at
    start; an instance opts in with ``"prefix_id"``) and
    ``brownout_max_new_tokens`` (default 16: under a brownout at
    :data:`~hops_tpu_torch.runtime.qos.DEGRADE` or above, decode budgets
    are clamped to it). Each request is admitted at the priority class of
    the caller's :func:`~hops_tpu_torch.runtime.qos.priority_scope`.
    """

    def __init__(
        self,
        artifact_dir: str | Path,
        lm_config: Mapping[str, Any] | None = None,
        device: str | torch.device | None = None,
    ):
        cfg = dict(lm_config or {})
        device = resolve_device(device)
        cache = {"ragged_decode": True}
        if cfg.get("kv_cache_dtype"):
            cache["kv_cache_dtype"] = str(cfg["kv_cache_dtype"])
        module = load_lm_artifact(artifact_dir, device, **cache)
        draft = None
        if cfg.get("draft_model"):
            draft_dir = registry.lm_artifact(cfg["draft_model"], cfg.get("draft_version"))
            draft = load_lm_artifact(draft_dir, device, **cache)

        def optional_int(key):
            return int(cfg[key]) if cfg.get(key) else None

        self._engine = LMEngine(
            module,
            slots=int(cfg.get("slots", 4)),
            prefill_buckets=(
                tuple(cfg["prefill_buckets"]) if "prefill_buckets" in cfg else None
            ),
            decode_horizon=int(cfg.get("decode_horizon", 1)),
            draft_model=draft,
            spec_k=int(cfg.get("spec_k", 4)),
            kv_page_size=optional_int("kv_page_size"),
            kv_pool_blocks=optional_int("kv_pool_blocks"),
            prefill_chunk=optional_int("prefill_chunk"),
            max_queue=int(cfg.get("max_queue", 1024)),
            device=device,
        )
        for name, tokens in (cfg.get("prefixes") or {}).items():
            self._engine.register_prefix(name, tokens)
        self._brownout_max_new = int(cfg.get("brownout_max_new_tokens", 16))
        #: Time to first token (seconds) of each instance of the last
        #: :meth:`predict` call, in instance order.
        self.last_ttft_s: list[float | None] = []
        self._cv = threading.Condition()
        self._stopping = False  # guarded by: self._cv
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def engine(self) -> LMEngine:
        return self._engine

    def _loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._stopping and not self._engine.has_work:
                        self._cv.wait()
                    if self._stopping:
                        return
                    # The step runs under the lock: admissions land only
                    # at iteration boundaries anyway, and waiters wake the
                    # moment their ticket finishes — or fails.
                    if self._engine.step() or self._engine.has_failures:
                        self._cv.notify_all()
        except BaseException:
            # A dying driver thread must fail the waiters, not strand them.
            with self._cv:
                self._stopping = True
                self._cv.notify_all()
            log.exception("LM engine driver thread died")
            raise

    def stats(self) -> dict[str, Any]:
        with self._cv:
            return self._engine.stats()

    @staticmethod
    def _parse(instance: Any) -> dict[str, Any]:
        if isinstance(instance, dict):
            return {
                "prompt": instance["prompt"],
                "max_new_tokens": int(instance.get("max_new_tokens", 32)),
                "eos_id": instance.get("eos_id"),
                "temperature": float(instance.get("temperature", 0.0)),
                "top_k": instance.get("top_k"),
                "top_p": instance.get("top_p"),
                "seed": int(instance.get("seed", 0)),
                "prefix_id": instance.get("prefix_id"),
            }
        return {"prompt": instance}

    def predict(self, instances: list[Any]) -> list[Any]:
        parsed = [self._parse(i) for i in instances]
        # The caller's class orders admission; a brownout shortens
        # answers rather than shedding them.
        priority = qos.request_priority()
        degrade = qos.brownout_level() >= qos.DEGRADE
        for kw in parsed:
            kw["priority"] = priority
            if degrade:
                kw["max_new_tokens"] = max(1, min(kw.get("max_new_tokens", 32),
                                                  self._brownout_max_new))
        # The engine steps on its driver thread: each ticket's submit-to-
        # finish window is recorded under this request's trace once the
        # results are in, with the engine's marks of where it waited.
        trace_ctx = tracing.current_context()
        t_submit = time.time()
        with self._cv:
            if self._stopping:
                raise RuntimeError("serving stopped")
            # All-or-nothing submission: the cancels are exact because the
            # driver thread steps under this same lock.
            tickets: list[int] = []
            try:
                for kw in parsed:
                    tickets.append(self._engine.submit(**kw))
            except Exception:
                for t in tickets:
                    self._engine.cancel(t)
                raise
            self._cv.notify_all()
            while any(
                self._engine.result(t) is None and self._engine.error(t) is None
                for t in tickets
            ):
                if self._stopping:
                    for t in tickets:
                        self._engine.take_result(t)
                        self._engine.take_error(t)
                    raise RuntimeError("serving stopped")
                self._cv.wait()
            self.last_ttft_s = [self._engine.ttft_s.get(t) for t in tickets]
            times = [self._engine.request_times(t) for t in tickets]
            errors = [self._engine.take_error(t) for t in tickets]
            results = [self._engine.take_result(t) for t in tickets]
            if trace_ctx is not None:
                self._record_dispatch(trace_ctx, t_submit, tickets, results, errors, times)
            first = next((e for e in errors if e is not None), None)
            if first is not None:
                raise RuntimeError(
                    f"lm engine step failed for this request: {type(first).__name__}: {first}"
                ) from first
            return results

    def _record_dispatch(self, ctx, t_submit: float, tickets: list[int], results: list,
                         errors: list, times: list) -> None:
        """One ``lm_engine.dispatch`` span per ticket under the request's
        trace: ``tokens``, ``ttft_ms``, the engine's ``queue_wait_ms`` and
        ``first_token_hold_ms``, and ``error`` on failure."""
        dur = time.time() - t_submit
        for t, ttft, res, err, tm in zip(tickets, self.last_ttft_s, results, errors, times):
            attrs: dict[str, Any] = {"ticket": t, "tokens": len(res) if res is not None else 0}
            if ttft is not None:
                attrs["ttft_ms"] = round(ttft * 1e3, 3)
            if tm is not None:
                attrs["queue_wait_ms"] = round(tm["queue_wait_s"] * 1e3, 3)
                if tm["first_token_hold_s"] is not None:
                    attrs["first_token_hold_ms"] = round(tm["first_token_hold_s"] * 1e3, 3)
            if err is not None:
                attrs["error"] = type(err).__name__
            tracing.record_span("lm_engine.dispatch", ctx, t_submit, dur, **attrs)

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


def _build_predictor(cfg: dict[str, Any]) -> Any:
    artifact_dir = Path(cfg["artifact_path"])
    # A record written without a device serves on the card.
    device = cfg.get("device")
    if cfg["model_server"] == LM:
        return LMEnginePredictor(artifact_dir, cfg.get("lm_config"), device=device)
    if cfg["model_server"] == PYTHON:
        scripts = sorted(artifact_dir.rglob("*.py"))
        if not scripts:
            raise FileNotFoundError(f"no predictor script under {artifact_dir}")
        # The predictor is the script defining `class Predict` (the
        # reference's contract) — helper modules may sit alongside it.
        with_predict = [s for s in scripts if "class Predict" in s.read_text()]
        if not with_predict:
            raise FileNotFoundError(
                f"no script under {artifact_dir} defines `class Predict`"
            )
        return PythonPredictor(with_predict[0])
    return ClassifierPredictor(artifact_dir, device=device)


# -- dynamic batching ---------------------------------------------------------


class DynamicBatcher:
    """Server-side request batching (TF-Serving's ``enable_batching``).

    Concurrent requests are coalesced: the batcher thread collects
    instances arriving within ``timeout_ms`` of the first, up to
    ``max_batch_size`` rows, runs ONE ``predict_fn`` over the
    concatenation, and splits the predictions back per request: N
    concurrent batch-1 forwards become one batch-N forward, matrix
    products instead of matrix-vector products. Exceptions
    from ``predict_fn`` propagate to every waiting request of that
    batch; later batches are unaffected.

    Requests never merge past ``max_batch_size`` (a request that would
    overflow the cap seeds the next batch instead); a SINGLE request
    larger than the cap runs alone, unsplit — the caller chose that
    batch shape explicitly.
    """

    def __init__(self, predict_fn, max_batch_size: int = 64,
                 timeout_ms: float = 5.0, model: str = "",
                 queue_bound: int = 1024, starvation_limit: int = 8):
        self._predict = predict_fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_ms / 1e3
        # Priority-aware and HARD-bounded (the unbounded-priority-queue
        # lint rule's contract): interactive requests coalesce ahead of
        # batch-class ones, FIFO within a class, batch never starves
        # (the queue's starvation guard), and a full queue sheds the
        # newest lowest-class item — its waiter gets qos.ShedError,
        # which the handler answers as a 503 shed.
        self._queue = qos.BoundedPriorityQueue(
            queue_bound, starvation_limit=starvation_limit)
        self._stop_lock = threading.Lock()
        self._stopped = False  # guarded by: self._stop_lock
        self.batches_run = 0
        self.rows_run = 0
        self._m_queue_depth = REGISTRY.gauge(
            "hops_tpu_serving_batch_queue_depth",
            "Requests waiting in the dynamic batcher",
            labels=("model",),
        ).labels(model=model)
        self._m_fill = REGISTRY.histogram(
            "hops_tpu_serving_batch_fill_ratio",
            "Rows per coalesced batch over max_batch_size",
            labels=("model",), buckets=RATIO_BUCKETS,
        ).labels(model=model)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def predict(self, instances: list[Any]) -> list[Any]:
        from concurrent.futures import Future

        fut: Future = Future()
        # The handler thread's trace context rides along so the batcher
        # thread can attribute queue-wait and the shared batch-compute
        # time back to THIS request's trace (queue vs compute split).
        item = (list(instances), fut, tracing.current_context(),
                time.monotonic(), time.time())
        # Check-and-enqueue is atomic with stop()'s flag-and-sentinel:
        # every item the queue ever holds precedes the sentinel, so the
        # loop (or its stop-time drain) resolves every future — no
        # handler can block forever on a straggler enqueued after it.
        # (The sentinel rides the negative control lane, which get()
        # serves first — its short-circuit drain still answers every
        # queued item, whatever class order says.)
        with self._stop_lock:
            if self._stopped:
                raise RuntimeError("serving stopped")
            evicted = self._queue.put(
                item, rank=qos.rank(qos.request_priority()))
        if evicted is not None:
            # Shed-lowest-first under a full queue: the evicted waiter
            # is answered NOW (503 at the handler), not left to starve.
            evicted[1].set_exception(
                qos.ShedError("shed from the batch queue by "
                              "higher-priority work"))
        self._m_queue_depth.set(self._queue.qsize())
        return fut.result()

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
            self._queue.put(None, rank=-1)  # control lane: served first
        self._thread.join(timeout=30)
        # The enqueue lock means nothing lands after the sentinel: once
        # the loop thread exits, every queued future has been resolved.
        # _drain_and_fail is belt-and-braces for the timeout path only.
        if self._thread.is_alive():
            log.warning("dynamic batcher stop: drain still running after "
                        "30s; leaving it to finish")
            return
        self._drain_and_fail()

    def _loop(self) -> None:
        import queue
        import time as _time

        carry = None  # a request that didn't fit the previous batch
        while True:
            item = carry if carry is not None else self._queue.get()
            carry = None
            if item is None:
                self._run_remaining()
                return
            pending = [item]
            rows = len(item[0])
            deadline = _time.monotonic() + self.timeout_s
            while rows < self.max_batch_size:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run(pending)
                    self._run_remaining()
                    return
                if rows + len(nxt[0]) > self.max_batch_size:
                    carry = nxt  # seed of the NEXT batch; cap respected
                    break
                pending.append(nxt)
                rows += len(nxt[0])
            self._run(pending)

    def _run_remaining(self) -> None:
        """Stop-time drain: work that was already QUEUED when the stop
        sentinel landed still gets its answer (replica drains complete
        queued requests before the predictor is torn down — the fleet
        rollout's zero-downtime contract); only stragglers that raced
        in after the drain are failed."""
        import queue

        pending: list = []
        rows = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            if pending and rows + len(item[0]) > self.max_batch_size:
                self._run(pending)
                pending, rows = [], 0
            pending.append(item)
            rows += len(item[0])
        if pending:
            self._run(pending)
        self._drain_and_fail()

    def _drain_and_fail(self) -> None:
        import queue

        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].set_exception(RuntimeError("serving stopped"))

    def _run(self, pending) -> None:
        flat = [row for instances, *_ in pending for row in instances]
        self._m_queue_depth.set(self._queue.qsize())
        # An over-cap single request runs alone, unsplit — clamp so the
        # ratio histogram stays in [0, 1].
        self._m_fill.observe(min(len(flat) / self.max_batch_size, 1.0))
        # Trace attribution for the coalesced batch: the predict runs
        # ONCE for every queued request, under the first traced
        # request's context (its trace carries the real compute span
        # and any children the predictor emits, e.g. the feature
        # join); every other traced request gets the same compute
        # window recorded retroactively, all linked by `batch`, and
        # every traced request gets its own queue-wait span — the
        # queue-wait vs compute split, per request.
        carrier = next(
            (it[2] for it in pending if it[2] is not None and it[2].sampled),
            None,
        )
        t_run_mono, t_run_wall = time.monotonic(), time.time()
        error: Exception | None = None
        preds = None
        with tracing.use_context(carrier):
            cspan = tracing.child_span(
                "serving.batch.compute",
                rows=len(flat), requests=len(pending), shared=True,
            )
            try:
                with cspan:
                    preds = self._predict(flat)
            except Exception as e:  # noqa: BLE001 — fail THIS batch only
                error = e
        batch_id = cspan.span_id or None
        compute_s = time.monotonic() - t_run_mono
        for instances, fut, ctx, enq_mono, enq_wall in pending:
            if ctx is None:
                continue
            tracing.record_span(
                "serving.batch.queue_wait", ctx, enq_wall,
                max(0.0, t_run_mono - enq_mono), batch=batch_id,
            )
            if ctx is not carrier:
                attrs = {"batch": batch_id, "rows": len(flat),
                         "requests": len(pending), "shared": True}
                if error is not None:
                    attrs["error"] = f"{type(error).__name__}: {error}"
                tracing.record_span(
                    "serving.batch.compute", ctx, t_run_wall, compute_s,
                    **attrs,
                )
        if error is not None:
            for _, fut, *_rest in pending:
                fut.set_exception(error)
            return
        self.batches_run += 1
        self.rows_run += len(flat)
        start = 0
        for instances, fut, *_rest in pending:
            fut.set_result(preds[start:start + len(instances)])
            start += len(instances)


# -- the HTTP server ----------------------------------------------------------


class _InflightSlot:
    """One admitted unit of the ``max_inflight`` budget.

    The cap bounds concurrent PREDICTOR executions, not handler
    threads: when a deadline abandons a predict still running on its
    worker thread, the slot must stay held until that work actually
    finishes — releasing it at handler exit would admit new requests
    on top of zombie computations, the exact overload the shedder
    exists to prevent. Ownership: the handler releases by default
    (:meth:`release`); once :meth:`transfer` hands the slot to the
    predict worker, only the worker's ``release(from_worker=True)``
    frees it. Idempotent either way."""

    __slots__ = ("_running", "_lock", "_released", "_transferred")

    def __init__(self, running: "_RunningServing"):
        self._running = running
        self._lock = threading.Lock()
        self._released = False  # guarded by: self._lock
        self._transferred = False  # guarded by: self._lock

    def transfer(self) -> None:
        with self._lock:
            self._transferred = True

    def release(self, from_worker: bool = False) -> None:
        with self._lock:
            if self._released or (self._transferred and not from_worker):
                return
            self._released = True
        self._running._exit()


class _RunningServing:
    def __init__(self, cfg: dict[str, Any]):
        self.cfg = cfg
        self.predictor = _build_predictor(cfg)
        if cfg.get("feature_config"):
            # Serving-time feature joins: requests carry entity IDs
            # only; the wrapper multi-gets the configured feature
            # groups' online rows, assembles model-ready vectors, and
            # feeds the real predictor. Sits UNDER the DynamicBatcher,
            # so coalesced entity batches become one batched join.
            from hops_tpu_torch.featurestore.online_serving import FeatureJoinPredictor

            self.predictor = FeatureJoinPredictor(
                self.predictor, cfg["feature_config"], model=cfg["name"]
            )
        self.producer = pubsub.Producer(cfg["topic"])
        name = cfg["name"]
        # Overload protection + failure gating (docs/operations.md
        # "Failure handling"): a queue-depth shedder (in-flight handler
        # threads over `max_inflight` get 503 + Retry-After instead of
        # queueing into a latency collapse), a per-request deadline,
        # and a circuit breaker that fails fast — and flips /healthz
        # unready — while the predictor is down rather than flaky.
        rcfg = cfg.get("resilience_config") or {}
        self.max_inflight = rcfg.get("max_inflight")
        self.deadline_s = rcfg.get("deadline_s")
        # Shed-lowest-class-first: batch traffic stops being admitted
        # once in-flight work crosses this fraction of max_inflight —
        # the headroom above it is reserved for interactive requests.
        self.batch_admit_frac = float(rcfg.get("batch_admit_frac", 0.75))
        self.breaker = CircuitBreaker(
            name=f"serving-{name}",
            failure_threshold=int(rcfg.get("breaker_failures", 5)),
            reset_timeout_s=float(rcfg.get("breaker_reset_s", 30.0)),
        )
        self._inflight_lock = threading.Lock()
        self._inflight = 0  # guarded by: self._inflight_lock
        self._draining = False  # guarded by: self._inflight_lock
        # The fleet router's least-loaded signal: live predictor
        # executions on THIS endpoint, scraped from /metrics.json.
        self._m_inflight = REGISTRY.gauge(
            "hops_tpu_serving_inflight",
            "Concurrent predictor executions in flight, per endpoint",
            labels=("model",),
        ).labels(model=name)
        self.batcher = None
        if cfg.get("batching_enabled"):
            bc = cfg.get("batching_config") or {}
            self.batcher = DynamicBatcher(
                self.predictor.predict,
                max_batch_size=int(bc.get("max_batch_size", 64)),
                timeout_ms=float(bc.get("timeout_ms", 5.0)),
                model=name,
                queue_bound=int(bc.get("queue_bound", 1024)),
                starvation_limit=int(bc.get("starvation_limit", 8)),
            )
        predictor = self.batcher or self.predictor
        raw_predictor = self.predictor
        producer = self.producer
        # Per-endpoint request telemetry (the reference's per-serving
        # Kafka metrics role): counters + the latency histogram the
        # `/metrics` route on THIS server's port exposes.
        m_requests = REGISTRY.counter(
            "hops_tpu_serving_requests_total",
            "Predict requests received, per serving endpoint",
            labels=("model",),
        ).labels(model=name)
        m_errors = REGISTRY.counter(
            "hops_tpu_serving_errors_total",
            "Predict requests that raised, per serving endpoint",
            labels=("model",),
        ).labels(model=name)
        m_logged = REGISTRY.counter(
            "hops_tpu_serving_inference_log_total",
            "Request/response pairs tee'd onto the serving's pubsub topic",
            labels=("model",),
        ).labels(model=name)
        m_shed = REGISTRY.counter(
            "hops_tpu_serving_shed_total",
            "Requests shed with 503, per serving endpoint and reason "
            "(overload | breaker | draining | qos — batch class shed "
            "first under load or evicted from the batch queue)",
            labels=("model", "reason"),
        )
        m_gen_rejected = REGISTRY.counter(
            "hops_tpu_fleet_generation_rejected_total",
            "Requests refused with a typed 410 because they stamped a "
            "generation newer than the unit's own — a superseded zombie "
            "fenced at the data plane, per unit kind",
            labels=("kind",),
        )
        # Placement identity (minted by the PlacementClient, carried in
        # cfg): this unit's own (slot, generation) token, compared
        # against the X-Hops-Generation stamp on every predict.
        unit_token = (f"{cfg['slot']}:{int(cfg.get('generation', 0))}"
                      if cfg.get("slot") else None)
        running = self
        breaker = self.breaker

        def _np_native(obj: Any):
            # A packed request hands the predictor an ndarray; a user
            # predictor may echo numpy scalars/arrays back into a JSON
            # (non-negotiated) response. Only invoked on non-native
            # objects, so the plain-JSON path pays nothing.
            if hasattr(obj, "tolist"):
                return obj.tolist()
            if hasattr(obj, "item"):
                return obj.item()
            raise TypeError(
                f"not JSON serializable: {type(obj).__name__}")

        def _json(code: int, body: dict[str, Any],
                  extra: dict[str, str] | None = None):
            h = {"Content-Type": "application/json"}
            if extra:
                h.update(extra)
            # JSON is the default wire format; errors, debug timelines,
            # and non-negotiated responses are spec'd to serialize here.
            return code, h, json.dumps(body, default=_np_native).encode()  # graftlint: disable=json-on-hot-wire

        def _maybe_debug(headers: Any, body: dict[str, Any],
                         tspan: Any) -> dict[str, Any]:
            """Attach the inline per-hop timing breakdown when the
            request asked for it (``X-Hops-Debug: timeline``) and this
            request is traced — the router merges its own hops into the
            same list on the way back out."""
            want = headers.get(tracing.DEBUG_HEADER, "")
            if want.strip().lower() == "timeline":
                rows = tracing.timeline(tspan)
                if rows:
                    body["debug"] = {
                        "trace_id": rows[0]["trace_id"],
                        "timeline": rows,
                    }
            return body

        def _do_get(path: str, headers: Any):
            # TF-Serving's model-status contract
            # (GET /v1/models/<name>), extended with live engine
            # telemetry when the predictor exposes stats() — the
            # LM engine's dispatches, occupancy, prefix hits, and
            # speculation acceptance.
            try:
                # Prometheus scrape rides the serving's own port
                # (GET /metrics, GET /metrics.json) — the whole
                # process's registry, not just this endpoint. The
                # debug surfaces (/debug/traces, /debug/flight)
                # ride the same port: this process's span ring and
                # flight recorder.
                resp = telemetry_export.metrics_response(path)
                if resp is None:
                    resp = telemetry_export.debug_response(path)
                if resp is not None:
                    return resp
                # Readiness: load balancers and supervisors poll
                # this; an open breaker = the predictor is down,
                # stop routing here until the half-open probe heals.
                # A DRAINING endpoint is also unready (503 +
                # Retry-After) and reports its in-flight count, so
                # a rollout can gate the reap on inflight == 0 off
                # the same probe the router stops routing on.
                if path.rstrip("/") == "/healthz":
                    bstate = breaker.state
                    if running.draining:
                        return _json(
                            503,
                            {"status": "draining", "breaker": bstate,
                             "inflight": running.inflight},
                            extra={"Retry-After": "1"},
                        )
                    if bstate == "open":
                        retry = max(1.0, breaker.retry_after_s())
                        return _json(
                            503,
                            {"status": "unready", "breaker": bstate},
                            extra={"Retry-After": f"{retry:.0f}"},
                        )
                    return _json(200, {"status": "ok", "breaker": bstate})
                # Exact TF-Serving routes only: /v1/models/<name>
                # and the versioned /v1/models/<name>/versions/<N>
                # form (a suffix match would accept arbitrary
                # prefixes like /junk/v1/models/<name>).
                p = path.rstrip("/")
                base = f"/v1/models/{name}"
                versioned = p.startswith(base + "/versions/")
                if versioned:
                    ver = p[len(base) + len("/versions/"):]
                    if ver != str(cfg.get("model_version", 1)):
                        return _json(404, {"error": f"unknown version {ver}"})
                elif p != base:
                    return _json(404, {"error": f"unknown path {path}"})
                body: dict[str, Any] = {
                    "model_version_status": [{
                        "version": str(cfg.get("model_version", 1)),
                        "state": "AVAILABLE",
                    }],
                }
                if hasattr(raw_predictor, "stats"):
                    body["engine"] = raw_predictor.stats()
                return _json(200, body)
            except Exception as e:  # noqa: BLE001 — server must stay up
                return _json(500, {"error": f"{type(e).__name__}: {e}"})

        def _predict_resp(headers: Any, payload: dict[str, Any],
                          instances: list[Any], slot: _InflightSlot,
                          tspan: Any):
            # Breaker check after shedding: an open breaker means
            # the predictor itself is failing — don't waste a
            # half-open probe on a request we'd shed anyway.
            if not breaker.allow():
                m_shed.inc(model=name, reason="breaker")
                tspan.annotate(shed="breaker")
                retry = max(1.0, breaker.retry_after_s())
                return _json(
                    503,
                    {"error": "circuit open; predictor failing"},
                    extra={"Retry-After": f"{retry:.0f}"},
                )
            try:
                # span() records into the request-latency histogram
                # even when predict raises — error latency is
                # latency; the error counter increments below.
                with span("hops_tpu_serving_request", model=name):
                    # Chaos point, keyed by this endpoint's port so
                    # a gray (slow-not-dead) fault can target ONE
                    # replica of an in-process fleet.
                    faultinject.fire("serving.handle", key=running.port)
                    if running.deadline_s:
                        # The worker owns the slot from here: a
                        # deadline overrun abandons the predict but
                        # its computation still occupies predictor
                        # capacity until it actually finishes.
                        slot.transfer()

                        def predict_holding_slot(rows):
                            try:
                                return predictor.predict(rows)
                            finally:
                                slot.release(from_worker=True)

                        preds = with_deadline(
                            predict_holding_slot, running.deadline_s,
                            instances, op="serving.handle")
                    else:
                        preds = predictor.predict(instances)
            except qos.ShedError as e:
                # Evicted from the batch queue by higher-priority
                # work (reason="qos") or refused at a full submit
                # queue (QueueFullError, reason="overload"): a
                # shed, not a failure — no breaker strike, same
                # 503 retry shape as every other shed.
                reason = (
                    "overload" if isinstance(e, qos.QueueFullError)
                    else "qos"
                )
                m_shed.inc(model=name, reason=reason)
                tspan.annotate(shed=reason)
                return _json(
                    503, _maybe_debug(
                        headers, {"error": f"{type(e).__name__}: {e}"}, tspan),
                    extra={"Retry-After": "1"},
                )
            except DeadlineExceeded as e:
                breaker.record_failure()
                m_errors.inc()
                return _json(504, _maybe_debug(
                    headers, {"error": f"{type(e).__name__}: {e}"}, tspan))
            except Exception as e:  # noqa: BLE001 — fail THIS request
                breaker.record_failure()
                m_errors.inc()
                return _json(500, _maybe_debug(
                    headers, {"error": f"{type(e).__name__}: {e}"}, tspan))
            breaker.record_success()
            response = {"predictions": preds}
            producer.send(
                {"request": payload, "response": response}, key=name
            )
            m_logged.inc()
            body = _maybe_debug(headers, response, tspan)
            if ("debug" not in body
                    and wirecodec.MEDIA_TYPE in (headers.get("Accept") or "")):
                # Accept-negotiated packed response. Debug timelines
                # always ride JSON (the router merges its hops into the
                # body); ragged/object predictions fall back to JSON
                # too — exactness over format.
                frame = wirecodec.try_encode_predictions(preds)
                if frame is not None:
                    return 200, {"Content-Type": wirecodec.MEDIA_TYPE}, frame
            return _json(200, body)

        def _do_post_inner(path: str, headers: Any, raw_body: bytes,
                           cap: dict[str, Any]):
            # Workload-capture control plane (arm / finalize the
            # process-global recorder; status rides GET
            # /debug/workload). Checked BEFORE the strict body parse
            # so a sloppy body degrades to {} — the same tolerant
            # contract as the router's route (a capture/stop must not
            # fail on replicas while succeeding on the front door).
            if path.split("?", 1)[0].rstrip("/").startswith(
                    "/admin/capture/"):
                try:
                    # Capture control plane, tolerant parse; not the
                    # data wire.
                    admin_payload = json.loads(raw_body)  # graftlint: disable=json-on-hot-wire
                except ValueError:
                    admin_payload = {}
                return _json(*workload.admin_action(path, admin_payload))
            # Fleet control plane: flip this endpoint into the
            # draining state (rollouts, scale-downs). Replies with
            # the in-flight count the caller will poll to zero on
            # /healthz before reaping. Checked before the body parse —
            # a drain must succeed whatever the body carries.
            if path.rstrip("/") == "/admin/drain":
                inflight = running.drain()
                return _json(200, {"status": "draining",
                                   "inflight": inflight})
            # Exact route, like GET: a suffix match would accept
            # /junk/v1/models/<name>:predict.
            if path.rstrip("/") != f"/v1/models/{name}:predict":
                return _json(404, {"error": f"unknown path {path}"})
            # Fencing gate (docs/operations.md "Partition tolerance &
            # fencing"): forwarders stamp the slot's CURRENT generation
            # on X-Hops-Generation; a mismatch means THIS unit has been
            # superseded (re-placed while it was partitioned) and must
            # refuse — typed 410, which the router retries on the live
            # generation without a breaker strike. Checked before
            # admission/parse: a zombie must not even shed or predict.
            stamped = headers.get("X-Hops-Generation")
            if stamped and unit_token and stamped != unit_token:
                m_gen_rejected.inc(kind="replica")
                flight.record("generation_rejected", unit_kind="replica",
                              model=name, slot=cfg.get("slot"),
                              have=unit_token, got=stamped)
                return _json(410, {"error": "superseded generation",
                                   "slot": cfg.get("slot"),
                                   "have": unit_token, "got": stamped})
            # Content-Type negotiation: the packed columnar frame
            # decodes zero-copy into the instance tensor; JSON stays
            # the default. A malformed frame fails closed with a 400
            # naming the offset — never a half-decoded batch.
            ctype = (headers.get("Content-Type") or "") \
                .split(";", 1)[0].strip().lower()
            if ctype == wirecodec.MEDIA_TYPE:
                wire_format = "packed"
                try:
                    instances = wirecodec.decode_instances(raw_body)
                except wirecodec.WireCodecError as e:
                    return _json(400, {"error": f"bad packed frame: {e}"})
                # The inference-log tee and capture tap need a
                # JSON-serializable request: a header-only shape
                # summary stands in for the tensor body.
                payload = {"format": "packed",
                           "summary": wirecodec.frame_summary(raw_body)}
            else:
                wire_format = "json"
                # The negotiated default path; packed bodies take the
                # branch above.
                payload = json.loads(raw_body)  # graftlint: disable=json-on-hot-wire
                instances = payload.get("instances")
                if instances is None:
                    return _json(400,
                                 {"error": "payload must carry 'instances'"})
            m_requests.inc()
            wirecodec.count_request(wire_format)
            if workload.capturing():
                # Arm the per-request capture tap: the route's single
                # exit records the request WITH its final status —
                # sheds, deadline 504s, and 500s included.
                cap["wire_format"] = wire_format
                if wire_format == "packed":
                    # Tensor bodies don't JSON-serialize; record the
                    # shape summary the replayer rebuilds from.
                    arr = instances
                    cap["payload"] = None
                    cap["instances"] = None
                    cap["summary"] = {
                        "bytes": len(raw_body),
                        "instances": int(arr.shape[0]) if arr.ndim else 1,
                        "instance": {"kind": "list",
                                     "shape": list(arr.shape[1:])},
                        "dtype": arr.dtype.str,
                    }
                else:
                    cap["payload"] = payload
                    cap["instances"] = instances
            # The trace enters (or starts) here: an incoming
            # `traceparent` — the fleet router injects one per
            # forward hop — makes this request span a child of
            # that hop; a bare request starts a fresh trace
            # under the tracer's sampling decision.
            # QoS: the fleet router stamps the RESOLVED class
            # on its forwards (clients of a bare endpoint may
            # also claim one); a relayed brownout level is
            # adopted with a TTL under THIS model's scope so the
            # replica degrades with its fleet — and only its
            # fleet, on a host serving several.
            priority = qos.parse_priority(headers.get(qos.PRIORITY_HEADER))
            qos.note_remote_brownout(headers.get(qos.BROWNOUT_HEADER),
                                     scope=name)
            want_debug = (
                headers.get(tracing.DEBUG_HEADER) or ""
            ).strip().lower() == "timeline"
            tspan = tracing.start_trace(
                "serving.request", headers=headers, model=name,
                force_sample=want_debug)
            if cap:
                cap["tspan"] = tspan
            with tspan, qos.priority_scope(priority), \
                    qos.brownout_scope(name):
                # Shedding BEFORE any model work — draining (stop
                # ADMITTING, keep finishing; the admission check is
                # atomic with the in-flight count inside _enter, so
                # /healthz can never report inflight==0 while a
                # checked-but-not-yet-admitted request sneaks in)
                # and overload (under a burst past max_inflight the
                # cheapest correct answer is an immediate 503 +
                # Retry-After — queueing collapses every request's
                # latency, not just the excess). One 503 shape for
                # both: clients and the fleet router share a single
                # retry path.
                slot, shed_reason = running._enter(priority)
                if slot is None:
                    m_shed.inc(model=name, reason=shed_reason)
                    tspan.annotate(shed=shed_reason)
                    if shed_reason == "draining":
                        msg = "draining; endpoint is going away"
                    elif shed_reason == "qos":
                        msg = ("batch traffic shed; interactive "
                               "headroom reserved")
                    else:
                        msg = "overloaded; retry later"
                    return _json(503, {"error": msg},
                                 extra={"Retry-After": "1"})
                try:
                    return _predict_resp(
                        headers, payload, instances, slot, tspan)
                finally:
                    slot.release()  # no-op once transferred

        def _do_post(path: str, headers: Any, body: bytes):
            # Workload capture stamps the ARRIVAL, not the predict
            # start — queueing ahead of the handler is part of the
            # workload being recorded.
            t_arr_mono, t_arr_wall = time.monotonic(), time.time()
            cap: dict[str, Any] = {}
            try:
                resp = _do_post_inner(path, headers, body or b"{}", cap)
            except Exception as e:  # noqa: BLE001 — server must stay up
                m_errors.inc()
                resp = _json(500, {"error": f"{type(e).__name__}: {e}"})
            if not cap:
                return resp
            # The workload tap: every predict branch replies exactly
            # once, so this is the one place the final status and
            # latency are both known. Runs as the route's `after`
            # callback — after the response is queued for write, so
            # capture never delays the reply.
            status = resp[0]
            tspan = cap.get("tspan")

            def after() -> None:
                workload.record_request(
                    surface="serving",
                    endpoint=name,
                    path=path,
                    tenant=headers.get("X-Tenant"),
                    payload=cap["payload"],
                    instances=cap["instances"],
                    lm_mode=cfg["model_server"] == LM,
                    status=status,
                    latency_ms=(time.monotonic() - t_arr_mono) * 1e3,
                    trace_id=(
                        tspan.trace_id
                        if getattr(tspan, "sampled", False) else None
                    ),
                    t_mono=t_arr_mono,
                    t_wall=t_arr_wall,
                    wire_format=cap.get("wire_format", "json"),
                    payload_summary=cap.get("summary"),
                )

            return resp[0], resp[1], resp[2], after

        def route(method: str, path: str, headers: Any, body: bytes):
            if method == "GET":
                return _do_get(path, headers)
            if method == "POST":
                return _do_post(path, headers, body)
            return _json(404, {"error": f"unknown path {path}"})

        self.server = HTTPServer(
            route, bind="127.0.0.1", port=0, name=f"serving-{name}",
            workers=int(rcfg.get("http_workers", 16)))

    def _enter(
        self, priority: str = "interactive"
    ) -> "tuple[_InflightSlot | None, str | None]":
        """Admit a request unless the endpoint is draining or
        ``max_inflight`` concurrent predictor executions are already in
        flight (None = no cap). The draining check lives HERE, under
        the same lock as the count, so ``drain()``'s returned inflight
        (and ``/healthz``'s) can never miss a request that had passed
        an earlier check but not yet been admitted. Batch-class
        requests stop being admitted at ``batch_admit_frac`` of the cap
        — the lowest class sheds first, the headroom above the fraction
        stays interactive-only. Returns ``(slot, None)`` when admitted
        (a one-shot slot the caller must release) or ``(None, reason)``
        — reason ``draining`` | ``qos`` | ``overload``."""
        with self._inflight_lock:
            if self._draining:
                return None, "draining"
            if self.max_inflight is not None:
                if self._inflight >= self.max_inflight:
                    return None, "overload"
                if (qos.rank(priority) > 0
                        and self._inflight >= max(
                            1, int(self.max_inflight
                                   * self.batch_admit_frac))):
                    return None, "qos"
            self._inflight += 1
            self._m_inflight.set(self._inflight)
        return _InflightSlot(self), None

    def _exit(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            self._m_inflight.set(self._inflight)

    def drain(self) -> int:
        """Stop admitting new requests (they shed 503 ``draining`` with
        ``Retry-After``); in-flight work runs to completion. Returns the
        current in-flight count. ``/healthz`` reports ``draining`` from
        here on — the one readiness contract the fleet router and the
        rollout drain both key off. Idempotent."""
        with self._inflight_lock:
            already = self._draining
            self._draining = True
            inflight = self._inflight
        if not already:
            flight.record("drain", model=self.cfg["name"], inflight=inflight)
        return inflight

    @property
    def draining(self) -> bool:
        with self._inflight_lock:
            return self._draining

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    @property
    def port(self) -> int:
        return self.server.port

    def stop(self) -> None:
        self.server.stop()
        if self.batcher is not None:
            self.batcher.stop()
        if hasattr(self.predictor, "stop"):  # LMEnginePredictor's engine thread
            self.predictor.stop()


# -- public API (reference surface) ------------------------------------------


def create_or_update(
    name: str,
    model_path: str | None = None,
    model_version: int | None = None,
    model_name: str | None = None,
    model_server: str = FLAX,
    kfserving: bool = False,  # accepted for parity; single serving tool here
    instances: int = 1,
    batching_enabled: bool = False,
    batching_config: dict[str, Any] | None = None,
    lm_config: dict[str, Any] | None = None,
    resilience_config: dict[str, Any] | None = None,
    feature_config: dict[str, Any] | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Create/update a serving endpoint definition (reference:
    ``serving.create_or_update``; ``batching_enabled`` mirrors the
    platform's server-side request batching). ``model_path`` may be a
    registry path or omitted in favor of ``model_name``+``model_version``.
    ``batching_config`` knobs: ``max_batch_size`` (default 64),
    ``timeout_ms`` (default 5). ``model_server="LM"`` serves a saved
    TransformerLM with continuous batching (``lm_config`` knobs:
    ``slots``, ``prefill_buckets``, ``decode_horizon`` — device-side
    steps per dispatch, amortizing host-dispatch latency —
    ``prefixes``, a ``{name: token_ids}`` dict of shared prompt
    prefixes prefilled once at startup,
    ``draft_model``/``draft_version``/``spec_k`` — a second registry
    model proposing tokens for greedy speculative serving — and
    ``kv_page_size``/``kv_pool_blocks``/``prefill_chunk``, which
    switch the engine to the paged KV cache: slot memory bounded by
    live tokens instead of slots x max_decode_len, prefix hits shared
    through page tables, and long prompts prefilled in chunks fused
    into the decode wave so they never freeze live generations); it
    does its own cross-request scheduling, so it composes with
    ``batching_enabled=False`` only.

    ``resilience_config`` knobs (docs/operations.md "Failure
    handling"): ``max_inflight`` — concurrent-request cap beyond which
    the endpoint sheds with 503 + ``Retry-After`` (default: uncapped);
    ``deadline_s`` — per-request budget, overruns answer 504;
    ``breaker_failures`` / ``breaker_reset_s`` — consecutive predictor
    failures that open the circuit, and how long it stays open before
    a half-open probe (defaults 5 / 30 s). ``GET /healthz`` reports
    readiness and flips 503 while the breaker is open.

    ``feature_config`` turns the endpoint into a feature-joining one
    (docs/featurestore.md "Online store & serving-time joins"):
    requests carry only entity-key dicts in ``instances``; the serving
    looks the entities up in the configured feature groups' sharded
    online stores, joins the rows into model-ready vectors (missing-key
    policy ``default`` | ``reject`` | ``passthrough``), and feeds the
    predictor those vectors — composing with ``batching_enabled``
    (coalesced entity batches become one batched multi-get join).

    ``device`` is where the predictor runs (``None``: the card,
    ``cuda:0``). It is stored in the record as a string, so a restored
    or standalone start runs there too; a start without that card
    raises. A ``PYTHON`` predictor ignores it."""
    if model_server.upper() == LM and batching_enabled:
        raise ValueError(
            "model_server='LM' schedules requests itself (continuous "
            "batching) — batching_enabled would double-batch; leave it off"
        )
    if feature_config:
        if model_server.upper() == LM:
            raise ValueError(
                "feature_config joins entity IDs into feature vectors — "
                "that is not a token stream; model_server='LM' cannot "
                "take it"
            )
        # Validate at definition time: a typo'd missing-key policy or a
        # group without a primary key must fail here, not at the first
        # request of a started endpoint.
        from hops_tpu_torch.featurestore.online_serving import validate_feature_config

        feature_config = validate_feature_config(feature_config)
    if lm_config:
        # The registry round-trips through JSON with default=str: a
        # numpy/jnp array anywhere in lm_config would be silently
        # stringified and break start(). Normalize every array-valued
        # knob to plain int lists here, rejecting non-integral values
        # loudly instead of truncating them.
        def int_list(x: Any, what: str) -> list[int]:
            out = []
            for t in np.asarray(x).reshape(-1):
                # Loud rejection with the field's name for BOTH failure
                # shapes: non-integral numerics (int() succeeds but
                # changes the value) and non-numerics (int() raises).
                try:
                    i = int(t)
                except (TypeError, ValueError):
                    raise ValueError(f"{what} must be integers, got {t!r}") from None
                if i != t:
                    raise ValueError(f"{what} must be integers, got {t!r}")
                out.append(i)
            return out

        lm_config = dict(lm_config)
        if lm_config.get("prefill_buckets") is not None:
            lm_config["prefill_buckets"] = int_list(
                lm_config["prefill_buckets"], "lm_config prefill_buckets"
            )
        if lm_config.get("prefixes"):
            lm_config["prefixes"] = {
                pname: int_list(ptokens, f"prefix {pname!r} tokens")
                for pname, ptokens in lm_config["prefixes"].items()
            }
    reg = _load_registry()
    if model_path is None:
        meta = registry.get_model(model_name or name, model_version)
        artifact_path = meta["path"]
        model_version = meta["version"]
    else:
        p = Path(model_path)
        artifact_path = str(p if p.is_absolute() else fs.project_path(model_path))
        if model_version is None:
            model_version = int(p.name) if p.name.isdigit() else 1
    cfg = {
        "name": name,
        # The registry model backing this endpoint: version-pinned
        # consumers (the fleet's rollouts and heals) resolve artifacts
        # through this, NOT the endpoint name — they differ whenever
        # one model serves under several endpoint names.
        "model_name": model_name or name,
        "artifact_path": artifact_path,
        "model_version": model_version,
        "model_server": model_server.upper(),
        "kfserving": kfserving,
        "instances": instances,
        "batching_enabled": batching_enabled,
        "batching_config": batching_config or {},
        "lm_config": lm_config or {},
        "resilience_config": resilience_config or {},
        "feature_config": feature_config or {},
        "device": str(default_device() if device is None else torch.device(device)),
        "status": reg.get(name, {}).get("status", "Stopped"),
        "topic": f"serving-{name}-inference",
    }
    # Preserve runtime keys (e.g. "port") across updates of a running
    # serving; the new artifact is picked up on the next start().
    for key in ("port",):
        if key in reg.get(name, {}):
            cfg[key] = reg[name][key]
    reg[name] = cfg
    _save_registry(reg)
    pubsub.create_topic(cfg["topic"])
    return cfg


def get_all() -> list[dict[str, Any]]:
    return list(_load_registry().values())


def exists(name: str) -> bool:
    return name in _load_registry()


def _port_alive(port: int | None) -> bool:
    if not port:
        return False
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=0.5):
            return True
    except OSError:
        return False


def get_status(name: str) -> str:
    """'Stopped' | 'Running' (reference statuses).

    Truthful, not trusting: a serving counts as Running if this process
    hosts it OR its recorded port answers (it may be hosted by another
    process sharing the workspace). A Running record whose server died
    with its process is healed to Stopped (use :func:`restore` to bring
    it back instead)."""
    reg = _load_registry()
    if name not in reg:
        raise KeyError(f"serving {name!r} not found")
    with _lock:
        if name in _servers:
            return "Running"
    cfg = reg[name]
    if cfg.get("status") == "Running":
        if _port_alive(cfg.get("port")):
            return "Running"
        if _host_process_alive(cfg):
            # The hosting process is alive but its port didn't answer —
            # a transient probe failure or a wedged host. Do NOT heal
            # (that would orphan the process and invite a duplicate from
            # restore()); report Stopped and leave the record intact so
            # stop() can still reach the pid.
            return "Stopped"
        # Host process is dead: heal against a FRESH snapshot under the
        # lock — the port probe above can take 0.5 s, during which
        # another thread may have updated other servings. "Failed"
        # (reported as Stopped) preserves the owner's running-intent so
        # restore() still revives it — healing must not erase what it heals.
        with _lock, _registry_lock():
            reg = _load_registry()
            if name in reg and reg[name].get("status") == "Running":
                reg[name]["status"] = "Failed"
                reg[name].pop("port", None)
                reg[name].pop("pid", None)
                _save_registry(reg)
    return "Stopped"


def restore(standalone: bool = False) -> list[str]:
    """Re-start endpoints recorded Running whose server died with its
    process — the restart-survival story (reference: platform servings
    outlive the notebook that created them, model_repo_and_serving.ipynb
    cells 15-21). Returns restarted names.

    Deliberate entry points that call this: the supervisor verb
    ``python -m hops_tpu_torch.modelrepo.serving_host --restore [--watch N]``
    (resident, revives in-process) and ``standalone=True`` (spawns a
    detached host per serving)."""
    restarted = []
    for name, cfg in _load_registry().items():
        with _lock:
            hosted = name in _servers
        # "Failed" = a dead-Running record already healed by get_status;
        # the owner's intent is still Running.
        if cfg.get("status") in ("Running", "Failed") and not hosted and not _port_alive(cfg.get("port")):
            if _host_process_alive(cfg):
                log.warning(
                    "serving %s: host pid %s alive but port unresponsive — "
                    "not spawning a duplicate; stop() it first", name, cfg.get("pid"))
                continue
            try:
                start(name, standalone=standalone)
            except Exception as exc:  # one broken artifact must not block the rest
                log.warning("restore of serving %s failed: %s", name, exc)
                continue
            restarted.append(name)
    return restarted


def reconcile() -> list[str]:
    """Shut down in-process servers whose record no longer says Running —
    the other half of supervision: restore() revives, reconcile() honors
    deliberate stop()s issued from other processes (which can only flip
    the record of a server they don't host). Returns stopped names."""
    stopped = []
    reg = _load_registry()
    with _lock:
        hosted = list(_servers)
    for name in hosted:
        if reg.get(name, {}).get("status") == "Running":
            continue
        with _lock:
            running = _servers.pop(name, None)
        if running is not None:
            running.stop()
            stopped.append(name)
    return stopped


def start(name: str, standalone: bool = False, timeout_s: float = 60.0) -> dict[str, Any]:
    """Start a serving endpoint.

    ``standalone=True`` hosts it in a detached process
    (``python -m hops_tpu_torch.modelrepo.serving_host <name>``) that outlives
    the caller — the stand-in for the reference's platform-owned serving
    containers (model_repo_and_serving.ipynb:370-374). Default hosts it
    as a thread of this process, as before.
    """
    if standalone:
        return _start_standalone(name, timeout_s)
    return _host_here(name)


def _host_here(name: str, dedicated: bool = False) -> dict[str, Any]:
    reg = _load_registry()
    if name not in reg:
        raise KeyError(f"serving {name!r} not found")
    while True:
        with _lock:
            if name in _servers:
                return reg[name]
            ev = _starting.get(name)
            if ev is None:
                ev = _starting[name] = threading.Event()
                break
        # Another thread is building this serving: wait for it OUTSIDE
        # the module lock, then re-check (its construction may have
        # failed, in which case this thread takes over the build).
        ev.wait()
        reg = _load_registry()
    try:
        # The slow part — registry model load, HTTP bind — runs with
        # _lock RELEASED: holding the module-wide lock would stall any
        # start/stop/status of ANY serving for a full model load.
        faultinject.fire("serving.start", key=name)  # chaos: slow load
        running = _RunningServing(reg[name])
    except BaseException:
        with _lock:
            _starting.pop(name, None)
        ev.set()
        raise
    with _lock:
        _servers[name] = running
        _starting.pop(name, None)
    try:
        with _registry_lock():
            reg = _load_registry()
            reg[name]["status"] = "Running"
            reg[name]["port"] = running.port
            reg[name]["pid"] = os.getpid()
            # Only a DEDICATED host process (serving_host <name>) may be
            # killed by stop() — never a notebook or a shared supervisor
            # whose pid happens to be on the record.
            if dedicated:
                reg[name]["host"] = "standalone"
            else:
                reg[name].pop("host", None)
            _save_registry(reg)
    finally:
        # Wake waiters only after the registry says Running: start()
        # peers must return a published record, and a stop() issued
        # mid-construction must sequence its "Stopped" write AFTER this
        # one, not interleave with it.
        ev.set()
    log.info("serving %s listening on 127.0.0.1:%d", name, running.port)
    return reg[name]


def _host_log(name: str) -> Path:
    return _servings_file().parent / f"{name}.host.log"


def _start_standalone(name: str, timeout_s: float) -> dict[str, Any]:
    if name not in _load_registry():
        raise KeyError(f"serving {name!r} not found")
    if get_status(name) == "Running":
        return _load_registry()[name]
    from hops_tpu_torch.jobs.api import _child_pythonpath

    env = dict(os.environ)
    env["HOPS_TPU_WORKSPACE"] = str(fs.workspace_root())
    env["HOPS_TPU_PROJECT"] = fs.project_name()
    env["PYTHONPATH"] = _child_pythonpath(env.get("PYTHONPATH"))
    with open(_host_log(name), "a") as logfile:
        # start_new_session detaches the host from our process group: our
        # death (even SIGKILL) leaves the endpoint serving. The child owns
        # its copy of the log fd from here.
        proc = subprocess.Popen(
            [sys.executable, "-m", "hops_tpu_torch.modelrepo.serving_host", name],
            stdout=logfile,
            stderr=subprocess.STDOUT,
            env=env,
            start_new_session=True,
        )
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        cfg = _load_registry().get(name, {})
        if cfg.get("pid") == proc.pid and _port_alive(cfg.get("port")):
            return cfg
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    tail = _host_log(name).read_text()[-2000:] if _host_log(name).exists() else ""
    if proc.poll() is None:
        # The host blocks SIGTERM during startup (serving_host's sigwait
        # routing), so a wedged predictor load must be SIGKILLed.
        proc.terminate()
        try:
            proc.wait(timeout=3)
        except subprocess.TimeoutExpired:
            proc.kill()
    raise RuntimeError(
        f"standalone serving {name!r} failed to come up within {timeout_s}s; "
        f"host log tail:\n{tail}"
    )


def _host_process_alive(cfg: dict[str, Any]) -> bool:
    """Is the record's hosting process still alive — with the pid-reuse
    guard for dedicated hosts (a recycled pid must actually be a
    serving_host to count, or healing/restore would block forever)."""
    pid = cfg.get("pid")
    if not _pid_alive(pid):
        return False
    if cfg.get("host") == "standalone":
        return _is_serving_host(pid)
    return True


def _is_serving_host(pid: int) -> bool:
    """Guard against pid reuse: only signal a process that actually is a
    serving host (best-effort; non-Linux says yes)."""
    try:
        cmdline = Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return True
    return b"serving_host" in cmdline


def _pid_alive(pid: int | None) -> bool:
    if not pid or pid == os.getpid():
        return False
    # A standalone host that THIS process spawned and that has exited
    # stays a zombie — alive to os.kill — until it is reaped here.
    with contextlib.suppress(ChildProcessError):
        if os.waitpid(pid, os.WNOHANG)[0] == pid:
            return False
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def stop(name: str) -> None:
    with _lock:
        ev = _starting.get(name)
    if ev is not None:
        # A start() is mid-construction: let it publish (outside the
        # module lock), then stop what it built — the behavior callers
        # had when construction itself held _lock.
        ev.wait()
    with _lock:
        running = _servers.pop(name, None)
    if running is not None:
        running.stop()
    reg = _load_registry()
    if name in reg:
        # A DEDICATED standalone host (another process) owns the server:
        # terminate it, then record the deliberate stop. In-process hosts
        # (notebooks, shared supervisors) are never signaled — their pid
        # on the record is informational.
        pid = reg[name].get("pid")
        if (running is None and reg[name].get("host") == "standalone"
                and _pid_alive(pid) and _is_serving_host(pid)):
            try:
                os.kill(pid, signal.SIGTERM)
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and _pid_alive(pid):
                    time.sleep(0.1)
                if _pid_alive(pid):
                    os.kill(pid, signal.SIGKILL)
                    deadline = time.monotonic() + 5.0
                    while time.monotonic() < deadline and _pid_alive(pid):
                        time.sleep(0.05)
            except (ProcessLookupError, PermissionError):
                pass
        with _registry_lock():
            reg = _load_registry()
            reg[name]["status"] = "Stopped"
            reg[name].pop("port", None)
            reg[name].pop("pid", None)
            _save_registry(reg)


def delete(name: str) -> None:
    stop(name)
    reg = _load_registry()
    reg.pop(name, None)
    _save_registry(reg)


def get_kafka_topic(name: str) -> str:
    """Per-serving inference-log topic (reference:
    ``serving.get_kafka_topic``)."""
    reg = _load_registry()
    if name not in reg:
        raise KeyError(f"serving {name!r} not found")
    return reg[name]["topic"]


def make_inference_request(
    name: str, data: dict[str, Any], verb: str = ":predict"
) -> dict[str, Any]:
    """POST the TF-Serving payload to the endpoint (reference:
    ``serving.make_inference_request(name, {"signature_name",
    "instances": [...]})``)."""
    req = urllib.request.Request(
        f"{_endpoint(name)}/v1/models/{name}{verb}",
        # Convenience client for the TF-Serving-shaped verbs; JSON is
        # that surface's contract.
        data=json.dumps(data).encode(),  # graftlint: disable=json-on-hot-wire
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def get_model_status(name: str) -> dict[str, Any]:
    """``GET /v1/models/<name>`` — TF-Serving's model-status contract,
    extended with live ``engine`` telemetry (dispatch counts, slot
    occupancy, prefix hits, speculation acceptance) for
    ``model_server="LM"`` endpoints."""
    with urllib.request.urlopen(
        f"{_endpoint(name)}/v1/models/{name}", timeout=30
    ) as resp:
        return json.loads(resp.read())


def _endpoint(name: str) -> str:
    """Base URL of a RUNNING serving, or raise (the one definition of
    the registry/port/status preamble)."""
    reg = _load_registry()
    if name not in reg:
        raise KeyError(f"serving {name!r} not found")
    port = reg[name].get("port")
    if port is None or get_status(name) != "Running":
        raise RuntimeError(f"serving {name!r} is not running")
    return f"http://127.0.0.1:{port}"
