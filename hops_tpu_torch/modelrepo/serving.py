"""LM serving behind the predictor contract (counterpart of
``LMEnginePredictor`` in ``hops_tpu/modelrepo/serving.py``).

An artifact is a directory holding ``lm_config.json`` (the TransformerLM
fields) and ``params.npz`` (flat ``'/'``-joined flax parameter names,
:func:`hops_tpu_torch.models.convert.save_npz`). This slice has no HTTP
server, tracing, brownout or QoS classes.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Any, Mapping

import torch

from hops_tpu_torch.models.convert import load_npz, save_npz
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.runtime.devices import resolve_device

log = logging.getLogger(__name__)

_LATER_SLICES = (
    "kv_cache_dtype", "draft_model", "kv_page_size", "kv_pool_blocks",
    "prefill_chunk", "prefixes",
)


def save_lm_artifact(
    artifact_dir: str | Path, lm_config: Mapping[str, Any], params: Mapping[str, Any]
) -> Path:
    """Write ``lm_config.json`` and ``params.npz`` into ``artifact_dir``."""
    artifact_dir = Path(artifact_dir)
    artifact_dir.mkdir(parents=True, exist_ok=True)
    (artifact_dir / "lm_config.json").write_text(json.dumps(dict(lm_config), indent=1))
    save_npz(artifact_dir / "params.npz", params)
    return artifact_dir


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
    ``prefill_buckets``, ``max_queue`` and ``decode_horizon`` (1 only).
    """

    def __init__(
        self,
        artifact_dir: str | Path,
        lm_config: Mapping[str, Any] | None = None,
        device: str | torch.device | None = None,
    ):
        cfg = dict(lm_config or {})
        for key in _LATER_SLICES:
            if cfg.get(key):
                raise NotImplementedError(f"lm_config[{key!r}] is a later slice")
        device = resolve_device(device)
        artifact_dir = Path(artifact_dir)
        model_cfg = json.loads((artifact_dir / "lm_config.json").read_text())
        model_cfg["ragged_decode"] = True
        module = TransformerLM(**model_cfg, device=device)
        module.load_flax(load_npz(artifact_dir / "params.npz"))
        self._engine = LMEngine(
            module,
            slots=int(cfg.get("slots", 4)),
            prefill_buckets=(
                tuple(cfg["prefill_buckets"]) if "prefill_buckets" in cfg else None
            ),
            decode_horizon=int(cfg.get("decode_horizon", 1)),
            max_queue=int(cfg.get("max_queue", 1024)),
            device=device,
        )
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
            errors = [self._engine.take_error(t) for t in tickets]
            results = [self._engine.take_result(t) for t in tickets]
            first = next((e for e in errors if e is not None), None)
            if first is not None:
                raise RuntimeError(
                    f"lm engine step failed for this request: {type(first).__name__}: {first}"
                ) from first
            return results

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
