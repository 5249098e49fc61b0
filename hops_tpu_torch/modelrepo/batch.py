"""Batch inference over sharded data (counterpart of
``hops_tpu/modelrepo/batch.py``).

Reference (SURVEY.md §2.5, Batch_Inference_Imagenet_Spark.ipynb:283-325):
Spark ``mapPartitions`` over an image DataFrame with the model broadcast
per partition. Here: a host loop over chunks of ``replicas *
per_chip_batch`` rows, each rank predicting its rows of a chunk under
``torch.inference_mode()`` on the strategy's device, the ranks'
predictions gathered back in order; the ragged tail is padded (from a
pooled buffer) so every chunk has one shape.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from hops_tpu_torch.parallel.strategy import Strategy
from hops_tpu_torch.telemetry.metrics import RATIO_BUCKETS, REGISTRY


class AssemblyPool:
    """Reusable host assembly buffers keyed by ``(shape, dtype)``.

    The batch-inference chunk loop assembles a fresh padded host array
    per ragged tail; at steady state every such wave has the same shape,
    so the allocation (and the page faults of first touch) is churn.
    ``take`` hands back a previously released buffer when one of the
    right spec is free (a *hit* on the reuse counter) or allocates (a
    *miss*). Callers ``give`` the buffer back once nothing reads it.
    Per-spec free lists are capped at ``depth`` buffers.
    """

    def __init__(self, depth: int = 4):
        self.depth = depth
        self._lock = threading.Lock()
        # (shape, dtype-str) -> free buffers. # guarded by: self._lock
        self._free: dict[tuple, list[np.ndarray]] = {}
        # Per-instance tallies behind hit_rate(): the registry counter is
        # shared by every pool in the process.
        self._hits = 0  # guarded by: self._lock
        self._misses = 0  # guarded by: self._lock
        self._m_reuse = REGISTRY.counter(
            "hops_tpu_batch_assembly_reuse_total",
            "Batch-assembly buffer checkouts, hit = reused allocation",
            labels=("site", "result"),
        )

    def take(self, shape: tuple[int, ...], dtype: Any,
             site: str = "serving") -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            stack = self._free.get(key)
            if stack:
                self._hits += 1
                self._m_reuse.inc(site=site, result="hit")
                return stack.pop()
            self._misses += 1
        self._m_reuse.inc(site=site, result="miss")
        return np.empty(shape, dtype)

    def give(self, buf: np.ndarray) -> None:
        key = (buf.shape, buf.dtype.str)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) < self.depth:
                stack.append(buf)

    def hit_rate(self) -> float:
        """THIS pool's lifetime hit fraction."""
        with self._lock:
            total = self._hits + self._misses
            return self._hits / total if total else 0.0


#: Process-global pool shared by every batch_predict call.
ASSEMBLY_POOL = AssemblyPool()


def _gather_rows(strategy: Strategy, preds: torch.Tensor) -> torch.Tensor:
    """Every replica's predictions for one chunk, in rank-slice order."""
    n = strategy.num_replicas_in_sync
    if n == 1 or not strategy._distributed():
        return preds
    parts = [torch.empty_like(preds) for _ in range(n)]
    dist.all_gather(parts, preds.contiguous(), group=strategy.mesh.group)
    return torch.cat(parts)


def batch_predict(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    inputs: np.ndarray,
    per_chip_batch: int = 32,
    strategy: Strategy | None = None,
) -> np.ndarray:
    """Run ``apply_fn`` over ``inputs`` data-parallel across the ranks.

    ``apply_fn`` maps a batch tensor on the strategy's device to
    predictions (already closed over the weights). Returns the stacked
    predictions aligned with ``inputs``, as numpy, on every rank.
    """
    strategy = strategy or Strategy()
    chunk = per_chip_batch * strategy.num_replicas_in_sync
    inputs = np.asarray(inputs)
    # Fill ratio says how much of each dispatch was pad waste (only the
    # ragged tail dips below 1.0); rows_total's scrape-side rate() is
    # batch-inference throughput.
    m_fill = REGISTRY.histogram(
        "hops_tpu_batch_fill_ratio",
        "Valid rows per batch-inference chunk over the chunk size",
        buckets=RATIO_BUCKETS,
    ).labels()
    m_rows = REGISTRY.counter(
        "hops_tpu_batch_rows_total", "Batch-inference rows predicted"
    ).labels()

    outs: list[np.ndarray] = []
    n = len(inputs)
    with torch.inference_mode():
        for start in range(0, n, chunk):
            block = inputs[start:start + chunk]
            valid = len(block)
            pad_buf = None
            if valid < chunk:  # pad tail to the chunk's shape (pooled buffer)
                pad_buf = ASSEMBLY_POOL.take((chunk,) + inputs.shape[1:], inputs.dtype,
                                             site="batch")
                pad_buf[:valid] = block
                pad_buf[valid:] = block[-1:]
                block = pad_buf
            # On the CPU the placed rows are a view of the buffer: it goes
            # back to the pool only once the predictions are out.
            placed = strategy.distribute_batch(block)
            preds = _gather_rows(strategy, apply_fn(placed)).cpu().numpy()
            if pad_buf is not None:
                ASSEMBLY_POOL.give(pad_buf)
            m_fill.observe(valid / chunk)
            m_rows.inc(valid)
            outs.append(preds[:valid])
        if outs:
            return np.concatenate(outs, axis=0)
        # Empty input: the output's row shape and dtype from one zero row.
        probe = apply_fn(torch.zeros((1,) + inputs.shape[1:],
                                     dtype=torch.from_numpy(inputs[:0]).dtype,
                                     device=strategy.device))
    return np.empty((0,) + tuple(probe.shape[1:]), probe.cpu().numpy().dtype)


def batch_predict_stream(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    batches: Iterator[np.ndarray],
    strategy: Strategy | None = None,
) -> Iterator[np.ndarray]:
    """Streaming variant: the caller controls batching; each yielded
    batch holds the predictions of every replica's rows of one input
    batch (pad upstream to keep one shape)."""
    strategy = strategy or Strategy()
    for block in batches:
        with torch.inference_mode():
            preds = _gather_rows(strategy, apply_fn(strategy.distribute_batch(block)))
            out = preds.cpu().numpy()
        yield out


def predict_with_model(
    name: str,
    inputs: np.ndarray,
    version: int | None = None,
    per_chip_batch: int = 32,
    strategy: Strategy | None = None,
) -> np.ndarray:
    """Batch inference straight from the model registry (the reference's
    broadcast-model-per-partition pattern, minus Spark): the registered
    classifier bundle on the strategy's device, in eval mode, over
    ``inputs`` (NHWC images, as the JAX modules take them)."""
    from hops_tpu_torch.modelrepo import registry

    strategy = strategy or Strategy()
    model = registry.load_classifier(name, version, device=strategy.device)
    return batch_predict(model, inputs, per_chip_batch, strategy)


def lm_generate_with_model(
    name: str,
    prompts: list,
    max_new_tokens: int | list[int] = 32,
    version: int | None = None,
    slots: int = 8,
    eos_id: int | None = None,
    device: str | torch.device | None = None,
    **sampling: Any,
) -> list[list[int]]:
    """LM batch inference from the registry: generate for every prompt
    via :meth:`LMEngine.run_offline` — budget-sorted slot-waves, one
    prefill and decode dispatch per wave. ``max_new_tokens`` may be
    per-prompt. ``sampling`` forwards per-request knobs (temperature,
    top_k, top_p, seed). Returns generated token lists aligned with
    ``prompts``. Runs on ``device`` (``None``: this process's,
    ``multihost.device()``)."""
    from hops_tpu_torch.modelrepo import registry
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine
    from hops_tpu_torch.modelrepo.serving import load_lm_artifact
    from hops_tpu_torch.parallel import multihost
    from hops_tpu_torch.runtime.devices import resolve_device

    # Validate budgets before the weights load: bad input should fail in
    # microseconds, not after reading a multi-GB artifact.
    if np.ndim(max_new_tokens) == 0:
        budgets = [int(max_new_tokens)] * len(prompts)
    else:
        budgets = [int(b) for b in np.asarray(max_new_tokens).reshape(-1)]
    if len(budgets) != len(prompts):
        raise ValueError(f"{len(budgets)} budgets for {len(prompts)} prompts")
    dev = multihost.device() if device is None else resolve_device(device)
    module = load_lm_artifact(registry.lm_artifact(name, version), dev, ragged_decode=True)
    engine = LMEngine(module, slots=slots, device=dev)
    tickets = [
        engine.submit(p, max_new_tokens=b, eos_id=eos_id, **sampling)
        for p, b in zip(prompts, budgets)
    ]
    results = engine.run_offline()
    return [results[t] for t in tickets]
