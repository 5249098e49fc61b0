"""``hops_tpu_torch.pipeline`` — the end-to-end platform loop.

The counterpart of ``hops_tpu/pipeline/__init__.py``, copied with the port's imports.

PAPER.md's L3→L4 spine (Kafka → experiment → model repo → serving) as
one continuously-running system: a pubsub topic feeds an unbounded
streaming loader source (:class:`~hops_tpu_torch.featurestore.StreamingSource`),
``run_preemptible`` trains on fresh spans under an exactly-once span
ledger, an eval gate scores every candidate, and passing checkpoints
roll into the serving fleet via breaker-judged rollouts with automatic
rollback. See :mod:`hops_tpu_torch.pipeline.continuous`.
"""

from __future__ import annotations

from hops_tpu_torch.pipeline.continuous import (  # noqa: F401
    ContinuousResult,
    RegistryFleetPublisher,
    SpanLedger,
    SpanStream,
    run_continuous,
)

__all__ = [
    "ContinuousResult",
    "RegistryFleetPublisher",
    "SpanLedger",
    "SpanStream",
    "run_continuous",
]
