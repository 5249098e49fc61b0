"""The platform's closed loop, end to end in one process.

Counterpart of ``examples/continuous_training.py``. PAPER.md's L3→L4 spine (Kafka → experiment → model repo → serving) as
a continuously-running system: a producer streams training rows onto a
pubsub topic; the continuous trainer (``hops_tpu_torch.pipeline``) tails it
through a ``StreamingSource``, trains each span exactly once under the
span ledger, gates every ``eval_every`` steps on a held-out eval, and
pushes passing candidates into the model registry — where a serving
fleet would pick them up via the breaker-judged rollout
(``chip_smoke.py``'s fleet phase runs that full serving leg; this
example keeps to the training half so it stays seconds-fast). The
trainer's state is a pair of tensors on ``device`` (default: the card).

One gate is deliberately poisoned: the regressed candidate is held
back (that IS the rollback — the incumbent keeps serving), visible in
the returned gate history and on the flight recorder's ``eval_gate``
events.

Usage: ``python examples_torch/continuous_training.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import tempfile


def main(records: int = 48, span_records: int = 6, eval_every: int = 3, *,
         device=None) -> dict:
    import numpy as np
    import torch

    from hops_tpu_torch.featurestore.loader import StreamingSource
    from hops_tpu_torch.messaging import pubsub
    from hops_tpu_torch.modelrepo import registry
    from hops_tpu_torch.pipeline import (
        RegistryFleetPublisher,
        SpanStream,
        run_continuous,
    )
    from hops_tpu_torch.pipeline.continuous import collate_column_batch
    from hops_tpu_torch.runtime import config
    from hops_tpu_torch.runtime.devices import resolve_device
    from hops_tpu_torch.runtime.preemption import PreemptionGuard

    dev = resolve_device(device)

    workspace = tempfile.mkdtemp(prefix="hops_tpu_continuous_example_")
    config.configure(workspace=workspace, project="continuous-example")

    # -- L3 ingest: the "Kafka" topic ---------------------------------------
    topic = pubsub.create_topic("training-rows")
    producer = pubsub.Producer(topic)
    rs = np.random.RandomState(0)
    for i in range(records):
        producer.send({"x": [float(v) for v in rs.rand(4)], "seq": i})

    # -- the model + held-out eval ------------------------------------------
    def train_step(state, batch):
        x = torch.as_tensor(np.asarray(batch["x"]), dtype=torch.float64, device=dev)
        return ({"w": state["w"] + x.sum(dim=0), "n": state["n"] + len(batch["seq"])},
                {"rows": float(len(batch["seq"]))})

    gates = []

    def eval_fn(state):
        gates.append(1)
        if len(gates) == 2:
            return -1.0  # the poisoned candidate: must be held back
        return float(state["n"])

    # -- L4 publish: every passing gate becomes a registry version ----------
    def export_fn(state, step, metric):
        import json
        from pathlib import Path

        art = Path(workspace) / f"candidate_{step}"
        art.mkdir()
        (art / "weights.json").write_text(
            json.dumps({"w": state["w"].tolist(), "step": step}))
        return registry.export(art, "continuous-example",
                               metrics={"eval": metric})

    stream = SpanStream(
        StreamingSource(topic, group="example-trainer", from_beginning=True),
        f"{workspace}/checkpoints",
        collate=collate_column_batch(["x", "seq"]),
        min_records=span_records, max_records=span_records,
        eval_every=eval_every, stop_on_idle=True, idle_grace_s=0.3)
    init = {"w": torch.zeros(4, dtype=torch.float64, device=dev),
            "n": torch.zeros((), dtype=torch.int64, device=dev)}
    result = run_continuous(
        train_step, init, stream,
        directory=f"{workspace}/checkpoints", eval_fn=eval_fn, save_every=2,
        publisher=RegistryFleetPublisher("continuous-example", export_fn),
        guard=PreemptionGuard(install=False))

    versions = registry.list_models("continuous-example")
    summary = {
        "steps": result.steps,
        "records_trained": result.ledger["records"],
        "ledger": result.ledger,
        "gates": [(g["step"], g["outcome"]) for g in result.gates],
        "published_versions": len(versions),
        "held_back": sum(1 for g in result.gates if g["outcome"] == "fail"),
    }
    print(f"trained {summary['records_trained']} records in "
          f"{summary['steps']} spans — ledger contiguous="
          f"{result.ledger['contiguous']} disjoint="
          f"{result.ledger['disjoint']}")
    print(f"gates: {summary['gates']} -> {summary['published_versions']} "
          f"version(s) published, {summary['held_back']} held back")
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
