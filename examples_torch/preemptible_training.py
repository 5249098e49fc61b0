"""Preemption-safe training: survive SIGTERM, resume where you left off.

Counterpart of ``examples/preemptible_training.py``. The reference had
no story for a killed run (SURVEY.md §5 "no auto-resume") — on
preemptible machines that means losing the whole run to a maintenance
event. This example simulates the full lifecycle in one process, on the
card:

1. first incarnation trains, is "preempted" (a real SIGTERM) mid-run,
   checkpoints at the step boundary, and exits cleanly;
2. second incarnation calls the SAME code and transparently resumes
   from the checkpoint, finishing the remaining steps — in supervisor
   mode (``max_recoveries``), so a transient feed or step failure in
   between would re-restore from the newest *valid* checkpoint instead
   of killing the run.

Usage: ``python examples_torch/preemptible_training.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile


def train(ckpt_dir: str, batches, preempt_at: int | None = None, device=None) -> dict:
    """One incarnation of the job: same code before and after preemption."""
    from hops_tpu_torch.models import common
    from hops_tpu_torch.models.mnist import CNN
    from hops_tpu_torch.runtime.preemption import PreemptionGuard, run_preemptible

    guard = PreemptionGuard()
    step_fn = common.make_train_step()
    seen = []

    def step(state, batch):
        seen.append(1)
        if preempt_at is not None and len(seen) == preempt_at:
            os.kill(os.getpid(), signal.SIGTERM)  # the maintenance event
        return step_fn(state, batch)

    state = common.create_train_state(CNN(dtype="float32", device=device, seed=0))
    state, metrics, done = run_preemptible(
        step, state, batches, directory=ckpt_dir, save_every=50, guard=guard,
        max_recoveries=2,  # supervisor: transient failures re-restore + resume
    )
    return {
        "steps_completed": done,
        "optimizer_steps": int(state.step),
        "loss": float(metrics["loss"]) if metrics else None,
    }


def main(num_steps: int = 10, preempt_at: int = 4, *, device=None) -> dict:
    import numpy as np

    from hops_tpu_torch.featurestore.loader import ArraySource, DataLoader
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    # The staged parallel input pipeline (featurestore/loader.py) as the
    # batch stream: run_preemptible checkpoints its (seed, epoch, step)
    # position in a data-state sidecar, so the second incarnation
    # resumes the EXACT remaining batch stream — no batches re-seen, no
    # batches skipped — with decode overlapped on worker threads.
    rs = np.random.RandomState(0)
    batches = DataLoader(
        ArraySource({
            "image": rs.rand(num_steps * 8, 28, 28, 1).astype(np.float32),
            "label": rs.randint(0, 10, num_steps * 8),
        }),
        batch_size=8, num_epochs=1, seed=0, num_workers=2,
    )
    ckpt_dir = tempfile.mkdtemp(prefix="preemptible_")

    first = train(ckpt_dir, batches, preempt_at=preempt_at, device=dev)
    second = train(ckpt_dir, batches, device=dev)
    print(
        f"incarnation 1: preempted after {first['steps_completed']} steps "
        f"(loss {first['loss']:.3f}); incarnation 2 resumed and finished "
        f"{second['steps_completed']} / {num_steps} "
        f"(optimizer steps {second['optimizer_steps']}, "
        f"loss {second['loss']:.3f})"
    )
    return {"first": first, "second": second}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
