"""Long-context LM training with ring attention over a ``seq`` mesh axis.

Counterpart of ``examples/long_context_lm.py``. No reference twin
exists — the reference has no transformers and no sequence parallelism
(SURVEY.md §5) — but long context is first-class here. A TransformerLM
with ``attention_impl="ring"`` trains on sequences cut across a
``(data, seq)`` mesh of ranks: each rank holds seq/n_seq tokens of
activations while K/V chunks rotate around the ring
(hops_tpu_torch/parallel/ringattention.py). On ``n >= 4`` ranks (an even
count, under ``python -m hops_tpu_torch.launch``) the mesh is ``data 2 x
seq n/2``; on one card (``seq`` 1) the LM runs the flash kernels (K1
forward, K2/K3 backward, head_dim 16 zero-padded to 64) and other rank
counts run plain data parallelism.

Usage: ``python examples_torch/long_context_lm.py [--seq-len 512] [--steps 5] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

CONFIG = dict(vocab_size=256, d_model=128, num_heads=8, num_layers=2, dtype="float32")


def main(seq_len: int = 512, steps: int = 5, *, params=None, device=None) -> dict:
    from hops_tpu_torch.featurestore.feed import pack_documents
    from hops_tpu_torch.models import common
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
    from hops_tpu_torch.parallel import mesh as mesh_lib, multihost
    from hops_tpu_torch.parallel.strategy import Strategy
    from hops_tpu_torch.runtime.devices import resolve_device

    # A rank of the launcher computes on the device it recorded.
    dev = multihost.device() if device is None else resolve_device(device)
    n = multihost.process_count()
    seq_par = n // 2 if n >= 4 and n % 2 == 0 else 1
    mesh = mesh_lib.make_mesh({"data": n // seq_par, "seq": seq_par})

    ring = seq_par > 1
    model = TransformerLM(
        **CONFIG,
        attention_impl="ring" if ring else "flash",
        mesh=mesh if ring else None,
        batch_axis="data" if ring else None,
        remat=True,
        device=dev,
    ).load_flax(random_params(**CONFIG, seed=0) if params is None else params)
    # Long context is exactly where the (batch, seq, vocab) logits
    # buffer hurts — the token-chunked LM-head loss never builds it.
    step = make_lm_train_step(loss_chunk=128)
    state = common.create_train_state(model)
    if not ring:
        # Without a seq axis the rows split over the data axis (one rank: all of them).
        strategy = Strategy(mesh=mesh, data_axis="data", device=dev)
        state, step = strategy.replicate(state), strategy.step(step)

    # Real LM data prep: ragged "documents" greedy-pack into
    # eos-separated (n, seq+1) rows — no interior padding
    # (featurestore.feed.pack_documents, the standard pretraining
    # layout). With a seq axis every rank takes the global rows and the
    # LM cuts its own block of them; else the strategy hands each rank
    # its rows.
    rng = np.random.RandomState(0)
    batch_size = 2 * mesh.shape["data"]
    docs = [
        rng.randint(1, 256, (int(k),))
        for k in rng.randint(seq_len // 3, seq_len, steps * batch_size * 3)
    ]
    packed = pack_documents(docs, seq_len=seq_len, eos_id=0)
    if len(packed) < steps * batch_size:
        raise ValueError(f"{len(packed)} packed rows for {steps} steps of {batch_size}")
    for i in range(steps):
        tokens = packed[i * batch_size:(i + 1) * batch_size]
        batch = {"tokens": tokens} if ring else strategy.distribute_batch({"tokens": tokens})
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    print(
        f"long-context LM: mesh={dict(mesh.shape)} seq={seq_len} "
        f"loss={loss:.4f} ppl={float(metrics['perplexity']):.1f}"
    )
    return {"loss": loss, "mesh": dict(mesh.shape)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    main(args.seq_len, args.steps, device=args.device)
