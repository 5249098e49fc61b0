"""Continuous batching: ragged requests through shared decode slots.

Counterpart of ``examples/continuous_batching.py``. The reference's
serving is one-shot classifier calls (SURVEY.md §2.5); this example
shows the framework's LM serving path on the card: ``LMEngine``
interleaves requests of different prompt lengths and generation budgets
over a fixed set of decode slots — one decode dispatch per iteration
serves every live request, finished requests free their slot
mid-flight, and the output is identical to running each request alone
through ``generate()``. Its prefills run the flash kernel and its
decode steps the decode kernels (dense; paged for the paged engine),
at head_dim 8: the kernels run it zero-padded to 64.

The interesting number is ``dispatches``: N requests of budget B cost
~max-chain dispatches instead of N*B — the continuous-batching win that
static batch serving (and the reference) cannot express.

Usage: ``python examples_torch/continuous_batching.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CONFIG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, dtype="float32",
              attention_impl="reference", max_decode_len=64)
# (prompt length, budget) of the six requests.
SHAPES = [(2, 8), (13, 3), (7, 12), (5, 5), (11, 6), (4, 9)]


def make_requests() -> list[tuple[np.ndarray, int]]:
    """Six requests, ragged prompts (2..13 tokens) and budgets (3..12),
    through 3 slots — twice as many requests as slots forces queueing
    and slot reuse."""
    rs = np.random.RandomState(0)
    return [(rs.randint(0, 64, (length,)), budget) for length, budget in SHAPES]


def build(params=None, draft_params=None, *, device=None):
    """``(plain, model, draft)`` on ``device``: the target LM (a flax
    parameter tree or flat dict in ``params``; default
    ``random_params(seed=0)``), its ragged-decode view for the engines,
    and a draft of the same shape with other weights (``draft_params``,
    default seed 7)."""
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM

    params = random_params(**CONFIG, seed=0) if params is None else params
    draft_params = random_params(**CONFIG, seed=7) if draft_params is None else draft_params
    plain = TransformerLM(**CONFIG, device=device).load_flax(params)
    model = plain.clone(ragged_decode=True)
    draft = TransformerLM(**CONFIG, ragged_decode=True, device=device).load_flax(draft_params)
    return plain, model, draft


def main(*, params=None, draft_params=None, device=None) -> dict:
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine
    from hops_tpu_torch.models.generation import generate
    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    plain, model, draft = build(params, draft_params, device=dev)
    requests = make_requests()
    engine = LMEngine(model, slots=3, prefill_buckets=(8, 16), device=dev)
    tickets = [engine.submit(p, max_new_tokens=b) for p, b in requests]
    results = engine.run()

    matches = 0
    for (prompt, budget), ticket in zip(requests, tickets):
        ref = generate(plain, prompt[None], max_new_tokens=budget, temperature=0.0,
                       device=dev)
        if results[ticket] == ref[0, len(prompt):].tolist():
            matches += 1

    total_tokens = sum(b for _, b in requests)
    naive_dispatches = sum(b - 1 for _, b in requests)  # one prefill each

    # The same workload through a SPECULATIVE engine: a (here:
    # differently-initialized, so imperfect) draft proposes 3 tokens
    # per dispatch, each slot keeps its own accepted prefix, and greedy
    # output stays identical — fewer dispatches whenever the draft
    # agrees with the target.
    spec = LMEngine(model, slots=3, prefill_buckets=(8, 16), draft_model=draft, spec_k=4,
                    device=dev)
    spec_tickets = [spec.submit(p, max_new_tokens=b) for p, b in requests]
    spec_results = spec.run()
    spec_parity = sum(
        spec_results[t] == results[t0]
        for t, t0 in zip(spec_tickets, tickets)
    )

    # The same workload through the PAGED engine: per-layer caches are
    # a shared block pool + per-slot page tables (slot memory bounded
    # by live tokens, not slots x max_decode_len), and prompts prefill
    # in chunks fused into the decode wave. Output stays identical —
    # the layout is pure memory/scheduling.
    paged = LMEngine(model, slots=3, kv_page_size=8, prefill_chunk=8, device=dev)
    paged_tickets = [paged.submit(p, max_new_tokens=b) for p, b in requests]
    paged_results = paged.run()
    paged_parity = sum(
        paged_results[t] == results[t0]
        for t, t0 in zip(paged_tickets, tickets)
    )
    pstats = paged.stats()

    out = {
        "requests": len(requests),
        "slots": engine.slots,
        "tokens": total_tokens,
        "dispatches": engine.dispatches,
        "naive_dispatches": naive_dispatches,
        "parity": matches,
        "spec_dispatches": spec.dispatches,
        "spec_acceptance": round(
            spec.spec_accepted / max(spec.spec_offered, 1), 3
        ),
        "spec_parity": spec_parity,
        "paged_parity": paged_parity,
        "paged_peak_blocks": pstats["blocks_peak_used"],
        "paged_prefill_chunks": pstats["prefill_chunks"],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
