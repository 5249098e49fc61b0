"""Decode horizons and offline waves in the port's engine against the
JAX package, fp32 on the CPU: any ``decode_horizon`` emits the streams
of horizon 1 (greedy ones JAX ``generate``'s) in fewer dispatches, a
request ending mid-horizon never writes past the cache, and
``run_offline`` answers what ``run`` answers in one dispatch per wave.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hops_tpu.models.generation import generate as jax_generate
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo.lm_engine import LMEngine

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
PAGED = dict(kv_page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def lm():
    plain = JaxLM(**CFG, dtype=jnp.float32, attention_impl="reference")
    params = jax.device_get(plain.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True,
                          device="cpu").load_flax(params)

    def greedy(prompt, n):
        out = jax_generate(plain, params["params"], jnp.asarray(prompt)[None],
                           jax.random.PRNGKey(0), max_new_tokens=n, temperature=0.0)
        return np.asarray(out)[0, len(prompt):].tolist()

    return model, greedy


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_horizon_streams_identical_in_fewer_dispatches(lm, layout):
    """Ragged budgets, an eos that fires mid-horizon, a sampled request,
    a prefix request and a budget of 1: horizon 4 emits what horizon 1
    emits, the greedy streams are JAX generate's, and it takes fewer
    dispatches and read-backs."""
    model, greedy = lm
    rs = np.random.RandomState(7)
    probe = rs.randint(0, 64, (5,))
    eos = greedy(probe, 8)[2]
    prefix = list(range(1, 9))
    prompts = [rs.randint(0, 64, (n,)) for n in (3, 7, 2)]
    kw = PAGED if layout == "paged" else dict(prefill_buckets=(8, 16))

    def run(horizon):
        engine = LMEngine(model, slots=2, decode_horizon=horizon, device="cpu", **kw)
        engine.register_prefix("sys", prefix)
        ts = [engine.submit(probe, max_new_tokens=8, eos_id=eos),
              engine.submit(prompts[0], max_new_tokens=10),
              engine.submit([9, 10, 11], max_new_tokens=5, prefix_id="sys"),
              engine.submit(prompts[1], max_new_tokens=6, temperature=0.8, top_k=8, seed=42),
              engine.submit(prompts[2], max_new_tokens=1)]
        r = engine.run()
        return [r[t] for t in ts], engine.stats()

    one, s1 = run(1)
    four, s4 = run(4)
    assert four == one
    assert s4["dispatches"] < s1["dispatches"] and s4["readbacks"] < s1["readbacks"]
    assert s4["decode_horizon"] == 4
    assert one[0] == greedy(probe, 8)[:3] and one[0][-1] == eos
    assert one[1] == greedy(prompts[0], 10)
    assert one[2] == greedy(np.asarray(prefix + [9, 10, 11]), 5)
    assert one[4] == greedy(prompts[2], 1)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_horizon_cache_never_overruns(lm, layout):
    """4 + 60 tokens fill max_decode_len exactly and horizon 7 does not
    divide 60: the row retires on the device and writes nothing past the
    cache."""
    model, greedy = lm
    p = np.random.RandomState(8).randint(0, 64, (4,))
    kw = PAGED if layout == "paged" else dict(prefill_buckets=(8,))
    engine = LMEngine(model, slots=1, decode_horizon=7, device="cpu", **kw)
    t = engine.submit(p, max_new_tokens=60)
    assert engine.run()[t] == greedy(p, 60)


def test_paged_horizon_waits_for_prefill(lm):
    """The paged engine runs one step while any slot is still prefilling
    and its horizon once every slot decodes."""
    model, _ = lm
    rs = np.random.RandomState(3)
    engine = LMEngine(model, slots=2, decode_horizon=4, device="cpu", **PAGED)
    engine.submit(rs.randint(0, 64, (30,)), max_new_tokens=10)
    engine.submit(rs.randint(0, 64, (3,)), max_new_tokens=10)
    emitted = []
    while engine.has_work:
        prefilling = any(st is not None and st.pending is not None for st in engine._slot_state)
        before = engine.tokens_emitted
        engine.step()
        emitted.append((prefilling, engine.tokens_emitted - before))
    assert all(n <= 2 for busy, n in emitted if busy)  # one token per slot at most
    assert max(n for _, n in emitted) > 2


def test_run_offline_matches_generate(lm):
    """One dispatch per budget-sorted wave; ragged budgets, an eos
    inside a rollout, a budget of 1 and a sampled request that equals the
    online engine's stream."""
    model, greedy = lm
    rs = np.random.RandomState(81)
    prompts = [rs.randint(1, 64, (n,)) for n in (3, 9, 5, 2, 6, 4)]
    budgets = [7, 1, 12, 4, 9, 5]
    eos = greedy(prompts[2], 12)[4]
    engine = LMEngine(model, slots=2, prefill_buckets=(8, 16), device="cpu")
    tickets = [engine.submit(p, max_new_tokens=b, eos_id=eos if i == 2 else None)
               for i, (p, b) in enumerate(zip(prompts, budgets))]
    sampled = dict(max_new_tokens=6, temperature=0.8, top_p=0.9, seed=31)
    ts = engine.submit(prompts[0], **sampled)
    results = engine.run_offline()
    assert engine.dispatches == -(-7 // 2) == engine.readbacks
    for i, (p, b, t) in enumerate(zip(prompts, budgets, tickets)):
        want = greedy(p, b)
        if i == 2:
            want = want[: want.index(eos) + 1]
        assert results[t] == want, i
    online = LMEngine(model, slots=2, prefill_buckets=(8, 16), device="cpu")
    t2 = online.submit(prompts[0], **sampled)
    assert results[ts] == online.run()[t2]
    # Engines that run_offline does not serve drain through run().
    paged = LMEngine(model, slots=2, device="cpu", **PAGED)
    t3 = paged.submit(prompts[1], max_new_tokens=3)
    assert paged.run_offline()[t3] == greedy(prompts[1], 3)
