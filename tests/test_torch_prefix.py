"""Prefix caching in the port's engine against the JAX package, fp32 on
the CPU: a registered prefix plus a suffix decodes exactly what the full
prompt decodes (dense stored rows; paged shared pages with copy-on-write
from the first incomplete page), with the JAX engine's reference counts,
eviction and admission ordering.
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
from hops_tpu_torch.telemetry.metrics import REGISTRY

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
JAX_KW = dict(dtype=jnp.float32, attention_impl="reference")
PAGED = dict(kv_page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def params():
    model = JaxLM(**CFG, **JAX_KW)
    return jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


def _model(params, **kw):
    return TransformerLM(**CFG, dtype="float32", ragged_decode=True, device="cpu",
                         **kw).load_flax(params)


def _run(engine, requests, prefix=None):
    if prefix is not None:
        engine.register_prefix("sys", prefix)
    tickets = [engine.submit(p, prefix_id="sys" if prefix is not None else None, **kw)
               for p, kw in requests]
    results = engine.run()
    return [results[t] for t in tickets]


@pytest.mark.parametrize("knobs", [{}, {"num_kv_heads": 2}, {"kv_cache_dtype": "int8"}],
                         ids=["mha", "gqa", "int8"])
def test_dense_prefix_equals_the_full_prompt(knobs):
    """Three suffixes on one stored prefix (11 tokens) decode what the
    full prompt decodes: JAX generate's stream (MHA, GQA; jitted
    once per length), and for the int8 cache the port's own int8 engine
    on the full prompt (both attend the same quantized keys; JAX's int8
    prefill attends its unquantized chunk)."""
    jm = JaxLM(**CFG, **JAX_KW, **{k: v for k, v in knobs.items() if k == "num_kv_heads"})
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    rs = np.random.RandomState(6)
    prefix = rs.randint(0, 64, (11,))
    suffixes = [rs.randint(0, 64, (n,)) for n in (3, 7, 5)]
    model = _model(params, **knobs)
    engine = LMEngine(model, slots=2, prefill_buckets=(8, 16), device="cpu")
    got = _run(engine, [(s, dict(max_new_tokens=6)) for s in suffixes], prefix)
    assert engine.prefix_hits == 3
    full = [np.concatenate([prefix, s]) for s in suffixes]
    if "kv_cache_dtype" in knobs:
        want = _run(LMEngine(model, slots=2, prefill_buckets=(8, 16, 32), device="cpu"),
                    [(f, dict(max_new_tokens=6)) for f in full])
    else:
        want = [np.asarray(jax_generate(jm, params["params"], jnp.asarray(f)[None],
                                        jax.random.PRNGKey(0), max_new_tokens=6,
                                        temperature=0.0))[0, f.size:].tolist() for f in full]
    assert got == want


def test_dense_prefix_snapshot_and_validation(params):
    """Queued requests keep the prefix they were submitted under when the
    name is registered again; unknown names and oversize requests are
    refused."""
    model = _model(params)
    engine = LMEngine(model, slots=1, prefill_buckets=(8, 16), device="cpu")
    with pytest.raises(ValueError, match="unknown prefix_id"):
        engine.submit([1, 2], prefix_id="nope")
    with pytest.raises(ValueError, match="empty prefix"):
        engine.register_prefix("bad", [])
    engine.register_prefix("sys", np.arange(1, 10))
    t = engine.submit([3, 1, 4], max_new_tokens=5, prefix_id="sys")
    engine.register_prefix("sys", np.arange(1, 40))
    with pytest.raises(ValueError, match="max_decode_len"):
        engine.submit(np.arange(10), max_new_tokens=20, prefix_id="sys")
    want = _run(LMEngine(model, slots=1, device="cpu"),
                [(np.concatenate([np.arange(1, 10), [3, 1, 4]]), dict(max_new_tokens=5))])
    assert engine.run()[t] == want[0]


def _blocks_data(engine, blocks):
    return [(t[:, blocks].clone()) for t in engine._cache.tensors()]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_paged_prefix_shares_pages_copy_on_write(params, kv):
    """The paged engine's streams equal the dense engine's stored-prefix
    streams. The prefix's 2 complete pages (20 tokens on pages of 8) are
    captured once (a registry reference), later admissions point at the
    same blocks (refcount 2 while one reads them) and write from the
    first incomplete page on, into a block of their own; the shared
    blocks' values (and int8 scales) never change after capture, and
    registering the name again drains the pool."""
    knobs = {} if kv is None else {"kv_cache_dtype": kv}
    model = _model(params, **knobs)
    rs = np.random.RandomState(6)
    prefix = rs.randint(1, 64, (20,))
    reqs = [(rs.randint(1, 64, (5,)), dict(max_new_tokens=8)),
            (rs.randint(1, 64, (7,)), dict(max_new_tokens=8))]
    dense = _run(LMEngine(model, slots=2, prefill_buckets=(8, 16, 32), device="cpu"), reqs,
                 prefix)
    paged = LMEngine(model, slots=2, device="cpu", **PAGED)
    assert _run(paged, reqs, prefix) == dense
    entry = paged._prefixes["sys"]
    assert entry.blocks is not None and len(entry.blocks) == 20 // 8
    assert all(paged._pool.refcount(b) == 1 for b in entry.blocks)
    shared = _blocks_data(paged, entry.blocks)
    t3 = paged.submit(reqs[0][0], max_new_tokens=4, prefix_id="sys")
    paged.step()
    row = next(r for r, st in enumerate(paged._slot_state) if st is not None and st.ticket == t3)
    st = paged._slot_state[row]
    assert st.shared_hit and list(paged._pages_np[row, :2]) == entry.blocks
    # Recompute started at position 16, the first incomplete page, and
    # this step's chunk took 8 of its 9 tokens (4 of the prefix, 5 own).
    assert paged._pages_np[row, 2] not in entry.blocks and st.base_len == 16 + 8
    assert all(paged._pool.refcount(b) == 2 for b in entry.blocks)
    assert paged.run()[t3] == dense[0][:4]
    for before, after in zip(shared, _blocks_data(paged, entry.blocks)):
        assert before.equal(after)
    assert all(paged._pool.refcount(b) == 1 for b in entry.blocks)
    assert paged.stats()["prefix_hits"] == 1  # the first two were admitted together, cold
    paged.register_prefix("sys", prefix[:8])
    assert paged._pool.used == 0


def test_paged_int8_preemption_replays_identically(params):
    """A pool too small for two long requests preempts the newest, and
    the int8 pools replay it to the dense int8 engine's stream."""
    model = _model(params, kv_cache_dtype="int8")
    rs = np.random.RandomState(23)
    reqs = [(rs.randint(1, 64, (20,)), dict(max_new_tokens=20)) for _ in range(2)]
    tight = LMEngine(model, slots=2, kv_page_size=8, kv_pool_blocks=9, prefill_chunk=8,
                     device="cpu")
    assert _run(tight, reqs) == _run(LMEngine(model, slots=2, prefill_buckets=(8, 32),
                                              device="cpu"), reqs)
    assert tight.preemptions > 0 and tight._pool.used == 0


def test_idle_prefix_is_evicted_instead_of_a_deadlock(params):
    """With no live slot, the registry's references to an idle prefix's
    pages must not keep a queued request out of the pool forever."""
    rs = np.random.RandomState(9)
    eng = LMEngine(_model(params), slots=2, kv_page_size=8, kv_pool_blocks=6, prefill_chunk=8,
                   device="cpu")  # 5 usable blocks
    eng.register_prefix("sys", rs.randint(1, 64, (17,)))  # 2 complete pages
    t0 = eng.submit(rs.randint(1, 64, (4,)), max_new_tokens=2, prefix_id="sys")
    eng.run()
    assert eng._prefixes["sys"].blocks is not None and eng._pool.used == 2
    t1 = eng.submit(rs.randint(1, 64, (30,)), max_new_tokens=8)  # 4 blocks of 3 free
    for _ in range(64):
        eng.step()
        if eng.result(t1) is not None:
            break
    assert eng.result(t1) is not None and len(eng.result(t1)) == 8
    assert eng._prefixes["sys"].blocks is None and eng._pool.used == 0
    assert eng.result(t0) is not None


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefix_waves_are_bit_identical_to_fifo(params, paged):
    """Same-prefix requests are grouped into one admission wave (the
    batched counter moves), and every stream equals FIFO admission's."""
    model = _model(params)

    def run(ordered):
        kw = dict(slots=2)
        if paged:
            kw.update(kv_page_size=8, kv_pool_blocks=20, prefill_chunk=16)
        eng = LMEngine(model, device="cpu", **kw)
        eng.register_prefix("sys", np.arange(10, 18))
        if not ordered:
            eng._order_queue_for_prefix_waves = lambda: None
        rs = np.random.RandomState(0)
        tickets = []
        for i in range(6):
            if i % 2 == 0:
                tickets.append(eng.submit(rs.randint(0, 64, 4), max_new_tokens=4,
                                          prefix_id="sys"))
            else:
                tickets.append(eng.submit(rs.randint(0, 64, 6), max_new_tokens=4, seed=i,
                                          temperature=0.8))
        res = eng.run()
        return {t: res[t] for t in tickets}

    counter = REGISTRY.counter("hops_tpu_lm_prefix_batched_total")
    before = counter.value()
    ordered = run(ordered=True)
    assert counter.value() > before
    assert ordered == run(ordered=False)


def test_prefix_ordering_keeps_fifo_without_prefixes(params):
    eng = LMEngine(_model(params), slots=1, device="cpu")
    rs = np.random.RandomState(1)
    for _ in range(4):
        eng.submit(rs.randint(0, 64, 4), max_new_tokens=2)
    order = [r.ticket for r in eng._queue]
    eng._order_queue_for_prefix_waves()
    assert [r.ticket for r in eng._queue] == order
