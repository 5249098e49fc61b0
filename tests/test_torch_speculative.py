"""Speculative decoding in the port (``LMEngine(draft_model=...)`` and
``generate_speculative``) against the JAX package, fp32 on the CPU.

Greedy streams must be identical to the JAX engine's and JAX
``generate``'s; a perfect draft takes the same dispatches as JAX's
engine. Sampled speculation is held to its law: a token's empirical
distribution over many seeds against the target's filtered softmax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.models.generation import _filter_logits as jax_filter
from hops_tpu.models.generation import generate as jax_generate
from hops_tpu.models.generation import generate_speculative as jax_speculative
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.modelrepo.lm_engine import LMEngine as JaxEngine
from hops_tpu_torch.models.generation import generate_speculative
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo.lm_engine import LMEngine

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
JAX_KW = dict(dtype=jnp.float32, attention_impl="reference")
PROMPT_LENS = (3, 8, 5, 2, 6)
BUDGETS = (9, 4, 7, 1, 6)


def _params(model, seed):
    return jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))


def _port(params, cfg=CFG, **kw):
    return TransformerLM(**cfg, dtype="float32", device="cpu", **kw).load_flax(params)


def _jax_greedy(model, params, prompt, n):
    out = jax_generate(model, params["params"], jnp.asarray(prompt)[None],
                       jax.random.PRNGKey(0), max_new_tokens=n, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def _layer_skip(params, **kw):
    """The target's first block with its embedding, final norm and head:
    a draft that is neither perfect nor random."""
    full = _port(params, **kw)
    draft = TransformerLM(**dict(CFG, num_layers=1), dtype="float32", device="cpu", **kw)
    draft.load_state_dict({k: v for k, v in full.state_dict().items()
                           if not k.startswith("block_1.")})
    return draft


@pytest.fixture(scope="module")
def lm():
    plain = JaxLM(**CFG, **JAX_KW)
    params, draft_params = _params(plain, 0), _params(plain, 5)
    rs = np.random.RandomState(31)
    prompts = [rs.randint(1, 64, (n,)) for n in PROMPT_LENS]
    want = [_jax_greedy(plain, params, p, b) for p, b in zip(prompts, BUDGETS)]
    return plain, params, draft_params, prompts, want


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_speculation_matches_jax(lm, layout):
    """A layer-skip draft on 2 slots, spec_k 3, that accepts some
    proposals and rejects others: every stream is JAX generate's, on the
    dense and the paged layout."""
    _, params, _, prompts, want = lm
    kw = dict(kv_page_size=8, prefill_chunk=8) if layout == "paged" else {}
    engine = LMEngine(_port(params, ragged_decode=True), slots=2, device="cpu", spec_k=3,
                      draft_model=_layer_skip(params, ragged_decode=True), **kw)
    tickets = [engine.submit(p, max_new_tokens=b) for p, b in zip(prompts, BUDGETS)]
    results = engine.run()
    assert [results[t] for t in tickets] == want
    assert engine.spec_offered > 0 and 0 < engine.stats()["spec_acceptance"] < 1
    if layout == "paged":
        assert engine._pool.used == 0


def test_perfect_draft_accepts_all_in_jax_dispatches(lm):
    """Draft == target: every proposal is accepted, eos truncates the
    stream exactly, and the engine takes as many dispatches as JAX's."""
    plain, params, _, _, _ = lm
    rs = np.random.RandomState(32)
    probe, second = rs.randint(1, 64, (5,)), rs.randint(1, 64, (4,))
    gen = _jax_greedy(plain, params, probe, 12)
    eos = gen[4]
    jax_engine = JaxEngine(JaxLM(**CFG, **JAX_KW, ragged_decode=True), params["params"],
                           slots=1, prefill_buckets=(8,), spec_k=4,
                           draft_model=JaxLM(**CFG, **JAX_KW, ragged_decode=True),
                           draft_params=params["params"])
    model = _port(params, ragged_decode=True)
    engine = LMEngine(model, slots=1, prefill_buckets=(8,), spec_k=4, draft_model=model,
                      device="cpu")
    runs = []
    for e in (jax_engine, engine):
        t0, t1 = e.submit(probe, max_new_tokens=12, eos_id=eos), e.submit(second, max_new_tokens=8)
        r = e.run()
        runs.append(([r[t0], r[t1]], e.dispatches))
    assert runs[1] == runs[0]
    assert runs[1][0] == [gen[: gen.index(eos) + 1], _jax_greedy(plain, params, second, 8)]
    assert engine.spec_accepted == engine.spec_offered and engine.dispatches < 8


@pytest.mark.parametrize("k", [2, 4])
def test_generate_speculative_matches_jax(lm, k):
    """Batch minimum acceptance with a one-layer draft of other widths:
    the JAX function's output, which is the target's greedy decoding."""
    plain, params, _, _, _ = lm
    dcfg = dict(CFG, d_model=16, num_heads=2, num_layers=1)
    draft = JaxLM(**dcfg, **JAX_KW)
    dparams = _params(draft, 7)
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
    want = np.asarray(jax_speculative(plain, params["params"], draft, dparams["params"],
                                      jnp.asarray(prompt), max_new_tokens=17, k=k))
    got = generate_speculative(_port(params), _port(dparams, dcfg), prompt, max_new_tokens=17,
                               k=k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_speculative_validation_and_sampled_determinism(lm):
    _, params, draft_params, _, _ = lm
    model, draft = _port(params), _port(draft_params)
    prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    with pytest.raises(ValueError, match="k must be >= 2"):
        generate_speculative(model, draft, prompt, k=1, device="cpu")
    with pytest.raises(ValueError, match="requires seed"):
        generate_speculative(model, draft, prompt, temperature=0.8, device="cpu")
    with pytest.raises(ValueError, match="slack"):
        generate_speculative(model, draft, prompt, max_new_tokens=57, k=4, device="cpu")
    kw = dict(max_new_tokens=10, k=3, temperature=0.9, top_k=20, device="cpu")
    a = generate_speculative(model, draft, prompt, seed=3, **kw)
    assert torch.equal(a, generate_speculative(model, draft, prompt, seed=3, **kw))
    assert not torch.equal(a, generate_speculative(model, draft, prompt, seed=4, **kw))


def test_speculation_horizon_sampled_identical_to_single_step(lm):
    """Any horizon gives the same streams, greedy and sampled, in fewer
    dispatches; the paged layout gives the same streams too."""
    _, params, draft_params, prompts, _ = lm
    model, draft = _port(params, ragged_decode=True), _port(draft_params, ragged_decode=True)

    def run(horizon, **kw):
        engine = LMEngine(model, slots=2, prefill_buckets=(8,), draft_model=draft, spec_k=3,
                          decode_horizon=horizon, device="cpu", **kw)
        ts = [engine.submit(prompts[0], max_new_tokens=7),
              engine.submit(prompts[1], max_new_tokens=6, temperature=0.9, top_p=0.9, seed=13),
              engine.submit(prompts[2], max_new_tokens=5, temperature=0.7, top_k=12, seed=14)]
        r = engine.run()
        return [r[t] for t in ts], engine.dispatches

    single, d1 = run(1)
    horizon, d4 = run(4)
    assert horizon == single and d4 < d1
    assert run(3, kv_page_size=8, prefill_chunk=8)[0] == single


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_speculation_matches_int8_decoding(lm, layout):
    """An int8 target and draft (sharing the page table on the paged
    layout) emit the streams of the dense int8 engine without a draft,
    greedy and sampled."""
    _, params, draft_params, prompts, _ = lm
    q8 = dict(ragged_decode=True, kv_cache_dtype="int8")
    model = _port(params, **q8)
    kws = [dict(max_new_tokens=8), dict(max_new_tokens=6, temperature=0.8, top_k=8, seed=31),
           dict(max_new_tokens=7, eos_id=5), dict(max_new_tokens=5)]

    def run(**kw):
        engine = LMEngine(model, slots=2, device="cpu", **kw)
        ts = [engine.submit(p, **k) for p, k in zip(prompts, kws)]
        r = engine.run()
        return [r[t] for t in ts], engine

    plain, _ = run()
    paged = dict(kv_page_size=8, prefill_chunk=8) if layout == "paged" else {}
    got, engine = run(draft_model=_port(draft_params, **q8), spec_k=3, **paged)
    assert got[0] == plain[0] and got[2:] == plain[2:]  # greedy rows
    assert engine.spec_offered > 0
    if layout == "paged":
        assert engine._pool.used == 0
        # Sampled streams do not depend on the layout either.
        assert run(draft_model=_port(draft_params, **q8), spec_k=3)[0] == got


def test_sampled_speculation_is_lossless():
    """Rejection sampling keeps the target's law: the first speculated
    token (the second token of each request, conditioned on the modal
    first one) over 384 seeds, at vocabulary 16 with a mismatched draft,
    within total variation 0.22 of the target's filtered softmax (JAX's
    bound for the same test); each request is a function of its seed."""
    cfg = dict(vocab_size=16, d_model=32, num_heads=4, num_layers=2, max_decode_len=16)
    plain = JaxLM(**cfg, **JAX_KW)
    params = _params(plain, 0)
    engine = LMEngine(_port(params, cfg, ragged_decode=True), slots=8, prefill_buckets=(8,),
                      draft_model=_port(_params(plain, 9), cfg, ragged_decode=True), spec_k=3,
                      device="cpu")
    prompt = [3, 7, 1, 12]
    knobs = dict(max_new_tokens=2, temperature=0.8, top_k=8)
    tickets = [engine.submit(prompt, seed=1000 + i, **knobs) for i in range(384)]
    results = engine.run()
    pairs = [tuple(results[t]) for t in tickets]
    again = [engine.submit(prompt, seed=1000 + i, **knobs) for i in range(16)]
    results = engine.run()
    assert [tuple(results[t]) for t in again] == pairs[:16]
    firsts = [a for a, _ in pairs]
    modal = max(set(firsts), key=firsts.count)
    seconds = np.asarray([b for a, b in pairs if a == modal])
    assert seconds.size >= 60, seconds.size
    ctx = jnp.asarray(prompt + [modal], jnp.int32)[None]
    logits = plain.apply({"params": params["params"]}, ctx)[0, -1][None]
    probs = np.asarray(jax.nn.softmax(jax_filter(logits, 0.8, 8, None)))[0]
    tv = 0.5 * np.abs(np.bincount(seconds, minlength=16) / seconds.size - probs).sum()
    assert tv < 0.22, (tv, seconds.size)


def test_speculative_validation_and_capacity_boundary(lm):
    """spec_k < 2 and requests past the speculation slack are refused
    (the prefix counts); a request at exactly max_decode_len with the
    slack decodes JAX generate's stream."""
    plain, params, draft_params, _, _ = lm
    model = _port(params, ragged_decode=True)
    with pytest.raises(ValueError, match="spec_k"):
        LMEngine(model, draft_model=model, spec_k=1, device="cpu")
    engine = LMEngine(model, slots=1, prefill_buckets=(8,), draft_model=model, spec_k=4,
                      device="cpu")
    with pytest.raises(ValueError, match="slack"):
        engine.submit(list(range(1, 30)), max_new_tokens=34)
    engine.register_prefix("sys", list(range(1, 20)))
    with pytest.raises(ValueError, match="slack"):
        engine.submit(list(range(1, 11)), max_new_tokens=34, prefix_id="sys")
    for kw in ({}, dict(kv_page_size=8, prefill_chunk=8)):
        engine = LMEngine(model, slots=1, prefill_buckets=(32,), spec_k=4, device="cpu",
                          draft_model=_port(draft_params, ragged_decode=True), **kw)
        p = np.random.RandomState(41).randint(1, 64, (29,))
        t = engine.submit(p, max_new_tokens=33)  # 29 + 33 + 4 - 2 == 64
        assert engine.run()[t] == _jax_greedy(plain, params, p, 33)
