"""The port's dense serving path (``hops_tpu_torch.modelrepo``) against
JAX ``generate`` on the same weights, fp32 on the CPU.

Greedy streams must be identical token for token. Sampled streams are
held only to determinism inside the port (JAX's PRNG is not reproduced).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.models.generation import generate as jax_generate
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu_torch.models.generation import generate
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo.lm_engine import LMEngine, QueueFullError
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact

CFG = dict(vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
PROMPT_LENS = (5, 12, 20)
BUDGETS = (6, 4, 8)


@pytest.fixture(scope="module")
def setup():
    jm = JaxLM(**CFG, dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)))
    prompts = [
        np.random.default_rng(10 + i).integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
        for i, n in enumerate(PROMPT_LENS)
    ]
    want = [
        np.asarray(jax_generate(
            jm, params["params"], p[None], jax.random.PRNGKey(0),
            max_new_tokens=n, temperature=0.0,
        ))[0, p.size:].tolist()
        for p, n in zip(prompts, BUDGETS)
    ]
    return params, prompts, want


def _model(params, **kw):
    return TransformerLM(**CFG, dtype="float32", device="cpu", **kw).load_flax(params)


def test_engine_greedy_matches_jax_generate(setup):
    """2 slots, 3 requests of different lengths: the third waits for a
    free slot, and every stream equals per-request JAX generate."""
    params, prompts, want = setup
    engine = LMEngine(_model(params, ragged_decode=True), slots=2, device="cpu")
    tickets = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)]
    results = engine.run()
    assert [results[t] for t in tickets] == want
    stats = engine.stats()
    assert stats["admission_waves"] == 2 and stats["slots_busy"] == 0
    assert stats["tokens_emitted"] == sum(BUDGETS)


def test_port_generate_matches_jax_generate(setup):
    params, prompts, want = setup
    model = _model(params)
    got = [
        generate(model, p[None], max_new_tokens=n, temperature=0.0, device="cpu")[0, p.size:].tolist()
        for p, n in zip(prompts, BUDGETS)
    ]
    assert got == want


def test_sampled_request_is_deterministic_per_seed(setup):
    params, prompts, _ = setup
    model = _model(params, ragged_decode=True)
    knobs = dict(max_new_tokens=8, temperature=0.9, top_k=20, top_p=0.9)

    def run(seed, company):
        engine = LMEngine(model, slots=2, device="cpu")
        if company:
            engine.submit(prompts[2], max_new_tokens=5)
        t = engine.submit(prompts[0], seed=seed, **knobs)
        return engine.run()[t]

    first = run(7, company=False)
    assert run(7, company=True) == first  # independent of slot and company
    assert run(8, company=False) != first
    assert all(0 <= tok < CFG["vocab_size"] for tok in first)


def test_sampled_generate_is_deterministic_per_seed(setup):
    params, prompts, _ = setup
    model = _model(params)
    kw = dict(max_new_tokens=6, temperature=1.0, top_p=0.8, device="cpu")
    a = generate(model, prompts[1][None], seed=3, **kw)
    assert torch.equal(a, generate(model, prompts[1][None], seed=3, **kw))
    assert not torch.equal(a, generate(model, prompts[1][None], seed=4, **kw))


def test_predictor_answers_through_an_npz_artifact(setup, tmp_path):
    params, prompts, want = setup
    save_lm_artifact(tmp_path / "lm", dict(CFG, dtype="float32"), params)
    predictor = LMEnginePredictor(tmp_path / "lm", {"slots": 2}, device="cpu")
    try:
        instances = [{"prompt": p.tolist(), "max_new_tokens": n} for p, n in zip(prompts, BUDGETS)]
        assert predictor.predict(instances) == want
        assert predictor.predict([prompts[0].tolist()])[0][:6] == want[0]
        assert len(predictor.last_ttft_s) == 1
        assert predictor.stats()["cache_layout"] == "dense"
    finally:
        predictor.stop()


def test_queue_bound_and_later_slices(setup):
    params, prompts, _ = setup
    model = _model(params, ragged_decode=True)
    engine = LMEngine(model, slots=1, max_queue=1, device="cpu")
    engine.submit(prompts[0], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        engine.submit(prompts[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_decode_len"):
        engine.submit(prompts[0], max_new_tokens=CFG["max_decode_len"])
    # The JAX engine's validation cases; a draft whose kv heads do not
    # divide the tensor-parallel degree is refused before any slicing.
    from hops_tpu_torch.parallel import mesh as mesh_lib

    with pytest.raises(ValueError, match="not divisible by tp degree"):
        LMEngine(model, device="cpu", mesh=mesh_lib.Mesh(np.arange(2), ("model",)),
                 draft_model=TransformerLM(**CFG, dtype="float32", device="cpu",
                                           ragged_decode=True, num_kv_heads=1))
    with pytest.raises(ValueError, match="decode_horizon"):
        LMEngine(model, device="cpu", decode_horizon=0)
    with pytest.raises(ValueError, match="spec_k"):
        LMEngine(model, device="cpu", draft_model=model, spec_k=1)
    with pytest.raises(ValueError, match="draft_model needs ragged_decode"):
        LMEngine(model, device="cpu", draft_model=_model(params))
    with pytest.raises(ValueError, match="prefill_chunk requires"):
        LMEngine(model, device="cpu", prefill_chunk=8)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        engine.submit(prompts[0], prefix_id="system")
    with pytest.raises(ValueError, match="ragged_decode"):
        LMEngine(_model(params), device="cpu")
