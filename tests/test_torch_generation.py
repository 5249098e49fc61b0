"""The port's sampling filters, eos handling and failure isolation against
the JAX package, fp32 on the CPU.

The filters are deterministic functions of the logits, so the port must
mask exactly the entries JAX masks and agree on the rest within ``1e-6``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.models import generation as JG
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.modelrepo import lm_engine as JE
from hops_tpu_torch.models import generation as TG
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo import lm_engine as TE
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact

CFG = dict(vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_decode_len=48)


def _logits(seed=0, rows=4, vocab=50):
    return np.random.default_rng(seed).standard_normal((rows, vocab)).astype(np.float32) * 3


def _same_mask(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_p", [0.3, 0.9, 1.0, 0.0])
def test_top_p_mask_matches_jax(top_p):
    x = _logits(1)
    _same_mask(TG.top_p_mask(torch.from_numpy(x), top_p), JG.top_p_mask(jnp.asarray(x), top_p))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.8), (0.9, 10, 0.5),
])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    x = _logits(2)
    _same_mask(
        TG._filter_logits(torch.from_numpy(x), temperature, top_k, top_p),
        JG._filter_logits(jnp.asarray(x), temperature, top_k, top_p),
    )


@pytest.mark.parametrize("use_top_p", [False, True])
def test_engine_filter_rows_matches_jax(use_top_p):
    x = _logits(3)
    temps = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
    topks = np.array([0, 3, 0, 7], np.int32)
    topps = np.array([0.0, 0.9, 0.6, 1.0], np.float32)
    _same_mask(
        TE._filter_rows(torch.from_numpy(x), torch.from_numpy(temps),
                        torch.from_numpy(topks).long(), torch.from_numpy(topps), use_top_p),
        JE._filter_rows(jnp.asarray(x), jnp.asarray(temps), jnp.asarray(topks),
                        jnp.asarray(topps), use_top_p),
    )


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(**CFG, dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32)))
    prompt = np.random.default_rng(3).integers(0, CFG["vocab_size"], (2, 9)).astype(np.int32)
    return jm, params, prompt


def test_generate_eos_pads_like_jax(lm):
    """A row that emits eos produces pad_id from the next step on."""
    jm, params, prompt = lm
    model = TransformerLM(**CFG, dtype="float32", device="cpu").load_flax(params)
    free = TG.generate(model, prompt, max_new_tokens=10, temperature=0.0, device="cpu")
    eos = int(free[0, prompt.shape[1] + 2])  # row 0's third new token
    want = np.asarray(JG.generate(jm, params["params"], prompt, jax.random.PRNGKey(0),
                                  max_new_tokens=10, temperature=0.0, eos_id=eos, pad_id=63))
    got = TG.generate(model, prompt, max_new_tokens=10, temperature=0.0, eos_id=eos,
                      pad_id=63, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, prompt.shape[1] + 3:] == 63).all()


def test_engine_stops_at_eos(lm):
    _, params, prompt = lm
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True, device="cpu").load_flax(params)
    engine = TE.LMEngine(model, slots=2, device="cpu")
    full = engine.submit(prompt[0], max_new_tokens=10)
    tokens = engine.run()[full]
    eos = tokens[3]
    first = tokens.index(eos)
    t = engine.submit(prompt[0], max_new_tokens=10, eos_id=eos)
    assert engine.run()[t] == tokens[: first + 1]


def test_step_failure_fails_in_flight_requests_and_engine_recovers(lm, monkeypatch):
    _, params, prompt = lm
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True, device="cpu").load_flax(params)
    engine = TE.LMEngine(model, slots=2, device="cpu")
    a = engine.submit(prompt[0], max_new_tokens=6)
    engine.step()  # admitted, one decode step done
    b = engine.submit(prompt[1], max_new_tokens=6)
    real = TransformerLM.forward

    def boom(self, *args, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(TransformerLM, "forward", boom)
    assert engine.step() == []
    monkeypatch.setattr(TransformerLM, "forward", real)
    assert str(engine.take_error(a)) == "injected"
    assert str(engine.take_error(b)) == "injected"
    assert not engine.has_work and not engine.has_failures
    c = engine.submit(prompt[1], max_new_tokens=6)
    alone = TE.LMEngine(model, slots=2, device="cpu")
    d = alone.submit(prompt[1], max_new_tokens=6)
    assert engine.run()[c] == alone.run()[d]


def test_predictor_raises_the_step_failure(lm, tmp_path, monkeypatch):
    _, params, prompt = lm
    save_lm_artifact(tmp_path / "lm", dict(CFG, dtype="float32"), params)
    predictor = LMEnginePredictor(tmp_path / "lm", {"slots": 2}, device="cpu")
    try:
        def boom(self, *args, **kw):
            raise RuntimeError("injected")

        monkeypatch.setattr(TransformerLM, "forward", boom)
        with pytest.raises(RuntimeError, match="injected"):
            predictor.predict([prompt[0].tolist()])
        monkeypatch.undo()
        assert len(predictor.predict([{"prompt": prompt[0].tolist(), "max_new_tokens": 3}])[0]) == 3
        with pytest.raises(NotImplementedError):
            LMEnginePredictor(tmp_path / "lm", {"kv_page_size": 16}, device="cpu")
    finally:
        predictor.stop()
