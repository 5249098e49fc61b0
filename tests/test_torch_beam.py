"""The port's ``beam_search`` against the JAX package's, fp32 on the
CPU: the same best beams, scores within ``1e-4``; a beam of 1 is greedy
decoding (also through the GQA and int8 cache); an exhaustive beam finds
the most likely continuation; eos freezes a beam at its score.
"""

from __future__ import annotations

from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.models.generation import beam_search as jax_beam_search
from hops_tpu.models.generation import generate as jax_generate
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu_torch.models.generation import beam_search, generate
from hops_tpu_torch.models.transformer import TransformerLM

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
JAX_KW = dict(dtype=jnp.float32, attention_impl="reference")


def _lm(cfg=CFG, seed=0, **knobs):
    jm = JaxLM(**cfg, **JAX_KW)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)))
    return jm, params, TransformerLM(**cfg, dtype="float32", device="cpu",
                                     **knobs).load_flax(params)


@pytest.fixture(scope="module")
def lm():
    return _lm()


@pytest.mark.parametrize("eos_id,length_penalty", [(None, 0.0), (7, 0.6)])
def test_beam_search_matches_jax(lm, eos_id, length_penalty):
    jm, params, model = lm
    prompt = np.random.RandomState(13).randint(1, 64, (2, 6)).astype(np.int32)
    kw = dict(max_new_tokens=8, beam_size=4, eos_id=eos_id, pad_id=0,
              length_penalty=length_penalty)
    want_tokens, want_scores = jax_beam_search(jm, params["params"], jnp.asarray(prompt), **kw)
    tokens, scores = beam_search(model, prompt, device="cpu", **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=1e-4, rtol=0)


@pytest.mark.parametrize("knobs", [{}, {"num_kv_heads": 2, "kv_cache_dtype": "int8"}],
                         ids=["mha", "gqa_int8"])
def test_beam_of_one_is_greedy(lm, knobs):
    """Beam 1 reorders the cache rows (values and int8 scales) by the
    identity and keeps the argmax: greedy decoding, JAX's for MHA and the
    port's own through the GQA int8 cache."""
    jm, params, model = lm
    if knobs:
        jm, params, model = _lm(dict(CFG, num_kv_heads=2), **{"kv_cache_dtype": "int8"})
    prompt = np.random.RandomState(13).randint(1, 64, (2, 6)).astype(np.int32)
    tokens, scores = beam_search(model, prompt, max_new_tokens=8, beam_size=1, device="cpu")
    if knobs:
        want = generate(model, prompt, max_new_tokens=8, temperature=0.0, device="cpu").numpy()
    else:
        want = np.asarray(jax_generate(jm, params["params"], jnp.asarray(prompt),
                                       jax.random.PRNGKey(0), max_new_tokens=8,
                                       temperature=0.0))
    np.testing.assert_array_equal(tokens.numpy(), want)
    assert scores.shape == (2,) and bool((scores <= 0).all())


def test_beam_search_finds_the_optimal_sequence():
    """Beam 16 over vocabulary 4 and depth 2 is exhaustive: the winner is
    the brute-force most likely continuation, scored as JAX scores it."""
    cfg = dict(vocab_size=4, d_model=32, num_heads=4, num_layers=2, max_decode_len=16)
    jm, params, model = _lm(cfg, seed=2)
    prompt = np.asarray([[1, 3, 2]], np.int32)
    tokens, score = beam_search(model, prompt, max_new_tokens=2, beam_size=16, device="cpu")
    _, jax_score = jax_beam_search(jm, params["params"], jnp.asarray(prompt), max_new_tokens=2,
                                   beam_size=16)
    best, best_lp = None, -np.inf
    for seq in product(range(4), repeat=2):
        with torch.no_grad():
            logits = model(torch.tensor([[1, 3, 2, *seq]]))[0].double()
        lp = sum(float(torch.log_softmax(logits[2 + i], -1)[t]) for i, t in enumerate(seq))
        if lp > best_lp:
            best, best_lp = seq, lp
    assert tuple(tokens[0, 3:].tolist()) == best
    assert abs(float(score[0]) - best_lp) < 1e-4
    assert abs(float(score[0]) - float(jax_score[0])) < 1e-4


def test_eos_freezes_a_beam(lm):
    """With beam 1 the beam is the greedy path; an eos that is its first
    token leaves pad_id after it and the first token's log-probability
    as the score."""
    _, _, model = lm
    prompt = np.random.RandomState(14).randint(1, 64, (1, 5)).astype(np.int32)
    eos = int(generate(model, prompt, max_new_tokens=1, temperature=0.0, device="cpu")[0, 5])
    tokens, score = beam_search(model, prompt, max_new_tokens=6, beam_size=1, eos_id=eos,
                                pad_id=0, device="cpu")
    assert tokens[0, 5:].tolist() == [eos] + [0] * 5
    with torch.no_grad():
        lp = float(torch.log_softmax(model(torch.from_numpy(prompt))[0, -1], -1)[eos])
    assert abs(float(score[0]) - lp) < 1e-4


def test_beam_search_validation(lm):
    _, _, model = lm
    prompt = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError, match="beam_size"):
        beam_search(model, prompt, beam_size=0, device="cpu")
    with pytest.raises(ValueError, match="max_decode_len"):
        beam_search(model, prompt, max_new_tokens=61, device="cpu")
