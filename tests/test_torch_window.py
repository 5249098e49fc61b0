"""Sliding-window attention in the port's engine against the JAX engine,
fp32 on the CPU: a 2-layer model whose attention sees the last 6 keys,
served dense and paged, with the fp32 and the int8 cache, at horizons 1
and 4, with a registered prefix, so that the dense engine appends each
suffix to a warm cache through ``decode_attention`` under the window
(a suffix of 18 tokens is a wide call: rows over ``SPLIT_ROWS``). The
greedy streams must be identical to the JAX engine's with the same
knobs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hops_tpu.modelrepo.lm_engine import LMEngine as JaxEngine
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.ops.attention import SPLIT_ROWS

WINDOW = 6
CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64,
           window=WINDOW)
LAYOUTS = {"dense": dict(prefill_buckets=(8, 16, 32)), "paged": dict(kv_page_size=8,
                                                                      prefill_chunk=8)}
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def workload():
    jm = JaxLM(**CFG, dtype=jnp.float32, attention_impl="reference")
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32)))
    rs = np.random.RandomState(11)
    prefix = rs.randint(1, 64, (11,)).astype(np.int32)
    # (prompt, uses the prefix): suffixes of 5 and 18 tokens and two
    # plain prompts longer than the window. The first is served alone
    # (it fills the prefix and, paged, publishes its complete page), the
    # others after it, on 2 slots.
    requests = [(rs.randint(1, 64, (5,)).astype(np.int32), True),
                (rs.randint(1, 64, (9,)).astype(np.int32), False),
                (rs.randint(1, 64, (18,)).astype(np.int32), True),
                (rs.randint(1, 64, (14,)).astype(np.int32), False)]
    assert 18 > SPLIT_ROWS
    return jm, params, prefix, requests


def _serve(engine, prefix, requests):
    engine.register_prefix("sys", prefix)
    streams = []
    for wave in (requests[:1], requests[1:]):
        tickets = [engine.submit(p, max_new_tokens=NEW_TOKENS,
                                 prefix_id="sys" if hit else None) for p, hit in wave]
        results = engine.run()
        streams += [list(results[t]) for t in tickets]
    return streams


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_windowed_engine_matches_jax(workload, layout, kv, horizon):
    """The port's engine and the JAX engine, same model, window, layout,
    cache dtype, horizon and prefix: identical greedy streams. Prefix
    hits: dense, both prefix requests, in both engines; paged, the port
    counts the second (it shares the page the first published), where
    the JAX paged engine counts no hit at all (its counter moves only on
    the dense append)."""
    jm, params, prefix, requests = workload
    knobs = dict(slots=2, decode_horizon=horizon, **LAYOUTS[layout])
    jax_engine = JaxEngine(jm.clone(ragged_decode=True, kv_cache_dtype=kv), params["params"],
                           **knobs)
    want = _serve(jax_engine, prefix, requests)
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True, kv_cache_dtype=kv,
                          device="cpu").load_flax(params)
    engine = LMEngine(model, device="cpu", **knobs)
    assert _serve(engine, prefix, requests) == want
    if layout == "dense":
        assert engine.prefix_hits == jax_engine.prefix_hits == 2
    else:
        assert engine.prefix_hits == 1
    assert all(len(s) == NEW_TOKENS for s in want)
