"""The port's int8 KV cache against the JAX package, fp32 on the CPU:
``quantize_kv``, the int8 decode attention (K5's plain version against
the Pallas ``_decode_q8_kernel`` in interpret mode), ``TransformerLM(
kv_cache_dtype="int8")`` and the dense int8 serving engine.

Tolerances: int8 values exactly equal, scales within 1 ulp; attention
``atol 2e-5`` (fp32, another summation order); logits ``atol 1e-4``;
greedy token streams identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.modelrepo.lm_engine import LMEngine as JaxEngine
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.ops import attention as J
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact
from hops_tpu_torch.ops import attention as T

CFG = dict(vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
TOL = dict(atol=2e-5, rtol=1e-5)
ATOL_LOGITS = 1e-4


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_quantize_kv_matches_jax_exactly():
    x = _rand(0, 3, 2, 17, 32) * 3.0
    x[0, 0, 0] = 0.0  # all-zero row: the eps floor
    x[1, 1, 2, :5] = [127.0, 2.5, -3.5, 0.5, -126.5]  # scale 1: ties round to even
    x[1, 1, 2, 5:] = 0.0
    want_q, want_s = J.quantize_kv(jnp.asarray(x))
    got_q, got_s = T.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_max_ulp(got_s.numpy(), np.asarray(want_s), maxulp=1)
    assert got_q[1, 1, 2, :5].tolist() == [127, 2, -4, 0, -126]
    np.testing.assert_array_equal(
        T.dequantize_kv(got_q, got_s).numpy(),
        np.asarray(J.dequantize_kv(want_q, want_s)),
    )


@pytest.mark.parametrize("s,hkv,window", [(1, 4, None), (4, 2, None), (1, 2, 24), (4, 4, 24)])
def test_decode_attention_q8_matches_jax(s, hkv, window):
    """GQA and MHA, one token and a chunk, ragged valid_len with a 0
    row and a full one, with and without a window."""
    q = _rand(1, 3, 4, s, 32)
    kq, ks = J.quantize_kv(jnp.asarray(_rand(2, 3, hkv, 64, 32)))
    vq, vs = J.quantize_kv(jnp.asarray(_rand(3, 3, hkv, 64, 32)))
    vl = np.array([0, 17, 64], np.int32)
    want = J.decode_attention_q8(jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(vl), window=window)
    cache = [torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)]
    got = T.decode_attention_q8(torch.from_numpy(q), *cache, torch.from_numpy(vl), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()
    with pytest.raises(ValueError, match="both"):
        T.decode_attention(torch.from_numpy(q), *cache[:2], vl, k_scale=cache[2])


def _jax_pair(num_kv_heads=None, seed=0):
    jm = JaxLM(**CFG, dtype=jnp.float32, num_kv_heads=num_kv_heads)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    return jm, params


def _set_idx(cache, value):
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(value, leaf.dtype) if path[-1].key == "idx" else leaf,
        cache,
    )


@pytest.mark.parametrize("num_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_int8_cache_prefill_and_steps_match_jax(num_kv_heads):
    """A fresh int8 prefill (read back quantized, no flash shortcut), per-row
    rewinds to different lengths, then three single-token steps."""
    jm, params = _jax_pair(num_kv_heads)
    jr = jm.clone(ragged_decode=True, kv_cache_dtype="int8")
    tm = TransformerLM(**CFG, dtype="float32", num_kv_heads=num_kv_heads, ragged_decode=True,
                       kv_cache_dtype="int8", device="cpu").load_flax(params)
    decode = jax.jit(lambda variables, toks: jr.apply(variables, toks, decode=True,
                                                      mutable=["cache"]))
    toks = np.random.default_rng(1).integers(0, CFG["vocab_size"], (2, 11)).astype(np.int32)
    logits, variables = decode(params, toks[:, :8])
    with torch.inference_mode():
        cache = tm.init_cache(2)
        assert cache.k[0].dtype == torch.int8 and cache.k_scale[0].shape == (2, tm.block_0.attn.kv_heads, 64)
        got = tm(torch.from_numpy(toks[:, :8]).long(), cache, fresh=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL_LOGITS, rtol=0)
        jk = np.asarray(variables["cache"]["block_1"]["attn"]["k"])
        np.testing.assert_array_equal(cache.k[1].numpy()[:, :, :8], jk[:, :, :8])
        lens = np.array([8, 5], np.int32)
        jcache = _set_idx(variables["cache"], lens)
        cache.idx = torch.from_numpy(lens)
        for t in range(3):
            step = toks[:, 8 + t: 9 + t]
            logits, variables = decode({**params, "cache": jcache}, step)
            jcache = variables["cache"]
            got = tm(torch.from_numpy(step).long(), cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL_LOGITS, rtol=0)


def _prompts(seed=21, n=6, lo=3, hi=30):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 64, (rs.randint(lo, hi),)).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def int8_engine_streams():
    """The JAX dense int8 engine's greedy streams on a mixed workload."""
    jm, params = _jax_pair(seed=3)
    prompts = _prompts()
    engine = JaxEngine(jm.clone(ragged_decode=True, kv_cache_dtype="int8"), params["params"],
                       slots=2, prefill_buckets=(8, 16, 32))
    tickets = [engine.submit(p, max_new_tokens=10) for p in prompts]
    res = engine.run()
    return params, prompts, [res[t] for t in tickets]


def test_dense_int8_engine_matches_jax(int8_engine_streams):
    params, prompts, want = int8_engine_streams
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True, kv_cache_dtype="int8",
                          device="cpu").load_flax(params)
    engine = LMEngine(model, slots=2, prefill_buckets=(8, 16, 32), device="cpu")
    tickets = [engine.submit(p, max_new_tokens=10) for p in prompts]
    res = engine.run()
    assert [res[t] for t in tickets] == want
    assert engine.stats()["cache_layout"] == "dense"


def test_predictor_serves_the_int8_cache(int8_engine_streams, tmp_path):
    params, prompts, want = int8_engine_streams
    save_lm_artifact(tmp_path / "lm", dict(CFG, dtype="float32"), params)
    predictor = LMEnginePredictor(tmp_path / "lm", {"slots": 2, "kv_cache_dtype": "int8",
                                                    "prefill_buckets": [8, 16, 32]},
                                  device="cpu")
    try:
        assert predictor.engine.model.kv_cache_dtype == "int8"
        got = predictor.predict([{"prompt": p.tolist(), "max_new_tokens": 10} for p in prompts])
        assert got == want
    finally:
        predictor.stop()


def test_int8_sampled_streams_are_deterministic(int8_engine_streams):
    """Sampled rows are held to determinism inside the port: the same
    (seed, token index) keys give the same stream in any slot company."""
    params, prompts, _ = int8_engine_streams
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True, kv_cache_dtype="int8",
                          device="cpu").load_flax(params)
    knobs = dict(max_new_tokens=8, temperature=0.9, top_k=20, seed=7)

    def run(company):
        engine = LMEngine(model, slots=2, device="cpu")
        if company:
            engine.submit(prompts[2], max_new_tokens=5)
        t = engine.submit(prompts[0], **knobs)
        return engine.run()[t]

    assert run(False) == run(True)
