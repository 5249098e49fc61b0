"""The port's paged KV cache against the JAX package, fp32 on the CPU:
the ``BlockPool`` copy, the paged decode attention (K6/K7's plain
version against the Pallas ``_paged_decode_kernel`` and
``_paged_decode_q8_kernel`` in interpret mode, or the JAX reference where
the JAX package routes a page size there), ``TransformerLM(
paged_decode=True)`` and the paged serving engine with chunked prefill.

Tolerances: attention ``atol 2e-5`` (fp32, another summation order);
logits ``atol 1e-4``; greedy token streams identical. Sampled streams
are held to determinism inside the port (JAX's PRNG is not reproduced).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.modelrepo import paged as jax_paged
from hops_tpu.modelrepo.lm_engine import LMEngine as JaxEngine
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.ops import attention as J
from hops_tpu_torch.models.transformer import PagedKVCache, TransformerLM
from hops_tpu_torch.modelrepo import paged
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact
from hops_tpu_torch.ops import attention as T

CFG = dict(vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
PAGED = dict(kv_page_size=8, prefill_chunk=8)
TOL = dict(atol=2e-5, rtol=1e-5)
ATOL_LOGITS = 1e-4


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _script(mod):
    """One alloc/ref/unref sequence, recording every observable."""
    pool, log = mod.BlockPool(6), []
    a = pool.alloc(3)
    pool.ref(a[1])
    log += [a, pool.available, pool.used, pool.refcount(a[1])]
    log += [pool.unref(a[1]), pool.unref(a[1]), pool.unref_all([a[0], a[2]])]
    log += [pool.alloc(5), pool.stats()]
    with pytest.raises(mod.BlockPoolExhausted):
        pool.alloc(1)
    with pytest.raises(ValueError):
        pool.ref(99)
    with pytest.raises(ValueError):
        mod.BlockPool(1)
    return log + [pool.peak_used, pool.total]


def test_block_pool_copy_behaves_as_jax():
    assert _script(paged) == _script(jax_paged)


def _pool_inputs(page, quantized, hkv=2, nblocks=10, d=32, seed=3):
    k, v = _rand(seed, hkv, nblocks, page, d), _rand(seed + 1, hkv, nblocks, page, d)
    if not quantized:
        return [k, v], {}
    kq, ks = J.quantize_kv(jnp.asarray(k))
    vq, vs = J.quantize_kv(jnp.asarray(v))
    return [np.array(kq), np.array(vq)], dict(k_scale=np.array(ks), v_scale=np.array(vs))


PAGES = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)


def _valid(page):
    return np.array([4 * page - 2, page + 1, 0], np.int32)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("s,page,window", [
    (1, 8, None), (4, 8, None), (4, 8, 5), (1, 6, None), (4, 6, 5),
])
def test_paged_decode_attention_matches_jax(quantized, s, page, window):
    """GQA (4 q heads on 2 kv heads), ragged valid_len with a 0 row whose
    table is all zeros, one token and a chunk, page 8 (the Pallas kernel,
    interpreted) and page 6 (which the JAX package sends to its
    reference)."""
    (k, v), scales = _pool_inputs(page, quantized)
    q, vl = _rand(4, 3, 4, s, 32), _valid(page)
    want = J.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl), jnp.asarray(PAGES),
        window=window, interpret=True, **{n: jnp.asarray(a) for n, a in scales.items()})
    got = T.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(vl),
        torch.from_numpy(PAGES), window=window,
        **{n: torch.from_numpy(a) for n, a in scales.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2].any()
    gathered = T.paged_gather_kv(torch.from_numpy(k), torch.from_numpy(PAGES))
    np.testing.assert_array_equal(
        gathered.numpy(), np.asarray(J.paged_gather_kv(jnp.asarray(k), jnp.asarray(PAGES))))
    if quantized:
        sc = T.paged_gather_scales(torch.from_numpy(scales["k_scale"]), torch.from_numpy(PAGES))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(J.paged_gather_scales(
            jnp.asarray(scales["k_scale"]), jnp.asarray(PAGES))))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_scratch_block_is_unreachable(quantized):
    """Block 0 holds ±1e30 garbage (scale pools too): rows that do not map
    it below their valid length give bit-identical outputs, and the row
    whose table is all zeros gives zeros (as tests/test_ops.py checks
    the JAX kernel)."""
    (k, v), scales = _pool_inputs(8, quantized)
    q, vl = _rand(5, 3, 4, 1, 32), _valid(8)
    args = dict(window=None, **{n: torch.from_numpy(a) for n, a in scales.items()})

    def run(k, v):
        return T.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(vl), torch.from_numpy(PAGES), **args)

    clean = run(k, v)
    k2, v2 = k.copy(), v.copy()
    if quantized:
        k2[:, 0], v2[:, 0] = 127, -127
        for name in args:
            if name != "window":
                args[name] = args[name].clone()
                args[name][:, 0] = 1e30
    else:
        k2[:, 0], v2[:, 0] = 1e30, -1e30
    dirty = run(k2, v2)
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)
    assert not clean[2].any()


def _jax_pair(seed=0):
    jm = JaxLM(**CFG, dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    return jm, params


def _graft(cache, **values):
    """The cache tree with each named leaf replaced (every other leaf kept)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(values[path[-1].key], leaf.dtype)
        if path[-1].key in values else leaf, cache)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_paged_model_prefill_and_steps_match_jax(kv_cache_dtype):
    """A prefill chunk appended at index 0 through a shuffled page table
    (page 8, pad positions on the scratch block), per-row rewinds to
    different lengths, then three single-token steps."""
    jm, params = _jax_pair()
    knobs = dict(ragged_decode=True, kv_cache_dtype=kv_cache_dtype, paged_decode=True,
                 kv_page_size=8, kv_pool_blocks=12)
    jr = jm.clone(**knobs)
    tm = TransformerLM(**CFG, dtype="float32", device="cpu", **knobs).load_flax(params)
    decode = jax.jit(lambda variables, toks: jr.apply(variables, toks, decode=True,
                                                      mutable=["cache"]))
    toks = np.random.default_rng(2).integers(0, CFG["vocab_size"], (2, 12)).astype(np.int32)
    table = np.zeros((2, 8), np.int32)
    table[0, :2], table[1, :2] = [7, 3], [10, 1]
    # One call builds JAX's cache tree; then every leaf starts as the
    # port's init_cache does, with the same page table.
    _, variables = decode(params, toks[:, :1])
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (jnp.ones_like(leaf) if "scale" in path[-1].key
                            else jnp.zeros_like(leaf)), variables["cache"])
    jcache = _graft(jcache, pages=table)
    with torch.inference_mode():
        cache = tm.init_cache(2)
        assert isinstance(cache, PagedKVCache) and cache.k[0].shape == (4, 12, 8, 16)
        cache.pages.copy_(torch.from_numpy(table))
        logits, variables = decode({**params, "cache": jcache}, toks[:, :9])
        got = tm(torch.from_numpy(toks[:, :9]).long(), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL_LOGITS, rtol=0)
        lens = np.array([9, 6], np.int32)
        jcache = _graft(variables["cache"], idx=lens)
        cache.idx = torch.from_numpy(lens)
        for t in range(3):
            step = toks[:, 9 + t: 10 + t]
            logits, variables = decode({**params, "cache": jcache}, step)
            jcache = variables["cache"]
            got = tm(torch.from_numpy(step).long(), cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL_LOGITS, rtol=0)
        jk = np.asarray(jcache["block_1"]["attn"]["k"])
        np.testing.assert_allclose(cache.k[1][:, [7, 3, 10, 1]].float().numpy(),
                                   jk[:, [7, 3, 10, 1]].astype(np.float32), atol=1e-4, rtol=0)
        assert cache.idx.tolist() == [12, 9]
        with pytest.raises(ValueError, match="paged cache"):
            tm(torch.from_numpy(toks[:, :2]).long(), cache, fresh=True)


def _prompts(seed, n=6, lo=3, hi=30):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 64, (rs.randint(lo, hi),)).astype(np.int32) for _ in range(n)]


def _run(engine, prompts, kws):
    tickets = [engine.submit(p, **kw) for p, kw in zip(prompts, kws)]
    res = engine.run()
    return [res[t] for t in tickets]


@pytest.fixture(scope="module")
def jax_paged_streams():
    """Greedy streams of the JAX paged engine (page 8, chunk 8, 2 slots)
    for the fp32 and the int8 pool, on one mixed short/long workload."""
    jm, params = _jax_pair(seed=1)
    prompts = _prompts(0)
    kws = [{"max_new_tokens": 10}] * len(prompts)
    want = {}
    for dt in (None, "int8"):
        engine = JaxEngine(jm.clone(ragged_decode=True, kv_cache_dtype=dt), params["params"],
                           slots=2, **PAGED)
        want[dt] = _run(engine, prompts, kws)
    return params, prompts, kws, want


def _model(params, **kw):
    return TransformerLM(**CFG, dtype="float32", ragged_decode=True, device="cpu",
                         **kw).load_flax(params)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_paged_engine_matches_jax_and_the_dense_engine(jax_paged_streams, kv_cache_dtype):
    """The JAX engine's streams with the same knobs; the port's dense
    engine at the same cache dtype; every block back in the pool; long
    prompts prefilled in several chunks."""
    params, prompts, kws, want = jax_paged_streams
    model = _model(params, kv_cache_dtype=kv_cache_dtype)
    engine = LMEngine(model, slots=2, device="cpu", **PAGED)
    assert _run(engine, prompts, kws) == want[kv_cache_dtype]
    dense = LMEngine(model, slots=2, prefill_buckets=(8, 16, 32), device="cpu")
    assert _run(dense, prompts, kws) == want[kv_cache_dtype]
    stats = engine.stats()
    assert engine._pool.used == 0 and stats["blocks_used"] == 0
    assert stats["cache_layout"] == "paged" and stats["prefill_chunks"] > len(prompts)
    assert stats["blocks_total"] == 2 * 8 and stats["blocks_peak_used"] > 0
    assert engine.model.paged_decode and not model.paged_decode


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_chunk_size_and_page_size_do_not_change_streams(jax_paged_streams, kv_cache_dtype):
    """The chunk width and the page size are scheduling knobs, not
    numerics knobs: chunks of 4, 8 and 32 and pages of 8 and 6 give the
    JAX engine's streams."""
    params, prompts, kws, want = jax_paged_streams
    model = _model(params, kv_cache_dtype=kv_cache_dtype)
    for page, chunk in ((8, 4), (8, 32), (6, 5)):
        engine = LMEngine(model, slots=2, kv_page_size=page, prefill_chunk=chunk, device="cpu")
        assert _run(engine, prompts, kws) == want[kv_cache_dtype], (page, chunk)


def test_sampled_paged_streams_equal_the_dense_engine(jax_paged_streams):
    """Sampled rows (temperature, top-k, top-p, seed) and eos truncation:
    the (seed, token index) keys make the stream independent of the
    layout."""
    params, prompts, _, _ = jax_paged_streams
    kws = [
        {"max_new_tokens": 8, "temperature": 0.8, "top_k": 8, "seed": 11},
        {"max_new_tokens": 6, "temperature": 1.1, "top_p": 0.9, "seed": 12},
        {"max_new_tokens": 9},
        {"max_new_tokens": 7, "eos_id": 5},
        {"max_new_tokens": 5, "temperature": 0.5, "seed": 13},
    ]
    model = _model(params)
    got = _run(LMEngine(model, slots=2, device="cpu", **PAGED), prompts[:5], kws)
    assert got == _run(LMEngine(model, slots=2, prefill_buckets=(8, 16, 32), device="cpu"),
                       prompts[:5], kws)


def test_pool_exhaustion_queues_and_oversize_requests_are_refused(jax_paged_streams):
    """A pool too small for the whole queue admits what fits and queues
    the rest, with streams unchanged; a request deeper than the whole
    pool is refused at submit."""
    params, _, _, _ = jax_paged_streams
    model = _model(params)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, 64, (20,)) for _ in range(4)]
    kws = [{"max_new_tokens": 8}] * 4
    # 8 usable blocks; each request needs 3 for its prompt and up to 4
    # at its deepest write: the pool cannot hold all four at once.
    engine = LMEngine(model, slots=4, kv_page_size=8, kv_pool_blocks=9, prefill_chunk=8,
                      device="cpu")
    tickets = [engine.submit(p, **kw) for p, kw in zip(prompts, kws)]
    engine.step()
    assert engine.stats()["queued"] > 0
    res = engine.run()
    dense = LMEngine(model, slots=4, prefill_buckets=(8, 16, 32), device="cpu")
    assert [res[t] for t in tickets] == _run(dense, prompts, kws)
    assert engine._pool.used == 0 and engine.stats()["blocks_peak_used"] == 8
    tiny = LMEngine(model, slots=2, kv_page_size=8, kv_pool_blocks=5, prefill_chunk=8,
                    device="cpu")
    with pytest.raises(ValueError, match="KV blocks"):
        tiny.submit(rs.randint(1, 64, (30,)), max_new_tokens=8)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_preemption_replays_identically(jax_paged_streams, kv_cache_dtype, sampled):
    """Decode growth on a dry pool preempts the newest request (its
    blocks freed, the request requeued at the front) and the replay
    gives the same stream; TTFT is observed once per request."""
    params, _, _, _ = jax_paged_streams
    model = _model(params, kv_cache_dtype=kv_cache_dtype)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 64, (20,)), rs.randint(1, 64, (20,))]
    kws = [{"max_new_tokens": 20}, {"max_new_tokens": 20}]
    if sampled:
        kws = [dict(kw, temperature=0.7, seed=s) for kw, s in zip(kws, (5, 9))]
    engine = LMEngine(model, slots=2, kv_page_size=8, kv_pool_blocks=9, prefill_chunk=8,
                      device="cpu")
    tickets = [engine.submit(p, **kw) for p, kw in zip(prompts, kws)]
    res = engine.run()
    dense = LMEngine(model, slots=2, prefill_buckets=(8, 32), device="cpu")
    assert [res[t] for t in tickets] == _run(dense, prompts, kws)
    assert engine.preemptions > 0 and engine.stats()["preemptions"] == engine.preemptions
    assert engine._pool.used == 0
    assert set(engine.ttft_s) == set(tickets)


def test_invalid_paged_configs_raise(jax_paged_streams):
    params, _, _, _ = jax_paged_streams
    model = _model(params)
    with pytest.raises(ValueError, match="prefill_chunk requires"):
        LMEngine(model, prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="kv_pool_blocks"):
        LMEngine(model, kv_page_size=8, kv_pool_blocks=1, device="cpu")
    with pytest.raises(ValueError, match="kv_page_size"):
        LMEngine(model, kv_page_size=0, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk must be"):
        LMEngine(model, kv_page_size=8, prefill_chunk=65, device="cpu")
    with pytest.raises(ValueError, match="None or 'int8'"):
        _model(params, kv_cache_dtype="fp8")
    with pytest.raises(ValueError, match="ragged_decode"):
        TransformerLM(**CFG, paged_decode=True, kv_pool_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="kv_pool_blocks >= 2"):
        _model(params, paged_decode=True)


def test_predictor_serves_the_paged_cache(jax_paged_streams, tmp_path):
    """``lm_config`` turns on the paged int8 engine, as the JAX
    predictor's does."""
    params, prompts, kws, want = jax_paged_streams
    save_lm_artifact(tmp_path / "lm", dict(CFG, dtype="float32"), params)
    predictor = LMEnginePredictor(
        tmp_path / "lm", {"slots": 2, "kv_cache_dtype": "int8", "kv_page_size": 8,
                          "kv_pool_blocks": 17, "prefill_chunk": 8}, device="cpu")
    try:
        got = predictor.predict([{"prompt": p.tolist(), **kw} for p, kw in zip(prompts, kws)])
        assert got == want["int8"]
        stats = predictor.stats()
        assert stats["cache_layout"] == "paged" and stats["blocks_total"] == 16
        assert predictor.engine.model.kv_cache_dtype == "int8"
    finally:
        predictor.stop()
