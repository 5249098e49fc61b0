"""The port's TransformerLM (``hops_tpu_torch.models.transformer``) against
the flax module on the same weights, fp32 on the CPU.

Weights come from ``model.init`` in JAX and cross through
``params_from_flax``. Tolerances: logits ``atol 1e-4`` (fp32 through two
layers, different summation orders), RoPE ``atol 1e-5``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.models.transformer import rotary_embedding as jax_rope
from hops_tpu_torch.models.convert import (
    flatten,
    load_npz,
    params_from_flax,
    random_params,
    save_npz,
)
from hops_tpu_torch.models.transformer import TransformerLM, rotary_embedding

CFG = dict(vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
ATOL = 1e-4


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def pair(request):
    kv = request.param
    jm = JaxLM(**CFG, dtype=jnp.float32, num_kv_heads=kv)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tm = TransformerLM(**CFG, dtype="float32", num_kv_heads=kv, device="cpu").load_flax(params)
    return jm, params, tm


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (b, s)).astype(np.int32)


def test_params_from_flax_names_and_shapes(pair):
    _, params, tm = pair
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert tuple(t.shape) == tuple(sd[name].shape), name
    assert "block_1.attn.out.kernel" in sd and "embed.embedding" in sd


def test_full_forward_logits_match(pair):
    jm, params, tm = pair
    toks = _tokens(2, 12)
    want = np.asarray(jm.apply(params, toks))
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _decode_fn(module):
    """The flax module's decode-mode apply, jitted: one compile per chunk
    shape instead of an eager trace of the interpreted kernel per call."""
    return jax.jit(lambda variables, toks: module.apply(
        variables, toks, decode=True, mutable=["cache"]
    ))


def _set_idx(cache, value):
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(value, leaf.dtype) if path[-1].key == "idx" else leaf,
        cache,
    )


def test_ragged_decode_prefill_and_steps_match(pair):
    """A fresh-cache prefill, per-row rewinds to different lengths, then
    three single-token steps on the ragged (engine) cache."""
    jm, params, tm = pair
    toks = _tokens(2, 11, seed=1)
    jr, tr = jm.clone(ragged_decode=True), tm.clone(ragged_decode=True)
    decode = _decode_fn(jr)
    logits, variables = decode(params, toks[:, :8])
    with torch.inference_mode():
        cache = tr.init_cache(2)
        got = tr(torch.from_numpy(toks[:, :8]).long(), cache, fresh=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
        lens = np.array([8, 5], np.int32)
        jcache = _set_idx(variables["cache"], lens)
        cache.idx = torch.from_numpy(lens)
        for t in range(3):
            step = toks[:, 8 + t : 9 + t]
            logits, variables = decode({**params, "cache": jcache}, step)
            jcache = variables["cache"]
            got = tr(torch.from_numpy(step).long(), cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
        assert cache.idx.tolist() == [11, 8]


def test_scalar_index_decode_matches(pair):
    """The generate() cache: one scalar index for the batch, and a warm
    multi-token append after the prefill."""
    jm, params, tm = pair
    toks = _tokens(2, 10, seed=2)
    decode = _decode_fn(jm)
    logits, variables = decode(params, toks[:, :6])
    with torch.inference_mode():
        cache = tm.init_cache(2)
        got = tm(torch.from_numpy(toks[:, :6]).long(), cache, fresh=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
        for lo, hi in ((6, 9), (9, 10)):
            logits, variables = decode({**params, "cache": variables["cache"]}, toks[:, lo:hi])
            got = tm(torch.from_numpy(toks[:, lo:hi]).long(), cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
        assert cache.idx.ndim == 0 and int(cache.idx) == 10


def test_prefill_into_rows_leaves_other_rows_untouched():
    """The engine's admission: a fresh prefill written into some rows of
    a larger cache changes nothing in the others."""
    cfg = dict(CFG, dtype="float32", ragged_decode=True)
    tm = TransformerLM(**cfg, device="cpu").load_flax(random_params(**cfg, seed=3))
    with torch.inference_mode():
        cache = tm.init_cache(3)
        tm(torch.from_numpy(_tokens(3, 7, seed=4)).long(), cache, fresh=True)
        before = [t.clone() for t in cache.k + cache.v]
        rows = torch.tensor([2, 0])
        logits = tm(torch.from_numpy(_tokens(2, 5, seed=5)).long(), cache, fresh=True, rows=rows)
        alone = tm(torch.from_numpy(_tokens(2, 5, seed=5)).long(), tm.init_cache(2), fresh=True)
        torch.testing.assert_close(logits, alone, rtol=0, atol=0)
        for old, new in zip(before, cache.k + cache.v):
            torch.testing.assert_close(new[1], old[1], rtol=0, atol=0)
            assert not torch.equal(new[0, :, :5], old[0, :, :5])
        assert cache.idx.tolist() == [5, 7, 5]


@pytest.mark.parametrize("ndim", [1, 2])
def test_rotary_embedding_matches_jax(ndim):
    x = np.random.default_rng(6).standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) + 3
    if ndim == 2:
        pos = np.stack([pos, pos * 2 + 100])
    want = np.asarray(jax_rope(x, jnp.asarray(pos)))
    got = rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_npz_roundtrip_loads_the_same_model(pair, tmp_path):
    jm, params, tm = pair
    save_npz(tmp_path / "p.npz", params)
    flat = load_npz(tmp_path / "p.npz")
    assert set(flat) == set(flatten(params))
    kv = tm.config["num_kv_heads"]
    other = TransformerLM(**CFG, dtype="float32", num_kv_heads=kv, device="cpu")
    other.load_flax(tmp_path / "p.npz")
    toks = torch.from_numpy(_tokens(1, 6)).long()
    with torch.inference_mode():
        torch.testing.assert_close(other(toks), tm(toks), rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [
    ("moe_every", 2), ("tp_shards", 2), ("attention_impl", "ring"), ("attention_impl", "ulysses"),
])
def test_later_slices_raise(field, value, pair):
    """The slices that once raised here are ported. A ``tp_shards=2``
    module holds this rank's half of the heads and of the MLP columns
    (the dense state dict's ``tp_param_specs`` shard loads into it) and
    needs its two-rank axis to run (``tests/test_torch_tp.py`` runs it
    on gloo ranks against JAX). MoE blocks and the ring/Ulysses impls
    build and run (the sequence impls over a one-rank ``seq`` mesh,
    where they equal the dense forward; MoE against
    ``tests/test_torch_moe.py``'s JAX parity)."""
    if field == "tp_shards":
        from hops_tpu_torch.parallel.tp_inference import tp_param_specs

        _, params, tm = pair
        local = TransformerLM(**CFG, dtype="float32", device="cpu", tp_axis="model",
                              num_kv_heads=tm.config["num_kv_heads"], **{field: value})
        assert local.block_0.attn.num_heads == CFG["num_heads"] // 2
        assert local.block_0.mlp.gate.kernel.shape[1] * 2 == tm.block_0.mlp.gate.kernel.shape[1]
        local.load_state_dict(tp_param_specs(tm.state_dict(), 2, 1))
        with pytest.raises(ValueError, match="not bound"):
            local(torch.from_numpy(_tokens(2, 12)).long())
        return
    from hops_tpu_torch.parallel import mesh as mesh_lib

    jm, params, tm = pair
    kw = {field: value}
    if field == "attention_impl":
        kw["mesh"] = mesh_lib.make_mesh({"seq": 1}, devices=[0])
    other = TransformerLM(**CFG, dtype="float32", device="cpu",
                          num_kv_heads=tm.config["num_kv_heads"], **kw)
    toks = torch.from_numpy(_tokens(2, 12)).long()
    if field == "moe_every":
        assert {type(b).__name__ for b in other.blocks()} == {"Block", "MoEBlock"}
        assert other.block_1.moe.w_in.shape == (8, 64, 256)
        return
    other.load_flax(params)
    with torch.inference_mode():
        torch.testing.assert_close(other(toks), tm(toks), rtol=1e-5, atol=1e-5)


def test_clone_shares_weights_or_casts_them(pair):
    _, _, tm = pair
    same = tm.clone(attention_impl="reference")
    assert same.unembed.kernel.data_ptr() == tm.unembed.kernel.data_ptr()
    cast = tm.clone(dtype="bfloat16")
    assert cast.unembed.kernel.dtype == torch.bfloat16
    torch.testing.assert_close(
        cast.unembed.kernel, tm.unembed.kernel.to(torch.bfloat16), rtol=0, atol=0
    )
    assert cast.final_norm.scale.dtype == torch.float32
