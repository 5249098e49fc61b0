"""Heads narrower than the kernels' 64 on the CPU: the layout around the
zero-padding that lets the CUDA kernels run head_dim 8, 16 and 32.

On the card the entry points pad q, k, v (and dO) to
``kernel_head_dim`` and slice the pad off their outputs, and the model
allocates its caches at that head dim once (``cache_head_dim``), so a
decode step copies only its query. The kernels themselves are held to
their plain versions at these dims in ``tests/test_torch_kernels.py``
(marked ``cuda``). Here: the plain versions read a padded cache through
its first ``d`` columns, and the model's cache writes and reads at a
padded layout (``cache_head_dim`` patched to pad on the CPU) emit the
same greedy tokens as the unpadded layout, with the pad columns left 0.
"""

from __future__ import annotations

import pytest
import torch

from hops_tpu_torch.models import transformer as TM
from hops_tpu_torch.models.convert import random_params
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.ops import attention as A


def test_kernel_head_dim_pads_to_the_bodies_dims():
    assert [A.kernel_head_dim(d) for d in (8, 16, 32, 64, 96, 128, 192)] == [
        64, 64, 64, 64, 128, 128, 192]
    assert A.cache_head_dim(16, "cpu") == 16
    assert A.cache_head_dim(16, torch.device("cuda", 0)) == 64
    assert A.cache_head_dim(128, "cuda") == 128


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [8, 16, 32])
def test_plain_versions_read_a_padded_cache_through_its_first_columns(d, quantized):
    g = torch.Generator().manual_seed(d)
    q = torch.randn(3, 4, 2, d, generator=g)
    k, v = (torch.randn(3, 2, 40, d, generator=g) for _ in range(2))
    vl = torch.tensor([0, 17, 40])
    sc = {}
    if quantized:
        (k, sc["k_scale"]), (v, sc["v_scale"]) = A.quantize_kv(k), A.quantize_kv(v)
    kp, vp = A._pad_head(k, 64), A._pad_head(v, 64)
    assert torch.equal(A.decode_attention(q, kp, vp, vl, **sc), A.decode_attention(q, k, v, vl, **sc))
    pages = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [11, 12, 13, 14, 15]], dtype=torch.int32)
    pool = [torch.randn(2, 16, 8, d, generator=g) for _ in range(2)]
    psc = {}
    if quantized:
        (pool[0], psc["k_scale"]), (pool[1], psc["v_scale"]) = (A.quantize_kv(p) for p in pool)
    padded = [A._pad_head(p, 64) for p in pool]
    torch.testing.assert_close(A.paged_decode_attention(q, *padded, vl, pages, **psc),
                               A.paged_decode_attention(q, *pool, vl, pages, **psc),
                               rtol=0, atol=0, equal_nan=True)


def test_cache_head_dim_must_be_the_query_dim_or_its_kernel_dim():
    q = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="cache head_dim"):
        A.decode_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32), 4)
    with pytest.raises(ValueError, match="cache head_dim"):
        A.paged_decode_attention(q, torch.zeros(2, 3, 4, 32), torch.zeros(2, 3, 4, 32), 4,
                                 torch.zeros(1, 2, dtype=torch.int32))


CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, dtype="float32",
           max_decode_len=64, ragged_decode=True, device="cpu")


@pytest.mark.parametrize("lm_config", [
    {}, {"kv_cache_dtype": "int8"}, {"kv_page_size": 8, "prefill_chunk": 8},
    {"kv_cache_dtype": "int8", "kv_page_size": 8, "prefill_chunk": 8},
    {"prefixes": "shared"},
], ids=["dense", "int8", "paged", "paged-int8", "prefix"])
def test_a_padded_cache_layout_serves_the_same_tokens(lm_config, monkeypatch):
    """The engine on caches allocated at the kernels' head dim (as on the
    card) emits the tokens of the unpadded layout; the pad columns of the
    caches stay 0."""
    params = random_params(**CFG, seed=0)
    g = torch.Generator().manual_seed(0)
    prefix = torch.randint(0, 64, (9,), generator=g).tolist()
    prompts = [torch.randint(0, 64, (n,), generator=g).tolist() for n in (2, 13, 7, 5, 11)]
    model_kw = {"kv_cache_dtype": lm_config.get("kv_cache_dtype")}
    engine_kw = {k: v for k, v in lm_config.items() if k in ("kv_page_size", "prefill_chunk")}
    shared = "prefixes" in lm_config
    out = []
    for pad in (False, True):
        if pad:
            monkeypatch.setattr(TM, "cache_head_dim", lambda d, device: A.kernel_head_dim(d))
        engine = LMEngine(TM.TransformerLM(**CFG, **model_kw).load_flax(params), slots=3,
                          device="cpu", **engine_kw)
        if shared:
            engine.register_prefix("shared", prefix)
        tickets = [engine.submit(p, max_new_tokens=8, prefix_id="shared" if shared else None)
                   for p in prompts]
        results = engine.run()
        out.append([results[t] for t in tickets])
        width = engine._cache.k[0].shape[-1]
        assert width == (64 if pad else 8)
        for t in engine._cache.k + engine._cache.v:
            assert not t[..., 8:].any()
    assert out[0] == out[1]
