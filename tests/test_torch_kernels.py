"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: bf16 inputs against the fp32 plain version, ``max err <=
2e-2 + 2e-2 * max|plain|``; fp32 inputs ``atol 1e-5`` (same arithmetic,
another summation order).
"""

from __future__ import annotations

import pytest
import torch

from hops_tpu_torch.ops import attention as T

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close_bf16(out, ref):
    ref = torch.nan_to_num(ref.float(), nan=0.0)
    tol = 2e-2 + 2e-2 * ref.abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (16, 16, True, None), (1000, 1000, True, None), (300, 300, False, None),
    (512, 512, True, 100), (64, 1024, True, None), (1, 70, True, None),
])
def test_flash_kernel_matches_plain(d, sq, sk, causal, window):
    dev = _card()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, n, d, generator=g).to(dev, torch.bfloat16) for n in (sq, sk, sk))
    before = T.launch_counts()["flash_fwd"]
    o, lse = T.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    assert T.launch_counts()["flash_fwd"] == before + 1
    f = [t.float() for t in (q, k, v)]
    _close_bf16(o, T.attention_reference(*f, causal=causal, window=window))
    _close_bf16(lse, T.attention_lse_reference(*f[:2], causal=causal, window=window))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv,s,window", [(8, 1, None), (2, 5, None), (8, 1, 256), (2, 3, 100)])
def test_decode_kernel_matches_plain(d, hkv, s, window):
    dev = _card()
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 8, s, d, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(4, hkv, 2048, d, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    vl = torch.tensor([0, 1, 700, 2048], dtype=torch.int32, device=dev)
    before = T.launch_counts()["decode_attention"]
    o = T.decode_attention(q, k, v, vl, window=window)
    assert T.launch_counts()["decode_attention"] == before + 1
    _close_bf16(o, T.decode_attention_reference(q.float(), k.float(), v.float(), vl, window=window))
    assert not o[0].any()


def test_fp32_kernels_match_plain_closely():
    dev = _card()
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 2, 200, 64, generator=g).to(dev) for _ in range(3))
    torch.testing.assert_close(
        T.flash_attention(q, k, v, causal=True),
        T.attention_reference(q, k, v, causal=True), atol=1e-5, rtol=1e-5,
    )
    vl = torch.tensor([150], dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        T.decode_attention(q[:, :, :2], k, v, vl),
        T.decode_attention_reference(q[:, :, :2], k, v, vl), atol=1e-5, rtol=1e-5,
    )


def test_decode_kernel_ignores_garbage_past_valid_len():
    dev = _card()
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 1, 1, 64, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(1, 1, 256, 64, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    clean = T.decode_attention(q, k, v, 100)
    k[:, :, 100:] = 1e30
    v[:, :, 100:] = -1e30
    torch.testing.assert_close(T.decode_attention(q, k, v, 100), clean, rtol=0, atol=0)


def test_unsupported_head_dim_raises_on_the_card():
    dev = _card()
    q = torch.zeros(1, 1, 8, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        T.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        T.decode_attention(q[:, :, :1], q, q, 4)


def test_engine_on_the_card_matches_the_cpu():
    """A small fp32 model served on the card (kernels) emits the same
    greedy tokens as on the CPU (plain versions)."""
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine

    dev = _card()
    cfg = dict(vocab_size=128, d_model=128, num_heads=2, num_layers=2, dtype="float32",
               max_decode_len=256, ragged_decode=True)
    params = random_params(**cfg, seed=4)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 128, (n,), generator=g).tolist() for n in (7, 40, 100)]
    out = []
    for device in ("cpu", dev):
        engine = LMEngine(TransformerLM(**cfg, device=device).load_flax(params), slots=2,
                          device=device)
        tickets = [engine.submit(p, max_new_tokens=12) for p in prompts]
        results = engine.run()
        out.append([results[t] for t in tickets])
    assert out[0] == out[1]
