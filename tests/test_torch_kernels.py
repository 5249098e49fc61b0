"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: the bf16 tensor-core bodies (K1's o, K2's dq, K3's dk and
dv, K4's and K5's wide o on K1's body over bf16 and int8 K/V, the
prefill-chunk o of K6 and K7) against the fp32 plain version
per element within their rounding, ``2**-8 * (mag + |plain|) + slack``
(``mag``: the product whose operand the body rounds to bf16, over
magnitudes, with int8 values dequantized; ``slack``: the kernel's fp32
bound), and K1's lse within ``1e-4``; the split-K body of K4-K7, which
computes in fp32 and rounds only its output, per element within
``2**-8 * |plain| + 1e-4``; fp32 inputs ``atol 1e-5`` for the forward
and decode kernels, ``atol 1e-4`` for the int8 and paged decode kernels
at capacity 2048 (the phase-3 rule of ``chip_smoke.py``) and ``1e-4 *
max(1, max|plain|)`` for the backward kernels, whose outputs grow with
the row length (same arithmetic, another summation order); gradients
and weights of a train step ``1e-4``; the scratch-block and poisoned-slot
checks and two launches of the bf16 flash kernels on the same inputs
are bit-exact.
"""

from __future__ import annotations

import pytest
import torch

from hops_tpu_torch.ops import attention as T
from hops_tpu_torch.ops.kernel_checks import (Q8_SPLIT_CASES, WIDE_CASES, dense_poisoned, q8_call,
                                              q8_operands, q8_plain, q8_poisoned, shuffled_table,
                                              wide_lengths)

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _close_rounded(out, ref, mag, slack):
    """A bf16 tensor-core body, per element: ``|out - ref| <= 2**-8 * (mag
    + |ref|) + slack``; a NaN in ``ref`` (a row that sees no key) is 0."""
    ref, mag = (torch.nan_to_num(t.float(), nan=0.0) for t in (ref, mag))
    bound = 2.0 ** -8 * (mag + ref.abs()) + slack
    assert torch.isfinite(out.float()).all()
    assert ((out.float() - ref).abs() <= bound).all()


def _bwd_magnitudes(q, k, v, do, lse, delta, causal, q_offset, window):
    """``mag`` of K2's dq (``|ds| |k|``: dS rounded), K3's dk (``|ds|^T
    |q|``: dS^T rounded) and dv (``p^T |do|``: P^T rounded), fp32."""
    sm_scale, q_offset = T._attention_args(q, k, causal, None, q_offset, window)
    p, ds = T._bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, q_offset, window)
    return (torch.einsum("bhqk,bhkd->bhqd", ds.abs(), k.abs()),
            torch.einsum("bhqk,bhqd->bhkd", ds.abs(), q.abs()),
            torch.einsum("bhqk,bhqd->bhkd", p, do.abs()))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (16, 16, True, None), (1000, 1000, True, None), (300, 300, False, None),
    (512, 512, True, 100), (64, 1024, True, None), (1, 70, True, None),
    # around the bf16 body's 128-row tiles; one query row; a window
    # wider than a tile, so its edge crosses tiles
    (127, 127, True, None), (128, 128, True, None), (129, 129, False, None),
    (255, 255, True, None), (1, 255, False, None), (300, 300, True, 130),
    # blocks that walk 1, 2 and 3 key tiles: odd and even turns of the
    # two warpgroups' ping-pong, and a refill of the 3-stage ring
    (128, 256, False, None), (128, 384, False, None), (384, 384, True, None),
    (100, 512, False, None),
])
def test_flash_kernel_matches_plain(d, sq, sk, causal, window):
    dev = _card()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, n, d, generator=g).to(dev, torch.bfloat16) for n in (sq, sk, sk))
    before = T.launch_counts()["flash_fwd"]
    o, lse = T.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    assert T.launch_counts()["flash_fwd"] == before + 1
    f = [t.float() for t in (q, k, v)]
    mag = T.attention_reference(*f[:2], f[2].abs(), causal=causal, window=window)
    _close_rounded(o, T.attention_reference(*f, causal=causal, window=window), mag, 1e-4)
    ref_lse = T.attention_lse_reference(*f[:2], causal=causal, window=window)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (16, 16, True, None, None), (1000, 1000, True, None, None), (300, 300, False, None, None),
    (512, 512, True, 100, None), (64, 1024, True, None, None),
    (200, 333, True, 64, 150),  # keys 0..86 seen by no query
    (128, 128, True, None, -40),  # rows 0..39 see no key
    # around the bf16 bodies' tiles (K2: 128 queries x 64 keys; K3: 128
    # keys x 64 queries); one query row; a window wider than a tile
    (127, 127, True, None, None), (128, 128, False, None, None), (129, 129, True, None, None),
    (255, 255, True, None, None), (1, 255, True, None, None), (300, 300, True, 130, None),
    (63, 63, True, None, None), (64, 64, False, None, None), (65, 65, True, None, None),
    (1, 1, True, None, None), (65, 129, True, None, None),
])
def test_flash_bwd_kernels_match_plain(dtype, d, sq, sk, causal, window, q_offset):
    """K2 and K3 against their plain versions on the same (o, lse) from
    K1; rows that see no key and keys that no query sees are exactly 0."""
    dev = _card()
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 4, n, d, generator=g).to(dev, dtype) for n in (sq, sk, sk))
    do = torch.randn(2, 4, sq, d, generator=g).to(dev, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = T.flash_attention(q, k, v, return_lse=True, **kw)
    delta = (o.float() * do.float()).sum(-1)
    before = T.launch_counts()
    dq = T.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = T.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    after = T.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    f = [t.float() for t in (q, k, v, do)]
    ref_dq = T.flash_bwd_dq_reference(*f, lse, delta, **kw)
    ref_dk, ref_dv = T.flash_bwd_dkv_reference(*f, lse, delta, **kw)
    mags = _bwd_magnitudes(*f, lse, delta, **kw)
    for out, ref, mag in zip((dq, dk, dv), (ref_dq, ref_dk, ref_dv), mags):
        assert out.dtype == dtype
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        if dtype == torch.float32:
            assert (out - ref).abs().max().item() <= tol
        else:
            _close_rounded(out, ref, mag, tol)
    if q_offset == -40:
        assert not dq[:, :, :40].any()
    if q_offset == 150:
        assert not dk[:, :, :87].any() and not dv[:, :, :87].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,window,q_offset,unseen", [
    (128, 128, None, -40, 40),  # rows 0..39 see no key
    (200, 333, 64, 150, 0),  # every row sees a key; keys 0..86 are seen by none
    (300, 200, 50, -250, 250),  # rows 0..249 see no key: whole 128-row tiles and part of one
])
def test_flash_kernel_rows_that_see_no_key(dtype, d, sq, sk, window, q_offset, unseen):
    """K1 with a q_offset: rows that see no key return lse -inf and
    o exactly 0; every other row matches the plain version."""
    dev = _card()
    g = torch.Generator().manual_seed(15)
    q, k, v = (torch.randn(2, 4, n, d, generator=g).to(dev, dtype) for n in (sq, sk, sk))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    o, lse = T.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.isneginf(lse[:, :, :unseen]).all() and not o[:, :, :unseen].any()
    assert torch.isfinite(lse[:, :, unseen:]).all()
    f = [t.float() for t in (q, k, v)]
    ref, ref_lse = T.attention_reference(*f, **kw), T.attention_lse_reference(*f[:2], **kw)
    if dtype == torch.bfloat16:
        _close_rounded(o, ref, T.attention_reference(*f[:2], f[2].abs(), **kw), 1e-4)
    else:
        assert (o - torch.nan_to_num(ref, nan=0.0)).abs().max().item() <= 1e-5
    assert (lse - ref_lse)[:, :, unseen:].abs().max().item() <= 1e-4


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_flash_kernels_are_bit_reproducible(d):
    """Two launches of K1, K2 and K3 on the same bf16 inputs give the
    same bits (no atomics, a fixed summation order)."""
    dev = _card()
    g = torch.Generator().manual_seed(16)
    q, k, v, do = (torch.randn(2, 8, 1000, d, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    runs = []
    for _ in range(2):
        o, lse = T.flash_attention(q, k, v, causal=True, window=300, return_lse=True)
        delta = (o.float() * do.float()).sum(-1)
        runs.append((o, lse, T.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, window=300),
                     *T.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, window=300)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_autograd_on_the_card_matches_the_cpu():
    """Gradients through the autograd Function: K1/K2/K3 on the card
    against the plain versions on the CPU, fp32, GQA through repeat_kv."""
    dev = _card()
    g = torch.Generator().manual_seed(7)
    leaves = [torch.randn(2, h, 300, 64, generator=g) for h in (8, 2, 2)]
    cot = torch.randn(2, 8, 300, 64, generator=g)
    grads = []
    for device in ("cpu", dev):
        ts = [t.detach().to(device).requires_grad_(True) for t in leaves]
        k, v = T.repeat_kv(*ts)
        o = T.flash_attention(ts[0], k, v, causal=True, window=100)
        (o * cot.to(device)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv,s,window", [(8, 1, None), (2, 5, None), (8, 1, 256), (2, 3, 100)])
def test_decode_kernel_matches_plain(d, hkv, s, window):
    dev = _card()
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 8, s, d, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(4, hkv, 2048, d, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    vl = torch.tensor([0, 1, 700, 2048], dtype=torch.int32, device=dev)
    # Calls of more than SPLIT_ROWS rows run K1's forward body, counted apart.
    split = (8 // hkv) * s <= T.SPLIT_ROWS
    name = "decode_attention" if split else "decode_attention_chunk"
    before = T.launch_counts()[name]
    o = T.decode_attention(q, k, v, vl, window=window)
    assert T.launch_counts()[name] == before + 1
    f = [t.float() for t in (q, k, v)]
    ref = T.decode_attention_reference(*f, vl, window=window)
    if split:
        _close_rounded(o, ref, torch.zeros_like(ref), 1e-4)  # the split body: output rounding
    else:  # the forward body rounds p for p·v
        _close_rounded(o, ref, T.decode_attention_reference(*f[:2], f[2].abs(), vl, window=window),
                       1e-4)
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


@pytest.mark.parametrize("h,hkv,s", [(1, 1, 1), (8, 2, 40)], ids=["split", "wide"])
def test_decode_kernel_ignores_garbage_past_valid_len(h, hkv, s):
    """K4 with NaN and +-1e30 in the cache slots at or past valid_len (K
    and V): the split body (one row) and the forward body (rows 160, a
    key tile that crosses valid_len) give the same bits."""
    dev = _card()
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, h, s, 64, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(1, hkv, 256, 64, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    vl = torch.tensor([100], dtype=torch.int32, device=dev)
    clean = T.decode_attention(q, k, v, vl)
    torch.testing.assert_close(T.decode_attention(q, *dense_poisoned(k, v, vl), vl), clean,
                               rtol=0, atol=0)


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


def test_train_step_on_the_card_matches_the_cpu():
    """Two fp32 train steps (chunked loss, Adam) of a small GQA model on
    the card (K1/K2/K3) against the same steps on the CPU (plain
    versions): both losses, and every gradient of the first step within
    ``1e-4 * ||g_cpu||inf``. Weights after Adam are not compared: its
    first update ``lr * g / (|g| + eps)`` turns a gradient difference at
    rounding level into a weight difference of up to ``lr * |dg| / eps``
    wherever ``|g|`` is near ``eps``."""
    from hops_tpu_torch.models.common import create_train_state
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step

    dev = _card()
    cfg = dict(vocab_size=256, d_model=256, num_heads=2, num_layers=2, dtype="float32",
               num_kv_heads=1)
    params = random_params(**cfg, seed=8)
    tokens = torch.randint(0, 256, (2, 300), generator=torch.Generator().manual_seed(9))
    runs = []
    for device in ("cpu", dev):
        state = create_train_state(TransformerLM(**cfg, device=device).load_flax(params), seed=0)
        step = make_lm_train_step(loss_chunk=128)
        before = T.launch_counts()["flash_bwd_dkv"]
        state, first = step(state, {"tokens": tokens})
        grads = {n: p.grad.cpu().clone() for n, p in state.model.named_parameters()}
        state, second = step(state, {"tokens": tokens})
        runs.append(([first["loss"].item(), second["loss"].item()], grads,
                     T.launch_counts()["flash_bwd_dkv"] - before))
    (cpu_losses, cpu_g, cpu_n), (gpu_losses, gpu_g, gpu_n) = runs
    assert cpu_n == 0 and gpu_n == 4
    torch.testing.assert_close(torch.tensor(gpu_losses), torch.tensor(cpu_losses),
                               atol=1e-4, rtol=1e-4)
    for name, g in cpu_g.items():
        assert (gpu_g[name] - g).abs().max() <= 1e-4 * g.abs().max(), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv,s,window", [(8, 1, None), (2, 256, None), (2, 1, 256), (8, 5, 100)])
def test_decode_q8_kernel_matches_plain(dtype, d, hkv, s, window):
    """K5: decode calls on the int8 split body (bf16: output rounding),
    the wide bf16 call (rows 1024) on the int8 chunk body (its rounding
    bound, ``mag`` from the dequantized |v|), fp32 within 1e-4."""
    dev = _card()
    g = torch.Generator().manual_seed(11)
    q = torch.randn(4, 8, s, d, generator=g).to(dev, dtype)
    (kq, ks), (vq, vs) = (T.quantize_kv(torch.randn(4, hkv, 2048, d, generator=g).to(dev))
                          for _ in range(2))
    vl = torch.tensor([0, 1, 700, 2048], dtype=torch.int32, device=dev)
    wide = (8 // hkv) * s > T.SPLIT_ROWS
    name = "decode_attention_q8_chunk" if wide and dtype == torch.bfloat16 else "decode_attention_q8"
    before = T.launch_counts()
    o = T.decode_attention_q8(q, kq, vq, ks, vs, vl, window=window)
    after = T.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ref = T.decode_attention_q8_reference(q.float(), kq, vq, ks, vs, vl, window=window)
    if dtype == torch.bfloat16 and not wide:
        _close_rounded(o, ref, torch.zeros_like(ref), 1e-4)  # the split body: output rounding
    elif dtype == torch.bfloat16:  # the chunk body rounds p * v_scale for p·v
        mag = T.decode_attention_q8_reference(q.float(), kq, vq.abs(), ks, vs, vl, window=window)
        _close_rounded(o, ref, mag, 1e-4)
    else:
        assert (o - torch.nan_to_num(ref, nan=0.0)).abs().max().item() <= 1e-4
    assert not o[0].any()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16pool", "int8pool"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("page", [64, 16, 24])
@pytest.mark.parametrize("d,hkv,s", [(128, 8, 1), (64, 2, 256)])
def test_paged_kernels_match_plain(quantized, dtype, page, d, hkv, s):
    """K6 / K7 on a shuffled table, ragged valid_len (0, 1, a page
    boundary + 1, full capacity), every page size on the kernel: the
    launch count proves that page 24 is not routed elsewhere."""
    dev = _card()
    g = torch.Generator().manual_seed(12)
    valid = [0, 1, 3 * page + 1, -(-2048 // page) * page]
    pages, nblocks = shuffled_table(page, 2048, valid, g, dev)
    q = torch.randn(4, 8, s, d, generator=g).to(dev, dtype)
    pools = [torch.randn(hkv, nblocks, page, d, generator=g).to(dev) for _ in range(2)]
    scales = {}
    if quantized:
        (k, scales["k_scale"]), (v, scales["v_scale"]) = (T.quantize_kv(p) for p in pools)
    else:
        k, v = (p.to(dtype) for p in pools)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    wide = (8 // hkv) * s > T.SPLIT_ROWS
    name = "paged_decode_attention_q8" if quantized else "paged_decode_attention"
    if wide and dtype == torch.bfloat16:
        name += "_chunk"
    before = T.launch_counts()
    o = T.paged_decode_attention(q, k, v, vl, pages, window=256, **scales)
    after = T.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    kf, vf = (k, v) if quantized else (k.float(), v.float())
    ref = T.paged_decode_attention_reference(q.float(), kf, vf, vl, pages, window=256, **scales)
    if dtype == torch.bfloat16 and not wide:
        _close_rounded(o, ref, torch.zeros_like(ref), 1e-4)  # the split body: output rounding
    elif dtype == torch.bfloat16:  # the chunk body rounds p (int8: p * v_scale) for p·v
        mag = T.paged_decode_attention_reference(q.float(), kf, vf.abs(), vl, pages, window=256,
                                                 **scales)
        _close_rounded(o, ref, mag, 1e-4)
    else:
        assert (o - torch.nan_to_num(ref.float(), nan=0.0)).abs().max().item() <= 1e-4
    assert not o[0].any()


@pytest.mark.parametrize("s", [1, 40], ids=["decode", "chunk"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32pool", "int8pool"])
def test_paged_kernels_never_read_the_scratch_block(quantized, s):
    """Block 0 filled with ±1e30 and NaN (int8: ±127 values, NaN and
    1e30 scales): outputs bit-identical, since no row maps block 0 below
    its valid length. One token (rows 4: K6's split body, 8 splits) and a
    40-token chunk (rows 160: the 64-row body)."""
    dev = _card()
    g = torch.Generator().manual_seed(13)
    valid = [0, 17, 63, 1000]
    pages, nblocks = shuffled_table(16, 2048, valid, g, dev)
    q = torch.randn(4, 8, s, 128, generator=g).to(dev)
    pools = [torch.randn(2, nblocks, 16, 128, generator=g).to(dev) for _ in range(2)]
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    scales = {}
    if quantized:
        (k, scales["k_scale"]), (v, scales["v_scale"]) = (T.quantize_kv(p) for p in pools)
    else:
        k, v = pools
    clean = T.paged_decode_attention(q, k, v, vl, pages, **scales)
    if quantized:
        k[:, 0], v[:, 0] = 127, -127
        scales["k_scale"][:, 0], scales["v_scale"][:, 0] = float("nan"), 1e30
    else:
        k[:, 0], v[:, 0] = 1e30, float("nan")
    torch.testing.assert_close(T.paged_decode_attention(q, k, v, vl, pages, **scales), clean,
                               rtol=0, atol=0)
    assert not clean[0].any()


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32pool", "int8pool"])
def test_paged_kernels_hide_keys_behind_out_of_range_entries(quantized):
    """A table entry past the pool (or negative) below valid_len is read
    as no key at all: a one-token query at position 31 whose second page
    maps nowhere attends to the first page's 16 keys alone (K6: the split
    body, whose later splits are empty)."""
    dev = _card()
    g = torch.Generator().manual_seed(14)
    pages, nblocks = shuffled_table(16, 2048, [32, 32], g, dev)
    q = torch.randn(2, 8, 1, 128, generator=g).to(dev)
    pools = [torch.randn(2, nblocks, 16, 128, generator=g).to(dev) for _ in range(2)]
    scales = {}
    if quantized:
        (k, scales["k_scale"]), (v, scales["v_scale"]) = (T.quantize_kv(p) for p in pools)
    else:
        k, v = pools
    bad = pages.clone()
    bad[0, 1], bad[1, 1] = nblocks + 5, -1
    o = T.paged_decode_attention(q, k, v, torch.tensor([32, 32], device=dev), bad, **scales)
    ref = T.paged_decode_attention_reference(q, k, v, torch.tensor([16, 16], device=dev),
                                             pages, **scales)
    assert (o - ref).abs().max().item() <= 1e-4


# K6's split body: (page, capacity, hkv, s, valid_len per row, window);
# 128-key splits, so valid_len 127/128/129 straddle the first boundary.
SPLIT_CASES = {
    "boundaries": (64, 2048, 8, 1, [127, 128, 129, 2048], None),
    "later_splits_empty": (64, 2048, 8, 1, [1, 64, 300, 0], None),
    "window_empties_leading": (64, 2048, 2, 1, [1000, 700, 513, 2048], 100),
    "gqa_rows_4": (16, 2048, 2, 1, [1023, 1024, 1025, 17], None),
    "gqa_chunk_rows_16": (16, 2048, 2, 4, [4, 512, 767, 2048], 300),
    "rows_5": (64, 2048, 8, 5, [5, 258, 1531, 2048], None),
    "page_24": (24, 2064, 2, 1, [2064, 255, 257, 0], None),
    "capacity_not_a_multiple": (16, 2000, 8, 1, [2000, 1999, 1793, 1], 600),
    "one_split": (16, 128, 8, 1, [128, 65, 64, 1], None),
    "verify_spec_k4": (64, 2048, 8, 4, [4, 130, 1303, 2047], None),  # speculative verify
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(SPLIT_CASES), ids=list(SPLIT_CASES))
def test_paged_split_body_matches_plain(dtype, d, case):
    """K6 on decode calls (rows <= 16: the split body and its combine)
    against the plain version, and against the split-and-merge plain
    version; a row with valid_len 0 is exactly 0."""
    page, cap, hkv, s, valid, window = SPLIT_CASES[case]
    dev = _card()
    g = torch.Generator().manual_seed(17)
    mb = cap // page
    nblocks = 1 + len(valid) * mb
    perm = (torch.randperm(nblocks - 1, generator=g) + 1).tolist()
    pages = torch.zeros(len(valid), mb, dtype=torch.int32)
    for r, n in enumerate(valid):
        need = -(-n // page)
        pages[r, :need] = torch.tensor(perm[:need], dtype=torch.int32)
        perm = perm[need:]
    pages = pages.to(dev)
    q = torch.randn(len(valid), 8, s, d, generator=g).to(dev, dtype)
    k, v = (torch.randn(hkv, nblocks, page, d, generator=g).to(dev, dtype) for _ in range(2))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    assert (8 // hkv) * s <= T.SPLIT_ROWS
    before = T.launch_counts()
    o = T.paged_decode_attention(q, k, v, vl, pages, window=window)
    after = T.launch_counts()
    assert after["paged_decode_attention"] == before["paged_decode_attention"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    f = [t.float() for t in (q, k, v)]
    ref = T.paged_decode_attention_reference(*f, vl, pages, window=window)
    split = T.paged_decode_split_reference(*f, vl, pages, window=window)
    torch.testing.assert_close(split, torch.nan_to_num(ref, nan=0.0), atol=1e-5, rtol=0)
    if dtype == torch.bfloat16:
        # fp32 arithmetic on the bf16 inputs: only the output is rounded.
        _close_rounded(o, ref, torch.zeros_like(ref), 1e-4)
    else:
        assert (o - torch.nan_to_num(ref, nan=0.0)).abs().max().item() <= 1e-4
    for r, n in enumerate(valid):
        if n == 0:
            assert not o[r].any()


# K4's split body on the dense cache: (capacity, hkv of 8 query heads,
# query tokens, valid_len per row, window); 128-key splits.
DENSE_SPLIT_CASES = {
    "boundaries": (2048, 8, 1, [127, 128, 129, 2048], None),
    "later_splits_empty": (2048, 8, 1, [1, 64, 300, 0], None),
    "window_empties_leading": (2048, 2, 1, [1000, 700, 513, 2048], 100),
    "gqa_rows_4": (2048, 2, 1, [1023, 1024, 1025, 17], None),
    "gqa_chunk_rows_16": (2048, 2, 4, [4, 512, 767, 2048], 300),
    "rows_5": (2048, 8, 5, [5, 258, 1531, 2048], None),
    "rows_8": (2048, 8, 8, [3, 130, 1024, 2048], 200),  # valid_len 3 < s: rows that see no key
    "capacity_not_a_multiple": (2000, 8, 1, [2000, 1999, 1793, 1], 600),
    "one_split": (128, 8, 1, [128, 65, 64, 1], None),
    "verify_spec_k4": (2048, 8, 4, [4, 130, 1303, 2047], None),  # speculative verify
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(DENSE_SPLIT_CASES), ids=list(DENSE_SPLIT_CASES))
def test_dense_split_body_matches_plain(dtype, d, case):
    """K4 on decode calls (rows <= 16: the split body and its combine on
    the dense layout) against the plain version, and against the
    split-and-merge plain version; a row with valid_len 0 is exactly 0."""
    cap, hkv, s, valid, window = DENSE_SPLIT_CASES[case]
    dev = _card()
    g = torch.Generator().manual_seed(18)
    q = torch.randn(len(valid), 8, s, d, generator=g).to(dev, dtype)
    k, v = (torch.randn(len(valid), hkv, cap, d, generator=g).to(dev, dtype) for _ in range(2))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    assert (8 // hkv) * s <= T.SPLIT_ROWS
    before = T.launch_counts()
    o = T.decode_attention(q, k, v, vl, window=window)
    after = T.launch_counts()
    assert after["decode_attention"] == before["decode_attention"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    f = [t.float() for t in (q, k, v)]
    ref = T.decode_attention_reference(*f, vl, window=window)
    split = T.decode_split_reference(*f, vl, window=window)
    torch.testing.assert_close(split, torch.nan_to_num(ref, nan=0.0), atol=1e-5, rtol=0)
    if dtype == torch.bfloat16:
        _close_rounded(o, ref, torch.zeros_like(ref), 1e-4)  # fp32 arithmetic, o rounded
    else:
        assert (o - torch.nan_to_num(ref, nan=0.0)).abs().max().item() <= 1e-4
    for r, n in enumerate(valid):
        if n == 0:
            assert not o[r].any()


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv,s,cap", list(WIDE_CASES.values()), ids=list(WIDE_CASES))
def test_dense_wide_body_matches_plain(hkv, s, cap, d, window):
    """K4 on wide bf16 calls (rows > 16: K1's tensor-core forward body over
    the dense bf16 cache, one launch counted as ``decode_attention_chunk``)
    against the plain version per element within its rounding bound
    (``mag = p·|v|``): valid_len 0, a length below s (rows before
    position 0 write 0), a tile edge + 1, 1300 and full capacity (at s =
    capacity, full causal); then NaN and +-1e30 in every slot at or past
    valid_len change no bit."""
    dev = _card()
    g = torch.Generator().manual_seed(25)
    valid, _ = wide_lengths(s, 64, cap)
    q = torch.randn(len(valid), 8, s, d, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(len(valid), hkv, cap, d, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    assert (8 // hkv) * s > T.SPLIT_ROWS
    before = T.launch_counts()
    o = T.decode_attention(q, k, v, vl, window=window)
    after = T.launch_counts()
    assert after["decode_attention_chunk"] == before["decode_attention_chunk"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    f = [t.float() for t in (q, k, v)]
    ref = T.decode_attention_reference(*f, vl, window=window)
    mag = T.decode_attention_reference(*f[:2], f[2].abs(), vl, window=window)
    _close_rounded(o, ref, mag, 1e-4)
    assert not o[0].any()
    assert not o[1, :, :s - valid[1]].any()  # positions below 0
    dirty = T.decode_attention(q, *dense_poisoned(k, v, vl), vl, window=window)
    torch.testing.assert_close(dirty, o, rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("page", [64, 16, 24])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv,s,cap", list(WIDE_CASES.values()), ids=list(WIDE_CASES))
def test_paged_chunk_body_matches_plain(hkv, s, cap, d, page, window):
    """K6 on wide bf16 calls (rows > 16: the tensor-core chunk body)
    against the plain version per element within its rounding bound
    (``mag = p·|v|``): ragged valid_len with 0, a length below s (rows
    before position 0 see no key and write 0), a page boundary + 1, a
    row whose last pages map the scratch block below its valid length,
    and full capacity (at s = capacity, full causal), on a shuffled
    table."""
    dev = _card()
    g = torch.Generator().manual_seed(19)
    valid, alloc = wide_lengths(s, page, cap)
    pages, nblocks = shuffled_table(page, cap, alloc, g, dev)
    q = torch.randn(len(valid), 8, s, d, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(hkv, nblocks, page, d, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    assert (8 // hkv) * s > T.SPLIT_ROWS
    before = T.launch_counts()
    o = T.paged_decode_attention(q, k, v, vl, pages, window=window)
    after = T.launch_counts()
    assert after["paged_decode_attention_chunk"] == before["paged_decode_attention_chunk"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    f = [t.float() for t in (q, k, v)]
    ref = T.paged_decode_attention_reference(*f, vl, pages, window=window)
    mag = T.paged_decode_attention_reference(*f[:2], f[2].abs(), vl, pages, window=window)
    _close_rounded(o, ref, mag, 1e-4)
    assert not o[0].any()
    assert not o[1, :, :s - valid[1]].any()  # positions below 0


@pytest.mark.parametrize("page", [64, 16, 24])
def test_paged_chunk_body_never_reads_the_scratch_block(page):
    """The chunk body with block 0 at ±1e30: every row whose valid_len
    stops before the scratch block is bit-identical; the last row maps
    the scratch block below its valid length and reads it."""
    dev = _card()
    g = torch.Generator().manual_seed(20)
    valid = [0, 40, 700, 2048, 900]
    pages, nblocks = shuffled_table(page, 2048, [*valid[:4], 900 - page], g, dev)
    q = torch.randn(len(valid), 8, 64, 128, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(2, nblocks, page, 128, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    clean = T.paged_decode_attention(q, k, v, vl, pages)
    k[:, 0], v[:, 0] = 1e30, -1e30
    dirty = T.paged_decode_attention(q, k, v, vl, pages)
    torch.testing.assert_close(dirty[:4], clean[:4], rtol=0, atol=0)
    assert not clean[0].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("case", list(Q8_SPLIT_CASES), ids=list(Q8_SPLIT_CASES))
def test_q8_split_body_matches_plain(dtype, d, layout, case):
    """K5 (dense) and K7 (paged) on decode calls (rows <= 16: the int8
    split body and its combine) against the plain version and the
    split-and-merge plain version; a row with valid_len 0 is exactly 0;
    the keys no row may read, values and scales poisoned, change no bit."""
    page, cap, hkv, s, valid, window = Q8_SPLIT_CASES[case]
    dev = _card()
    g = torch.Generator().manual_seed(21)
    kv, pages = q8_operands(layout, page, cap, hkv, d, valid, g, dev)
    q = torch.randn(len(valid), 8, s, d, generator=g).to(dev, dtype)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    assert (8 // hkv) * s <= T.SPLIT_ROWS
    name = "decode_attention_q8" if pages is None else "paged_decode_attention_q8"
    before = T.launch_counts()
    o = q8_call(q, kv, vl, pages, window)
    after = T.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ref = q8_plain(q, kv, vl, pages, window)
    split = (T.decode_split_q8_reference(q.float(), *kv, vl, window=window) if pages is None else
             T.paged_decode_split_q8_reference(q.float(), *kv, vl, pages, window=window))
    torch.testing.assert_close(split, torch.nan_to_num(ref, nan=0.0), atol=1e-5, rtol=0)
    if dtype == torch.bfloat16:
        _close_rounded(o, ref, torch.zeros_like(ref), 1e-4)  # fp32 arithmetic, o rounded
    else:
        assert (o - torch.nan_to_num(ref, nan=0.0)).abs().max().item() <= 1e-4
    for r, n in enumerate(valid):
        if n == 0:
            assert not o[r].any()
    dirty = q8_call(q, q8_poisoned(kv, vl, pages), vl, pages, window)
    assert T.launch_counts()[name] == before[name] + 2
    torch.testing.assert_close(dirty, o, rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("layout", ["dense", 64, 16, 24], ids=["dense", "page64", "page16", "page24"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv,s,cap", list(WIDE_CASES.values()), ids=list(WIDE_CASES))
def test_q8_chunk_body_matches_plain(hkv, s, cap, d, layout, window):
    """K5 (dense: K1's tensor-core forward body over int8 K/V) and K7
    (paged: the int8 tensor-core chunk body) on wide bf16 calls (rows >
    16) against the plain version per element within its rounding bound
    (``mag = p·|v|``, v dequantized): valid_len 0, a
    length below s (rows before position 0 write 0), a page boundary + 1,
    a row whose last pages map the scratch block, and full capacity (at
    s = capacity: the full causal form of the int8 engine's admission
    prefill)."""
    dev = _card()
    g = torch.Generator().manual_seed(22)
    page = 64 if layout == "dense" else layout
    valid, alloc = wide_lengths(s, page, cap)
    kv, pages = q8_operands("dense" if layout == "dense" else "paged", page, cap, hkv, d, alloc,
                            g, dev)
    q = torch.randn(len(valid), 8, s, d, generator=g).to(dev, torch.bfloat16)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    assert (8 // hkv) * s > T.SPLIT_ROWS
    name = "decode_attention_q8_chunk" if pages is None else "paged_decode_attention_q8_chunk"
    before = T.launch_counts()
    o = q8_call(q, kv, vl, pages, window)
    after = T.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ref = q8_plain(q, kv, vl, pages, window)
    mag = q8_plain(q, [kv[0], kv[1].abs(), kv[2], kv[3]], vl, pages, window)
    _close_rounded(o, ref, mag, 1e-4)
    assert not o[0].any()
    assert not o[1, :, :s - valid[1]].any()  # positions below 0


@pytest.mark.parametrize("layout", ["dense", 64, 16, 24], ids=["dense", "page64", "page16", "page24"])
def test_q8_chunk_body_never_reads_poisoned_keys(layout):
    """The int8 wide bodies (K5's forward body, K7's chunk body) with the
    keys no row may read at ±127 and
    their scales at NaN / 1e30: every row that does not map them is
    bit-identical (paged: the last row maps the scratch block below its
    valid length and reads it)."""
    dev = _card()
    g = torch.Generator().manual_seed(23)
    page = 64 if layout == "dense" else layout
    valid = [0, 40, 700, 2048, 900]
    alloc = [*valid[:4], 900 - page]
    kv, pages = q8_operands("dense" if layout == "dense" else "paged", page, 2048, 2, 128, alloc,
                            g, dev)
    q = torch.randn(len(valid), 8, 64, 128, generator=g).to(dev, torch.bfloat16)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    clean = q8_call(q, kv, vl, pages, None)
    dirty = q8_call(q, q8_poisoned(kv, vl, pages), vl, pages, None)
    keep = slice(None) if pages is None else slice(0, 4)
    torch.testing.assert_close(dirty[keep], clean[keep], rtol=0, atol=0)
    assert not clean[0].any()


@pytest.mark.parametrize("d", [64, 128])
def test_q8_wide_body_at_the_admission_prefill(d):
    """K5 at the int8 engine's admission prefill: q (4, 8, 2048, d) bf16
    causal over its own int8 K/V at valid_len 2048 (16 row tiles and up to
    32 key tiles per head), per element within the rounding bound, and
    bit-identical over two launches."""
    dev = _card()
    g = torch.Generator().manual_seed(24)
    b, s = 4, 2048
    kv, _ = q8_operands("dense", 64, s, 8, d, [s] * b, g, dev)
    q = torch.randn(b, 8, s, d, generator=g).to(dev, torch.bfloat16)
    vl = torch.full((b,), s, dtype=torch.int32, device=dev)
    before = T.launch_counts()["decode_attention_q8_chunk"]
    o = q8_call(q, kv, vl, None)
    assert T.launch_counts()["decode_attention_q8_chunk"] == before + 1
    ref = q8_plain(q, kv, vl, None)
    mag = q8_plain(q, [kv[0], kv[1].abs(), kv[2], kv[3]], vl, None)
    _close_rounded(o, ref, mag, 1e-4)
    assert torch.equal(q8_call(q, kv, vl, None), o)


@pytest.mark.parametrize("lm_config", [
    {"kv_cache_dtype": "int8"},
    {"kv_page_size": 16, "prefill_chunk": 32},
    {"kv_cache_dtype": "int8", "kv_page_size": 24, "kv_pool_blocks": 7, "prefill_chunk": 32},
], ids=["int8", "paged", "paged-int8"])
def test_int8_and_paged_engines_on_the_card_match_the_cpu(lm_config):
    """A small fp32 model served with the int8 cache, the paged cache and
    the paged int8 cache (a pool of 6 usable blocks, so admission queues)
    emits the same greedy tokens on the card (K5, K6, K7) as on the CPU
    (plain versions)."""
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine

    dev = _card()
    cfg = dict(vocab_size=128, d_model=128, num_heads=2, num_layers=2, dtype="float32",
               max_decode_len=256, ragged_decode=True)
    params = random_params(**cfg, seed=4)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 128, (n,), generator=g).tolist() for n in (7, 40, 100)]
    model_kw = {"kv_cache_dtype": lm_config.get("kv_cache_dtype")}
    engine_kw = {k: v for k, v in lm_config.items() if k != "kv_cache_dtype"}
    out = []
    for device in ("cpu", dev):
        model = TransformerLM(**cfg, **model_kw, device=device).load_flax(params)
        engine = LMEngine(model, slots=2, device=device, **engine_kw)
        tickets = [engine.submit(p, max_new_tokens=12) for p in prompts]
        results = engine.run()
        out.append([results[t] for t in tickets])
    assert out[0] == out[1]
