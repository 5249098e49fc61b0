"""Gradients of the port's ``flash_attention`` against the JAX package,
fp32 on the CPU.

The JAX side is ``jax.grad`` of ``hops_tpu.ops.attention.flash_attention``
with ``block_q=block_k=64``, which forces its custom VJP, so the Pallas
backward kernels K2/K3 run in interpret mode (as ``tests/test_ops.py``
runs them). The port's side is autograd through its
``torch.autograd.Function``, whose CPU backward is the plain version of
K2/K3 (``flash_bwd_dq_reference``/``flash_bwd_dkv_reference``: the
kernels' formulas from the saved lse, not autograd of the plain
forward). Both see the same seeded inputs and the same random output
cotangent. Tolerance: ``atol 2e-5, rtol 1e-5`` (fp32, other summation
orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.ops import attention as J
from hops_tpu_torch.ops import attention as T

TOL = dict(atol=2e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_grads(q, k, v, g, **kw):
    def loss(q, k, v):
        kk, vv = J.repeat_kv(q, k, v)
        o = J.flash_attention(q, kk, vv, block_q=64, block_k=64, **kw)
        return jnp.sum(o * g)

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _torch_grads(q, k, v, g, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    kk, vv = T.repeat_kv(q, k, v)
    o = T.flash_attention(q, kk, vv, **kw)
    (o * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize(
    "causal,window,sq,sk,q_offset,heads",
    [
        (True, None, 128, 128, None, 2),
        (False, None, 128, 128, None, 2),
        (True, 48, 128, 128, None, 2),
        (True, None, 64, 192, None, 2),  # cross-length: chunk at the last 64 keys
        (True, None, 64, 192, 40, 2),  # cross-length at an explicit offset
        (True, 32, 128, 128, 64, 2),  # keys 0..32 seen by no query: dk = dv = 0
        (True, None, 128, 128, None, 4),  # GQA: 4 query heads on 2 kv heads
    ],
    ids=["causal", "full", "window", "cross", "cross-offset", "unseen-keys", "gqa"],
)
def test_flash_grads_match_jax_kernels(causal, window, sq, sk, q_offset, heads):
    b, kv_heads, d = 1, 2, 32
    q = _rand(0, b, heads, sq, d)
    k, v = _rand(1, b, kv_heads, sk, d), _rand(2, b, kv_heads, sk, d)
    g = _rand(3, b, heads, sq, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _jax_grads(q, k, v, g, **kw)
    got = _torch_grads(q, k, v, g, **kw)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, w, err_msg=f"d{name}", **TOL)
    if q_offset == 64:
        assert not got[1][:, :, :33].any() and not got[2][:, :, :33].any()


def test_rows_that_see_no_key_get_zero_output_and_grads():
    """A negative offset leaves the first rows without keys: the kernel
    contract (and the JAX kernel) gives o = 0 and dq = 0 there, not NaN."""
    q, k, v, g = _rand(4, 1, 2, 64, 32), _rand(5, 1, 2, 64, 32), _rand(6, 1, 2, 64, 32), \
        _rand(7, 1, 2, 64, 32)
    kw = dict(causal=True, q_offset=-16)
    want = _jax_grads(q, k, v, g, **kw)
    got = _torch_grads(q, k, v, g, **kw)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, **TOL)
    assert not got[0][:, :, :16].any()
    o = T.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert torch.isfinite(o).all() and not o[:, :, :16].any()


def test_backward_reference_is_the_kernels_math():
    """``flash_attention_bwd_reference`` from a saved (o, lse) equals
    autograd of the plain forward, and the two halves agree with it."""
    q, k, v, g = (torch.from_numpy(_rand(s, 2, 2, 96, 64)) for s in (8, 9, 10, 11))
    o, lse = T.flash_attention(q, k, v, causal=True, window=40, return_lse=True)
    dq, dk, dv = T.flash_attention_bwd_reference(q, k, v, o, lse, g, causal=True, window=40)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    (T.attention_reference(qa, ka, va, causal=True, window=40) * g).sum().backward()
    for a, w in ((dq, qa.grad), (dk, ka.grad), (dv, va.grad)):
        torch.testing.assert_close(a, w, **TOL)
    delta = (o * g).sum(-1)
    torch.testing.assert_close(
        T.flash_bwd_dq(q, k, v, g, lse, delta, causal=True, window=40), dq, rtol=0, atol=0)
    dk2, dv2 = T.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True, window=40)
    torch.testing.assert_close(dk2, dk, rtol=0, atol=0)
    torch.testing.assert_close(dv2, dv, rtol=0, atol=0)


def test_cpu_backward_launches_no_kernel_and_lse_is_not_differentiable():
    T.reset_launch_counts()
    q, k, v = (torch.from_numpy(_rand(s, 1, 2, 32, 64)).requires_grad_(True) for s in (12, 13, 14))
    o, lse = T.flash_attention(q, k, v, causal=True, return_lse=True)
    assert o.requires_grad and not lse.requires_grad
    o.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert all(n == 0 for n in T.launch_counts().values())


def test_bwd_wrappers_check_shapes():
    q = torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse/delta"):
        T.flash_bwd_dq(q, q, q, q, lse[..., :4], lse)
    with pytest.raises(ValueError, match="flash_bwd_dkv"):
        T.flash_bwd_dkv(q, q[:, :1], q, q, lse, lse)
