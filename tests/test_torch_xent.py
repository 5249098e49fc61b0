"""The port's chunked LM-head loss (``hops_tpu_torch.ops.xent``) against
the JAX package's ``chunked_softmax_xent`` and against optax's dense
``softmax_cross_entropy_with_integer_labels``, fp32 on the CPU, on the
same seeded inputs.

Tolerances: value ``rtol 1e-6``, gradients ``atol 1e-5, rtol 1e-5``
(fp32, other summation orders; the bounds of ``tests/test_ops.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hops_tpu.ops.xent import chunked_softmax_xent as jax_xent
from hops_tpu_torch.ops.xent import chunked_softmax_xent

GTOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, s, d, v, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, s, d).astype(np.float32), (rs.randn(d, v) * 0.1).astype(np.float32),
            rs.randint(0, v, (b, s)).astype(np.int32))


def _port(h, w, t, chunk):
    ht, wt = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    loss = chunked_softmax_xent(ht, wt, torch.from_numpy(t), chunk=chunk)
    loss.backward()
    return loss.item(), ht.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("b,s,chunk", [(2, 12, 8), (2, 16, 8), (3, 7, 64)],
                         ids=["pad-24-to-32", "aligned", "one-padded-chunk"])
def test_chunked_xent_matches_jax_chunked_and_optax_dense(b, s, chunk):
    h, w, t = _inputs(b, s, 16, 37)
    loss, dh, dw = _port(h, w, t, chunk)

    def chunked(h, w):
        return jax_xent(h, w, t, chunk=chunk)

    def dense(h, w):
        return optax.softmax_cross_entropy_with_integer_labels(h @ w, t).mean()

    for fn in (chunked, dense):
        want, grads = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
        np.testing.assert_allclose(loss, float(want), rtol=1e-6)
        np.testing.assert_allclose(dh, np.asarray(grads[0]), **GTOL)
        np.testing.assert_allclose(dw, np.asarray(grads[1]), **GTOL)


def test_chunked_xent_equals_dense_torch_loss():
    h, w, t = _inputs(2, 40, 32, 101, seed=1)
    loss, dh, dw = _port(h, w, t, chunk=16)
    ht, wt = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    dense = torch.nn.functional.cross_entropy((ht @ wt).reshape(-1, 101),
                                              torch.from_numpy(t).long().reshape(-1))
    dense.backward()
    np.testing.assert_allclose(loss, dense.item(), rtol=1e-6)
    np.testing.assert_allclose(dh, ht.grad.numpy(), **GTOL)
    np.testing.assert_allclose(dw, wt.grad.numpy(), **GTOL)


def test_backward_never_holds_more_than_one_chunk_of_logits():
    """Only the per-token lse is saved for backward: the tensors autograd
    keeps are the inputs and an ``(n,)`` vector, never ``(n, vocab)``."""
    h, w, t = _inputs(2, 64, 8, 512, seed=2)
    ht = torch.from_numpy(h).requires_grad_(True)
    loss = chunked_softmax_xent(ht, torch.from_numpy(w), torch.from_numpy(t), chunk=32)
    saved = [x for x in loss.grad_fn.saved_tensors]
    assert max(x.numel() for x in saved) == max(h.size, w.size)
    assert not any(x.shape[-1] == 512 and x.shape[0] == 128 for x in saved)
