"""The port's attention (``hops_tpu_torch.ops.attention``) against the JAX
package on the same seeded inputs, fp32 on the CPU.

The JAX side runs its Pallas kernels as ``tests/test_ops.py`` does:
explicit ``block_q/block_k`` force the interpret-mode flash kernel, and
``decode_attention`` interprets on the CPU by itself. The port's CPU
entry points run its plain versions. Tolerance: ``atol 2e-5,
rtol 1e-5`` (fp32, different summation orders).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.ops import attention as J
from hops_tpu_torch.ops import attention as T

TOL = dict(atol=2e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(b=2, h=4, sq=128, sk=128, d=32, hkv=None, seed=0):
    return (
        _rand(seed, b, h, sq, d),
        _rand(seed + 1, b, hkv or h, sk, d),
        _rand(seed + 2, b, hkv or h, sk, d),
    )


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize(
    "causal,window,sq,sk,q_offset",
    [
        (True, None, 128, 128, None),
        (False, None, 128, 128, None),
        (True, 32, 128, 128, None),
        (True, None, 64, 128, None),  # cross-length: chunk at the last 64 keys
        (True, None, 64, 128, 32),  # cross-length at an explicit offset
        (False, None, 64, 192, None),
    ],
)
def test_attention_reference_matches_jax(causal, window, sq, sk, q_offset):
    q, k, v = _qkv(sq=sq, sk=sk)
    want = J.attention_reference(q, k, v, causal=causal, q_offset=q_offset, window=window)
    got = T.attention_reference(*_t(q, k, v), causal=causal, q_offset=q_offset, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_reference_per_row_q_offset_matches_jax():
    q, k, v = _qkv(sq=4, sk=64)
    off = np.array([10, 60], np.int32)
    want = J.attention_reference(q, k, v, causal=True, q_offset=jnp.asarray(off))
    got = T.attention_reference(*_t(q, k, v), causal=True, q_offset=torch.from_numpy(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_repeat_kv_matches_jax_grouping():
    q, k, v = _qkv(h=8, hkv=2, sq=8, sk=8)
    jk, jv = J.repeat_kv(q, k, v)
    tk, tv = T.repeat_kv(*_t(q, k, v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize(
    "causal,window,sq,sk",
    [
        (True, None, 128, 128),
        (False, None, 128, 128),
        (True, 48, 128, 128),
        (True, None, 64, 128),
    ],
)
def test_flash_attention_cpu_matches_jax_kernel(causal, window, sq, sk):
    q, k, v = _qkv(sq=sq, sk=sk, seed=3)
    want = J.flash_attention(q, k, v, causal=causal, window=window, block_q=64, block_k=64)
    got = T.flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 40)])
def test_flash_lse_matches_jax_kernel(causal, window):
    """The second output of the TPU forward kernel (`_fwd_call`'s lse)."""
    q, k, v = _qkv(sq=128, sk=128, seed=4)
    flat = [a.reshape(-1, *a.shape[2:]) for a in (q, k, v)]
    _, lse = J._fwd_call(*flat, causal, 1 / np.sqrt(32), 64, 64, 0, window, True)
    _, got = T.flash_attention(*_t(q, k, v), causal=causal, window=window, return_lse=True)
    np.testing.assert_allclose(got.numpy().reshape(-1), np.asarray(lse).reshape(-1), **TOL)


def test_flash_attention_refuses_autograd():
    q, k, v = _t(*_qkv(sq=16, sk=16))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        T.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        T.flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("window", [None, 40])
def test_decode_attention_ragged_matches_jax_kernel(hkv, s, window):
    """Ragged valid_len with a 0 row, MHA and GQA, one- and multi-token
    chunks, with and without a window: the port's CPU entry point against
    the JAX Pallas decode kernel (interpreted)."""
    b, h, cap, d = 4, 4, 256, 32
    q = _rand(5, b, h, s, d)
    k, v = _rand(6, b, hkv, cap, d), _rand(7, b, hkv, cap, d)
    vl = np.array([0, s, 130, 256], np.int32)
    want = J.decode_attention(q, k, v, jnp.asarray(vl), window=window, block_k=128)
    got = T.decode_attention(*_t(q, k, v), torch.from_numpy(vl), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()  # vl == 0 row: zeros


def test_decode_attention_scalar_valid_len_matches_jax():
    q = _rand(8, 2, 4, 1, 32)
    k, v = _rand(9, 2, 4, 128, 32), _rand(10, 2, 4, 128, 32)
    want = J.decode_attention(q, k, v, jnp.int32(77), block_k=128)
    got = T.decode_attention(*_t(q, k, v), 77)
    ref = T.decode_attention_reference(*_t(q, k, v), 77)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_decode_attention_ignores_garbage_past_valid_len():
    """Slots past valid_len hold arbitrary finite data and must not leak
    into the output (port of the JAX test of the same name)."""
    q = torch.from_numpy(_rand(2, 1, 1, 1, 64))
    k, v = _t(_rand(11, 1, 1, 256, 64), _rand(12, 1, 1, 256, 64))
    clean = T.decode_attention(q, k, v, 100)
    k[:, :, 100:] = 1e30
    v[:, :, 100:] = -1e30
    dirty = T.decode_attention(q, k, v, 100)
    torch.testing.assert_close(clean, dirty, rtol=0, atol=0)


def test_decode_attention_bad_valid_len_shape_raises():
    q = torch.zeros(2, 4, 1, 32)
    k = torch.zeros(2, 4, 64, 32)
    with pytest.raises(ValueError, match="valid_len"):
        T.decode_attention(q, k, k, torch.zeros(3, dtype=torch.int32))


def test_launch_counts_reset_and_cpu_launches_nothing():
    T.reset_launch_counts()
    q, k, v = _t(*_qkv(sq=16, sk=16))
    T.flash_attention(q, k, v, causal=True)
    T.decode_attention(q[:, :, :1], k, v, 16)
    assert T.launch_counts() == {"flash_fwd": 0, "decode_attention": 0}
