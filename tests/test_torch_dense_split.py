"""K4's split-K decode on the CPU: the split rule and workspace of the
dense call (``decode_splits``, ``_split_workspace``) and the plain
version of the split body and its combine on a dense cache
(``decode_split_reference``), held to the JAX package's
``decode_attention`` (the Pallas ``_decode_kernel`` in interpret mode)
on numpy-seeded fp32 inputs.

Tolerance: ``atol 1e-5`` (fp32; the splits sum in another order). The
cases straddle the 128-key split boundaries: ``valid_len`` at L - 1, L,
L + 1, full capacity and 0, a window that empties the leading splits,
GQA rows 4, chunks of s = 5 and 8, and a capacity of 2000, not a
multiple of L.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.ops import attention as J
from hops_tpu_torch.ops import attention as T

TOL = dict(atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows,capacity,bhkv,want", [
    (1, 2048, 32, (16, 128)),    # the served dense decode step: 4 slots x 8 kv heads
    (4, 2048, 8, (16, 128)),     # GQA 8-on-2 at 4 slots
    (5, 2048, 32, (16, 128)),    # a 5-token chunk
    (20, 2048, 8, (1, 2048)),    # GQA rows 4 x 5 tokens: the 64-row body
    (1, 2000, 32, (16, 128)),    # the last split holds 80 keys
    (1, 4096, 32, (16, 256)),    # 128-key splits would be 1024 blocks, over the cap of 528
    (1, 4000, 48, (11, 384)),    # ... so each split takes more keys, in whole tiles
])
def test_dense_split_rule(rows, capacity, bhkv, want):
    n, keys = T.decode_splits(rows, capacity, bhkv)
    assert (n, keys) == want
    assert n * keys >= capacity > (n - 1) * keys


@pytest.mark.parametrize("rows,capacity,bhkv,d", [
    (1, 2048, 32, 128), (8, 2000, 4, 64), (20, 2048, 8, 128), (1, 100, 32, 64),
])
def test_split_workspace_holds_every_partial(rows, capacity, bhkv, d):
    """One fp32 (m, l, acc) per split, row and kv head; none for one split."""
    n, keys, work = T._split_workspace(rows, capacity, bhkv, d, "cpu")
    assert (n, keys) == T.decode_splits(rows, capacity, bhkv)
    if n == 1:
        assert work is None
    else:
        assert work.dtype == torch.float32 and work.numel() == n * bhkv * rows * (d + 2)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (capacity, h, hkv, s, valid_len per row, window)
CASES = {
    "boundaries": (1024, 4, 4, 1, [127, 128, 129, 1024, 0], None),
    "window_empties_leading": (1024, 4, 2, 1, [1000, 700, 513], 100),
    "gqa_rows_4": (1024, 8, 2, 1, [639, 256, 17, 1024], None),
    "rows_5": (1024, 4, 4, 5, [5, 258, 1023, 0], None),
    "rows_8": (1024, 4, 4, 8, [8, 130, 1024], 200),
    "capacity_2000": (2000, 4, 2, 3, [2000, 1999, 1793, 1], 600),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_dense_split_reference_matches_jax(case):
    cap, h, hkv, s, valid, window = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    d, b = 32, len(valid)
    q, k, v = _rand(rng, b, h, s, d), _rand(rng, b, hkv, cap, d), _rand(rng, b, hkv, cap, d)
    vl = np.array(valid, np.int32)
    n_splits, keys = T.decode_splits((h // hkv) * s, cap, b * hkv)
    assert n_splits > 1 and keys == T.SPLIT_KEYS  # the cases cross split boundaries
    # A block that divides the capacity, so the Pallas kernel runs (2000
    # has no 128-granular divisor; the JAX router would take its reference).
    want = J.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl), window=window,
        block_k=512 if cap % 512 == 0 else 400, interpret=True)
    got = T.decode_split_reference(*(torch.from_numpy(a) for a in (q, k, v, vl)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for r, n in enumerate(valid):
        if n == 0:
            assert not got[r].any()
    # The split reference is the plain version's function, split and merged
    # (a row that sees no key, at a position below 0, is 0 in both, as in
    # the kernels).
    plain = T.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, vl)), window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
