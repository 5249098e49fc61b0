"""K6's split-K decode on the CPU: the split rule the wrapper uses
(``decode_splits``) and the plain version of the split body and its
combine (``paged_decode_split_reference``), held to the JAX package's
``paged_decode_attention`` (the Pallas ``_paged_decode_kernel`` in
interpret mode) on numpy-seeded fp32 inputs.

Tolerance: ``atol 1e-5`` (fp32; the splits sum in another order). The
cases straddle the 128-key split boundaries: ``valid_len`` at L - 1, L,
L + 1 and full capacity, rows whose later splits are all empty,
``valid_len`` 0, a window that empties the leading splits, GQA rows,
pages of 16 and 24, and capacities that are not a multiple of L.
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
    (1, 2048, 32, (16, 128)),    # the served decode step: 512 blocks
    (4, 2048, 8, (16, 128)),     # GQA 8-on-2, rows 4
    (16, 2048, 32, (16, 128)),   # the widest call the split body takes
    (17, 2048, 32, (1, 2048)),   # wider: the 64-row body, one split
    (256, 2048, 32, (1, 2048)),  # the 256-token prefill chunk
    (1, 100, 32, (1, 128)),      # shorter than one split
    (1, 128, 32, (1, 128)),
    (1, 129, 32, (2, 128)),
    (1, 2000, 32, (16, 128)),    # not a multiple of L: the last split is short
    (1, 2048, 128, (4, 512)),    # the block cap makes each split longer
    (1, 960, 100, (5, 192)),     # ... by whole 64-key tiles
    (1, 2048, 528, (1, 2048)),
    (1, 2048, 4096, (1, 2048)),  # more rows than the cap: one split each
])
def test_split_rule(rows, capacity, bhkv, want):
    n, keys = T.decode_splits(rows, capacity, bhkv)
    assert (n, keys) == want
    assert keys % 64 == 0 or rows > T.SPLIT_ROWS
    assert n * keys >= capacity > (n - 1) * keys  # covers the capacity, no split past it
    assert n == 1 or n * bhkv <= T.SPLIT_MAX_BLOCKS


@pytest.mark.parametrize("bad", [(0, 2048, 32), (1, 0, 32), (1, 2048, 0)])
def test_split_rule_rejects_empty_shapes(bad):
    with pytest.raises(ValueError, match="decode_splits"):
        T.decode_splits(*bad)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _table(rng, valid, page, mb):
    """A shuffled ``(len(valid), mb)`` table over ``1 + rows * mb`` blocks:
    distinct nonzero blocks below each row's valid length, the scratch
    block 0 past it."""
    nblocks = 1 + len(valid) * mb
    free = list(rng.permutation(np.arange(1, nblocks)))
    table = np.zeros((len(valid), mb), np.int32)
    for r, n in enumerate(valid):
        need = -(-n // page)
        table[r, :need] = free[:need]
        free = free[need:]
    return table, nblocks


# (page, max_blocks, h, hkv, s, valid_len per row, window)
CASES = {
    "boundaries": (64, 16, 4, 4, 1, [127, 128, 129, 1024], None),
    "later_splits_empty": (64, 16, 4, 4, 1, [1, 64, 300, 0], None),
    "valid_len_0": (16, 40, 4, 2, 1, [0, 0, 640], None),
    "window_empties_leading": (64, 16, 4, 2, 1, [1000, 700, 513], 100),
    "window_across_a_boundary": (16, 40, 4, 4, 1, [600, 260, 520], 300),
    "gqa_rows_4": (16, 40, 8, 2, 1, [639, 256, 17], None),
    "gqa_chunk_rows_8": (16, 40, 8, 2, 2, [640, 258, 2], 200),
    "page_24": (24, 27, 4, 2, 1, [648, 255, 257], None),
    "capacity_not_a_multiple": (16, 30, 4, 2, 3, [480, 257, 3], None),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_split_reference_matches_jax(case):
    page, mb, h, hkv, s, valid, window = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    d, b = 32, len(valid)
    table, nblocks = _table(rng, valid, page, mb)
    k, v = _rand(rng, hkv, nblocks, page, d), _rand(rng, hkv, nblocks, page, d)
    q, vl = _rand(rng, b, h, s, d), np.array(valid, np.int32)
    n_splits, keys = T.decode_splits((h // hkv) * s, page * mb, b * hkv)
    assert n_splits > 1 and keys == T.SPLIT_KEYS  # the cases cross split boundaries
    want = J.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl), jnp.asarray(table),
        window=window, interpret=True)
    got = T.paged_decode_split_reference(
        *(torch.from_numpy(a) for a in (q, k, v, vl, table)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for r, n in enumerate(valid):
        if n == 0:
            assert not got[r].any()
    # The split reference is the plain version's function, split and merged.
    plain = T.paged_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, vl, table)),
                                     window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
