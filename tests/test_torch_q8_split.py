"""K5's and K7's int8 arithmetic on the CPU, held to the JAX package's
interpreted Pallas kernels (``_decode_q8_kernel`` through
``decode_attention_q8``, ``_paged_decode_q8_kernel`` through
``paged_decode_attention(..., k_scale=, v_scale=)``) on numpy-seeded
fp32 inputs, quantized by the port's ``quantize_kv`` (whose int8 values
equal JAX's exactly).

- Decode calls (rows <= 16): the split-and-merge plain versions of the
  int8 split-K body (``decode_split_q8_reference``,
  ``paged_decode_split_q8_reference``: ``k_scale`` on the score columns
  before ``sm_scale``, ``v_scale`` on p for p·v only, ``l`` unscaled),
  across the 128-key split boundaries of ``tests/test_torch_dense_split.py``
  and ``tests/test_torch_split_decode.py``.
- Wide calls (rows > 16, the prefill calls of the int8 engines, which
  take K1's tensor-core forward body (K5) or the chunk body (K7) on the
  card): the port's plain versions at s 20 and 64, GQA and not, ragged
  ``valid_len``, and at the forward body's tile edges (s 129 against
  capacity 2048, full causal at s = capacity 255).

Tolerance: ``atol 1e-5`` (fp32; the splits sum in another order, and
the plain versions multiply the dequantized values where the kernels
scale the products).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.ops import attention as J
from hops_tpu_torch.ops import attention as T
from hops_tpu_torch.ops import kernel_checks

TOL = dict(atol=1e-5, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _quantized(rng, *shape):
    """int8 values and fp32 scales from the port's ``quantize_kv``, as
    numpy arrays."""
    vals, scales = T.quantize_kv(torch.from_numpy(_rand(rng, *shape)))
    return vals.numpy(), scales.numpy()


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


def _jax_dense(q, k, v, ks, vs, vl, window):
    # A block that divides the capacity, so the Pallas kernel runs (2000
    # has no 128-granular divisor; the JAX router would take its reference).
    cap = k.shape[2]
    return np.asarray(J.decode_attention_q8(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, vl)), window=window,
        block_k=512 if cap % 512 == 0 else (400 if cap % 400 == 0 else cap), interpret=True))


def _jax_paged(q, k, v, ks, vs, vl, table, window):
    return np.asarray(J.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, vl, table)), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), window=window, interpret=True))


# Dense (K5): (capacity, h, hkv, s, valid_len per row, window), the
# boundary cases of tests/test_torch_dense_split.py.
DENSE_CASES = {
    "boundaries": (1024, 4, 4, 1, [127, 128, 129, 1024, 0], None),
    "window_empties_leading": (1024, 4, 2, 1, [1000, 700, 513], 100),
    "gqa_rows_4": (1024, 8, 2, 1, [639, 256, 17, 1024], None),
    "rows_5": (1024, 4, 4, 5, [5, 258, 1023, 0], None),
    "rows_8": (1024, 4, 4, 8, [8, 130, 1024], 200),
    "capacity_2000": (2000, 4, 2, 3, [2000, 1999, 1793, 1], 600),
}


@pytest.mark.parametrize("case", list(DENSE_CASES), ids=list(DENSE_CASES))
def test_dense_split_q8_reference_matches_jax(case):
    cap, h, hkv, s, valid, window = DENSE_CASES[case]
    rng = np.random.default_rng(100 + sorted(DENSE_CASES).index(case))
    d, b = 32, len(valid)
    q = _rand(rng, b, h, s, d)
    (k, ks), (v, vs) = _quantized(rng, b, hkv, cap, d), _quantized(rng, b, hkv, cap, d)
    vl = np.array(valid, np.int32)
    n_splits, keys = T.decode_splits((h // hkv) * s, cap, b * hkv)
    assert n_splits > 1 and keys == T.SPLIT_KEYS  # the cases cross split boundaries
    want = _jax_dense(q, k, v, ks, vs, vl, window)
    args = [torch.from_numpy(a) for a in (q, k, v, ks, vs, vl)]
    got = T.decode_split_q8_reference(*args, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for r, n in enumerate(valid):
        if n == 0:
            assert not got[r].any()
    # The split reference is the plain version's function, split and merged
    # (a row that sees no key is 0 in both, as in the kernels).
    plain = T.decode_attention_q8(*args[:5], args[5], window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


# Paged (K7): (page, max_blocks, h, hkv, s, valid_len per row, window),
# the boundary cases of tests/test_torch_split_decode.py.
PAGED_CASES = {
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


@pytest.mark.parametrize("case", list(PAGED_CASES), ids=list(PAGED_CASES))
def test_paged_split_q8_reference_matches_jax(case):
    page, mb, h, hkv, s, valid, window = PAGED_CASES[case]
    rng = np.random.default_rng(200 + sorted(PAGED_CASES).index(case))
    d, b = 32, len(valid)
    table, nblocks = _table(rng, valid, page, mb)
    (k, ks), (v, vs) = (_quantized(rng, hkv, nblocks, page, d) for _ in range(2))
    q, vl = _rand(rng, b, h, s, d), np.array(valid, np.int32)
    n_splits, keys = T.decode_splits((h // hkv) * s, page * mb, b * hkv)
    assert n_splits > 1 and keys == T.SPLIT_KEYS  # the cases cross split boundaries
    want = _jax_paged(q, k, v, ks, vs, vl, table, window)
    args = [torch.from_numpy(a) for a in (q, k, v, ks, vs, vl, table)]
    got = T.paged_decode_split_q8_reference(*args, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for r, n in enumerate(valid):
        if n == 0:
            assert not got[r].any()
    plain = T.paged_decode_attention(args[0], args[1], args[2], args[5], args[6],
                                     k_scale=args[3], v_scale=args[4], window=window)
    np.testing.assert_allclose(got.numpy(), np.nan_to_num(plain.numpy()), **TOL)


def test_q8_split_reference_applies_each_scale_once():
    """The int8 split arithmetic, checked by hand on one key: v_scale
    multiplies p in p·v only, so a single visible key returns exactly its
    dequantized value row, whatever its v_scale; and k_scale scales its
    score, so two keys' weights follow ``q·k_int * k_scale``."""
    q = torch.tensor([[[[1.0, 0.0]]]])
    k = torch.tensor([[[[2, 0], [1, 0]]]], dtype=torch.int8)
    v = torch.tensor([[[[3, -4], [5, 6]]]], dtype=torch.int8)
    ks = torch.tensor([[[0.5, 3.0]]])
    vs = torch.tensor([[[0.25, 2.0]]])
    one = T.decode_split_q8_reference(q, k, v, ks, vs, 1, sm_scale=1.0)
    torch.testing.assert_close(one, torch.tensor([[[[0.75, -1.0]]]]), rtol=0, atol=0)
    two = T.decode_split_q8_reference(q, k, v, ks, vs, 2, sm_scale=1.0)
    w = torch.softmax(torch.tensor([2 * 0.5, 1 * 3.0]), 0)  # scores q·k_int * k_scale
    want = w[0] * torch.tensor([0.75, -1.0]) + w[1] * torch.tensor([10.0, 12.0])
    torch.testing.assert_close(two[0, 0, 0], want, rtol=1e-6, atol=1e-6)


# Wide calls (the int8 engines' prefill): (capacity or page * max_blocks,
# page, h, hkv, s, valid_len per row, window); rows = h / hkv * s > 16.
WIDE_CASES = {
    "s20_gqa": (256, 16, 8, 2, 20, [0, 10, 100, 256], None),
    "s20_mha_window": (256, 16, 4, 4, 20, [20, 255, 129, 3], 50),
    "s64_gqa": (256, 64, 4, 2, 64, [64, 200, 0, 256], None),
    "s64_mha_window": (256, 64, 4, 4, 64, [64, 130, 256, 40], 100),
}
# The card's cases at the tensor-core forward body's 128-row / 128-key
# tile edges (``kernel_checks.WIDE_CASES``), with the card's valid lengths
# (``wide_lengths``) at their own capacities, pages of 16 (capacity 255:
# the table's 16 pages map 256 positions, and the last row's valid_len 256
# runs past the dense cache, whose kernels read keys below the capacity).
for _name in ("gqa_s129", "full_causal_255"):
    _hkv, _s, _cap = kernel_checks.WIDE_CASES[_name]
    WIDE_CASES[_name] = (_cap, 16, 8, _hkv, _s, kernel_checks.wide_lengths(_s, 16, _cap)[0], None)


@pytest.mark.parametrize("case", list(WIDE_CASES), ids=list(WIDE_CASES))
def test_wide_q8_plain_matches_jax(case):
    """K5 (dense) and K7 (paged) at prefill widths: the port's plain
    versions against the interpreted JAX kernels; rows before position 0
    see no key (0 in the JAX kernels, the card's kernels and the dense
    CPU entry point; NaN in the paged CPU entry point, as in the JAX
    entry point's CPU route, its reference)."""
    cap, page, h, hkv, s, valid, window = WIDE_CASES[case]
    rng = np.random.default_rng(300 + sorted(WIDE_CASES).index(case))
    d, b = 32, len(valid)
    assert (h // hkv) * s > T.SPLIT_ROWS
    q, vl = _rand(rng, b, h, s, d), np.array(valid, np.int32)
    (k, ks), (v, vs) = _quantized(rng, b, hkv, cap, d), _quantized(rng, b, hkv, cap, d)
    got = T.decode_attention_q8(*(torch.from_numpy(a) for a in (q, k, v, ks, vs, vl)),
                                window=window)
    want = _jax_dense(q, k, v, ks, vs, vl, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    mb = -(-cap // page)
    table, nblocks = _table(rng, valid, page, mb)
    (pk, pks), (pv, pvs) = (_quantized(rng, hkv, nblocks, page, d) for _ in range(2))
    got = T.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, pk, pv, vl, table)), k_scale=torch.from_numpy(pks),
        v_scale=torch.from_numpy(pvs), window=window)
    want = _jax_paged(q, pk, pv, pks, pvs, vl, table, window)
    np.testing.assert_allclose(np.nan_to_num(got.numpy()), want, **TOL)
