"""Check cases and operands of the cache kernels (K4's wide calls, K5
dense int8, K6 and K7 paged), shared by ``chip_smoke.py`` phases 3 and
3c and ``tests/test_torch_kernels.py``, so that both hold the kernels to
the same cases with the same operands.

Nothing here launches a kernel by itself: :func:`q8_call` goes through
the public entry points, which run the kernel on CUDA tensors and the
plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from hops_tpu_torch.ops import attention as A

# The int8 split body (decode calls, rows = g·s <= 16): name -> (page,
# capacity, kv heads of 8 query heads, query tokens, valid_len per row,
# window). K5's dense capacity is page * ceil(capacity / page) there too.
Q8_SPLIT_CASES = {
    "boundaries": (64, 2048, 8, 1, [127, 128, 129, 2048, 0], None),  # L - 1, L, L + 1, full, 0
    "window_empties_leading": (16, 2048, 2, 1, [1000, 700, 513, 2048, 1], 100),  # GQA rows 4
    "gqa_rows_16_page_24": (24, 2064, 2, 4, [2064, 255, 257, 0, 1025], 300),
    "rows_5": (64, 2048, 8, 5, [5, 258, 1531, 2048], None),
}
# The wide bf16 calls (rows > 16: K6 and K7's tensor-core chunk body, K4's
# and K5's tensor-core forward body): name -> (kv heads of 8 query heads, query
# tokens, capacity); rows 17, 100, 256, GQA 20 and 100 (64-row chunk tiles
# that span heads), s = capacity, the full causal form of the int8
# engine's admission prefill (4 of the forward body's 128-row tiles), and
# at the forward body's tile edges: s = 129 (a second row tile of one row)
# against capacity 2048, GQA, and full causal at s = capacity = 255 (a
# 127-row tile; a last key tile cut at 255).
WIDE_CASES = {
    "rows17": (8, 17, 2048),
    "rows100": (8, 100, 2048),
    "rows256": (8, 256, 2048),
    "gqa_rows20": (2, 5, 2048),
    "gqa_rows100": (2, 25, 2048),
    "full_causal_512": (8, 512, 512),
    "gqa_s129": (2, 129, 2048),
    "full_causal_255": (8, 255, 255),
}


def wide_lengths(s: int, page: int, cap: int) -> tuple[list[int], list[int]]:
    """``(valid, alloc)`` of a wide case: valid_len 0, below s (rows
    before position 0 see no key), a page boundary + 1 (at most the
    capacity), a row whose last two pages map the scratch block below its
    valid length (the engine's pad rows; 1300 at capacity 2048), and the
    full capacity rounded up to a page; ``alloc`` the positions each row's
    table maps."""
    valid = [0, max(s - 3, 1), min(5 * page + 1, cap), min(1300, cap), -(-cap // page) * page]
    return valid, [*valid[:3], valid[3] - 2 * page, valid[4]]


def shuffled_table(page: int, cap: int, alloc: list[int], gen: torch.Generator,
                   dev) -> tuple[torch.Tensor, int]:
    """``(pages, nblocks)``: a ``(len(alloc), ceil(cap / page))`` table
    over a pool of ``1 + rows * max_blocks`` blocks in which row r maps
    distinct, shuffled nonzero blocks below ``alloc[r]`` positions and the
    scratch block 0 past them (a free row is all zeros)."""
    mb = -(-cap // page)
    nblocks = 1 + len(alloc) * mb
    free = (torch.randperm(nblocks - 1, generator=gen) + 1).tolist()
    table = torch.zeros(len(alloc), mb, dtype=torch.int32)
    for r, n in enumerate(alloc):
        need = -(-n // page)
        table[r, :need] = torch.tensor(free[:need], dtype=torch.int32)
        free = free[need:]
    return table.to(dev), nblocks


def q8_operands(layout: str, page: int, cap: int, hkv: int, d: int, alloc: list[int],
                gen: torch.Generator, dev) -> tuple[list[torch.Tensor], torch.Tensor | None]:
    """``(kv, pages)``: int8 ``[k, v, k_scale, v_scale]`` of K5's dense
    ``(rows, hkv, cap, d)`` cache (``layout`` "dense", ``pages`` None) or
    of K7's pools of page ``page`` under a :func:`shuffled_table` mapping
    row r up to ``alloc[r]`` positions (``layout`` "paged")."""
    if layout == "dense":
        shape, pages = (len(alloc), hkv, cap, d), None
    else:
        pages, nblocks = shuffled_table(page, cap, alloc, gen, dev)
        shape = (hkv, nblocks, page, d)
    (k, ks), (v, vs) = (A.quantize_kv(torch.randn(*shape, generator=gen).to(dev)) for _ in range(2))
    return [k, v, ks, vs], pages


def q8_call(q, kv, vl, pages, window=None) -> torch.Tensor:
    """K5 (``pages`` None) or K7 over int8 operands ``kv``."""
    if pages is None:
        return A.decode_attention_q8(q, *kv, vl, window=window)
    return A.paged_decode_attention(q, kv[0], kv[1], vl, pages, k_scale=kv[2], v_scale=kv[3],
                                    window=window)


def q8_plain(q, kv, vl, pages, window=None) -> torch.Tensor:
    """The fp32 plain version of :func:`q8_call` (NaN where a row sees no
    key)."""
    if pages is None:
        return A.decode_attention_q8_reference(q.float(), *kv, vl, window=window)
    return A.paged_decode_attention_reference(q.float(), kv[0], kv[1], vl, pages, window=window,
                                              k_scale=kv[2], v_scale=kv[3])


def q8_poisoned(kv, vl, pages) -> list[torch.Tensor]:
    """A copy of ``kv`` whose keys no row may read hold garbage: values
    ±127, k_scale and v_scale NaN at even positions and 1e30 at odd ones
    (a NaN scale reaches an output through any product, even with p = 0).
    Paged: the scratch block 0; dense: every position at or past a row's
    valid_len."""
    k, v, ks, vs = (t.clone() for t in kv)
    if pages is not None:
        where = torch.zeros(ks.shape, dtype=torch.bool, device=ks.device)
        where[:, 0] = True
    else:
        past = torch.arange(k.shape[2], device=k.device)[None, :] >= vl[:, None]
        where = past[:, None, :].expand(k.shape[:3])
    pos = torch.arange(ks.shape[-1], device=ks.device)
    junk = torch.where(pos % 2 == 0, float("nan"), 1e30).expand(ks.shape)
    k[where], v[where] = 127, -127
    ks, vs = torch.where(where, junk, ks), torch.where(where, junk, vs)
    return [k, v, ks, vs]


def dense_poisoned(k: torch.Tensor, v: torch.Tensor, vl: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Copies of K4's dense ``(b, hkv, cap, d)`` caches whose positions at
    or past each row's valid_len (stale slots of a reused cache) hold
    garbage: NaN at even positions, +1e30 in K and -1e30 in V at odd ones
    (a NaN value reaches an output through p·v even with p = 0)."""
    pos = torch.arange(k.shape[2], device=k.device)
    past = (pos[None, :] >= vl[:, None])[:, None, :, None]
    k2, v2 = (torch.where(past, torch.where(pos[:, None] % 2 == 0, float("nan"), sign * 1e30)
                          .to(t.dtype), t) for t, sign in ((k, 1.0), (v, -1.0)))
    return k2, v2
