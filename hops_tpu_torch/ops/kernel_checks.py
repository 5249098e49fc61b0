"""Check cases and operands of the cache kernels (K4's wide calls, K5
dense int8, K6 and K7 paged) and of every kernel at head dims narrower
than its bodies' (:func:`narrow_head_checks`), shared by
``chip_smoke.py`` phases 3 to 3c and ``tests/test_torch_kernels.py``, so
that both hold the kernels to the same cases with the same operands.

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


#: Head dims below the kernels' 64 that the JAX functions take and the
#: examples use (``continuous_batching`` 8, ``lm_serving`` and
#: ``long_context_lm`` 16): the entry points zero-pad them to 64.
NARROW_HEAD_DIMS = (8, 16, 32)
# (seq_q, seq_k, causal, window) of K1 and K2/K3 at a narrow head dim:
# one 128-row tile, a ragged non-causal length, and a window over a long key run.
NARROW_FLASH = ((128, 128, True, None), (300, 300, False, None), (64, 1024, True, 100))
# (kv heads of 8 query heads, query tokens, capacity, valid_len, window)
# of K4-K7 at a narrow head dim: a decode step on the split body, and a
# wide call (rows 160) on the tensor-core bodies in bf16.
NARROW_DECODE = ((8, 1, 512, [0, 1, 300, 512], None), (2, 40, 512, [0, 30, 200, 512], 100))
NARROW_PAGE = 16


def held(out, ref, mag, slack: float) -> tuple[float, float, bool]:
    """``(max |out - ref|, worst |out - ref| / bound, ok)`` per element,
    ``bound = 2**-8 * (mag + |ref|) + slack`` (``mag``: the product whose
    operand a bf16 tensor-core body rounds, over magnitudes; 0 for a body
    that rounds only its output; None for fp32 inputs: ``bound =
    slack``). ``slack == 0`` with ``mag`` None asks for equal bits. NaN
    in ``ref`` (a row that sees no key) must be 0 in ``out``."""
    ref = torch.nan_to_num(ref.float(), nan=0.0)
    err = (out.float() - ref).abs()
    finite = bool(torch.isfinite(out.float()).all())
    if mag is None and slack == 0:
        same = torch.equal(out, ref.to(out.dtype)) and finite
        return err.max().item(), 0.0 if same else float("inf"), same
    bound = torch.full_like(ref, slack)
    if mag is not None:
        bound = bound + 2.0 ** -8 * (torch.nan_to_num(torch.as_tensor(mag).float(), nan=0.0)
                                     + ref.abs())
    ratio = (err / bound).max().item()
    return err.max().item(), ratio, ratio <= 1.0 and finite


def narrow_head_checks(d: int, dtype: torch.dtype, gen: torch.Generator, dev,
                       part: str = "all"):
    """Every kernel at head dim ``d`` (< 64): K1 and K2/K3 over
    :data:`NARROW_FLASH` (``part`` "flash" or "all"), K4 and K5 (dense)
    and K6 and K7 (paged, page :data:`NARROW_PAGE`) over
    :data:`NARROW_DECODE` (``part`` "cache" or "all"), with ``dtype``
    queries. Yields ``(case, counter, launched, out, ref, mag, slack)``
    per output, for :func:`held`: ``counter`` the launch counter the call
    must have raised by one (and no other), ``launched`` whether it did.
    The cache kernels run twice, on caches at ``d`` (padded per call) and
    at :func:`~hops_tpu_torch.ops.attention.kernel_head_dim` (padded once,
    as the model allocates them): the second output must equal the
    first bit for bit (``mag`` None, ``slack`` 0)."""
    bf16 = dtype == torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def counted(counter, fn):
        before = A.launch_counts()
        out = fn()
        after = A.launch_counts()
        ok = (after[counter] == before[counter] + 1
              and sum(after.values()) == sum(before.values()) + 1)
        return out, ok

    for sq, sk, causal, window in NARROW_FLASH if part in ("flash", "all") else ():
        kw = dict(causal=causal, window=window)
        case = f"d{d} seq_q {sq} seq_k {sk} causal={causal} window={window}"
        q, k, v, do = rand(2, 4, sq, d), rand(2, 4, sk, d), rand(2, 4, sk, d), rand(2, 4, sq, d)
        f = [t.float() for t in (q, k, v, do)]
        (o, lse), ok = counted("flash_fwd", lambda: A.flash_attention(q, k, v, return_lse=True,
                                                                      **kw))
        mag = A.attention_reference(f[0], f[1], f[2].abs(), **kw) if bf16 else None
        yield (f"flash_fwd o {case}", "flash_fwd", ok, o,
               A.attention_reference(*f[:3], **kw), mag, 1e-4)
        yield (f"flash_fwd lse {case}", "flash_fwd", ok, lse,
               A.attention_lse_reference(*f[:2], **kw), None, 1e-4)
        delta = (o.float() * do.float()).sum(-1)
        dq, ok_dq = counted("flash_bwd_dq", lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw))
        (dk, dv), ok_dkv = counted("flash_bwd_dkv",
                                   lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
        refs = (A.flash_bwd_dq_reference(*f, lse, delta, **kw),
                *A.flash_bwd_dkv_reference(*f, lse, delta, **kw))
        mags = [None] * 3
        if bf16:
            sm_scale, q_offset = A._attention_args(f[0], f[1], causal, None, None, window)
            p, ds = A._bwd_probs(*f, lse, delta, causal, sm_scale, q_offset, window)
            mags = [torch.einsum("bhqk,bhkd->bhqd", ds.abs(), f[1].abs()),
                    torch.einsum("bhqk,bhqd->bhkd", ds.abs(), f[0].abs()),
                    torch.einsum("bhqk,bhqd->bhkd", p, f[3].abs())]
        for out_name, counter, ok_b, out, ref, mag in zip(
                ("dq", "dk", "dv"), ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                (ok_dq, ok_dkv, ok_dkv), (dq, dk, dv), refs, mags):
            yield (f"{counter} {out_name} {case}", counter, ok_b, out, ref, mag,
                   1e-4 * max(1.0, ref.abs().max().item()))

    dp = A.kernel_head_dim(d)
    for hkv, s, cap, valid, window in NARROW_DECODE if part in ("cache", "all") else ():
        rows = (8 // hkv) * s
        split = rows <= A.SPLIT_ROWS
        wide_bf16 = bf16 and not split
        case = f"d{d} hkv {hkv} s {s} cap {cap} valid_len {valid} window={window}"
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        q = rand(len(valid), 8, s, d)
        mag0 = 0.0 if bf16 else None  # the split body rounds its output alone
        # K4, the dense bf16/fp32 cache.
        k, v = rand(len(valid), hkv, cap, d), rand(len(valid), hkv, cap, d)
        kf, vf = k.float(), v.float()
        counter = "decode_attention_chunk" if wide_bf16 else "decode_attention"
        o, ok = counted(counter, lambda: A.decode_attention(q, k, v, vl, window=window))
        mag = (A.decode_attention_reference(q.float(), kf, vf.abs(), vl, window=window)
               if wide_bf16 else mag0)
        yield (f"{counter} {case}", counter, ok, o,
               A.decode_attention_reference(q.float(), kf, vf, vl, window=window), mag, 1e-4)
        kp, vp = A._pad_head(k, dp), A._pad_head(v, dp)
        o2, ok = counted(counter, lambda: A.decode_attention(q, kp, vp, vl, window=window))
        yield f"{counter} padded cache {case}", counter, ok, o2, o, None, 0.0
        # K5, the dense int8 cache.
        kv, _ = q8_operands("dense", cap, cap, hkv, d, valid, gen, dev)
        counter = "decode_attention_q8_chunk" if wide_bf16 else "decode_attention_q8"
        o, ok = counted(counter, lambda: q8_call(q, kv, vl, None, window))
        mag = q8_plain(q, [kv[0], kv[1].abs(), *kv[2:]], vl, None, window) if wide_bf16 else mag0
        yield (f"{counter} {case}", counter, ok, o, q8_plain(q, kv, vl, None, window), mag, 1e-4)
        kvp = [A._pad_head(kv[0], dp), A._pad_head(kv[1], dp), *kv[2:]]
        o2, ok = counted(counter, lambda: q8_call(q, kvp, vl, None, window))
        yield f"{counter} padded cache {case}", counter, ok, o2, o, None, 0.0
        # K6 and K7, bf16/fp32 and int8 pools under a shuffled table.
        for quantized in (False, True):
            pages, nblocks = shuffled_table(NARROW_PAGE, cap, valid, gen, dev)
            name = "paged_decode_attention_q8" if quantized else "paged_decode_attention"
            counter = name + "_chunk" if wide_bf16 else name
            if quantized:
                (pk, ks), (pv, vs) = (A.quantize_kv(torch.randn(hkv, nblocks, NARROW_PAGE, d,
                                                                generator=gen).to(dev))
                                      for _ in range(2))
                sc = dict(k_scale=ks, v_scale=vs)
                pkf, pvf = pk, pv
            else:
                pk, pv = rand(hkv, nblocks, NARROW_PAGE, d), rand(hkv, nblocks, NARROW_PAGE, d)
                sc, pkf, pvf = {}, pk.float(), pv.float()
            o, ok = counted(counter, lambda: A.paged_decode_attention(
                q, pk, pv, vl, pages, window=window, **sc))
            ref = A.paged_decode_attention_reference(q.float(), pkf, pvf, vl, pages,
                                                     window=window, **sc)
            mag = (A.paged_decode_attention_reference(q.float(), pkf, pvf.abs(), vl, pages,
                                                      window=window, **sc)
                   if wide_bf16 else mag0)
            yield f"{counter} page {NARROW_PAGE} {case}", counter, ok, o, ref, mag, 1e-4
            pkp, pvp = A._pad_head(pk, dp), A._pad_head(pv, dp)
            o2, ok = counted(counter, lambda: A.paged_decode_attention(
                q, pkp, pvp, vl, pages, window=window, **sc))
            yield (f"{counter} page {NARROW_PAGE} padded pool {case}", counter, ok, o2, o,
                   None, 0.0)
