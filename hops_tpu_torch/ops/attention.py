"""Attention for the port (counterpart of ``hops_tpu/ops/attention.py``).

Layout ``(batch, heads, seq, head_dim)``, as in the JAX package.

The entry points run hand-written CUDA kernels for Hopper on CUDA
tensors and their plain PyTorch versions on CPU tensors:

- :func:`flash_attention` -> ``csrc/flash_fwd.cu`` (K1, ``_fwd_kernel``)
  forward; under autograd its backward (:func:`flash_attention_bwd`)
  runs ``csrc/flash_bwd_dq.cu`` (K2, ``_bwd_dq_kernel``) and
  ``csrc/flash_bwd_dkv.cu`` (K3, ``_bwd_dkv_kernel``), the
  flash-attention-2 split of the JAX custom VJP;
- :func:`decode_attention` -> ``csrc/decode_attention.cu`` (K4,
  ``_decode_kernel``), the dense, unquantized cache (decode steps on a
  split-K body and a combine kernel, splits from :func:`decode_splits`;
  bf16 appends to a warm cache on K1's tensor-core forward body,
  counted apart as ``decode_attention_chunk``);
  with ``k_scale`` / ``v_scale`` (:func:`decode_attention_q8`)
  ``csrc/decode_attention_q8.cu`` (K5, ``_decode_q8_kernel``), the dense
  int8 cache (decode steps on the split-K body; bf16 prefill on K1's
  tensor-core forward body, ``csrc/flash_fwd_tc.cuh``, over int8 K/V
  widened in shared memory, counted apart as
  ``decode_attention_q8_chunk``);
- :func:`paged_decode_attention` -> ``csrc/paged_decode_attention.cu``,
  K6 (``_paged_decode_kernel``) over bf16/fp32 block pools (decode
  steps on the split-K body, bf16 prefill chunks on a tensor-core body,
  counted apart as ``paged_decode_attention_chunk``), or
  ``csrc/paged_decode_attention_q8.cu``, K7 (``_paged_decode_q8_kernel``)
  over int8 pools with fp32 scale pools (the same two bodies; its chunks
  counted as ``paged_decode_attention_q8_chunk``).

On a CUDA tensor the entry point launches its kernel or raises; it never
falls back. The kernels mask ragged tails themselves, so every sequence
length, cache capacity and page size runs on them (no block table, no
reference routing below a length or for a page size). Each launch adds
one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import math

import torch

from hops_tpu_torch.ops import _build

NEG_INF = float("-inf")

#: Launches of each kernel since the last :func:`reset_launch_counts`.
#: A decode kernel's wide bf16 calls (rows > ``SPLIT_ROWS``: a prefill,
#: or a suffix appended to a stored prefix) run a tensor-core body (K4,
#: K5: K1's forward body over bf16 or int8 K/V; K6, K7: the chunk body)
#: and count under ``<kernel>_chunk``.
LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "decode_attention": 0,
    "decode_attention_chunk": 0, "decode_attention_q8": 0, "decode_attention_q8_chunk": 0,
    "paged_decode_attention": 0, "paged_decode_attention_chunk": 0,
    "paged_decode_attention_q8": 0, "paged_decode_attention_q8_chunk": 0,
}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (64, 128)

#: The split-K body of K4-K7 takes calls of at most this many rows (g
#: query heads per kv head times s tokens): every decode step.
SPLIT_ROWS = 16
#: Keys per split before the cap below: two of the kernel's 64-key tiles
#: (at the served decode shape K6 read 128 faster than 256 and 512 on an
#: H100; PERF.md).
SPLIT_KEYS = 128
_SPLIT_TILE = 64
#: At most this many blocks per call (4 waves of the H100's 132 SMs).
SPLIT_MAX_BLOCKS = 4 * 132


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def repeat_kv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Broadcast GQA kv heads to match q's head count (no-op for MHA).

    kv head ``j`` serves the contiguous query heads ``j*g .. j*g + g - 1``
    — the order :func:`decode_attention`'s row folding assumes."""
    if q.shape[1] == k.shape[1]:
        return k, v
    g = q.shape[1] // k.shape[1]
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)


def _masked_scores(q, k, causal, sm_scale, q_offset, window):
    """fp32 ``(b, h, sq, sk)`` scaled scores with masked entries at -inf."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        # q_offset may be per batch row (shape (b,), the ragged-decode
        # path) or a scalar; the mask broadcasts to (b, 1, sq, sk).
        off = torch.as_tensor(q_offset, device=q.device)
        off = off[:, None, None] if off.ndim == 1 else off
        q_pos = torch.arange(q.shape[2], device=q.device)[:, None] + off
        k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
        visible = q_pos >= k_pos
        if window is not None:
            visible = visible & (q_pos - k_pos < window)
        if visible.ndim == 3:
            visible = visible[:, None]
        s = s.masked_fill(~visible, NEG_INF)
    return s


def _attention_args(q, k, causal, sm_scale, q_offset, window):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2] if causal else 0
    return sm_scale, q_offset


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int | torch.Tensor | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Plain attention: the numeric ground truth.

    ``q_offset`` places query row i at absolute key position
    ``i + q_offset``; the causal default aligns the queries with the
    *last* ``seq_q`` keys. Scores are fp32; probabilities are cast to
    v's dtype for the value product. A row that sees no key is NaN, as
    in the JAX reference.
    """
    sm_scale, q_offset = _attention_args(q, k, causal, sm_scale, q_offset, window)
    s = _masked_scores(q, k, causal, sm_scale, q_offset, window)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def attention_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """fp32 ``(b, h, seq_q)`` logsumexp of the masked scaled scores —
    the plain version of the flash kernel's second output (-inf where a
    row sees no key)."""
    sm_scale, q_offset = _attention_args(q, k, causal, sm_scale, q_offset, window)
    return torch.logsumexp(
        _masked_scores(q, k, causal, sm_scale, q_offset, window), dim=-1
    )


def _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, q_offset, window):
    """fp32 ``(p, ds)`` of the backward kernels: ``p = exp(s - lse)``
    (0 where the row's lse is -inf: the row sees no key), ``dp = do vᵀ``,
    ``ds = p (dp - delta) sm_scale``."""
    s = _masked_scores(q, k, causal, sm_scale, q_offset, window)
    lse = lse.float()[..., None]
    dead = torch.isneginf(lse)
    p = torch.where(dead, 0.0, torch.exp(s - torch.where(dead, 0.0, lse)))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None]) * sm_scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                           q_offset=None, window=None) -> torch.Tensor:
    """Plain version of K2: ``dq = ds k`` from the forward's fp32 ``lse``
    and ``delta = rowsum(o·do)`` (both ``(b, h, seq_q)``), in q's dtype."""
    sm_scale, q_offset = _attention_args(q, k, causal, sm_scale, q_offset, window)
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, q_offset, window)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                            q_offset=None, window=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``dk = dsᵀ q`` and ``dv = pᵀ do``, in k's and
    v's dtypes."""
    sm_scale, q_offset = _attention_args(q, k, causal, sm_scale, q_offset, window)
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, q_offset, window)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float()).to(v.dtype)
    return dk, dv


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False, sm_scale=None,
                                  q_offset=None, window=None):
    """Plain backward of :func:`flash_attention` with the kernels'
    formulas (not autograd of :func:`attention_reference`): ``(dq, dk,
    dv)`` from the saved output ``o`` and fp32 ``lse``."""
    delta = (o.float() * do.float()).sum(-1)
    args = (causal, sm_scale, q_offset, window)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, *args),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta, *args))


def _normalize_valid_len(valid_len, b: int, device) -> torch.Tensor:
    """``valid_len`` as a contiguous ``(b,)`` int32 tensor on ``device``:
    a scalar broadcasts (uniform decode), a ``(b,)`` vector passes
    through (ragged decode). Anything else is a caller bug."""
    vl = torch.as_tensor(valid_len, dtype=torch.int32, device=device)
    if vl.ndim == 0:
        return vl.expand(b).contiguous()
    if tuple(vl.shape) != (b,):
        raise ValueError(
            f"valid_len must be a scalar or shape ({b},), got {tuple(vl.shape)}"
        )
    return vl.contiguous()


def _sees_a_key(vl: torch.Tensor, s: int, capacity: int, window: int | None) -> torch.Tensor:
    """``(b, s)``: whether query row i of each batch row (position
    ``valid_len - s + i``) sees a key of the cache: its newest visible
    key, ``min(position, capacity - 1)``, exists and lies within
    ``window``."""
    pos = vl[:, None] - s + torch.arange(s, device=vl.device)
    newest = torch.clamp_max(pos, capacity - 1)
    sees = newest >= 0
    if window is not None:
        sees = sees & (pos - newest < window)
    return sees


def decode_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`decode_attention`.

    ``q`` is ``(b, h, s, d)``: the last ``s`` tokens, already RoPE'd, at
    absolute positions ``valid_len - s .. valid_len - 1`` of the
    ``(b, hkv, capacity, d)`` caches. Exactly causal attention with the
    chunk at offset ``valid_len - s``; fewer kv heads than q heads (GQA)
    broadcast. A ``valid_len == 0`` row returns zeros.
    """
    vl = _normalize_valid_len(valid_len, q.shape[0], q.device)
    k, v = repeat_kv(q, k, v)
    out = attention_reference(
        q, k, v, causal=True, sm_scale=sm_scale,
        q_offset=vl - q.shape[2], window=window,
    )
    return torch.where((vl > 0)[:, None, None, None], out, 0.0)


def quantize_kv(x: torch.Tensor, eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position symmetric int8 quantization over the head dim:
    ``(..., seq, d)`` -> (int8 values, fp32 scales ``(..., seq)``) with
    ``x ≈ values * scales[..., None]``. The same arithmetic as the JAX
    package (fp32 division, round half to even, clip to ±127), so the
    int8 values are equal."""
    scale = torch.clamp_min(x.float().abs().amax(dim=-1) / 127.0, eps)
    q = torch.round(x.float() / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`."""
    return (values.float() * scales[..., None].float()).to(dtype)


def paged_gather_kv(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """The dense ``(b, hkv, max_blocks*page, d)`` view of a ``(hkv,
    nblocks, page, d)`` block pool under a ``(b, max_blocks)`` page
    table. Only the plain version gathers; the kernels read each pool
    block through the table."""
    hkv, _, ps, d = pool.shape
    b, mb = pages.shape
    return pool[:, pages.long()].movedim(1, 0).reshape(b, hkv, mb * ps, d)


def paged_gather_scales(pool_s: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """:func:`paged_gather_kv` for a ``(hkv, nblocks, page)`` scale pool:
    the dense ``(b, hkv, max_blocks*page)`` view."""
    hkv, _, ps = pool_s.shape
    b, mb = pages.shape
    return pool_s[:, pages.long()].movedim(1, 0).reshape(b, hkv, mb * ps)


def decode_attention_q8_reference(q, k, v, k_scale, v_scale, valid_len, sm_scale=None,
                                  window=None) -> torch.Tensor:
    """Plain version of :func:`decode_attention_q8`: dequantize the int8
    caches, attend in fp32, cast to q's dtype."""
    return decode_attention_reference(
        q.float(), dequantize_kv(k, k_scale), dequantize_kv(v, v_scale),
        valid_len, sm_scale, window,
    ).to(q.dtype)


def decode_splits(rows: int, capacity: int, bhkv: int) -> tuple[int, int]:
    """``(n_splits, split_keys)`` of a decode call on the split-K body of
    K4 or K6, chosen from the shape alone: ``capacity`` (the dense cache's
    length, or a paged call's ``max_blocks * page``), never
    ``valid_len``, which stays on the device.

    ``split_keys`` is a multiple of the 64-key tile, ``SPLIT_KEYS`` unless
    the cap of ``SPLIT_MAX_BLOCKS`` blocks (``n_splits * bhkv``, ``bhkv``
    the batch times the kv heads) makes each split longer, and
    ``n_splits * split_keys`` covers the capacity. A call wider than
    ``SPLIT_ROWS`` rows takes another body instead: ``(1, capacity)``.
    """
    if rows < 1 or capacity < 1 or bhkv < 1:
        raise ValueError(f"decode_splits: rows {rows}, capacity {capacity}, bhkv {bhkv}")
    if rows > SPLIT_ROWS:
        return 1, capacity
    keys, most = SPLIT_KEYS, max(1, SPLIT_MAX_BLOCKS // bhkv)
    if math.ceil(capacity / keys) > most:  # longer splits, still whole tiles
        keys = math.ceil(math.ceil(capacity / most) / _SPLIT_TILE) * _SPLIT_TILE
    return math.ceil(capacity / keys), keys


def decode_split_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Plain version of the split-K body and its combine, in fp32, on
    dense ``(b, hkv, capacity, d)`` caches (K4's layout): the splits of
    :func:`decode_splits`, each split's ``(m, l, acc)`` by the online
    softmax's arithmetic over its keys, merged as the combine kernel
    merges them (``M = max m_i``, ``o = sum e^(m_i - M) acc_i / sum
    e^(m_i - M) l_i``, with ``-inf`` guards and ``l_safe``). Equal to
    :func:`decode_attention_reference` up to rounding; for the tests,
    which pin the combine arithmetic against JAX on the CPU."""
    b, h, s, d = q.shape
    hkv, cap = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    vl = _normalize_valid_len(valid_len, b, q.device)
    kd, vd = repeat_kv(q, k.float(), v.float())
    n_splits, keys = decode_splits((h // hkv) * s, cap, b * hkv)
    sc = _masked_scores(q.float(), kd, True, sm_scale, vl - s, window)  # (b, h, s, cap)
    parts = []
    for i in range(n_splits):
        si = sc[..., i * keys:(i + 1) * keys]
        m = si.amax(-1, keepdim=True)
        p = torch.exp(si - torch.where(torch.isneginf(m), 0.0, m))
        parts.append((m, p.sum(-1, keepdim=True), p @ vd[:, :, i * keys:(i + 1) * keys]))
    m = torch.stack([pt[0] for pt in parts])
    big = m.amax(0)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - torch.where(torch.isneginf(big), 0.0, big)))
    num = (w * torch.stack([pt[2] for pt in parts])).sum(0)
    den = (w * torch.stack([pt[1] for pt in parts])).sum(0)
    return (num / torch.where(den == 0, 1.0, den)).to(q.dtype)


def decode_split_q8_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """:func:`decode_split_reference` over a dense int8 cache (K5's split-K
    body and its combine), with the int8 arithmetic of the kernel: scores
    of the int8 keys times each key's ``k_scale``, then ``sm_scale`` and
    the mask; each split's ``acc`` sums ``p * v_scale`` times the int8
    values while its ``l`` sums the unscaled ``p``. In fp32; for the
    tests."""
    b, h, s, d = q.shape
    hkv, cap = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    vl = _normalize_valid_len(valid_len, b, q.device)
    kd, vd = repeat_kv(q, k.float(), v.float())
    ks, vs = (t.float().repeat_interleave(h // hkv, dim=1)[:, :, None, :]
              for t in (k_scale, v_scale))  # (b, h, 1, cap)
    n_splits, keys = decode_splits((h // hkv) * s, cap, b * hkv)
    raw = torch.einsum("bhqd,bhkd->bhqk", q.float(), kd) * ks
    pos = torch.arange(s, device=q.device)[None, :] + (vl - s)[:, None]  # (b, s)
    kpos = torch.arange(cap, device=q.device)
    vis = kpos[None, None, :] <= pos[:, :, None]
    if window is not None:
        vis = vis & (pos[:, :, None] - kpos[None, None, :] < window)
    sc = torch.where(vis[:, None], raw * sm_scale, NEG_INF)  # (b, h, s, cap)
    parts = []
    for i in range(n_splits):
        cut = slice(i * keys, (i + 1) * keys)
        si = sc[..., cut]
        m = si.amax(-1, keepdim=True)
        p = torch.exp(si - torch.where(torch.isneginf(m), 0.0, m))
        parts.append((m, p.sum(-1, keepdim=True), (p * vs[..., cut]) @ vd[:, :, cut]))
    m = torch.stack([pt[0] for pt in parts])
    big = m.amax(0)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(m - torch.where(torch.isneginf(big), 0.0, big)))
    num = (w * torch.stack([pt[2] for pt in parts])).sum(0)
    den = (w * torch.stack([pt[1] for pt in parts])).sum(0)
    return (num / torch.where(den == 0, 1.0, den)).to(q.dtype)


def paged_decode_split_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    pages: torch.Tensor,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """:func:`decode_split_reference` through a page table (K6's split-K
    body and its combine): the gathered dense view of the pools, split
    over its ``max_blocks * page`` positions."""
    return decode_split_reference(q, paged_gather_kv(k, pages), paged_gather_kv(v, pages),
                                  valid_len, sm_scale, window)


def paged_decode_split_q8_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    valid_len,
    pages: torch.Tensor,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """:func:`decode_split_q8_reference` through a page table (K7's
    split-K body and its combine): the gathered dense views of the int8
    pools and of their scale pools."""
    return decode_split_q8_reference(
        q, paged_gather_kv(k, pages), paged_gather_kv(v, pages),
        paged_gather_scales(k_scale, pages), paged_gather_scales(v_scale, pages),
        valid_len, sm_scale, window)


def paged_decode_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    pages: torch.Tensor,
    sm_scale: float | None = None,
    window: int | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`paged_decode_attention`: gather the dense
    view, then :func:`decode_attention_reference` (int8 pools dequantize
    first and attend in fp32, cast to q's dtype)."""
    dk, dv = paged_gather_kv(k, pages), paged_gather_kv(v, pages)
    if k_scale is not None:
        return decode_attention_q8_reference(
            q, dk, dv, paged_gather_scales(k_scale, pages),
            paged_gather_scales(v_scale, pages), valid_len, sm_scale, window,
        )
    return decode_attention_reference(q, dk, dv, valid_len, sm_scale, window)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != tensors[0].dtype:
            raise ValueError(f"{name}: inputs of different dtypes")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: input not 16-byte aligned")
    if tensors[0].dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {tensors[0].dtype} not in {_KERNEL_DTYPES}")
    if tensors[0].shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name}: head_dim {tensors[0].shape[-1]} not in {_KERNEL_HEAD_DIMS}"
        )


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_of(name: str, q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


def _flash_fwd(q, k, v, causal, sm_scale, q_offset, window):
    """``(o, lse)``: K1 on CUDA tensors; on CPU tensors the plain
    versions, with a row that sees no key at 0 as the kernel writes it."""
    if _device_of("flash_attention", q) == "cpu":
        lse = attention_lse_reference(q, k, causal, sm_scale, q_offset, window)
        o = attention_reference(q, k, v, causal, sm_scale, q_offset, window)
        return torch.where(torch.isneginf(lse)[..., None], 0.0, o), lse
    b, h, sq, d = q.shape
    _check_kernel_inputs("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.kernel("flash_fwd")
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, sq, k.shape[2], d, int(q.dtype == torch.bfloat16), float(sm_scale),
        int(causal), int(q_offset), int(window or 0), _stream(q.device),
    )
    _build.check("flash_fwd", rc)
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_launch(name, q, k, v, do, lse, delta, outs, causal, sm_scale, q_offset, window):
    b, h, sq, d = q.shape
    _check_kernel_inputs(name, q, k, v, do, *outs)
    for t in (lse, delta):
        if t.device != q.device or t.dtype != torch.float32 or t.data_ptr() % 16:
            raise ValueError(f"{name}: lse/delta must be 16-byte aligned fp32 on {q.device}")
    fn = _build.kernel(name)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in outs), b * h, sq, k.shape[2], d,
        int(q.dtype == torch.bfloat16), float(sm_scale), int(causal), int(q_offset),
        int(window or 0), _stream(q.device),
    )
    _build.check(name, rc)
    LAUNCHES[name] += 1


def _bwd_inputs(name, q, k, v, do, lse, delta, causal, sm_scale, q_offset, window):
    if (k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] or v.shape != k.shape
            or do.shape != q.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, do {tuple(do.shape)}")
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"{name}: lse/delta must be (b, h, seq_q) = {tuple(q.shape[:3])}")
    sm_scale, q_offset = _attention_args(q, k, causal, sm_scale, q_offset, window)
    return sm_scale, q_offset, [t.contiguous() for t in (q, k, v, do, lse, delta)]


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=False, sm_scale=None,
                 q_offset=None, window=None) -> torch.Tensor:
    """``dq`` of flash attention from the forward's fp32 ``lse`` and
    ``delta = rowsum(o·do)`` (both ``(b, h, seq_q)`` fp32), in q's dtype.
    CUDA tensors run ``csrc/flash_bwd_dq.cu`` (K2); CPU tensors run
    :func:`flash_bwd_dq_reference`."""
    sm_scale, q_offset, ts = _bwd_inputs(
        "flash_bwd_dq", q, k, v, do, lse, delta, causal, sm_scale, q_offset, window)
    if _device_of("flash_bwd_dq", q) == "cpu":
        return flash_bwd_dq_reference(*ts, causal, sm_scale, q_offset, window)
    dq = torch.empty_like(ts[0])
    _bwd_launch("flash_bwd_dq", *ts, [dq], causal, sm_scale, q_offset, window)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=False, sm_scale=None,
                  q_offset=None, window=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of flash attention, in k's dtype. CUDA tensors run
    ``csrc/flash_bwd_dkv.cu`` (K3); CPU tensors run
    :func:`flash_bwd_dkv_reference`. A key that no query sees gets 0."""
    sm_scale, q_offset, ts = _bwd_inputs(
        "flash_bwd_dkv", q, k, v, do, lse, delta, causal, sm_scale, q_offset, window)
    if _device_of("flash_bwd_dkv", q) == "cpu":
        return flash_bwd_dkv_reference(*ts, causal, sm_scale, q_offset, window)
    dk, dv = torch.empty_like(ts[1]), torch.empty_like(ts[2])
    _bwd_launch("flash_bwd_dkv", *ts, [dk, dv], causal, sm_scale, q_offset, window)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, sm_scale=None,
                        q_offset=None, window=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` from its saved output
    ``o`` and fp32 ``lse``: ``delta = rowsum(o·do)`` in fp32 (a torch op,
    as in the JAX VJP), then K2 and K3 (CPU tensors: their plain
    versions)."""
    delta = (o.float() * do.float()).sum(-1)
    args = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset, window=window)
    return (flash_bwd_dq(q, k, v, do, lse, delta, **args),
            *flash_bwd_dkv(q, k, v, do, lse, delta, **args))


class _FlashAttention(torch.autograd.Function):
    """K1 forward saving ``(q, k, v, o, lse)``; K2/K3 backward (the JAX
    custom VJP ``_flash``). ``lse`` is returned but not differentiable,
    as in JAX, where only ``o`` leaves the VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, window):
        o, lse = _flash_fwd(q, k, v, causal, sm_scale, q_offset, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset, window=window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # The cotangent often arrives as a transposed view (the out
        # projection's transpose); the kernels take contiguous rows.
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    q_offset: int | None = None,
    window: int | None = None,
    return_lse: bool = False,
):
    """Flash attention over ``(batch, heads, seq, head_dim)``.

    ``window`` (causal only): query p attends keys ``[p - window + 1, p]``.
    Cross-length causal calls place the query chunk at ``q_offset``
    (default: the last ``seq_q`` key positions). k and v carry q's head
    count (broadcast GQA heads with :func:`repeat_kv` first; autograd
    sums the repeated heads' gradients back). A query row that sees no
    key returns 0. With ``return_lse`` also returns the fp32 ``(b, h,
    seq_q)`` logsumexp (not differentiable).

    CUDA tensors run ``csrc/flash_fwd.cu`` (bf16 or fp32, head_dim 64 or
    128) and, when autograd needs a gradient, ``csrc/flash_bwd_dq.cu``
    and ``csrc/flash_bwd_dkv.cu`` in backward; CPU tensors run the plain
    versions of all three.
    """
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} — k/v need q's heads (use repeat_kv)"
        )
    sm_scale, q_offset = _attention_args(q, k, causal, sm_scale, q_offset, window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, causal, sm_scale, q_offset, window)
    else:
        o, lse = _flash_fwd(q, k, v, causal, sm_scale, q_offset, window)
    return (o, lse) if return_lse else o


def _check_operands(name: str, device, dtype, *tensors: torch.Tensor) -> None:
    """Caches, scales and page tables the kernels read in place: on
    ``device``, of ``dtype``, contiguous and 16-byte aligned."""
    for t in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: caches, scales and page tables must be contiguous "
                             "and 16-byte aligned")


def _check_scales(k_scale, v_scale) -> bool:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    return k_scale is not None


def _split_workspace(rows: int, capacity: int, bhkv: int, d: int, device):
    """``(n_splits, split_keys, workspace or None)`` of a decode call:
    :func:`decode_splits`, and for several splits an fp32 workspace for
    the split body's partials (m, l and acc per split, row and kv head).
    Calls wider than ``SPLIT_ROWS`` get ``(1, capacity, None)``."""
    n_splits, split_keys = decode_splits(rows, capacity, bhkv)
    if n_splits == 1:
        return n_splits, split_keys, None
    work = torch.empty(n_splits * bhkv * rows * (d + 2), dtype=torch.float32, device=device)
    return n_splits, split_keys, work


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Attention for KV-cached decoding: ``q`` ``(b, h, s, d)`` against
    ``(b, hkv, capacity, d)`` caches of which the first ``valid_len``
    positions are written (the cache index AFTER the current chunk was
    stored; query row i sits at position ``valid_len - s + i``).
    ``valid_len`` is a scalar or a ``(b,)`` vector (ragged decode); a
    ``valid_len == 0`` row outputs zeros. The ``h / hkv`` query heads of
    a kv head fold into one row block, so the cache is read once per kv
    head, and only up to ``valid_len``.

    With ``k_scale``/``v_scale`` (both or neither; fp32 ``(b, hkv,
    capacity)`` from :func:`quantize_kv`) the caches are int8.

    CUDA tensors run ``csrc/decode_attention.cu`` (K4) or, int8,
    ``csrc/decode_attention_q8.cu`` (K5) (bf16 or fp32 queries, head_dim
    64 or 128): a call of at most ``SPLIT_ROWS`` rows (``g * s``, every
    decode step) runs the split-K body, ``decode_splits`` splits of the
    capacity merged by a combine kernel; a wider bf16 call (a prefix
    hit's suffix appended to a warm cache; K5: the int8 engine's
    admission prefill) runs K1's tensor-core forward body over the bf16
    or int8 K/V (one block per 128 rows of a query head, reading kv head
    ``head // (h // hkv)``), counted as ``decode_attention_chunk`` or
    ``decode_attention_q8_chunk``; a wider fp32 call runs the 64-row
    body. CPU tensors run :func:`decode_attention_reference` (int8: on
    the dequantized caches in fp32, cast to q's dtype), with a row that
    sees no key at 0 as the kernels write it.
    """
    quantized = _check_scales(k_scale, v_scale)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, h, s, d = q.shape
    hkv, cap = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads not divisible by {hkv} kv heads")
    if k.shape != (b, hkv, cap, d) or v.shape != k.shape:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if quantized and (k_scale.shape != (b, hkv, cap) or v_scale.shape != k_scale.shape):
        raise ValueError(f"decode_attention: scales must be {(b, hkv, cap)}, got "
                         f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    vl = _normalize_valid_len(valid_len, b, q.device)
    if _device_of("decode_attention", q) == "cpu":
        if quantized:
            o = decode_attention_q8_reference(q, k, v, k_scale, v_scale, vl, sm_scale, window)
        else:
            o = decode_attention_reference(q, k, v, vl, sm_scale, window)
        return torch.where(_sees_a_key(vl, s, cap, window)[:, None, :, None], o, 0.0)
    q = q.contiguous()
    o = torch.empty_like(q)
    rows = (h // hkv) * s
    n_splits, split_keys, work = _split_workspace(rows, cap, b * hkv, d, q.device)
    common = (None if work is None else work.data_ptr(), b, hkv, rows, s, cap, d,
              int(q.dtype == torch.bfloat16), float(sm_scale), int(window or 0), n_splits,
              split_keys, _stream(q.device))
    if quantized:
        name = "decode_attention_q8"
        _check_kernel_inputs(name, q, o)
        _check_operands(name, q.device, torch.int8, k, v)
        _check_operands(name, q.device, torch.float32, k_scale, v_scale)
        rc = _build.kernel(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), vl.data_ptr(), o.data_ptr(), *common,
        )
    else:
        name = "decode_attention"
        if not (k.is_contiguous() and v.is_contiguous()):
            raise ValueError("decode_attention: k/v caches must be contiguous")
        _check_kernel_inputs(name, q, k, v)
        rc = _build.kernel(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(), o.data_ptr(), *common,
        )
    _build.check(name, rc)
    # A wide bf16 call ran the tensor-core forward body: counted on its own.
    if rows > SPLIT_ROWS and q.dtype == torch.bfloat16:
        name += "_chunk"
    LAUNCHES[name] += 1
    return o


def decode_attention_q8(q, k, v, k_scale, v_scale, valid_len, **kwargs) -> torch.Tensor:
    """:func:`decode_attention` over an int8 cache: ``k``/``v`` int8
    ``(b, hkv, capacity, d)`` with fp32 scales ``(b, hkv, capacity)``
    from :func:`quantize_kv`."""
    return decode_attention(q, k, v, valid_len, k_scale=k_scale, v_scale=v_scale, **kwargs)


def paged_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    pages: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """:func:`decode_attention` over a paged KV cache.

    ``k``/``v`` are block pools ``(hkv, nblocks, page, d)`` shared by
    every batch row, and ``pages`` is the ``(b, max_blocks)`` int32 page
    table: logical block ``j`` of row ``r`` (positions ``j*page ..
    (j+1)*page - 1``) is pool block ``pages[r, j]``. ``valid_len`` is as
    in :func:`decode_attention`. Table entries past a row's valid length
    are conventionally 0, the scratch block; the kernels never read a
    key at or past ``valid_len``, so its contents are unreachable. An
    entry outside ``[0, nblocks)`` below a row's valid length is a caller
    bug: the plain version raises on it, and the kernel reads nothing
    through it and leaves its keys out of the softmax. With
    ``k_scale``/``v_scale`` (both or neither; fp32 ``(hkv, nblocks,
    page)``) the pools are int8 and each scale is read through the same
    table entry as its values.

    CUDA tensors run ``csrc/paged_decode_attention.cu`` (K6) or, for
    int8 pools, ``csrc/paged_decode_attention_q8.cu`` (K7), for every
    page size: a call of at most ``SPLIT_ROWS``
    rows (``g * s``, every decode step) on the split-K body,
    ``decode_splits`` splits of the capacity merged by a combine kernel;
    a wider call (a prefill chunk) on the tensor-core body in bf16
    (counted as ``paged_decode_attention_chunk`` or
    ``paged_decode_attention_q8_chunk``) and on the 64-row body in fp32.
    CPU tensors run :func:`paged_decode_attention_reference`.
    """
    quantized = _check_scales(k_scale, v_scale)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, h, s, d = q.shape
    hkv, nblocks, page, dk = k.shape
    if dk != d:
        raise ValueError(f"pool head_dim {dk} != query head_dim {d}")
    if h % hkv:
        raise ValueError(f"{h} query heads not divisible by {hkv} kv heads")
    if v.shape != k.shape:
        raise ValueError(f"pools differ: k {tuple(k.shape)}, v {tuple(v.shape)}")
    if quantized:
        for sname, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (hkv, nblocks, page):
                raise ValueError(
                    f"scale pool {sname} shape {tuple(sc.shape)} != {(hkv, nblocks, page)}")
    if pages.ndim != 2 or pages.shape[0] != b:
        raise ValueError(f"page table rows {pages.shape[0]} != batch {b}")
    max_blocks = pages.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    vl = _normalize_valid_len(valid_len, b, q.device)
    if _device_of("paged_decode_attention", q) == "cpu":
        return paged_decode_attention_reference(
            q, k, v, vl, pages, sm_scale, window, k_scale=k_scale, v_scale=v_scale,
        ).to(q.dtype)
    name = "paged_decode_attention_q8" if quantized else "paged_decode_attention"
    q = q.contiguous()
    pages = pages.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty_like(q)
    _check_kernel_inputs(name, q, o)
    _check_operands(name, q.device, torch.int8 if quantized else q.dtype, k, v)
    _check_operands(name, q.device, torch.int32, pages)
    rows = (h // hkv) * s
    n_splits, split_keys, work = _split_workspace(rows, max_blocks * page, b * hkv, d, q.device)
    tail = (None if work is None else work.data_ptr(), b, hkv, rows, s, page, max_blocks,
            nblocks, d, int(q.dtype == torch.bfloat16), float(sm_scale), int(window or 0),
            n_splits, split_keys, _stream(q.device))
    if quantized:
        _check_operands(name, q.device, torch.float32, k_scale, v_scale)
        rc = _build.kernel(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            vl.data_ptr(), pages.data_ptr(), o.data_ptr(), *tail,
        )
    else:
        rc = _build.kernel(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(), pages.data_ptr(),
            o.data_ptr(), *tail,
        )
    _build.check(name, rc)
    # A wide bf16 call ran the tensor-core chunk body: counted on its own.
    chunk = rows > SPLIT_ROWS and q.dtype == torch.bfloat16
    LAUNCHES[name + "_chunk" if chunk else name] += 1
    return o
