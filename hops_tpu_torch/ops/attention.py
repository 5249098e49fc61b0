"""Attention for the port (counterpart of ``hops_tpu/ops/attention.py``).

Layout ``(batch, heads, seq, head_dim)``, as in the JAX package.

Two entry points run hand-written CUDA kernels for Hopper on CUDA
tensors and their plain PyTorch versions on CPU tensors:

- :func:`flash_attention` -> ``csrc/flash_fwd.cu`` (K1, ``_fwd_kernel``),
  forward only;
- :func:`decode_attention` -> ``csrc/decode_attention.cu`` (K4,
  ``_decode_kernel``), the dense, unquantized cache.

On a CUDA tensor the entry point launches its kernel or raises; it never
falls back. The kernels mask ragged tails themselves, so every sequence
length and cache capacity runs on them (no block table, no reference
routing below a length). Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import math

import torch

from hops_tpu_torch.ops import _build

NEG_INF = float("-inf")

#: Launches of each kernel since the last :func:`reset_launch_counts`.
LAUNCHES: dict[str, int] = {"flash_fwd": 0, "decode_attention": 0}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (64, 128)


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
    """Flash attention forward over ``(batch, heads, seq, head_dim)``.

    ``window`` (causal only): query p attends keys ``[p - window + 1, p]``.
    Cross-length causal calls place the query chunk at ``q_offset``
    (default: the last ``seq_q`` key positions). k and v carry q's head
    count (broadcast GQA heads with :func:`repeat_kv` first). With
    ``return_lse`` also returns the fp32 ``(b, h, seq_q)`` logsumexp.

    CUDA tensors run ``csrc/flash_fwd.cu`` (bf16 or fp32, head_dim 64 or
    128); CPU tensors run :func:`attention_reference`. Forward only: this
    raises when autograd would need a gradient.
    """
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention is forward-only in this port; run under "
            "torch.inference_mode() or torch.no_grad()"
        )
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} — k/v need q's heads (use repeat_kv)"
        )
    sm_scale, q_offset = _attention_args(q, k, causal, sm_scale, q_offset, window)
    if q.device.type == "cpu":
        o = attention_reference(q, k, v, causal, sm_scale, q_offset, window)
        if return_lse:
            return o, attention_lse_reference(q, k, causal, sm_scale, q_offset, window)
        return o
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_kernel_inputs("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.kernel("flash_fwd")
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, sq, sk, d, int(q.dtype == torch.bfloat16), float(sm_scale),
        int(causal), int(q_offset), int(window or 0), _stream(q.device),
    )
    _build.check("flash_fwd", rc)
    LAUNCHES["flash_fwd"] += 1
    return (o, lse) if return_lse else o


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len,
    *,
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

    CUDA tensors run ``csrc/decode_attention.cu`` (bf16 or fp32,
    head_dim 64 or 128); CPU tensors run
    :func:`decode_attention_reference`.
    """
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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    vl = _normalize_valid_len(valid_len, b, q.device)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, vl, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: k/v caches must be contiguous")
    q = q.contiguous()
    _check_kernel_inputs("decode_attention", q, k, v)
    o = torch.empty_like(q)
    fn = _build.kernel("decode_attention")
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(), o.data_ptr(),
        b, hkv, (h // hkv) * s, s, cap, d, int(q.dtype == torch.bfloat16),
        float(sm_scale), int(window or 0), _stream(q.device),
    )
    _build.check("decode_attention", rc)
    LAUNCHES["decode_attention"] += 1
    return o
