"""Decoder-only transformer LM (counterpart of ``hops_tpu/models/transformer.py``).

Modules keep the flax parameter names and shapes as attributes — for
example ``block_3.attn.qkv.kernel`` of shape ``(d_model, 3, heads,
head_dim)`` — so a JAX parameter tree loads with no reshape
(:mod:`hops_tpu_torch.models.convert`). Parameters are stored in
``param_dtype`` (default: the compute ``dtype``, the serving layout;
training keeps fp32 masters, as flax stores them) and each op casts to
the compute ``dtype`` exactly where flax does: ``Dense`` casts its input
and its kernel, ``Embed`` its table; RMSNorm statistics and scale stay
fp32; logits are fp32.

The KV cache is explicit: :meth:`TransformerLM.init_cache` returns a
:class:`KVCache` (dense, bf16/fp32 or int8 with fp32 scales) or, with
``paged_decode``, a :class:`PagedKVCache` (per-layer block pools and one
page table), and a decode call writes into it in place. Attention runs
through :mod:`hops_tpu_torch.ops.attention`: ``flash_attention`` (full
forward, and the prefill of a fresh bf16/fp32 cache), ``decode_attention``
(every other dense call; int8 caches on its q8 kernel) and
``paged_decode_attention`` (every paged call) — the port's Hopper
kernels on CUDA tensors.

The full forward also trains: :func:`make_lm_train_step` runs the
JAX package's next-token step (dense or chunked loss, dropout, per-block
remat, MoE load-balancing losses) with
the flash kernels' backward. ``moe_every`` makes every k-th block a
:class:`~hops_tpu_torch.models.moe.MoEBlock`; ``attention_impl="ring"``,
``"ulysses"`` and ``"ring_local"`` run sequence parallelism over a
``mesh``'s ``seq_axis`` (:mod:`hops_tpu_torch.parallel.ringattention`):
with ``ring`` and ``ulysses`` every block runs on this rank's block of
the activations, which join before the final norm. ``tp_axis`` and
``tp_shards`` split every block the Megatron way over a tensor-parallel
axis: each rank holds ``1/tp_shards`` of the heads (and of the MLP's
hidden columns) and one sum per projection combines the partial
outputs (:mod:`hops_tpu_torch.parallel.tp_inference`).

While a ``torch.profiler`` records, the forward opens the ranges
``transformer.forward``, ``transformer.attention`` and ``transformer.mlp``
(the two halves of each block) and ``transformer.logits``, and the train
step ``train_step.forward``, ``.loss``, ``.backward`` and ``.optimizer``
(:func:`~hops_tpu_torch.telemetry.spans.annotate`: one flag test each
with none recording).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hops_tpu_torch.models.common import TrainState, cross_entropy_loss, step_seed
from hops_tpu_torch.models.convert import params_from_flax
from hops_tpu_torch.ops.attention import (
    attention_reference,
    cache_head_dim,
    decode_attention,
    decode_attention_q8,
    flash_attention,
    paged_decode_attention,
    quantize_kv,
    repeat_kv,
)
from hops_tpu_torch.ops.xent import chunked_softmax_xent
from hops_tpu_torch.runtime.devices import resolve_device
from hops_tpu_torch.telemetry.spans import annotate

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def as_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r} (bfloat16 or float32)")
    return _DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    return {v: k for k, v in _DTYPES.items()}[dtype]


def rotary_embedding(
    x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0
) -> torch.Tensor:
    """Apply RoPE over ``(batch, heads, seq, head_dim)``.

    Rotates INTERLEAVED pairs ``(0::2, 1::2)`` and re-interleaves them, as
    the JAX package does. ``positions`` is ``(seq,)`` — or
    ``(batch, seq)`` for the ragged decode path, where each batch row's
    chunk sits at its own absolute position."""
    d = x.shape[-1]
    inv_freq = 1.0 / (
        base ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    )
    angles = positions[..., None].to(torch.float32) * inv_freq  # (..., d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if positions.ndim == 2:  # (b, s, d/2) -> broadcast over heads
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    # Filled by load_flax (a JAX tree or convert.random_params).
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Dense(nn.Module):
    """Bias-free projection holding flax's ``kernel`` of shape
    ``(in, *features)`` in ``param_dtype``; input and kernel are cast to
    the compute ``dtype`` for the product, as flax's ``Dense`` does."""

    def __init__(self, in_features: int, features: tuple[int, ...], dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((in_features, *features), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype)
        out = x.to(self.dtype) @ w.reshape(w.shape[0], -1)
        return out.reshape(*x.shape[:-1], *w.shape[1:])


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((vocab, dim), param_dtype, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # Gather, then cast: the same values as casting the table first.
        return nn.functional.embedding(tokens, self.embedding).to(self.dtype)


class RMSNorm(nn.Module):
    """fp32 statistics, fp32 scale, result cast to ``dtype``."""

    def __init__(self, dim: int, dtype, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = _param((dim,), torch.float32, device)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


@dataclasses.dataclass
class KVCache:
    """Dense per-layer KV cache: ``k[i]``/``v[i]`` are
    ``(batch, kv_heads, max_decode_len, head_dim)`` (on the card a head
    narrower than the kernels' is stored zero-padded to
    :func:`~hops_tpu_torch.ops.attention.cache_head_dim`); ``idx`` is the cache
    index — ``(batch,)`` int32 on a ``ragged_decode`` model (every row
    advances on its own), a 0-d int32 otherwise. All layers advance in
    lockstep, so one index serves them all. Decode calls update the
    tensors in place. An int8 cache (``kv_cache_dtype="int8"``) holds
    int8 ``k``/``v`` and fp32 ``k_scale[i]``/``v_scale[i]`` of shape
    ``(batch, kv_heads, max_decode_len)``, one scale per written
    position (:func:`~hops_tpu_torch.ops.attention.quantize_kv`)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    idx: torch.Tensor
    k_scale: list[torch.Tensor] | None = None
    v_scale: list[torch.Tensor] | None = None

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]

    def tensors(self) -> list[torch.Tensor]:
        """Every per-layer tensor: k, v and, int8, their scales."""
        return [*self.k, *self.v, *(self.k_scale or ()), *(self.v_scale or ())]

    def _map(self, fn, idx: torch.Tensor) -> "KVCache":
        def each(ts):
            return None if ts is None else [fn(t) for t in ts]

        return KVCache(each(self.k), each(self.v), idx, each(self.k_scale), each(self.v_scale))

    def rows_view(self, start: int, stop: int) -> "KVCache":
        """Rows ``[start, stop)`` as a cache over this one's storage: a
        model call on it writes these rows in place (and assigns the
        view's own ``idx``)."""
        return self._map(lambda t: t[start:stop], self.idx[start:stop])

    def copy_prefix(self, row: int, length: int) -> "KVCache":
        """A one-row copy of ``row``'s first ``length`` positions (values
        and int8 scales): a stored prefix for :meth:`load_prefix`."""
        idx = torch.full((1,), length, dtype=self.idx.dtype, device=self.idx.device)
        return self._map(lambda t: t[row: row + 1, :, :length].clone(), idx)

    def load_prefix(self, row: int, prefix: "KVCache") -> None:
        """Copy a stored prefix into ``row`` and set its index to the
        prefix's length; the positions past it keep what they held."""
        length = prefix.k[0].shape[2]
        for dst, src in zip(self.tensors(), prefix.tensors()):
            dst[row, :, :length] = src[0]
        self.idx[row] = length

    def reorder_rows(self, rows: torch.Tensor, length: int) -> None:
        """Row i takes the contents of row ``rows[i]`` (beam search's
        back-pointers): one ``index_select`` per tensor over the first
        ``length`` positions, the only ones written."""
        for t in self.tensors():
            part = t[:, :, :length]
            part.copy_(part.index_select(0, rows))
        if self.idx.ndim:
            self.idx = self.idx.index_select(0, rows)


@dataclasses.dataclass
class PagedKVCache:
    """Paged per-layer KV cache (``paged_decode``): ``k[i]``/``v[i]`` are
    block pools ``(kv_heads, kv_pool_blocks, page, head_dim)`` shared by
    every batch row; ``pages`` is the ``(batch, max_blocks)`` int32 page
    table, shared by all layers as ``idx`` is: position ``p`` of row ``r``
    lives in pool block ``pages[r, p // page]`` at offset ``p % page``.
    Block 0 is the scratch block: entries of 0 catch free rows and pad
    writes, and the kernels never read it below a row's valid length.
    The owner (the serving engine) fills ``pages``; int8 pools carry fp32
    scale pools ``(kv_heads, kv_pool_blocks, page)``."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    pages: torch.Tensor
    idx: torch.Tensor
    max_len: int  # the model's max_decode_len: positions clamp below it
    k_scale: list[torch.Tensor] | None = None
    v_scale: list[torch.Tensor] | None = None

    @property
    def capacity(self) -> int:
        return self.max_len

    @property
    def page_size(self) -> int:
        return self.k[0].shape[2]

    def tensors(self) -> list[torch.Tensor]:
        """Every per-layer pool: k, v and, int8, their scales."""
        return [*self.k, *self.v, *(self.k_scale or ()), *(self.v_scale or ())]


_SEQ_IMPLS = ("ring", "ulysses", "ring_local")


class Attention(nn.Module):
    """``attention_impl``: ``flash`` (the kernels), ``reference`` (plain
    attention), or sequence parallelism over ``mesh``'s ``seq_axis``
    (batch rows split over ``batch_axis``). Each takes this rank's chunk
    of the sequence (its positions offset by the rank's index on the seq
    axis): ``ring_local`` as the caller feeds it, ``ring`` and
    ``ulysses`` as :class:`TransformerLM` cuts it (``shard``, a
    :class:`~hops_tpu_torch.parallel.ringattention.SeqShard`).

    ``tp_axis``/``tp_shards``: Megatron tensor parallelism. The module
    holds ``num_heads // tp_shards`` heads (and as many kv heads of
    ``num_kv_heads``), attends them, and the out projection's partial
    sums are summed over the axis (``tp_axis`` names an axis of
    ``mesh``, a bound axis name, or is a ``grad_comms.Axis``)."""

    def __init__(
        self, d_model: int, num_heads: int, *, dtype, param_dtype, device,
        attention_impl: str = "flash", num_kv_heads: int | None = None,
        window: int | None = None, mesh: Any = None, seq_axis: str = "seq",
        batch_axis: str | None = None, tp_axis: Any = None, tp_shards: int = 1,
    ):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        if num_heads % tp_shards:
            raise ValueError(f"{num_heads} heads not divisible by tp_shards={tp_shards}")
        self.num_heads = num_heads // tp_shards
        self.head_dim = d_model // num_heads
        self.attention_impl = attention_impl
        self.window = window
        self.mesh, self.seq_axis, self.batch_axis = mesh, seq_axis, batch_axis
        self.tp_axis, self.tp_shards = tp_axis, tp_shards
        self.fused = num_kv_heads is None
        heads = self.num_heads
        dt = (dtype, param_dtype, device)
        if self.fused:
            self.kv_heads = heads
            self.qkv = Dense(d_model, (3, heads, self.head_dim), *dt)
        else:
            if num_heads % num_kv_heads:
                raise ValueError(
                    f"{num_heads} heads not divisible by num_kv_heads={num_kv_heads}"
                )
            if num_kv_heads % tp_shards:
                raise ValueError(
                    f"{num_kv_heads} kv heads not divisible by tp_shards={tp_shards}")
            self.kv_heads = num_kv_heads // tp_shards
            self.q = Dense(d_model, (heads, self.head_dim), *dt)
            self.kv = Dense(d_model, (2, self.kv_heads, self.head_dim), *dt)
        self.out = Dense(heads * self.head_dim, (d_model,), *dt)

    def _project_in(self, x):
        if self.tp_axis is not None:
            x = _tp_enter(x, self.mesh, self.tp_axis, self.tp_shards)
        if self.fused:
            qkv = self.qkv(x)  # (b, s, 3, h, d)
            return [qkv[:, :, i].transpose(1, 2) for i in range(3)]  # (b, h, s, d)
        q = self.q(x).transpose(1, 2)
        kv = self.kv(x)
        return [q] + [kv[:, :, i].transpose(1, 2) for i in range(2)]

    def _project_out(self, o):
        b, _, s, _ = o.shape
        o = self.out(o.transpose(1, 2).reshape(b, s, -1))
        if self.tp_axis is not None:
            o = _tp_sum(o, self.mesh, self.tp_axis, self.tp_shards)
        return o

    def forward(self, x, cache: KVCache | None = None, layer: int = 0,
                offset: torch.Tensor | None = None, fresh: bool = False,
                rows: torch.Tensor | None = None, shard: Any = None):
        q, k, v = self._project_in(x)
        if cache is not None:
            return self._decode_attend(q, k, v, cache, layer, offset, fresh, rows)
        pos = torch.arange(x.shape[1], device=x.device)
        impl = self.attention_impl
        if impl in _SEQ_IMPLS:
            from hops_tpu_torch.parallel import ringattention

            if impl != "ring_local" and shard is None:
                raise ValueError(f"attention_impl={impl!r} runs on this rank's block of the "
                                 "activations: call it through TransformerLM")
            seq = ringattention.axis_group(self.mesh, self.seq_axis)
            pos = pos + seq.index * x.shape[1]  # x is this rank's chunk of the sequence
        q, k = rotary_embedding(q, pos), rotary_embedding(k, pos)
        if impl == "flash":
            o = flash_attention(q, *repeat_kv(q, k, v), causal=True, window=self.window)
        elif impl == "reference":
            o = attention_reference(q, *repeat_kv(q, k, v), causal=True, window=self.window)
        elif impl in ("ring", "ring_local"):
            # The un-repeated kv heads rotate (ring) or ride the
            # all-to-alls (Ulysses): Hkv/H of the MHA bytes.
            o = ringattention.ring_attention_local(q, k, v, axis=seq, causal=True,
                                                   window=self.window)
        elif impl == "ulysses":
            o = ringattention.ulysses_attention_local(q, k, v, axis=seq, causal=True,
                                                      window=self.window)
        else:
            raise ValueError(f"unknown attention_impl {impl!r}")
        return self._project_out(o)

    def _decode_attend(self, q, k, v, cache, layer, offset, fresh, rows):
        """Attention against the layer's slice of ``cache``.

        ``offset`` is the cache index before this chunk (shared by all
        layers; :class:`TransformerLM` advances ``cache.idx`` once after
        the last layer). The chunk lands at each row's offset (clamped so
        it fits, as ``dynamic_update_slice`` clamps). A multi-token chunk
        on a ``fresh`` bf16/fp32 cache (nothing earlier to attend to) is
        plain causal self-attention over the chunk and runs through the
        flash kernel; every other call streams the cache through the
        decode kernel. An int8 cache quantizes k/v as it writes them and
        reads them back quantized on every call, prefill included, as the
        JAX package does (so the dense and paged int8 layouts attend the
        same bytes); a fresh int8 chunk is read as a cache of its own,
        valid to its length, which holds exactly what its rows of the
        cache hold. ``rows`` (fresh only) maps batch row i to cache row
        ``rows[i]``: the engine prefills admitted slots in place.
        """
        b, _, s, _ = q.shape
        steps = torch.arange(s, device=q.device)
        pos = offset[:, None] + steps[None, :] if offset.ndim == 1 else offset + steps
        q = rotary_embedding(q, pos)
        k = rotary_embedding(k, pos)
        if isinstance(cache, PagedKVCache):
            return self._project_out(self._paged_attend(q, k, v, cache, layer, pos, offset + s))
        d = q.shape[-1]
        ck, cv = cache.k[layer], cache.v[layer]
        cap = ck.shape[2]
        start = torch.clamp(offset, 0, cap - s)
        wpos = start[:, None] + steps[None, :] if start.ndim == 1 else (start + steps)[None, :]
        row_idx = torch.arange(b, device=q.device) if rows is None else rows
        if cache.k_scale is not None:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            # (b, cap, h, d) and (b, cap, h) views: one index_put_ per
            # tensor writes every row's chunk at its own offset.
            for dst, val in ((ck[..., :d], kq), (cv[..., :d], vq), (cache.k_scale[layer], ks),
                             (cache.v_scale[layer], vs)):
                dst.transpose(1, 2)[row_idx[:, None], wpos] = val.transpose(1, 2)
            if fresh:
                kv = [t.contiguous() for t in (kq, vq, ks, vs)]
            else:
                kv = [ck, cv, cache.k_scale[layer], cache.v_scale[layer]]
            return self._project_out(decode_attention_q8(q, *kv, offset + s, window=self.window))
        ck[..., :d].transpose(1, 2)[row_idx[:, None], wpos] = k.transpose(1, 2).to(ck.dtype)
        cv[..., :d].transpose(1, 2)[row_idx[:, None], wpos] = v.transpose(1, 2).to(cv.dtype)
        if s > 1 and fresh:
            kk, vv = repeat_kv(q, k.to(ck.dtype), v.to(cv.dtype))
            o = flash_attention(q, kk, vv, causal=True, window=self.window)
        else:
            if rows is not None:
                raise ValueError("rows= is only for fresh prefill")
            o = decode_attention(q, ck, cv, offset + s, window=self.window)
        return self._project_out(o)

    def _paged_attend(self, q, k, v, cache, layer, pos, valid_len):
        """The paged path (JAX ``_paged_decode_attend``): position ``p`` of
        row ``r`` is written to pool block ``pages[r, p // page]`` at
        offset ``p % page``, with ``p`` clamped below ``max_decode_len``;
        a pad position past a row's allocation meets a table entry of 0
        and lands in the scratch block. There is no fresh-cache shortcut:
        a prefill is a chunk appended at the row's own offset, so the
        engine can run prefill chunks and decode steps in one call."""
        page = cache.page_size
        posc = torch.clamp_max(pos, cache.max_len - 1)
        blk = torch.gather(cache.pages, 1, (posc // page).to(torch.long)).to(torch.long)
        off = (posc % page).to(torch.long)
        ck, cv = cache.k[layer], cache.v[layer]
        scales = {}
        if cache.k_scale is not None:
            ks_pool, vs_pool = cache.k_scale[layer], cache.v_scale[layer]
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            # pool[:, blk, off] is (hkv, b, s, ...): head-major updates.
            ks_pool[:, blk, off] = ks.transpose(0, 1)
            vs_pool[:, blk, off] = vs.transpose(0, 1)
            scales = dict(k_scale=ks_pool, v_scale=vs_pool)
        d = q.shape[-1]
        ck[..., :d][:, blk, off] = k.transpose(0, 1).to(ck.dtype)
        cv[..., :d][:, blk, off] = v.transpose(0, 1).to(cv.dtype)
        return paged_decode_attention(q, ck, cv, valid_len, cache.pages, window=self.window,
                                      **scales)


class MLP(nn.Module):
    """SwiGLU: gate/up projections and a gated down projection. With
    ``tp_axis``/``tp_shards`` the module holds ``hidden // tp_shards``
    columns of gate/up and rows of down, and the partial down
    projections are summed over the axis (as :class:`Attention`)."""

    def __init__(self, d_model: int, *, dtype, param_dtype, device, hidden_mult: int = 4,
                 mesh: Any = None, tp_axis: Any = None, tp_shards: int = 1):
        super().__init__()
        hidden = int(d_model * hidden_mult * 2 / 3)
        hidden = max(128, (hidden // 128) * 128)
        if hidden % tp_shards:
            raise ValueError(f"hidden {hidden} not divisible by tp_shards={tp_shards}")
        hidden //= tp_shards
        self.mesh, self.tp_axis, self.tp_shards = mesh, tp_axis, tp_shards
        dt = (dtype, param_dtype, device)
        self.gate = Dense(d_model, (hidden,), *dt)
        self.up = Dense(d_model, (hidden,), *dt)
        self.down = Dense(hidden, (d_model,), *dt)

    def forward(self, x):
        if self.tp_axis is not None:
            x = _tp_enter(x, self.mesh, self.tp_axis, self.tp_shards)
        out = self.down(nn.functional.silu(self.gate(x)) * self.up(x))
        if self.tp_axis is not None:
            out = _tp_sum(out, self.mesh, self.tp_axis, self.tp_shards)
        return out


def _tp_enter(x, mesh, tp_axis, shards):
    """Megatron's "f": ``x`` unchanged, its gradient summed over the
    tensor-parallel axis in backward."""
    from hops_tpu_torch.parallel import tp_inference

    return tp_inference.tp_enter(x, tp_inference.tp_group(mesh, tp_axis, shards))


def _tp_sum(x, mesh, tp_axis, shards):
    """Megatron's "g": the rank-order sum of every rank's partial ``x``;
    the (replicated) gradient passes through unchanged."""
    from hops_tpu_torch.parallel import tp_inference

    return tp_inference.tp_sum(x, tp_inference.tp_group(mesh, tp_axis, shards))


def dropout(x: torch.Tensor, rate: float, seed: int, shard: Any = None) -> torch.Tensor:
    """flax's ``Dropout``: keep each entry with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``. The mask is a function
    of ``seed`` alone (a fresh generator on ``x``'s device), so a
    recomputed forward (remat) draws the same mask. With ``shard``, ``x``
    is this rank's block and takes its block of the global mask."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    shape = x.shape if shard is None else shard.full_shape(tuple(x.shape))
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - rate
    if shard is not None:
        keep = shard.block_of(keep)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Block(nn.Module):
    """Attention and a SwiGLU ``mlp``, or with ``moe`` (the
    :class:`~hops_tpu_torch.models.moe.MoEMLP` arguments) routed experts
    named ``moe`` (:class:`~hops_tpu_torch.models.moe.MoEBlock`)."""

    def __init__(self, d_model: int, num_heads: int, *, dtype, param_dtype, device,
                 dropout_rate: float = 0.0, moe: dict | None = None, **attn_kw):
        super().__init__()
        self.dropout_rate = dropout_rate
        dt = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.RMSNorm_0 = RMSNorm(d_model, dtype, device)
        self.attn = Attention(d_model, num_heads, **dt, **attn_kw)
        self.RMSNorm_1 = RMSNorm(d_model, dtype, device)
        if moe is None:
            self.mlp = MLP(d_model, **dt, mesh=attn_kw.get("mesh"),
                           tp_axis=attn_kw.get("tp_axis"), tp_shards=attn_kw.get("tp_shards", 1))
        else:
            from hops_tpu_torch.models.moe import MoEMLP

            self.moe = MoEMLP(d_model, **dt, **moe)

    def forward(self, x, cache=None, layer=0, offset=None, fresh=False, rows=None,
                seed: int | None = None, shard: Any = None):
        """``seed`` (training with dropout only): the attention and MLP
        outputs are dropped with masks drawn from ``seed`` and
        ``seed + 1``. ``shard``: ``x`` is this rank's block of the
        activations (:class:`TransformerLM`'s sequence parallelism)."""
        with annotate("transformer.attention"):
            h = self.attn(self.RMSNorm_0(x), cache, layer, offset, fresh, rows, shard)
            if seed is not None:
                h = dropout(h, self.dropout_rate, seed, shard)
            x = x + h
        with annotate("transformer.mlp"):
            h = self.ffn(self.RMSNorm_1(x), shard)
            if seed is not None:
                h = dropout(h, self.dropout_rate, seed + 1, shard)
            return x + h

    def ffn(self, x: torch.Tensor, shard: Any = None) -> torch.Tensor:
        if not hasattr(self, "moe"):
            return self.mlp(x)
        if shard is None:
            return self.moe(x)
        # Routing couples every token of a call (capacity, buffer slots in
        # token order): the experts see the global batch, as in JAX.
        return shard.cut(self.moe(shard.join(x)))


class TransformerLM(nn.Module):
    """GPT-style causal LM over token ids ``(batch, seq)`` -> fp32 logits.

    Constructor arguments are the flax module's fields (the artifact's
    ``lm_config.json``), plus ``param_dtype`` (flax's name: the storage
    type of the weights; ``None`` stores them in ``dtype``, as the
    serving path does) and ``device`` (``None`` = the card), and the
    JAX module's ``mesh`` (a port :class:`~hops_tpu_torch.parallel.mesh.Mesh`),
    ``seq_axis`` and ``batch_axis`` for the sequence-parallel impls.
    ``tp_axis``/``tp_shards`` hold this rank's Megatron shard of every
    block (dense models only, as in JAX): build one from a dense model
    with :func:`~hops_tpu_torch.parallel.tp_inference.tp_shard_model`.
    Like ``mesh``, they are not part of ``config`` (the artifact's
    ``lm_config.json``); :meth:`clone` keeps them.
    ``attention_impl="reference"`` runs the full forward on the plain
    attention version; the cached path always runs the kernels.
    ``moe_every=k`` makes blocks k-1, 2k-1, ... MoE blocks of
    ``num_experts`` experts, ``moe_top_k`` per token (not with
    ``paged_decode``: MoE models keep the dense ragged cache).
    ``kv_cache_dtype="int8"`` quantizes the KV cache; ``paged_decode``
    (with ``ragged_decode``, ``kv_page_size`` and ``kv_pool_blocks`` >= 2)
    makes :meth:`init_cache` return a :class:`PagedKVCache`.
    """

    def __init__(
        self,
        vocab_size: int = 32000,
        d_model: int = 512,
        num_heads: int = 8,
        num_layers: int = 6,
        dtype: Any = torch.bfloat16,
        attention_impl: str = "flash",
        max_decode_len: int = 2048,
        kv_cache_dtype: str | None = None,
        num_kv_heads: int | None = None,
        window: int | None = None,
        ragged_decode: bool = False,
        paged_decode: bool = False,
        kv_page_size: int = 64,
        kv_pool_blocks: int | None = None,
        moe_every: int = 0,
        num_experts: int = 8,
        moe_top_k: int = 2,
        tp_shards: int = 1,
        tp_axis: str | None = None,
        dropout_rate: float = 0.0,
        remat: bool = False,
        param_dtype: Any = None,
        device: str | torch.device | None = None,
        mesh: Any = None,
        seq_axis: str = "seq",
        batch_axis: str | None = None,
    ):
        super().__init__()
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r} (None or 'int8')")
        if paged_decode:
            if not ragged_decode:
                raise ValueError(
                    "paged_decode requires ragged_decode=True — the page table "
                    "is per-row, so rows must advance independently")
            if kv_pool_blocks is None or kv_pool_blocks < 2:
                raise ValueError(
                    "paged_decode needs kv_pool_blocks >= 2 (block 0 is the "
                    "reserved scratch block)")
            if kv_page_size < 1:
                raise ValueError(f"kv_page_size must be >= 1, got {kv_page_size}")
        if tp_shards > 1 and moe_every:
            raise NotImplementedError(
                "tensor parallelism composes with dense TransformerLMs; shard MoE models "
                "over an expert axis instead (models/moe.py expert_axis)")
        if paged_decode and moe_every:
            raise NotImplementedError(
                "paged_decode serves dense TransformerLMs; MoE blocks keep the dense "
                "ragged cache")
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
        if attention_impl not in ("flash", "reference", *_SEQ_IMPLS):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if attention_impl in _SEQ_IMPLS and (mesh is None or seq_axis not in mesh.shape):
            raise ValueError(f"attention_impl={attention_impl!r} needs a mesh with a "
                             f"{seq_axis!r} axis")
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        stored = None if param_dtype is None else dtype_name(as_dtype(param_dtype))
        param_dtype = dtype if param_dtype is None else as_dtype(param_dtype)
        self.config = dict(
            vocab_size=vocab_size, d_model=d_model, num_heads=num_heads,
            num_layers=num_layers, dtype=dtype_name(dtype),
            attention_impl=attention_impl, max_decode_len=max_decode_len,
            kv_cache_dtype=kv_cache_dtype, num_kv_heads=num_kv_heads, window=window,
            ragged_decode=ragged_decode, paged_decode=paged_decode,
            kv_page_size=kv_page_size, kv_pool_blocks=kv_pool_blocks,
            dropout_rate=dropout_rate, remat=remat,
            moe_every=moe_every, num_experts=num_experts, moe_top_k=moe_top_k,
            param_dtype=stored,
        )
        self.mesh, self.seq_axis, self.batch_axis = mesh, seq_axis, batch_axis
        self.tp_axis, self.tp_shards = tp_axis, tp_shards
        self.moe_every = moe_every
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.max_decode_len = max_decode_len
        self.kv_cache_dtype = kv_cache_dtype
        self.ragged_decode = ragged_decode
        self.paged_decode = paged_decode
        self.kv_page_size = kv_page_size
        self.kv_pool_blocks = kv_pool_blocks
        self.dropout_rate = dropout_rate
        self.remat = remat
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.embed = Embed(vocab_size, d_model, dtype, param_dtype, device)
        block_kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                        dropout_rate=dropout_rate, attention_impl=attention_impl,
                        num_kv_heads=num_kv_heads, window=window, mesh=mesh,
                        seq_axis=seq_axis, batch_axis=batch_axis)
        tp = dict(tp_axis=tp_axis, tp_shards=tp_shards) if tp_axis is not None else {}
        for i in range(num_layers):
            if moe_every and (i + 1) % moe_every == 0:
                from hops_tpu_torch.models.moe import MoEBlock

                block = MoEBlock(d_model, num_heads, num_experts=num_experts,
                                 top_k=moe_top_k, **block_kw)
            else:
                block = Block(d_model, num_heads, **block_kw, **tp)
            self.add_module(f"block_{i}", block)
        self.final_norm = RMSNorm(d_model, dtype, device)
        self.unembed = Dense(d_model, (vocab_size,), dtype, param_dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def blocks(self) -> list[Block]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def clone(self, **changes) -> "TransformerLM":
        """A new module with ``changes`` applied to the config and this
        module's weights: shared when their storage type stays, else cast
        copies."""
        mesh = {k: changes.pop(k, getattr(self, k))
                for k in ("mesh", "seq_axis", "batch_axis", "tp_axis", "tp_shards")}
        other = TransformerLM(**{**self.config, **changes}, device=self.device, **mesh)
        other.load_state_dict(self.state_dict(), strict=True,
                              assign=other.param_dtype == self.param_dtype)
        return other

    def load_flax(self, tree_or_flat) -> "TransformerLM":
        """Load a JAX parameter tree, a flat ``'/'``-joined dict, or a
        ``.npz`` path (:func:`~hops_tpu_torch.models.convert.params_from_flax`),
        cast to the module's dtypes and device. Every name must match."""
        self.load_state_dict(params_from_flax(tree_or_flat), strict=True)
        return self

    def init_cache(self, batch: int) -> KVCache | PagedKVCache:
        """A cache for ``batch`` rows on the model's device: values 0 and
        int8 scales 1, as the JAX package initialises them; on the card
        its head dim is :func:`~hops_tpu_torch.ops.attention.cache_head_dim`
        (heads narrower than the kernels' padded once, here). A paged cache
        starts with an all-zero page table (every position on the scratch
        block) for its owner to fill."""
        attn = self.block_0.attn
        dev = self.device
        hd = cache_head_dim(attn.head_dim, dev)
        if self.paged_decode:
            shape = (attn.kv_heads, self.kv_pool_blocks, self.kv_page_size, hd)
        else:
            shape = (batch, attn.kv_heads, self.max_decode_len, hd)
        int8 = self.kv_cache_dtype == "int8"
        store = torch.int8 if int8 else self.dtype

        def per_layer(shape, dtype, fill):
            return [torch.full(shape, fill, dtype=dtype, device=dev)
                    for _ in range(self.num_layers)]

        kv = dict(k=per_layer(shape, store, 0), v=per_layer(shape, store, 0))
        if int8:
            kv.update(k_scale=per_layer(shape[:3], torch.float32, 1.0),
                      v_scale=per_layer(shape[:3], torch.float32, 1.0))
        if self.paged_decode:
            max_blocks = -(-self.max_decode_len // self.kv_page_size)
            return PagedKVCache(
                **kv, pages=torch.zeros((batch, max_blocks), dtype=torch.int32, device=dev),
                idx=torch.zeros((batch,), dtype=torch.int32, device=dev),
                max_len=self.max_decode_len,
            )
        idx_shape = (batch,) if self.ragged_decode else ()
        return KVCache(**kv, idx=torch.zeros(idx_shape, dtype=torch.int32, device=dev))

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 logits from :meth:`forward`'s ``return_hidden`` output."""
        with annotate("transformer.logits"):
            return self.unembed(hidden).to(torch.float32)

    def forward(
        self,
        tokens: torch.Tensor,
        cache: KVCache | None = None,
        *,
        fresh: bool = False,
        rows: torch.Tensor | None = None,
        return_hidden: bool = False,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Logits ``(batch, seq, vocab)`` fp32.

        Without ``cache``: the full causal forward. ``train=True`` turns
        on dropout (``dropout_rate > 0``; its masks come from
        ``generator``, which is then required) and, with ``remat`` while
        autograd records, recomputes each block in backward
        (``torch.utils.checkpoint``) instead of keeping its activations.
        With ``cache``: decode
        mode — the chunk is written at the cache index and the index
        advances by ``seq``. ``fresh=True`` says the written rows hold no
        history (their index is taken as 0: the prefill of a new
        request). ``rows`` (with ``fresh``) names the cache rows that
        batch rows write, so a prefill fills some slots of a larger
        cache and leaves the others exactly as they were.
        """
        with annotate("transformer.forward"):
            return self._forward(tokens, cache, fresh, rows, return_hidden, train, generator)

    def _forward(self, tokens, cache, fresh, rows, return_hidden, train, generator):
        """:meth:`forward`'s body, inside its range."""
        x = self.embed(tokens)
        offset = None
        if cache is not None:
            if rows is not None and not fresh:
                raise ValueError("rows= requires fresh=True")
            if isinstance(cache, PagedKVCache) and fresh:
                raise ValueError("a paged cache is written at its rows' own indices "
                                 "through its page table: fresh=/rows= are for a dense cache")
            s = tokens.shape[1]
            if s > cache.capacity:
                raise ValueError(f"chunk of {s} exceeds cache capacity {cache.capacity}")
            if fresh:
                offset = torch.zeros(
                    (tokens.shape[0],) if cache.idx.ndim else (),
                    dtype=torch.int32, device=tokens.device,
                )
            else:
                offset = cache.idx
        seed = None
        if train and self.dropout_rate:
            if cache is not None or generator is None:
                raise ValueError("dropout in training needs generator= and no cache")
            # One draw per forward; block i uses seed + 2i and + 2i + 1.
            seed = int(torch.randint(0, 2**62, (), generator=generator))
        remat = train and self.remat and cache is None and torch.is_grad_enabled()
        shard = None
        if cache is None and self.config["attention_impl"] in ("ring", "ulysses"):
            from hops_tpu_torch.parallel import ringattention

            # Sequence parallelism: every block runs on this rank's block
            # of the activations; the blocks join before the final norm.
            shard = ringattention.seq_shard(self.mesh, self.seq_axis, self.batch_axis)
            x = shard.cut(x)
        for i, block in enumerate(self.blocks()):
            block_seed = None if seed is None else seed + 2 * i
            run = block if shard is None else functools.partial(_on_block, block, shard)
            if remat:
                x = checkpoint(run, x, layer=i, seed=block_seed, use_reentrant=False)
            else:
                x = run(x, cache, i, offset, fresh, rows, block_seed)
        if shard is not None:
            x = shard.join(x)
        if cache is not None:
            if rows is None:
                cache.idx = offset + tokens.shape[1]
            else:
                cache.idx[rows] = offset + tokens.shape[1]
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.logits(x)


def _on_block(block: Block, shard: Any, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """``block`` on this rank's block of the activations. Each parameter
    it uses there sums its gradient over the blocks in backward, so every
    rank holds the full gradient; the experts' parameters see the global
    batch and keep theirs."""
    params = {name: shard.summed(p) for name, p in block.named_parameters()
              if not name.startswith("moe.")}
    return torch.func.functional_call(block, params, (x, *args), {**kw, "shard": shard})


def make_lm_train_step(aux_loss_weight: float = 0.01, loss_chunk: int | None = None):
    """Next-token-prediction step: ``(state, {"tokens"}) -> (state, metrics)``.

    The JAX package's step (``hops_tpu/models/transformer.py``) on a
    :class:`~hops_tpu_torch.models.common.TrainState`: inputs are
    ``tokens[:, :-1]``, targets ``tokens[:, 1:]``; the loss is the dense
    cross-entropy over fp32 logits or, with ``loss_chunk``, the chunked
    LM-head loss (:func:`~hops_tpu_torch.ops.xent.chunked_softmax_xent`,
    ``loss_chunk`` tokens' logits at a time); one optimizer step follows.
    Dropout masks derive from ``(state.seed, state.step)``. Unlike JAX,
    the step updates the model's weights and the optimizer's moments in
    place (no second copy of either); the returned state carries the
    next step number. Metrics are 0-d tensors on the model's device (no
    host sync). MoE blocks' load-balancing losses
    (:func:`~hops_tpu_torch.models.moe.sum_sown_losses`) are folded into
    the differentiated loss at ``aux_loss_weight``; the reported loss is
    the cross-entropy alone, as in JAX.
    """
    from hops_tpu_torch.models.moe import sum_sown_losses

    def train_step(state: TrainState, batch: dict[str, Any]):
        model = state.model
        tokens = torch.as_tensor(batch["tokens"]).to(model.device, torch.long)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        gen = torch.Generator().manual_seed(step_seed(state.seed, state.step))
        with annotate("train_step.forward"):
            out = model(inputs, train=True, generator=gen, return_hidden=bool(loss_chunk))
        with annotate("train_step.loss"):
            if loss_chunk:
                loss = chunked_softmax_xent(out, model.unembed.kernel, targets, chunk=loss_chunk)
            else:
                loss = cross_entropy_loss(out, targets)
            aux = sum_sown_losses(model)
            total = loss + aux_loss_weight * aux if model.moe_every else loss
        with annotate("train_step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with annotate("train_step.optimizer"):
            state.optimizer.step()
        loss = loss.detach()
        state = dataclasses.replace(state, step=state.step + 1)
        return state, {"loss": loss, "perplexity": torch.exp(loss)}

    return train_step
