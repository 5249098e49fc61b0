"""Decoder-only transformer LM (counterpart of ``hops_tpu/models/transformer.py``).

Modules keep the flax parameter names and shapes as attributes — for
example ``block_3.attn.qkv.kernel`` of shape ``(d_model, 3, heads,
head_dim)`` — so a JAX parameter tree loads with no reshape
(:mod:`hops_tpu_torch.models.convert`). Projections compute with
``einsum``/``matmul`` in the model dtype, as flax's ``Dense`` does;
RMSNorm statistics and scale stay fp32; logits are fp32.

The KV cache is explicit: :meth:`TransformerLM.init_cache` returns a
:class:`KVCache`, and a decode call writes into it in place. Attention
runs through :func:`hops_tpu_torch.ops.attention.flash_attention` (full
forward, and the prefill of a fresh cache) and
:func:`hops_tpu_torch.ops.attention.decode_attention` (every step on a
warm cache): the port's two Hopper kernels on CUDA tensors.

This slice serves dense models; the paged cache, the int8 cache, MoE
blocks, tensor parallelism and the ring/Ulysses impls raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from hops_tpu_torch.models.convert import params_from_flax
from hops_tpu_torch.ops.attention import (
    attention_reference,
    decode_attention,
    flash_attention,
    repeat_kv,
)
from hops_tpu_torch.runtime.devices import resolve_device

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
    # Serving slice: weights are loaded, never trained here.
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """Bias-free projection holding flax's ``kernel`` of shape
    ``(in, *features)``."""

    def __init__(self, in_features: int, features: tuple[int, ...], dtype, device):
        super().__init__()
        self.kernel = _param((in_features, *features), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        out = x.to(w.dtype) @ w.reshape(w.shape[0], -1)
        return out.reshape(*x.shape[:-1], *w.shape[1:])


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, dim), dtype, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(tokens, self.embedding)


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
    ``(batch, kv_heads, max_decode_len, head_dim)``; ``idx`` is the cache
    index — ``(batch,)`` int32 on a ``ragged_decode`` model (every row
    advances on its own), a 0-d int32 otherwise. All layers advance in
    lockstep, so one index serves them all. Decode calls update the
    tensors in place."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    idx: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]


class Attention(nn.Module):
    def __init__(
        self, d_model: int, num_heads: int, *, dtype, device,
        attention_impl: str = "flash", num_kv_heads: int | None = None,
        window: int | None = None,
    ):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.attention_impl = attention_impl
        self.window = window
        self.fused = num_kv_heads is None
        if self.fused:
            self.kv_heads = num_heads
            self.qkv = Dense(d_model, (3, num_heads, self.head_dim), dtype, device)
        else:
            if num_heads % num_kv_heads:
                raise ValueError(
                    f"{num_heads} heads not divisible by num_kv_heads={num_kv_heads}"
                )
            self.kv_heads = num_kv_heads
            self.q = Dense(d_model, (num_heads, self.head_dim), dtype, device)
            self.kv = Dense(d_model, (2, num_kv_heads, self.head_dim), dtype, device)
        self.out = Dense(num_heads * self.head_dim, (d_model,), dtype, device)

    def _project_in(self, x):
        if self.fused:
            qkv = self.qkv(x)  # (b, s, 3, h, d)
            return [qkv[:, :, i].transpose(1, 2) for i in range(3)]  # (b, h, s, d)
        q = self.q(x).transpose(1, 2)
        kv = self.kv(x)
        return [q] + [kv[:, :, i].transpose(1, 2) for i in range(2)]

    def _project_out(self, o):
        b, _, s, _ = o.shape
        return self.out(o.transpose(1, 2).reshape(b, s, -1))

    def forward(self, x, cache: KVCache | None = None, layer: int = 0,
                offset: torch.Tensor | None = None, fresh: bool = False,
                rows: torch.Tensor | None = None):
        q, k, v = self._project_in(x)
        if cache is not None:
            return self._decode_attend(q, k, v, cache, layer, offset, fresh, rows)
        pos = torch.arange(x.shape[1], device=x.device)
        q, k = rotary_embedding(q, pos), rotary_embedding(k, pos)
        k, v = repeat_kv(q, k, v)
        if self.attention_impl == "flash":
            o = flash_attention(q, k, v, causal=True, window=self.window)
        elif self.attention_impl == "reference":
            o = attention_reference(q, k, v, causal=True, window=self.window)
        else:
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        return self._project_out(o)

    def _decode_attend(self, q, k, v, cache, layer, offset, fresh, rows):
        """Attention against the layer's slice of ``cache``.

        ``offset`` is the cache index before this chunk (shared by all
        layers; :class:`TransformerLM` advances ``cache.idx`` once after
        the last layer). The chunk lands at each row's offset (clamped so
        it fits, as ``dynamic_update_slice`` clamps). A multi-token chunk
        on a ``fresh`` cache (nothing earlier to attend to) is plain
        causal self-attention over the chunk and runs through the flash
        kernel; every other call streams the cache through the decode
        kernel. ``rows`` (fresh only) maps batch row i to cache row
        ``rows[i]``: the engine prefills admitted slots in place.
        """
        b, _, s, _ = q.shape
        ck, cv = cache.k[layer], cache.v[layer]
        cap = ck.shape[2]
        steps = torch.arange(s, device=q.device)
        pos = offset[:, None] + steps[None, :] if offset.ndim == 1 else offset + steps
        q = rotary_embedding(q, pos)
        k = rotary_embedding(k, pos)
        start = torch.clamp(offset, 0, cap - s)
        wpos = start[:, None] + steps[None, :] if start.ndim == 1 else (start + steps)[None, :]
        row_idx = torch.arange(b, device=q.device) if rows is None else rows
        # (b, cap, h, d) views: one index_put_ per cache writes every
        # row's chunk at its own offset.
        ck.transpose(1, 2)[row_idx[:, None], wpos] = k.transpose(1, 2).to(ck.dtype)
        cv.transpose(1, 2)[row_idx[:, None], wpos] = v.transpose(1, 2).to(cv.dtype)
        if s > 1 and fresh:
            kk, vv = repeat_kv(q, k.to(ck.dtype), v.to(cv.dtype))
            o = flash_attention(q, kk, vv, causal=True, window=self.window)
        else:
            if rows is not None:
                raise ValueError("rows= is only for fresh prefill")
            o = decode_attention(q, ck, cv, offset + s, window=self.window)
        return self._project_out(o)


class MLP(nn.Module):
    """SwiGLU: gate/up projections and a gated down projection."""

    def __init__(self, d_model: int, *, dtype, device, hidden_mult: int = 4):
        super().__init__()
        hidden = int(d_model * hidden_mult * 2 / 3)
        hidden = max(128, (hidden // 128) * 128)
        self.gate = Dense(d_model, (hidden,), dtype, device)
        self.up = Dense(d_model, (hidden,), dtype, device)
        self.down = Dense(hidden, (d_model,), dtype, device)

    def forward(self, x):
        return self.down(nn.functional.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, *, dtype, device, **attn_kw):
        super().__init__()
        self.RMSNorm_0 = RMSNorm(d_model, dtype, device)
        self.attn = Attention(d_model, num_heads, dtype=dtype, device=device, **attn_kw)
        self.RMSNorm_1 = RMSNorm(d_model, dtype, device)
        self.mlp = MLP(d_model, dtype=dtype, device=device)

    def forward(self, x, cache=None, layer=0, offset=None, fresh=False, rows=None):
        x = x + self.attn(self.RMSNorm_0(x), cache, layer, offset, fresh, rows)
        return x + self.mlp(self.RMSNorm_1(x))


class TransformerLM(nn.Module):
    """GPT-style causal LM over token ids ``(batch, seq)`` -> fp32 logits.

    Constructor arguments are the flax module's fields (the artifact's
    ``lm_config.json``), plus ``device`` (``None`` = the card). Fields of
    later slices raise ``NotImplementedError``. ``attention_impl=
    "reference"`` runs the full forward on the plain attention version;
    the cached path always runs the kernels.
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
        moe_every: int = 0,
        tp_shards: int = 1,
        tp_axis: str | None = None,
        dropout_rate: float = 0.0,
        remat: bool = False,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        if paged_decode:
            raise NotImplementedError("paged_decode: the paged KV cache is a later slice")
        if kv_cache_dtype is not None:
            raise NotImplementedError(
                f"kv_cache_dtype={kv_cache_dtype!r}: the int8 cache is a later slice"
            )
        if moe_every:
            raise NotImplementedError("moe_every: MoE blocks are a later slice")
        if tp_shards != 1 or tp_axis is not None:
            raise NotImplementedError("tp_*: tensor parallelism is a later slice")
        if dropout_rate or remat:
            raise NotImplementedError(
                "dropout_rate/remat act in training, which is a later slice"
            )
        if attention_impl not in ("flash", "reference"):
            raise NotImplementedError(
                f"attention_impl={attention_impl!r}: ring/ulysses are a later slice"
            )
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        self.config = dict(
            vocab_size=vocab_size, d_model=d_model, num_heads=num_heads,
            num_layers=num_layers, dtype=dtype_name(dtype),
            attention_impl=attention_impl, max_decode_len=max_decode_len,
            num_kv_heads=num_kv_heads, window=window, ragged_decode=ragged_decode,
        )
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.max_decode_len = max_decode_len
        self.ragged_decode = ragged_decode
        self.dtype = dtype
        self.embed = Embed(vocab_size, d_model, dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", Block(
                d_model, num_heads, dtype=dtype, device=device,
                attention_impl=attention_impl, num_kv_heads=num_kv_heads,
                window=window,
            ))
        self.final_norm = RMSNorm(d_model, dtype, device)
        self.unembed = Dense(d_model, (vocab_size,), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def blocks(self) -> list[Block]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def clone(self, **changes) -> "TransformerLM":
        """A new module with ``changes`` applied to the config and this
        module's weights: shared when the dtype stays, else cast copies."""
        other = TransformerLM(**{**self.config, **changes}, device=self.device)
        other.load_state_dict(self.state_dict(), strict=True, assign=other.dtype == self.dtype)
        return other

    def load_flax(self, tree_or_flat) -> "TransformerLM":
        """Load a JAX parameter tree, a flat ``'/'``-joined dict, or a
        ``.npz`` path (:func:`~hops_tpu_torch.models.convert.params_from_flax`),
        cast to the module's dtypes and device. Every name must match."""
        self.load_state_dict(params_from_flax(tree_or_flat), strict=True)
        return self

    def init_cache(self, batch: int) -> KVCache:
        """An all-zero cache for ``batch`` rows on the model's device."""
        attn = self.block_0.attn
        shape = (batch, attn.kv_heads, self.max_decode_len, attn.head_dim)
        dev = self.device
        idx_shape = (batch,) if self.ragged_decode else ()
        return KVCache(
            k=[torch.zeros(shape, dtype=self.dtype, device=dev) for _ in range(self.num_layers)],
            v=[torch.zeros(shape, dtype=self.dtype, device=dev) for _ in range(self.num_layers)],
            idx=torch.zeros(idx_shape, dtype=torch.int32, device=dev),
        )

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 logits from :meth:`forward`'s ``return_hidden`` output."""
        return self.unembed(hidden).to(torch.float32)

    def forward(
        self,
        tokens: torch.Tensor,
        cache: KVCache | None = None,
        *,
        fresh: bool = False,
        rows: torch.Tensor | None = None,
        return_hidden: bool = False,
    ) -> torch.Tensor:
        """Logits ``(batch, seq, vocab)`` fp32.

        Without ``cache``: the full causal forward. With ``cache``: decode
        mode — the chunk is written at the cache index and the index
        advances by ``seq``. ``fresh=True`` says the written rows hold no
        history (their index is taken as 0: the prefill of a new
        request). ``rows`` (with ``fresh``) names the cache rows that
        batch rows write, so a prefill fills some slots of a larger
        cache and leaves the others exactly as they were.
        """
        x = self.embed(tokens)
        offset = None
        if cache is not None:
            if rows is not None and not fresh:
                raise ValueError("rows= requires fresh=True")
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
        for i, block in enumerate(self.blocks()):
            x = block(x, cache, i, offset, fresh, rows)
        if cache is not None:
            if rows is None:
                cache.idx = offset + tokens.shape[1]
            else:
                cache.idx[rows] = offset + tokens.shape[1]
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.logits(x)
