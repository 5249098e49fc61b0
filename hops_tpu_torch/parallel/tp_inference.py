"""Tensor-parallel inference (counterpart of ``hops_tpu/parallel/tp_inference.py``).

A model too big for one card decodes across a tensor-parallel mesh axis
the Megatron way: each rank holds ``1/tp`` of every qkv / out / gate /
up / down kernel and its own head shard of the KV cache, and one sum per
projection (attention out, MLP down) combines the partial outputs.

The JAX package runs the whole ``generate()`` loop inside one
``shard_map``. The port runs one process per rank, each the same host
program on the same requests (SPMD); only the per-block sums cross
ranks. Every sum is an all-gather of the partials followed by a fold in
rank order (:func:`tp_sum`), so every rank computes the same logits bit
for bit and the replicated host schedules (argmax, sampling, admission)
never split.

No weight repacking: :func:`tp_param_specs` slices the dense state
dict's head-major axes (qkv kernels are ``(dm, 3, H, hd)``, out is
head-major ``(dm, dm)``) to this rank's shard, which is what a
``tp_shards``-configured :class:`~hops_tpu_torch.models.transformer.TransformerLM`
holds. :func:`tp_generate` is token-identical to one-rank ``generate``
up to argmax flips at float ties (the partial sums add in another
order).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch

from hops_tpu_torch.parallel.grad_comms import Axis, _axis, _fold, gather_stack


def tp_leaf_partition(names: list[str], tp_axis: str) -> tuple | None:
    """Which per-parameter axis Megatron-shards, by parameter path
    ``names``: the partition tuple for the parameter's shape, or None
    for replicated. The single source of truth for the classification:
    :mod:`~hops_tpu_torch.parallel.pipeline` uses the same tuples."""
    tail = names[-1] if names else ""
    if tail == "kernel":
        if "qkv" in names:  # (dm, 3, H, hd)
            return (None, None, tp_axis, None)
        if "q" in names:  # GQA q: (dm, H, hd)
            return (None, tp_axis, None)
        if "kv" in names:  # GQA kv: (dm, 2, Hkv, hd)
            return (None, None, tp_axis, None)
        if "out" in names:  # (dm, dm), rows head-major
            return (tp_axis, None)
        if "gate" in names or "up" in names:  # (dm, hidden)
            return (None, tp_axis)
        if "down" in names:  # (hidden, dm)
            return (tp_axis, None)
    return None


def tp_shard_dim(name: str) -> int | None:
    """The dimension of parameter ``name`` (a state-dict name such as
    ``block_0.attn.qkv.kernel``, or a flax path with ``/``) that tensor
    parallelism splits, or None for a replicated parameter."""
    part = tp_leaf_partition(re.split(r"[./]", name), "tp")
    return None if part is None else part.index("tp")


def tp_param_specs(params: Mapping[str, Any], shards: int, index: int) -> dict[str, Any]:
    """This rank's shard of a dense TransformerLM state dict (tensors or
    arrays by state-dict or flax-path name): qkv/q/kv kernels on their
    head axis, attention-out and MLP-down kernels on their input rows
    (head-major, so row slices are head slices), gate/up on their output
    columns, each cut into ``shards`` equal parts of which part
    ``index`` is kept; embeds, norms and the unembed replicate."""
    out = {}
    for name, t in params.items():
        d = tp_shard_dim(name)
        if d is None or shards == 1:
            out[name] = t
            continue
        if t.shape[d] % shards:
            raise ValueError(f"{name} {tuple(t.shape)}: dim {d} not divisible by {shards} shards")
        per = t.shape[d] // shards
        t = torch.as_tensor(t)
        out[name] = t.narrow(d, index * per, per).contiguous()
    return out


def tp_unshard_state_dict(params: Mapping[str, torch.Tensor], axis: Axis) -> dict[str, torch.Tensor]:
    """The dense state dict from every rank's :func:`tp_param_specs`
    shard over ``axis`` (the inverse: an all-gather per sharded leaf)."""
    out = {}
    for name, t in params.items():
        d = tp_shard_dim(name)
        out[name] = t if d is None or axis.size == 1 else \
            torch.cat(list(gather_stack(t, axis)), d)
    return out


def tp_cache_specs(cache: Any, shards: int, index: int) -> Any:
    """This rank's shard of a decode cache, for both layouts: dense
    leaves ``(slots, heads, capacity, d)`` (and int8 scales ``(slots,
    heads, capacity)``) on the head axis, dim 1; paged pools ``(kv_heads,
    blocks, page, d)`` on dim 0, every rank owning its head shard of
    every block under the replicated page table; ``idx`` and ``pages``
    replicate. A TP engine sizes its caches at local heads directly
    (``init_cache`` of the sharded model); this slices an existing one."""
    import dataclasses

    from hops_tpu_torch.models.transformer import PagedKVCache

    dim = 0 if isinstance(cache, PagedKVCache) else 1

    def cut(ts):
        if ts is None:
            return None
        return [t.chunk(shards, dim)[index].contiguous() for t in ts]

    return dataclasses.replace(cache, k=cut(cache.k), v=cut(cache.v),
                               k_scale=cut(cache.k_scale), v_scale=cut(cache.v_scale))


def tp_group(mesh: Any, tp_axis: Any, shards: int) -> Axis:
    """The tensor-parallel axis as a ``grad_comms.Axis``: an axis name
    of ``mesh``, a name bound by ``grad_comms.bind_axis``, or an
    ``Axis``; it must hold ``shards`` ranks."""
    if mesh is not None and isinstance(tp_axis, str) and tp_axis in mesh.shape:
        from hops_tpu_torch.parallel.ringattention import axis_group

        axis = axis_group(mesh, tp_axis)
    else:
        axis = _axis(tp_axis)
    if axis.size != shards:
        raise ValueError(f"tp_shards={shards} on an axis of {axis.size} ranks")
    return axis


def fold_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of every rank's ``x``: one all-gather, then a fold in rank
    order, so every rank gets the same sum bit for bit."""
    if axis.size == 1:
        return x
    return _fold(gather_stack(x, axis))


class _Sum(torch.autograd.Function):
    """Megatron's "g": the partial outputs summed over the axis; the
    output is replicated, so each rank's partial has the output's
    gradient (identity backward)."""

    @staticmethod
    def forward(ctx, x, axis):
        return fold_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Megatron's "f": a replicated input used by this rank's shard of a
    column-parallel projection; its gradient is the sum of every rank's
    contribution."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fold_sum(g, ctx.axis), None


def tp_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """:func:`fold_sum` with an identity backward (Megatron's "g")."""
    if axis.size == 1:
        return x
    return _Sum.apply(x, axis) if torch.is_grad_enabled() and x.requires_grad \
        else fold_sum(x, axis)


def tp_enter(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` unchanged, its gradient summed over ``axis`` (Megatron's "f")."""
    if axis.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, axis)


def tp_shard_model(model: Any, mesh: Any, tp_axis: Any = "model", shards: int | None = None):
    """A ``TransformerLM`` holding this rank's Megatron shard of dense
    ``model`` (same config, dtypes and device; ``tp_axis`` of ``mesh``,
    or a bound name or ``Axis`` with ``shards``). Its heads (and kv
    heads) must divide the degree. The sliced weights are copies; the
    dense model is left as it was."""
    from hops_tpu_torch.models.transformer import TransformerLM

    if shards is None:
        shards = mesh.shape[tp_axis]
    axis = tp_group(mesh, tp_axis, shards)
    local = TransformerLM(**model.config, device=model.device, mesh=mesh,
                          seq_axis=model.seq_axis, batch_axis=model.batch_axis,
                          tp_axis=tp_axis, tp_shards=shards)
    local.load_state_dict(tp_param_specs(model.state_dict(), shards, axis.index), strict=True)
    return local


def _local_model(model: Any, mesh: Any, tp_axis: str) -> Any:
    """``tp_shard_model`` memoized on ``model`` per (mesh, axis): the
    JAX package caches its compiled program on the same keys, so a
    second call on the same model slices nothing again."""
    memo = model.__dict__.setdefault("_tp_local", {})
    key = (id(mesh), tp_axis)
    if key not in memo:
        memo[key] = tp_shard_model(model, mesh, tp_axis)
    return memo[key]


def _batch_rows(prompt: Any, mesh: Any, batch_axis: str | None, device) -> tuple:
    """(this rank's rows of ``prompt``, their first global row id, the
    batch axis or None)."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    if batch_axis is None:
        return prompt, 0, None
    from hops_tpu_torch.parallel.ringattention import axis_group

    axis = axis_group(mesh, batch_axis)
    if prompt.shape[0] % axis.size:
        raise ValueError(f"{prompt.shape[0]} prompt rows do not split over {axis.size} "
                         f"{batch_axis!r} shards")
    per = prompt.shape[0] // axis.size
    return prompt[axis.index * per:(axis.index + 1) * per], axis.index * per, axis


def _join_rows(out: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return out
    return gather_stack(out, axis).reshape(-1, *out.shape[1:])


def _check_kwargs(kwargs: dict) -> None:
    if "row_offset" in kwargs:
        raise ValueError("the tp wrapper owns row_offset (it derives it from the dp shard "
                         "index) — shard the batch via batch_axis instead")


def tp_generate(
    model: Any,
    prompt: Any,
    mesh: Any,
    tp_axis: str = "model",
    batch_axis: str | None = None,
    **generate_kwargs: Any,
) -> torch.Tensor:
    """:func:`hops_tpu_torch.models.generation.generate` over a
    tensor-parallel mesh: ``generate``'s arguments plus ``mesh``,
    ``tp_axis`` and ``batch_axis``, the same tokens. ``model`` is the
    DENSE model (its ``num_heads``, and ``num_kv_heads`` if set, must
    divide the tp degree); every rank of the mesh calls this with the
    same arguments. With ``batch_axis`` the prompt rows split over that
    axis (dp x tp serving on one mesh), each shard keyed by its global
    row ids; every rank returns the whole batch."""
    from hops_tpu_torch.models.generation import generate

    _check_kwargs(generate_kwargs)
    local = _local_model(model, mesh, tp_axis)
    rows, offset, axis = _batch_rows(prompt, mesh, batch_axis, local.device)
    out = generate(local, rows, row_offset=offset, device=local.device, **generate_kwargs)
    return _join_rows(out, axis)


def tp_generate_speculative(
    model: Any,
    draft_model: Any,
    prompt: Any,
    mesh: Any,
    tp_axis: str = "model",
    batch_axis: str | None = None,
    **spec_kwargs: Any,
) -> torch.Tensor:
    """:func:`hops_tpu_torch.models.generation.generate_speculative` over
    a tensor-parallel mesh: BOTH models are sliced (the draft's heads
    must divide the tp degree too) and the whole propose/score/accept
    loop runs on every rank. Greedy output matches the one-rank call up
    to argmax flips at float ties; sampled runs are deterministic and
    keyed by global row ids, their agreement with the one-rank call
    distributional (acceptance compares against logits whose sums add
    in another order). Sampling needs ``seed`` (the port's ``rng``)."""
    from hops_tpu_torch.models.generation import generate_speculative

    if spec_kwargs.get("temperature", 0.0) > 0 and spec_kwargs.get("seed") is None:
        raise ValueError("sampled speculative decoding requires seed")
    _check_kwargs(spec_kwargs)
    local = _local_model(model, mesh, tp_axis)
    dlocal = _local_model(draft_model, mesh, tp_axis)
    rows, offset, axis = _batch_rows(prompt, mesh, batch_axis, local.device)
    out = generate_speculative(local, dlocal, rows, row_offset=offset, device=local.device,
                               **spec_kwargs)
    return _join_rows(out, axis)
