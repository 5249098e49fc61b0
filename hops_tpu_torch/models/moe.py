"""Mixture-of-Experts layer (counterpart of ``hops_tpu/models/moe.py``).

The JAX package's dense-dispatch MoE, kept as it is:

- router: fp32 softmax over expert logits; a token's gates are the
  probabilities ``>= `` its k-th largest (a tie can select more than k
  experts), renormalized;
- capacity ``max(1, int(capacity_factor · tokens · k / E))`` per call;
  a token's slot in an expert's buffer is the running count of tokens
  routed there in (batch, seq) order, and tokens past capacity drop
  (the residual path still carries them);
- dispatch and combine are einsums against a one-hot ``(T, E, C)`` mask;
  the experts' GELU is flax's tanh approximation;
- a Switch-style load-balancing loss per call, which the train step
  folds in (:func:`sum_sown_losses`).

With ``expert_axis`` (a process group, or a ``grad_comms`` axis) each rank
holds ``num_experts // expert_shards`` experts, computes their
contribution and the contributions are summed over the axis — the dense
dispatch's result. :func:`expert_specs` gives the DTensor placements that
shard the expert stacks on their leading dim.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from hops_tpu_torch.models.transformer import Block, Dense, _param


class _SumOverAxis(torch.autograd.Function):
    """The sum of every rank's contribution (the rank-order ``psum``);
    each rank's downstream is the same replicated computation, so the
    gradient of its own contribution is the output's gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        from hops_tpu_torch.parallel.grad_comms import psum

        return psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class MoEMLP(nn.Module):
    """Top-k routed expert FFN over ``(batch, seq, d_model)``, holding
    flax's ``router/kernel`` ``(d_model, E)`` (fp32 compute),
    ``w_in`` ``(E_local, d_model, hidden)`` and ``w_out`` ``(E_local,
    hidden, d_model)`` in ``param_dtype``. ``aux_loss`` is the last
    call's load-balancing loss."""

    def __init__(self, d_model: int, *, num_experts: int = 8, top_k: int = 2,
                 hidden_mult: int = 4, capacity_factor: float = 1.25, dtype=torch.bfloat16,
                 param_dtype=None, device=None, expert_axis: Any = None,
                 expert_shards: int = 1):
        super().__init__()
        if num_experts % expert_shards:
            raise ValueError(f"{num_experts} experts not divisible by "
                             f"expert_shards={expert_shards}")
        param_dtype = dtype if param_dtype is None else param_dtype
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.expert_axis, self.expert_shards = expert_axis, expert_shards
        hidden = max(128, (d_model * hidden_mult // 128) * 128)
        e_local = num_experts // expert_shards
        self.router = Dense(d_model, (num_experts,), torch.float32, param_dtype, device)
        self.w_in = _param((e_local, d_model, hidden), param_dtype, device)
        self.w_out = _param((e_local, hidden, d_model), param_dtype, device)
        self.aux_loss: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dm = x.shape
        n_tok = b * s
        capacity = max(1, int(self.capacity_factor * n_tok * self.top_k / self.num_experts))
        tokens = x.reshape(n_tok, dm)
        probs = torch.softmax(self.router(tokens.float()), dim=-1)  # (T, E)
        kth = torch.topk(probs, self.top_k, dim=-1).values[:, -1:]
        gates = torch.where(probs >= kth, probs, 0.0)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        assigned = gates > 0.0
        position = torch.cumsum(assigned.to(torch.int32), dim=0) - 1
        keep = assigned & (position < capacity)
        slots = torch.arange(capacity, device=x.device)
        dispatch = (keep[..., None] & (position[..., None] == slots)).to(self.dtype)  # (T, E, C)
        expert_tokens = tokens
        if self.expert_axis is not None:
            from hops_tpu_torch.parallel.grad_comms import _axis
            from hops_tpu_torch.parallel.tp_inference import tp_enter

            axis = _axis(self.expert_axis)
            if axis.size != self.expert_shards:
                raise ValueError(f"expert_shards={self.expert_shards} on an axis of {axis.size}")
            # The tokens and gates feed only this rank's experts here:
            # their gradients sum over the axis (Megatron's "f").
            expert_tokens, gates = tp_enter(tokens, axis), tp_enter(gates, axis)
        combine = dispatch * gates[..., None].to(self.dtype)
        if self.expert_axis is not None:
            e_local = self.num_experts // self.expert_shards
            start = axis.index * e_local
            dispatch = dispatch[:, start:start + e_local]
            combine = combine[:, start:start + e_local]
        expert_in = torch.einsum("td,tec->ecd", expert_tokens.to(self.dtype), dispatch)
        h = torch.einsum("ecd,edh->ech", expert_in, self.w_in.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        expert_out = torch.einsum("ech,ehd->ecd", h, self.w_out.to(self.dtype))
        out = torch.einsum("ecd,tec->td", expert_out, combine)
        if self.expert_axis is not None:
            out = _SumOverAxis.apply(out, axis)
        density = assigned.to(torch.float32).mean(0)
        self.aux_loss = self.num_experts * torch.sum(density * probs.mean(0))
        return out.reshape(b, s, dm)


def sum_sown_losses(model: nn.Module) -> torch.Tensor | float:
    """The total of the load-balancing losses of ``model``'s MoE layers
    from its last forward (0.0 when it has none) — what the JAX package
    sums from the ``"losses"`` collection. Read it right after the
    forward whose losses it should fold."""
    losses = [m.aux_loss for m in model.modules()
              if isinstance(m, MoEMLP) and m.aux_loss is not None]
    return sum(losses) if losses else 0.0


def expert_specs(params: Any, axis: str = "expert") -> Any:
    """DTensor placements for a state dict (or a nested dict of
    parameters): every expert stack (``w_in``/``w_out``) ``Shard(0)`` on
    its leading (num_experts) dim, the rest ``Replicate()``. Pair each
    with the ``axis`` of a mesh (``sharding.sharding_tree``)."""
    from torch.distributed.tensor import Replicate, Shard

    del axis  # a placement is per axis; the caller pairs it with one

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return Shard(0) if name.rsplit(".", 1)[-1] in ("w_in", "w_out") else Replicate()

    return walk(params)


class MoEBlock(Block):
    """A transformer block whose MLP is routed experts (``moe``)."""

    def __init__(self, d_model: int, num_heads: int, *, num_experts: int = 8, top_k: int = 2,
                 expert_axis: Any = None, expert_shards: int = 1, **block_kw):
        super().__init__(d_model, num_heads, **block_kw, moe=dict(
            num_experts=num_experts, top_k=top_k, expert_axis=expert_axis,
            expert_shards=expert_shards))
