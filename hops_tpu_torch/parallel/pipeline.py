"""Pipeline parallelism: GPipe-style microbatched stages over a ``stage``
mesh axis (counterpart of ``hops_tpu/parallel/pipeline.py``).

The JAX package writes the pipeline as one ``shard_map`` program whose
``fori_loop`` applies every device's stage to the activation it holds
and ``ppermute``s the result one hop down the ring; ``jax.grad``
differentiates through it. The port runs one process per rank. Each
rank of the ``stage`` axis runs its own stage on microbatches ``0 ..
M-1`` in order: stage 0 ingests the microbatch, every other stage
receives it from the stage before (``_Recv``), and every stage but the
last sends its output on (``_Send``). Both hops are
``torch.autograd.Function``s whose backward moves the gradient the
other way, so autograd runs the drain in reverse. The last stage emits
(the collected outputs through ``emit_fn``) and its result is handed to
every stage (``_FromLast``), as the JAX program's ``psum`` of the last
stage's outputs does. The hops ride the ring primitives of
:mod:`~hops_tpu_torch.parallel.ringattention` and
:mod:`~hops_tpu_torch.parallel.grad_comms`: on a gloo group, CUDA tensors
go through host buffers (``grad_comms.via_host``).

Parameters. As in JAX, the dense parameter tree stays replicated and is
updated everywhere: each rank runs its stage's chunk of it, so after a
backward each rank holds the gradients of what its stage used.
:func:`pipelined_lm_apply` taps every use of a parameter per microbatch
(:class:`GradTaps`); :meth:`GradTaps.reduce` folds the taps in ascending
microbatch order and sums the result in rank order over the stage axis
(and over the axes that split the data, and over the tensor or expert
axis for the leaves sharded there), so every rank ends with the same
full gradient and the same optimizer update. The explicit schedules
(``gpipe``/``1f1b``/``interleaved``, :mod:`~hops_tpu_torch.parallel.pp_schedule`)
run a forward and a backward slot per tick with
``torch.autograd.backward`` and fold the same taps in the same order,
so every schedule, and the autodiff ring, give bit-identical losses and
gradients.

Compositions of :func:`pipelined_lm_apply`, as in JAX: ``seq_axis``
(``ring_local`` attention inside each stage), ``expert_axis``
(``MoEMLP(expert_axis=)``), ``tp_axis`` (Megatron tensor parallelism
inside each stage, :mod:`~hops_tpu_torch.parallel.tp_inference`) and
``batch_axis`` (data parallelism outside the ring).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn

from hops_tpu_torch.parallel.grad_comms import (
    Axis,
    count_host_bytes,
    gather_stack,
    psum,
    via_host,
)
from hops_tpu_torch.parallel.mesh import _tree_map
from hops_tpu_torch.parallel.tp_inference import fold_sum, tp_shard_dim, tp_sum


def _tree_multimap(fn: Callable, *trees: Any) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_multimap(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_multimap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params: list[Any]) -> Any:
    """Stack S same-structure parameter trees along a new leading stage dim."""
    return _tree_multimap(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                          *per_stage_params)


def chunk_stage_params(per_layer_params: list[Any], n_stages: int) -> Any:
    """Split L same-structure layer trees into S stage chunks of K=L/S
    layers; leaves come out ``(S, K, ...)``."""
    n_layers = len(per_layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    k = n_layers // n_stages
    return stack_stage_params([stack_stage_params(per_layer_params[s * k:(s + 1) * k])
                               for s in range(n_stages)])


# -- the stage axis and its hops -------------------------------------------------


def _axis(mesh: Any, name: str) -> Axis:
    from hops_tpu_torch.parallel.ringattention import axis_group

    return axis_group(mesh, name)


def _send(x: torch.Tensor, axis: Axis, dst: int, tag: int = 0) -> None:
    x = x.contiguous()
    if via_host(x, axis.group):
        x = x.cpu()
        count_host_bytes(x.nbytes)
    dist.send(x, axis.ranks[dst], group=axis.group, tag=tag)


def _recv(shape, dtype, device, axis: Axis, src: int, tag: int = 0) -> torch.Tensor:
    host = device.type == "cuda" and dist.get_backend(axis.group) == "gloo"
    out = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    dist.recv(out, axis.ranks[src], group=axis.group, tag=tag)
    if host:
        count_host_bytes(out.nbytes)
        return out.to(device)
    return out


class _Recv(torch.autograd.Function):
    """The activation stage ``src`` sent; the backward sends its gradient
    back. ``anchor`` (a 0-d tensor that requires grad) puts the hop in
    the graph."""

    @staticmethod
    def forward(ctx, anchor, axis, src, shape, dtype):
        ctx.axis, ctx.src = axis, src
        return _recv(shape, dtype, anchor.device, axis, src)

    @staticmethod
    def backward(ctx, g):
        _send(g, ctx.axis, ctx.src)
        return None, None, None, None, None


class _Send(torch.autograd.Function):
    """Send ``x`` to stage ``dst``; returns a 0-d token to tie into the
    rank's output. The backward receives ``x``'s gradient from ``dst``."""

    @staticmethod
    def forward(ctx, x, axis, dst):
        ctx.axis, ctx.dst = axis, dst
        ctx.meta = (x.shape, x.dtype, x.device)
        _send(x.detach(), axis, dst)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.meta
        return _recv(shape, dtype, device, ctx.axis, ctx.dst), None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``x`` on every stage (``x`` is a placeholder of
    the same shape elsewhere). Every stage computes the same loss from
    it, one loss, so only the last stage's ``x`` takes its gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.last = axis.index == axis.size - 1
        return gather_stack(x.detach(), axis)[axis.size - 1]

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None), None


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``tokens`` in its graph: the backward of every
    send this rank made runs when the output's backward does."""

    @staticmethod
    def forward(ctx, x, *tokens):
        ctx.n = len(tokens)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros((), dtype=g.dtype, device=g.device) for _ in range(ctx.n)))


# -- specs: a PartitionSpec as a tuple of axis names per dim ---------------------


def _spec_axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _cut(x: torch.Tensor, spec: Any, mesh: Any) -> torch.Tensor:
    """This rank's block of replicated ``x`` under ``spec`` (one entry per
    leading dim: an axis name, a tuple of them, or None). The cut's
    backward gathers the blocks' gradients."""
    from hops_tpu_torch.parallel.ringattention import _Cut

    for dim, entry in enumerate(spec or ()):
        for name in _spec_axes(entry):
            ax = _axis(mesh, name)
            if ax.size > 1:
                if x.shape[dim] % ax.size:
                    raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                                     f"{ax.size} {name!r} ranks")
                x = _Cut.apply(x, ax, dim)
    return x


def _join(x: torch.Tensor, spec: Any, mesh: Any) -> torch.Tensor:
    """The replicated tensor from every rank's block under ``spec``."""
    from hops_tpu_torch.parallel.ringattention import _Join

    cuts = [(dim, name) for dim, entry in enumerate(spec or ()) for name in _spec_axes(entry)]
    for dim, name in reversed(cuts):
        ax = _axis(mesh, name)
        if ax.size > 1:
            x = _Join.apply(x, ax, dim)
    return x


def _sum_over(x: torch.Tensor, axes: list[Axis]) -> torch.Tensor:
    """The rank-order sum over ``axes`` with an identity backward (a
    replicated result whose every copy is the one value)."""
    for ax in axes:
        x = tp_sum(x, ax)
    return x


# -- the fill-drain ring -----------------------------------------------------------


def _ring(stage_fn: Callable, micro: list, axis: Axis, *, ingest: Callable, emit: Callable,
          act: tuple, out_shape: tuple, out_dtype, device, stage_aux: bool):
    """Run the M microbatches ``micro`` through the stages: returns
    (the last stage's ``emit`` result on every stage, this stage's aux
    sum over microbatches). ``stage_fn(h, j) -> (h, aux)``, ``ingest(x,
    j) -> h``, ``emit(outputs) -> y`` of ``out_shape``; ``act`` is the
    carried activation's (shape, dtype)."""
    n, s = axis.size, axis.index
    anchor = torch.zeros((), device=device, requires_grad=torch.is_grad_enabled())
    outs, tokens = [], []
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for j, x in enumerate(micro):
        if s == 0:
            h = ingest(x, j)
        elif anchor.requires_grad:
            h = _Recv.apply(anchor, axis, s - 1, *act)
        else:
            h = _recv(*act, device, axis, s - 1)
        h, a = stage_fn(h, j)
        if stage_aux:
            aux = aux + a
        if s < n - 1:
            if h.requires_grad:
                tokens.append(_Send.apply(h, axis, s + 1))
            else:
                _send(h, axis, s + 1)
        else:
            outs.append(h)
    if s == n - 1:
        y = emit(outs)
    else:
        y = torch.zeros(out_shape, dtype=out_dtype, device=device)
    if n > 1:
        y = _FromLast.apply(y, axis)
    if tokens:
        # Either output may be all a loss reads (the MoE aux alone, say):
        # both carry the sends' backward.
        y = _Tie.apply(y, *tokens)
        if stage_aux:
            aux = _Tie.apply(aux, *tokens)
    return y, aux


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    stacked_params: Any,
    x: torch.Tensor,
    mesh: Any,
    *,
    axis: str = "stage",
    num_microbatches: int | None = None,
    ingest_fn: Callable[[Any, torch.Tensor], torch.Tensor] | None = None,
    ingest_params: Any = None,
    emit_fn: Callable[[Any, torch.Tensor], torch.Tensor] | None = None,
    emit_params: Any = None,
    stage_aux: bool = False,
    x_spec: Any = None,
    out_spec: Any = None,
    param_specs: Any = None,
    extra_vary: tuple[str, ...] = (),
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Run ``x`` through S pipelined stages; returns the final outputs on
    every rank (the JAX package's replicated result).

    ``stage_fn(params_s, h) -> h`` must preserve ``h``'s shape;
    ``stacked_params`` leaves have leading dim S and stage ``s`` uses
    ``leaf[s]``. ``x`` is ``(batch, ...)``, the same on every rank,
    split into ``num_microbatches`` (default S) equal microbatches.
    ``stage_aux=True``: ``stage_fn`` returns ``(h, aux_scalar)`` and the
    call returns ``(outputs, aux)``, ``aux`` the mean over microbatches
    of the per-stage scalars summed over stages. ``ingest_fn`` maps a
    raw microbatch to the carried activation on stage 0; ``emit_fn``
    maps the collected outputs to the result on the last stage.

    ``x_spec``/``out_spec`` shard the input/output over inner mesh axes
    (tuples of axis names per dim, as ``PartitionSpec``s: a batch dim on
    a data axis runs one ring per data coordinate); ``param_specs`` (the
    same tree as ``stacked_params``) shards leaves beyond the stage dim
    (e.g. ``(axis, None, "expert")``). ``extra_vary`` is accepted for
    the JAX package's signature and unused (``mesh.pvary``).

    Each rank's backward leaves the gradients of what its stage used in
    the parameters' ``.grad``; sum them over the stage axis (and the
    data axes) for the replicated gradient (:func:`psum_grads`).
    """
    del extra_vary
    stage = _axis(mesh, axis)
    n_stages, s = stage.size, stage.index
    m = num_microbatches or n_stages
    n_data = math.prod(_axis(mesh, a).size for a in _spec_axes((x_spec or (None,))[0]))
    if x.shape[0] % (m * n_data):
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} microbatches x {n_data} "
                         f"batch shards")

    def pick(leaf, spec=None):
        p = leaf[s]
        if spec is not None:
            p = _cut(p, tuple(spec)[1:], mesh)
        return p

    if param_specs is None:
        params = _tree_map(pick, stacked_params)
    else:
        params = _tree_multimap(pick, stacked_params, param_specs)
    x_local = _cut(x, x_spec, mesh)
    lb = x_local.shape[0]
    micro = list(x_local.reshape(m, lb // m, *x_local.shape[1:]))
    ingest = (lambda v, j: ingest_fn(ingest_params, v)) if ingest_fn else (lambda v, j: v)
    # Every stage learns the carried and the emitted shapes by running
    # ingest and emit once without autograd (cheap at a stage's edges).
    with torch.no_grad():
        h0 = ingest(micro[0], 0)
        full = h0.new_zeros((lb, *h0.shape[1:]))
        y0 = emit_fn(emit_params, full) if emit_fn else full

    def fn(h, j):
        out = stage_fn(params, h)
        return out if stage_aux else (out, torch.zeros((), device=h.device))

    def emit(outs):
        full = torch.cat(outs)
        return emit_fn(emit_params, full) if emit_fn else full

    y, aux = _ring(fn, micro, stage, ingest=ingest, emit=emit, act=(tuple(h0.shape), h0.dtype),
                   out_shape=tuple(y0.shape), out_dtype=y0.dtype, device=x_local.device,
                   stage_aux=stage_aux)
    y = _join(y, out_spec, mesh)
    if not stage_aux:
        return y
    aux = _sum_over(aux, [stage]) / m
    data_axes = [_axis(mesh, a) for a in _spec_axes((x_spec or (None,))[0])]
    if data_axes:
        aux = _sum_over(aux, data_axes) / n_data
    return y, aux


def psum_grads(params: list[torch.Tensor], mesh: Any, axes: list[str]) -> None:
    """Sum each tensor's ``.grad`` (zeros where this rank has none) over
    the mesh ``axes`` in rank order, in place: one flat fp32 buffer."""
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      .to(torch.float32) for p in params])
    for name in axes:
        flat = psum(flat, _axis(mesh, name))
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view(p.shape).to(p.dtype)
        off += n


# -- per-microbatch gradient taps -------------------------------------------------


class _Tap(torch.autograd.Function):
    """``p`` unchanged; its gradient is kept by ``taps`` under ``(name,
    microbatch)`` instead of accumulating into ``p.grad``."""

    @staticmethod
    def forward(ctx, p, taps, name, mb):
        ctx.taps, ctx.name, ctx.mb = taps, name, mb
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        ctx.taps.add(ctx.name, ctx.mb, g)
        return None, None, None, None


class GradTaps:
    """The gradients of a pipelined model's parameters, one per use and
    microbatch. :meth:`reduce` makes them each parameter's ``.grad``:
    the uses folded in ascending microbatch order (whatever order the
    schedule ran them in), then summed in rank order over the axes."""

    def __init__(self):
        self.got: dict[str, dict[int, torch.Tensor]] = {}

    def tap(self, name: str, p: torch.Tensor, mb: int) -> torch.Tensor:
        if not (torch.is_grad_enabled() and p.requires_grad):
            return p
        return _Tap.apply(p, self, name, mb)

    def add(self, name: str, mb: int, g: torch.Tensor) -> None:
        d = self.got.setdefault(name, {})
        d[mb] = g if mb not in d else d[mb] + g

    def reduce(self, model: nn.Module, mesh: Any, axes_of: Callable[[str], list[str]]) -> None:
        """Set every parameter's ``.grad``: its taps folded in microbatch
        order (zeros where this rank used it not at all), summed over
        ``axes_of(name)`` of ``mesh`` in rank order; groups of
        parameters that share their axes sum as one flat buffer."""
        groups: dict[tuple, list[tuple[str, torch.Tensor]]] = {}
        for name, p in model.named_parameters():
            groups.setdefault(tuple(axes_of(name)), []).append((name, p))
        for axes, members in groups.items():
            for name, p in members:
                taps = self.got.get(name)
                if not taps:
                    p.grad = None
                    continue
                acc = None
                for mb in sorted(taps):
                    acc = taps[mb] if acc is None else acc + taps[mb]
                p.grad = acc
            psum_grads([p for _, p in members], mesh, list(axes))
        self.got.clear()


# -- the LM through the pipeline ---------------------------------------------------


def _meta_block(model, *, moe: bool, attention_impl: str, mesh: Any, seq_axis: str,
                batch_axis: Any, tp_axis: Any, tp_shards: int, expert_axis: Any,
                expert_shards: int):
    """A parameterless (meta) block of ``model``'s widths for
    ``functional_call`` with the dense model's (sliced) parameters."""
    from hops_tpu_torch.models.moe import MoEBlock
    from hops_tpu_torch.models.transformer import Block

    cfg = model.config
    kw = dict(dtype=model.dtype, param_dtype=model.param_dtype, device="meta",
              dropout_rate=0.0, attention_impl=attention_impl,
              num_kv_heads=cfg["num_kv_heads"], window=cfg["window"], mesh=mesh,
              seq_axis=seq_axis, batch_axis=batch_axis)
    if moe:
        return MoEBlock(cfg["d_model"], cfg["num_heads"], num_experts=cfg["num_experts"],
                        top_k=cfg["moe_top_k"], expert_axis=expert_axis,
                        expert_shards=expert_shards, **kw)
    tp = dict(tp_axis=tp_axis, tp_shards=tp_shards) if tp_axis is not None else {}
    return Block(cfg["d_model"], cfg["num_heads"], **kw, **tp)


class _LMStages:
    """A dense ``TransformerLM`` cut into ``S * v`` virtual stages for this
    rank: its parameters, tapped per microbatch and sliced to this
    rank's tensor or expert shard, run through meta blocks with
    ``torch.func.functional_call``."""

    def __init__(self, model, mesh, axis: str, *, v: int = 1, seq_axis=None, expert_axis=None,
                 batch_axis=None, tp_axis=None, taps: GradTaps | None = None):
        from hops_tpu_torch.models.transformer import Dense, RMSNorm

        if seq_axis and model.moe_every:
            raise NotImplementedError(
                "seq_axis inside pp is supported for dense LMs; MoE models compose pp with "
                "expert_axis instead (per-microbatch routing over a sharded sequence would "
                "change drop semantics)")
        if expert_axis and not model.moe_every:
            raise ValueError("expert_axis requires a MoE model (moe_every > 0)")
        if tp_axis and model.moe_every:
            raise NotImplementedError(
                "tp_axis inside pp is supported for dense LMs; MoE models compose pp with "
                "expert_axis instead")
        cfg = model.config
        self.model, self.mesh, self.taps = model, mesh, taps
        self.stage = _axis(mesh, axis)
        self.S, self.v = self.stage.size, v
        V = self.S * v
        L = cfg["num_layers"]
        g = model.moe_every or 1
        if L % g:
            raise ValueError(f"{L} layers not divisible by moe_every={g}")
        if (L // g) % V:
            what = "layers" if g == 1 else f"groups of {g} layers"
            raise ValueError(f"{L // g} {what} not divisible by {V} virtual stages "
                             f"({self.S} stages x {v} chunks)")
        self.K = L // V
        self.tp = _axis(mesh, tp_axis) if tp_axis else None
        self.ep = _axis(mesh, expert_axis) if expert_axis else None
        self.data_axes = [a for a in (batch_axis, seq_axis) if a]
        self.axis_names = dict(stage=axis, tp=tp_axis, ep=expert_axis)
        common = dict(attention_impl="ring_local" if seq_axis else cfg["attention_impl"],
                      mesh=mesh if (seq_axis or tp_axis) else None, seq_axis=seq_axis or "seq",
                      batch_axis=batch_axis, tp_axis=tp_axis,
                      tp_shards=self.tp.size if self.tp else 1,
                      expert_axis=self.ep, expert_shards=self.ep.size if self.ep else 1)
        self.dense = _meta_block(model, moe=False, **common)
        self.moe = _meta_block(model, moe=True, **common) if model.moe_every else None
        self.norm = RMSNorm(cfg["d_model"], model.dtype, "meta")
        self.unembed = Dense(cfg["d_model"], (cfg["vocab_size"],), model.dtype,
                             model.param_dtype, "meta")
        self.params = dict(model.named_parameters())

    def axes_of(self, name: str) -> list[str]:
        """The mesh axes a parameter's gradient sums over."""
        axes = [self.axis_names["stage"], *self.data_axes]
        if self.tp is not None and tp_shard_dim(name) is not None:
            axes.append(self.axis_names["tp"])
        if self.ep is not None and name.rsplit(".", 1)[-1] in ("w_in", "w_out"):
            axes.append(self.axis_names["ep"])
        return axes

    def param(self, name: str, mb: int) -> torch.Tensor:
        p = self.params[name]
        if self.taps is not None:
            p = self.taps.tap(name, p, mb)
        if self.tp is not None:
            d = tp_shard_dim(name)
            if d is not None:
                per = p.shape[d] // self.tp.size
                p = p.narrow(d, self.tp.index * per, per)
        if self.ep is not None and name.rsplit(".", 1)[-1] in ("w_in", "w_out"):
            per = p.shape[0] // self.ep.size
            p = p.narrow(0, self.ep.index * per, per)
        return p

    def _call(self, module, prefix: str, mb: int, *args):
        prm = {n: self.param(f"{prefix}.{n}", mb) for n, _ in module.named_parameters()}
        return torch.func.functional_call(module, prm, args)

    def layers(self, chunk: int) -> range:
        """The layers of this rank's ``chunk`` (virtual stage ``chunk * S + s``)."""
        vs = chunk * self.S + self.stage.index
        return range(vs * self.K, (vs + 1) * self.K)

    def run_chunk(self, chunk: int, h: torch.Tensor, mb: int) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``chunk`` of blocks on ``h``: (h, its MoE aux sum)."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        g = self.model.moe_every
        for i in self.layers(chunk):
            if g and (i + 1) % g == 0:
                h = self._call(self.moe, f"block_{i}", mb, h)
                aux = aux + self.moe.moe.aux_loss
            else:
                h = self._call(self.dense, f"block_{i}", mb, h)
        return h, aux

    def ingest(self, tokens: torch.Tensor, mb: int) -> torch.Tensor:
        table = self.param("embed.embedding", mb)
        return nn.functional.embedding(tokens, table).to(self.model.dtype)

    def logits(self, h: torch.Tensor, mb: int) -> torch.Tensor:
        x = self._call(self.norm, "final_norm", mb, h)
        return self._call(self.unembed, "unembed", mb, x).to(torch.float32)


def _lm_specs(seq_axis, batch_axis):
    return (batch_axis, seq_axis) if (seq_axis or batch_axis) else None


def _micro(x: torch.Tensor, m: int) -> list[torch.Tensor]:
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} microbatches")
    return list(x.reshape(m, x.shape[0] // m, *x.shape[1:]))


def _lm_ring(stages: _LMStages, tokens: torch.Tensor, m: int, emit: Callable, out_shape,
             out_dtype):
    model = stages.model
    micro = _micro(tokens, m)
    act = ((micro[0].shape[0], micro[0].shape[1], model.config["d_model"]), model.dtype)
    return _ring(lambda h, j: stages.run_chunk(0, h, j), micro, stages.stage,
                 ingest=stages.ingest, emit=emit, act=act, out_shape=out_shape,
                 out_dtype=out_dtype, device=tokens.device, stage_aux=bool(model.moe_every))


def _aux_total(stages: _LMStages, aux: torch.Tensor, m: int, mesh, batch_axis) -> torch.Tensor:
    aux = _sum_over(aux, [stages.stage]) / m
    if batch_axis:
        ax = _axis(mesh, batch_axis)
        aux = _sum_over(aux, [ax]) / ax.size
    return aux


def pipelined_lm_apply(
    model: Any,
    tokens: Any,
    mesh: Any,
    *,
    axis: str = "stage",
    num_microbatches: int | None = None,
    return_aux: bool = False,
    seq_axis: str | None = None,
    expert_axis: str | None = None,
    batch_axis: str | None = None,
    tp_axis: str | None = None,
    taps: GradTaps | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Run a dense ``TransformerLM``'s forward through the GPipe ring:
    logits ``(batch, seq, vocab)`` fp32 on every rank, equal to
    ``model(tokens)`` up to float rounding. ``model`` holds the dense
    weights (the same on every rank); the embed is stage 0's ingest, the
    final norm and unembed the last stage's emit, and the L blocks split
    into S chunks of L/S.

    MoE models (``moe_every > 0``) pipeline in groups of ``moe_every``
    layers; routing runs per microbatch, so whole-batch parity holds for
    drop-free routing only. Inner compositions as in JAX: ``seq_axis``
    (ring attention inside the stages; dense models), ``expert_axis``
    (each rank its experts), ``tp_axis`` (Megatron inside the stages;
    dense models) and ``batch_axis`` (one ring per data coordinate).
    ``return_aux=True`` returns ``(logits, aux)``, the load-balancing
    loss summed over layers and averaged over microbatches.

    ``taps`` (a :class:`GradTaps`) collects the parameters' gradients
    of a later backward; :meth:`GradTaps.reduce` with
    ``pipeline_grad_axes`` turns them into the replicated ``.grad``.
    """
    stages = _LMStages(model, mesh, axis, seq_axis=seq_axis, expert_axis=expert_axis,
                       batch_axis=batch_axis, tp_axis=tp_axis, taps=taps)
    m = num_microbatches or stages.S
    spec = _lm_specs(seq_axis, batch_axis)
    tok = _cut(torch.as_tensor(tokens).to(model.device, torch.long), spec, mesh)
    out_shape = (tok.shape[0], tok.shape[1], model.config["vocab_size"])

    def emit(outs):
        return torch.cat([stages.logits(h, j) for j, h in enumerate(outs)])

    logits, aux = _lm_ring(stages, tok, m, emit, out_shape, torch.float32)
    logits = _join(logits, spec, mesh)
    if not return_aux:
        return logits
    return logits, _aux_total(stages, aux, m, mesh, batch_axis)


def pipeline_grad_axes(model: Any, mesh: Any, *, axis: str = "stage", seq_axis=None,
                       expert_axis=None, batch_axis=None, tp_axis=None) -> Callable[[str], list]:
    """``axes_of(name)`` for :meth:`GradTaps.reduce` after a backward
    through :func:`pipelined_lm_apply` with the same arguments."""
    return _LMStages(model, mesh, axis, seq_axis=seq_axis, expert_axis=expert_axis,
                     batch_axis=batch_axis, tp_axis=tp_axis).axes_of


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    from hops_tpu_torch.models.common import cross_entropy_loss

    return cross_entropy_loss(logits, targets)


def _ring_loss(stages: _LMStages, inputs, targets, m: int, mesh, seq_axis, batch_axis):
    """The autodiff ring's loss: each microbatch's cross-entropy on the
    last stage as its output arrives, ``sum_j loss_j / m`` in ascending
    order (as the explicit schedules add them), handed to every stage and
    averaged over the data axes. Returns (loss, aux)."""
    spec = _lm_specs(seq_axis, batch_axis)
    tok = _cut(inputs, spec, mesh)
    tgt = _micro(_cut(targets, spec, mesh), m)

    def emit(outs):
        total = None
        for j, h in enumerate(outs):
            loss = _ce(stages.logits(h, j), tgt[j]) / m
            total = loss if total is None else total + loss
        return total

    loss, aux = _lm_ring(stages, tok, m, emit, (), torch.float32)
    data = [_axis(mesh, a) for a in (batch_axis, seq_axis) if a]
    if data:
        n = math.prod(a.size for a in data)
        loss = _sum_over(loss, data) / n
    aux = _aux_total(stages, aux, m, mesh, batch_axis) if stages.model.moe_every else 0.0
    return loss, aux


def _scheduled_loss(stages: _LMStages, sched: Any, inputs, targets) -> torch.Tensor:
    """The explicit tick program (the JAX package's
    ``_scheduled_lm_loss_and_grads``) on this rank: per tick at most one
    forward and one backward slot, activations and cotangents one hop
    down/up the rotated ring. Gradients go to ``stages.taps``; returns
    the loss on every rank."""
    S, v, m = sched.n_stages, sched.v, sched.num_microbatches
    V = S * v
    s = stages.stage.index
    axis = stages.stage
    model = stages.model
    micro_tok, micro_tgt = _micro(inputs, m), _micro(targets, m)
    act_shape = (micro_tok[0].shape[0], micro_tok[0].shape[1], model.config["d_model"])
    dev = inputs.device
    acts: dict[tuple[int, int], torch.Tensor] = {}
    outs: dict[tuple[int, int], torch.Tensor] = {}
    cts: dict[tuple[int, int], torch.Tensor] = {}
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    fwd_in = bwd_in = None
    for t in range(sched.ticks):
        # 1. store what last tick's hop delivered
        if fwd_in is not None:
            acts[(int(sched.in_f_chunk[t][s]), int(sched.in_f_mb[t][s]))] = \
                fwd_in.requires_grad_()
        if bwd_in is not None:
            cts[(int(sched.in_b_chunk[t][s]), int(sched.in_b_mb[t][s]))] = bwd_in
        fwd_msg = bwd_msg = None
        # 2. forward slot
        c, mb = int(sched.f_chunk[t][s]), int(sched.f_mb[t][s])
        if c >= 0:
            vs = c * S + s
            if vs == 0:
                with torch.no_grad():
                    acts[(c, mb)] = stages.ingest(micro_tok[mb], mb).requires_grad_()
            h_out, _ = stages.run_chunk(c, acts[(c, mb)], mb)
            outs[(c, mb)] = h_out
            if vs == V - 1:
                h_leaf = h_out.detach().requires_grad_()
                loss_mb = _ce(stages.logits(h_leaf, mb), micro_tgt[mb])
                torch.autograd.backward(loss_mb, torch.full_like(loss_mb, 1.0 / m))
                loss_acc = loss_acc + loss_mb.detach() / m
                cts[(c, mb)] = h_leaf.grad
            fwd_msg = h_out.detach()
        # 3. backward slot
        c, mb = int(sched.b_chunk[t][s]), int(sched.b_mb[t][s])
        if c >= 0:
            x_in = acts.pop((c, mb))
            torch.autograd.backward(outs.pop((c, mb)), cts.pop((c, mb)))
            if c * S + s == 0:
                emb = stages.ingest(micro_tok[mb], mb)
                torch.autograd.backward(emb, x_in.grad.to(emb.dtype))
            else:
                bwd_msg = x_in.grad
        # 4. one ring hop each way, as the next tick's tables expect
        fwd_in, bwd_in = _tick_exchange(sched, t, axis, fwd_msg, bwd_msg, act_shape,
                                        model.dtype, dev)
    return fold_sum(loss_acc, axis)


def _tick_exchange(sched, t: int, axis: Axis, fwd_msg, bwd_msg, shape, dtype, dev):
    """The messages of tick ``t``: forward to ``s + 1``, backward to
    ``s - 1`` (both mod S), each sent only where the next tick's
    incoming table expects it, in one ``batch_isend_irecv``."""
    S, s = axis.size, axis.index
    if t + 1 >= sched.ticks or S == 1:
        return None, None
    nxt, prv = (s + 1) % S, (s - 1) % S
    host = dev.type == "cuda" and dist.get_backend(axis.group) == "gloo"
    buf_dev = "cpu" if host else dev
    ops, recv = [], {}
    for msg, peer, expect_at, tag in ((fwd_msg, nxt, sched.in_f_chunk, 1),
                                      (bwd_msg, prv, sched.in_b_chunk, 2)):
        if expect_at[t + 1][peer] >= 0:
            src = msg.contiguous()
            if host:
                src = src.cpu()
                count_host_bytes(src.nbytes)
            recv.setdefault("keep", []).append(src)
            ops.append(dist.P2POp(dist.isend, src, axis.ranks[peer], axis.group, tag))
    for key, peer, table, tag in (("f", prv, sched.in_f_chunk, 1),
                                  ("b", nxt, sched.in_b_chunk, 2)):
        if table[t + 1][s] >= 0:
            recv[key] = torch.empty(shape, dtype=dtype, device=buf_dev)
            ops.append(dist.P2POp(dist.irecv, recv[key], axis.ranks[peer], axis.group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    got = []
    for key in ("f", "b"):
        x = recv.get(key)
        if x is not None and host:
            count_host_bytes(x.nbytes)
            x = x.to(dev)
        got.append(x)
    return tuple(got)


def make_pp_lm_train_step(
    model: Any,
    mesh: Any,
    *,
    axis: str = "stage",
    seq_axis: str | None = None,
    expert_axis: str | None = None,
    batch_axis: str | None = None,
    tp_axis: str | None = None,
    num_microbatches: int | None = None,
    aux_loss_weight: float = 0.01,
    schedule: str | None = None,
    virtual_stages: int | None = None,
) -> Callable[[Any, dict[str, Any]], tuple[Any, dict[str, torch.Tensor]]]:
    """Pipelined next-token-prediction train step for a ``TransformerLM``:
    the ``step(state, batch) -> (state, metrics)`` contract of
    ``models.transformer.make_lm_train_step`` (inputs ``tokens[:, :-1]``,
    targets ``tokens[:, 1:]``, the same global batch on every rank), with
    the forward and backward through the pipeline and optionally sp
    (``seq_axis``), ep (``expert_axis``), tp (``tp_axis``) or dp
    (``batch_axis``) composed inside. ``state.model`` is the dense
    model, replicated; every rank applies the same optimizer update to
    the same summed gradients (:class:`GradTaps`).

    ``schedule=None`` differentiates through the fill-drain ring.
    ``"gpipe" | "1f1b" | "interleaved"`` runs the explicit tick program
    of :mod:`~hops_tpu_torch.parallel.pp_schedule` (``virtual_stages``
    chunks per rank for ``interleaved``, default 2); explicit schedules
    run dense models on a pure ``stage`` mesh. Every schedule, and the
    ring, give bit-identical losses and gradients. The factory sets
    ``hops_tpu_pp_bubble_fraction{schedule}``; wrap the step with
    :func:`instrument_pp_step` for per-microbatch wall time.
    """
    sched = _check_schedule(model, mesh, axis, schedule, num_microbatches, virtual_stages,
                            seq_axis, expert_axis, batch_axis, tp_axis)
    if sched is not None:
        _register_pp_schedule_telemetry(sched)

    def train_step(state, batch):
        model_ = state.model
        state.optimizer.zero_grad(set_to_none=True)
        loss = lm_loss_and_grads(
            model_, batch["tokens"], mesh, axis=axis, seq_axis=seq_axis,
            expert_axis=expert_axis, batch_axis=batch_axis, tp_axis=tp_axis,
            num_microbatches=num_microbatches, aux_loss_weight=aux_loss_weight, sched=sched)
        state.optimizer.step()
        state = dataclasses.replace(state, step=state.step + 1)
        return state, {"loss": loss, "perplexity": torch.exp(loss)}

    if sched is not None:
        train_step.pp_schedule = sched
    return train_step


def _check_schedule(model, mesh, axis, schedule, num_microbatches, virtual_stages, *inner):
    """The explicit schedule's tables (None for the ring), after the JAX
    factory's refusals and the layer split's check."""
    if schedule is None:
        return None
    if any(inner):
        raise NotImplementedError(
            "explicit schedules (gpipe/1f1b/interleaved) run on a pure stage mesh; "
            "inner-axis compositions use the autodiff ring (schedule=None)")
    if model.moe_every:
        raise NotImplementedError(
            "explicit pipeline schedules support dense TransformerLMs; MoE pipelines use "
            "the autodiff ring (schedule=None)")
    from hops_tpu_torch.parallel.pp_schedule import build_pp_schedule

    m = num_microbatches or mesh.shape[axis]
    sched = build_pp_schedule(schedule, m, mesh.shape[axis], virtual_stages)
    _LMStages(model, mesh, axis, v=sched.v)  # the layer split, checked now
    return sched


def lm_loss_and_grads(
    model: Any,
    tokens: Any,
    mesh: Any,
    *,
    axis: str = "stage",
    seq_axis: str | None = None,
    expert_axis: str | None = None,
    batch_axis: str | None = None,
    tp_axis: str | None = None,
    num_microbatches: int | None = None,
    aux_loss_weight: float = 0.01,
    schedule: str | None = None,
    virtual_stages: int | None = None,
    sched: Any = None,
) -> torch.Tensor:
    """The pipelined next-token loss of ``tokens`` (inputs ``[:, :-1]``,
    targets ``[:, 1:]``) on every rank, with every parameter's replicated
    gradient in its ``.grad`` (the JAX package's
    ``_scheduled_lm_loss_and_grads`` for the explicit schedules, the
    autodiff ring's value and gradient otherwise). The loss is the
    cross-entropy alone; MoE aux losses join the differentiated one at
    ``aux_loss_weight``."""
    if sched is None:
        sched = _check_schedule(model, mesh, axis, schedule, num_microbatches,
                                virtual_stages, seq_axis, expert_axis, batch_axis, tp_axis)
    tokens = torch.as_tensor(tokens).to(model.device, torch.long)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    taps = GradTaps()
    if sched is not None:
        stages = _LMStages(model, mesh, axis, v=sched.v, taps=taps)
        loss = _scheduled_loss(stages, sched, inputs, targets)
    else:
        stages = _LMStages(model, mesh, axis, seq_axis=seq_axis, expert_axis=expert_axis,
                           batch_axis=batch_axis, tp_axis=tp_axis, taps=taps)
        m = num_microbatches or stages.S
        loss, aux = _ring_loss(stages, inputs, targets, m, mesh, seq_axis, batch_axis)
        (loss + aux_loss_weight * aux if model.moe_every else loss).backward()
    taps.reduce(model, mesh, stages.axes_of)
    return loss.detach()


def _register_pp_schedule_telemetry(sched: Any) -> None:
    """Publish the schedule's static bubble model (host side, once per
    factory call)."""
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    REGISTRY.gauge(
        "hops_tpu_pp_bubble_fraction",
        "Idle fraction of pipeline work slots for the built schedule",
        labels=("schedule",),
    ).set(sched.bubble_fraction, schedule=sched.kind)


def instrument_pp_step(step_fn: Callable[..., Any], sched: Any | None = None
                       ) -> Callable[..., Any]:
    """Wrap a scheduled pipeline step with host-side per-microbatch
    timing: each call's wall time (to its loss read back) divided by the
    schedule's microbatch count feeds
    ``hops_tpu_pp_microbatch_seconds{schedule=...}``."""
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    sched = sched if sched is not None else getattr(step_fn, "pp_schedule", None)
    if sched is None:
        raise ValueError("instrument_pp_step needs the step's PipelineSchedule (build the "
                         "step with make_pp_lm_train_step(schedule=...))")
    hist = REGISTRY.histogram(
        "hops_tpu_pp_microbatch_seconds",
        "Wall time per microbatch of a scheduled pipeline train step",
        labels=("schedule",),
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5),
    )

    def timed(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        float(out[1]["loss"])  # the step's work is done once its loss is read back
        hist.observe((time.perf_counter() - t0) / sched.num_microbatches,
                     schedule=sched.kind)
        return out

    timed.pp_schedule = sched
    return timed
