"""Sequence parallelism: ring attention and Ulysses all-to-all
(counterpart of ``hops_tpu/parallel/ringattention.py``).

The JAX package writes both as ``shard_map`` programs over a ``seq`` mesh
axis. The port runs one process per rank. The global-shaped entry
points take the same global tensors on every rank, cut this rank's
chunk out (batch rows on ``batch_axis``, sequence on ``axis``), run the
per-rank body and gather the chunks back. The cut's backward gathers
the chunks' gradients and the gather's backward keeps this rank's
chunk, so every rank ends with the full gradient, as the replicated
program has it. :class:`SeqShard` does the same for a whole LM: it cuts
the activations once, the blocks run the per-rank bodies on them, and
their parameters' gradients are summed over the blocks.

- **Ring attention** (:func:`ring_attention_local`): Q stays put; K/V
  chunks rotate one hop per step (``batch_isend_irecv`` to rank + 1 and
  from rank - 1 on the seq group, an ``autograd.Function`` whose
  backward sends the gradient the other way) while each rank folds the
  incoming chunk into online-softmax accumulators in fp32. Autograd
  differentiates the fold itself.
- **Ulysses** (:func:`ulysses_attention`): two all-to-alls reshard
  (seq-sharded, all heads) → (head-sharded, full seq), run
  :func:`~hops_tpu_torch.ops.attention.flash_attention` locally (the K1
  forward and K2/K3 backward kernels on the card) and reshard back.

Axes are a :class:`~hops_tpu_torch.parallel.mesh.Mesh`'s named axes;
every rank creates the process groups of an axis's lines the first time
it is used (in the same order on every rank).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from hops_tpu_torch.ops.attention import (
    NEG_INF,
    attention_reference,
    flash_attention,
    repeat_kv,
)
from hops_tpu_torch.parallel.grad_comms import (
    Axis,
    _axis,
    _exchange,
    count_host_bytes,
    gather_stack,
    via_host,
)


def axis_group(mesh: Any, axis: str) -> Axis:
    """This rank's line of ``mesh`` along ``axis`` (the ranks that differ
    only in that coordinate) as a :class:`~hops_tpu_torch.parallel.grad_comms.Axis`.
    The first call creates every line's process group, on every rank of
    the mesh in the same order; later calls reuse them."""
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    got = cache.get(axis)
    if got is None:
        size = mesh.shape[axis]
        if size == 1:
            got = Axis(None, (dist.get_rank() if dist.is_initialized() else 0,))
        elif not dist.is_initialized():
            raise RuntimeError(f"axis {axis!r} of {mesh.shape} needs a process group: join one "
                               "with multihost.initialize or run under python -m "
                               "hops_tpu_torch.launch")
        else:
            d = mesh.axis_names.index(axis)
            lines = np.moveaxis(mesh.devices, d, -1).reshape(-1, size).tolist()
            group, _ = dist.new_subgroups_by_enumeration(lines)
            got = Axis(group, tuple(dist.get_process_group_ranks(group)))
        cache[axis] = got
    return got


def _local_scores(q, k, sm_scale, q_offset, k_offset, causal, window=None,
                  s_q: int | None = None):
    """(bh, rows, sk) masked scores for one ring step, fp32. ``s_q``: the
    per-rank query length when GQA query-head groups are folded into the
    row dim (row r holds chunk position r % s_q)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s_q = s_q or q.shape[2]
        rows = torch.arange(q.shape[2], device=q.device)
        q_pos = q_offset + (rows % s_q)[:, None]
        k_pos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        visible = q_pos >= k_pos
        if window is not None:
            visible &= q_pos - k_pos < window
        s = torch.where(visible, s, NEG_INF)
    return s


def _fold(carry, s, v):
    """Fold one chunk's scores/values into online-softmax accumulators."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    alpha = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - m_safe))
    l = l * alpha + p.sum(dim=-1)
    # p rounds to v's dtype (bf16 in training), the product accumulates in fp32.
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    acc = acc * alpha[..., None] + pv
    return m_new, l, acc


def _shift(x: torch.Tensor, axis: Axis, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places ahead on ``axis`` and
    receive from the rank ``step`` places behind (through host buffers
    on a gloo group, ``grad_comms.via_host``)."""
    n, i = axis.size, axis.index
    x = x.contiguous()
    host = via_host(x, axis.group)
    src = x.cpu() if host else x
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, axis.ranks[(i + step) % n], axis.group),
           dist.P2POp(dist.irecv, out, axis.ranks[(i - step) % n], axis.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if host:
        count_host_bytes(2 * src.nbytes)
        return out.to(x.device)
    return out


class _Rotate(torch.autograd.Function):
    """One hop of the ring: rank i's chunk moves to rank i + 1; the
    gradient moves back to rank i - 1."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _shift(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -1), None


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis: Any = "seq",
    batch_axis: Any = None,
    causal: bool = False,
    sm_scale: float | None = None,
    window: int | None = None,
    ring_size: int | None = None,
) -> torch.Tensor:
    """The per-rank body of ring attention over this rank's ``(batch,
    heads, seq/ring_size, d)`` chunks. ``axis`` is the ring: an
    :class:`~hops_tpu_torch.parallel.grad_comms.Axis`, a process group,
    or a name bound by ``grad_comms.bind_axis``. GQA: ``k``/``v`` may
    carry fewer heads than ``q``; the un-repeated kv heads rotate and the
    query-head groups fold into the row dim. A chunk wholly outside a
    causal window's band still rotates but is not folded."""
    del batch_axis  # the batch split needs no collective inside the ring
    ring = _axis(axis)
    n = ring.size
    if ring_size is not None and ring_size != n:
        raise ValueError(f"ring_size {ring_size} != {n} ranks on the ring")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, seq_local, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"{h} query heads not divisible by {hkv} kv heads")
    g = h // hkv
    if g > 1:
        q = q.reshape(b, hkv, g * seq_local, d)  # row r = group * s + pos
    my_idx = ring.index
    q32 = q.float()
    rows = q.shape[:3]
    m = torch.full(rows, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    q_offset = my_idx * seq_local
    k_cur, v_cur = k, v
    for t in range(n):
        k_start = ((my_idx - t) % n) * seq_local
        relevant = not (causal and window is not None) or (
            k_start <= q_offset + seq_local - 1
            and k_start + seq_local - 1 >= q_offset - (window - 1))
        if relevant:
            s = _local_scores(q32, k_cur, sm_scale, q_offset, k_start, causal, window,
                              s_q=seq_local)
            m, l, acc = _fold((m, l, acc), s, v_cur)
        if t + 1 < n:  # at step t every rank holds the chunk of rank (i - t) mod n
            k_cur, v_cur = _Rotate.apply(k_cur, ring), _Rotate.apply(v_cur, ring)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype)
    if n > 1:  # the last hop's chunk may lie outside this rank's band
        out = _Tie.apply(out, k_cur, v_cur)
    if g > 1:
        out = out.reshape(b, h, seq_local, d)
    return out


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``others`` in its graph at a zero gradient.
    A chunk that no rank folds after its last hop would leave that hop's
    backward unrun on some ranks and not others, and the hops' sends and
    receives would no longer pair up; tied to the output, every hop's
    backward runs on every rank."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.others))


class _Cut(torch.autograd.Function):
    """This rank's block of a replicated tensor: ``dim``'s chunk by its
    index on ``axis``. The backward gathers every rank's chunk gradient,
    so the replicated input gets the full gradient on every rank."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return x.chunk(axis.size, dim)[axis.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.axis, ctx.dim), None, None


class _Join(torch.autograd.Function):
    """The replicated tensor from every rank's block along ``dim``; the
    backward keeps this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.index].contiguous(), None, None


def _gather_dim(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    if axis.size == 1:
        return x
    return torch.cat(list(gather_stack(x, axis)), dim)


class _SumGrad(torch.autograd.Function):
    """Identity on a replicated parameter used on this rank's block of
    the activations; the backward sums its gradient over the blocks'
    axes, so every rank holds the full gradient."""

    @staticmethod
    def forward(ctx, p, axes):
        ctx.axes = axes
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        from hops_tpu_torch.parallel.grad_comms import psum

        for ax in ctx.axes:
            g = psum(g, ax)
        return g, None


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """How an LM's ``(batch, seq, d)`` activations split over a mesh:
    batch rows over ``batch`` (dim 0, when set) and the sequence over
    ``seq`` (dim 1). The LM cuts its embedded tokens once, runs its
    blocks on this rank's block and joins before the final norm, so the
    work outside attention splits too (a replicated JAX program's
    ``shard_map`` specs let XLA do the same)."""

    seq: Axis
    batch: Axis | None = None

    @property
    def cuts(self) -> list[tuple[Axis, int]]:
        return ([(self.batch, 0)] if self.batch is not None else []) + [(self.seq, 1)]

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of replicated ``x`` (the cut's backward
        gathers the blocks' gradients)."""
        for ax, dim in self.cuts:
            if x.shape[dim] % ax.size:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                                 f"{ax.size} ranks")
            x = _Cut.apply(x, ax, dim)
        return x

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """The replicated tensor from every rank's block."""
        for ax, dim in reversed(self.cuts):
            x = _Join.apply(x, ax, dim)
        return x

    def block_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a tensor every rank computed in full
        (no autograd: a dropout mask)."""
        for ax, dim in self.cuts:
            full = full.chunk(ax.size, dim)[ax.index]
        return full

    def full_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        out = list(shape)
        for ax, dim in self.cuts:
            out[dim] *= ax.size
        return tuple(out)

    def summed(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` for use on this rank's block: its gradient is summed
        over the blocks in backward."""
        axes = [ax for ax, _ in self.cuts if ax.size > 1]
        return _SumGrad.apply(p, axes) if axes else p


def seq_shard(mesh: Any, seq_axis: str, batch_axis: str | None = None) -> SeqShard:
    """The :class:`SeqShard` of ``mesh``'s ``seq_axis`` (and ``batch_axis``)."""
    return SeqShard(axis_group(mesh, seq_axis),
                    axis_group(mesh, batch_axis) if batch_axis is not None else None)


def _sharded(fn, q, k, v, mesh, axis: str, batch_axis: str | None):
    """Run ``fn(q, k, v, seq_axis)`` on this rank's (batch, seq) block of
    global ``(batch, heads, seq, d)`` tensors and join the blocks."""
    seq = axis_group(mesh, axis)
    cuts = [(seq, 2)]
    if batch_axis is not None:
        cuts.insert(0, (axis_group(mesh, batch_axis), 0))
    for ax, dim in cuts:
        if q.shape[dim] % ax.size:
            raise ValueError(f"dim {dim} of {tuple(q.shape)} does not split over {ax.size} ranks")
        q, k, v = (_Cut.apply(t, ax, dim) for t in (q, k, v))
    out = fn(q, k, v, seq)
    for ax, dim in reversed(cuts):
        out = _Join.apply(out, ax, dim)
    return out


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    *,
    axis: str = "seq",
    batch_axis: str | None = None,
    causal: bool = False,
    sm_scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Ring attention over global ``(batch, heads, seq, d)`` tensors on
    ``mesh`` (batch split over ``batch_axis``, sequence over ``axis``):
    :func:`ring_attention_local` on this rank's block, the blocks
    joined."""
    def local(q, k, v, seq):
        return ring_attention_local(q, k, v, axis=seq, causal=causal, sm_scale=sm_scale,
                                    window=window)

    return _sharded(local, q, k, v, mesh, axis, batch_axis)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks of the leading dim; with
    equal chunks the transpose is the same exchange."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.axis), None


def _seq_to_heads(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(b, H, s/n, d) → (b, H/n, s, d): scatter heads, gather sequence."""
    n = axis.size
    if n == 1:
        return x
    b, h, s, d = x.shape
    chunks = x.reshape(b, n, h // n, s, d).movedim(1, 0)  # [j]: head group j
    got = _AllToAll.apply(chunks, axis)  # [i]: rank i's sequence chunk
    return got.movedim(0, 2).reshape(b, h // n, n * s, d)


def _heads_to_seq(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(b, H/n, s, d) → (b, H, s/n, d): the inverse reshard."""
    n = axis.size
    if n == 1:
        return x
    b, hl, s, d = x.shape
    chunks = x.reshape(b, hl, n, s // n, d).movedim(2, 0)  # [j]: sequence chunk j
    got = _AllToAll.apply(chunks, axis)  # [i]: rank i's head group
    return got.movedim(0, 1).reshape(b, n * hl, s // n, d)


def ulysses_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis: Any = "seq",
    causal: bool = False,
    sm_scale: float | None = None,
    window: int | None = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """The per-rank body of Ulysses over this rank's ``(batch, heads,
    seq/n, d)`` chunks: an all-to-all to a head group over the full
    sequence, attention (``flash_attention``, or the plain version with
    ``use_flash=False``), and the all-to-all back. GQA: kv heads
    divisible by the ring ride the all-to-alls un-repeated and repeat
    after; otherwise they repeat before."""
    seq = _axis(axis)
    n = seq.size
    if q.shape[1] % n:
        raise ValueError(f"heads {q.shape[1]} not divisible by {n} ranks on the seq axis")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{q.shape[1]} query heads not divisible by {k.shape[1]} kv heads")
    if k.shape[1] % n:
        k, v = repeat_kv(q, k, v)
    q, k, v = (_seq_to_heads(t, seq) for t in (q, k, v))
    k, v = repeat_kv(q, k, v)  # a no-op unless GQA kv heads crossed
    if use_flash:
        o = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
    else:
        o = _reference_local(q, k, v, causal, sm_scale, window)
    return _heads_to_seq(o, seq)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    *,
    axis: str = "seq",
    batch_axis: str | None = None,
    causal: bool = False,
    sm_scale: float | None = None,
    window: int | None = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism over global ``(batch,
    heads, seq, d)`` tensors: :func:`ulysses_attention_local` on this
    rank's block, the blocks joined. Needs ``heads %
    mesh.shape[axis] == 0``."""
    def local(q, k, v, seq):
        return ulysses_attention_local(q, k, v, axis=seq, causal=causal, sm_scale=sm_scale,
                                       window=window, use_flash=use_flash)

    return _sharded(local, q, k, v, mesh, axis, batch_axis)


def _reference_local(q, k, v, causal, sm_scale, window=None):
    return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
