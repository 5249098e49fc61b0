"""Gradient communication (counterpart of ``hops_tpu/parallel/grad_comms.py``).

The default data-parallel step (``Strategy.step`` without a config)
averages gradients through DDP. Passing a :class:`GradCommsConfig`
takes explicit control of that traffic instead, with the JAX package's
optimizations:

1. **Block-scaled quantized all-reduce** (:func:`psum_quantized`):
   gradients are quantized to int8 (one fp32 scale per ``block_size``
   elements) or cast to bf16 before each hop of the reduce-scatter +
   all-gather decomposition; the reduction accumulates in fp32. The wire
   is emulated as the JAX package emulates it on the CPU: a
   quantize→dequantize round trip at each of the two hops, fp32 bytes
   on the wire; :func:`wire_bytes` counts what the quantized blocks
   would weigh.
2. **ZeRO-1** (``update_sharding="cross_replica"``,
   :func:`sharded_apply_gradients`): reduce-scatter the bucketed
   gradients, run the optimizer on this rank's 1/N slice of the flat
   parameters and moments, all-gather the parameters.
3. **Bucketing** (:func:`flatten_buckets` / :func:`unflatten_buckets`).
4. **Overlap and ZeRO-2/3**: a post-accumulate-grad hook on each
   parameter launches its collective the moment backward produces the
   gradient (``overlap``: all-reduce; ``zero2``: reduce-scatter, only
   this rank's slice kept); ``zero3`` keeps parameters and moments
   1/N-sharded at rest (:func:`zero3_init`) and gathers each parameter
   in an ``autograd.Function`` whose backward is the reduce-scatter.
5. **Hierarchy** (``hierarchy=H`` hosts): intra-host all-to-all, one
   inter-host all-to-all, a local fold in global rank order.

Every floating reduction goes through ONE primitive, :func:`psum_scatter`:
an ``all_to_all_single`` of tiles followed by a local fold of the N
addends in rank order (the hierarchical schedule moves the same addends
to the same fold). gloo's and NCCL's own ``all_reduce`` promise no
summation order, and the order they use for an element depends on where
it sits in the buffer; folding in rank order makes a per-leaf reduction
(the overlap hooks) equal a per-bucket one bit for bit, and the
hierarchical path equal the flat one. All-gathers only move bytes.

Functions on tensors take the replica axis as ``axis_name``: a process
group (``None`` is the default group) or the name of the data axis that
``Strategy.step(fn, grad_comms=cfg)`` binds while ``fn`` runs
(:func:`bind_axis`). A world of one rank (no process group) has no wire:
every reduction returns its input.

State-level functions work on the port's
:class:`~hops_tpu_torch.models.common.TrainState` (a module and a
``torch.optim.Optimizer``). The sharded updates run a new instance of the
optimizer's class, with its hyperparameters, over flat 1-D shard
tensors laid out as the reference lays them out: per-dtype buckets for
ZeRO-1, per-parameter buffers padded to the replica count for ZeRO-2/3.
The persistent carriers (:func:`zero12_init`, :func:`zero3_init`) keep
that optimizer and its shards in ``state.shards``; :func:`zero12_unshard`
and :func:`zero3_unshard` give the replicated state back.

Telemetry: counters ``hops_tpu_grad_comms_bytes_pre_total`` /
``hops_tpu_grad_comms_bytes_post_total`` (label ``mode``), gauge
``hops_tpu_grad_comms_compression_ratio``, and
``span("grad_comms.all_reduce")`` around each step
(``grad_comms_all_reduce_seconds``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

#: Default bucket target: 4 MiB of gradient bytes per collective.
DEFAULT_BUCKET_BYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class GradCommsConfig:
    """Configuration for explicit gradient communication.

    Passing any config (even the default) to ``Strategy.step`` /
    ``make_train_step`` replaces DDP's gradient averaging with the
    explicit bucketed collectives of this module; ``quantize``,
    ``overlap`` and ``update_sharding`` select the optimizations.
    Frozen, so steps memoize per config.

    ``update_sharding`` picks the ZeRO stage of the weight update:
    ``"replicated"`` (stage 0), ``"cross_replica"`` (ZeRO-1),
    ``"zero2"`` (gradients reduce-scattered during backward) or
    ``"zero3"`` (parameters sharded at rest, :func:`zero3_init`).
    ``overlap=True`` (stage 0 only) launches each gradient's all-reduce
    from a backward hook. ``local_only=True`` runs the explicit path
    with no cross-replica reduction (a timing reference; training
    diverges per rank). ``hierarchy`` counts hosts: 0 is flat, >= 2
    reduces inside each host first and crosses hosts once per byte.
    """

    quantize: bool = False
    update_sharding: str = "replicated"  # replicated|cross_replica|zero2|zero3
    qdtype: Any = torch.int8  # int8 (block-scaled) or bfloat16 (cast-only)
    block_size: int = 256
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    overlap: bool = False
    local_only: bool = False
    hierarchy: int = 0

    def __post_init__(self):
        if self.update_sharding not in ("replicated", "cross_replica", "zero2", "zero3"):
            raise ValueError(
                "update_sharding must be one of 'replicated', 'cross_replica', 'zero2', "
                f"'zero3', got {self.update_sharding!r}")
        if self.overlap and self.update_sharding != "replicated":
            raise ValueError(
                "overlap=True applies to the replicated update only; zero2/zero3 overlap "
                "by construction and zero1 (cross_replica) reduce-scatters at update time")
        if self.local_only and (self.overlap or self.hierarchy
                                or self.update_sharding != "replicated"):
            raise ValueError("local_only is a bench timing reference; combine it with nothing")
        if self.qdtype not in (torch.int8, torch.bfloat16):
            raise ValueError(f"qdtype must be torch.int8 or torch.bfloat16, got {self.qdtype}")
        if self.hierarchy:
            if self.hierarchy < 2:
                raise ValueError(f"hierarchy counts hosts: 0 (flat) or >= 2, got {self.hierarchy}")
            if self.update_sharding == "zero3":
                raise ValueError(
                    "hierarchy composes with the replicated/zero1/zero2 updates; zero3's "
                    "reduce-scatter is the backward of the parameter gather and cannot be "
                    "rescheduled")

    @property
    def zero_stage(self) -> int:
        """0 (replicated) / 1 (cross_replica) / 2 / 3."""
        return {"replicated": 0, "cross_replica": 1, "zero2": 2, "zero3": 3}[self.update_sharding]

    @property
    def mode(self) -> str:
        """Flag name, e.g. allreduce | quantized+overlap | zero3."""
        if self.local_only:
            return "local"
        parts = []
        if self.quantize:
            parts.append("quantized")
        if self.hierarchy:
            parts.append("hier")
        if self.overlap:
            parts.append("overlap")
        if self.zero_stage:
            parts.append(f"zero{self.zero_stage}")
        return "+".join(parts) or "allreduce"

    @classmethod
    def parse(cls, mode: str | None) -> "GradCommsConfig | None":
        """Parse the ``--grad-comms`` flag: ``none`` (or None) is the
        default DDP path and returns None; the other modes return a
        config for the explicit path."""
        if mode is None or mode == "none":
            return None
        known = {
            "allreduce": cls(),
            "quantized": cls(quantize=True),
            "overlap": cls(overlap=True),
            "quantized+overlap": cls(quantize=True, overlap=True),
            "zero1": cls(update_sharding="cross_replica"),
            "quantized+zero1": cls(quantize=True, update_sharding="cross_replica"),
            "zero2": cls(update_sharding="zero2"),
            "quantized+zero2": cls(quantize=True, update_sharding="zero2"),
            "zero3": cls(update_sharding="zero3"),
            "quantized+zero3": cls(quantize=True, update_sharding="zero3"),
            "hier": cls(hierarchy=2),
            "quantized+hier": cls(quantize=True, hierarchy=2),
            "hier+overlap": cls(hierarchy=2, overlap=True),
            "quantized+hier+overlap": cls(quantize=True, hierarchy=2, overlap=True),
            "hier+zero1": cls(hierarchy=2, update_sharding="cross_replica"),
        }
        if mode not in known:
            raise ValueError(f"unknown grad-comms mode {mode!r}; pick one of "
                             f"none|{'|'.join(known)}")
        return known[mode]


# -- the replica axis ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """The replicas a reduction runs over: their process group (``None``
    for the default group) and their global ranks in group order."""

    group: Any
    ranks: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's position among the replicas."""
        return dist.get_rank(self.group) if self.size > 1 else 0


_bound = threading.local()


def axis_of_group(group: Any = None) -> Axis:
    """The :class:`Axis` of a process group (``None``: the default
    group; a world of one rank without a process group)."""
    if not dist.is_initialized():
        return Axis(None, (0,))
    return Axis(group, tuple(dist.get_process_group_ranks(group or dist.group.WORLD)))


@contextlib.contextmanager
def bind_axis(name: Any, axis: Axis) -> Iterator[Axis]:
    """Bind the axis name ``name`` (a string or a tuple of them) to
    ``axis`` on this thread for the block, as ``shard_map`` binds an
    axis name in the JAX package."""
    stack = getattr(_bound, "stack", None)
    if stack is None:
        stack = _bound.stack = []
    stack.append((name, axis))
    try:
        yield axis
    finally:
        stack.pop()


def _axis(axis_name: Any) -> Axis:
    if isinstance(axis_name, Axis):
        return axis_name
    if isinstance(axis_name, (str, tuple)):
        for name, axis in reversed(getattr(_bound, "stack", None) or []):
            if name == axis_name:
                return axis
        raise ValueError(
            f"axis {axis_name!r} is not bound: run the step through "
            "Strategy.step(fn, grad_comms=cfg), or pass a process group")
    return axis_of_group(axis_name)


def axis_size(axis_name: Any = None) -> int:
    """The replica count of ``axis_name`` (``lax.psum(1, axis)``)."""
    return _axis(axis_name).size


# -- block-scaled quantization ------------------------------------------------


def quantize_blockwise(x: torch.Tensor, block_size: int = 256,
                       qdtype: torch.dtype = torch.int8) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Quantize to ``(blocks, scales)``: ``x`` flattened, zero-padded to
    a block multiple and shaped ``(n_blocks, block_size)``. int8 gets one
    fp32 scale per block (``amax / 127``, 1 where the block is all zero;
    values rounded half to even, as ``jnp.round``), bf16 is a plain cast
    with ``scales=None``."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block_size)
    if qdtype.is_floating_point:
        return blocks.to(qdtype), None
    qmax = float(torch.iinfo(qdtype).max)
    amax = blocks.to(torch.float32).abs().amax(dim=1, keepdim=True)
    # A tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, which rounds differently from the division JAX makes.
    scales = torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scales), -qmax, qmax).to(qdtype)
    return q, scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor | None, size: int,
                         shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (drops the block padding)."""
    blocks = q.to(torch.float32)
    if scales is not None:
        blocks = blocks * scales
    return blocks.reshape(-1)[:size].reshape(shape).to(dtype)


def _wire(x: torch.Tensor, block_size: int, qdtype: torch.dtype) -> torch.Tensor:
    """One wire hop: quantize → dequantize."""
    q, scales = quantize_blockwise(x, block_size, qdtype)
    return dequantize_blockwise(q, scales, x.numel(), tuple(x.shape), x.dtype)


# -- the rank-order primitives -------------------------------------------------


def _pad_to(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % multiple
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def via_host(x: torch.Tensor, group: Any) -> bool:
    """Whether a collective on ``x`` stages it through host buffers: a
    CUDA tensor on a gloo group. Two ranks on one card cannot form an
    NCCL group, so they run gloo, and gloo collectives handed CUDA
    tensors aborted a rank on torch 2.11 (``writev: Bad address``); the
    arithmetic stays on the card and only the exchanged bytes cross the
    host (counted by ``hops_tpu_gloo_host_bytes_total``). An NCCL group
    never stages."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def count_host_bytes(nbytes: int) -> None:
    from hops_tpu_torch.telemetry.metrics import REGISTRY

    REGISTRY.counter("hops_tpu_gloo_host_bytes_total",
                     "Bytes of CUDA tensors staged through host buffers for a gloo "
                     "collective (copied out and back)").inc(nbytes)


def all_reduce_(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """``dist.all_reduce`` (a sum) of ``x`` in place, through host
    buffers on a gloo group (:func:`via_host`); returns ``x``."""
    if via_host(x, group):
        h = x.cpu()
        dist.all_reduce(h, group=group)
        count_host_bytes(2 * h.nbytes)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group: Any = None) -> torch.Tensor:
    """``dist.broadcast`` of ``x`` in place from global rank ``src``,
    through host buffers on a gloo group (:func:`via_host`)."""
    if via_host(x, group):
        h = x.cpu()
        dist.broadcast(h, src=src, group=group)
        count_host_bytes(2 * h.nbytes)
        x.copy_(h)
    else:
        dist.broadcast(x, src=src, group=group)
    return x


def _exchange(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``all_to_all_single`` of equal chunks of ``x``'s leading dim
    (through host buffers on a gloo group, :func:`via_host`)."""
    x = x.contiguous()
    if via_host(x, group):
        h = x.cpu()
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        count_host_bytes(2 * h.nbytes)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def gather_stack(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``(n, *x.shape)``: one
    ``all_gather_into_tensor`` (through host buffers on a gloo group,
    :func:`via_host`)."""
    x = x.contiguous()
    if axis.size == 1:
        return x[None]
    host = via_host(x, axis.group)
    src = (x.cpu() if host else x).reshape(-1)
    out = src.new_empty((axis.size * src.numel(),))
    dist.all_gather_into_tensor(out, src, group=axis.group)
    out = out.view(axis.size, *x.shape)
    if host:
        count_host_bytes(src.nbytes + out.nbytes)
        return out.to(x.device)
    return out


def _fold(contrib: torch.Tensor) -> torch.Tensor:
    """Row ``s`` is rank ``s``'s addend: fold left in rank order."""
    acc = contrib[0]
    for s in range(1, contrib.shape[0]):
        acc = acc + contrib[s]
    return acc


def psum_scatter(flat: torch.Tensor, axis_name: Any = None, hierarchy: int = 0) -> torch.Tensor:
    """Tiled reduce-scatter of a flat buffer whose length divides by the
    replica count: this rank's ``len/N`` tile of the sum, folded in rank
    order after one ``all_to_all_single`` (or the hierarchical schedule,
    which folds the same addends in the same order)."""
    axis = _axis(axis_name)
    n = axis.size
    if n == 1:
        return flat
    if flat.shape[0] % n:
        raise ValueError(f"buffer length {flat.shape[0]} not divisible by {n} replicas")
    if hierarchy:
        return hier_reduce_scatter(flat, axis, hierarchy)
    return _fold(_exchange(flat, axis.group).view(n, -1))


def all_gather(shard: torch.Tensor, axis_name: Any = None, hierarchy: int = 0) -> torch.Tensor:
    """Tiled all-gather of per-rank tiles in rank order (pure movement)."""
    axis = _axis(axis_name)
    if axis.size == 1:
        return shard
    if hierarchy:
        return hier_all_gather(shard, axis, hierarchy)
    return gather_stack(shard.reshape(-1), axis).reshape(-1)


def psum(x: torch.Tensor, axis_name: Any = None, *, mean: bool = False) -> torch.Tensor:
    """Drop-in ``lax.psum``: floating tensors through the rank-order
    reduce-scatter and an all-gather; integer tensors through
    ``all_reduce`` (exact in any order)."""
    axis = _axis(axis_name)
    n = axis.size
    if n == 1:
        return x
    if not x.is_floating_point():
        return all_reduce_(x.clone(), axis.group)
    flat = _pad_to(x.reshape(-1), n)
    out = all_gather(psum_scatter(flat, axis), axis)[: x.numel()].reshape(x.shape)
    return out / n if mean else out


# -- hierarchy-aware collectives ----------------------------------------------


def hier_groups(n: int, hosts: int) -> tuple[list[list[int]], list[list[int]]]:
    """(intra, inter) groups of replica positions for ``n`` host-major
    ranks on ``hosts`` hosts: intra groups share a host, inter groups
    link the k-th rank of every host."""
    if hosts < 2:
        raise ValueError(f"hierarchy needs >= 2 hosts, got {hosts}")
    if n % hosts:
        raise ValueError(f"replica count {n} not divisible by hierarchy={hosts} hosts")
    local = n // hosts
    intra = [[h * local + i for i in range(local)] for h in range(hosts)]
    inter = [[h * local + i for h in range(hosts)] for i in range(local)]
    return intra, inter


_HIER_GROUPS: dict[tuple, tuple[Any, Any]] = {}


def hier_process_groups(axis_name: Any, hosts: int) -> tuple[Any, Any]:
    """This rank's (intra, inter) process groups, created once per
    (default group, replicas, hosts): every rank of the world creates
    every subgroup in the same order, so the first call must come from
    all of them at the same point (``Strategy.step`` makes it when it
    builds the step)."""
    axis = _axis(axis_name)
    if dist.get_world_size() != axis.size:
        raise ValueError("hierarchy reduces over replicas that span every rank of the "
                         f"process group: {axis.size} of {dist.get_world_size()}")
    key = (id(dist.group.WORLD), axis.ranks, hosts)
    pgs = _HIER_GROUPS.get(key)
    if pgs is None:
        intra, inter = hier_groups(axis.size, hosts)
        mine = []
        for groups in (intra, inter):
            ranks = [[axis.ranks[i] for i in g] for g in groups]
            mine.append(dist.new_subgroups_by_enumeration(ranks)[0])
        pgs = _HIER_GROUPS[key] = tuple(mine)
    return pgs


def hier_reduce_scatter(flat: torch.Tensor, axis_name: Any, hosts: int) -> torch.Tensor:
    """Hierarchical tiled reduce-scatter: intra-host all-to-all, one
    inter-host all-to-all, local fold in global rank order — the same
    addends in the same order as :func:`psum_scatter`'s flat schedule,
    so the tile is bit-identical to it."""
    axis = _axis(axis_name)
    n = axis.size
    hier_groups(n, hosts)
    if flat.shape[0] % n:
        raise ValueError(f"buffer length {flat.shape[0]} not divisible by {n} replicas")
    intra, inter = hier_process_groups(axis, hosts)
    t = flat.view(hosts, n // hosts, -1)  # [h, i]: the tile rank (h, i) will own
    # Within the host, member j gets every tile for local position j:
    # p1[i, h] = host-mate i's addend for tile (h, my position).
    p1 = _exchange(t.transpose(0, 1), intra)
    # The one inter-host exchange: p2[g, i] = rank (g, i)'s addend for my tile.
    p2 = _exchange(p1.transpose(0, 1), inter)
    return _fold(p2.reshape(n, -1))


def hier_all_gather(shard: torch.Tensor, axis_name: Any, hosts: int) -> torch.Tensor:
    """Hierarchical tiled all-gather: within each host first (a
    contiguous block of tiles), then across hosts. Equals the flat
    gather element for element."""
    intra, inter = hier_process_groups(axis_name, hosts)
    g1 = all_gather(shard, axis_of_group(intra))
    return all_gather(g1, axis_of_group(inter))


def psum_hierarchical(x: torch.Tensor, axis_name: Any = None, *, hosts: int = 2,
                      mean: bool = False) -> torch.Tensor:
    """Drop-in :func:`psum` with the hierarchical wire schedule, bit for
    bit equal to it. With one replica the input comes straight back."""
    axis = _axis(axis_name)
    n = axis.size
    if n == 1:
        return x
    flat = _pad_to(x.reshape(-1), n)
    part = hier_reduce_scatter(flat, axis, hosts)
    out = hier_all_gather(part, axis, hosts)[: x.numel()].reshape(x.shape)
    return out / n if mean else out


def psum_quantized(x: torch.Tensor, axis_name: Any = None, *, block_size: int = 256,
                   qdtype: torch.dtype = torch.int8, mean: bool = False,
                   hierarchy: int = 0) -> torch.Tensor:
    """Drop-in :func:`psum` with block-scaled quantization at both wire
    hops (local gradients going in, partial sums coming out); the
    reduction accumulates in fp32. The buffer pads to ``n *
    block_size`` so every tile is whole blocks. With one replica the
    input is returned unquantized."""
    axis = _axis(axis_name)
    n = axis.size
    if n == 1:
        return x
    flat = _pad_to(x.to(torch.float32).reshape(-1), n * block_size)
    flat = _wire(flat, block_size, qdtype)  # hop 1: local gradients
    part = psum_scatter(flat, axis, hierarchy)
    part = _wire(part, block_size, qdtype)  # hop 2: partial sums
    out = all_gather(part, axis, hierarchy)[: x.numel()].reshape(x.shape)
    if mean:
        out = out / n
    return out.to(x.dtype)


# -- bucketing ----------------------------------------------------------------


@dataclasses.dataclass
class BucketLayout:
    """Recipe to rebuild a tree from its flat buckets."""

    treedef: Any
    #: per bucket: (leaf_indices, shapes, sizes, dtype, pad)
    buckets: list[tuple[list[int], list[tuple[int, ...]], list[int], torch.dtype, int]]


def _leaves(tree: Any) -> tuple[list[torch.Tensor], Any]:
    return pytree.tree_flatten(tree)


def flatten_buckets(tree: Any, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    pad_multiple: int = 1) -> tuple[list[torch.Tensor], BucketLayout]:
    """Concatenate a tree's tensors (a list, tuple or dict of them) into
    a few 1-D buffers: leaves group by dtype in tree order and a bucket
    closes once it holds ``bucket_bytes``; each buffer is zero-padded to
    a multiple of ``pad_multiple`` (the replica count, for a
    reduce-scatter)."""
    leaves, treedef = _leaves(tree)
    open_bucket: dict[torch.dtype, int] = {}
    groups: list[tuple[torch.dtype, list[int], int]] = []
    for i, leaf in enumerate(leaves):
        dt = leaf.dtype
        nbytes = leaf.numel() * leaf.element_size()
        j = open_bucket.get(dt)
        if j is None:
            open_bucket[dt] = len(groups)
            groups.append((dt, [i], nbytes))
        else:
            dtype, idxs, total = groups[j]
            idxs.append(i)
            groups[j] = (dtype, idxs, total + nbytes)
        if groups[open_bucket[dt]][2] >= bucket_bytes:
            del open_bucket[dt]  # full: the next leaf of this dtype opens a new one
    buffers, meta = [], []
    for dtype, idxs, _ in groups:
        parts = [leaves[i].reshape(-1) for i in idxs]
        buf = parts[0] if len(parts) == 1 else torch.cat(parts)
        pad = (-buf.shape[0]) % pad_multiple
        buffers.append(_pad_to(buf, pad_multiple))
        meta.append((idxs, [tuple(leaves[i].shape) for i in idxs],
                     [leaves[i].numel() for i in idxs], dtype, pad))
    return buffers, BucketLayout(treedef, meta)


def unflatten_buckets(buffers: list[torch.Tensor], layout: BucketLayout) -> Any:
    """Inverse of :func:`flatten_buckets`: split, reshape, re-tree."""
    n_leaves = sum(len(idxs) for idxs, *_ in layout.buckets)
    leaves: list[Any] = [None] * n_leaves
    for buf, (idxs, shapes, sizes, dtype, pad) in zip(buffers, layout.buckets):
        if pad:
            buf = buf[: buf.shape[0] - pad]
        for i, shape, part in zip(idxs, shapes, torch.split(buf, sizes)):
            leaves[i] = part.reshape(shape).to(dtype)
    return pytree.tree_unflatten(leaves, layout.treedef)


# -- tree-level collectives ---------------------------------------------------


def all_reduce_grads(grads: Any, axis_name: Any = "data", config: GradCommsConfig | None = None,
                     *, mean: bool = True) -> Any:
    """Bucketed (optionally quantized, optionally hierarchical)
    all-reduce of a tree of gradients: flatten into per-dtype buffers,
    one reduction per buffer, restore the tree. ``mean=True`` divides
    floating buffers by the replica count."""
    cfg = config or GradCommsConfig()
    axis = _axis(axis_name)
    n = axis.size
    buffers, layout = flatten_buckets(grads, cfg.bucket_bytes)
    out = []
    for buf in buffers:
        floating = buf.is_floating_point()
        if cfg.quantize and floating and n > 1:
            r = psum_quantized(buf, axis, block_size=cfg.block_size, qdtype=cfg.qdtype,
                               hierarchy=cfg.hierarchy)
        elif cfg.hierarchy and floating and n > 1:
            r = psum_hierarchical(buf, axis, hosts=cfg.hierarchy)
        else:
            r = psum(buf, axis)
        if mean and floating:
            r = r / n
        out.append(r)
    return unflatten_buckets(out, layout)


def _shard_slice(buf: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    m = buf.shape[0] // n
    return buf[idx * m:(idx + 1) * m]


def _scatter_mean(buf: torch.Tensor, axis: Axis, cfg: GradCommsConfig) -> torch.Tensor:
    """This rank's mean-gradient tile of a flat buffer padded to the
    replica count: quantized wire (hop 1) if asked, the rank-order
    reduce-scatter, divided by N."""
    if cfg.quantize and buf.is_floating_point():
        buf = _wire(buf, cfg.block_size, cfg.qdtype)
    shard = psum_scatter(buf, axis, cfg.hierarchy)
    return shard / axis.size if shard.is_floating_point() else shard


# -- the optimizer over flat shards -------------------------------------------


def _one_group(opt: torch.optim.Optimizer) -> dict[str, Any]:
    if len(opt.param_groups) != 1:
        raise ValueError("the sharded updates take an optimizer with one parameter group "
                         f"(got {len(opt.param_groups)}): the flat layout mixes parameters")
    return {k: v for k, v in opt.param_groups[0].items() if k != "params"}


def _like(opt: torch.optim.Optimizer, params: list[torch.Tensor]) -> torch.optim.Optimizer:
    """A new optimizer of ``opt``'s class and hyperparameters over
    ``params`` (the group's current values, a scheduler's included)."""
    group = _one_group(opt)
    new = type(opt)(params, **opt.defaults)
    new.param_groups[0].update(group)
    return new


def _state_keys(opt: torch.optim.Optimizer, params: list[torch.Tensor]) -> tuple[list[str], dict]:
    """The parameter-shaped state entries of ``opt`` (moments: ``exp_avg``,
    ``exp_avg_sq``, ``momentum_buffer``) and its scalar entries (Adam's
    ``step``), read from the first parameter that has state."""
    for p in params:
        st = opt.state.get(p)
        if st:
            shaped = [k for k, v in st.items()
                      if isinstance(v, torch.Tensor) and v.shape == p.shape and v.dim()]
            scalars = {k: v for k, v in st.items() if k not in shaped}
            return shaped, scalars
    return [], {}


def _new_leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(t.is_floating_point())


def _load_shard_state(shard_opt, shard_params, moments: dict[str, list[torch.Tensor]],
                      scalars: dict) -> None:
    """Seed ``shard_opt``'s state: each moment's flat shards (one per
    shard parameter) and the scalar entries, cloned per parameter."""
    if not moments and not scalars:
        return
    for j, sp in enumerate(shard_params):
        st = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in scalars.items()}
        st.update({k: bufs[j].clone() for k, bufs in moments.items()})
        shard_opt.state[sp] = st


def _write_state(opt, params, moments: dict[str, list[torch.Tensor]], scalars: dict) -> None:
    """Write dense moments (one per parameter) and scalars into ``opt``'s
    per-parameter state."""
    for i, p in enumerate(params):
        st = opt.state.setdefault(p, {})
        for k, v in scalars.items():
            st[k] = v.clone() if isinstance(v, torch.Tensor) else v
        for k, leaves in moments.items():
            st[k] = leaves[i].detach().clone()


@dataclasses.dataclass
class MomentShards:
    """The persistent ZeRO-1/2 carrier (``state.shards``): the optimizer
    runs over flat shards of the parameters in the gradient shards'
    layout (per-dtype buckets for ZeRO-1, per-parameter buffers for
    ZeRO-2), and its moments stay this rank's 1/N between steps. The
    parameters themselves stay dense and replicated."""

    update_sharding: str
    axis: Axis
    params: list[torch.Tensor]  # this rank's shard of each flat buffer
    optimizer: torch.optim.Optimizer  # over ``params``
    base: torch.optim.Optimizer  # the replicated optimizer it came from

    def __repr__(self) -> str:
        return f"MomentShards({len(self.params)} buffers, 1/{self.axis.size})"


def _flatten_fn(stage: str, n: int, bucket_bytes: int):
    """The flat layout the gradient shards arrive in: per-dtype buckets
    at ``bucket_bytes`` for ZeRO-1, per-parameter buffers for ZeRO-2."""
    if stage == "zero2":
        return lambda t: _per_leaf_buffers(t, n)
    return lambda t: flatten_buckets(t, bucket_bytes, pad_multiple=n)


def _per_leaf_buffers(tree: Any, n: int) -> tuple[list[torch.Tensor], BucketLayout]:
    """Per-leaf flat buffers padded to the replica count: the layout of
    the scatter hooks, the ZeRO-2 update and the ZeRO-3 state."""
    return flatten_buckets(tree, bucket_bytes=1, pad_multiple=n)


def _sharded_state_update(state: Any, gshards: list[torch.Tensor], flatten_fn, axis: Axis) -> Any:
    """Shared ZeRO-1/2 tail: the optimizer on this rank's 1/N flat
    shards of the parameters (and their moments), the parameters
    all-gathered back. A state without a carrier keeps the replicated
    contract (moments sliced here, gathered back into the optimizer); a
    :class:`MomentShards` carrier keeps its resident shards, never
    gathered."""
    n, idx = axis.size, axis.index
    model, opt = state.model, state.optimizer
    params = list(model.parameters())
    with torch.no_grad():
        pbufs, playout = flatten_fn([p.detach() for p in params])
        pshards = [_shard_slice(b, n, idx) for b in pbufs]
        carrier = state.shards if isinstance(state.shards, MomentShards) else None
        if carrier is not None:
            if carrier.axis.size != n:
                raise ValueError(f"moment shards for {carrier.axis.size} replicas, step over {n}")
            shard_params, shard_opt = carrier.params, carrier.optimizer
            for sp, cur in zip(shard_params, pshards):
                sp.copy_(cur)
        else:
            shard_params = [_new_leaf(s) for s in pshards]
            shard_opt = _like(opt, shard_params)
            shaped, scalars = _state_keys(opt, params)
            moments = {}
            for k in shaped:
                bufs, _ = flatten_fn([opt.state[p][k] for p in params])
                moments[k] = [_shard_slice(b, n, idx) for b in bufs]
            _load_shard_state(shard_opt, shard_params, moments, scalars)
        for sp, g in zip(shard_params, gshards):
            sp.grad = g.to(sp.dtype)
    shard_opt.step()
    with torch.no_grad():
        for sp in shard_params:
            sp.grad = None
        new = unflatten_buckets([all_gather(sp.detach(), axis) for sp in shard_params], playout)
        for p, v in zip(params, new):
            p.copy_(v)
            p.grad = None
        if carrier is None:
            shaped, scalars = _state_keys(shard_opt, shard_params)
            moments = {}
            for k in shaped:
                gathered = [all_gather(shard_opt.state[sp][k], axis) for sp in shard_params]
                moments[k] = unflatten_buckets(gathered, playout)
            _write_state(opt, params, moments, scalars)
    return dataclasses.replace(state, step=state.step + 1)


def sharded_apply_gradients(state: Any, grads: list[torch.Tensor], axis_name: Any = "data",
                            config: GradCommsConfig | None = None) -> Any:
    """ZeRO-1 update: reduce-scatter the bucketed (optionally
    quantized) gradients, update this rank's 1/N slice of the flat
    parameters and moments, all-gather the parameters. Exact for
    elementwise optimizers (SGD, momentum, Adam). ``grads`` are the
    raw per-replica gradients, one per parameter of ``state.model``."""
    cfg = config or GradCommsConfig(update_sharding="cross_replica")
    axis = _axis(axis_name)
    n = axis.size
    if n == 1:
        return _plain_update(state, grads)
    gbufs, _ = flatten_buckets(grads, cfg.bucket_bytes, pad_multiple=n)
    gshards = [_scatter_mean(b, axis, cfg) for b in gbufs]
    return _sharded_state_update(state, gshards, _flatten_fn("cross_replica", n, cfg.bucket_bytes),
                                 axis)


def _plain_update(state: Any, grads: list[torch.Tensor] | None) -> Any:
    """``state.apply_gradients``: one optimizer step on ``grads`` (or on
    the gradients the parameters hold)."""
    params = list(state.model.parameters())
    if grads is not None:
        for p, g in zip(params, grads):
            p.grad = g
    state.optimizer.step()
    return dataclasses.replace(state, step=state.step + 1)


# -- overlap hooks: collectives launched during backward ----------------------


class BackwardComms:
    """The per-parameter backward hooks of ``overlap`` / ``zero2``: each
    fires when autograd has accumulated a parameter's gradient, launches
    that gradient's all-to-all asynchronously (``async_op=True``),
    releases the gradient and folds the exchanges launched before it to
    this rank's 1/N tile, so that during backward at most one receive
    buffer (the newest) holds a whole gradient; :meth:`wait` finishes
    every pending reduction (the last fold, the second wire hop, the
    gather of ``overlap``) and removes the hooks. ``overlap`` writes the
    mean gradient back to ``p.grad``; ``zero2`` keeps only this rank's
    1/N mean-gradient slice (:attr:`shards`), never gathered."""

    def __init__(self, params: list[torch.Tensor], axis: Axis, cfg: GradCommsConfig):
        self.params, self.axis, self.cfg = params, axis, cfg
        self.scatter = cfg.update_sharding in ("zero2", "zero3")
        # index -> (work or None once folded, buffer, shape, numel, dtype)
        self.pending: dict[int, tuple] = {}
        self.shards: list[torch.Tensor] | None = None
        self.handles = [p.register_post_accumulate_grad_hook(functools.partial(self._fire, i))
                        for i, p in enumerate(params)]

    def _fire(self, i: int, p: torch.Tensor) -> None:
        g, n, cfg = p.grad, self.axis.size, self.cfg
        if n == 1:
            return
        if self.scatter:
            flat = _pad_to(g.reshape(-1), n)
            if cfg.quantize:
                flat = _wire(flat, cfg.block_size, cfg.qdtype)
        elif cfg.quantize:
            flat = _wire(_pad_to(g.to(torch.float32).reshape(-1), n * cfg.block_size),
                         cfg.block_size, cfg.qdtype)
        else:
            flat = _pad_to(g.reshape(-1), n)
        flat = flat.contiguous()
        if cfg.hierarchy:  # phase 2 depends on phase 1: both run here, in turn
            work, buf = None, hier_reduce_scatter(flat, self.axis, cfg.hierarchy)
        else:
            buf = torch.empty_like(flat)
            work = dist.all_to_all_single(buf, flat, group=self.axis.group, async_op=True)
        self._settle()
        self.pending[i] = (work, buf, g.shape, g.numel(), g.dtype)
        p.grad = None  # the gradient lives on in the exchange's buffers

    def _settle(self) -> None:
        """Wait on every pending exchange and fold it to this rank's tile."""
        n = self.axis.size
        for i, (work, buf, *meta) in self.pending.items():
            if work is not None:
                work.wait()
                self.pending[i] = (None, _fold(buf.view(n, -1)), *meta)

    def wait(self) -> None:
        """Finish the reductions launched in backward; remove the hooks."""
        self.remove()
        n, cfg = self.axis.size, self.cfg
        if n == 1:
            return
        for i, p in enumerate(self.params):
            if i not in self.pending:  # no gradient reached it: a zero gradient
                p.grad = torch.zeros_like(p)
                self._fire(i, p)
        self._settle()
        shards = []
        for i, p in enumerate(self.params):
            _, part, shape, size, dtype = self.pending.pop(i)
            if self.scatter:
                shards.append(part / n)
                continue
            if cfg.quantize:
                part = _wire(part, cfg.block_size, cfg.qdtype)
            full = all_gather(part, self.axis, cfg.hierarchy)[:size].reshape(shape)
            p.grad = full.to(dtype) / n
        self.shards = shards if self.scatter else None

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def tag_backward_comms(params: list[torch.Tensor], axis_name: Any,
                       cfg: GradCommsConfig) -> BackwardComms | None:
    """Install the backward hooks on ``params`` (``overlap`` →
    all-reduce hooks, ``zero2`` → reduce-scatter hooks); call before
    the forward. ``None`` for ``local_only``."""
    if cfg.local_only:
        return None
    return BackwardComms(list(params), _axis(axis_name), cfg)


# -- ZeRO-2 ---------------------------------------------------------------------


def extract_grad_shards(comms: BackwardComms) -> list[torch.Tensor]:
    """This rank's mean-gradient slice of each parameter's padded flat
    buffer, from the scatter hooks (waited on here). A local read — no
    communication beyond the hooks' own."""
    if comms.shards is None:
        comms.wait()
    return comms.shards


def zero2_apply_gradients(state: Any, comms: BackwardComms, axis_name: Any = "data",
                          config: GradCommsConfig | None = None) -> Any:
    """ZeRO-2 update: the gradients were reduce-scattered by the backward
    hooks, so the optimizer runs on this rank's per-parameter shards and
    the parameters are all-gathered — no gradient collective here.
    Exact vs the replicated update for elementwise optimizers."""
    axis = _axis(axis_name)
    if axis.size == 1:
        comms.remove()
        return _plain_update(state, None)
    gshards = extract_grad_shards(comms)
    return _sharded_state_update(state, gshards, lambda t: _per_leaf_buffers(t, axis.size), axis)


# -- ZeRO-1/2 persistent-sharded moments ---------------------------------------


def zero12_init(state: Any, mesh: Any, config: GradCommsConfig, axis_name: Any = "data") -> Any:
    """The replicated state with its optimizer moved onto the persistent
    ZeRO-1 (``cross_replica``) / ZeRO-2 carrier: a :class:`MomentShards`
    in ``state.shards`` whose optimizer (same class and
    hyperparameters) runs over this rank's flat shards, its moments
    sliced from the live ones (a mid-training state keeps its
    trajectory). The replicated optimizer's state is dropped: 1/N
    optimizer bytes per rank at rest. With one replica the state comes
    back as it is."""
    if config.update_sharding not in ("cross_replica", "zero2"):
        raise ValueError("zero12_init applies to update_sharding='cross_replica' (ZeRO-1) "
                         f"or 'zero2', got {config.update_sharding!r}")
    axis = mesh_axis(mesh, axis_name)
    n = axis.size
    if n == 1:
        return state
    opt = state.optimizer
    params = list(state.model.parameters())
    flatten_fn = _flatten_fn(config.update_sharding, n, config.bucket_bytes)
    idx = axis.index
    with torch.no_grad():
        pbufs, _ = flatten_fn([p.detach() for p in params])
        shard_params = [_new_leaf(_shard_slice(b, n, idx)) for b in pbufs]
        shaped, scalars = _state_keys(opt, params)
        moments = {}
        for k in shaped:
            if [opt.state[p][k].dtype for p in params] != [p.dtype for p in params]:
                raise ValueError("zero12_init: optimizer moments must share the parameter "
                                 "dtypes (the unshard layout is derived from the parameters)")
            bufs, _ = flatten_fn([opt.state[p][k] for p in params])
            moments[k] = [_shard_slice(b, n, idx) for b in bufs]
    shard_opt = _like(opt, shard_params)
    _load_shard_state(shard_opt, shard_params, moments, scalars)
    opt.state.clear()
    carrier = MomentShards(config.update_sharding, axis, shard_params, shard_opt, opt)
    return dataclasses.replace(state, shards=carrier)


def zero12_unshard(state: Any, config: GradCommsConfig, axis_name: Any = "data") -> Any:
    """Inverse of :func:`zero12_init` (eval, checkpoint export): the
    replicated optimizer gets the dense moments back, gathered from the
    shards (over the replicas the carrier was built on) through the
    parameters' flat layout. Every replica calls it."""
    del axis_name  # the carrier knows its replicas
    carrier = state.shards
    if not isinstance(carrier, MomentShards):
        return state
    params = list(state.model.parameters())
    flatten_fn = _flatten_fn(carrier.update_sharding, carrier.axis.size, config.bucket_bytes)
    with torch.no_grad():
        _, playout = flatten_fn([p.detach() for p in params])
        shaped, scalars = _state_keys(carrier.optimizer, carrier.params)
        moments = {}
        for k in shaped:
            gathered = [all_gather(carrier.optimizer.state[sp][k], carrier.axis)
                        for sp in carrier.params]
            moments[k] = unflatten_buckets(gathered, playout)
    _write_state(carrier.base, params, moments, scalars)
    return dataclasses.replace(state, optimizer=carrier.base, shards=None)


def has_sharded_moments(state: Any) -> bool:
    """True when the state carries the persistent ZeRO-1/2 carrier."""
    return isinstance(getattr(state, "shards", None), MomentShards)


def zero12_state_specs(state: Any, axis_name: Any = "data") -> dict[str, Any]:
    """Where each part of a ZeRO-1/2 state lives, as DTensor placements
    over the data axis: the carrier's shard buffers ``Shard(0)``, the
    parameters and scalars ``Replicate()`` (JAX's shard_map specs)."""
    from torch.distributed.tensor import Replicate, Shard

    del axis_name
    params = {n: Replicate() for n, _ in state.model.named_parameters()}
    if has_sharded_moments(state):
        return {"params": params, "shards": [Shard(0)] * len(state.shards.params)}
    return {"params": params, "shards": []}


def mesh_axis(mesh: Any, axis_name: Any = "data") -> Axis:
    """The :class:`Axis` of a port ``Mesh``'s data axes: its process group
    and ranks. The data axes must span the mesh (the reductions run over
    every rank of its group)."""
    axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    n = math.prod(mesh.shape[a] for a in axes)
    if n != mesh.size:
        raise ValueError(f"grad_comms reduces over data axes {axes} of {mesh.shape}: "
                         "they must span the mesh")
    if n == 1:
        return Axis(None, (int(mesh.devices.reshape(-1)[0]),))
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs a process group: join one with "
                           "multihost.initialize or run under python -m hops_tpu_torch.launch")
    axis = axis_of_group(mesh.group)
    if axis.size != n:
        raise ValueError(f"mesh {mesh.shape} has {n} ranks, its group {axis.size}")
    return axis


# -- ZeRO-3: parameters sharded at rest ----------------------------------------


@dataclasses.dataclass
class Zero3Shards:
    """The ZeRO-3 carrier (``state.shards``): per parameter, this rank's
    1/N slice of its flat buffer padded to the replica count, the
    optimizer (same class and hyperparameters, ``state.optimizer``) over
    those slices, and ``meta`` (shape, dtype, size, padded size) to
    rebuild the dense parameters. The module's own parameters hold no
    storage at rest."""

    axis: Axis
    names: list[str]
    params: list[torch.Tensor]
    meta: tuple
    base: torch.optim.Optimizer

    def __repr__(self) -> str:
        return f"Zero3Shards({len(self.params)} parameters, 1/{self.axis.size})"


def _zero3_meta(params: list[torch.Tensor], n: int) -> tuple:
    meta = []
    for p in params:
        size = p.numel()
        meta.append((tuple(p.shape), p.dtype, size, size + (-size) % n))
    return tuple(meta)


def zero3_init(state: Any, mesh: Any, axis_name: Any = "data") -> Any:
    """Convert a replicated state into the ZeRO-3 carrier: each parameter
    (and its optimizer moments) becomes this rank's slice of its flat
    buffer padded to the replica count; the module's parameters release
    their storage. The incoming optimizer state converts leaf for leaf
    (a mid-training state resumes on its trajectory). The inverse is
    :func:`zero3_unshard`."""
    axis = mesh_axis(mesh, axis_name)
    n, idx = axis.size, axis.index
    opt = state.optimizer
    named = list(state.model.named_parameters())
    params = [p for _, p in named]
    meta = _zero3_meta(params, n)

    def _flat(t: torch.Tensor, m) -> torch.Tensor:
        return _shard_slice(_pad_to(t.detach().reshape(-1), n), n, idx).clone()

    with torch.no_grad():
        shards = [_flat(p, m).requires_grad_(p.is_floating_point()) for p, m in zip(params, meta)]
        shaped, scalars = _state_keys(opt, params)
        moments = {k: [_flat(opt.state[p][k], m) for p, m in zip(params, meta)] for k in shaped}
    shard_opt = _like(opt, shards)
    _load_shard_state(shard_opt, shards, moments, scalars)
    opt.state.clear()
    for p in params:
        p.data = p.data.new_empty((0,))
    carrier = Zero3Shards(axis, [name for name, _ in named], shards, meta, opt)
    return dataclasses.replace(state, optimizer=shard_opt, shards=carrier)


class _GatherLeaf(torch.autograd.Function):
    """All-gather one parameter's flat shards into the dense tensor; the
    backward is the rank-order reduce-scatter of its gradient (the
    quantized wire's first hop before it, when asked): the ZeRO-3
    backward schedule, run per parameter as backward produces it."""

    @staticmethod
    def forward(ctx, shard, axis, meta, cfg):
        shape, dtype, size, padded = meta
        ctx.axis, ctx.meta, ctx.cfg = axis, meta, cfg
        return all_gather(shard.detach(), axis)[:size].reshape(shape).to(dtype)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, size, padded = ctx.meta
        cfg = ctx.cfg
        if cfg.quantize and g.is_floating_point():
            g = _wire(g, cfg.block_size, cfg.qdtype)
        flat = _pad_to(g.reshape(-1).to(dtype), ctx.axis.size)
        return psum_scatter(flat, ctx.axis), None, None, None


def zero3_gather_params(shards: list[torch.Tensor], meta: tuple, axis_name: Any,
                        config: GradCommsConfig | None = None) -> list[torch.Tensor]:
    """The dense parameters from their flat shards, each through
    :class:`_GatherLeaf` (its backward reduce-scatters the gradient onto
    the shard's ``.grad``)."""
    cfg = config or GradCommsConfig(update_sharding="zero3")
    axis = _axis(axis_name)
    return [_GatherLeaf.apply(s, axis, m, cfg) for s, m in zip(shards, meta)]


def zero3_apply_gradients(state: Any) -> Any:
    """ZeRO-3 update: the shards' gradients (summed by the gathers'
    backward) are divided by the replica count and the optimizer steps
    the resident shards; nothing is gathered back."""
    carrier = state.shards
    with torch.no_grad():
        for s in carrier.params:
            if s.grad is None:
                s.grad = torch.zeros_like(s)
            elif s.grad.is_floating_point():
                s.grad.div_(carrier.axis.size)
    state.optimizer.step()
    for s in carrier.params:
        s.grad = None
    return dataclasses.replace(state, step=state.step + 1)


def zero3_unshard(state: Any) -> Any:
    """Inverse of :func:`zero3_init` (eval, checkpoint export): the
    replicated state — dense parameters back in the module, the
    replicated optimizer with the dense moments. Every replica calls it
    (the dense values are gathered from the shards)."""
    carrier = state.shards
    params = list(state.model.parameters())

    def _dense(flat: torch.Tensor, m) -> torch.Tensor:
        shape, dtype, size, _ = m
        return all_gather(flat.detach(), carrier.axis)[:size].reshape(shape).to(dtype)

    with torch.no_grad():
        for p, s, m in zip(params, carrier.params, carrier.meta):
            p.data = _dense(s, m)
        shaped, scalars = _state_keys(state.optimizer, carrier.params)
        moments = {k: [_dense(state.optimizer.state[s][k], m)
                       for s, m in zip(carrier.params, carrier.meta)] for k in shaped}
    _write_state(carrier.base, params, moments, scalars)
    return dataclasses.replace(state, optimizer=carrier.base, shards=None)


def zero3_state_specs(state: Any, axis_name: Any = "data") -> dict[str, Any]:
    """Where each part of a ZeRO-3 state lives, as DTensor placements:
    parameter and moment shards ``Shard(0)`` over the data axis, the
    step and buffers ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    del axis_name
    return {"params": {n: Shard(0) for n in state.shards.names},
            "buffers": {n: Replicate() for n, _ in state.model.named_buffers()}}


# -- mode dispatch -------------------------------------------------------------


@dataclasses.dataclass
class Prepared:
    """What :func:`prepare_params` returns: the parameters the forward
    reads (``None``: the module's own) and the backward hooks or ZeRO-3
    gathers whose results :func:`apply_gradients` collects."""

    model: nn.Module
    comms: BackwardComms | None = None
    swapped: dict[str, tuple[nn.Module, str, Any]] | None = None

    def restore(self) -> None:
        """Put the module's own parameters back (ZeRO-3)."""
        for mod, attr, p in (self.swapped or {}).values():
            mod._parameters[attr] = p
        self.swapped = None


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def prepare_params(state: Any, config: GradCommsConfig, axis_name: Any = "data") -> Prepared:
    """The mode's view of the parameters for the forward — call before
    it. Stage 0/1 without overlap: the module's own (the reduction runs
    at update time). ``overlap``/``zero2``: backward hooks on them.
    ``zero3``: the dense parameters gathered from the state's shards
    and set in the module for the forward and backward (restored by
    :func:`apply_gradients`)."""
    model = state.model
    if config.local_only:
        return Prepared(model)
    if config.update_sharding == "zero3":
        carrier = getattr(state, "shards", None)
        if not isinstance(carrier, Zero3Shards):
            raise ValueError("zero3 needs the state's shards (build the state with zero3_init)")
        full = zero3_gather_params(carrier.params, carrier.meta, carrier.axis, config)
        swapped = {}
        for name, t in zip(carrier.names, full):
            mod, attr = _owner(model, name)
            swapped[name] = (mod, attr, mod._parameters[attr])
            mod._parameters[attr] = t
        return Prepared(model, swapped=swapped)
    if config.overlap or config.update_sharding == "zero2":
        return Prepared(model, comms=tag_backward_comms(list(model.parameters()), axis_name,
                                                        config))
    return Prepared(model)


def apply_gradients(state: Any, prepared: Prepared, config: GradCommsConfig,
                    axis_name: Any = "data") -> Any:
    """The explicit replacement for the optimizer step, after backward:
    the gradients' meaning depends on the mode (raw per replica for
    stage 0/1, reduced by the hooks for overlap, scattered for zero2,
    on the shards for zero3). Returns the state with the next step
    number."""
    if config.local_only:
        return _plain_update(state, None)
    if config.update_sharding == "zero3":
        prepared.restore()
        return zero3_apply_gradients(state)
    if config.update_sharding == "zero2":
        return zero2_apply_gradients(state, prepared.comms, axis_name, config)
    if config.overlap:  # the hooks reduced and meaned during backward
        prepared.comms.wait()
        return _plain_update(state, None)
    params = list(state.model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if config.update_sharding == "cross_replica":
        return sharded_apply_gradients(state, grads, axis_name, config)
    return _plain_update(state, all_reduce_grads(grads, axis_name, config, mean=True))


def pmean_buffers(model: nn.Module, axis_name: Any = "data") -> None:
    """Average the module's floating buffers (BatchNorm's running
    statistics) over the replicas, in place."""
    if axis_size(axis_name) == 1:
        return
    with torch.no_grad():
        for b in model.buffers():
            if b.is_floating_point():
                b.copy_(psum(b, axis_name, mean=True))


def pmean_metrics(metrics: dict[str, torch.Tensor], axis_name: Any = "data") -> dict:
    """The metrics averaged over the replicas (one reduction)."""
    if axis_size(axis_name) == 1 or not metrics:
        return metrics
    keys = list(metrics)
    packed = psum(torch.stack([metrics[k].detach().float() for k in keys]), axis_name, mean=True)
    return {k: packed[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


# -- telemetry ----------------------------------------------------------------


def wire_bytes(tree: Any, config: GradCommsConfig) -> tuple[int, int]:
    """(pre, post) gradient wire bytes for one reduction pass over
    ``tree`` (tensors, or a module's parameters): pre is the
    uncompressed payload, post the quantized blocks plus per-block fp32
    scales (equal when not quantizing)."""
    leaves = list(tree.parameters()) if isinstance(tree, nn.Module) else _leaves(tree)[0]
    pre = post = 0
    q_int = not config.qdtype.is_floating_point
    q_item = torch.empty((), dtype=config.qdtype).element_size()
    for leaf in leaves:
        size = leaf.numel()
        nbytes = size * leaf.element_size()
        pre += nbytes
        if config.quantize and leaf.is_floating_point():
            n_blocks = math.ceil(size / config.block_size)
            post += size * q_item + (4 * n_blocks if q_int else 0)
        else:
            post += nbytes
    return pre, post


def instrument_step(step_fn: Callable[..., Any], config: GradCommsConfig,
                    steps_per_call: int = 1) -> Callable[..., Any]:
    """Wrap a grad-comms step with telemetry: per-call pre/post byte
    counters, the compression-ratio gauge and a
    ``span("grad_comms.all_reduce")`` around the call (host time).
    ``steps_per_call`` scales the counters for a step that runs several
    updates per call (the ``grad_comms_steps`` attribute)."""
    from hops_tpu_torch.telemetry.metrics import REGISTRY
    from hops_tpu_torch.telemetry.spans import span

    mode = config.mode
    pre_c = REGISTRY.counter("hops_tpu_grad_comms_bytes_pre_total",
                             "Gradient wire bytes per step before compression", labels=("mode",))
    post_c = REGISTRY.counter("hops_tpu_grad_comms_bytes_post_total",
                              "Gradient wire bytes per step after compression", labels=("mode",))
    ratio_g = REGISTRY.gauge("hops_tpu_grad_comms_compression_ratio",
                             "Gradient compression ratio (pre / post wire bytes)",
                             labels=("mode",))

    @functools.wraps(step_fn)
    def wrapped(state, *args, **kwargs):
        carrier = getattr(state, "shards", None)
        if isinstance(carrier, Zero3Shards):
            # The reference counts ZeRO-3's padded flat shards.
            tree = [torch.empty((m[3],), dtype=m[1], device="meta") for m in carrier.meta]
        else:
            tree = getattr(state, "model", state)
        pre, post = wire_bytes(tree, config)
        pre_c.inc(pre * steps_per_call, mode=mode)
        post_c.inc(post * steps_per_call, mode=mode)
        ratio_g.set(pre / post if post else 1.0, mode=mode)
        with span("grad_comms.all_reduce", mode=mode):
            return step_fn(state, *args, **kwargs)

    return wrapped
