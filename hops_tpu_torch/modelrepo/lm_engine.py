"""Continuous batching for LM serving (counterpart of
``hops_tpu/modelrepo/lm_engine.py``).

Requests of different prompt lengths and generation budgets share a
fixed set of decode *slots*. Each engine iteration admits queued
requests into free slots and then runs one decode dispatch for every
slot; a request that finishes frees its slot at once and the next queued
request takes it. The cache has one of two layouts.

Dense (the default):

- The per-layer KV caches are one ``(slots, heads, capacity, d)`` buffer
  per layer, alive across requests, with a ``(slots,)`` cache index
  (``TransformerLM(ragged_decode=True)``): every slot advances on its
  own and the decode kernel reads each row only up to its own length.
  An int8 model (``kv_cache_dtype="int8"``) stores them quantized.
- Admission prefills the admitted rows straight into their slots of the
  persistent cache (``model(..., fresh=True, rows=...)``): prompts are
  padded to a length bucket, rows not admitted are left exactly as they
  were, and each admitted row's index rewinds to its true length, so
  the pad garbage past it is never read. A request under a registered
  prefix (:meth:`LMEngine.register_prefix`) copies the stored prefix
  rows into its slot and appends its suffix there.
- Rows not decoding stay in the decode batch with their index at 0: a
  free row writes one position, attends nothing, and its token is
  discarded.

Paged (``kv_page_size``): the caches are one block pool per layer
(``kv_pool_blocks`` pages, bf16/fp32 or int8) and a ``(slots,
max_blocks)`` page table, so persistent memory is bounded by live tokens
rather than ``slots x max_decode_len``. Admission is bookkeeping only
(:class:`~hops_tpu_torch.modelrepo.paged.BlockPool`): the prompt's
blocks, or the request queues if the pool cannot hold them. Prompts then
prefill in ``prefill_chunk``-token chunks fused into the same call as
the decode step of every other live slot (chunked prefill), blocks
allocate as decode advances, and a dry pool preempts the newest request,
which replays from the front of the queue to the same stream. A prefix
hit shares the prefix's complete pages through the pool's reference
counts and recomputes from the first incomplete page (copy-on-write).
A row that rides a call without work has its page-table row masked to
the scratch block for that call.

Three levers compose on both layouts: ``decode_horizon`` runs that many
decode steps between host read-backs, with tokens, the live mask,
budgets and eos ids kept on the device; ``draft_model`` speculates
``spec_k - 1`` tokens per slot and dispatch, each slot keeping its own
accepted prefix; and priority admission serves ``interactive`` requests
before ``batch`` ones under a starvation guard. The host holds each
row's cache index and sets it before every dispatch.

Greedy decoding emits exactly what per-request ``generate(...,
temperature=0)`` emits, in both layouts, at any horizon, with or without
a draft or a prefix. Sampled requests draw with keys ``(seed, token
index)`` (:func:`hops_tpu_torch.models.generation.draw_rows`), so a
stream does not depend on its slot, its batch company, the layout, the
horizon or a preemption.

``mesh`` serves tensor-parallel over its ``tp_axis``: every rank of the
axis builds the engine from the same dense model and runs the same
host schedule on the same submitted requests (SPMD, as the JAX engine
runs its programs under ``shard_map``); each holds its Megatron shard
of the weights and a cache at its local heads, and only the per-block
sums cross ranks (:mod:`hops_tpu_torch.parallel.tp_inference`). Those
sums fold in rank order, so every rank draws the same tokens.

The engine times itself on one phase clock
(:class:`~hops_tpu_torch.telemetry.spans.Phases`; host seconds and
counts, read through :meth:`LMEngine.stats`): each request's queue wait
(``lm_engine.queue_wait``: submit, or requeue after a preemption, to
admission) and first-token hold (``lm_engine.first_token_hold``: its
first token on the host to the end of that ``step()``), and the phases
``lm_engine.prefill`` (child ``lm_engine.prefill.launch``: up to the
first-token read-back) and ``lm_engine.decode`` (children
``lm_engine.decode.launch``: up to the last launch of the horizon, and
``lm_engine.decode.readback``; the rest is the host's row-by-row
replay). While a ``torch.profiler`` records, each phase is also a
``record_function`` range, inside an ``lm_engine.step`` range per
``step()``; with none recording, no range is opened.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from hops_tpu_torch.models.generation import draw_rows, top_p_mask, uniform_rows
from hops_tpu_torch.modelrepo.paged import BlockPool
from hops_tpu_torch.runtime import faultinject, flight, qos
from hops_tpu_torch.runtime.devices import resolve_device
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY
from hops_tpu_torch.telemetry.spans import Phases, annotate

log = get_logger(__name__)

#: A bounded submit queue is full (:class:`hops_tpu_torch.runtime.qos.QueueFullError`).
QueueFullError = qos.QueueFullError


def _filter_rows(logits, temps, topks, topps, use_top_p=False):
    """The per-row sampling filter: temperature-scale, top-k-mask and
    (``use_top_p``) nucleus-mask ``(rows, vocab)`` logits.
    ``temps[i] <= 0`` rows divide by 1e-6."""
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    srt = torch.sort(logits, dim=-1).values  # ascending
    k_eff = torch.clamp(torch.where(topks > 0, topks, v), 1, v)
    kth = torch.gather(srt, -1, (v - k_eff)[:, None])
    masked = logits.masked_fill(logits < kth, float("-inf"))
    scaled = masked / torch.clamp_min(temps, 1e-6)[:, None]
    if use_top_p:
        srt_desc = srt.flip(-1)
        srt_desc = srt_desc.masked_fill(srt_desc < kth, float("-inf"))
        srt_desc = srt_desc / torch.clamp_min(temps, 1e-6)[:, None]
        scaled = top_p_mask(scaled, topps, sorted_desc=srt_desc)
    return scaled


@dataclasses.dataclass
class _Sampling:
    """Per-row sampling knobs on the device. ``sampled`` is False when
    every row is greedy: then only ``argmax`` runs (the knob tensors are
    None); ``nucleus`` when some sampled row has ``0 < top_p < 1``."""

    sampled: bool
    nucleus: bool = False
    temps: torch.Tensor | None = None
    topks: torch.Tensor | None = None
    topps: torch.Tensor | None = None
    seeds: torch.Tensor | None = None

    def keys(self, ns: torch.Tensor, purpose: int | None = None) -> torch.Tensor:
        """Draw keys ``(seed, n)``, or ``(seed, purpose, n)`` for the
        speculative path's draft draws, acceptances and residuals."""
        cols = [self.seeds, ns] if purpose is None else [
            self.seeds, torch.full_like(ns, purpose), ns]
        return torch.stack(cols, dim=1)

    def filtered(self, logits: torch.Tensor, repeat: int = 1) -> torch.Tensor:
        """:func:`_filter_rows` with each row's knobs repeated ``repeat``
        times (the rows of a speculative chunk)."""
        rep = (lambda t: t) if repeat == 1 else (lambda t: t.repeat_interleave(repeat))
        return _filter_rows(logits, rep(self.temps), rep(self.topks), rep(self.topps),
                            self.nucleus)

    def sample(self, logits: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
        """One token per row of fp32 ``(rows, vocab)`` logits, on the
        device: greedy rows take the argmax, sampled rows draw with key
        ``(seed, n)``."""
        greedy = torch.argmax(logits.to(torch.float32), dim=-1)
        if not self.sampled:
            return greedy
        drawn = draw_rows(self.filtered(logits), self.keys(ns))
        return torch.where(self.temps <= 0, greedy, drawn)


def _sampling(items: list[Any], device) -> _Sampling:
    """The knobs of ``items`` (requests or slot states, None for rows
    without one) as device tensors."""
    live = [it for it in items if it is not None]
    if not any(it.temperature > 0 for it in live):
        return _Sampling(sampled=False)
    nucleus = any(it.temperature > 0 and 0.0 < it.top_p < 1.0 for it in live)
    ints = torch.tensor([[it.top_k, it.seed] if it else [0, 0] for it in items])
    floats = torch.tensor([[it.temperature, it.top_p] if it else [0.0, 0.0] for it in items])
    ints, floats = ints.to(device), floats.to(device)
    return _Sampling(True, nucleus, floats[:, 0], ints[:, 0], floats[:, 1], ints[:, 1])


@dataclasses.dataclass
class _Request:
    ticket: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    eos_id: int | None
    temperature: float = 0.0
    top_k: int = 0  # 0 = no top-k truncation
    top_p: float = 0.0  # 0 = no nucleus truncation
    seed: int = 0
    # Snapshot taken at submit time, so re-registering the name cannot
    # swap a queued request's prefix. Dense: (target prefix cache, draft
    # prefix cache or None, length); paged: a _PagedPrefix.
    prefix: Any = None
    # The prefix_id it was submitted under: the key that groups
    # same-prefix requests into one admission wave.
    prefix_key: str | None = None
    submitted_at: float = 0.0  # monotonic submit time, the TTFT start mark
    queued_at: float = 0.0  # perf_counter of submit or of a preemption's requeue
    priority: str = "interactive"  # qos class: interactive | batch
    # A preempted request replays from scratch; its TTFT was observed
    # the first time around.
    ttft_observed: bool = False

    @property
    def prefix_len(self) -> int:
        if self.prefix is None:
            return 0
        if isinstance(self.prefix, _PagedPrefix):
            return int(self.prefix.tokens.size)
        return self.prefix[2]


@dataclasses.dataclass
class _Marks:
    """One ticket's host-clock marks (``time.perf_counter``) and the
    intervals read from them."""

    queue_wait_s: float = 0.0  # every wait in the queue, requeues included
    first_at: float | None = None  # its first token reached the host
    first_token_hold_s: float | None = None  # first_at to the end of that step()


@dataclasses.dataclass
class _PagedPrefix:
    """A prefix registered on the paged engine: its tokens and, once the
    first request naming it has prefilled past it, the physical blocks
    that hold its complete pages, one registry reference each. Later
    admissions point their page tables at these blocks (one reference
    per reader) and recompute from the first incomplete block."""

    name: str
    tokens: np.ndarray  # (L,) int32
    blocks: list[int] | None = None  # complete pages only: L // page blocks


@dataclasses.dataclass
class _SlotState:
    ticket: int
    emitted: list[int]
    remaining: int
    eos_id: int | None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    n_sampled: int = 1  # tokens drawn so far (prefill's counts as #0)
    prompt_total: int = 0  # prefix + prompt tokens
    # --- paged-engine scheduling state (unused on the dense engine) ---
    req: _Request | None = None  # for a preemption's requeue
    pending: np.ndarray | None = None  # prompt tokens not prefilled yet
    base_len: int = 0  # tokens written so far by prefill chunks
    worst_len: int = 0  # deepest position this request can ever write
    blocks: list[int] | None = None  # physical blocks, logical order
    shared_hit: bool = False  # admission shared a prefix's pages
    seq: int = 0  # admission order: preemption takes the newest

    @property
    def written(self) -> int:
        """Positions in the cache once prefilled: the newest emitted
        token is not written yet."""
        return self.prompt_total + len(self.emitted) - 1


class LMEngine:
    """Continuous-batching scheduler over ``slots`` concurrent decodes.

    ``model`` must be a ``TransformerLM(ragged_decode=True)`` on
    ``device`` (``None`` = the card) whose ``max_decode_len`` covers every
    request's prompt + generation. ``submit()`` enqueues and returns a
    ticket; ``step()`` runs one engine iteration (admit into free slots,
    then one decode dispatch); ``run()`` drains everything and returns
    ``{ticket: tokens}``; ``run_offline()`` drains a known workload in
    waves of one prefill and one decode horizon each. The engine is not
    thread-safe: callers sharing it across threads hold their own lock
    (``serving.LMEnginePredictor``).

    ``decode_horizon`` decode steps run per dispatch with one host
    read-back; rows retire on the device exactly where the host loop
    would retire them, so the streams do not depend on it. New requests
    are admitted only between horizons, and the paged engine uses one
    step while any slot is still prefilling.

    ``draft_model`` (a ragged ``TransformerLM`` on the same device, and
    the same ``max_decode_len`` on the paged layout, whose pools share the
    target's page table) proposes ``spec_k - 1`` tokens per slot and
    dispatch; the target scores each slot's ``[token, proposals]`` in one
    warm append of ``spec_k`` tokens, and each slot keeps its own longest
    accepted prefix plus the target's token after it. Sampled rows use
    rejection sampling, so their tokens keep the target's law.

    ``kv_page_size`` switches to the paged layout on clones of ``model``
    (and the draft) (``paged_decode=True``, weights shared):
    ``kv_pool_blocks`` defaults to the dense reservation's token capacity
    plus the scratch block (``1 + slots * ceil(max_decode_len / page)``),
    ``prefill_chunk`` to ``min(64, max_decode_len)``.

    ``mesh`` (a port :class:`~hops_tpu_torch.parallel.mesh.Mesh` with a
    ``tp_axis`` axis) makes this rank's engine one tensor-parallel shard:
    the dense ``model`` (and ``draft_model``, whose heads must divide the
    degree too) are sliced to this rank's shard at construction and
    every cache (dense, int8, paged, the draft's) is sized at local
    heads. Every rank must submit the same requests in the same order.
    """

    def __init__(
        self,
        model,
        slots: int = 4,
        prefill_buckets: tuple[int, ...] | None = None,
        decode_horizon: int = 1,
        mesh: Any = None,
        tp_axis: str = "model",
        draft_model: Any = None,
        spec_k: int = 4,
        kv_page_size: int | None = None,
        kv_pool_blocks: int | None = None,
        prefill_chunk: int | None = None,
        max_queue: int = 1024,
        device: str | torch.device | None = None,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if not getattr(model, "ragged_decode", False):
            raise ValueError(
                "LMEngine requires TransformerLM(ragged_decode=True) — the "
                "(slots,) cache index is what lets rows advance independently"
            )
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got {decode_horizon}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine asked for {self.device}")
        if draft_model is not None:
            if spec_k < 2:
                raise ValueError(f"spec_k must be >= 2, got {spec_k}")
            if not getattr(draft_model, "ragged_decode", False):
                raise ValueError("draft_model needs ragged_decode=True too")
            if draft_model.device != self.device:
                raise ValueError(f"draft_model is on {draft_model.device}, "
                                 f"engine asked for {self.device}")
        self.mesh = mesh
        if mesh is not None:
            from hops_tpu_torch.parallel.tp_inference import tp_shard_model

            shards = mesh.shape[tp_axis]
            if draft_model is not None:
                # The draft shards the same Megatron way: its heads must
                # divide the tp degree just like the target's.
                dcfg = draft_model.config
                dh = dcfg["num_kv_heads"] or dcfg["num_heads"]
                if dcfg["num_heads"] % shards or dh % shards:
                    raise ValueError(f"draft heads {dcfg['num_heads']}/{dh} not divisible by "
                                     f"tp degree {shards}")
                draft_model = tp_shard_model(draft_model, mesh, tp_axis)
            model = tp_shard_model(model, mesh, tp_axis)
        cap = model.max_decode_len
        self._paged = kv_page_size is not None
        self._pool = None
        self.prefill_chunk = None
        if self._paged:
            if kv_page_size < 1:
                raise ValueError(f"kv_page_size must be >= 1, got {kv_page_size}")
            self._page_size = int(kv_page_size)
            self._max_blocks = -(-cap // self._page_size)
            if kv_pool_blocks is None:
                # Parity default: the dense reservation's token capacity
                # plus the scratch block. Shrink it to save memory; the
                # scheduler queues and preempts when it runs dry.
                kv_pool_blocks = 1 + slots * self._max_blocks
            if kv_pool_blocks < 2:
                raise ValueError(f"kv_pool_blocks must be >= 2, got {kv_pool_blocks}")
            self.prefill_chunk = int(prefill_chunk or min(64, cap))
            if not 1 <= self.prefill_chunk <= cap:
                raise ValueError(
                    f"prefill_chunk must be in [1, {cap}], got {self.prefill_chunk}")
            paged = dict(paged_decode=True, kv_page_size=self._page_size,
                         kv_pool_blocks=int(kv_pool_blocks))
            model = model.clone(**paged)
            if draft_model is not None:
                if draft_model.max_decode_len != cap:
                    raise ValueError(
                        "paged speculative engine needs draft.max_decode_len == "
                        f"model.max_decode_len ({draft_model.max_decode_len} != {cap}) — "
                        "the two pools share one page table")
                draft_model = draft_model.clone(**paged)
            self._pool = BlockPool(int(kv_pool_blocks))
            self._pages_np = np.zeros((slots, self._max_blocks), np.int32)
            self._pages_dirty = True
        elif prefill_chunk is not None:
            raise ValueError(
                "prefill_chunk requires the paged cache (kv_page_size=): "
                "chunked prefill writes in place through page tables")
        self.model = model
        self.draft_model = draft_model
        self.spec_k = int(spec_k) if draft_model is not None else 0
        self.slots = slots
        self.max_queue = int(max_queue)
        self.decode_horizon = int(decode_horizon)
        # A speculative engine is bounded by the smaller of its caches.
        self._cap = min(cap, draft_model.max_decode_len) if draft_model is not None else cap
        if prefill_buckets is None:
            prefill_buckets = tuple(
                b for b in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096) if b < cap
            ) or (cap,)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self._cache = model.init_cache(slots)
        self._draft_cache = draft_model.init_cache(slots) if draft_model is not None else None
        if self._paged:
            # One device page table, shared by every layer of both caches.
            self._pages_dev = self._cache.pages
            if self._draft_cache is not None:
                self._draft_cache.pages = self._pages_dev
        self._queue: collections.deque[_Request] = collections.deque()
        self._slot_state: list[_SlotState | None] = [None] * slots
        self._results: dict[int, list[int]] = {}
        self._errors: dict[int, BaseException] = {}
        self._admitting: list[_Request] = []  # popped, not yet slotted
        # Dense: (target cache, draft cache or None, length) per name;
        # paged: a _PagedPrefix.
        self._prefixes: dict[str, Any] = {}
        # Interactive requests take free slots first; after 8 in a row
        # while batch work waits, a batch request is admitted.
        self._admission_guard = qos.StarvationGuard(limit=8)
        self._next_ticket = 0
        self.dispatches = 0
        self.tokens_emitted = 0
        self.prefix_hits = 0
        self.admission_waves = 0
        self.spec_accepted = 0  # accepted proposals ...
        self.spec_offered = 0  # ... of the proposal slots offered
        self._occ_sum = 0.0
        self._admit_seq = 0
        self.prefill_chunks = 0  # paged: prompt chunks prefilled
        self.preemptions = 0  # paged: requests sent back to the queue
        # The phase clock (module docstring). Admission prefills (paged:
        # calls that carry a prompt chunk, with the decode rows riding
        # along) and decode dispatches each end by reading their tokens
        # back, so the device work is inside their phases.
        self._phases = Phases()
        #: Tokens emitted by decode dispatches.
        self.decode_tokens = 0
        #: Host read-backs of decode dispatches (one per horizon).
        self.readbacks = 0
        #: Per-ticket time to first token (seconds), consumed by take_result.
        self.ttft_s: dict[int, float] = {}
        # Per-ticket marks, dropped by take_result / take_error / cancel.
        self._marks: dict[int, _Marks] = {}
        self._holding: list[_Marks] = []  # first tokens of the running step()
        # Process-wide registry metrics, shared by every engine.
        self._m_dispatches = REGISTRY.counter(
            "hops_tpu_lm_dispatches_total", "LM engine device dispatches").labels()
        self._m_tokens = REGISTRY.counter(
            "hops_tpu_lm_tokens_total", "Tokens emitted by the LM engine").labels()
        self._m_ttft = REGISTRY.histogram(
            "hops_tpu_lm_ttft_seconds",
            "Time from submit to a request's first emitted token").labels()
        self._m_occupancy = REGISTRY.gauge(
            "hops_tpu_lm_slot_occupancy",
            "Busy decode slots / total slots, sampled at dispatch time").labels()
        self._m_prefix_cache = REGISTRY.counter(
            "hops_tpu_lm_prefix_cache_total", "Admissions by prefix-cache outcome",
            labels=("result",))
        self._m_prefix_batched = REGISTRY.counter(
            "hops_tpu_lm_prefix_batched_total",
            "Requests admitted in a wave with another request sharing their prefix "
            "(prefix-aware admission ordering)").labels()
        self._m_pool_util = REGISTRY.gauge(
            "hops_tpu_lm_block_pool_utilization",
            "Live KV blocks / allocatable pool blocks, sampled at dispatch time").labels()
        self._m_prefill_chunks = REGISTRY.counter(
            "hops_tpu_lm_prefill_chunks_total",
            "Prompt chunks prefilled by the paged engine").labels()
        self._m_preemptions = REGISTRY.counter(
            "hops_tpu_lm_preemptions_total",
            "Requests preempted (blocks freed, requeued for replay) because the "
            "block pool ran dry").labels()
        self._m_dispatch_failures = REGISTRY.counter(
            "hops_tpu_lm_dispatch_failures_total",
            "Engine dispatch waves that raised; their in-flight requests were "
            "failed and the scheduler continued").labels()

    # --- public API -----------------------------------------------------

    @torch.inference_mode()
    def register_prefix(self, name: str, tokens: Any) -> str:
        """Register a shared prompt prefix (a system prompt); requests
        that ``submit(..., prefix_id=name)`` start from it and compute
        only their own suffix. Re-registering a name replaces it; queued
        requests keep the prefix they were submitted under.

        Dense: the prefix is prefilled now and its cache rows stored (the
        draft's too on a speculative engine). Paged: nothing is computed
        here; the first request that names it prefills it, and its
        complete pages are then shared with every later one."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("empty prefix")
        if tokens.size >= self._cap:
            raise ValueError(f"prefix {tokens.size} leaves no room in "
                             f"max_decode_len {self._cap}")
        if self._paged:
            old = self._prefixes.get(name)
            if isinstance(old, _PagedPrefix) and old.blocks:
                # Blocks still shared by live requests survive until
                # those finish.
                self._pool.unref_all(old.blocks)
                old.blocks = None
            self._prefixes[name] = _PagedPrefix(name=name, tokens=tokens)
            return name
        n = tokens.size
        padded = np.zeros((1, min(self._bucket(n), self._cap)), np.int64)
        padded[0, :n] = tokens
        padded = torch.from_numpy(padded).to(self.device)
        stored = []
        for model in (self.model, self.draft_model):
            if model is None:
                stored.append(None)
                continue
            cache = model.init_cache(1)
            model(padded, cache, fresh=True, return_hidden=True)
            stored.append(cache.copy_prefix(0, n))
        self._prefixes[name] = (stored[0], stored[1], n)
        return name

    def submit(
        self,
        prompt: Any,
        max_new_tokens: int = 32,
        eos_id: int | None = None,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        seed: int = 0,
        prefix_id: str | None = None,
        priority: str = "interactive",
    ) -> int:
        """Enqueue a request. ``temperature=0`` is greedy; otherwise tokens
        draw from the (optionally top-k- and/or top-p-truncated) scaled
        distribution with keys that depend only on ``seed`` and the token
        index. With ``prefix_id``, ``prompt`` is the suffix after a
        prefix registered by :meth:`register_prefix`. ``priority``
        (``interactive`` | ``batch``; anything else counts as batch)
        orders admission and never changes a request's tokens. Raises
        :class:`QueueFullError` when ``max_queue`` requests are already
        queued."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        prefix = None
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id!r} — register_prefix first")
            prefix = self._prefixes[prefix_id]
        req = _Request(
            self._next_ticket, prompt, int(max_new_tokens), eos_id,
            temperature=float(temperature), top_k=int(top_k or 0),
            top_p=float(top_p or 0.0), seed=int(seed) & 0x7FFFFFFF, prefix=prefix,
            prefix_key=prefix_id, submitted_at=time.monotonic(),
            queued_at=time.perf_counter(),
            priority=priority if priority in qos.PRIORITIES else "batch",
        )
        total = req.prefix_len + prompt.size + max_new_tokens
        if total > self.model.max_decode_len:
            raise ValueError(
                f"prefix {req.prefix_len} + prompt {prompt.size} + {max_new_tokens} new "
                f"tokens exceeds max_decode_len {self.model.max_decode_len}"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # The deepest speculative write: the last dispatch enters with at
        # most total - 2 tokens written and writes spec_k positions.
        slack = max(0, self.spec_k - 2)
        if self.spec_k and total + slack > self._cap:
            raise ValueError(
                f"prefix {req.prefix_len} + prompt {prompt.size} + {max_new_tokens} new "
                f"tokens (+{slack} speculation slack) exceeds max_decode_len {self._cap}"
            )
        if self._paged:
            # The deepest position this request can ever write must fit
            # the pool even when it is the only live request: preemption
            # can evict every other request, never this one.
            need = -(-(total + slack) // self._page_size)
            if need > self._pool.total:
                raise ValueError(
                    f"request needs {need} KV blocks at its deepest write; the pool "
                    f"has {self._pool.total} (kv_pool_blocks={self._pool.num_blocks}, "
                    f"page={self._page_size})")
        # Admission bound last: malformed requests above are ValueErrors;
        # only a well-formed request at a full queue is a retryable shed.
        if len(self._queue) >= self.max_queue:
            raise QueueFullError(
                f"submit queue full ({len(self._queue)}/{self.max_queue} queued); retry later"
            )
        self._next_ticket += 1
        self._queue.append(req)
        self._marks[req.ticket] = _Marks()
        return req.ticket

    @torch.inference_mode()
    def step(self) -> list[int]:
        """One engine iteration: admit queued requests into free slots,
        then one decode dispatch (``decode_horizon`` steps) for all
        slots. Returns the tickets that finished this iteration.

        A failure during the iteration (the ``lm_engine.dispatch`` fault
        point, or a kernel that raises) fails only the in-flight
        requests (retrievable per ticket through :meth:`take_error`);
        their slots and blocks free and the engine keeps serving the
        queue.
        """
        with annotate("lm_engine.step"):
            try:
                faultinject.fire("lm_engine.dispatch")
                self._order_queue_for_prefix_waves()
                out = self._step_paged() if self._paged else self._step_dense()
                self._count_prefix_batched()
                return out
            except Exception as e:  # noqa: BLE001 — isolate to in-flight work
                return self._fail_inflight(e)
            finally:
                self._admitting.clear()
                self._close_holds()

    def run(self) -> dict[int, list[int]]:
        """Drain the queue and all live slots; returns every result
        collected so far."""
        while self.has_work:
            self.step()
        return dict(self._results)

    @torch.inference_mode()
    def run_offline(self) -> dict[int, list[int]]:
        """Drain every queued request in budget-sorted waves of up to
        ``slots`` requests, each ONE dispatch: a prefill of the wave, then
        a decode horizon of the next power of two above the wave's
        largest remaining budget, with rows retiring on the device and
        one read-back at the end. The streams equal :meth:`run`'s.

        Speculative and paged engines, queued prefix requests and drains
        started with live slots use :meth:`run`."""
        if (self.spec_k or self._paged or any(r.prefix is not None for r in self._queue)
                or any(st is not None for st in self._slot_state)):
            return self.run()
        # Budget-major, bucket-minor: a wave pads to its own longest
        # budget and prompt. Unprocessed requests stay queued if a wave
        # raises.
        self._queue = collections.deque(sorted(
            self._queue, key=lambda r: (r.max_new_tokens, self._bucket(r.prompt.size)),
            reverse=True,
        ))
        while self._queue:
            wave = [self._pop_queue() for _ in range(min(self.slots, len(self._queue)))]
            try:
                self._run_offline_wave(wave)
            except BaseException:
                self._queue.extendleft(reversed(wave))
                raise
            finally:
                self._close_holds()
        return dict(self._results)

    def result(self, ticket: int) -> list[int] | None:
        """Generated tokens (prompt excluded), or None if not finished."""
        return self._results.get(ticket)

    def take_result(self, ticket: int) -> list[int] | None:
        """Like :meth:`result` but consuming (and drops the ticket's TTFT
        and marks)."""
        self.ttft_s.pop(ticket, None)
        self._marks.pop(ticket, None)
        return self._results.pop(ticket, None)

    def error(self, ticket: int) -> BaseException | None:
        return self._errors.get(ticket)

    def take_error(self, ticket: int) -> BaseException | None:
        self._marks.pop(ticket, None)
        return self._errors.pop(ticket, None)

    def cancel(self, ticket: int) -> bool:
        """Remove a still-queued request; returns whether one was removed."""
        for req in self._queue:
            if req.ticket == ticket:
                self._queue.remove(req)
                self._marks.pop(ticket, None)
                return True
        return False

    def request_times(self, ticket: int) -> dict[str, float | None] | None:
        """A live ticket's host-clock intervals in seconds: its time in
        the queue (``queue_wait_s``, every wait if it was preempted) and
        from its first token reaching the host to the end of that
        ``step()`` (``first_token_hold_s``, None before then). None for
        a ticket already taken."""
        m = self._marks.get(ticket)
        if m is None:
            return None
        return {"queue_wait_s": m.queue_wait_s, "first_token_hold_s": m.first_token_hold_s}

    def stats(self) -> dict[str, Any]:
        ph = self._phases
        out = {
            "dispatches": self.dispatches,
            "tokens_emitted": self.tokens_emitted,
            "tokens_per_dispatch": round(self.tokens_emitted / max(self.dispatches, 1), 3),
            "prefix_hits": self.prefix_hits,
            "admission_waves": self.admission_waves,
            "queued": len(self._queue),
            "slots_busy": sum(st is not None for st in self._slot_state),
            "slots": self.slots,
            "decode_horizon": self.decode_horizon,
            "mean_occupancy": round(self._occ_sum / max(self.dispatches, 1), 4),
            "cache_layout": "paged" if self._paged else "dense",
            "prefill_s": ph.seconds("lm_engine.prefill"),
            "decode_s": ph.seconds("lm_engine.decode"),
            "decode_tokens": self.decode_tokens,
            "readbacks": self.readbacks,
            "queue_wait_s": ph.seconds("lm_engine.queue_wait"),
            "admitted": ph.count("lm_engine.queue_wait"),
            "prefill_launch_s": ph.seconds("lm_engine.prefill.launch"),
            "first_token_hold_s": ph.seconds("lm_engine.first_token_hold"),
            "decode_launch_s": ph.seconds("lm_engine.decode.launch"),
            "decode_readback_s": ph.seconds("lm_engine.decode.readback"),
        }
        if self._paged:
            out.update(self._pool.stats())
            out.update(page_size=self._page_size, prefill_chunk=self.prefill_chunk,
                       prefill_chunks=self.prefill_chunks, preemptions=self.preemptions)
        if self.spec_k:
            out["spec_k"] = self.spec_k
            out["spec_acceptance"] = round(self.spec_accepted / max(self.spec_offered, 1), 3)
        return out

    @property
    def has_failures(self) -> bool:
        return bool(self._errors)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(st is not None for st in self._slot_state)

    # --- admission order ------------------------------------------------

    def _promote_next_admission(self) -> None:
        """Move the priority-admission winner to the queue head: FIFO
        within a class, interactive first, and the starvation guard
        forces a batch admission after ``limit`` interactive ones in a
        row while batch work waits. A no-op with one class queued."""
        if len(self._queue) <= 1:
            return
        ranks = [qos.rank(r.priority) for r in self._queue]
        if len(set(ranks)) <= 1:
            return
        want = self._admission_guard.pick_rank(ranks)
        idx = ranks.index(want)
        if idx:
            req = self._queue[idx]
            del self._queue[idx]
            self._queue.appendleft(req)

    def _order_queue_for_prefix_waves(self) -> None:
        """Stable-group the queue so requests under the same
        ``prefix_id`` sit together and share an admission wave. A group
        anchors at its oldest queued member and pulls at most ``slots``
        members forward; later arrivals anchor a new group at their own
        position, so a hot prefix overtakes an older request by at most
        one wave. Prefix-less requests keep their positions, and streams
        do not depend on placement, so outputs equal FIFO admission's."""
        if len(self._queue) < 2 or not any(r.prefix_key is not None for r in self._queue):
            return
        q = list(self._queue)
        wave_rank: dict[str, int] = {}
        wave_fill: dict[str, int] = {}
        ranks = []
        for pos, req in enumerate(q):
            key = req.prefix_key
            if key is None:
                ranks.append(pos)
                continue
            if wave_fill.get(key, self.slots) >= self.slots:
                wave_rank[key] = pos  # start a new wave here
                wave_fill[key] = 0
            ranks.append(wave_rank[key])
            wave_fill[key] += 1
        if all(a <= b for a, b in zip(ranks, ranks[1:])):
            return
        order = sorted(range(len(ranks)), key=ranks.__getitem__)
        self._queue = collections.deque(q[i] for i in order)

    def _count_prefix_batched(self) -> None:
        """Count requests whose admission wave held another request
        under the same prefix."""
        keys: dict[str, int] = {}
        for req in self._admitting:
            if req.prefix_key is not None:
                keys[req.prefix_key] = keys.get(req.prefix_key, 0) + 1
        batched = sum(c for c in keys.values() if c >= 2)
        if batched:
            self._m_prefix_batched.inc(batched)

    # --- bookkeeping ----------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self._cap

    def _mark_dispatch(self) -> None:
        self.dispatches += 1
        self._m_dispatches.inc()
        occ = sum(st is not None for st in self._slot_state) / self.slots
        self._occ_sum += occ
        self._m_occupancy.set(occ)
        if self._paged:
            self._m_pool_util.set(self._pool.stats()["utilization"])

    def _pop_queue(self) -> _Request:
        """Admit the queue head: its wait ends here."""
        req = self._queue.popleft()
        wait = time.perf_counter() - req.queued_at
        self._phases.add("lm_engine.queue_wait", wait)
        m = self._marks.get(req.ticket)
        if m is not None:
            m.queue_wait_s += wait
        return req

    def _observe_ttft(self, req: _Request) -> None:
        """Once per request: a preempted request keeps its first TTFT.
        Its first token is on the host: the hold to the end of this
        ``step()`` starts."""
        if not req.ttft_observed:
            dt = time.monotonic() - req.submitted_at
            self._m_ttft.observe(dt)
            self.ttft_s[req.ticket] = dt
            req.ttft_observed = True
            m = self._marks.get(req.ticket)
            if m is not None:
                m.first_at = time.perf_counter()
                self._holding.append(m)

    def _close_holds(self) -> None:
        """End the first-token holds of the running ``step()``."""
        if not self._holding:
            return
        now = time.perf_counter()
        for m in self._holding:
            m.first_token_hold_s = now - m.first_at
            self._phases.add("lm_engine.first_token_hold", m.first_token_hold_s)
        self._holding.clear()

    def _emit(self, n: int = 1) -> None:
        self.tokens_emitted += n
        self._m_tokens.inc(n)

    def _register(self, row: int, req: _Request, tok: int) -> int | None:
        """Dense admission: record the first emitted token and occupy (or
        immediately finish) the slot."""
        self._emit()
        self._m_prefix_cache.inc(result="hit" if req.prefix is not None else "miss")
        self._observe_ttft(req)
        self._slot_state[row] = _SlotState(
            ticket=req.ticket, emitted=[tok], remaining=req.max_new_tokens - 1,
            eos_id=req.eos_id, temperature=req.temperature, top_k=req.top_k,
            top_p=req.top_p, seed=req.seed,
            prompt_total=req.prefix_len + int(req.prompt.size),
        )
        if req.max_new_tokens == 1 or (req.eos_id is not None and tok == req.eos_id):
            return self._finish(row)
        return None

    def _account(self, row: int, tok: int, finished: list[int]) -> None:
        """Emit one decode token; finish the row at its budget or eos
        (the rule the device-side retirement mirrors)."""
        st = self._slot_state[row]
        st.emitted.append(tok)
        st.remaining -= 1
        st.n_sampled += 1
        self._emit()
        if st.remaining == 0 or (st.eos_id is not None and tok == st.eos_id):
            finished.append(self._finish(row))

    def _finish(self, row: int) -> int:
        st = self._slot_state[row]
        self._results[st.ticket] = st.emitted
        self._slot_state[row] = None
        if st.blocks is not None:
            # Shared prefix pages survive on the registry's reference.
            self._release_blocks(row, st.blocks)
        # Dense: the slot's cache rows stay as they are; the next
        # admission overwrites them and sets the index.
        return st.ticket

    def _fail_inflight(self, exc: BaseException) -> list[int]:
        """Every in-flight request fails with ``exc``; slots and blocks
        free, and the cache indices reset so the engine keeps serving the
        queue."""
        self._m_dispatch_failures.inc()
        failed = []
        for row, st in enumerate(self._slot_state):
            if st is not None:
                self._errors[st.ticket] = exc
                failed.append(st.ticket)
                self._slot_state[row] = None
                if st.blocks is not None:
                    self._release_blocks(row, st.blocks)
        for req in self._admitting:
            # A paged admission preempted back to the queue in this same
            # iteration is still live: it replays.
            if any(r is req for r in self._queue):
                continue
            if req.ticket not in self._errors and req.ticket not in self._results:
                self._errors[req.ticket] = exc
                failed.append(req.ticket)
        self._admitting.clear()
        for cache in (self._cache, self._draft_cache):
            if cache is not None:
                cache.idx = torch.zeros_like(cache.idx)
                if self._paged:
                    cache.pages = self._pages_dev
        log.warning(
            "lm_engine step failed; %d in-flight request(s) failed (%s: %s)",
            len(failed), type(exc).__name__, exc,
        )
        flight.record("dispatch_failure", failed=len(failed),
                      error=f"{type(exc).__name__}: {exc}")
        return []

    # --- device programs ------------------------------------------------
    # Each runs a fixed sequence of model calls on device tensors and
    # returns device tensors: the caller reads them back once.

    def _set_idx(self, idx: torch.Tensor) -> None:
        """Every row's cache index (both caches) from the host's values."""
        for cache in (self._cache, self._draft_cache):
            if cache is not None:
                cache.idx = idx

    def _mask_pages(self, active: torch.Tensor | None) -> None:
        """Paged: point rows outside ``active`` at the scratch block for
        the next call (their one write must not land in a live or shared
        block); ``None`` restores the full table."""
        if not self._paged:
            return
        pages = self._pages_dev
        if active is not None:
            pages = torch.where(active[:, None], pages, torch.zeros_like(pages))
        for cache in (self._cache, self._draft_cache):
            if cache is not None:
                cache.pages = pages

    def _decode_scan(self, cache, tok, live, rem, eos, ns, samp, horizon):
        """``horizon`` decode steps with retirement on the device: a row
        is live going into a step while it has budget left and has not
        emitted its eos; dead rows ride with index 0 (and, paged, the
        scratch block). Returns ``(horizon, rows)`` tokens and live-going-in
        masks."""
        toks, lives = [], []
        for i in range(horizon):
            if i:
                cache.idx = torch.where(live, cache.idx, torch.zeros_like(cache.idx))
            self._mask_pages(live)
            nxt = samp.sample(self.model(tok[:, None], cache)[:, -1], ns + i)
            toks.append(nxt)
            lives.append(live)
            if i + 1 < horizon:
                rem = rem - live.long()
                live = live & (rem > 0) & (nxt != eos)
            tok = nxt
        self._mask_pages(None)
        return torch.stack(toks), torch.stack(lives)

    def _spec_core(self, tok, active, ns, samp):
        """One speculative round for every row: the draft proposes
        ``spec_k - 1`` tokens (it runs ``spec_k`` steps: the last step's
        token is dropped, but its cache write is where a fully accepted
        round resumes), the target scores ``[tok, proposals]`` in one warm
        append, and each row keeps its own accepted count ``a`` and the
        target's token after them (the bonus). Both indices rewind to
        ``idx0 + 1 + a``; the rejected positions past it are never read
        and the next round overwrites them. Sampled rows accept with
        probability ``min(1, p/q)`` and resample a rejection from
        ``norm(max(p - q, 0))``; greedy rows take exact one-hots through
        the same arithmetic, so they stay bit-identical to greedy decoding.
        Keys ``(seed, 7, n)`` draft draws, ``(seed, 8, n)`` acceptances,
        ``(seed, 9, n)`` residuals, at each row's token index ``n``."""
        k = self.spec_k
        tc, dc = self._cache, self._draft_cache
        idx0 = torch.where(active, tc.idx, torch.zeros_like(tc.idx))
        self._set_idx(idx0)
        self._mask_pages(active)
        t, drafts, qs = tok, [], []
        for i in range(k):
            last = self.draft_model(t[:, None], dc)[:, -1].to(torch.float32)
            greedy = torch.argmax(last, dim=-1)
            if samp.sampled:
                scaled = samp.filtered(last)
                if i < k - 1:
                    onehot = torch.nn.functional.one_hot(greedy, last.shape[-1]).to(last.dtype)
                    qs.append(torch.where((samp.temps <= 0)[:, None], onehot,
                                          torch.softmax(scaled, dim=-1)))
                t = torch.where(samp.temps <= 0, greedy,
                                draw_rows(scaled, samp.keys(ns + i, 7)))
            else:
                t = greedy
            drafts.append(t)
        drafts = torch.stack(drafts[: k - 1], dim=1)  # (rows, k-1)
        logits = self.model(torch.cat([tok[:, None], drafts], dim=1), tc)  # (rows, k, V)
        rows, _, v = logits.shape
        preds = torch.argmax(logits, dim=-1)
        if samp.sampled:
            p = torch.softmax(samp.filtered(logits.reshape(rows * k, v), k), dim=-1)
            p = torch.where((samp.temps <= 0)[:, None, None],
                            torch.nn.functional.one_hot(preds, v).to(p.dtype),
                            p.reshape(rows, k, v))
            q = torch.stack(qs, dim=1)
            px = torch.gather(p[:, : k - 1], 2, drafts[..., None])[..., 0]
            qx = torch.gather(q, 2, drafts[..., None])[..., 0]
            us = torch.stack([uniform_rows(samp.keys(ns + i, 8), 1)[:, 0]
                              for i in range(k - 1)], dim=1)
            accepts = us * qx < px
        else:
            accepts = drafts == preds[:, : k - 1]
        # a = the first rejected slot (k - 1 when all are accepted).
        a = torch.argmin(torch.cat([accepts, torch.zeros_like(accepts[:, :1])], 1).to(torch.int32),
                         dim=1)
        if samp.sampled:
            p_a = torch.gather(p, 1, a[:, None, None].expand(rows, 1, v))[:, 0]
            q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
            q_a = torch.gather(q_pad, 1, a[:, None, None].expand(rows, 1, v))[:, 0]
            res = torch.clamp_min(p_a - q_a, 0.0)
            ssum = res.sum(-1, keepdim=True)
            res = torch.where(ssum > 0, res / torch.where(ssum > 0, ssum, 1.0), p_a)
            bonus = torch.where(samp.temps <= 0, torch.argmax(res, dim=-1),
                                draw_rows(torch.log(res), samp.keys(ns + a, 9)))
        else:
            bonus = torch.gather(preds, 1, a[:, None])[:, 0]
        self._set_idx(torch.where(active, idx0 + 1 + a.to(idx0.dtype), torch.zeros_like(idx0)))
        return drafts, a, bonus

    def _spec_scan(self, tok, live, rem, eos, ns, samp, horizon):
        """``horizon`` speculative rounds with retirement on the device:
        a row emits its accepted proposals and the bonus, cut at its
        budget and after its first eos, then stays dead. Returns the
        ``(horizon, rows, spec_k)`` emitted tokens and emit mask and the
        ``(horizon, rows)`` accepted counts and live-going-in masks."""
        k = self.spec_k
        cols = torch.arange(k, device=tok.device)[None, :]
        outs = []
        for i in range(horizon):
            drafts, a, bonus = self._spec_core(tok, live, ns, samp)
            toks = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            toks = torch.where(cols == a[:, None], bonus[:, None], toks)
            emit = (cols <= a[:, None]) & (cols < rem[:, None]) & live[:, None]
            is_eos = (toks == eos[:, None]) & emit
            eos_n = is_eos.long()
            emit = emit & ~((torch.cumsum(eos_n, dim=1) - eos_n) > 0)  # the first eos is emitted
            outs.append((toks, emit, a, live))
            if i + 1 < horizon:
                cnt = emit.sum(dim=1)
                rem = rem - cnt
                live = live & (rem > 0) & ~(is_eos & emit).any(dim=1)
                ns = ns + cnt
                tok = bonus
        self._mask_pages(None)
        return [torch.stack(x) for x in zip(*outs)]

    def _decode(self, is_decode: list[bool], horizon: int, finished: list[int]) -> None:
        """One decode dispatch over the rows in ``is_decode``: ``horizon``
        steps (or speculative rounds), one read-back, then the host
        replays the same bookkeeping row by row."""
        states = self._slot_state
        with self._phases.phase("lm_engine.decode.launch"):
            ints = np.zeros((6, self.slots), np.int64)
            ints[3] = -1
            for r, st in enumerate(states):
                if is_decode[r]:
                    ints[:, r] = (st.emitted[-1], st.written, st.remaining,
                                  -1 if st.eos_id is None else st.eos_id, st.n_sampled, 1)
            tok, idx, rem, eos, ns, live = torch.from_numpy(ints).to(self.device)
            samp = _sampling([st if d else None for st, d in zip(states, is_decode)],
                             self.device)
            self._set_idx(idx.to(self._cache.idx.dtype))
            live = live.bool()
            if self.spec_k:
                out = self._spec_scan(tok, live, rem, eos, ns, samp, horizon)
            else:
                out = self._decode_scan(self._cache, tok, live, rem, eos, ns, samp, horizon)
        with self._phases.phase("lm_engine.decode.readback"):
            out = [t.cpu().numpy() for t in out]
        if self.spec_k:
            toks, emits, accs, lives = out
        else:
            toks, lives = out
        self.readbacks += 1
        self._mark_dispatch()
        for i in range(horizon):
            for r in range(self.slots):
                st = states[r]
                if st is None or not is_decode[r] or not lives[i, r]:
                    continue
                if not self.spec_k:
                    self._account(r, int(toks[i, r]), finished)
                    continue
                self.spec_offered += self.spec_k - 1
                self.spec_accepted += int(accs[i, r])
                for j in range(self.spec_k):
                    if emits[i, r, j] and states[r] is st:
                        self._account(r, int(toks[i, r, j]), finished)

    # --- dense scheduler ------------------------------------------------

    def _step_dense(self) -> list[int]:
        finished: list[int] = []
        if self._queue and any(st is None for st in self._slot_state):
            with self._phases.phase("lm_engine.prefill"):
                self._admit_dense(finished)
        is_decode = [st is not None for st in self._slot_state]
        if not any(is_decode):
            return finished
        before = self.tokens_emitted
        with self._phases.phase("lm_engine.decode"):
            self._decode(is_decode, self.decode_horizon, finished)
        self.decode_tokens += self.tokens_emitted - before
        return finished

    def _admit_dense(self, finished: list[int]) -> None:
        """Fill every free slot from the queue: prefix requests one
        append each, the rest in one wave."""
        wave: list[tuple[int, _Request]] = []
        for row in range(self.slots):
            if self._slot_state[row] is None and self._queue:
                self._promote_next_admission()
                req = self._pop_queue()
                self._admitting.append(req)
                if req.prefix is not None:
                    # Each prefix admission starts from its own stored
                    # cache: one append per request.
                    done = self._admit_prefix(row, req)
                    if done is not None:
                        finished.append(done)
                else:
                    wave.append((row, req))
        if wave:
            finished.extend(self._admit_wave(wave))

    def _admit_wave(self, wave: list[tuple[int, _Request]]) -> list[int]:
        """Batched admission: ONE prefill (per model) for every request
        entering a free slot this iteration, written straight into those
        slots. The pad past each row's true length is never read: the
        next dispatch sets the row's index to it."""
        with self._phases.phase("lm_engine.prefill.launch"):
            tok_dev = self._launch_wave(wave)
        toks = tok_dev.tolist()
        self.admission_waves += 1
        finished = []
        for (row, req), tok in zip(wave, toks):
            done = self._register(row, req, tok)
            if done is not None:
                finished.append(done)
        return finished

    def _launch_wave(self, wave: list[tuple[int, _Request]]) -> torch.Tensor:
        """The wave's prefill launches; its first tokens on the device."""
        bucket = max(min(self._bucket(req.prompt.size), self._cap) for _, req in wave)
        # MoE routing couples the rows of a call (capacity per call, buffer
        # slots in token order), so an MoE wave of several requests runs
        # the JAX engine's shape: every slot, free ones on zeros, into a
        # transient cache whose admitted rows are then copied in.
        all_slots = bool(self.model.moe_every) and len(wave) > 1
        at = [row if all_slots else i for i, (row, _) in enumerate(wave)]
        padded = np.zeros((self.slots if all_slots else len(wave), bucket), np.int64)
        true_lens = np.zeros((len(wave),), np.int64)
        for i, (_, req) in enumerate(wave):
            padded[at[i], : req.prompt.size] = req.prompt
            true_lens[i] = req.prompt.size
        dev = self.device
        rows = torch.tensor([row for row, _ in wave], dtype=torch.long, device=dev)
        lens = torch.from_numpy(true_lens).to(dev)
        padded = torch.from_numpy(padded).to(dev)
        if all_slots:
            fresh = self.model.init_cache(self.slots)
            hidden = self.model(padded, fresh, fresh=True, return_hidden=True)
            for dst, src in zip(self._cache.tensors(), fresh.tensors()):
                dst[rows] = src[rows]
            self._cache.idx[rows] = fresh.idx[rows]
            del fresh
        else:
            hidden = self.model(padded, self._cache, fresh=True, rows=rows, return_hidden=True)
        picked = torch.tensor(at, dtype=torch.long, device=dev)
        last = self.model.logits(hidden[picked, lens - 1])
        if self.spec_k:
            self.draft_model(padded[picked], self._draft_cache, fresh=True, rows=rows,
                             return_hidden=True)
        reqs = [req for _, req in wave]
        return _sampling(reqs, dev).sample(last, torch.zeros_like(lens))

    def _admit_prefix(self, row: int, req: _Request) -> int | None:
        """Prefix admission: copy the stored prefix rows (and the
        draft's) into slot ``row`` and append the suffix there, padded to
        its bucket; the pad past the true end is never read."""
        with self._phases.phase("lm_engine.prefill.launch"):
            t_prefix, d_prefix, base = req.prefix
            n = int(req.prompt.size)
            padded = np.zeros((1, min(self._bucket(n), self._cap - base)), np.int64)
            padded[0, :n] = req.prompt
            padded = torch.from_numpy(padded).to(self.device)
            last = None
            for model, cache, prefix in ((self.model, self._cache, t_prefix),
                                         (self.draft_model, self._draft_cache, d_prefix)):
                if model is None:
                    continue
                cache.load_prefix(row, prefix)
                hidden = model(padded, cache.rows_view(row, row + 1), return_hidden=True)
                if last is None:
                    last = model.logits(hidden[:, n - 1])
            tok = _sampling([req], self.device).sample(
                last, torch.zeros((1,), dtype=torch.long, device=self.device))
        self.prefix_hits += 1
        return self._register(row, req, int(tok[0]))

    def _run_offline_wave(self, wave: list[_Request]) -> None:
        """One offline wave in rows ``0..len(wave)-1`` of the cache (no
        slot is live): a prefill, then the decode horizon, then one
        read-back."""
        n = len(wave)
        bucket = max(min(self._bucket(r.prompt.size), self._cap) for r in wave)
        padded = np.zeros((n, bucket), np.int64)
        ints = np.zeros((3, n), np.int64)
        for i, r in enumerate(wave):
            padded[i, : r.prompt.size] = r.prompt
            ints[:, i] = (r.prompt.size, r.max_new_tokens, -1 if r.eos_id is None else r.eos_id)
        dev = self.device
        lens, rems, eos = torch.from_numpy(ints).to(dev)
        samp = _sampling(wave, dev)
        cache = self._cache.rows_view(0, n)
        hidden = self.model(torch.from_numpy(padded).to(dev), cache, fresh=True,
                            return_hidden=True)
        tok0 = samp.sample(self.model.logits(hidden[torch.arange(n, device=dev), lens - 1]),
                           torch.zeros_like(lens))
        maxrem = max(r.max_new_tokens for r in wave) - 1
        # Power-of-two horizons: steps past the wave's last live row are
        # all-dead idles.
        horizon = 1 << (maxrem - 1).bit_length() if maxrem > 0 else 0
        out = tok0[None]
        if horizon:
            cache.idx = lens.to(cache.idx.dtype)
            rem0 = rems - 1
            live0 = (rem0 > 0) & (tok0 != eos)
            toks, lives = self._decode_scan(cache, tok0, live0, rem0, eos,
                                            torch.ones_like(lens), samp, horizon)
            out = torch.cat([out, toks, lives.long()])
        out = out.cpu().numpy()
        self.readbacks += 1
        self._mark_dispatch()
        self.admission_waves += 1
        for i, r in enumerate(wave):
            # Live-going-in is a true-then-false run per row: its tokens
            # are the first sum(lives) scan outputs.
            cnt = int(out[1 + horizon:, i].sum()) if horizon else 0
            tokens = [int(out[0, i])] + out[1: 1 + cnt, i].astype(int).tolist()
            self._emit(len(tokens))
            self._m_prefix_cache.inc(result="miss")
            self._observe_ttft(r)
            self._results[r.ticket] = tokens

    # --- paged scheduler ------------------------------------------------
    # Host bookkeeping for the paged layout: which physical blocks each
    # slot owns (BlockPool references), how much of each prompt is still
    # to prefill, and when to preempt. Admission costs no device call:
    # the prompt enters the cache in prefill_chunk-token chunks fused into
    # the regular calls.

    def _live(self) -> list[tuple[int, _SlotState]]:
        return [(r, st) for r, st in enumerate(self._slot_state) if st is not None]

    def _sync_pages(self) -> None:
        """Copy the host page table into the device table (shared by all
        layers of both caches) if it changed since the last call."""
        if self._pages_dirty:
            self._pages_dev.copy_(torch.from_numpy(self._pages_np))
            self._pages_dirty = False

    def _release_blocks(self, row: int, blocks: list[int]) -> None:
        self._pool.unref_all(blocks)
        self._pages_np[row, :] = 0
        self._pages_dirty = True

    def _admit_paged(self, row: int) -> bool:
        """Admit the queue head into free slot ``row``: its page-table row
        (the prefix's shared complete pages first, one new reference
        each, then fresh blocks for the rest of the prompt) and its slot
        state. False when the pool cannot hold the prompt now: the
        request stays queued."""
        req = self._queue[0]
        entry = req.prefix
        full = req.prompt if entry is None else np.concatenate([entry.tokens, req.prompt])
        ps = self._page_size
        shared = list(entry.blocks) if entry is not None and entry.blocks else []
        n_new = -(-full.size // ps) - len(shared)
        while n_new > self._pool.available:
            # Idle prefix registrations must not starve an admission when
            # no live slot will ever free a block; never preempt live work
            # to admit.
            if not self._evict_idle_prefix(keep=entry):
                return False
        blocks = shared + self._pool.alloc(n_new)
        for blk in shared:
            self._pool.ref(blk)
        self._pop_queue()
        self._admitting.append(req)
        self._pages_np[row, :] = 0
        self._pages_np[row, : len(blocks)] = blocks
        self._pages_dirty = True
        shared_len = len(shared) * ps
        self._slot_state[row] = _SlotState(
            ticket=req.ticket, emitted=[], remaining=req.max_new_tokens, eos_id=req.eos_id,
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p, seed=req.seed,
            n_sampled=0, prompt_total=int(full.size), req=req, pending=full[shared_len:],
            base_len=shared_len,
            worst_len=int(full.size) + req.max_new_tokens + max(0, self.spec_k - 2),
            blocks=blocks, shared_hit=bool(shared), seq=self._admit_seq,
        )
        self._admit_seq += 1
        return True

    def _capture_prefix_blocks(self, st: _SlotState) -> None:
        """The row has prefilled past its prefix: publish the prefix's
        complete pages for sharing (one registry reference each). Only
        the first finisher publishes, and only while its snapshot is
        still the registered entry."""
        entry = st.req.prefix
        if not isinstance(entry, _PagedPrefix) or entry.blocks is not None:
            return
        if self._prefixes.get(entry.name) is not entry:
            return  # re-registered since this request was submitted
        nfull = entry.tokens.size // self._page_size
        if nfull == 0:
            return
        entry.blocks = list(st.blocks[:nfull])
        for blk in entry.blocks:
            self._pool.ref(blk)

    def _ensure_blocks(self, row: int, st: _SlotState, cover_len: int) -> None:
        """Grow ``row``'s page table to cover positions below
        ``cover_len``; a dry pool evicts an idle prefix first, then
        preempts the newest other slot."""
        need = -(-cover_len // self._page_size)
        while need > len(st.blocks):
            want = need - len(st.blocks)
            if self._pool.available >= want:
                new = self._pool.alloc(want)
                self._pages_np[row, len(st.blocks): need] = new
                st.blocks.extend(new)
                self._pages_dirty = True
                return
            if not self._reclaim(row):
                raise RuntimeError(
                    "block pool wedged: no free block, no evictable prefix and no other "
                    "slot to preempt; submit-time validation should have made this impossible")

    def _evict_idle_prefix(self, keep: Any = None) -> bool:
        """Drop one prefix registration's block references (the next hit
        recomputes them); ``keep`` protects the entry an admission in
        progress points at. False when nothing is evictable."""
        for entry in self._prefixes.values():
            if entry is not keep and isinstance(entry, _PagedPrefix) and entry.blocks:
                self._pool.unref_all(entry.blocks)
                entry.blocks = None
                return True
        return False

    def _reclaim(self, needy_row: int) -> bool:
        """Free capacity for ``needy_row``: an idle prefix's references
        first (no lost work), else preempt the newest-admitted other
        slot. False when there is nothing left to take."""
        if self._evict_idle_prefix():
            return True
        victims = [(st.seq, r) for r, st in self._live() if r != needy_row]
        if not victims:
            return False
        self._preempt(max(victims)[1])
        return True

    def _preempt(self, row: int) -> None:
        st = self._slot_state[row]
        self._slot_state[row] = None
        self._release_blocks(row, st.blocks)
        # Queue front: the victim re-admits as soon as space frees and
        # replays to the same stream (greedy is deterministic; sampled
        # keys fold (seed, token index) only).
        st.req.queued_at = time.perf_counter()
        self._queue.appendleft(st.req)
        self.preemptions += 1
        self._m_preemptions.inc()

    def _first_token(self, row: int, st: _SlotState, tok: int) -> int | None:
        """The row's prefill completed in this call: its first token."""
        self._emit()
        self._m_prefix_cache.inc(result="hit" if st.shared_hit else "miss")
        self.prefix_hits += st.shared_hit
        self._observe_ttft(st.req)
        st.emitted = [tok]
        st.remaining = st.req.max_new_tokens - 1
        st.n_sampled = 1
        if st.remaining == 0 or (st.eos_id is not None and tok == st.eos_id):
            return self._finish(row)
        return None

    def _step_paged(self) -> list[int]:
        """One iteration of the paged engine: admit (bookkeeping only),
        grow the decode rows' page tables (preempting if the pool is
        dry), then ONE call for every slot — each prefilling row writes
        its next prompt chunk, each decode row its next token. A
        speculative engine runs the chunks (through both models, decode
        rows inert) and then its speculative dispatch for the rows that
        were already decoding; with no prompt chunk left, the dispatch
        runs ``decode_horizon`` steps or rounds."""
        finished: list[int] = []
        for row in range(self.slots):
            if self._queue and self._slot_state[row] is None:
                self._promote_next_admission()
                if not self._admit_paged(row):
                    break  # FIFO: pool pressure queues, never reorders
        horizon = 1 if any(st.pending is not None for _, st in self._live()) \
            else self.decode_horizon
        adv = (self.spec_k or 1) * horizon  # deepest advance of this dispatch
        for r, st in self._live():
            if self._slot_state[r] is st and st.pending is None:
                self._ensure_blocks(r, st, min(st.written + adv, st.worst_len))
        live = self._live()  # _ensure_blocks may have preempted
        if not live:
            return finished
        prefilling = [(r, st) for r, st in live if st.pending is not None]
        decoding = [(r, st) for r, st in live if st.pending is None]
        self._sync_pages()
        if prefilling:
            fused = not self.spec_k
            width = self.prefill_chunk
            tokens = np.zeros((self.slots, width), np.int64)
            ints = np.zeros((3, self.slots), np.int64)  # base, true length, n
            for r, st in prefilling:
                n = min(width, st.pending.size)
                tokens[r, :n] = st.pending[:n]
                ints[:2, r] = (st.base_len, n)
            if fused:
                for r, st in decoding:
                    tokens[r, 0] = st.emitted[-1]
                    ints[:, r] = (st.written, 1, st.n_sampled)
            with self._phases.phase("lm_engine.prefill"):
                toks = self._paged_chunk(tokens, ints)
                self._mark_dispatch()
            for r, st in prefilling:
                n = int(ints[1, r])
                self.prefill_chunks += 1
                self._m_prefill_chunks.inc()
                st.base_len += n
                st.pending = st.pending[n:] if st.pending.size > n else None
                if st.pending is None:
                    self._capture_prefix_blocks(st)
                    done = self._first_token(r, st, toks[r])
                    if done is not None:
                        finished.append(done)
            if fused:
                for r, st in decoding:
                    if self._slot_state[r] is st:
                        self._account(r, toks[r], finished)
                return finished
        if not decoding:
            return finished
        # A row that finished its prefill in this iteration sits this
        # dispatch out: its first token was just drawn.
        self._sync_pages()
        dec = {r for r, _ in decoding}
        is_decode = [r in dec for r in range(self.slots)]
        before = self.tokens_emitted
        with self._phases.phase("lm_engine.decode"):
            self._decode(is_decode, horizon, finished)
        self.decode_tokens += self.tokens_emitted - before
        return finished

    def _paged_chunk(self, tokens: np.ndarray, ints: np.ndarray) -> list[int]:
        """The fused chunk + decode call: each row's index at its
        ``base`` (``ints[0]``), ``tokens`` ``(slots, width)`` through the
        model (and the draft, which drops its logits), each row's next
        token drawn from its last true position (``ints[1]`` tokens; key
        index ``ints[2]``). Rows with no tokens write into the scratch
        block and attend nothing."""
        dev = self.device
        with self._phases.phase("lm_engine.prefill.launch"):
            base, lens, ns = torch.from_numpy(ints).to(dev)
            tokens = torch.from_numpy(tokens).to(dev)
            active = lens > 0
            self._set_idx(torch.where(active, base,
                                      torch.zeros_like(base)).to(self._cache.idx.dtype))
            self._mask_pages(active)
            hidden = self.model(tokens, self._cache, return_hidden=True)
            if self.spec_k:
                self.draft_model(tokens, self._draft_cache, return_hidden=True)
            self._mask_pages(None)
            rows = torch.arange(self.slots, device=dev)
            last = self.model.logits(hidden[rows, torch.clamp_min(lens - 1, 0)])
            toks = _sampling(self._slot_state, dev).sample(last, ns)
        return toks.tolist()
