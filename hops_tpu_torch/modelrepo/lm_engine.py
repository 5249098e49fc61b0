"""Continuous batching for LM serving (counterpart of
``hops_tpu/modelrepo/lm_engine.py``, dense cache layout).

Requests of different prompt lengths and generation budgets share a
fixed set of decode *slots*. Each engine iteration admits queued
requests into free slots — one batched prefill for all of them — and
then runs ONE decode step for every slot; a request that finishes frees
its slot at once and the next queued request takes it.

- The per-layer KV caches are one ``(slots, heads, capacity, d)`` buffer
  per layer, alive across requests, with a ``(slots,)`` cache index
  (``TransformerLM(ragged_decode=True)``): every slot advances on its
  own and the decode kernel reads each row only up to its own length.
- Admission prefills the admitted rows straight into their slots of the
  persistent cache (``model(..., fresh=True, rows=...)``): prompts are
  padded to a length bucket, rows not admitted are left exactly as they
  were, and each admitted row's index rewinds to its true length, so
  the pad garbage past it is never read.
- Free slots stay in the decode batch with their index clamped to 0: a
  free row writes one position, attends nothing, and its token is
  discarded.

Greedy decoding emits exactly what per-request ``generate(...,
temperature=0)`` emits. Sampled requests draw with keys
``(seed, token index)`` (:func:`hops_tpu_torch.models.generation.draw`),
so a stream does not depend on its slot or its batch company.

This slice ports the dense engine only: ``decode_horizon > 1``,
``draft_model``, ``mesh``, ``kv_page_size``, ``prefill_chunk``, prefixes
and priority admission raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from hops_tpu_torch.models.generation import draw, top_p_mask
from hops_tpu_torch.runtime.devices import resolve_device

log = logging.getLogger(__name__)


class QueueFullError(RuntimeError):
    """A bounded submit queue is at capacity: the request is refused at
    the door; the client should retry later."""


def _clamp_idx(idx: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Clamp inactive rows' cache index to 0 (the free-slot convention):
    a free row writes one position, attends one block, and its output is
    discarded host-side."""
    return torch.where(active, idx, torch.zeros_like(idx))


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


def _sample_rows(logits, temps, topks, topps, seeds, ns, use_top_p=False) -> list[int]:
    """Per-row sampling over ``(rows, vocab)`` logits; the knobs are host
    lists. ``temps[i] <= 0`` is greedy; ``topks[i] > 0`` keeps the top-k
    logits; ``0 < topps[i] < 1`` applies the nucleus filter on top. Row
    i draws with key ``(seeds[i], ns[i])`` — a pure function of the
    request and token index. Returns host ints."""
    greedy = torch.argmax(logits.to(torch.float32), dim=-1).tolist()
    hot = [i for i, t in enumerate(temps) if t > 0]
    if not hot:
        return greedy
    dev = logits.device
    sel = torch.tensor(hot, device=dev)
    scaled = _filter_rows(
        logits[sel],
        torch.tensor([temps[i] for i in hot], dtype=torch.float32, device=dev),
        torch.tensor([topks[i] for i in hot], dtype=torch.long, device=dev),
        torch.tensor([topps[i] for i in hot], dtype=torch.float32, device=dev),
        use_top_p,
    )
    out = list(greedy)
    for j, i in enumerate(hot):
        out[i] = draw(scaled[j], seeds[i], ns[i])
    return out


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
    submitted_at: float = 0.0  # monotonic submit time, the TTFT start mark


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


class LMEngine:
    """Continuous-batching scheduler over ``slots`` concurrent decodes.

    ``model`` must be a ``TransformerLM(ragged_decode=True)`` on
    ``device`` (``None`` = the card) whose ``max_decode_len`` covers every
    request's prompt + generation. ``submit()`` enqueues and returns a
    ticket; ``step()`` runs one engine iteration (admit into free slots,
    then one decode step); ``run()`` drains everything and returns
    ``{ticket: tokens}``. The engine is not thread-safe: callers sharing
    it across threads hold their own lock (``serving.LMEnginePredictor``).
    """

    def __init__(
        self,
        model,
        slots: int = 4,
        prefill_buckets: tuple[int, ...] | None = None,
        decode_horizon: int = 1,
        mesh: Any = None,
        draft_model: Any = None,
        kv_page_size: int | None = None,
        kv_pool_blocks: int | None = None,
        prefill_chunk: int | None = None,
        max_queue: int = 1024,
        device: str | torch.device | None = None,
    ):
        if decode_horizon != 1:
            raise NotImplementedError("decode_horizon > 1 is a later slice")
        if draft_model is not None:
            raise NotImplementedError("draft_model (speculative decoding) is a later slice")
        if mesh is not None:
            raise NotImplementedError("mesh (tensor-parallel serving) is a later slice")
        if kv_page_size is not None or kv_pool_blocks is not None or prefill_chunk is not None:
            raise NotImplementedError("the paged engine and chunked prefill are a later slice")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if not getattr(model, "ragged_decode", False):
            raise ValueError(
                "LMEngine requires TransformerLM(ragged_decode=True) — the "
                "(slots,) cache index is what lets rows advance independently"
            )
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine asked for {self.device}")
        self.model = model
        self.slots = slots
        self.max_queue = int(max_queue)
        self.decode_horizon = 1
        cap = model.max_decode_len
        self._cap = cap
        if prefill_buckets is None:
            prefill_buckets = tuple(
                b for b in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096) if b < cap
            ) or (cap,)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self._cache = model.init_cache(slots)
        self._queue: collections.deque[_Request] = collections.deque()
        self._slot_state: list[_SlotState | None] = [None] * slots
        self._results: dict[int, list[int]] = {}
        self._errors: dict[int, BaseException] = {}
        self._admitting: list[_Request] = []  # popped, not yet slotted
        self._next_ticket = 0
        self.dispatches = 0
        self.tokens_emitted = 0
        self.admission_waves = 0
        self._occ_sum = 0.0
        # Host-clock seconds in admission prefills and in decode steps;
        # each phase ends by reading its tokens back, so the device work
        # is inside the measured span.
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.decode_tokens = 0
        #: Per-ticket time to first token (seconds), consumed by take_result.
        self.ttft_s: dict[int, float] = {}

    # --- public API -----------------------------------------------------

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
        index. Raises :class:`QueueFullError` when ``max_queue`` requests
        are already queued."""
        if prefix_id is not None:
            raise NotImplementedError("prefix_id (prefix caching) is a later slice")
        if priority != "interactive":
            raise NotImplementedError("priority admission is a later slice")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + max_new_tokens > self._cap:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens "
                f"exceeds max_decode_len {self._cap}"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # Admission bound last: malformed requests above are ValueErrors;
        # only a well-formed request at a full queue is a retryable shed.
        if len(self._queue) >= self.max_queue:
            raise QueueFullError(
                f"submit queue full ({len(self._queue)}/{self.max_queue} queued); retry later"
            )
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append(_Request(
            ticket, prompt, int(max_new_tokens), eos_id,
            temperature=float(temperature), top_k=int(top_k or 0),
            top_p=float(top_p or 0.0), seed=int(seed) & 0x7FFFFFFF,
            submitted_at=time.monotonic(),
        ))
        return ticket

    @torch.inference_mode()
    def step(self) -> list[int]:
        """One engine iteration: admit queued requests into free slots,
        then one decode step for all slots. Returns the tickets that
        finished this iteration.

        A failure during the iteration fails only the in-flight requests
        (retrievable per ticket through :meth:`take_error`); their slots
        free and the engine keeps serving the queue.
        """
        try:
            return self._step_dense()
        except Exception as e:  # noqa: BLE001 — isolate to in-flight work
            return self._fail_inflight(e)
        finally:
            self._admitting.clear()

    def run(self) -> dict[int, list[int]]:
        """Drain the queue and all live slots; returns every result
        collected so far."""
        while self.has_work:
            self.step()
        return dict(self._results)

    def result(self, ticket: int) -> list[int] | None:
        """Generated tokens (prompt excluded), or None if not finished."""
        return self._results.get(ticket)

    def take_result(self, ticket: int) -> list[int] | None:
        """Like :meth:`result` but consuming (and drops the ticket's TTFT)."""
        self.ttft_s.pop(ticket, None)
        return self._results.pop(ticket, None)

    def error(self, ticket: int) -> BaseException | None:
        return self._errors.get(ticket)

    def take_error(self, ticket: int) -> BaseException | None:
        return self._errors.pop(ticket, None)

    def cancel(self, ticket: int) -> bool:
        """Remove a still-queued request; returns whether one was removed."""
        for req in self._queue:
            if req.ticket == ticket:
                self._queue.remove(req)
                return True
        return False

    def stats(self) -> dict[str, Any]:
        return {
            "dispatches": self.dispatches,
            "tokens_emitted": self.tokens_emitted,
            "tokens_per_dispatch": round(self.tokens_emitted / max(self.dispatches, 1), 3),
            "prefix_hits": 0,
            "admission_waves": self.admission_waves,
            "queued": len(self._queue),
            "slots_busy": sum(st is not None for st in self._slot_state),
            "slots": self.slots,
            "decode_horizon": self.decode_horizon,
            "mean_occupancy": round(self._occ_sum / max(self.dispatches, 1), 4),
            "cache_layout": "dense",
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "decode_tokens": self.decode_tokens,
        }

    @property
    def has_failures(self) -> bool:
        return bool(self._errors)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(st is not None for st in self._slot_state)

    # --- internals ------------------------------------------------------

    def _step_dense(self) -> list[int]:
        finished: list[int] = []
        wave: list[tuple[int, _Request]] = []
        for row in range(self.slots):
            if self._slot_state[row] is None and self._queue:
                req = self._queue.popleft()
                self._admitting.append(req)
                wave.append((row, req))
        if wave:
            t0 = time.perf_counter()
            finished.extend(self._admit_wave(wave))
            self.prefill_s += time.perf_counter() - t0
        live = [st for st in self._slot_state if st is not None]
        if not live:
            return finished
        t0 = time.perf_counter()
        states = self._slot_state
        tokens = torch.tensor(
            [st.emitted[-1] if st else 0 for st in states], dtype=torch.long, device=self.device
        )
        active = torch.tensor([st is not None for st in states], device=self.device)
        self._cache.idx = _clamp_idx(self._cache.idx, active)
        last = self.model(tokens[:, None], self._cache)[:, -1]
        nxt = _sample_rows(
            last,
            [st.temperature if st else 0.0 for st in states],
            [st.top_k if st else 0 for st in states],
            [st.top_p if st else 0.0 for st in states],
            [st.seed if st else 0 for st in states],
            [st.n_sampled if st else 0 for st in states],
            use_top_p=any(st.temperature > 0 and 0.0 < st.top_p < 1.0 for st in live),
        )
        self._mark_dispatch()
        self.decode_s += time.perf_counter() - t0
        self.decode_tokens += len(live)
        for row in range(self.slots):
            if self._slot_state[row] is not None:
                self._account(row, nxt[row], finished)
        return finished

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self._cap

    def _admit_wave(self, wave: list[tuple[int, _Request]]) -> list[int]:
        """Batched admission: ONE prefill for every request entering a
        free slot this iteration, written straight into those slots. A
        one-request wave is the same call with one row — with no
        transient full-slot cache there is nothing to save by a separate
        path."""
        bucket = max(min(self._bucket(req.prompt.size), self._cap) for _, req in wave)
        padded = np.zeros((len(wave), bucket), np.int64)
        true_lens = np.zeros((len(wave),), np.int64)
        for i, (_, req) in enumerate(wave):
            padded[i, : req.prompt.size] = req.prompt
            true_lens[i] = req.prompt.size
        dev = self.device
        rows = torch.tensor([row for row, _ in wave], dtype=torch.long, device=dev)
        lens = torch.from_numpy(true_lens).to(dev)
        hidden = self.model(
            torch.from_numpy(padded).to(dev), self._cache,
            fresh=True, rows=rows, return_hidden=True,
        )
        last = self.model.logits(hidden[torch.arange(len(wave), device=dev), lens - 1])
        # Rewind each admitted row's index to its true length: the pad
        # garbage past it is never read.
        self._cache.idx[rows] = lens.to(self._cache.idx.dtype)
        reqs = [req for _, req in wave]
        toks = _sample_rows(
            last,
            [r.temperature for r in reqs], [r.top_k for r in reqs],
            [r.top_p for r in reqs], [r.seed for r in reqs], [0] * len(reqs),
            use_top_p=any(r.temperature > 0 and 0.0 < r.top_p < 1.0 for r in reqs),
        )
        self.admission_waves += 1
        finished = []
        for (row, req), tok in zip(wave, toks):
            done = self._register(row, req, tok)
            if done is not None:
                finished.append(done)
        return finished

    def _register(self, row: int, req: _Request, tok: int) -> int | None:
        """Record the first emitted token and occupy (or immediately
        finish) the slot."""
        self.tokens_emitted += 1
        self._observe_ttft(req)
        self._slot_state[row] = _SlotState(
            ticket=req.ticket, emitted=[tok], remaining=req.max_new_tokens - 1,
            eos_id=req.eos_id, temperature=req.temperature, top_k=req.top_k,
            top_p=req.top_p, seed=req.seed,
        )
        if req.max_new_tokens == 1 or (req.eos_id is not None and tok == req.eos_id):
            return self._finish(row)
        return None

    def _account(self, row: int, tok: int, finished: list[int]) -> None:
        st = self._slot_state[row]
        st.emitted.append(tok)
        st.remaining -= 1
        st.n_sampled += 1
        self.tokens_emitted += 1
        if st.remaining == 0 or (st.eos_id is not None and tok == st.eos_id):
            finished.append(self._finish(row))

    def _finish(self, row: int) -> int:
        st = self._slot_state[row]
        self._results[st.ticket] = st.emitted
        self._slot_state[row] = None
        # The slot's cache rows stay as they are; the next admission
        # overwrites them and resets the index.
        return st.ticket

    def _observe_ttft(self, req: _Request) -> None:
        self.ttft_s[req.ticket] = time.monotonic() - req.submitted_at

    def _mark_dispatch(self) -> None:
        self.dispatches += 1
        self._occ_sum += sum(st is not None for st in self._slot_state) / self.slots

    def _fail_inflight(self, exc: BaseException) -> list[int]:
        """Every in-flight request fails with ``exc``; slots free, and the
        cache index resets so the engine keeps serving the queue."""
        failed = []
        for row, st in enumerate(self._slot_state):
            if st is not None:
                self._errors[st.ticket] = exc
                failed.append(st.ticket)
                self._slot_state[row] = None
        for req in self._admitting:
            if req.ticket not in self._errors and req.ticket not in self._results:
                self._errors[req.ticket] = exc
                failed.append(req.ticket)
        self._admitting.clear()
        self._cache.idx = torch.zeros_like(self._cache.idx)
        log.warning(
            "lm_engine step failed; %d in-flight request(s) failed (%s: %s)",
            len(failed), type(exc).__name__, exc,
        )
        return []
