"""Autoregressive sampling for TransformerLM (counterpart of
``hops_tpu/models/generation.py``).

A prefill call writes the prompt into an explicit KV cache
(``model.init_cache``) through the flash kernel, then single-token steps
stream the cache through the decode kernel.

Sampling draws Gumbel noise from a counter-based hash of integer keys
(:func:`draw_rows`: ``(seed, row, step)`` here, ``(seed, token index)``
in the engine), computed on the device, so a sampled stream is
deterministic for a seed and independent of the batch it rides in. JAX's
PRNG streams are not reproduced: greedy decoding matches the JAX package
token for token, sampled decoding only itself.
"""

from __future__ import annotations

import torch

from hops_tpu_torch.runtime.devices import resolve_device

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, in halves so
    no product leaves int64."""
    return (x * (c & 0xFFFF) + ((x * (c >> 16)) & 0xFFFF) * 65536) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer, elementwise on int64 tensors."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_rows(keys: torch.Tensor, width: int) -> torch.Tensor:
    """Counter-based uniforms in (0, 1): ``(rows, width)`` fp32 on
    ``keys``' device, entry ``(r, j)`` a hash of key row ``r`` (``(rows,
    m)`` non-negative integers, folded in order) and ``j``. A pure
    function of the keys, computed on the device with no host round
    trip, so a draw inside a decode horizon needs no read-back."""
    keys = keys.to(torch.int64)
    h = torch.full(keys.shape[:1], _GOLDEN, dtype=torch.int64, device=keys.device)
    for col in keys.unbind(1):
        h = _fmix32((h + _GOLDEN + (col & _M32)) & _M32)
        h = _fmix32(h ^ ((col >> 32) & _M32))
    j = _fmix32(torch.arange(width, dtype=torch.int64, device=keys.device) + _GOLDEN)
    bits = _fmix32(_mul32(h[:, None] ^ j[None, :], 0x27D4EB2F))
    return ((bits >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def draw_rows(scaled: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One token per row of the categorical distributions ``scaled``
    (fp32 ``(rows, vocab)`` logits, ``-inf`` where masked), row ``r``
    keyed by ``keys[r]`` (Gumbel-max over :func:`uniform_rows`).
    Returns a long tensor on the device, with no host round trip."""
    u = uniform_rows(keys, scaled.shape[-1])
    return torch.argmax(scaled.to(torch.float32) - torch.log(-torch.log(u)), dim=-1)


def top_p_mask(
    logits: torch.Tensor, top_p, sorted_desc: torch.Tensor | None = None
) -> torch.Tensor:
    """Nucleus filter: ``-inf`` everywhere except the smallest
    descending-probability prefix whose cumulative mass reaches
    ``top_p``. ``logits`` ``(rows, vocab)`` are already
    temperature-scaled/top-k-masked; ``top_p`` is a scalar or a
    ``(rows,)`` vector — entries outside (0, 1) disable filtering for that
    row. Ties at the threshold are kept. A caller holding the rows
    sorted descending passes them as ``sorted_desc``. The threshold is
    taken and compared in logit space from the same sorted array."""
    if sorted_desc is None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    probs_desc = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_desc, dim=-1)
    reached = cum >= top_p[..., None]
    idx = torch.argmax(reached.to(torch.uint8), dim=-1)  # first True
    thresh = torch.gather(sorted_desc, -1, idx[..., None])[..., 0]
    enabled = (top_p > 0.0) & (top_p < 1.0)
    thresh = torch.where(
        enabled & reached.any(dim=-1), thresh, torch.full_like(thresh, float("-inf"))
    )
    return logits.masked_fill(logits < thresh[..., None], float("-inf"))


def _filter_logits(
    logits_row: torch.Tensor,
    temperature: float,
    top_k: int | None,
    top_p: float | None,
) -> torch.Tensor:
    """Temperature-scale then top-k/top-p-truncate ``(rows, vocab)``
    logits."""
    logits_row = logits_row / max(temperature, 1e-6)
    sorted_desc = None
    if top_k is not None:
        srt = torch.sort(logits_row, dim=-1).values
        kth = srt[:, -top_k][:, None]
        logits_row = logits_row.masked_fill(logits_row < kth, float("-inf"))
        desc = srt.flip(-1)
        sorted_desc = desc.masked_fill(desc < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        logits_row = top_p_mask(logits_row, top_p, sorted_desc=sorted_desc)
    return logits_row


def _check_model(model, device) -> torch.device:
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, asked for {device}")
    return device


def generate(
    model,
    prompt,
    max_new_tokens: int = 32,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_id: int | None = None,
    pad_id: int = 0,
    seed: int = 0,
    row_offset: int = 0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` ``(b, L)``.

    ``temperature=0`` (or ``top_k=1``) is greedy decoding; ``top_k`` and
    ``top_p`` compose, in that order, on the temperature-scaled logits.
    Returns ``(b, L + max_new_tokens)`` token ids on ``device``. With
    ``eos_id`` set, rows that have emitted it produce ``pad_id`` from the
    next step on. Sampled row ``r`` draws with key
    ``(seed, row_offset + r, step)``. ``device`` (``None`` = the card)
    must be the model's device.
    """
    device = _check_model(model, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, prompt_len = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len + max_new_tokens > model.max_decode_len:
        raise ValueError(
            f"prompt {prompt_len} + {max_new_tokens} new tokens exceeds "
            f"max_decode_len {model.max_decode_len}"
        )
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    greedy = temperature == 0.0 or top_k == 1

    def sample(logits_row: torch.Tensor, step: int) -> torch.Tensor:
        if greedy:
            return torch.argmax(logits_row, dim=-1)
        scaled = _filter_logits(logits_row, temperature, top_k, top_p)
        keys = torch.tensor([[seed, row_offset + r, step] for r in range(b)], device=device)
        return draw_rows(scaled, keys)

    with torch.inference_mode():
        cache = model.init_cache(b)
        logits = model(prompt, cache, fresh=True)
        tok = sample(logits[:, -1], 0)
        done = tok == eos_id if eos_id is not None else torch.zeros_like(tok, dtype=torch.bool)
        out = [tok]
        for step in range(1, max_new_tokens):
            logits = model(tok[:, None], cache)
            nxt = sample(logits[:, -1], step)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def _rewind(cache, valid) -> None:
    """Set every row's cache index to ``valid`` (an int or a per-row
    tensor). The keys and values past it stay where they are: no kernel
    reads a position at or past a row's valid length, so a rejected
    speculation is undone by the index alone."""
    cache.idx = torch.as_tensor(valid, dtype=cache.idx.dtype,
                                device=cache.idx.device).expand_as(cache.idx).clone()


def generate_speculative(
    model,
    draft_model,
    prompt,
    max_new_tokens: int = 32,
    k: int = 4,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    seed: int | None = None,
    row_offset: int = 0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Speculative decoding: ``draft_model`` proposes ``k - 1`` tokens,
    ``model`` scores ``[current, proposals]`` in one warm append of ``k``
    tokens (the decode kernel with ``s = k``), and each round yields
    1..k tokens. Returns ``(b, L + max_new_tokens)`` token ids.

    ``temperature=0`` is greedy: the longest prefix of proposals that
    matches the target's argmax is kept, plus the target's own next
    token, so the output is exactly the target's greedy decoding.
    ``temperature > 0`` is rejection sampling (needs ``seed``): the draft
    samples from its filtered distribution q, the target accepts
    proposal x with probability ``min(1, p(x)/q(x))``, and the first
    rejected slot resamples from ``norm(max(p - q, 0))``, so each token
    is distributed as sampling from the target's filtered distribution.
    Draws are keyed ``(seed, purpose, row_offset + row, position)``.

    Acceptance is the minimum over the batch (one cache index serves
    every row, as in the JAX package); a row whose own acceptance went
    further re-emits its accepted token at the boundary. Both models
    must cover ``L + max_new_tokens + k`` positions.
    """
    device = _check_model(model, device)
    _check_model(draft_model, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, prompt_len = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if k < 2:
        raise ValueError(f"speculation depth k must be >= 2, got {k}")
    if temperature > 0 and seed is None:
        raise ValueError("sampled speculative decoding requires seed")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    total = prompt_len + max_new_tokens
    if total + k > model.max_decode_len or total + k > draft_model.max_decode_len:
        raise ValueError(
            f"prompt {prompt_len} + {max_new_tokens} new tokens (+{k} speculation "
            f"slack) exceeds a max_decode_len ({model.max_decode_len}, "
            f"{draft_model.max_decode_len})"
        )
    sampled = temperature > 0
    rows = torch.arange(b, device=device) + row_offset

    def keys(purpose: int, pos) -> torch.Tensor:
        pos = torch.as_tensor(pos, device=device).expand(b)
        return torch.stack([torch.full_like(rows, seed), torch.full_like(rows, purpose),
                            rows, pos], dim=1)

    def probs(logits):
        return torch.softmax(_filter_logits(logits.to(torch.float32), temperature,
                                            top_k, top_p), dim=-1)

    with torch.inference_mode():
        t_cache, d_cache = model.init_cache(b), draft_model.init_cache(b)
        model(prompt, t_cache, fresh=True)
        draft_model(prompt, d_cache, fresh=True)
        # Invariant: each cache holds the tokens before the newest known
        # one, `cur`, which is not written yet.
        _rewind(t_cache, prompt_len - 1)
        _rewind(d_cache, prompt_len - 1)
        cur = prompt[:, -1]
        out = torch.zeros((b, total + k), dtype=torch.long, device=device)
        out[:, :prompt_len] = prompt
        n = 0
        while n < max_new_tokens:
            pos = prompt_len + n
            # The draft runs k steps for k - 1 proposals: the last
            # step's proposal is dropped, but its cache write is what a
            # fully accepted round resumes from.
            tok, drafts, qs = cur, [], []
            for i in range(k):
                last = draft_model(tok[:, None], d_cache)[:, -1]
                if sampled:
                    q = probs(last)
                    tok = draw_rows(torch.log(q), keys(0, pos + i))
                    qs.append(q)
                else:
                    tok = torch.argmax(last, dim=-1)
                drafts.append(tok)
            drafts = torch.stack(drafts[: k - 1], dim=1)  # (b, k-1)
            logits = model(torch.cat([cur[:, None], drafts], dim=1), t_cache)  # (b, k, V)
            if sampled:
                p_probs = probs(logits.reshape(b * k, -1)).reshape(b, k, -1)
                q_probs = torch.stack(qs[: k - 1], dim=1)
                px = torch.gather(p_probs[:, : k - 1], 2, drafts[..., None])[..., 0]
                qx = torch.gather(q_probs, 2, drafts[..., None])[..., 0]
                us = torch.stack([uniform_rows(keys(1, pos + i), 1)[:, 0]
                                  for i in range(k - 1)], dim=1)
                acc = torch.cat([us * qx < px, torch.zeros_like(px, dtype=torch.bool)[:, :1]], 1)
                a = int(torch.argmin(acc.to(torch.int32), dim=1).min())
                p_a = p_probs[:, a]
                q_a = q_probs[:, a] if a < k - 1 else torch.zeros_like(p_a)
                res = torch.clamp_min(p_a - q_a, 0.0)
                ssum = res.sum(-1, keepdim=True)
                res = torch.where(ssum > 0, res / torch.where(ssum > 0, ssum, 1.0), p_a)
                res_tok = draw_rows(torch.log(res), keys(2, pos + a))
                x_a = drafts[:, a] if a < k - 1 else res_tok
                bonus = torch.where(acc[:, a], x_a, res_tok)
            else:
                preds = torch.argmax(logits, dim=-1)  # (b, k)
                match = drafts == preds[:, : k - 1]
                acc = torch.cat([match, torch.zeros_like(match[:, :1])], dim=1)
                a = int(torch.argmin(acc.to(torch.int32), dim=1).min())
                bonus = preds[:, a]
            emitted = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            emitted[:, a] = bonus
            out[:, pos: pos + k] = emitted
            n += a + 1
            cur = bonus
            _rewind(t_cache, pos + a)
            _rewind(d_cache, pos + a)
        return out[:, :total]


def beam_search(
    model,
    prompt,
    max_new_tokens: int = 32,
    beam_size: int = 4,
    eos_id: int | None = None,
    pad_id: int = 0,
    length_penalty: float = 0.0,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the KV-cached decode path: returns ``(tokens (b,
    L + max_new_tokens), scores (b,))``, the best beam per prompt and its
    total log-probability (divided by ``generated_length **
    length_penalty`` when set; a finished beam keeps its eos length).

    ``b * beam_size`` cache rows, beam-major (row ``i * beam_size + j``
    is beam j of prompt i), live for the whole search; each step is one
    decode call, a top-k over ``(b, beam_size * vocab)`` and a gather
    that reorders the written part of every cache tensor (int8 scales
    included) and the emitted tokens by back-pointer. With ``eos_id``, a
    finished beam's only continuation is ``pad_id`` at zero cost, so it
    competes unchanged while live beams extend. Ties in the top-k go to
    the lower index, as ``jax.lax.top_k`` breaks them.
    """
    device = _check_model(model, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, prompt_len = prompt.shape
    k = beam_size
    if k < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len + max_new_tokens > model.max_decode_len:
        raise ValueError(
            f"prompt {prompt_len} + {max_new_tokens} new tokens exceeds "
            f"max_decode_len {model.max_decode_len}"
        )
    neg = -1e30

    with torch.inference_mode():
        cache = model.init_cache(b * k)
        logits = model(prompt.repeat_interleave(k, dim=0), cache, fresh=True)
        logp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
        v = logp.shape[-1]
        pad_only = torch.full((v,), neg, device=device)
        pad_only[pad_id] = 0.0
        # Only beam 0 is live at first: every row holds the same prompt,
        # so step 1 takes the top-k distinct first tokens of one row.
        scores = torch.full((b, k), neg, device=device)
        scores[:, 0] = 0.0
        done = torch.zeros((b, k), dtype=torch.bool, device=device)
        lengths = torch.zeros((b, k), dtype=torch.long, device=device)
        base = torch.arange(b, device=device)[:, None] * k
        buf = torch.full((b * k, max_new_tokens), pad_id, dtype=torch.long, device=device)
        for t in range(max_new_tokens):
            if t:
                logits = model(tok.reshape(-1, 1), cache)
                logp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
            logp = torch.where(done[:, :, None], pad_only, logp.reshape(b, k, v))
            flat = (scores[:, :, None] + logp).reshape(b, k * v)
            scores, top = torch.sort(flat, dim=1, descending=True, stable=True)
            scores, top = scores[:, :k], top[:, :k]
            parent, tok = top // v, top % v
            done = torch.gather(done, 1, parent)
            lengths = torch.gather(lengths, 1, parent)
            if eos_id is not None:
                lengths = torch.where(done, lengths, lengths + 1)
                done = done | (tok == eos_id)
            else:
                lengths = lengths + 1
            rows = (base + parent).reshape(-1)
            cache.reorder_rows(rows, prompt_len + t)
            buf = buf.index_select(0, rows)
            buf[:, t] = tok.reshape(-1)
        ranked = scores
        if length_penalty:
            ranked = scores / torch.clamp_min(lengths, 1).to(torch.float32) ** length_penalty
        best = torch.argmax(ranked, dim=1)
        best_tokens = buf[(base[:, 0] + best)]
        best_scores = torch.gather(ranked, 1, best[:, None])[:, 0]
        return torch.cat([prompt, best_tokens], dim=1), best_scores
