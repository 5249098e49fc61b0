"""Autoregressive sampling for TransformerLM (counterpart of
``hops_tpu/models/generation.py``).

A prefill call writes the prompt into an explicit KV cache
(``model.init_cache``) through the flash kernel, then single-token steps
stream the cache through the decode kernel.

Sampling draws from ``torch.Generator``s seeded per ``(seed, row, step)``,
so a sampled stream is deterministic for a seed and independent of the
batch it rides in. JAX's PRNG streams are not reproduced: greedy
decoding matches the JAX package token for token, sampled decoding only
itself.
"""

from __future__ import annotations

import torch

from hops_tpu_torch.runtime.devices import resolve_device

_MASK64 = (1 << 64) - 1


def _mix(*values: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each in turn)."""
    z = 0x9E3779B97F4A7C15
    for v in values:
        z = (z ^ (int(v) & _MASK64)) & _MASK64
        z = (z + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def draw(scaled_row: torch.Tensor, *key: int) -> int:
    """One token from the categorical distribution of ``scaled_row``
    (fp32 ``(vocab,)`` logits, ``-inf`` where masked), with noise drawn
    from a generator seeded by ``key`` (Gumbel-max through exponential
    variates: ``argmax(logits - log E)``)."""
    gen = torch.Generator(device=scaled_row.device)
    gen.manual_seed(_mix(*key))
    e = torch.empty_like(scaled_row, dtype=torch.float32).exponential_(generator=gen)
    e.clamp_min_(torch.finfo(torch.float32).tiny)
    return int(torch.argmax(scaled_row - torch.log(e)))


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
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, generate asked for {device}")
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
        return torch.tensor(
            [draw(scaled[r], seed, row_offset + r, step) for r in range(b)],
            dtype=torch.long, device=device,
        )

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
