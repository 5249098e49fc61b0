"""Memory-efficient LM-head loss (counterpart of ``hops_tpu/ops/xent.py``).

:func:`chunked_softmax_xent` computes the mean next-token cross-entropy
straight from the final hidden states and the unembed matrix, a token
chunk at a time. Its backward recomputes each chunk's logits, so the
``(batch, seq, vocab)`` fp32 logits never exist: peak LM-head memory is
``chunk x vocab`` fp32 in both passes.

The LM-head product is a plain large matrix product, which the JAX
package leaves to XLA, so here it is ``torch.mm`` with fp32
accumulation and fp32 logits (bf16 inputs: ``out_dtype=torch.float32``
on the card). Same log-sum-exp formulation as
``optax.softmax_cross_entropy_with_integer_labels`` in fp32.
"""

from __future__ import annotations

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32, like ``dot_general``
    with ``preferred_element_type=float32``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()  # exact products of the low-precision values


class _ChunkedXent(torch.autograd.Function):
    """Forward: per chunk, fp32 logits, logsumexp and the target logit;
    only the ``(n,)`` lse leaves a chunk. Backward: per chunk, logits
    again, ``dlogits = (softmax - onehot) / n`` on valid tokens, then
    ``dh = dlogits wᵀ`` (in h's dtype) and ``dw += hᵀ dlogits`` (fp32)."""

    @staticmethod
    def forward(ctx, h, unembed, targets, valid, chunk, n):
        w = unembed.to(h.dtype)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for hc, tc, vc in zip(h.split(chunk), targets.split(chunk), valid.split(chunk)):
            logits = _mm_f32(hc, w)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, tc[:, None])[:, 0]
            total += ((lse - tgt) * vc).sum()
            lses.append(lse)
        ctx.save_for_backward(h, unembed, targets, valid, torch.cat(lses))
        ctx.chunk, ctx.n = chunk, n
        return total / n

    @staticmethod
    def backward(ctx, g):
        h, unembed, targets, valid, lse = ctx.saved_tensors
        chunk, n = ctx.chunk, ctx.n
        w = unembed.to(h.dtype)
        dh = torch.empty_like(h)
        dw = torch.zeros(unembed.shape, dtype=torch.float32, device=unembed.device)
        scale = g.float() / n
        for i, (hc, tc, vc, lc) in enumerate(zip(
            h.split(chunk), targets.split(chunk), valid.split(chunk), lse.split(chunk)
        )):
            dl = torch.exp(_mm_f32(hc, w) - lc[:, None])
            dl.scatter_add_(1, tc[:, None], -torch.ones_like(lc)[:, None])
            dl *= (vc * scale)[:, None]
            dl = dl.to(h.dtype)
            dh[i * chunk:(i + 1) * chunk] = dl @ w.T
            dw += _mm_f32(hc.T, dl)
        return dh, dw.to(unembed.dtype), None, None, None, None


def chunked_softmax_xent(
    hidden: torch.Tensor,
    unembed: torch.Tensor,
    targets: torch.Tensor,
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """Mean next-token cross-entropy from hidden states.

    ``hidden``: ``(batch, seq, d)``, the final-norm output; ``unembed``:
    the ``(d, vocab)`` kernel (cast to ``hidden``'s dtype for the
    product, as flax's ``Dense`` casts it); ``targets``: ``(batch, seq)``
    ids. ``chunk`` is a TOKEN count: the flattened ``batch*seq`` tokens
    are processed ``chunk`` at a time, padded up to a multiple and
    masked. Returns the fp32 scalar mean loss.
    """
    b, s, d = hidden.shape
    n = b * s
    h = hidden.reshape(n, d)
    t = targets.reshape(n).long()
    pad = (-n) % chunk
    if pad:
        h = torch.cat([h, h.new_zeros((pad, d))])
        t = torch.cat([t, t.new_zeros((pad,))])
    valid = (torch.arange(n + pad, device=h.device) < n).float()
    return _ChunkedXent.apply(h, unembed, t, valid, chunk, n)
