"""Wide-and-deep tabular model (counterpart of
``hops_tpu/models/widedeep.py``; the Chicago-Taxi Trainer equivalent).

Wide = linear over one-hot categoricals, deep = MLP over embeddings +
dense features; logits summed, fp32 out. The parameters keep flax's
names and shapes (``wide_i/kernel`` of ``(vocab_i, num_classes)``,
``embed_i/embedding``, ``deep_j/{kernel,bias}``, ``deep_out/{kernel,bias}``),
so a JAX variable tree loads through
:func:`~hops_tpu_torch.models.convert.params_from_flax`.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from hops_tpu_torch.models.layers import Dense, init_weights
from hops_tpu_torch.models.transformer import as_dtype
from hops_tpu_torch.runtime.devices import resolve_device


class _Wide(nn.Module):
    """flax ``nn.Dense(num_classes, use_bias=False)`` over a one-hot of
    ``vocab`` ids: the product picks the kernel's row of each id, so it
    is computed as that gather (the same values, rounded the same way:
    one product by 1.0 and the rest by 0)."""

    def __init__(self, vocab: int, num_classes: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((vocab, num_classes), device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.kernel.to(self.dtype)[ids]


class _Embed(nn.Module):
    """flax ``nn.Embed``: the table cast to ``dtype``, then gathered."""

    def __init__(self, vocab: int, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty((vocab, dim), device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)


class WideAndDeep(nn.Module):
    """Inputs: ``{"dense": [B, num_dense] float, "categorical":
    [B, num_cat] int (already hashed/bucketized)}``, numpy arrays or
    tensors; fp32 logits ``[B, num_classes]``. ``num_dense`` is the dense
    width the JAX module reads off its first batch."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        embed_dim: int = 8,
        hidden: Sequence[int] = (128, 64),
        num_classes: int = 2,
        dtype: Any = "bfloat16",
        num_dense: int = 5,
        device: Any = None,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.hidden = tuple(int(h) for h in hidden)
        self.dtype = as_dtype(dtype)
        for i, vocab in enumerate(self.vocab_sizes):
            self.add_module(f"wide_{i}", _Wide(vocab, num_classes, self.dtype, dev))
            self.add_module(f"embed_{i}", _Embed(vocab, embed_dim, self.dtype, dev))
        width = embed_dim * len(self.vocab_sizes) + num_dense
        for j, out in enumerate(self.hidden):
            self.add_module(f"deep_{j}", Dense(width, out, dtype=self.dtype, device=dev))
            width = out
        self.deep_out = Dense(width, num_classes, dtype=self.dtype, device=dev)
        self._init(seed)

    @torch.no_grad()
    def _init(self, seed: int) -> None:
        """flax's initializers: Dense kernels (the wide ones too)
        lecun_normal, biases 0 (:func:`init_weights`), embeddings normal
        with std ``1/sqrt(embed_dim)``."""
        init_weights(self, seed)
        g = torch.Generator().manual_seed(seed + 1)
        for i, vocab in enumerate(self.vocab_sizes):
            wide = getattr(self, f"wide_{i}").kernel
            std = math.sqrt(1.0 / vocab) / 0.87962566103423978
            draw = torch.empty(wide.shape)
            nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=g)
            wide.copy_(draw)
            table = getattr(self, f"embed_{i}").embedding
            table.copy_(torch.randn(table.shape, generator=g) / math.sqrt(table.shape[1]))

    @property
    def device(self) -> torch.device:
        return self.deep_out.kernel.device

    def forward(self, batch: dict[str, Any], train: bool = False) -> torch.Tensor:
        del train  # no dropout or batch statistics
        dev = self.device
        dense = torch.as_tensor(batch["dense"]).to(dev, self.dtype)
        cats = torch.as_tensor(batch["categorical"]).to(dev, torch.long)
        # Wide path: per-feature one-hot linear logits, summed in dtype.
        wide = getattr(self, "wide_0")(cats[:, 0])
        for i in range(1, len(self.vocab_sizes)):
            wide = wide + getattr(self, f"wide_{i}")(cats[:, i])
        # Deep path: embeddings + dense features through an MLP.
        embs = [getattr(self, f"embed_{i}")(cats[:, i]) for i in range(len(self.vocab_sizes))]
        x = torch.cat(embs + [dense], dim=-1)
        for j in range(len(self.hidden)):
            x = F.relu(getattr(self, f"deep_{j}")(x))
        return (wide + self.deep_out(x)).to(torch.float32)


def batch_from_vectors(vectors, num_dense: int) -> dict[str, np.ndarray]:
    """Model-ready ``WideAndDeep`` batch from serving-time feature
    vectors: the first ``num_dense`` entries of each vector are the
    dense floats, the rest the hashed/bucketized categorical ids.
    Accepts plain Python lists (the serving JSON path) or arrays."""
    arr = np.asarray(vectors, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] <= num_dense:
        raise ValueError(
            f"expected [batch, >{num_dense}] feature vectors, got "
            f"shape {arr.shape}"
        )
    return {
        "dense": arr[:, :num_dense].astype(np.float32),
        "categorical": arr[:, num_dense:].astype(np.int32),
    }


def make_taxi_batch(generator: torch.Generator, batch_size: int, vocab_sizes: Sequence[int],
                    num_dense: int = 5, device: Any = None) -> dict[str, torch.Tensor]:
    """Synthetic Chicago-Taxi-shaped batch (tips classification twin),
    drawn from ``generator`` (on ``device``; ``None``: the card) — the
    JAX package's draw from ``jax.random`` cannot be reproduced, its
    label rule is kept: the label correlates with the first dense
    feature and the first categorical's parity."""
    dev = resolve_device(device)
    cats = torch.stack([
        torch.randint(0, int(v), (batch_size,), generator=generator, device=dev)
        for v in vocab_sizes
    ], dim=1).to(torch.int32)
    dense = torch.randn((batch_size, num_dense), generator=generator, device=dev)
    label = ((dense[:, 0] + (cats[:, 0] % 2) * 0.5) > 0.25).to(torch.int32)
    return {"dense": dense, "categorical": cats, "label": label}
