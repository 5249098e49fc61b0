"""MNIST models (counterpart of ``hops_tpu/models/mnist.py``).

The JAX package's CNN and FFN with flax's parameter names and bf16
compute by default. Both take NHWC images, as the JAX modules do; the
CNN computes on the channels-last NCHW view of them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from hops_tpu_torch.models.layers import Conv, Dense, init_weights
from hops_tpu_torch.models.transformer import as_dtype, dropout
from hops_tpu_torch.runtime.devices import resolve_device


class CNN(nn.Module):
    """Conv(32)-pool-Conv(64)-pool-Dense(128)-dropout-Dense(10) over
    28x28x1 images."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 dtype: Any = "bfloat16", in_channels: int = 1, image_size: int = 28,
                 device: Any = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = as_dtype(dtype)
        self.dropout_rate = dropout_rate
        kw = dict(dtype=self.dtype, device=dev)
        self.Conv_0 = Conv(in_channels, 32, (3, 3), **kw)
        self.Conv_1 = Conv(32, 64, (3, 3), **kw)
        side = image_size // 2 // 2
        self.Dense_0 = Dense(side * side * 64, 128, **kw)
        self.Dense_1 = Dense(128, num_classes, **kw)
        init_weights(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """fp32 logits of NHWC images. ``train=True`` with
        ``dropout_rate > 0`` draws the dropout mask from ``generator``."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        # flax flattens NHWC: Dense_0's rows are in (h, w, c) order.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        if train and self.dropout_rate:
            if generator is None:
                raise ValueError("dropout in training needs generator=")
            x = dropout(x, self.dropout_rate, int(torch.randint(0, 2**62, (), generator=generator)))
        return self.Dense_1(x).to(torch.float32)


class FFN(nn.Module):
    """Flatten-Dense(128)-Dense(10), the end-to-end-pipeline model."""

    def __init__(self, num_classes: int = 10, hidden: int = 128, dtype: Any = "bfloat16",
                 in_features: int = 28 * 28, device: Any = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = as_dtype(dtype)
        self.Dense_0 = Dense(in_features, hidden, dtype=self.dtype, device=dev)
        self.Dense_1 = Dense(hidden, num_classes, dtype=self.dtype, device=dev)
        init_weights(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x))).to(torch.float32)
