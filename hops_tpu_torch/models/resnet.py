"""ResNet-v1.5 (counterpart of ``hops_tpu/models/resnet.py``).

The JAX package's ResNet with flax's parameter names: bf16 compute by
default, fp32 parameters and BatchNorm statistics, NHWC input computed
on its channels-last NCHW view. Stride 2 sits in the 3x3 conv of a
bottleneck, with lax's ``"SAME"`` padding (0 before and 1 after on an
even size).

``s2d_stem`` is accepted and changes nothing: in the JAX package it
rewrites the 7x7 stride-2 stem as a 4x4 conv over a space-to-depth
input to feed the TPU's matrix unit, an identity the port does not need;
the port computes the plain 7x7 stride-2 conv with padding 3. ``remat``
recomputes each bottleneck in backward (``torch.utils.checkpoint``)
instead of keeping its activations; BatchNorm's running statistics are
updated once per step either way.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from hops_tpu_torch.models.layers import BatchNorm, Conv, Dense, init_weights, recompute_context
from hops_tpu_torch.models.transformer import as_dtype
from hops_tpu_torch.runtime.devices import resolve_device


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: tuple[int, int] = (1, 1), *,
                 dtype: torch.dtype, norm_dtype: torch.dtype, device: torch.device):
        super().__init__()
        conv = dict(use_bias=False, dtype=dtype, device=device)
        norm = dict(dtype=norm_dtype, device=device)
        self.Conv_0 = Conv(in_features, filters, (1, 1), **conv)
        self.BatchNorm_0 = BatchNorm(filters, **norm)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, **conv)
        self.BatchNorm_1 = BatchNorm(filters, **norm)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), **conv)
        self.BatchNorm_2 = BatchNorm(filters * 4, scale_init=0.0, **norm)
        if in_features != filters * 4 or tuple(strides) != (1, 1):
            self.proj = Conv(in_features, filters * 4, (1, 1), strides, **conv)
            self.proj_bn = BatchNorm(filters * 4, **norm)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = self.proj_bn(self.proj(x), train) if hasattr(self, "proj") else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000, width: int = 64,
                 dtype: Any = "bfloat16", norm_dtype: Any = None, s2d_stem: bool = True,
                 remat: bool = False, in_channels: int = 3, device: Any = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = as_dtype(dtype)
        norm = self.dtype if norm_dtype is None else as_dtype(norm_dtype)
        self.s2d_stem = s2d_stem
        self.remat = remat
        self.num_blocks = sum(stage_sizes)
        self.stem_conv = nn.Parameter(torch.empty(
            (width, in_channels, 7, 7), dtype=torch.float32, device=dev))
        self.BatchNorm_0 = BatchNorm(width, dtype=norm, device=dev)
        features, n = width, 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = BottleneckBlock(features, width * 2**i, strides,
                                        dtype=self.dtype, norm_dtype=norm, device=dev)
                setattr(self, f"BottleneckBlock_{n}", block)
                features, n = width * 2**i * 4, n + 1
        self.Dense_0 = Dense(features, num_classes, dtype=self.dtype, device=dev)
        init_weights(self, seed)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """fp32 logits of NHWC images; ``train=True`` normalizes by batch
        statistics and updates the running ones."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        w = self.stem_conv.to(dtype=self.dtype, memory_format=torch.channels_last)
        x = F.conv2d(x, w, stride=2, padding=3)
        x = F.relu(self.BatchNorm_0(x, train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        remat = train and self.remat and torch.is_grad_enabled()
        for n in range(self.num_blocks):
            block = getattr(self, f"BottleneckBlock_{n}")
            if remat:
                x = checkpoint(block, x, train, use_reentrant=False,
                               context_fn=recompute_context)
            else:
                x = block(x, train)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).to(torch.float32)


def ResNet50(num_classes: int = 1000, dtype: Any = "bfloat16", norm_dtype: Any = None,
             s2d_stem: bool = True, remat: bool = False, device: Any = None,
             seed: int = 0) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes=num_classes, dtype=dtype, norm_dtype=norm_dtype,
                  s2d_stem=s2d_stem, remat=remat, device=device, seed=seed)


def ResNet18ish(num_classes: int = 10, dtype: Any = "bfloat16", remat: bool = False,
                device: Any = None, seed: int = 0) -> ResNet:
    """Small bottleneck variant for CI-scale tests."""
    return ResNet([1, 1, 1, 1], num_classes=num_classes, width=16, dtype=dtype, remat=remat,
                  device=device, seed=seed)
