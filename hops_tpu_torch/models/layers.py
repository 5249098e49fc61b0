"""flax.linen's ``Conv``, ``Dense`` and ``BatchNorm`` for the port's
classification models (``models/mnist.py``, ``models/resnet.py``).

Each keeps flax's parameter names, so a JAX tree loads by name
(:mod:`hops_tpu_torch.models.convert`): ``kernel`` and ``bias``;
``scale`` and ``bias`` with the running ``mean`` and ``var`` as buffers.
Parameters are fp32, as flax stores them; each op computes in the
module's ``dtype`` where flax does. Images travel as logical NCHW
tensors in the channels-last memory format — the NHWC bytes of the JAX
package, so a ``permute`` of an NHWC batch is free. Layout differences
from flax: a conv ``kernel`` is OIHW (flax: HWIO), a ``Dense`` kernel
keeps flax's ``(in, out)``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator

import torch
from torch import nn
from torch.nn import functional as F

#: Set while ``torch.utils.checkpoint`` recomputes a block in backward
#: (:func:`recompute_context`): BatchNorm then must not fold the batch
#: statistics into its running ones a second time.
_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "hops_tpu_torch_bn_recomputing", default=False
)


@contextlib.contextmanager
def _recomputing() -> Iterator[None]:
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: the
    forward runs as is, the recompute in backward with BatchNorm's
    running-statistics update off (it already happened in the forward)."""
    return contextlib.nullcontext(), _recomputing()


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """lax's ``"SAME"`` padding of one spatial dim: ``ceil(size/stride)``
    outputs, the total padding split with the odd pixel after. A 3x3
    stride-2 window over an even size pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``"SAME"`` padding: ``kernel`` OIHW (fp32),
    optional ``bias``; input and weights cast to ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size: tuple[int, int],
                 strides: tuple[int, int] = (1, 1), use_bias: bool = True, *,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        self.kernel = nn.Parameter(torch.empty(
            (features, in_features, *kernel_size), dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(dtype=self.dtype, memory_format=torch.channels_last)
        (ph, qh), (pw, qw) = (same_pads(n, k, s) for n, k, s in
                              zip(x.shape[2:], w.shape[2:], self.strides))
        x = x.to(self.dtype)
        if (ph, pw) == (qh, qw):
            padding = (ph, pw)
        else:
            x = F.pad(x, (pw, qw, ph, qh)).contiguous(memory_format=torch.channels_last)
            padding = (0, 0)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, b, stride=self.strides, padding=padding)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``kernel`` of shape
    ``(in, out)`` (fp32), computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            (in_features, features), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of an NCHW tensor.

    Training normalizes by the batch's mean and **biased** variance
    (``E[x^2] - E[x]^2``, as flax computes it), in fp32 whatever the
    input dtype, and folds them into the running
    statistics as ``momentum * running + (1 - momentum) * batch`` (flax's
    ``momentum=0.9`` — torch's ``BatchNorm2d`` would call it 0.1, and
    would fold in the unbiased variance). Evaluation normalizes by the
    running statistics. The output is cast to ``dtype``.
    """

    def __init__(self, features: int, *, dtype: torch.dtype, device: torch.device,
                 momentum: float = 0.9, epsilon: float = 1e-5, scale_init: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale_init = scale_init
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.full((features,), scale_init, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            # flax's fast variance, E[x^2] - E[x]^2 clipped at 0, in one
            # pass: the same rounding as the JAX package's statistics.
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
            if not _RECOMPUTING.get():
                with torch.no_grad():
                    m = self.momentum
                    self.mean.mul_(m).add_(mean, alpha=1.0 - m)
                    self.var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded weights drawn as flax initialises them: conv and dense
    kernels from lecun_normal (a normal truncated at two deviations,
    variance ``1 / fan_in``), biases 0, BatchNorm scales at their
    ``scale_init`` with bias 0, running mean 0 and variance 1. Drawn on
    the CPU in module order, so a seed gives the same weights on every
    device. For runs without trained weights; the JAX package's own draw
    cannot be reproduced (carry its weights over with ``convert``)."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        kernels = [module.kernel] if isinstance(module, (Conv, Dense)) else []
        if isinstance(getattr(module, "stem_conv", None), nn.Parameter):
            kernels.append(module.stem_conv)
        for w in kernels:
            fan_in = w[0].numel() if w.ndim == 4 else w.shape[0]  # OIHW or (in, out)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            draw = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=g)
            w.copy_(draw)
        if isinstance(module, (Conv, Dense)) and module.bias is not None:
            module.bias.zero_()
        if isinstance(module, BatchNorm):
            module.scale.fill_(module.scale_init)
            module.bias.zero_()
            module.mean.zero_()
            module.var.fill_(1.0)
    return model
