"""Carry weights between the JAX package and the port.

A JAX variable tree (``model.init(...)``, as numpy arrays) or a flat
``'/'``-joined file maps onto the port's state dict by name alone: the
port's modules keep the flax names and shapes (the LM's
``embed/embedding``, ``block_i/{RMSNorm_0,RMSNorm_1}/scale``,
``block_i/attn/{qkv|q,kv,out}/kernel``, ``block_i/mlp/{gate,up,down}/kernel``,
``final_norm/scale``, ``unembed/kernel``; the classifiers'
``Conv_i/{kernel,bias}``, ``Dense_i/{kernel,bias}``, ``.../BatchNorm_i``
and ``proj``/``proj_bn``, ``stem_conv``; wide-and-deep's
``wide_i/kernel``, ``embed_i/embedding``, ``deep_j/{kernel,bias}`` and
``deep_out/{kernel,bias}``). A tree's ``batch_stats``
collection (BatchNorm's ``mean`` and ``var``) joins the ``params`` in one
state dict, where they are the BatchNorm modules' buffers.

One layout changes on the way: a conv kernel — a 4-d ``kernel`` of a
``Conv_i`` or ``proj`` module, or ``stem_conv`` — is HWIO in flax and
OIHW in the port. Every other array, ``Dense`` kernels included
(``(in, out)``), keeps flax's layout. Neither side needs the other's
framework to write or read the ``.npz`` artifact. :func:`params_to_flax`
carries the weights back: a model trained by the port loads into the JAX
module and into an artifact.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch


_COLLECTIONS = {"params", "batch_stats"}
_CONV_KERNEL = re.compile(r"(^|/)((Conv_\d+|proj)/kernel|stem_conv)$")


def _is_conv_kernel(name: str, arr: Any) -> bool:
    return np.ndim(arr) == 4 and _CONV_KERNEL.search(name) is not None


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """A nested mapping of arrays as a flat ``'/'``-joined dict. Top-level
    ``"params"`` and ``"batch_stats"`` collections (``model.init``'s
    output) are unwrapped and merged: their leaf names never collide."""
    if not prefix and "params" in tree and set(tree) <= _COLLECTIONS:
        out = {}
        for col in sorted(tree):
            out.update(flatten(tree[col]))
        return out
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def params_from_flax(tree_or_flat: Mapping[str, Any] | str | Path) -> dict[str, torch.Tensor]:
    """A state dict for a port module (the LM, ``CNN``, ``FFN``,
    ``ResNet``) from a JAX variable tree (``params``, with or without
    ``batch_stats``), a flat ``'/'``-joined dict, or the path of a
    :func:`save_npz` file. Conv kernels turn OIHW. Tensors stay fp32 on
    the CPU; ``load_state_dict`` casts them to the module's dtype and
    device."""
    flat = load_npz(tree_or_flat) if isinstance(tree_or_flat, (str, Path)) else flatten(tree_or_flat)
    out = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        if _is_conv_kernel(name, arr):
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        arr = np.ascontiguousarray(arr)
        out[name.replace("/", ".")] = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return out


def params_to_flax(model: torch.nn.Module) -> dict[str, Any]:
    """The module's weights in the flax layout, as fp32 numpy arrays in
    flat ``'/'``-joined dicts. A module without buffers (the LM, ``CNN``,
    ``FFN``) gives the ``params`` dict itself: :func:`save_npz` writes it
    as an artifact and ``flax.traverse_util.unflatten_dict(flat,
    sep="/")`` makes it the JAX module's parameter tree. A module with
    BatchNorm gives ``{"params": ..., "batch_stats": ...}``, its buffers
    in the second."""
    buffers = {name for name, _ in model.named_buffers()}
    cols: dict[str, dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        arr = t.detach().to(torch.float32).cpu().numpy()
        flat_name = name.replace(".", "/")
        if _is_conv_kernel(flat_name, arr):
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        cols["batch_stats" if name in buffers else "params"][flat_name] = arr
    return cols if cols["batch_stats"] else cols["params"]


def save_npz(path: str | Path, tree_or_flat: Mapping[str, Any]) -> None:
    """Write parameters as one uncompressed ``.npz`` of ``'/'``-joined
    names."""
    np.savez(path, **flatten(tree_or_flat))


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


def random_params(
    vocab_size: int, d_model: int, num_heads: int, num_layers: int,
    num_kv_heads: int | None = None, seed: int = 0, **_unused: Any,
) -> dict[str, np.ndarray]:
    """Seeded fp32 weights in the flax layout, drawn as flax initialises
    them: Dense kernels normal with std ``1/sqrt(fan_in)``, the embedding
    normal with std ``1/sqrt(d_model)``, norm scales 1. For runs without
    a trained checkpoint. Extra config keys are ignored, so a whole
    ``lm_config`` can be passed."""
    rng = np.random.default_rng(seed)
    head_dim = d_model // num_heads
    hidden = max(128, (int(d_model * 4 * 2 / 3) // 128) * 128)

    def normal(shape, fan_in):
        arr = rng.standard_normal(shape, dtype=np.float32)
        arr *= np.float32(1.0 / np.sqrt(fan_in))
        return arr

    flat = {"embed/embedding": normal((vocab_size, d_model), d_model)}
    for i in range(num_layers):
        p = f"block_{i}"
        flat[f"{p}/RMSNorm_0/scale"] = np.ones((d_model,), np.float32)
        flat[f"{p}/RMSNorm_1/scale"] = np.ones((d_model,), np.float32)
        if num_kv_heads is None:
            flat[f"{p}/attn/qkv/kernel"] = normal((d_model, 3, num_heads, head_dim), d_model)
        else:
            flat[f"{p}/attn/q/kernel"] = normal((d_model, num_heads, head_dim), d_model)
            flat[f"{p}/attn/kv/kernel"] = normal((d_model, 2, num_kv_heads, head_dim), d_model)
        flat[f"{p}/attn/out/kernel"] = normal((num_heads * head_dim, d_model), num_heads * head_dim)
        flat[f"{p}/mlp/gate/kernel"] = normal((d_model, hidden), d_model)
        flat[f"{p}/mlp/up/kernel"] = normal((d_model, hidden), d_model)
        flat[f"{p}/mlp/down/kernel"] = normal((hidden, d_model), hidden)
    flat["final_norm/scale"] = np.ones((d_model,), np.float32)
    flat["unembed/kernel"] = normal((d_model, vocab_size), d_model)
    return flat
