"""Carry TransformerLM weights between the JAX package and the port.

A JAX parameter tree (``model.init(...)``, as numpy arrays) or a flat
``'/'``-joined file maps onto the port's state dict by name alone: the
port's modules keep the flax names and shapes (``embed/embedding``,
``block_i/{RMSNorm_0,RMSNorm_1}/scale``, ``block_i/attn/{qkv|q,kv,out}/kernel``,
``block_i/mlp/{gate,up,down}/kernel``, ``final_norm/scale``,
``unembed/kernel``). Neither side needs the other's framework to write or
read the ``.npz`` artifact.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """A nested mapping of arrays as a flat ``'/'``-joined dict. A
    top-level ``"params"`` collection (``model.init``'s output) is
    unwrapped."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def params_from_flax(tree_or_flat: Mapping[str, Any] | str | Path) -> dict[str, torch.Tensor]:
    """A state dict for :class:`hops_tpu_torch.models.transformer.TransformerLM`
    from a JAX parameter tree, a flat ``'/'``-joined dict, or the path of
    a :func:`save_npz` file. Tensors stay fp32 on the CPU;
    ``load_state_dict`` casts them to the module's dtype and device."""
    flat = load_npz(tree_or_flat) if isinstance(tree_or_flat, (str, Path)) else flatten(tree_or_flat)
    return {
        name.replace("/", "."): torch.from_numpy(
            arr if arr.flags.writeable and arr.flags.c_contiguous else np.array(arr)
        )
        for name, arr in flat.items()
    }


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
