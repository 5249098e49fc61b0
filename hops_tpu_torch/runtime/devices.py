"""Device selection for the port (counterpart of ``hops_tpu/runtime/devices.py``).

Every entry point of the port takes ``device=``; ``None`` means the card.
Where there is no card the entry point raises: it never carries on
quietly on the CPU. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def default_device() -> torch.device:
    """The first CUDA device, ``cuda:0``."""
    return torch.device("cuda", 0)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the card.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and none is available.
    """
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card only). Raises when ``nvidia-smi`` is missing
    or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out.splitlines()[0].strip()
