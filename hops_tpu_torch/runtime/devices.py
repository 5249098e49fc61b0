"""Device selection for the port (counterpart of ``hops_tpu/runtime/devices.py``).

Every entry point of the port takes ``device=``; ``None`` means the card
(inside a search trial, the trial's first device: :func:`trial_scope`).
Where there is no card the entry point raises: it never carries on
quietly on the CPU. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import threading
from typing import Iterator, Sequence

import torch

# The search driver runs each trial on a thread of its own, inside the
# trial's group of devices (``jax.default_device`` plus the mesh's
# ``device_scope`` in the JAX package).
_trial = threading.local()


def default_device() -> torch.device:
    """The first CUDA device, ``cuda:0``."""
    return torch.device("cuda", 0)


def visible_devices() -> list[torch.device]:
    """Every visible card, ``cuda:0`` .. ``cuda:n-1`` (``jax.local_devices()``
    in the JAX package). Raises ``RuntimeError`` where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is False); "
            "pass the devices explicitly, e.g. devices=[torch.device('cpu')]")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@contextlib.contextmanager
def trial_scope(devices: Sequence[str | torch.device]) -> Iterator[list[torch.device]]:
    """Run this thread's work on one trial's group of devices: inside,
    :func:`resolve_device` of ``None`` is the group's first device and
    :func:`scoped_devices` the whole group. On a card the thread's
    current CUDA device is the group's first too (CUDA keeps it per
    thread). Scopes nest; other threads are not affected."""
    group = [torch.device(d) for d in devices]
    if not group:
        raise ValueError("a trial scope needs at least one device")
    prev = getattr(_trial, "devices", None)
    _trial.devices = group
    try:
        if group[0].type == "cuda":
            with torch.cuda.device(group[0]):
                yield list(group)
        else:
            yield list(group)
    finally:
        _trial.devices = prev


def scoped_devices() -> list[torch.device] | None:
    """The devices of the enclosing :func:`trial_scope` on this thread,
    or None outside one."""
    group = getattr(_trial, "devices", None)
    return list(group) if group is not None else None


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the card (inside a
    :func:`trial_scope`, the trial's first device).

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and none is available.
    """
    if device is None:
        group = getattr(_trial, "devices", None)
        dev = group[0] if group else default_device()
    else:
        dev = torch.device(device)
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
