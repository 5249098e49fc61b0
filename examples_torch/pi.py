"""Monte-Carlo pi — the jobs-client toy payload, with a cross-module import.

Counterpart of ``examples/pi.py`` (jobs-client/user_program/code/pi.py +
resources/util.py, SURVEY.md §2.7): the fixture for remote job
submission. The reference zips a workspace whose main file imports a
sibling module (``pi_util.py`` here) — staging must carry both files.
The estimate is drawn on the card (``--device cpu`` to run it on the
host) from a ``torch.Generator`` seeded with ``--seed``.

Usage: ``python examples_torch/pi.py [samples] [--seed 0] [--device cpu]``
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import pi_util  # noqa: E402  (the reference's cross-module import demo)


def estimate_pi(samples: int = 1_000_000, seed: int = 0, *, device=None) -> float:
    import torch

    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(samples, generator=gen, device=dev)
    y = torch.rand(samples, generator=gen, device=dev)
    return float(pi_util.inside(x, y).float().mean() * 4.0)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("samples", type=int, nargs="?", default=1_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    print(f"pi is roughly {estimate_pi(args.samples, args.seed, device=args.device):.6f}")
