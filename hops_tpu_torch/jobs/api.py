"""The import path of a child process (counterpart of
``_child_pythonpath`` in ``hops_tpu/jobs/api.py``; the rest of that
module, the job API itself, is not ported yet).

``modelrepo.serving.start(name, standalone=True)`` spawns a fresh
interpreter that must import ``hops_tpu_torch`` from the same checkout
as its parent.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def _child_pythonpath(existing: str | None) -> str:
    """Import path for child processes: inherited ``PYTHONPATH``, then
    the port's own location, then the parent's on-disk ``sys.path``
    entries.

    A clean checkout is neither pip-installed nor on ``PYTHONPATH``, so
    without this a child could not ``import hops_tpu_torch`` at all.
    """
    import hops_tpu_torch

    # An inherited PYTHONPATH keeps precedence over everything, so a
    # caller can pin its own staged dependencies; the port's root after
    # that covers the bare-checkout case; sys.path[0] (the parent
    # script's directory) is excluded so stray modules next to the
    # launcher don't shadow the child's imports.
    entries = existing.split(os.pathsep) if existing else []
    entries.append(str(Path(hops_tpu_torch.__file__).resolve().parent.parent))
    entries += [p for p in sys.path[1:] if p and Path(p).exists()]
    return os.pathsep.join(dict.fromkeys(entries))
