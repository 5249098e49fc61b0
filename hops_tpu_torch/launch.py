"""Per-host launcher CLI — ``python -m hops_tpu_torch.launch [opts] script.py``
(counterpart of ``hops_tpu/launch.py``).

Every process runs the same program: the launcher joins this process to
the run's process group (:func:`hops_tpu_torch.parallel.multihost.initialize`:
NCCL on cards, gloo on the CPU, rendezvous at rank 0), pins the shared
run-session id, then hands the process to the user's script or module,
whose ``experiment.*`` calls and strategies now see every rank.

Usage (one invocation per process; one process per card):

    python -m hops_tpu_torch.launch \\
        --coordinator 10.0.0.2:1234 --num-processes 8 --process-id $RANK \\
        train.py --epochs 10

A single process needs no flags: ``python -m hops_tpu_torch.launch
train.py``. Flags may also come from torchrun's environment variables:
``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator), ``WORLD_SIZE``
and ``RANK``; ``LOCAL_RANK`` picks the card. ``--platform cpu`` (or
``HOPS_TPU_PLATFORM=cpu``) joins over gloo and makes the CPU this
process's device for the strategies; the default, ``cuda``, joins over
NCCL on the process's card.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys


def _env_coordinator() -> str | None:
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def _env_int(name: str) -> int | None:
    return int(os.environ[name]) if name in os.environ else None


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m hops_tpu_torch.launch", description=__doc__.split("\n")[0]
    )
    parser.add_argument("--coordinator", default=_env_coordinator(),
                        help="host:port of rank 0's rendezvous (MASTER_ADDR:MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=_env_int("WORLD_SIZE"))
    parser.add_argument("--process-id", type=int, default=_env_int("RANK"))
    parser.add_argument(
        "--platform", choices=("cuda", "cpu"),
        default=os.environ.get("HOPS_TPU_PLATFORM", "cuda"),
        help="cuda: NCCL on this process's card; cpu: gloo, and the CPU as the "
        "strategies' device",
    )
    parser.add_argument("-m", "--module", help="run a module instead of a script file")
    parser.add_argument("script", nargs="?", help="Python file to run in this process")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if not args.module and not args.script:
        parser.error("provide a script file or -m module")

    # Join the group before the user's code can touch a device.
    from hops_tpu_torch.parallel import multihost

    multihost.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        device="cpu" if args.platform == "cpu" else None,
    )

    try:
        if args.module:
            sys.argv = [args.module, *([args.script] if args.script else []), *args.script_args]
            runpy.run_module(args.module, run_name="__main__", alter_sys=True)
        else:
            sys.argv = [args.script, *args.script_args]
            runpy.run_path(args.script, run_name="__main__")
    finally:
        # Leave the group (NCCL warns at exit about one left alive) and
        # drop the recorded device, so an in-process caller is as before.
        multihost.shutdown()


if __name__ == "__main__":
    main()
