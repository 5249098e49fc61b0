"""Standalone serving host / supervisor — ``python -m hops_tpu_torch.modelrepo.serving_host``
(counterpart of ``hops_tpu/modelrepo/serving_host.py``).

Importing this module starts nothing: :func:`main` does, and only when
the module runs as a program. The reference's servings are platform-owned containers that outlive
whatever notebook created them (model_repo_and_serving.ipynb:370-374);
here the equivalent is this resident process:

- ``serving_host NAME`` — host one serving endpoint until terminated.
  ``serving.start(name, standalone=True)`` spawns exactly this in a
  detached session, so the endpoint survives its creator.
- ``serving_host --restore [--watch N]`` — the supervisor verb: revive
  every serving recorded Running whose server died with its process,
  stay resident hosting them, and (with ``--watch``) re-check liveness
  every N seconds, reviving again as needed.
- ``serving_host --fleet-worker DIR`` — one fleet replica: host the
  serving config at ``DIR/cfg.json`` (in the JAX package,
  ``modelrepo.fleet.replicas.ReplicaManager`` writes it) WITHOUT touching the
  shared servings registry — N replicas of one endpoint each own a
  private port, announced via ``DIR/state.json``. The replica manager
  owns the lifecycle (drain via ``POST /admin/drain``, then SIGTERM).

Termination does NOT mark hosted servings Stopped: a record's Running
status is its owner's *intent*, which is what lets the next
``restore()`` bring the endpoint back after a crash or host restart.
A deliberate ``serving.stop(name)`` is the thing that flips the record.
"""

from __future__ import annotations

import argparse
import json
import os
import signal


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m hops_tpu_torch.modelrepo.serving_host",
        description=__doc__.split("\n")[0],
    )
    parser.add_argument("name", nargs="?", help="serving to host standalone")
    parser.add_argument(
        "--restore", action="store_true",
        help="revive dead-Running servings and supervise them",
    )
    parser.add_argument(
        "--watch", type=float, default=0.0,
        help="with --restore: re-check liveness every N seconds",
    )
    parser.add_argument(
        "--fleet-worker", metavar="DIR", default=None,
        help="host one fleet replica from DIR/cfg.json (registry untouched; "
        "port announced in DIR/state.json)",
    )
    args = parser.parse_args(argv)
    if sum(map(bool, (args.name, args.restore, args.fleet_worker))) != 1:
        parser.error("provide a serving name, --restore, or --fleet-worker")

    from hops_tpu_torch.modelrepo import serving

    # Block the termination signals BEFORE any server thread exists:
    # spawned threads inherit the mask, so the kernel can only deliver
    # them to this main thread's sigwait below. (A signal.signal handler
    # is NOT enough here — with server threads running, delivery can
    # land on a worker thread while the main thread sits in a C-level
    # wait, deferring the Python handler until that wait times out.)
    sigs = {signal.SIGTERM, signal.SIGINT}
    signal.pthread_sigmask(signal.SIG_BLOCK, sigs)

    if args.fleet_worker:
        from pathlib import Path

        rdir = Path(args.fleet_worker)
        cfg = json.loads((rdir / "cfg.json").read_text())
        running = serving._RunningServing(cfg)
        # Atomic announce: the replica manager polls for this file and
        # must never read a partial write.
        state = {"name": cfg["name"], "port": running.port, "pid": os.getpid(),
                 "version": cfg.get("model_version")}
        tmp = rdir / f".state.json.tmp{os.getpid()}"
        tmp.write_text(json.dumps(state))
        os.replace(tmp, rdir / "state.json")
        print(json.dumps(state), flush=True)
        signal.sigwait(sigs)
        os._exit(0)

    if args.restore:
        names = serving.restore()
        print(json.dumps({"restored": names, "pid": os.getpid()}), flush=True)
        if args.watch:
            while signal.sigtimedwait(sigs, args.watch) is None:
                serving.reconcile()  # honor stop()s issued elsewhere
                serving.restore()
        else:
            signal.sigwait(sigs)
    else:
        cfg = serving._host_here(args.name, dedicated=True)
        print(json.dumps({"name": args.name, "port": cfg["port"], "pid": os.getpid()}), flush=True)
        signal.sigwait(sigs)
    # Exit decisively: server/producer threads must not keep a
    # terminated host lingering (records stay Running by design — see
    # module docstring).
    os._exit(0)


if __name__ == "__main__":
    main()
