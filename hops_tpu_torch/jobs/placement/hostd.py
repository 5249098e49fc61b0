"""hostd — the per-host placement agent.

The counterpart of ``hops_tpu/jobs/placement/hostd.py``, copied with the port's imports.

One hostd runs on every machine the platform may place work on. It is
the only thing the :class:`~hops_tpu_torch.jobs.placement.client.
PlacementClient` talks to: an event-loop HTTP daemon (one
:class:`~hops_tpu_torch.runtime.httpserver.HTTPServer`) that spawns, drains,
reaps and health-checks the UNITS on its host —

- ``replica`` units: one ``serving._RunningServing`` each, hosted
  either as a detached ``serving_host --fleet-worker`` process (the
  production shape — same worker, same ``cfg.json``/``state.json``
  announce protocol the local ``ReplicaManager`` used) or as an
  in-process server thread (``inprocess_units=True`` — the fast tier
  for tests and benches, since a process replica pays torch startup);
- ``shard`` units: one :class:`~hops_tpu_torch.jobs.placement.shardd.
  ShardServer` each (process or thread) — no model stack, so the
  process shape starts faster than a replica.

Verbs (JSON in, JSON out; unit states mirror the fleet's
``starting -> ready -> draining -> stopped`` machine)::

    GET  /healthz                   {"status": "ok", "host", "units"}
    GET  /units                     {"units": [ {uid, kind, port, pid,
                                                 state}, ... ]}
    POST /units/spawn               {"kind": "replica"|"shard",
                                     "cfg": {...}}  -> unit record
    POST /units/<uid>/drain         replica: forwards /admin/drain
    POST /units/<uid>/reap          graceful stop (SIGTERM, then KILL)
    POST /units/<uid>/kill          chaos verb: SIGKILL, no drain

Process units are spawned in the hostd's OWN process group (no
``start_new_session``): when the host dies — in the chaos drill,
``SIGKILL`` to the group — its units die with it, exactly like a real
machine failure takes everything on the machine.

Join-via-announce: given ``announce_dir``, the hostd heartbeats its
:class:`~hops_tpu_torch.jobs.placement.registry.Host` record every
``heartbeat_s`` so registries list it while it lives and age it out
when it stops.

Each heartbeat announce renews a :class:`~hops_tpu_torch.jobs.placement.
lease.Lease` (TTL ``lease_ttl_s``, default ``3 × heartbeat_s``). When
renewals keep failing past the TTL — the host is partitioned from the
registry — the hostd honors the suicide pact: :meth:`Hostd.self_fence`
drains and kills every unit it runs, so a cut-off host can never keep
serving a placement the survivors have re-placed. The agent itself
stays up and keeps trying to renew; after the partition heals it
rejoins empty. Announces pass the ``transport.send`` fault point
(destination ``registry``), and the hostd registers its agent port and
every unit port under its host name via ``faultinject.name_endpoint``
— one ``cut("h1")`` severs the whole host, agent and units alike.

See docs/operations.md "Multi-host placement" and "Partition
tolerance & fencing".
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from typing import Any

from hops_tpu_torch.jobs.placement.lease import Lease
from hops_tpu_torch.jobs.placement.registry import Host, HostRegistry
from hops_tpu_torch.modelrepo.fleet.spare import WorkerStarter
from hops_tpu_torch.runtime import faultinject, flight
from hops_tpu_torch.runtime.httpserver import HTTPServer
from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)

UNIT_KINDS = ("replica", "shard")


class _Unit:
    """One placed worker on this host."""

    def __init__(self, uid: str, kind: str, *, slot: str | None = None,
                 generation: int = 0):
        self.uid = uid
        self.kind = kind
        self.state = "starting"
        self.port: int | None = None
        self.proc: subprocess.Popen | None = None
        self.server: Any = None  # in-process _RunningServing / ShardServer
        self.dir: Path | None = None
        # Placement identity (minted by PlacementClient, carried in
        # cfg): which slot this unit fills and at which generation —
        # the fence/audit trail's ground truth.
        self.slot = slot
        self.generation = generation

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def record(self) -> dict[str, Any]:
        return {"uid": self.uid, "kind": self.kind, "state": self.state,
                "port": self.port, "pid": self.pid, "slot": self.slot,
                "generation": self.generation}


class Hostd:
    """The agent (see module docs). ``port=0`` binds an ephemeral port;
    ``unit_root`` is where process units keep their ``cfg.json`` /
    ``state.json`` / logs (a temp dir per test, a data dir in prod)."""

    def __init__(
        self,
        name: str,
        *,
        port: int = 0,
        bind: str = "127.0.0.1",
        inprocess_units: bool = False,
        unit_root: str | Path | None = None,
        announce_dir: str | Path | None = None,
        heartbeat_s: float = 3.0,
        lease_ttl_s: float | None = None,
        spawn_timeout_s: float = 60.0,
    ):
        self.name = name
        self.inprocess_units = inprocess_units
        self.spawn_timeout_s = spawn_timeout_s
        self._unit_root = Path(unit_root) if unit_root else None
        self._lock = threading.Lock()
        self._units: dict[str, _Unit] = {}  # guarded by: self._lock
        self._counter = 0  # guarded by: self._lock
        #: Replica units start warm from a spare that has imported torch
        #: already (:mod:`~hops_tpu_torch.modelrepo.fleet.spare`).
        self.starter = WorkerStarter()
        self._server = _make_server(self, bind, port)
        self.port = self._server.port
        self.address = bind
        faultinject.name_endpoint(f"{bind}:{self.port}", name)
        self._announce_dir = Path(announce_dir) if announce_dir else None
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self.lease: Lease | None = None
        if self._announce_dir is not None:
            # Construction is the first renewal: announce before the
            # heartbeat thread exists, lease granted from "now".
            HostRegistry.announce(self._announce_dir, self.host())
            self.lease = Lease(
                name,
                lease_ttl_s if lease_ttl_s is not None else 3.0 * heartbeat_s)
            self._hb_thread = threading.Thread(
                target=self._heartbeat, args=(heartbeat_s,),
                name=f"hostd-{name}-hb", daemon=True)
            self._hb_thread.start()
        log.info("hostd %s up on %s:%d (units=%s)", name, bind, self.port,
                 "inprocess" if inprocess_units else "process")

    def host(self) -> Host:
        return Host(self.name, self.address, self.port)

    def _heartbeat(self, interval_s: float) -> None:
        while not self._hb_stop.wait(interval_s):
            self._renew_lease()

    def _renew_lease(self) -> None:
        """One heartbeat: announce (= renew), or fence once the lease
        has run out. The announce passes the ``transport.send`` fault
        point as this host → ``registry``, so a partition cut on this
        host's egress starves the lease exactly like a real cut."""
        try:
            faultinject.fire_transport(self.name, "registry")
            HostRegistry.announce(self._announce_dir, self.host())
        except OSError as e:
            self.lease.renewal_failed()
            log.warning(
                "hostd %s: lease renewal failed (%s: %s); %.1fs of lease left",
                self.name, type(e).__name__, e,
                max(self.lease.remaining_s(), 0.0))
        else:
            self.lease.renew()
        if self.lease.expired() and self.lease.mark_fenced():
            self.self_fence(
                f"lease expired: no successful renewal in "
                f"{self.lease.ttl_s:.1f}s")

    def self_fence(self, reason: str) -> None:
        """The suicide-pact half of the lease contract: this host has
        been unable to renew for a full TTL, so the registry (and
        everything placing against it) has already given it up and may
        be re-placing its units on survivors. Drain and kill every
        unit NOW — a partitioned host must never keep serving. The
        agent stays up; after the partition heals the next successful
        renewal rejoins the (now empty) host."""
        units = self.units()
        flight.record("fence", host=self.name, reason=reason,
                      units=[u.record() for u in units])
        log.error("hostd %s: SELF-FENCE (%s) — draining and killing %d "
                  "unit(s)", self.name, reason, len(units))
        for unit in units:
            try:
                self.drain(unit.uid)
            except Exception as e:  # noqa: BLE001 — best-effort drain;
                # the reap below is the guarantee
                log.warning("hostd %s: fence drain of %s failed: %s",
                            self.name, unit.uid, e)
            try:
                self.reap(unit.uid)
            except Exception as e:  # noqa: BLE001 — keep fencing the rest
                log.warning("hostd %s: fence reap of %s failed: %s",
                            self.name, unit.uid, e)

    # -- unit bookkeeping -----------------------------------------------------

    def units(self) -> list[_Unit]:
        with self._lock:
            return list(self._units.values())

    def _get(self, uid: str) -> _Unit | None:
        with self._lock:
            return self._units.get(uid)

    def _unit_dir(self, unit: _Unit) -> Path:
        root = self._unit_root
        if root is None:
            from hops_tpu_torch.runtime import fs

            root = Path(fs.project_path("Serving")) / f"{self.name}.hostd"
        d = root / unit.uid
        d.mkdir(parents=True, exist_ok=True)
        return d

    # -- spawn ----------------------------------------------------------------

    def spawn(self, kind: str, cfg: dict[str, Any]) -> dict[str, Any]:
        if kind not in UNIT_KINDS:
            raise ValueError(f"unknown unit kind {kind!r} (expect one of "
                             f"{UNIT_KINDS})")
        with self._lock:
            uid = f"u{self._counter}"
            self._counter += 1
            unit = _Unit(uid, kind, slot=cfg.get("slot"),
                         generation=int(cfg.get("generation", 0)))
            self._units[uid] = unit
        try:
            if self.inprocess_units:
                self._spawn_inprocess(unit, cfg)
            else:
                self._spawn_process(unit, cfg)
            unit.state = "ready" if kind == "shard" else unit.state
            if kind == "replica":
                # The worker announced its port; readiness (the
                # /healthz gate) is the ReplicaManager's job — it owns
                # the replica state machine end to end.
                unit.state = "ready"
        except Exception:
            self._teardown(unit)
            unit.state = "failed"
            with self._lock:
                self._units.pop(unit.uid, None)
            raise
        if unit.port is not None:
            # Partition keying: the unit belongs to this host, so a
            # cut of the host name black-holes its data plane too.
            faultinject.name_endpoint(f"{self.address}:{unit.port}", self.name)
        log.info("hostd %s: unit %s (%s) up on port %s", self.name, uid,
                 kind, unit.port)
        return unit.record()

    def _spawn_inprocess(self, unit: _Unit, cfg: dict[str, Any]) -> None:
        if unit.kind == "shard":
            from hops_tpu_torch.jobs.placement.shardd import ShardServer

            unit.server = ShardServer(cfg)
        else:
            # Lazy: importing serving pulls the model stack — a shard-only hostd
            # (or the shardd CLI) must never pay that.
            from hops_tpu_torch.modelrepo import serving

            unit.server = serving._RunningServing(cfg)
        unit.port = unit.server.port

    def _spawn_process(self, unit: _Unit, cfg: dict[str, Any]) -> None:
        udir = self._unit_dir(unit)
        unit.dir = udir
        (udir / "state.json").unlink(missing_ok=True)
        (udir / "cfg.json").write_text(json.dumps(cfg, indent=2, default=str))
        from hops_tpu_torch.jobs.api import _child_pythonpath
        from hops_tpu_torch.runtime import fs

        env = dict(os.environ)
        env["HOPS_TPU_WORKSPACE"] = str(fs.workspace_root())
        env["HOPS_TPU_PROJECT"] = fs.project_name()
        env["PYTHONPATH"] = _child_pythonpath(env.get("PYTHONPATH"))
        mod = ("hops_tpu_torch.modelrepo.serving_host" if unit.kind == "replica"
               else "hops_tpu_torch.jobs.placement.shardd")
        argv = [sys.executable, "-m", mod]
        argv += (["--fleet-worker", str(udir)] if unit.kind == "replica"
                 else [str(udir)])
        # SAME process group as the hostd (no new session): a dead host
        # takes its units with it — the machine-failure semantics the
        # chaos drill SIGKILLs for. Replicas start warm from a spare.
        if unit.kind == "replica":
            unit.proc = self.starter.start(argv[3:], env, udir / "worker.log",
                                            new_session=False)
        else:
            with open(udir / "worker.log", "a") as logfile:
                unit.proc = subprocess.Popen(
                    argv, stdout=logfile, stderr=subprocess.STDOUT, env=env)
        deadline = time.monotonic() + self.spawn_timeout_s
        state_file = udir / "state.json"
        while time.monotonic() < deadline:
            if state_file.exists():
                state = json.loads(state_file.read_text())
                if state.get("pid") == unit.proc.pid:
                    unit.port = state["port"]
                    return
            if unit.proc.poll() is not None:
                tail = (udir / "worker.log").read_text()[-2000:]
                raise RuntimeError(
                    f"unit {unit.uid} worker exited "
                    f"rc={unit.proc.returncode}; log tail:\n{tail}")
            time.sleep(0.05)
        unit.proc.kill()
        raise RuntimeError(
            f"unit {unit.uid} did not announce a port within "
            f"{self.spawn_timeout_s}s")

    # -- drain / reap / kill --------------------------------------------------

    def drain(self, uid: str) -> dict[str, Any]:
        unit = self._get(uid)
        if unit is None:
            raise KeyError(uid)
        if unit.kind == "replica" and unit.port is not None:
            if unit.server is not None:
                unit.server.drain()
            else:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{unit.port}/admin/drain", data=b"{}",
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=2.0):
                        pass
                except OSError:
                    log.warning("hostd %s: unit %s unreachable for drain "
                                "(already dead?)", self.name, uid)
        unit.state = "draining"
        return unit.record()

    def _teardown(self, unit: _Unit, *, grace_s: float = 5.0) -> None:
        if unit.server is not None:
            unit.server.stop()
            unit.server = None
        if unit.proc is not None and unit.proc.poll() is None:
            unit.proc.terminate()
            try:
                unit.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                unit.proc.kill()
                unit.proc.wait(timeout=grace_s)

    def reap(self, uid: str) -> dict[str, Any]:
        unit = self._get(uid)
        if unit is None:
            return {"uid": uid, "state": "stopped"}
        self._teardown(unit)
        unit.state = "stopped"
        with self._lock:
            self._units.pop(uid, None)
        log.info("hostd %s: unit %s reaped", self.name, uid)
        return unit.record()

    def kill(self, uid: str) -> dict[str, Any]:
        """Chaos verb: SIGKILL / abrupt stop, no drain."""
        unit = self._get(uid)
        if unit is None:
            return {"uid": uid, "state": "stopped"}
        if unit.proc is not None and unit.proc.poll() is None:
            os.kill(unit.proc.pid, signal.SIGKILL)
            unit.proc.wait(timeout=10)
        if unit.server is not None:
            unit.server.stop()
            unit.server = None
        unit.state = "stopped"
        with self._lock:
            self._units.pop(uid, None)
        log.warning("hostd %s: unit %s KILLED (chaos)", self.name, uid)
        return unit.record()

    # -- verb dispatch (the HTTP surface) -------------------------------------

    def handle(self, method: str, path: str, body: dict) -> tuple[int, dict]:
        if method == "GET" and path == "/healthz":
            return 200, {"status": "ok", "host": self.name,
                         "units": len(self.units()),
                         "fenced": bool(self.lease is not None
                                        and self.lease.fenced)}
        if method == "GET" and path == "/units":
            return 200, {"units": [u.record() for u in self.units()]}
        if method == "POST" and path == "/units/spawn":
            try:
                return 200, self.spawn(body["kind"], body["cfg"])
            except ValueError as e:
                return 400, {"error": str(e)}
            except Exception as e:  # noqa: BLE001 — spawn failure is the
                # client's retry-on-next-host signal, not a daemon crash
                return 500, {"error": f"{type(e).__name__}: {e}"}
        if method == "POST" and path.startswith("/units/"):
            parts = path.strip("/").split("/")
            if len(parts) == 3 and parts[2] in ("drain", "reap", "kill"):
                uid, verb = parts[1], parts[2]
                try:
                    return 200, getattr(self, verb)(uid)
                except KeyError:
                    return 404, {"error": f"no such unit: {uid}"}
        return 404, {"error": f"no such verb: {method} {path}"}

    # -- lifecycle ------------------------------------------------------------

    def stop(self) -> None:
        """Clean shutdown: reap every unit, retract the announce."""
        self._hb_stop.set()
        for unit in self.units():
            self.reap(unit.uid)
        self.starter.close()
        self._server.stop()
        if self._announce_dir is not None:
            HostRegistry.retract(self._announce_dir, self.name)

    def chaos_kill(self) -> None:
        """Die like a machine: the agent stops answering and every unit
        dies with it — no drains, no reaps, no announce retraction (the
        record ages out, exactly like a crashed host's would)."""
        self._hb_stop.set()
        for unit in self.units():
            if unit.proc is not None and unit.proc.poll() is None:
                os.kill(unit.proc.pid, signal.SIGKILL)
                unit.proc.wait(timeout=10)
            if unit.server is not None:
                unit.server.stop()
                unit.server = None
            unit.state = "stopped"
        self.starter.close()
        self._server.stop()
        log.warning("hostd %s: CHAOS-KILLED with %d units", self.name,
                    len(self.units()))


def _make_server(hostd: Hostd, bind: str, port: int) -> HTTPServer:
    def route(method, path, headers, body):
        try:
            # The agent-side half of the partition fault point: a
            # chaos spec keyed by this host's name stalls/errors the
            # verb INSIDE the agent, after transport succeeded.
            faultinject.fire("placement.rpc", key=hostd.name)
            payload = json.loads(body or b"{}") if method == "POST" else {}
            status, out = hostd.handle(method, path, payload)
        except Exception as e:  # noqa: BLE001 — agent stays up; the
            # error is the client's breaker food
            log.warning("hostd %s: %s %s failed: %s: %s", hostd.name,
                        method, path, type(e).__name__, e)
            status, out = 500, {"error": f"{type(e).__name__}: {e}"}
        data = json.dumps(out, default=str).encode()
        return status, {"Content-Type": "application/json"}, data

    return HTTPServer(route, bind=bind, port=port,
                      name=f"hostd-{hostd.name}", workers=8)


def main(argv: list[str] | None = None) -> None:
    """``python -m hops_tpu_torch.jobs.placement.hostd --name h0 [...]`` —
    run one agent until terminated (the ``serving_host`` process
    model: signals blocked before server threads exist, sigwait)."""
    parser = argparse.ArgumentParser(
        prog="python -m hops_tpu_torch.jobs.placement.hostd",
        description=__doc__.split("\n")[0],
    )
    parser.add_argument("--name", required=True, help="host name")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--bind", default="127.0.0.1")
    parser.add_argument("--announce", default=None,
                        help="registry announce directory (join mode)")
    parser.add_argument("--heartbeat", type=float, default=3.0,
                        help="announce/lease-renewal cadence, seconds")
    parser.add_argument("--lease-ttl", type=float, default=None,
                        help="self-fence after this long without a "
                             "successful renewal (default 3x heartbeat)")
    parser.add_argument("--unit-root", default=None)
    parser.add_argument("--inprocess-units", action="store_true")
    args = parser.parse_args(argv)

    sigs = {signal.SIGTERM, signal.SIGINT}
    signal.pthread_sigmask(signal.SIG_BLOCK, sigs)

    hostd = Hostd(
        args.name, port=args.port, bind=args.bind,
        inprocess_units=args.inprocess_units,
        unit_root=args.unit_root, announce_dir=args.announce,
        heartbeat_s=args.heartbeat, lease_ttl_s=args.lease_ttl,
    )
    print(json.dumps({"name": hostd.name, "port": hostd.port,
                      "pid": os.getpid()}), flush=True)
    signal.sigwait(sigs)
    hostd.stop()
    os._exit(0)


if __name__ == "__main__":
    main()
