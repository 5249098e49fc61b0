"""Replica lifecycle: spawn, readiness-gate, drain, reap N serving workers.

The counterpart of ``hops_tpu/modelrepo/fleet/replicas.py``, copied with the port's imports.

The reference platform's serving tier is a FLEET of containers behind
one endpoint (PAPER.md L4: Docker/K8s model serving) — capacity is a
replica count, not a process. This module owns that count: each replica
is one ``serving._RunningServing`` of the SAME endpoint config on its
own private port, hosted either

- **out of process** (default): a detached
  ``python -m hops_tpu_torch.modelrepo.serving_host --fleet-worker <dir>``
  worker per replica — its own interpreter, its own telemetry registry
  (so the router's per-replica ``/metrics.json`` scrape sees truly
  per-replica load), surviving the manager's death; or
- **in process** (``inprocess=True``): a server thread per replica —
  the fast path for tests, benches and chaos drills (replicas share the
  process registry, so per-replica load comes from the router's own
  inflight accounting rather than the scrape).

Replica state machine: ``starting -> ready -> draining -> stopped``
(``failed`` from anywhere). ``drain()`` flips the replica's own
``/healthz`` to the 503 ``draining`` contract (serving.py) so the
router stops routing there without any side channel; ``reap()`` then
terminates it. The ``fleet.spawn`` fault point fires before every
spawn so chaos tests can fail replica creation deterministically.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import threading
import time
from pathlib import Path
from typing import Any

from hops_tpu_torch.modelrepo import serving
from hops_tpu_torch.modelrepo.fleet.spare import WorkerStarter
from hops_tpu_torch.runtime import faultinject, flight, fs
from hops_tpu_torch.runtime.httpclient import HTTPPool
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

#: Replica lifecycle states (the ``hops_tpu_fleet_replicas`` gauge is
#: labelled by these).
STATES = ("starting", "ready", "draining", "stopped", "failed")

_m_replicas = REGISTRY.gauge(
    "hops_tpu_fleet_replicas",
    "Replica count per fleet endpoint and lifecycle state",
    labels=("model", "state"),
)


class FleetSpawnError(RuntimeError):
    """A replica failed to spawn or come ready in time."""


@dataclasses.dataclass
class Replica:
    """One serving worker of the fleet (process-, thread-, or
    placement-hosted). ``host`` is where its serving port lives —
    loopback for local workers, the placing host's address for placed
    ones; the router forwards to ``host:port`` either way."""

    rid: str
    version: int | None
    state: str = "starting"
    host: str = "127.0.0.1"
    port: int | None = None
    proc: subprocess.Popen | None = None
    server: Any = None  # in-process serving._RunningServing
    unit: Any = None  # placement.PlacedUnit for placed replicas
    spawned_at: float = 0.0

    @property
    def pid(self) -> int | None:
        if self.proc is not None:
            return self.proc.pid
        return self.unit.pid if self.unit is not None else None


class ReplicaManager:
    """Spawns and reaps the serving workers behind one fleet endpoint.

    ``name`` must be an existing ``serving.create_or_update`` endpoint
    definition; every replica hosts that config (optionally pinned to a
    different ``version`` — the rollout path). Thread-safe: the router,
    the autoscaler and a rollout all mutate the same fleet.
    """

    def __init__(self, name: str, *, inprocess: bool = False,
                 spawn_timeout_s: float = 60.0, placement: Any = None):
        reg = serving._load_registry()
        if name not in reg:
            raise KeyError(f"serving {name!r} not found — create_or_update first")
        if placement is not None and inprocess:
            raise ValueError("placement= and inprocess=True are exclusive: "
                             "a placed replica lives on its host's agent")
        self.name = name
        self.inprocess = inprocess
        #: A ``jobs.placement.PlacementClient``: replicas spawn on the
        #: registry's hosts via their hostd agents instead of local
        #: ``Popen`` — the autoscaler and rollouts ride through
        #: unchanged, they only ever call spawn/drain/reap here.
        self.placement = placement
        self.spawn_timeout_s = spawn_timeout_s
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}  # guarded by: self._lock
        self._counter = 0  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock
        #: Units whose slot was re-placed while their host was
        #: unreachable (generation already bumped): kept so the
        #: reconcile sweep can reap the zombie once the partition
        #: heals instead of leaking the worker forever.
        self._superseded: list[Any] = []  # guarded by: self._lock
        # Probes and drains go through a pool rather than raw urllib so
        # the transport.send fault seam covers them: a partitioned host
        # must look unreachable to the liveness sweep, not just to the
        # router's forwards.
        self._probe_pool = HTTPPool(max_idle_per_host=2, identity="fleet")
        #: Process workers start warm from a spare that has imported
        #: torch already (:mod:`~hops_tpu_torch.modelrepo.fleet.spare`).
        self.starter = WorkerStarter()
        self._publish_states()

    # -- bookkeeping ----------------------------------------------------------

    def _publish_states(self) -> None:
        with self._lock:
            reps = list(self._replicas.values())
        for state in STATES:
            _m_replicas.set(
                sum(1 for r in reps if r.state == state),
                model=self.name, state=state,
            )

    def replicas(self) -> list[Replica]:
        """Snapshot of all live (non-stopped) replicas."""
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.state not in ("stopped", "failed")]

    def _forget(self, rid: str) -> None:
        """Drop a dead replica's record. Every rollout and autoscale
        churn mints a fresh rid, so retaining stopped/failed entries
        (each holding a Popen) grows ``_replicas`` — and every
        ``_publish_states`` pass over it — for the manager's lifetime;
        the router prunes its per-rid views for the same reason."""
        with self._lock:
            self._replicas.pop(rid, None)

    def ready(self) -> list[Replica]:
        return [r for r in self.replicas() if r.state == "ready"]

    def get(self, rid: str) -> Replica | None:
        with self._lock:
            return self._replicas.get(rid)

    def _fleet_dir(self) -> Path:
        p = Path(fs.project_path("Serving")) / f"{self.name}.fleet"
        p.mkdir(parents=True, exist_ok=True)
        return p

    def _replica_cfg(self, version: int | None) -> dict[str, Any]:
        """The serving config a replica hosts: the endpoint's current
        definition, re-resolved to ``version``'s artifact when pinned
        (the rollout path — old and new replicas differ only here)."""
        cfg = dict(serving._load_registry()[self.name])
        cfg.pop("port", None)
        cfg.pop("pid", None)
        if version is not None and version != cfg.get("model_version"):
            from hops_tpu_torch.modelrepo import registry

            # The model registry is keyed by MODEL name, which differs
            # from the endpoint name whenever the definition was
            # created with model_name=. Pre-model_name records fall
            # back to the endpoint name (they could only have been
            # created with name == model_name).
            meta = registry.get_model(
                cfg.get("model_name") or self.name, version)
            cfg["artifact_path"] = meta["path"]
            cfg["model_version"] = meta["version"]
        return cfg

    # -- spawn ----------------------------------------------------------------

    def spawn(self, version: int | None = None, *,
              wait_ready: bool = True) -> Replica:
        """Spawn one replica (pinned to ``version`` when given) and —
        by default — gate on its ``/healthz`` answering ready. Raises
        :class:`FleetSpawnError` on spawn or readiness failure; the
        caller's retry policy owns recovery (``fleet.spawn`` faults
        land here)."""
        with self._lock:
            if self._closed:
                raise FleetSpawnError(
                    f"fleet {self.name!r} manager is stopped")
            rid = f"r{self._counter}"
            self._counter += 1
            rep = Replica(rid=rid, version=version, spawned_at=time.monotonic())
            self._replicas[rid] = rep
        try:
            faultinject.fire("fleet.spawn")  # chaos point
            cfg = self._replica_cfg(version)
            rep.version = cfg.get("model_version")
            if self.placement is not None:
                self._spawn_placed(rep, cfg)
            elif self.inprocess:
                rep.server = serving._RunningServing(cfg)
                rep.port = rep.server.port
            else:
                self._spawn_process(rep, cfg)
            if wait_ready:
                # Via the local rep, not the rid: a stop() racing this
                # spawn may already have swept the rid out of the book.
                self._wait_ready(rep)
            else:
                rep.state = "ready" if self.inprocess else rep.state
        except Exception as e:
            self._teardown(rep)
            rep.state = "failed"
            self._forget(rid)
            self._publish_states()
            if not isinstance(e, FleetSpawnError):
                raise FleetSpawnError(
                    f"replica {rid} of {self.name!r} failed to spawn: "
                    f"{type(e).__name__}: {e}"
                ) from e
            raise
        with self._lock:
            closed = self._closed
        if closed:
            # stop() ran while this spawn was in flight (e.g. a blocked
            # autoscaler tick): its reap sweep may have missed a worker
            # process that only just announced. Tear the LOCAL rep down
            # (not reap-by-rid: the sweep may have already reaped and
            # forgotten this rid before the Popen existed, so the book
            # lookup would no-op and leak the worker) so nothing
            # outlives the fleet.
            self._teardown(rep)
            rep.state = "stopped"
            self._forget(rid)
            self._publish_states()
            raise FleetSpawnError(
                f"fleet {self.name!r} manager stopped during spawn of {rid}")
        self._publish_states()
        log.info("fleet %s: replica %s up on port %s (version %s)",
                 self.name, rep.rid, rep.port, rep.version)
        return rep

    def _spawn_process(self, rep: Replica, cfg: dict[str, Any]) -> None:
        rdir = self._fleet_dir() / rep.rid
        rdir.mkdir(parents=True, exist_ok=True)
        (rdir / "state.json").unlink(missing_ok=True)
        (rdir / "cfg.json").write_text(json.dumps(cfg, indent=2, default=str))
        from hops_tpu_torch.jobs.api import _child_pythonpath

        env = dict(os.environ)
        env["HOPS_TPU_WORKSPACE"] = str(fs.workspace_root())
        env["HOPS_TPU_PROJECT"] = fs.project_name()
        env["PYTHONPATH"] = _child_pythonpath(env.get("PYTHONPATH"))
        rep.proc = self.starter.start(["--fleet-worker", str(rdir)], env,
                                       rdir / "worker.log", new_session=True)
        deadline = time.monotonic() + self.spawn_timeout_s
        state_file = rdir / "state.json"
        poll = 0.05
        while time.monotonic() < deadline:
            if state_file.exists():
                state = json.loads(state_file.read_text())
                if state.get("pid") == rep.proc.pid:
                    rep.port = state["port"]
                    return
            if rep.proc.poll() is not None:
                tail = (rdir / "worker.log").read_text()[-2000:]
                raise FleetSpawnError(
                    f"replica {rep.rid} worker exited rc={rep.proc.returncode}; "
                    f"log tail:\n{tail}"
                )
            time.sleep(poll)
        rep.proc.kill()
        raise FleetSpawnError(
            f"replica {rep.rid} of {self.name!r} did not announce a port "
            f"within {self.spawn_timeout_s}s"
        )

    def _spawn_placed(self, rep: Replica, cfg: dict[str, Any]) -> None:
        """Place the replica on some registry host via its hostd agent
        (the client picks the least-placed healthy host and retries on
        survivors when one dies — ``placement.rpc`` faults land
        there). The worker is the same ``serving_host --fleet-worker``
        process; only who spawned it changes."""
        unit = self.placement.spawn(
            "replica", cfg, slot=f"{self.name}/{rep.rid}")
        rep.unit = unit
        rep.host = unit.address
        rep.port = unit.port

    def wait_ready(self, rid: str, timeout_s: float | None = None) -> Replica:
        """Block until the replica's ``/healthz`` answers 200, then mark
        it ``ready``. Raises :class:`FleetSpawnError` on timeout."""
        rep = self.get(rid)
        if rep is None:
            raise KeyError(f"replica {rid!r} not found")
        return self._wait_ready(rep, timeout_s)

    def _wait_ready(self, rep: Replica,
                    timeout_s: float | None = None) -> Replica:
        budget = timeout_s if timeout_s is not None else self.spawn_timeout_s
        deadline = time.monotonic() + budget
        poll = 0.02
        while time.monotonic() < deadline:
            if self._probe(rep)[0] == "ok":
                rep.state = "ready"
                flight.record("replica_state", model=self.name,
                              rid=rep.rid, state="ready")
                self._publish_states()
                return rep
            if rep.proc is not None and rep.proc.poll() is not None:
                break
            time.sleep(poll)
        # A failed replica may still have a LIVE worker (announced its
        # port but never answered ready): tear it down now — stop()'s
        # sweep skips "failed", so nothing else ever would.
        self._teardown(rep)
        rep.state = "failed"
        flight.record("replica_state", model=self.name,
                      rid=rep.rid, state="failed")
        self._forget(rep.rid)
        self._publish_states()
        raise FleetSpawnError(
            f"replica {rep.rid} of {self.name!r} never became ready "
            f"(port {rep.port})"
        )

    # -- health / drain / reap ------------------------------------------------

    def healthz(self, rid: str) -> str:
        """``ok`` | ``draining`` | ``unready`` | ``unreachable`` — the
        replica's own readiness answer (one probe, bounded)."""
        return self._healthz_body(rid)[0]

    def inflight(self, rid: str) -> int | None:
        """The replica's in-flight request count (None when it cannot
        be read — unreachable, or not draining and not in-process)."""
        rep = self.get(rid)
        if rep is None:
            return None
        if rep.server is not None:
            return rep.server.inflight
        return self._healthz_body(rid)[1].get("inflight")

    def _healthz_body(self, rid: str) -> tuple[str, dict[str, Any]]:
        return self._probe(self.get(rid))

    def _probe(self, rep: Replica | None) -> tuple[str, dict[str, Any]]:
        if rep is None or rep.port is None:
            return "unreachable", {}
        try:
            code, data, _ = self._probe_pool.request(
                "GET", f"http://{rep.host}:{rep.port}/healthz",
                timeout_s=2.0)
        except OSError:
            return "unreachable", {}
        try:
            body = json.loads(data)
        except Exception:  # graftlint: disable=swallowed-exception
            body = {}  # by contract: a probe never raises past here
        if code == 200:
            return "ok", body
        return body.get("status", "unready"), body

    def drain(self, rid: str) -> None:
        """Flip the replica into the draining state: it stops admitting
        (503 + ``Retry-After``) and its ``/healthz`` reports
        ``draining`` with the live in-flight count. A replica that died
        before (or while) being told is already as drained as it will
        ever get — tolerated, like :meth:`drained`'s ``unreachable``
        case, so a chaos kill racing a rollout's shift cannot crash the
        rollout. Same for a rid already reaped out of the book (an
        autoscaler scale-down racing a rollout that snapshotted it):
        a dead replica must never be flipped back into the live set."""
        rep = self.get(rid)
        if rep is None:
            log.warning("fleet %s: drain of unknown replica %s (already "
                        "reaped?); ignoring", self.name, rid)
            return
        if rep.state in ("stopped", "failed"):
            return  # already dead — as drained as it will ever get
        if rep.server is not None:
            rep.server.drain()
        elif rep.port is not None:
            # Placed replicas drain by the SAME direct POST (the drain
            # is the replica's own admission flip, not a host-lifecycle
            # action) — the hostd only owns spawn/reap/kill.
            try:
                self._probe_pool.request(
                    "POST", f"http://{rep.host}:{rep.port}/admin/drain",
                    b"{}", {"Content-Type": "application/json"},
                    timeout_s=2.0)
            except OSError:
                log.warning("fleet %s: replica %s unreachable for drain "
                            "(already dead?); treating as draining",
                            self.name, rid)
        rep.state = "draining"
        flight.record("replica_state", model=self.name,
                      rid=rep.rid, state="draining")
        self._publish_states()

    def drained(self, rid: str) -> bool:
        """Has a draining replica finished its in-flight work?"""
        rep = self.get(rid)
        if rep is None:
            return True
        if rep.server is not None:
            return rep.server.inflight == 0
        status, body = self._healthz_body(rid)
        if status == "unreachable":
            return True  # already gone
        return status == "draining" and body.get("inflight", 1) == 0

    def _teardown(self, rep: Replica, *, grace_s: float = 5.0) -> None:
        """Terminate a replica's worker (SIGTERM, SIGKILL after
        ``grace_s`` for process workers; server stop for in-process
        ones). Idempotent; does not touch the state machine."""
        if rep.server is not None:
            rep.server.stop()
            rep.server = None
        if rep.unit is not None:
            try:
                self.placement.reap(rep.unit)
            except Exception as e:  # noqa: BLE001 — a dead/partitioned host's
                # units are already gone; reap must stay idempotent
                log.warning("fleet %s: placed replica %s reap via %s failed "
                            "(host dead?): %s", self.name, rep.rid,
                            rep.unit.host.name, e)
            rep.unit = None
        if rep.proc is not None and rep.proc.poll() is None:
            rep.proc.terminate()
            try:
                rep.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait(timeout=grace_s)

    def reap(self, rid: str, *, grace_s: float = 5.0) -> None:
        """Terminate a replica and mark it stopped. Idempotent."""
        rep = self.get(rid)
        if rep is None:
            return
        self._teardown(rep, grace_s=grace_s)
        rep.state = "stopped"
        flight.record("replica_state", model=self.name,
                      rid=rid, state="stopped", how="reap")
        self._forget(rid)
        self._publish_states()
        log.info("fleet %s: replica %s reaped", self.name, rid)

    def kill(self, rid: str) -> None:
        """Chaos verb: kill a replica WITHOUT drain (SIGKILL / abrupt
        server stop) — the failure the router must route around."""
        rep = self.get(rid)
        if rep is None:
            return
        if rep.proc is not None and rep.proc.poll() is None:
            os.kill(rep.proc.pid, signal.SIGKILL)
            rep.proc.wait(timeout=10)
        if rep.unit is not None:
            try:
                self.placement.kill(rep.unit)
            except Exception as e:  # noqa: BLE001 — chaos may have taken the
                # whole host with it; the unit is dead either way
                log.warning("fleet %s: placed replica %s kill via %s failed "
                            "(host dead?): %s", self.name, rep.rid,
                            rep.unit.host.name, e)
            rep.unit = None
        if rep.server is not None:
            rep.server.stop()
            rep.server = None
        rep.state = "stopped"
        flight.record("replica_state", model=self.name,
                      rid=rid, state="stopped", how="kill")
        self._forget(rid)
        self._publish_states()
        log.warning("fleet %s: replica %s KILLED (chaos)", self.name, rid)

    def reconcile(self) -> list[str]:
        """Placed-fleet liveness sweep: a replica whose HOST died takes
        no SIGCHLD here — nothing local notices. Probe each placed
        ready/starting replica; the unreachable ones are marked failed
        and forgotten, so the replica count drops and the autoscaler's
        next tick re-places them on the surviving hosts. Local fleets
        (no placement client) are a no-op. Returns the failed rids.

        Fencing: "unreachable" may mean dead — or PARTITIONED, still
        serving on the far side of a network cut. Before forgetting the
        unit its slot's generation is bumped, so every router forward
        from then on stamps a token the old worker cannot match: if the
        host heals, the zombie answers 410 instead of serving stale
        results under a retired identity. The unit itself is stashed so
        the sweep can reap it once the cut heals (see
        :meth:`_reap_superseded`)."""
        if self.placement is None:
            return []
        self._reap_superseded()
        failed: list[str] = []
        for rep in self.replicas():
            if rep.unit is None or rep.state not in ("starting", "ready"):
                continue
            if self._probe(rep)[0] != "unreachable":
                continue
            unit = rep.unit
            if getattr(unit, "slot", None):
                self.placement.bump_generation(unit.slot)
                with self._lock:
                    self._superseded.append(unit)
            rep.state = "failed"
            rep.unit = None  # fenced above; the zombie sweep owns the reap
            flight.record("replica_state", model=self.name,
                          rid=rep.rid, state="failed", how="reconcile")
            self._forget(rep.rid)
            failed.append(rep.rid)
            log.warning("fleet %s: placed replica %s on %s:%s unreachable — "
                        "marked failed for re-placement", self.name, rep.rid,
                        rep.host, rep.port)
        if failed:
            self._publish_states()
        return failed

    def _reap_superseded(self) -> None:
        """Reap zombies: units whose slot was re-placed while their host
        was unreachable. A reap that still cannot get through (cut not
        healed, or the hostd's breaker is open) keeps the unit queued
        for the next sweep; a reap that lands — or a host that was
        truly dead, where the hostd answers "already stopped" — drops
        it. Bounded: each sweep tries each zombie once."""
        with self._lock:
            pending = list(self._superseded)
        for unit in pending:
            try:
                self.placement.reap(unit)
            except Exception as e:  # noqa: BLE001 — partition still up or
                # breaker open; keep the zombie queued for the next sweep
                log.info("fleet %s: zombie %s on %s not reapable yet: %s",
                         self.name, unit.uid, unit.host.name, e)
                continue
            with self._lock:
                if unit in self._superseded:
                    self._superseded.remove(unit)
            flight.record("replica_state", model=self.name,
                          rid=unit.uid, state="stopped", how="zombie_reap")
            log.info("fleet %s: zombie %s on %s reaped after heal",
                     self.name, unit.uid, unit.host.name)

    def commit_version(self, version: int | None) -> None:
        """Persist a completed rollout's version into the serving
        definition, so every FUTURE spawn — an autoscaler heal, a
        restart — hosts the rolled-out version instead of silently
        resurrecting the old one. No-op for ``version=None`` (a roll
        onto the current definition changes nothing)."""
        if version is None:
            return
        from hops_tpu_torch.modelrepo import registry

        with serving._registry_lock():
            reg = serving._load_registry()
            cfg = reg.get(self.name)
            if cfg is None:
                return
            meta = registry.get_model(
                cfg.get("model_name") or self.name, version)
            cfg["artifact_path"] = meta["path"]
            cfg["model_version"] = meta["version"]
            serving._save_registry(reg)

    def stop(self) -> None:
        """Reap every replica (fleet shutdown). Closes the manager:
        later ``spawn()`` calls — and spawns already in flight on other
        threads — fail with :class:`FleetSpawnError` and reap their own
        worker, so no replica process outlives the fleet."""
        with self._lock:
            self._closed = True
        for rep in self.replicas():
            self.reap(rep.rid)
        if self.placement is not None:
            self._reap_superseded()
        self.starter.close()
        self._probe_pool.close()
