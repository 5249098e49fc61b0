"""Host registry: which machines the placement layer may place on.

The counterpart of ``hops_tpu/jobs/placement/registry.py``, copied with the port's imports.

Two population modes, composable:

- **Static config**: ``HostRegistry(hosts=[Host("h0", "10.0.0.4", 7070),
  ...])`` or :meth:`HostRegistry.from_config` on the same shape as
  JSON/dicts — the operator hands placement a fixed fleet.
- **Join-via-announce**: hostds started with ``--announce DIR`` write
  ``DIR/<name>.json`` atomically and re-stamp it every heartbeat;
  ``HostRegistry(announce_dir=DIR)`` lists every record whose content
  last CHANGED within ``ttl_s`` as live. A host that dies simply stops
  heartbeating and ages out — no deregistration RPC to lose.

Aging is **receiver-side, on the monotonic clock**: the registry
remembers when *it* first observed each announce's current content and
ages from that arrival time. The sender's ``ts`` stamp is display
metadata only — a hostd with a skewed wall clock (hours behind, or
stamping from the future) can neither be prematurely expired nor
immortalized, and an NTP step on the registry's own host cannot mass-
expire the fleet. This is half of the lease contract
(:mod:`~hops_tpu_torch.jobs.placement.lease` is the other half): both sides
measure the same TTL on clocks that only move forward.

The registry answers "who exists"; health ("who answers") is the
:class:`~hops_tpu_torch.jobs.placement.client.PlacementClient`'s per-host
breakers. Keeping those separate means a partitioned host stays in the
registry (it may heal) while the client routes around it.

Registry file format (one JSON object per announce file)::

    {"name": "h0", "address": "10.0.0.4", "port": 7070,
     "pid": 4242, "ts": 1754450000.0}
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterable

from hops_tpu_torch.runtime.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class Host:
    """One placement target: a machine running a hostd agent."""

    name: str
    address: str
    port: int

    @property
    def endpoint(self) -> str:
        return f"http://{self.address}:{self.port}"

    @property
    def key(self) -> str:
        return f"{self.address}:{self.port}"


class HostRegistry:
    """The set of hosts placement may use (static, announced, or both).

    Thread-safe for the read path; :meth:`add` / :meth:`remove` mutate
    the static set (tests, operator reconfiguration). Announce records
    are re-read on every :meth:`hosts` call — they are tiny files and
    the placement client only consults the registry on control-plane
    actions, never per request.
    """

    def __init__(
        self,
        hosts: Iterable[Host] = (),
        *,
        announce_dir: str | Path | None = None,
        ttl_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._static: dict[str, Host] = {h.name: h for h in hosts}
        self._announce_dir = Path(announce_dir) if announce_dir else None
        self.ttl_s = float(ttl_s)
        self._clock = clock  # injectable for clock-skew tests
        self._obs_lock = threading.Lock()
        #: announce name → (content fingerprint, arrival on self._clock).
        #: Arrival-time aging: liveness = "this file's content changed
        #: within ttl_s of OUR monotonic clock", never the sender's ts.
        self._seen: dict[str, tuple[str, float]] = {}  # guarded by: self._obs_lock

    @classmethod
    def from_config(cls, config: Iterable[dict[str, Any]] | str | Path,
                    **kwargs: Any) -> "HostRegistry":
        """Build from a list of ``{"name", "address", "port"}`` dicts or
        a JSON file holding one."""
        if isinstance(config, (str, Path)):
            config = json.loads(Path(config).read_text())
        return cls(
            [Host(c["name"], c.get("address", "127.0.0.1"), int(c["port"]))
             for c in config],
            **kwargs,
        )

    # -- membership ----------------------------------------------------------

    def add(self, host: Host) -> None:
        self._static[host.name] = host

    def remove(self, name: str) -> None:
        self._static.pop(name, None)

    def _announced(self) -> list[Host]:
        d = self._announce_dir
        if d is None or not d.is_dir():
            return []
        live: list[Host] = []
        present: set[str] = set()
        with self._obs_lock:
            now = self._clock()
            for p in sorted(d.glob("*.json")):
                try:
                    text = p.read_text()
                    rec = json.loads(text)
                    # The heartbeat re-stamps ts every announce, so the
                    # file CONTENT is the fingerprint: new content means
                    # the hostd is alive and beat recently. We age from
                    # when WE first saw that content — the sender's ts
                    # value itself is never compared against a clock.
                    prev = self._seen.get(p.name)
                    if prev is None or prev[0] != text:
                        self._seen[p.name] = (text, now)
                        arrival = now
                    else:
                        arrival = prev[1]
                    present.add(p.name)
                    if now - arrival > self.ttl_s:
                        continue  # stale: the hostd stopped heartbeating
                    live.append(
                        Host(rec["name"], rec["address"], int(rec["port"])))
                except (OSError, ValueError, KeyError, TypeError):
                    # A half-written or malformed record is skipped, not
                    # fatal: announces are atomic (write+rename) so this
                    # is only ever external corruption, and the next
                    # heartbeat repairs it.
                    log.warning("host registry: unreadable announce %s", p.name)
            # Retracted/removed announces must not pin observations: a
            # host that retracts and later re-announces the same bytes
            # would otherwise inherit its old arrival time.
            for name in list(self._seen):
                if name not in present:
                    del self._seen[name]
        return live

    def hosts(self) -> list[Host]:
        """All known hosts: static members plus live announces (an
        announce with a static member's name supersedes it — the
        announce carries the actual bound port)."""
        merged = dict(self._static)
        for h in self._announced():
            merged[h.name] = h
        return [merged[k] for k in sorted(merged)]

    def get(self, name: str) -> Host | None:
        for h in self.hosts():
            if h.name == name:
                return h
        return None

    # -- announce (written by hostd) ------------------------------------------

    @staticmethod
    def announce(announce_dir: str | Path, host: Host,
                 pid: int | None = None) -> None:
        """Atomically (re)stamp a hostd's announce record. Called by the
        hostd's heartbeat loop at a cadence well under ``ttl_s``."""
        d = Path(announce_dir)
        d.mkdir(parents=True, exist_ok=True)
        rec = {
            "name": host.name,
            "address": host.address,
            "port": host.port,
            "pid": pid if pid is not None else os.getpid(),
            "ts": time.time(),
        }
        tmp = d / f".{host.name}.json.tmp{os.getpid()}"
        tmp.write_text(json.dumps(rec))
        os.replace(tmp, d / f"{host.name}.json")

    @staticmethod
    def retract(announce_dir: str | Path, name: str) -> None:
        """Remove a hostd's announce on clean shutdown (a crash just
        ages out via ``ttl_s``)."""
        try:
            (Path(announce_dir) / f"{name}.json").unlink(missing_ok=True)
        except OSError:
            log.warning("host registry: could not retract announce for %s",
                        name)
