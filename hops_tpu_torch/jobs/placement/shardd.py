"""shardd — one feature-store shard behind HTTP.

The counterpart of ``hops_tpu/jobs/placement/shardd.py``, copied with the port's imports.

``ShardedOnlineStore`` keys rows by ``crc32(primary key) % N`` and, in
the single-host build, opens all N ``OnlineStore`` shard files locally.
Placed mode keeps the client exactly as it is — routing, per-shard
breakers, parallel fan-out, straggler hedging — and swaps each local
shard for a remote one: an instance of this server, placed on some host
by the :mod:`~hops_tpu_torch.jobs.placement.hostd` agent.

Its import chain stops at ``featurestore.online``, which loads torch
(the JAX package's loads JAX the same way): a shard server is a lookup
daemon and imports nothing of the model stack, which is also why this
is its own process model rather than a ``serving_host`` mode.

Verbs (JSON in, JSON out by default, HTTP/1.1 keep-alive for the
pool). ``/healthz`` doubles as the codec handshake: it advertises
``"codecs"`` and a client that sees ``"packed"`` there may send
``Accept: application/x-hops-packed`` on ``/get_many`` to receive the
row batch as a packed columnar frame (``runtime/wirecodec.py``) instead
of JSON — per shard, falling back to JSON whenever the batch cannot be
packed. A ``"codecs": ["json"]`` config entry pins a shard JSON-only
(mixed fleets are a supported state, e.g. mid-rollout)::

    GET  /healthz            {"status": "ok", "store", "shard", "rows",
                              "codecs"}
    GET  /stats              {"rows": N}
    POST /get_many {"pks": [[...], ...]}        -> {"rows": [row|null, ...]}
    POST /put      {"records": [...]}           -> {"applied": N}
    POST /delete   {"records": [...]}           -> {}
    GET  /scan                                  -> {"rows": [...]}

Warm start: a ``snapshot`` path in the config names a
``ShardedOnlineStore.snapshot`` directory (PR 8's integrity-manifest
format); the server verifies THIS shard's file against the manifest
(size + SHA-256 — verify-before-trust) and loads it before serving, so
a re-placed shard starts warm instead of empty.

Config (``cfg.json`` for the CLI, a dict for in-process units)::

    {"store": "profile", "version": 1, "shard_index": 0, "shards": 4,
     "primary_key": ["uid"], "root": "/data/online", "port": 0,
     "snapshot": "/data/snaps/profile_1",        # optional
     "slot": "profile/0", "generation": 2}       # placement identity

A configured ``(slot, generation)`` arms the fencing gate: data verbs
stamped with an ``X-Hops-Generation`` token that differs from the
shard's own are refused with a typed 410 (no breaker strike client
side) — how a zombie shard healing from a partition is kept from
serving stale rows or absorbing writes after its slot was re-placed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
from pathlib import Path
from typing import Any

import pandas as pd

from hops_tpu_torch.featurestore.online import OnlineStore
from hops_tpu_torch.runtime import flight, wirecodec
from hops_tpu_torch.runtime.httpserver import HTTPServer
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_m_gen_rejected = REGISTRY.counter(
    "hops_tpu_fleet_generation_rejected_total",
    "Requests refused with a typed 410 because they stamped a "
    "generation newer than the unit's own — a superseded zombie "
    "fenced at the data plane, per unit kind",
    labels=("kind",),
)


class SnapshotCorruptError(RuntimeError):
    """A warm-start snapshot failed its manifest integrity check."""


def _file_sha256(path: Path, chunk: int = 1 << 20) -> str:
    # Local twin of runtime.checkpoint._file_sha256, kept as the JAX
    # package keeps it: that module is not in a shard server's imports.
    h = hashlib.sha256()
    with path.open("rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


class ShardServer:
    """One ``OnlineStore`` shard served over HTTP (see module docs)."""

    def __init__(self, cfg: dict[str, Any]):
        self.store_name = cfg["store"]
        self.version = int(cfg.get("version", 1))
        self.shard_index = int(cfg["shard_index"])
        self.n_shards = int(cfg.get("shards", 1))
        self.primary_key = [k.lower() for k in cfg["primary_key"]]
        self.codecs = tuple(cfg.get("codecs", ("json", "packed")))
        if "json" not in self.codecs:
            raise ValueError(
                "shardd codecs must include 'json' (the negotiation "
                f"fallback): {self.codecs!r}")
        self.label = f"{self.store_name}_{self.version}"
        # Placement identity (minted by the PlacementClient): compared
        # against the X-Hops-Generation stamp on every data verb so a
        # superseded shard — a zombie healed from a partition — refuses
        # with a typed 410 instead of serving stale rows or taking
        # writes the live generation will never see.
        self.slot = cfg.get("slot")
        self.generation = int(cfg.get("generation", 0))
        self.token = (f"{self.slot}:{self.generation}"
                      if self.slot is not None else None)
        root = Path(cfg["root"])
        root.mkdir(parents=True, exist_ok=True)
        self._store = OnlineStore(
            root / f"{self.label}.shard{self.shard_index}")
        if cfg.get("snapshot"):
            loaded = self.warm_start(cfg["snapshot"])
            log.info("shardd %s shard %d: warm-started %d rows from %s",
                     self.label, self.shard_index, loaded, cfg["snapshot"])
        self._server = _make_server(
            self, int(cfg.get("port", 0)), cfg.get("bind", "127.0.0.1"))
        self.port = self._server.port

    # -- warm start -----------------------------------------------------------

    def warm_start(self, snapshot_dir: str | Path) -> int:
        """Verify this shard's file against the snapshot manifest and
        load its rows. Raises :class:`SnapshotCorruptError` on any
        integrity mismatch — serving from a corrupt warm start is worse
        than starting cold."""
        d = Path(snapshot_dir)
        manifest = json.loads((d / "manifest.json").read_text())
        if int(manifest.get("shards", self.n_shards)) != self.n_shards:
            raise SnapshotCorruptError(
                f"snapshot {d} holds {manifest.get('shards')} shards, "
                f"server expects {self.n_shards}")
        fname = f"shard{self.shard_index}.jsonl"
        meta = manifest.get("files", {}).get(fname)
        if meta is None:
            raise SnapshotCorruptError(f"snapshot {d} has no {fname}")
        p = d / fname
        try:
            size = p.stat().st_size
        except OSError as e:
            raise SnapshotCorruptError(
                f"snapshot {d}: {fname} unreadable ({e})") from None
        if size != meta["size"]:
            raise SnapshotCorruptError(
                f"snapshot {d}: {fname} size {size} != manifest {meta['size']}")
        if _file_sha256(p) != meta["sha256"]:
            raise SnapshotCorruptError(
                f"snapshot {d}: {fname} checksum mismatch")
        with p.open() as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return self._put_rows(rows)

    # -- verb implementations -------------------------------------------------

    def _put_rows(self, rows: list[dict]) -> int:
        if not rows:
            return 0
        # Group by column signature (the ShardedOnlineStore contract):
        # one put per homogeneous slice so a mixed batch never NaN-pads
        # missing columns into stored rows.
        by_cols: dict[frozenset, list[dict]] = {}
        for rec in rows:
            by_cols.setdefault(frozenset(rec), []).append(rec)
        applied = 0
        for recs in by_cols.values():
            applied += self._store.put_dataframe(
                pd.DataFrame(recs), self.primary_key)
        return applied

    def handle(self, method: str, path: str, body: dict) -> tuple[int, dict]:
        if method == "GET" and path == "/healthz":
            return 200, {"status": "ok", "store": self.label,
                         "shard": self.shard_index,
                         "rows": self._store.count(),
                         "codecs": list(self.codecs),
                         "slot": self.slot,
                         "generation": self.generation}
        if method == "GET" and path == "/stats":
            return 200, {"rows": self._store.count()}
        if method == "GET" and path == "/scan":
            return 200, {"rows": list(self._store.scan())}
        if method == "POST" and path == "/get_many":
            return 200, {"rows": self._store.get_many(body["pks"])}
        if method == "POST" and path == "/put":
            return 200, {"applied": self._put_rows(body["records"])}
        if method == "POST" and path == "/delete":
            if body.get("records"):
                self._store.delete_keys(
                    pd.DataFrame(body["records"]), self.primary_key)
            return 200, {}
        return 404, {"error": f"no such verb: {method} {path}"}

    def stop(self) -> None:
        self._server.stop()
        self._store.close()


def _make_server(shard: ShardServer, port: int,
                 bind: str = "127.0.0.1") -> HTTPServer:
    def route(method, path, headers, body):
        # Fencing gate on the data verbs (health/stats stay open — the
        # reconcile sweep identifies zombies through them): a stamped
        # generation newer than this shard's own token means the shard
        # has been superseded; refuse typed so the client degrades
        # without a breaker strike. See docs/operations.md "Partition
        # tolerance & fencing".
        stamped = headers.get("x-hops-generation")
        if (stamped and shard.token and stamped != shard.token
                and path.rstrip("/") not in ("/healthz", "/stats")):
            _m_gen_rejected.inc(kind="shard")
            flight.record("generation_rejected", unit_kind="shard",
                          store=shard.label, shard=shard.shard_index,
                          slot=shard.slot, have=shard.token, got=stamped)
            data = json.dumps({"error": "superseded generation",
                               "slot": shard.slot, "have": shard.token,
                               "got": stamped}).encode()
            return 410, {"Content-Type": "application/json"}, data
        try:
            payload = json.loads(body or b"{}") if method == "POST" else {}
            status, out = shard.handle(method, path, payload)
        except Exception as e:  # noqa: BLE001 — a shard fault must reach the
            # client as a 500 (breaker food), never kill the server
            log.warning("shardd %s shard %d: %s %s failed: %s: %s",
                        shard.label, shard.shard_index, method, path,
                        type(e).__name__, e)
            status, out = 500, {"error": f"{type(e).__name__}: {e}"}
        if (status == 200 and method == "POST" and path == "/get_many"
                and "packed" in shard.codecs
                and wirecodec.MEDIA_TYPE in headers.get("accept", "")):
            try:
                frame = wirecodec.encode_rows(out["rows"])
            except wirecodec.WireCodecError:
                # Un-packable batch (shouldn't happen for stored rows)
                # — negotiation falls back to JSON, client sniffs the
                # Content-Type.
                log.warning("shardd %s shard %d: get_many batch not "
                            "packable; answering JSON", shard.label,
                            shard.shard_index, exc_info=True)
            else:
                return status, {"Content-Type": wirecodec.MEDIA_TYPE}, frame
        data = json.dumps(out, default=str).encode()
        return status, {"Content-Type": "application/json"}, data

    return HTTPServer(route, bind=bind, port=port,
                      name=f"shardd-{shard.label}-{shard.shard_index}",
                      workers=8)


def main(argv: list[str] | None = None) -> None:
    """``python -m hops_tpu_torch.jobs.placement.shardd DIR`` — host the shard
    configured at ``DIR/cfg.json``, announce ``DIR/state.json``
    atomically (the hostd polls for it), then wait for termination —
    the ``serving_host --fleet-worker`` process model."""
    parser = argparse.ArgumentParser(
        prog="python -m hops_tpu_torch.jobs.placement.shardd",
        description=__doc__.split("\n")[0],
    )
    parser.add_argument("dir", help="unit directory holding cfg.json")
    args = parser.parse_args(argv)

    sigs = {signal.SIGTERM, signal.SIGINT}
    signal.pthread_sigmask(signal.SIG_BLOCK, sigs)

    udir = Path(args.dir)
    cfg = json.loads((udir / "cfg.json").read_text())
    server = ShardServer(cfg)
    state = {"store": server.label, "shard": server.shard_index,
             "port": server.port, "pid": os.getpid()}
    tmp = udir / f".state.json.tmp{os.getpid()}"
    tmp.write_text(json.dumps(state))
    os.replace(tmp, udir / "state.json")
    print(json.dumps(state), flush=True)
    signal.sigwait(sigs)
    os._exit(0)


if __name__ == "__main__":
    main()
