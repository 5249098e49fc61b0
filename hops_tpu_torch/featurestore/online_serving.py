"""Online feature serving: sharded stores, write-through, request-time joins (counterpart of
``hops_tpu/featurestore/online_serving.py``, copied with the port's imports).

The reference platform served features at request time from MySQL NDB
behind hsfs (``td.get_serving_vector`` over JDBC prepared statements,
PAPER.md L0) and kept the online values consistent with training-time
feature groups via Kafka-fed materialization jobs. This module is that
layer for the port, in three pieces:

- :class:`ShardedOnlineStore` — N :class:`~hops_tpu_torch.featurestore.online.
  OnlineStore` shards keyed by ``crc32(primary key) % N``. Point reads
  ride each backend's reader-safe path (never the writer lock), rows
  carry an event-time stamp for TTL eviction and idempotent upserts,
  and :meth:`~ShardedOnlineStore.snapshot` / :meth:`~ShardedOnlineStore.
  restore_snapshot` write/verify checkpoint-layer integrity manifests
  (sizes + SHA-256) so a serving replica can warm-start from a known-
  good snapshot instead of replaying the topic from zero.
- :class:`Materializer` — the write-through daemon: one consumer thread
  tails a ``messaging.pubsub`` topic and upserts each record's row into
  the store. At-least-once (offsets commit *after* the batch flush) with
  idempotent, event-time-guarded upserts, so replays and duplicates
  converge to the same state; the max materialized event time is the
  store's freshness watermark.
- :class:`FeatureJoinPredictor` — the serving-time join step: requests
  carry only entity IDs; the predictor batch-multi-gets across every
  configured feature group's shards, joins the rows into model-ready
  vectors (missing-key policy: ``default`` | ``reject`` |
  ``passthrough``) and hands them to the wrapped predictor. Wired into
  ``modelrepo.serving`` via ``create_or_update(..., feature_config=)``,
  upstream of the existing ``DynamicBatcher`` (coalesced entity batches
  become one multi-get).

Failure semantics: lookups run under the ``online.lookup`` fault point
with an optional deadline and a circuit breaker per shard — a dead
shard degrades to missing keys (the policy decides what that means),
it never fails the request. The daemon runs under
``online.materialize`` and outlives transient broker/store faults with
computed backoff; while it is down the freshness-lag gauge keeps rising
because lag is re-derived from the stalled watermark at every lookup.

Tail semantics (docs/operations.md "Tail latency & QoS"): multi-shard
lookups FAN OUT in parallel on the store's worker pool instead of
probing shards sequentially — one slow shard no longer eats the whole
deadline, it eats only its own keys. A shard attempt still unanswered
after the store's recent p95 lookup latency is HEDGED (a second
attempt on the same reader-safe backend races it; first result wins,
the loser is abandoned without a breaker strike — injected stalls and
page-cache hiccups lose to the hedge, a genuinely dead shard still
feeds its breaker via the deadline). Each attempt passes the
``shard.lookup`` fault point keyed by shard index, so a gray
(slow-not-dead) shard is deterministically injectable. Under brownout
(level >= DEGRADE) the feature-join layer shrinks the deadline it
passes here, converting slow-shard waits into served defaults.

Metrics (docs/operations.md "Online feature serving"):
``hops_tpu_online_lookup_seconds`` / ``hops_tpu_online_join_seconds`` /
``hops_tpu_online_request_seconds`` per-stage latency histograms,
``hops_tpu_online_lookup_total{store,result}`` hit/miss/expired/error,
``hops_tpu_online_freshness_lag_seconds``,
``hops_tpu_online_materialized_rows_total``,
``hops_tpu_online_evicted_rows_total``,
``hops_tpu_online_missing_keys_total{model,policy}``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Iterator

import pandas as pd

from hops_tpu_torch.featurestore import storage
from hops_tpu_torch.featurestore.online import OnlineStore, _key_of
from hops_tpu_torch.messaging import pubsub
from hops_tpu_torch.runtime import faultinject, qos, wirecodec
from hops_tpu_torch.runtime.checkpoint import CheckpointCorruptError, _file_sha256
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.runtime.resilience import CircuitBreaker, with_deadline
from hops_tpu_torch.telemetry import tracing
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

#: Reserved event-time column (epoch seconds) stamped onto every stored
#: row — the TTL clock and the idempotent-upsert staleness guard. Rows
#: handed back to callers have it stripped.
EVENT_TS_COL = "_hops_event_ts"

MISSING_POLICIES = ("default", "reject", "passthrough")

_m_lookup_seconds = REGISTRY.histogram(
    "hops_tpu_online_lookup_seconds",
    "Online-store point-lookup latency per shard batch",
    labels=("store",),
)
_m_lookup_total = REGISTRY.counter(
    "hops_tpu_online_lookup_total",
    "Online-store key lookups by result (hit | miss | expired | error)",
    labels=("store", "result"),
)
_m_join_seconds = REGISTRY.histogram(
    "hops_tpu_online_join_seconds",
    "Feature-join latency (all group lookups + vector assembly) per "
    "request batch",
    labels=("model",),
)
_m_request_seconds = REGISTRY.histogram(
    "hops_tpu_online_request_seconds",
    "End-to-end feature-joined predict latency (lookup + join + model)",
    labels=("model",),
)
_m_missing_keys = REGISTRY.counter(
    "hops_tpu_online_missing_keys_total",
    "Features absent from the online store at join time, by the policy "
    "that handled them",
    labels=("model", "policy"),
)
_m_freshness = REGISTRY.gauge(
    "hops_tpu_online_freshness_lag_seconds",
    "Now minus the store's last materialized event-time watermark "
    "(re-derived at every lookup, so it rises while the daemon is down)",
    labels=("store",),
)
_m_materialized = REGISTRY.counter(
    "hops_tpu_online_materialized_rows_total",
    "Rows upserted by write-through materialization, per store",
    labels=("store",),
)
_m_evicted = REGISTRY.counter(
    "hops_tpu_online_evicted_rows_total",
    "Rows deleted by a TTL eviction sweep, per store",
    labels=("store",),
)
_m_shard_hedges = REGISTRY.counter(
    "hops_tpu_online_shard_hedges_total",
    "Straggler shard lookups hedged with a second attempt, per store",
    labels=("store",),
)


def _shard_of(key: str, n: int) -> int:
    # crc32, not hash(): stable across processes and PYTHONHASHSEED, so
    # a writer daemon and a serving replica agree on every row's shard.
    return zlib.crc32(key.encode()) % n


class GenerationSupersededError(RuntimeError):
    """A shard server refused the request with a typed 410: the stamped
    ``X-Hops-Generation`` token supersedes the server's own — the
    endpoint is a ZOMBIE, a unit whose slot was re-placed while its
    host was partitioned. Deliberately not an ``OSError``: the shard is
    healthy and answering, so this must bypass the transport-failure
    breaker accounting (no strike — striking would eject the slot while
    the placement layer is already healing it) and degrade to missing
    keys only."""


class _RemoteShard:
    """Client proxy for one placed shard server (``jobs.placement.
    shardd``), shaped exactly like :class:`~hops_tpu_torch.featurestore.
    online.OnlineStore` where the sharded store touches it.

    Transport failures and non-200 answers raise ``OSError`` subclasses
    — precisely what ``multi_get``'s per-shard breaker/hedge/deadline
    machinery already catches, so placed shards inherit the local tail
    semantics without a line of change there. The one exception is a
    410, which raises :class:`GenerationSupersededError` (see its docs).

    ``generation_token`` stamps every exchange with the slot's identity
    (``X-Hops-Generation``): a static ``"slot:gen"`` string, or a
    zero-arg callable re-read per request so the stamp tracks the
    placement client's LIVE generation counter — after a re-placement
    bump, in-flight lookups immediately carry the new token and any
    zombie still holding the old identity 410s.
    """

    def __init__(self, endpoint: str, *, timeout_s: float = 5.0,
                 generation_token: str | Callable[[], str] | None = None):
        from hops_tpu_torch.runtime.httpclient import HTTPPool

        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = float(timeout_s)
        self._pool = HTTPPool(max_idle_per_host=4, identity="store-client")
        self._generation_token = generation_token
        #: Codecs the shard server advertised at handshake; ``None``
        #: until the first ``get_many`` probes ``/healthz``. A server
        #: that predates the handshake field is pinned JSON-only.
        self._codecs: frozenset[str] | None = None

    def _exchange(self, method: str, path: str,
                  payload: dict | None = None,
                  headers: dict[str, str] | None = None,
                  ) -> tuple[bytes, dict]:
        # Shard RPC *requests* (key lists, row batches to put) stay
        # JSON: they are small and schema-free; only the get_many
        # response rides the packed codec.
        body = (json.dumps(payload, default=str).encode()  # graftlint: disable=json-on-hot-wire
                if payload is not None else None)
        hdrs = dict(headers or {})
        if body:
            hdrs.setdefault("Content-Type", "application/json")
        tok = self._generation_token
        if callable(tok):
            tok = tok()
        if tok:
            # Same literal as jobs.placement.client.GENERATION_HEADER
            # (not imported: the featurestore stays decoupled from the
            # placement package's import chain).
            hdrs.setdefault("X-Hops-Generation", tok)
        code, data, resp_hdrs = self._pool.request(
            method, f"{self.endpoint}{path}", body, hdrs or None,
            timeout_s=self.timeout_s,
        )
        if code == 410:
            raise GenerationSupersededError(
                f"shard server {self.endpoint}{path} answered 410 "
                f"(superseded generation — zombie endpoint, stamped "
                f"{tok!r})")
        if code != 200:
            raise ConnectionError(
                f"shard server {self.endpoint}{path} answered {code}")
        return data, resp_hdrs

    def _json_exchange(self, method: str, path: str,
                       payload: dict | None = None) -> dict:
        # Control-plane verbs (healthz/stats/put/delete/scan) are
        # JSON-only by contract; get_many negotiates separately.
        data, _ = self._exchange(method, path, payload)
        return json.loads(data) if data else {}  # graftlint: disable=json-on-hot-wire

    def _handshake(self) -> frozenset[str]:
        """Learn the server's codecs from ``/healthz`` (cached).

        A non-200 answer pins the shard JSON-only (the request path will
        surface the shard's real health); transport errors propagate so
        the caller's breaker/hedge machinery sees them.
        """
        if self._codecs is None:
            try:
                health = self._json_exchange("GET", "/healthz")
            except ConnectionError:
                return frozenset({"json"})  # unhealthy answer — don't cache
            self._codecs = frozenset(health.get("codecs") or ("json",))
        return self._codecs

    def get_many(self, pk_values_list: list[list[Any]]) -> list[dict | None]:
        accept = None
        if "packed" in self._handshake():
            accept = {"Accept": wirecodec.MEDIA_TYPE}
        data, hdrs = self._exchange("POST", "/get_many",
                                    {"pks": pk_values_list}, accept)
        ctype = next((v for k, v in hdrs.items()
                      if k.lower() == "content-type"), "")
        if wirecodec.MEDIA_TYPE in ctype:
            try:
                return wirecodec.decode_rows(data)
            except wirecodec.WireCodecError as e:
                # Fail closed: a malformed frame is breaker food, never
                # silently-wrong rows.
                raise ConnectionError(
                    f"shard server {self.endpoint}/get_many sent a bad "
                    f"packed frame: {e}") from None
        # Negotiated JSON fallback: the shard either answered a JSON
        # Content-Type or predates the packed codec entirely.
        return json.loads(data)["rows"] if data else []  # graftlint: disable=json-on-hot-wire

    def put_dataframe(self, df: pd.DataFrame, primary_key: list[str]) -> int:
        recs = df.to_dict(orient="records")
        return int(self._json_exchange("POST", "/put",
                                  {"records": recs}).get("applied", 0))

    def delete_keys(self, df: pd.DataFrame, primary_key: list[str]) -> None:
        self._json_exchange("POST", "/delete",
                            {"records": df.to_dict(orient="records")})

    def scan(self) -> Iterator[dict]:
        yield from self._json_exchange("GET", "/scan")["rows"]

    def count(self) -> int:
        return int(self._json_exchange("GET", "/stats")["rows"])

    def close(self) -> None:
        self._pool.close()


class ShardedOnlineStore:
    """N ``OnlineStore`` shards keyed by ``crc32(primary key) % N``.

    One instance per (feature group, version). Writers route each row to
    its shard and take only that shard's writer lock; point reads use
    the backends' reader-safe path (sqlite WAL snapshot connections —
    see ``online.OnlineStore``), so serving lookups never queue behind a
    materialization flush. ``ttl_s`` bounds row age: expired rows read
    as misses immediately and :meth:`evict_expired` reclaims them.
    """

    def __init__(
        self,
        name: str,
        version: int = 1,
        *,
        primary_key: list[str],
        shards: int = 4,
        ttl_s: float | None = None,
        root: str | Path | None = None,
        breaker_failures: int = 5,
        breaker_reset_s: float = 5.0,
        fanout: bool = True,
        hedge: bool = True,
        endpoints: list[str] | None = None,
        units: list[Any] | None = None,
        placement: Any = None,
        rpc_timeout_s: float = 5.0,
    ):
        if not primary_key:
            raise ValueError("ShardedOnlineStore needs a primary_key")
        if units is not None and endpoints is not None:
            raise ValueError("units= and endpoints= are exclusive: units "
                             "derive their own endpoints")
        tokens: list[Any] = []
        if units is not None:
            # PLACED mode by PlacedUnit: derive each shard's endpoint
            # AND its generation identity. With a placement client the
            # token is a live read of the slot's current generation
            # (tracks re-placement bumps mid-flight); without one it is
            # pinned to the unit's minted generation.
            if not units:
                raise ValueError("units= must name at least one shard unit")
            endpoints = [f"http://{u.address}:{u.port}" for u in units]
            for u in units:
                slot = getattr(u, "slot", None)
                if slot is None:
                    tokens.append(None)
                elif placement is not None:
                    tokens.append(
                        lambda s=slot: f"{s}:{placement.current_generation(s)}")
                else:
                    tokens.append(f"{slot}:{u.generation}")
        if endpoints is not None and not endpoints:
            raise ValueError("endpoints= must name at least one shard server")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.name = name
        self.version = int(version)
        self.label = f"{name}_{version}"
        self.primary_key = [k.lower() for k in primary_key]
        self.ttl_s = ttl_s
        d = Path(root) if root is not None else storage.feature_store_root() / "online"
        d.mkdir(parents=True, exist_ok=True)
        self._dir = d
        if endpoints is not None:
            # PLACED mode: each shard is a remote shardd server (placed
            # on some host by the placement layer); the shard count IS
            # the endpoint list — the placement that spawned the
            # servers owns the layout, so the local meta file is not
            # consulted. Everything else (crc32 routing, per-shard
            # breakers, fan-out, hedging) is identical to local mode.
            shards = len(endpoints)
            if not tokens:
                tokens = [None] * shards
            self._shards: list[Any] = [
                _RemoteShard(ep, timeout_s=rpc_timeout_s, generation_token=tok)
                for ep, tok in zip(endpoints, tokens)
            ]
        else:
            # The shard layout is part of the data: crc32(key) % N only
            # finds a row under the N it was written with. The first
            # opener persists its layout; later openers (serving
            # replicas, other processes) ADOPT it — a differing
            # ``shards=`` argument would otherwise silently read misses
            # for most keys.
            meta_path = d / f"{self.label}.meta.json"
            if meta_path.exists():
                meta = json.loads(meta_path.read_text())
                if [k.lower() for k in meta.get("primary_key", [])] != self.primary_key:
                    raise ValueError(
                        f"online store {self.label} was created with primary key "
                        f"{meta.get('primary_key')}, not {self.primary_key}"
                    )
                if int(meta["shards"]) != int(shards):
                    log.info(
                        "online store %s: adopting persisted shard count %d "
                        "(requested %d)", self.label, meta["shards"], shards,
                    )
                shards = int(meta["shards"])
            else:
                tmp = meta_path.with_suffix(".meta.tmp")
                tmp.write_text(json.dumps(
                    {"shards": int(shards), "primary_key": self.primary_key}
                ))
                os.replace(tmp, meta_path)
            self._shards = [
                OnlineStore(d / f"{self.label}.shard{i}")
                for i in range(int(shards))
            ]
        # One breaker per shard: a dead shard fails fast (its keys read
        # as missing) instead of stalling every request that hashes into
        # it; the half-open probe heals it when the backend recovers.
        self._breakers = [
            CircuitBreaker(
                name=f"online-{self.label}-shard{i}",
                failure_threshold=breaker_failures,
                reset_timeout_s=breaker_reset_s,
            )
            for i in range(int(shards))
        ]
        # One per shard: serializes upsert_rows' read-check-merge-write
        # cycle (the shard's own writer lock covers only each put).
        self._upsert_locks = [threading.Lock() for _ in range(int(shards))]
        # Parallel fan-out + straggler hedging for multi-shard reads.
        self.fanout = bool(fanout) and int(shards) > 1
        self.hedge_stragglers = bool(hedge)
        self._pool_lock = threading.Lock()
        self._pool = None  # guarded by: self._pool_lock (lazy: many stores never multi-shard-read)
        # Recent successful shard-lookup latencies — the hedge timer's
        # p95 source. guarded by: self._pool_lock.
        self._recent_lookup_s: "list[float]" = []
        self._meta_lock = threading.Lock()
        self._watermark: float | None = None  # guarded by: self._meta_lock
        # (file value, monotonic read time): the persisted watermark is
        # re-read at most every 50 ms — freshness lag is a seconds-scale
        # signal and an uncached read_text per lookup was ~15% of the
        # join path on the CPU tier.
        self._wm_cache: tuple[float | None, float] | None = None  # guarded by: self._meta_lock
        self._m_lookup = _m_lookup_seconds.labels(store=self.label)
        self._m_hit = _m_lookup_total.labels(store=self.label, result="hit")
        self._m_miss = _m_lookup_total.labels(store=self.label, result="miss")
        self._m_expired = _m_lookup_total.labels(store=self.label, result="expired")
        self._m_error = _m_lookup_total.labels(store=self.label, result="error")
        self._m_fresh = _m_freshness.labels(store=self.label)
        self._m_evict = _m_evicted.labels(store=self.label)

    # -- keys -----------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def _pk_values(self, entry: Any) -> list[Any]:
        if isinstance(entry, dict):
            lowered = {str(k).lower(): v for k, v in entry.items()}
            try:
                return [lowered[k] for k in self.primary_key]
            except KeyError as e:
                raise ValueError(
                    f"entity entry {entry!r} is missing primary key "
                    f"{e.args[0]!r} of store {self.label}"
                ) from None
        return list(entry)  # positional, in primary_key order

    def shard_index(self, entry: Any) -> int:
        return _shard_of(_key_of(self._pk_values(entry)), self.n_shards)

    # -- write path -----------------------------------------------------------

    def put_dataframe(self, df: pd.DataFrame, event_ts: str | None = None) -> int:
        """Route a frame's rows to their shards and upsert (see
        :meth:`upsert_rows`)."""
        return self.upsert_rows(df.to_dict(orient="records"), event_ts=event_ts)

    def upsert_rows(self, rows: list[dict], event_ts: str | None = None) -> int:
        """Idempotent keyed upsert-merge; returns rows applied.

        ``event_ts`` names the column carrying each row's event time
        (epoch seconds); absent, rows are stamped with now. A row whose
        event time is OLDER than the stored row's is skipped, and
        duplicates WITHIN the batch fold newest-last before the write —
        so at-least-once delivery, replays, and out-of-order topics
        (across and inside poll batches) all converge to
        last-event-time-wins, and re-running a drained materializer is
        a no-op. A partial row (a subset of columns) merges into the
        stored row rather than replacing it: absent features stay
        served instead of silently turning into misses — and never into
        NaN padding.
        """
        now = time.time()
        # Fold the batch per key in ascending (event time, batch order)
        # before touching any shard: an older duplicate BEHIND a newer
        # row in the same batch must not win just because it was
        # applied later.
        folded: dict[str, dict] = {}
        order: list[str] = []
        max_ts: float | None = None
        for row in rows:
            rec = {str(k).lower(): v for k, v in row.items()}
            ts = now
            if event_ts is not None and rec.get(event_ts.lower()) is not None:
                ts = float(rec[event_ts.lower()])
            rec[EVENT_TS_COL] = ts
            key = _key_of(self._pk_values(rec))
            cur = folded.get(key)
            if cur is None:
                folded[key] = rec
                order.append(key)
            elif ts >= cur[EVENT_TS_COL]:
                folded[key] = {**cur, **rec}
            else:
                folded[key] = {**rec, **cur}
            max_ts = ts if max_ts is None else max(max_ts, ts)
        buckets: dict[int, list[dict]] = {}
        for key in order:
            buckets.setdefault(_shard_of(key, self.n_shards), []).append(folded[key])
        applied = 0
        for idx in sorted(buckets):
            shard = self._shards[idx]
            # The read-check-merge-write cycle must be atomic per shard:
            # without this lock two concurrent upserters (the daemon and
            # a snapshot restore, say) can both read the old row, both
            # pass the staleness guard, and the LAST writer — possibly
            # the older one — wins.
            with self._upsert_locks[idx]:
                currents = shard.get_many(
                    [self._pk_values(rec) for rec in buckets[idx]]
                )
                fresh = []
                for rec, current in zip(buckets[idx], currents):
                    if current is not None:
                        if current.get(EVENT_TS_COL, 0.0) > rec[EVENT_TS_COL]:
                            continue  # stale replay: the store already moved past it
                        rec = {**current, **rec}  # partial update merges
                    fresh.append(rec)
                # Group by column signature: one put per homogeneous
                # slice, so a mixed batch never NaN-pads missing columns
                # into stored rows (NaN would read back as a HIT and
                # bypass the missing-key policy).
                by_cols: dict[frozenset, list[dict]] = {}
                for rec in fresh:
                    by_cols.setdefault(frozenset(rec), []).append(rec)
                for recs in by_cols.values():
                    applied += shard.put_dataframe(
                        pd.DataFrame(recs), self.primary_key
                    )
        if max_ts is not None:
            self.set_watermark(max_ts)
        return applied

    def delete_keys(self, df: pd.DataFrame) -> None:
        buckets: dict[int, list[dict]] = {}
        for row in df.to_dict(orient="records"):
            rec = {str(k).lower(): v for k, v in row.items()}
            key = _key_of(self._pk_values(rec))
            buckets.setdefault(_shard_of(key, self.n_shards), []).append(rec)
        for idx, recs in buckets.items():
            self._shards[idx].delete_keys(pd.DataFrame(recs), self.primary_key)

    # -- read path ------------------------------------------------------------

    @staticmethod
    def _strip(row: dict) -> dict:
        return {k: v for k, v in row.items() if k != EVENT_TS_COL}

    def _expired(self, row: dict, now: float) -> bool:
        if self.ttl_s is None:
            return False
        return now - float(row.get(EVENT_TS_COL, now)) > self.ttl_s

    @staticmethod
    def _shard_lookup(shard: OnlineStore, pk_lists: list[list[Any]]) -> list[dict | None]:
        return shard.get_many(pk_lists)

    def get(self, entry: Any) -> dict | None:
        """Point lookup; None on miss/expiry/shard failure (the caller's
        missing-key policy decides what None means)."""
        return self.multi_get([entry])[0]

    def multi_get(
        self, entries: list[Any], deadline_s: float | None = None
    ) -> list[dict | None]:
        """Batched point lookup across shards, results in entry order.

        Never raises for a failing shard: a lookup error, a
        ``deadline_s`` overrun, or an open breaker turns that shard's
        keys into misses (``result="error"`` on the lookup counter) —
        serving degrades to the missing-key policy instead of failing
        the request.

        With multiple shards touched (and ``fanout`` on, the default),
        shard lookups run in PARALLEL under one shared deadline, and a
        straggler shard is hedged with a second attempt after the
        store's recent p95 lookup latency — see the module docstring's
        tail semantics. Single-shard batches keep the inline path.
        """
        out: list[dict | None] = [None] * len(entries)
        buckets: dict[int, list[tuple[int, list[Any]]]] = {}
        for pos, entry in enumerate(entries):
            pk = self._pk_values(entry)
            buckets.setdefault(_shard_of(_key_of(pk), self.n_shards), []).append(
                (pos, pk)
            )
        now = time.time()
        if self.fanout and len(buckets) > 1:
            self._multi_get_fanout(buckets, out, now, deadline_s)
        else:
            for idx in sorted(buckets):
                items = buckets[idx]
                shard, breaker = self._shards[idx], self._breakers[idx]
                if not breaker.allow():
                    self._m_error.inc(len(items))
                    continue
                t0 = time.perf_counter()
                try:
                    # Chaos points: a lookup error/latency here must
                    # surface as missing keys + breaker pressure,
                    # never a 5xx.
                    faultinject.fire("online.lookup")
                    faultinject.fire("shard.lookup", key=idx)
                    pk_lists = [pk for _, pk in items]
                    if deadline_s is not None:
                        rows = with_deadline(
                            self._shard_lookup, deadline_s, shard, pk_lists,
                            op="online.lookup",
                        )
                    else:
                        rows = self._shard_lookup(shard, pk_lists)
                except GenerationSupersededError as e:
                    # Zombie endpoint (typed 410): degrade to missing
                    # keys with NO breaker strike — the shard answered
                    # healthily, it is the placement layer's job to
                    # swap the endpoint, not the breaker's to eject it.
                    self._m_error.inc(len(items))
                    log.warning(
                        "online store %s shard %d superseded: %s",
                        self.label, idx, e,
                    )
                    continue
                except Exception as e:  # noqa: BLE001 — a dead shard degrades, never raises
                    breaker.record_failure()
                    self._m_error.inc(len(items))
                    log.warning(
                        "online store %s shard %d lookup failed: %s: %s",
                        self.label, idx, type(e).__name__, e,
                    )
                    continue
                breaker.record_success()
                elapsed = time.perf_counter() - t0
                self._m_lookup.observe(elapsed)
                self._note_lookup_latency(elapsed)
                self._fill_rows(out, items, rows, now)
        self._observe_freshness()
        return out

    def _fill_rows(self, out: list, items: list, rows: list,
                   now: float) -> None:
        for (pos, _), row in zip(items, rows):
            if row is None:
                self._m_miss.inc()
            elif self._expired(row, now):
                self._m_expired.inc()
            else:
                self._m_hit.inc()
                out[pos] = self._strip(row)

    # -- parallel fan-out with straggler hedging ------------------------------

    def _executor(self):
        from concurrent.futures import ThreadPoolExecutor

        with self._pool_lock:
            if self._pool is None:
                # 2x shards: a full fan-out plus one hedge per shard
                # can run without queueing behind each other.
                self._pool = ThreadPoolExecutor(
                    max_workers=min(2 * self.n_shards, 16),
                    thread_name_prefix=f"online-{self.label}",
                )
            return self._pool

    def _note_lookup_latency(self, seconds: float) -> None:
        with self._pool_lock:
            self._recent_lookup_s.append(seconds)
            if len(self._recent_lookup_s) > 256:
                del self._recent_lookup_s[:128]

    def _hedge_delay_s(self) -> float | None:
        """p95 of recent successful shard lookups — the straggler
        threshold. None (no hedging) until enough history exists."""
        with self._pool_lock:
            window = sorted(self._recent_lookup_s[-128:])
        if len(window) < 8:
            return None
        return max(window[min(len(window) - 1, int(len(window) * 0.95))],
                   0.002)

    def _multi_get_fanout(
        self,
        buckets: dict[int, list[tuple[int, list[Any]]]],
        out: list,
        now: float,
        deadline_s: float | None,
    ) -> None:
        cv = threading.Condition()
        results: dict[int, tuple[bool, Any, float]] = {}  # guarded by: cv

        def attempt(idx: int, pk_lists: list) -> None:
            t0 = time.perf_counter()
            try:
                # Chaos points, per ATTEMPT: `online.lookup` keeps its
                # error-degrades contract; `shard.lookup` (keyed by
                # shard index) is the gray-shard injection site — a
                # latency fault stalls exactly one attempt, which the
                # hedge races.
                faultinject.fire("online.lookup")
                faultinject.fire("shard.lookup", key=idx)
                rows = self._shard_lookup(self._shards[idx], pk_lists)
                ok = True
            except Exception as e:  # noqa: BLE001 — degrade, never raise
                rows, ok = e, False
            elapsed = time.perf_counter() - t0
            with cv:
                if idx not in results:
                    results[idx] = (ok, rows, elapsed)
                    cv.notify_all()
                # else: abandoned loser (hedge raced it) — discarded,
                # no breaker/metric effects.

        pool = self._executor()
        pending: list[int] = []
        started = time.perf_counter()
        for idx in sorted(buckets):
            if not self._breakers[idx].allow():
                self._m_error.inc(len(buckets[idx]))
                continue
            pool.submit(attempt, idx, [pk for _, pk in buckets[idx]])
            pending.append(idx)
        hedge_delay = (
            self._hedge_delay_s() if self.hedge_stragglers else None)
        deadline = started + deadline_s if deadline_s is not None else None
        hedged: set[int] = set()
        while True:
            with cv:
                done = set(results)
            live = [i for i in pending if i not in done]
            if not live:
                break
            now_pc = time.perf_counter()
            if deadline is not None and now_pc >= deadline:
                break
            waits = [] if deadline is None else [deadline - now_pc]
            if hedge_delay is not None:
                not_hedged = [i for i in live if i not in hedged]
                if not_hedged:
                    hedge_at = started + hedge_delay
                    if now_pc >= hedge_at:
                        for idx in not_hedged:
                            hedged.add(idx)
                            _m_shard_hedges.inc(store=self.label)
                            pool.submit(
                                attempt, idx,
                                [pk for _, pk in buckets[idx]])
                        continue
                    waits.append(hedge_at - now_pc)
            with cv:
                if all(i in results for i in live):
                    continue
                cv.wait(timeout=min(waits) if waits else None)
        with cv:
            settled = dict(results)
        for idx in pending:
            items = buckets[idx]
            res = settled.get(idx)
            if res is None:
                # Deadline overrun: the shard is slow past the budget —
                # breaker pressure plus missing keys, exactly like the
                # sequential path's with_deadline overrun.
                self._breakers[idx].record_failure()
                self._m_error.inc(len(items))
                log.warning(
                    "online store %s shard %d lookup missed the "
                    "%.3fs deadline (hedged=%s)",
                    self.label, idx, deadline_s or -1.0, idx in hedged)
                continue
            ok, rows, elapsed = res
            if not ok:
                if isinstance(rows, GenerationSupersededError):
                    # Zombie endpoint (typed 410): miss-degrade, no
                    # breaker strike — see the sequential path.
                    self._m_error.inc(len(items))
                    log.warning(
                        "online store %s shard %d superseded: %s",
                        self.label, idx, rows)
                    continue
                self._breakers[idx].record_failure()
                self._m_error.inc(len(items))
                log.warning(
                    "online store %s shard %d lookup failed: %s: %s",
                    self.label, idx, type(rows).__name__, rows)
                continue
            self._breakers[idx].record_success()
            self._m_lookup.observe(elapsed)
            self._note_lookup_latency(elapsed)
            self._fill_rows(out, items, rows, now)

    def scan(self) -> Iterator[dict]:
        """Every live (non-expired) row across all shards."""
        now = time.time()
        for shard in self._shards:
            for row in shard.scan():
                if not self._expired(row, now):
                    yield self._strip(row)

    def count(self) -> int:
        """Stored rows across all shards (including TTL-expired rows
        not yet swept — :meth:`evict_expired` reclaims those)."""
        return sum(shard.count() for shard in self._shards)

    def evict_expired(self) -> int:
        """TTL sweep: delete expired rows (each shard's delete runs
        under that shard's writer lock). Returns rows evicted."""
        if self.ttl_s is None:
            return 0
        now = time.time()
        evicted = 0
        for shard in self._shards:
            doomed = [row for row in shard.scan() if self._expired(row, now)]
            if doomed:
                shard.delete_keys(pd.DataFrame(doomed), self.primary_key)
                evicted += len(doomed)
        if evicted:
            self._m_evict.inc(evicted)
        return evicted

    # -- freshness watermark --------------------------------------------------
    #
    # The watermark is persisted beside the shard files (not memory-only)
    # because the writer and the readers are usually DIFFERENT store
    # instances — the materializer daemon advances it, serving replicas
    # (their own ShardedOnlineStore objects, possibly other processes)
    # re-derive lag from it at every lookup. That is also what makes the
    # freshness gauge rise while the daemon is dead: the file stalls,
    # now keeps moving.

    def _watermark_path(self) -> Path:
        return self._dir / f"{self.label}.watermark"

    def _file_watermark(self) -> float | None:
        now = time.monotonic()
        with self._meta_lock:
            cached = self._wm_cache
        if cached is not None and now - cached[1] < 0.05:
            return cached[0]
        try:
            file_wm = float(self._watermark_path().read_text())
        except (OSError, ValueError):
            file_wm = None
        with self._meta_lock:
            self._wm_cache = (file_wm, now)
        return file_wm

    @property
    def watermark(self) -> float | None:
        """Max event time materialized into this store (epoch seconds):
        the newer of this instance's own writes and the persisted file
        (another instance's writes, cached for at most 50 ms)."""
        with self._meta_lock:
            wm = self._watermark
        file_wm = self._file_watermark()
        if file_wm is None:
            return wm
        return file_wm if wm is None else max(wm, file_wm)

    def set_watermark(self, ts: float) -> None:
        ts = float(ts)
        with self._meta_lock:
            try:
                file_wm = float(self._watermark_path().read_text())
            except (OSError, ValueError):
                file_wm = None
            known = max(
                (v for v in (self._watermark, file_wm) if v is not None),
                default=None,
            )
            if known is None or ts > known:
                self._watermark = ts
                tmp = self._watermark_path().with_suffix(".watermark.tmp")
                tmp.write_text(repr(ts))
                os.replace(tmp, self._watermark_path())
                self._wm_cache = (ts, time.monotonic())
            elif self._watermark is None or ts > self._watermark:
                self._watermark = ts  # file already newer; cache ours anyway
        self._observe_freshness()

    def freshness_lag_s(self) -> float:
        """Seconds between now and the watermark — how stale the online
        view is. 0.0 before anything has been materialized."""
        wm = self.watermark
        return max(0.0, time.time() - wm) if wm is not None else 0.0

    def _observe_freshness(self) -> None:
        self._m_fresh.set(self.freshness_lag_s())

    # -- snapshot / warm-start ------------------------------------------------

    def snapshot(self, directory: str | Path) -> Path:
        """Write a warm-start snapshot: one JSONL file per shard plus a
        ``manifest.json`` with per-file sizes and SHA-256 checksums —
        the checkpoint layer's integrity contract (same streaming
        digest, same verify-before-trust restore), so a replica can
        prove a snapshot healthy before serving from it."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        # Captured BEFORE the scans: under concurrent write-through the
        # manifest watermark must be a LOWER bound on what the files
        # hold — claiming event times whose rows were scanned past
        # would make a restored replica report freshness it doesn't have.
        wm = self.watermark
        files: dict[str, dict[str, Any]] = {}
        for i, shard in enumerate(self._shards):
            p = d / f"shard{i}.jsonl"
            tmp = p.with_suffix(".jsonl.tmp")
            with tmp.open("w") as f:
                for row in shard.scan():
                    f.write(json.dumps(row, default=str) + "\n")
            os.replace(tmp, p)
            files[p.name] = {"size": p.stat().st_size, "sha256": _file_sha256(p)}
        manifest = {
            "name": self.name,
            "version": self.version,
            "primary_key": self.primary_key,
            "shards": self.n_shards,
            "watermark": wm,
            "files": files,
        }
        tmp = d / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest, indent=2))
        os.replace(tmp, d / "manifest.json")
        return d

    def restore_snapshot(self, directory: str | Path) -> int:
        """Verify and load a :meth:`snapshot` into this store (warm
        start). Rows load through the idempotent upsert with their
        snapshotted event times, so restoring on top of newer data never
        rolls a row back; the watermark is restored too. Raises
        :class:`~hops_tpu_torch.runtime.checkpoint.CheckpointCorruptError`
        when a file fails its manifest check. Returns rows applied."""
        d = Path(directory)
        manifest = json.loads((d / "manifest.json").read_text())
        for fname, meta in manifest.get("files", {}).items():
            p = d / fname
            try:
                size = p.stat().st_size
            except OSError as e:
                raise CheckpointCorruptError(
                    f"online snapshot {d}: {fname} unreadable "
                    f"({type(e).__name__}: {e})"
                ) from None
            if size != meta["size"]:
                raise CheckpointCorruptError(
                    f"online snapshot {d}: {fname} size {size} != "
                    f"manifest {meta['size']}"
                )
            if _file_sha256(p) != meta["sha256"]:
                raise CheckpointCorruptError(
                    f"online snapshot {d}: {fname} checksum mismatch"
                )
        rows: list[dict] = []
        for fname in manifest.get("files", {}):
            with (d / fname).open() as f:
                rows.extend(json.loads(line) for line in f if line.strip())
        applied = self.upsert_rows(rows, event_ts=EVENT_TS_COL) if rows else 0
        if manifest.get("watermark") is not None:
            self.set_watermark(float(manifest["watermark"]))
        return applied

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            # WAIT for in-flight attempts: an abandoned hedge loser may
            # still be inside a native (mmap) read — closing the shards
            # under it is a segfault, not an exception. The wait is
            # bounded by the slowest real lookup still running.
            pool.shutdown(wait=True)
        for shard in self._shards:
            shard.close()


def open_sharded_store(
    name: str, version: int = 1, *, primary_key: list[str], **kwargs: Any
) -> ShardedOnlineStore:
    """Open (or create) the sharded online store of a (feature group,
    version) under the workspace's ``FeatureStore/online`` root."""
    return ShardedOnlineStore(name, version, primary_key=primary_key, **kwargs)


# -- write-through materialization --------------------------------------------


class Materializer:
    """Write-through materialization daemon for one (topic, store) pair.

    A consumer thread tails the pubsub topic with a durable consumer
    group and upserts each record's ``value`` row into the store in
    batched flushes. Delivery is at-least-once — the group offset
    commits only AFTER a batch is flushed — and convergence comes from
    the store's idempotent event-time-guarded upserts, so a crash
    between flush and commit merely replays rows into a no-op.

    ``event_time`` names the row column carrying event time; absent (or
    missing on a row), the producer's ``ts`` stamp is used. The max
    event time applied becomes the store's freshness watermark; rows
    without a usable primary key are skipped with a warning (a poison
    record must not wedge the offset forever — the same contract as the
    consumer's unparsable-record skip).

    ``from_beginning=True`` (the default) makes a NEW group catch up on
    the topic's history; a restarted daemon with a committed offset
    resumes from the commit either way (the consumer's durable-group
    contract), so restarts cost O(uncommitted tail), not O(topic).
    """

    def __init__(
        self,
        store: ShardedOnlineStore,
        topic: str,
        group: str = "online-materializer",
        *,
        event_time: str | None = None,
        batch_size: int = 256,
        poll_interval_s: float = 0.05,
        from_beginning: bool = True,
    ):
        self._store = store
        self._topic = topic
        self._consumer = pubsub.Consumer(topic, group=group, from_beginning=from_beginning)
        self._event_time = event_time.lower() if event_time else None
        self._batch_size = int(batch_size)
        self._poll_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._state_lock = threading.Lock()
        self._busy = False  # guarded by: self._state_lock
        self._errors = 0
        self._m_rows = _m_materialized.labels(store=store.label)
        self._thread = threading.Thread(
            target=self._loop, name=f"materializer-{store.label}", daemon=True
        )

    def start(self) -> "Materializer":
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout_s)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def lag_bytes(self) -> int:
        """Topic bytes not yet consumed (0 = caught up)."""
        return self._consumer.lag()

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until the consumer has caught up to the topic end AND
        the last batch is flushed; False on timeout or a dead daemon.
        Meaningful only while producers are quiet (a live producer can
        re-raise the lag right after the check)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self.alive:
                return False
            with self._state_lock:
                busy = self._busy
            if not busy and self._consumer.lag() == 0:
                return True
            time.sleep(min(self._poll_s, 0.02))
        return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                with self._state_lock:
                    self._busy = True
                try:
                    # Chaos point: an injected error/latency here must be
                    # survived (logged + retried with backoff), never kill
                    # the daemon — while it stalls, the freshness gauge
                    # rises and serving keeps answering from stale rows.
                    faultinject.fire("online.materialize")
                    records = self._consumer.poll(max_records=self._batch_size)
                    if records:
                        self._apply(records)
                        self._consumer.commit()  # at-least-once: AFTER the flush
                finally:
                    with self._state_lock:
                        self._busy = False
            except Exception as e:  # noqa: BLE001 — the daemon outlives transient faults
                self._errors += 1
                log.warning(
                    "materializer %s -> %s: %s: %s (attempt %d, backing off)",
                    self._topic, self._store.label, type(e).__name__, e,
                    self._errors,
                )
                # Computed exponential backoff (capped), interruptible
                # by stop() — not a naked retry loop.
                self._stop.wait(min(self._poll_s * (2 ** min(self._errors, 6)), 2.0))
                continue
            self._errors = 0
            if not records:
                self._stop.wait(self._poll_s)

    def _apply(self, records: list[dict]) -> None:
        rows: list[dict] = []
        for rec in records:
            value = rec.get("value")
            if not isinstance(value, dict):
                log.warning(
                    "materializer %s: skipping non-row record (%s)",
                    self._topic, type(value).__name__,
                )
                continue
            row = {str(k).lower(): v for k, v in value.items()}
            if any(row.get(k) is None for k in self._store.primary_key):
                log.warning(
                    "materializer %s: skipping row without primary key %s",
                    self._topic, self._store.primary_key,
                )
                continue
            ts = None
            if self._event_time is not None:
                ts = row.get(self._event_time)
            if ts is None:
                ts = rec.get("ts", time.time())
            row[EVENT_TS_COL] = float(ts)
            rows.append(row)
        if rows:
            applied = self._store.upsert_rows(rows, event_ts=EVENT_TS_COL)
            self._m_rows.inc(applied)


# -- serving-time feature joins ------------------------------------------------


def validate_feature_config(cfg: dict[str, Any]) -> dict[str, Any]:
    """Normalize and validate a ``feature_config`` dict at definition
    time (``serving.create_or_update``), so a typo'd policy or a group
    without a primary key fails at create, not at the first request."""
    cfg = dict(cfg)
    missing = cfg.get("missing", "default")
    if missing not in MISSING_POLICIES:
        raise ValueError(
            f"feature_config missing-key policy must be one of "
            f"{MISSING_POLICIES}, got {missing!r}"
        )
    groups = cfg.get("groups")
    if not groups:
        raise ValueError("feature_config needs a non-empty 'groups' list")
    for g in groups:
        if not g.get("name"):
            raise ValueError(f"feature_config group without a name: {g!r}")
        if not g.get("primary_key"):
            raise ValueError(
                f"feature_config group {g['name']!r} needs a primary_key"
            )
        eps = g.get("endpoints")
        if eps is not None and (
            not isinstance(eps, list)
            or not eps
            or not all(isinstance(e, str) and e.startswith("http") for e in eps)
        ):
            raise ValueError(
                f"feature_config group {g['name']!r} endpoints must be a "
                f"non-empty list of http URLs, got {eps!r}"
            )
    if not cfg.get("order") and not all(g.get("features") for g in groups):
        raise ValueError(
            "feature_config needs an explicit 'order' (output feature "
            "order) or per-group 'features' lists to derive it from"
        )
    return cfg


class FeatureJoinPredictor:
    """Request-time feature joins in front of any predictor.

    Instances are entity-key dicts (``{"user_id": 7}``); the predictor
    multi-gets every configured group's rows (one batched lookup per
    group, fanned per shard), merges them per entity, assembles the
    model-ready vector in ``order``, and calls the wrapped predictor on
    the vectors. Composes with the ``DynamicBatcher`` upstream —
    coalesced requests arrive here as one instances list and become one
    join pass.

    ``feature_config`` keys: ``groups`` (list of ``{"name", "version",
    "primary_key", "features", "shards", "ttl_s", "endpoints"}`` —
    ``endpoints`` lists placed shard-server URLs, turning the group's
    store remote; see docs/operations.md "Multi-host placement"),
    ``order`` (output
    feature order; default: concatenation of the groups' ``features``),
    ``missing`` (``default`` — substitute ``defaults[f]`` or
    ``default_value``; ``reject`` — fail the request; ``passthrough`` —
    emit None), ``defaults`` / ``default_value``, ``lookup_deadline_s``
    (the multi-get budget; overruns degrade to the missing policy),
    ``brownout_lookup_deadline_s`` (the budget while the fleet is
    browned out — under SLO burn joins stop waiting on slow shards and
    serve defaults; not applied under the ``reject`` policy, which
    would turn degradation into request failures), ``shards`` /
    ``ttl_s`` / ``root`` / ``fanout`` / ``hedge`` (store defaults).
    """

    def __init__(
        self,
        inner: Any,
        feature_config: dict[str, Any],
        model: str = "",
        stores: dict[str, ShardedOnlineStore] | None = None,
    ):
        cfg = validate_feature_config(feature_config)
        self._inner = inner
        self._model = model
        self._missing = cfg.get("missing", "default")
        self._defaults = {
            str(k).lower(): v for k, v in (cfg.get("defaults") or {}).items()
        }
        self._default_value = cfg.get("default_value", 0.0)
        self._deadline_s = cfg.get("lookup_deadline_s")
        self._brownout_deadline_s = cfg.get("brownout_lookup_deadline_s", 0.05)
        self._groups: list[tuple[ShardedOnlineStore, list[str]]] = []
        for g in cfg["groups"]:
            store = (stores or {}).get(g["name"])
            if store is None:
                store = ShardedOnlineStore(
                    g["name"],
                    g.get("version", 1),
                    primary_key=g["primary_key"],
                    shards=int(g.get("shards", cfg.get("shards", 4))),
                    ttl_s=g.get("ttl_s", cfg.get("ttl_s")),
                    root=cfg.get("root"),
                    fanout=bool(g.get("fanout", cfg.get("fanout", True))),
                    hedge=bool(g.get("hedge", cfg.get("hedge", True))),
                    # Placed shards: the group's shard-server endpoints
                    # (placement wrote them into the serving config, so
                    # subprocess fleet replicas join against the same
                    # remote shards the local path would).
                    endpoints=g.get("endpoints"),
                )
            feats = [str(f).lower() for f in (g.get("features") or [])]
            self._groups.append((store, feats))
        order = [str(f).lower() for f in (cfg.get("order") or [])]
        if not order:
            order = [f for _, feats in self._groups for f in feats]
        self._order = order
        self._m_join = _m_join_seconds.labels(model=model)
        self._m_request = _m_request_seconds.labels(model=model)
        self._m_missing = _m_missing_keys.labels(model=model, policy=self._missing)

    @property
    def order(self) -> list[str]:
        """The model-ready vector's feature order."""
        return list(self._order)

    def join(self, entries: list[Any]) -> list[list[Any]]:
        """Joined model-ready vectors for a batch of entity entries."""
        t0 = time.perf_counter()
        merged: list[dict[str, Any]] = [{} for _ in entries]
        # Child of the request trace when one is active (the batcher
        # runs the coalesced join under the carrier request's context);
        # a no-op outside one.
        # Brownout degrade: stop waiting on slow shards — a tight
        # deadline turns their keys into served defaults. Never under
        # the `reject` policy (degradation must not become failures).
        deadline = self._deadline_s
        if (self._missing != "reject"
                and qos.brownout_level() >= qos.DEGRADE):
            deadline = (self._brownout_deadline_s if deadline is None
                        else min(deadline, self._brownout_deadline_s))
        with tracing.child_span(
            "featurestore.join",
            entities=len(entries), groups=len(self._groups),
        ):
            for store, feats in self._groups:
                rows = store.multi_get(entries, deadline_s=deadline)
                for m, row in zip(merged, rows):
                    if row is None:
                        continue
                    m.update(
                        {k: v for k, v in row.items()
                         if not feats or k in feats}
                    )
        vectors: list[list[Any]] = []
        for entry, m in zip(entries, merged):
            vec: list[Any] = []
            for fname in self._order:
                if fname in m:
                    vec.append(m[fname])
                    continue
                self._m_missing.inc()
                if self._missing == "reject":
                    raise ValueError(
                        f"online feature {fname!r} missing for entity "
                        f"{entry!r} (missing-key policy: reject)"
                    )
                if self._missing == "default":
                    vec.append(self._defaults.get(fname, self._default_value))
                else:  # passthrough
                    vec.append(None)
            vectors.append(vec)
        self._m_join.observe(time.perf_counter() - t0)
        return vectors

    def predict(self, instances: list[Any]) -> list[Any]:
        t0 = time.perf_counter()
        vectors = self.join(instances)
        inner: Callable[[list[list[Any]]], list[Any]]
        inner = self._inner.predict if hasattr(self._inner, "predict") else self._inner
        preds = inner(vectors)
        self._m_request.observe(time.perf_counter() - t0)
        return preds

    def stop(self) -> None:
        """Close the stores and forward stop() to the wrapped predictor
        (the serving teardown path)."""
        for store, _ in self._groups:
            store.close()
        if hasattr(self._inner, "stop"):
            self._inner.stop()
