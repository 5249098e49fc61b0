"""Durable pubsub topics — the Kafka-surface equivalent
(a copy of ``hops_tpu/messaging/pubsub.py``: the module imports no JAX, and
the port imports nothing of the JAX package).

The reference used per-project SSL Kafka for inference logging and
streaming ingest, with broker discovery and an Avro schema registry
(``hops.kafka``: get_broker_endpoints / get_schema — KafkaPython.ipynb:
134,155; SURVEY.md §2.2). Here a topic is an append-only JSONL log under
the project's ``Topics`` dataset: producers append, consumers tail with
durable per-group offsets — the same at-least-once, replayable contract,
with no broker to operate. The storage backend rides the fs façade, so a
shared filesystem gives cross-host pubsub; a real broker can slot in
behind the same API later.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Iterator

from hops_tpu_torch.runtime import fs
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_lock = threading.Lock()

_m_consumer_lag = REGISTRY.gauge(
    "hops_tpu_pubsub_consumer_lag",
    "Bytes between a consumer group's offset and the topic end "
    "(0 = caught up), sampled at every poll",
    labels=("topic", "group"),
)
_m_poison = REGISTRY.counter(
    "hops_tpu_pubsub_poison_records_total",
    "Unparsable records skipped by consumers (corrupt on the wire or "
    "at rest); the offset keeps moving past them",
    labels=("topic",),
)
_m_replayed = REGISTRY.counter(
    "hops_tpu_pubsub_replayed_records_total",
    "Records re-delivered after a consumer restart because the previous "
    "incarnation died between delivery and its offset commit "
    "(at-least-once replay — downstream dedupe owns convergence)",
    labels=("topic", "group"),
)


def _topics_root() -> Path:
    p = Path(fs.project_path("Topics"))
    p.mkdir(parents=True, exist_ok=True)
    return p


def _topic_dir(name: str) -> Path:
    return _topics_root() / name


def create_topic(name: str, schema: dict[str, Any] | None = None) -> str:
    d = _topic_dir(name)
    d.mkdir(parents=True, exist_ok=True)
    (d / "log.jsonl").touch()
    if schema is not None:
        (d / "schema.json").write_text(json.dumps(schema, indent=2))
    return name


def topic_exists(name: str) -> bool:
    return (_topic_dir(name) / "log.jsonl").exists()


def list_topics() -> list[str]:
    return sorted(d.name for d in _topics_root().iterdir() if d.is_dir())


def get_schema(topic: str) -> dict[str, Any] | None:
    """Schema-registry lookup (reference: ``kafka.get_schema(topic)``)."""
    p = _topic_dir(topic) / "schema.json"
    return json.loads(p.read_text()) if p.exists() else None


def get_broker_endpoints() -> str:
    """Reference-parity discovery (``kafka.get_broker_endpoints``): the
    'broker' is the topics root on the shared filesystem."""
    return str(_topics_root())


def get_security_protocol() -> str:
    return "FS"  # filesystem-backed; TLS applies at the mount, not here


class Producer:
    def __init__(self, topic: str):
        if not topic_exists(topic):
            create_topic(topic)
        self._path = _topic_dir(topic) / "log.jsonl"

    def send(self, value: Any, key: str | None = None) -> None:
        from hops_tpu_torch.runtime import faultinject

        rec = {"ts": time.time(), "key": key, "value": value}
        line = (json.dumps(rec, default=str) + "\n").encode()
        # Chaos point: raise/delay a publish, or corrupt the encoded
        # record (consumers must survive an unparsable line).
        line = faultinject.fire_data("pubsub.publish", line)
        with _lock:
            with self._path.open("ab") as f:
                f.write(line)

    def flush(self) -> None:
        pass  # every send is durable


class Consumer:
    """Tailing consumer with a durable per-group offset.

    A committed group offset always resumes (that is what makes the
    group durable); ``from_beginning`` only chooses where a group
    WITHOUT a commit starts — byte 0 (catch up on history) or the
    current end (new records only). Kafka's ``auto.offset.reset``
    contract: a restarted write-through materializer must not replay
    the whole topic just because it was constructed replay-capable.
    """

    def __init__(self, topic: str, group: str = "default", from_beginning: bool = False):
        if not topic_exists(topic):
            create_topic(topic)
        self._topic = topic
        self._group = group
        self._log = _topic_dir(topic) / "log.jsonl"
        self._offset_file = _topic_dir(topic) / f"offset.{group}"
        # Delivered watermark: the highest offset this group has ever
        # POLLED (vs committed). A restart whose committed offset sits
        # below it is about to replay a span the previous incarnation
        # consumed but never committed — at-least-once by design, but
        # it must be VISIBLE (a silent whole-batch replay after a
        # mid-batch crash is indistinguishable from fresh data to
        # anything downstream without its own dedupe).
        self._delivered_file = _topic_dir(topic) / f"delivered.{group}"
        if self._offset_file.exists():
            self._offset = int(self._offset_file.read_text() or 0)
        else:
            self._offset = 0 if from_beginning else self._current_end()
        self._delivered = self._read_delivered()
        self._replay_end = 0
        self._replay_logged = False
        if self._delivered > self._offset:
            self._replay_end = self._delivered
        self._m_lag = _m_consumer_lag.labels(topic=topic, group=group)
        self._m_poison = _m_poison.labels(topic=topic)
        self._m_replayed = _m_replayed.labels(topic=topic, group=group)

    def _read_delivered(self) -> int:
        try:
            return int(self._delivered_file.read_text() or 0)
        except (OSError, ValueError):
            return 0

    def _current_end(self) -> int:
        return self._log.stat().st_size

    @property
    def offset(self) -> int:
        """Byte offset into the topic log; settable for external
        checkpointing (the streaming runner's checkpointLocation)."""
        return self._offset

    @offset.setter
    def offset(self, value: int) -> None:
        self._offset = int(value)

    def end_offset(self) -> int:
        """Current end of the topic log (bytes)."""
        return self._current_end()

    def lag(self) -> int:
        """Bytes between this group's offset and the topic end — 0 when
        caught up. The watermark check write-through materializers and
        streaming runners gate their drain on."""
        return max(0, self._current_end() - self._offset)

    def poll(self, max_records: int | None = None) -> list[dict[str, Any]]:
        return [rec for _, rec in self.poll_records(max_records)]

    def poll_records(
        self, max_records: int | None = None
    ) -> list[tuple[int, dict[str, Any]]]:
        """Like :meth:`poll`, but each record arrives with its starting
        byte offset in the topic log — the handle span ledgers and
        replay dedupe key on. A raised fault restores the pre-poll
        offset first, so a retried poll re-delivers the whole batch
        (at-least-once) instead of silently skipping the partial one.
        """
        from hops_tpu_torch.runtime import faultinject

        start = self._offset
        replayed_span: tuple[int, int] | None = None
        replayed = poisoned = 0
        out: list[tuple[int, dict[str, Any]]] = []
        try:
            with self._log.open("rb") as f:
                f.seek(self._offset)
                for line in f:
                    if not line.endswith(b"\n"):
                        break  # partial write in flight; retry next poll
                    at = self._offset
                    self._offset += len(line)
                    # Chaos point: per-record consumer-side faults —
                    # error/latency abort the poll (offset restored
                    # in the except arm, so a retried poll re-delivers
                    # the batch), corrupt mangles THIS record after the
                    # durable log, making a consumer-side poison record
                    # without damaging the topic.
                    line = faultinject.fire_data("pubsub.poll", line)
                    if at < self._replay_end:
                        replayed += 1
                        replayed_span = (
                            at if replayed_span is None else replayed_span[0],
                            self._offset,
                        )
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        # A corrupt record must not wedge the consumer
                        # at this offset forever: skip it, keep tailing.
                        poisoned += 1
                        log.warning("topic %s: skipping unparsable record "
                                    "at offset %d", self._topic, at)
                        continue
                    out.append((at, rec))
                    if max_records is not None and len(out) >= max_records:
                        break
        except Exception:
            # Counters stay untouched on the abort path: the retried
            # poll re-delivers (and re-counts) the same records.
            self._offset = start
            raise
        if replayed:
            self._m_replayed.inc(replayed)
        if poisoned:
            self._m_poison.inc(poisoned)
        if replayed_span is not None and not self._replay_logged:
            self._replay_logged = True
            log.warning(
                "topic %s group %s: replaying span [%d, %d) delivered "
                "before the last restart but never committed "
                "(at-least-once — downstream dedupe owns convergence)",
                self._topic, self._group, replayed_span[0], replayed_span[1],
            )
            from hops_tpu_torch.runtime import flight

            flight.record("span_replayed", topic=self._topic,
                          group=self._group, first=replayed_span[0],
                          last=replayed_span[1])
        if self._offset > self._delivered:
            self._delivered = self._offset
            try:
                self._delivered_file.write_text(str(self._delivered))
            except OSError as e:
                # Watermark persistence is best-effort visibility: a
                # failed write only costs replay DETECTION, never data.
                log.warning("topic %s: could not persist delivered "
                            "watermark: %s", self._topic, e)
        self._m_lag.set(max(0, self._current_end() - self._offset))
        return out

    def commit(self) -> None:
        self._offset_file.write_text(str(self._offset))

    def __iter__(self) -> Iterator[dict[str, Any]]:
        while True:
            batch = self.poll()
            if not batch:
                return
            yield from batch
