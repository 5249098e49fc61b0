"""The port's closed loop (``hops_tpu_torch.pipeline``) held to the JAX
package's: every scenario of ``tests/test_continuous.py`` — the span
ledger, the streaming source, replay visibility, the ``pubsub.poll``
fault, exactly-once under chaos, the eval gate and cutover, the trainer
SIGKILLed mid-span (its driver script runs the package under test), the
serving leg with a replica killed mid-cutover, and the bench tier — runs
through both packages in this process, each in its own workspace (the
harness of ``tests/test_torch_fleet.py``). Then a small LM trains
through ``run_continuous`` in both packages, and an in-place torch train
step checks that a cutover exports the parameters its gate judged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hops_tpu.featurestore.loader import StreamingSource as j_StreamingSource
from hops_tpu.featurestore.online_serving import Materializer as j_Materializer
from hops_tpu.featurestore.online_serving import ShardedOnlineStore as j_ShardedOnlineStore
from hops_tpu.messaging import pubsub as j_pubsub
from hops_tpu.modelrepo import fleet as j_fleet
from hops_tpu.modelrepo import registry as j_registry
from hops_tpu.modelrepo import serving as j_serving
from hops_tpu.modelrepo.fleet.autoscale import AutoscalePolicy as j_AutoscalePolicy
from hops_tpu.pipeline import continuous as j_continuous
from hops_tpu.runtime import faultinject as j_faultinject
from hops_tpu.runtime import flight as j_flight
from hops_tpu.runtime.preemption import PreemptionGuard as j_PreemptionGuard
from hops_tpu.runtime.resilience import RetryPolicy as j_RetryPolicy
from hops_tpu.telemetry.metrics import REGISTRY as j_REGISTRY

from hops_tpu_torch.featurestore.loader import StreamingSource as t_StreamingSource
from hops_tpu_torch.models import convert
from hops_tpu_torch.models.common import TrainState, cross_entropy_loss
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
from hops_tpu_torch.featurestore.online_serving import Materializer as t_Materializer
from hops_tpu_torch.featurestore.online_serving import ShardedOnlineStore as t_ShardedOnlineStore
from hops_tpu_torch.messaging import pubsub as t_pubsub
from hops_tpu_torch.modelrepo import fleet as t_fleet
from hops_tpu_torch.modelrepo import registry as t_registry
from hops_tpu_torch.modelrepo import serving as t_serving
from hops_tpu_torch.modelrepo.fleet.autoscale import AutoscalePolicy as t_AutoscalePolicy
from hops_tpu_torch.pipeline import continuous as t_continuous
from hops_tpu_torch.runtime import faultinject as t_faultinject
from hops_tpu_torch.runtime import flight as t_flight
from hops_tpu_torch.runtime.preemption import PreemptionGuard as t_PreemptionGuard
from hops_tpu_torch.runtime.resilience import RetryPolicy as t_RetryPolicy
from hops_tpu_torch.telemetry.metrics import REGISTRY as t_REGISTRY
from test_torch_fleet import bench_tier, in_both


def _names(source, materializer, store, pubsub, fleet, registry, serving,
           policy, cont, faultinject, flight, guard, retry, metrics) -> dict:
    return dict(
        StreamingSource=source, Materializer=materializer,
        ShardedOnlineStore=store, pubsub=pubsub, fleet=fleet,
        registry=registry, serving=serving, AutoscalePolicy=policy,
        continuous=cont, RegistryFleetPublisher=cont.RegistryFleetPublisher,
        SpanEntry=cont.SpanEntry, SpanLedger=cont.SpanLedger,
        SpanStream=cont.SpanStream,
        collate_column_batch=cont.collate_column_batch,
        run_continuous=cont.run_continuous, faultinject=faultinject,
        flight=flight, PreemptionGuard=guard, RetryPolicy=retry,
        REGISTRY=metrics)


NAMES = {
    "jax": _names(j_StreamingSource, j_Materializer, j_ShardedOnlineStore,
                  j_pubsub, j_fleet, j_registry, j_serving, j_AutoscalePolicy,
                  j_continuous, j_faultinject, j_flight, j_PreemptionGuard,
                  j_RetryPolicy, j_REGISTRY),
    "torch": _names(t_StreamingSource, t_Materializer, t_ShardedOnlineStore,
                    t_pubsub, t_fleet, t_registry, t_serving, t_AutoscalePolicy,
                    t_continuous, t_faultinject, t_flight, t_PreemptionGuard,
                    t_RetryPolicy, t_REGISTRY),
}
# Bound per run by the harness; these module values only serve linters.
globals().update(NAMES["torch"])
PKG = "hops_tpu_torch"


def _counter(name: str, **labels) -> float:
    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    try:
        return metric.value(**labels)
    except Exception:  # label child not created yet
        return 0.0


def _account(verified: dict) -> dict:
    """A ledger's account without its byte offsets: records carry the
    producer's timestamps, so the two packages' topic logs differ in
    length."""
    return {k: v for k, v in verified.items() if k not in ("start", "end")}


def _publish(topic: str, n: int, start: int = 0) -> None:
    producer = pubsub.Producer(topic)
    for i in range(start, start + n):
        producer.send({"x": [float(i)] * 2, "seq": i})


def _train_step(state, batch):
    return (
        {"w": state["w"] + batch["x"].sum(axis=0),
         "n": np.asarray(state["n"] + len(batch["seq"]))},
        {"rows": float(len(batch["seq"]))},
    )


def _fresh_state():
    return {"w": np.zeros(2, np.float64), "n": np.asarray(0)}


def _stream(topic: str, directory, group: str = "trainer", **kw) -> SpanStream:
    kw.setdefault("collate", collate_column_batch(["x", "seq"]))
    kw.setdefault("min_records", 4)
    kw.setdefault("max_records", 8)
    kw.setdefault("eval_every", 3)
    kw.setdefault("stop_on_idle", True)
    kw.setdefault("idle_grace_s", 0.3)
    src = StreamingSource(topic, group=group, from_beginning=True)
    return SpanStream(src, directory, **kw)


# -- the span ledger -----------------------------------------------------------


@in_both
class TestSpanLedger:
    def test_append_covered_and_accounting(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(0, 100, 3, 0), SpanEntry(100, 250, 4, 1)])
        assert led.end_offset() == 250 and led.start_offset() == 0
        assert led.covered(0) and led.covered(99) and led.covered(249)
        assert not led.covered(250)
        assert led.records_total() == 7
        v = led.verify()
        assert v["contiguous"] and v["disjoint"] and v["steps_monotonic"]
        # A reader against the same file sees the identical account.
        assert SpanLedger(tmp_path).verify() == v
        return v

    def test_append_rejects_gap_or_overlap(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(0, 100, 3, 0)])
        with pytest.raises(ValueError):
            led.append([SpanEntry(150, 200, 1, 1)])  # gap
        with pytest.raises(ValueError):
            led.append([SpanEntry(50, 200, 1, 1)])  # overlap

    def test_truncate_to_step_drops_orphans_durably(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(0, 100, 3, 0), SpanEntry(100, 200, 3, 1),
                    SpanEntry(200, 300, 3, 2)])
        assert led.truncate_to_step(1) == 1
        assert led.end_offset() == 200
        # Durable: a fresh load sees the truncated account.
        assert SpanLedger(tmp_path).end_offset() == 200
        # Replayed span re-appends exactly once.
        led.append([SpanEntry(200, 300, 3, 2)])
        v = SpanLedger(tmp_path).verify()
        assert v["entries"] == 3 and v["contiguous"] and v["disjoint"]
        return v

    def test_torn_tail_truncated_on_load(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(0, 100, 3, 0)])
        with led.path.open("ab") as f:
            f.write(b'{"first": 100, "last": 2')  # died mid-append
        reloaded = SpanLedger(tmp_path)
        assert len(reloaded) == 1 and reloaded.end_offset() == 100
        # The file itself was repaired: a third load parses cleanly.
        assert len(SpanLedger(tmp_path)) == 1

    def test_compaction_folds_history_into_base(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(i * 100, (i + 1) * 100, 2, i)
                    for i in range(10)])
        folded = led.compact(up_to_step=7, retain_entries=2)
        assert folded == 8
        assert len(led) == 2  # live lines capped
        assert led.base is not None
        assert led.base.first == 0 and led.base.last == 800
        # The account is unchanged across the fold.
        assert led.start_offset() == 0 and led.end_offset() == 1000
        assert led.records_total() == 20
        assert led.covered(0) and led.covered(799) and led.covered(950)
        assert not led.covered(1000)
        v = led.verify()
        assert v["contiguous"] and v["disjoint"] and v["steps_monotonic"]
        assert v["compacted_entries"] == 8 and v["entries"] == 2
        # Appends keep tiling from the live end.
        led.append([SpanEntry(1000, 1100, 1, 10)])
        assert led.verify()["contiguous"]
        return led.verify(), led.path.read_text()

    def test_compaction_is_durable_and_idempotent(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(i * 10, (i + 1) * 10, 1, i) for i in range(6)])
        led.compact(up_to_step=3, retain_entries=0)
        reloaded = SpanLedger(tmp_path)
        assert reloaded.base is not None and reloaded.base.last == 40
        assert reloaded.verify() == led.verify()
        # A second fold merges INTO the existing base.
        reloaded.append([SpanEntry(60, 70, 1, 6)])
        reloaded.compact(up_to_step=6, retain_entries=0)
        again = SpanLedger(tmp_path)
        assert again.base.first == 0 and again.base.last == 70
        assert again.records_total() == 7
        assert again.verify()["contiguous"]
        # Nothing foldable -> no-op, same file.
        assert again.compact(up_to_step=6) == 0
        return again.verify(), again.path.read_text()

    def test_verify_proves_contiguity_across_the_fold_boundary(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(0, 100, 1, 0), SpanEntry(100, 200, 1, 1),
                    SpanEntry(200, 300, 1, 2)])
        led.compact(up_to_step=1, retain_entries=0)
        assert led.verify()["contiguous"]
        # Corrupt the boundary on disk: the retained entry no longer
        # continues at the base's end — verify must SEE it.
        lines = led.path.read_text().splitlines()
        import json as _json
        base_line = _json.loads(lines[0])
        base_line["last"] = 150  # lie about the folded range
        led.path.write_text(
            _json.dumps(base_line) + "\n" + "\n".join(lines[1:]) + "\n")
        v = SpanLedger(tmp_path).verify()
        assert not v["contiguous"]

    def test_truncate_above_base_works_below_base_clamps(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(i * 10, (i + 1) * 10, 1, i) for i in range(8)])
        led.compact(up_to_step=3, retain_entries=0)  # base covers steps 0-3
        assert led.truncate_to_step(5) == 2  # steps 6,7 drop normally
        assert led.end_offset() == 60
        # A restore BEHIND the fold cannot un-fold: the ledger keeps
        # the base (shouting) and resumes from its boundary.
        assert led.truncate_to_step(1) == 2
        assert led.base is not None and led.end_offset() == 40
        assert SpanLedger(tmp_path).end_offset() == 40
        return led.verify()

    def test_reset_discards_the_base_too(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(0, 100, 1, 0), SpanEntry(100, 200, 1, 1)])
        led.compact(up_to_step=0, retain_entries=0)
        led.reset()
        assert led.base is None and len(led) == 0
        assert led.start_offset() is None
        assert not led.path.exists()

    def test_stream_auto_compacts_past_threshold(self, tmp_path):
        led = SpanLedger(tmp_path)
        led.append([SpanEntry(i, i + 1, 1, i) for i in range(50)])
        led.compact(up_to_step=30, retain_entries=4)
        # The ledger is bounded: folded history is one line, live tail
        # stays small, and the whole account still proves out.
        raw_lines = led.path.read_text().splitlines()
        assert len(raw_lines) == 1 + len(led)
        assert led.verify()["contiguous"] and led.records_total() == 50

    def test_verify_flags_noncontiguous_history(self, tmp_path):
        p = tmp_path / "span_ledger.jsonl"
        p.write_text(
            '{"first":0,"last":100,"records":3,"step":0}\n'
            '{"first":150,"last":200,"records":1,"step":1}\n')
        v = SpanLedger(tmp_path).verify()
        assert not v["contiguous"] and v["disjoint"]


# -- streaming source ----------------------------------------------------------


@in_both
class TestStreamingSource:
    def test_poll_span_offsets_watermark_and_lag(self, workspace):
        pubsub.create_topic("s1")
        _publish("s1", 6)
        src = StreamingSource("s1", group="g", from_beginning=True)
        span = src.poll_span(max_records=4)
        assert span.records == 4 and span.first == 0
        assert span.offsets[0] == 0 and len(span.offsets) == 4
        assert span.last == src.offset
        assert span.watermark > 0 and src.watermark_lag_s() < 60
        rest = src.poll_span()
        assert rest.first == span.last and rest.records == 2
        assert src.lag() == 0
        assert src.poll_span() is None
        return span.records, rest.records, [v["seq"] for v in span.values]

    def test_decode_poison_skipped_and_counted(self, workspace):
        pubsub.create_topic("s2")
        _publish("s2", 3)

        def decode(value):
            if value["seq"] == 1:
                raise ValueError("poison")
            return value

        src = StreamingSource("s2", group="g", decode=decode,
                              from_beginning=True, name="s2")
        span = src.poll_span()
        assert [v["seq"] for v in span.values] == [0, 2]
        # The span's byte range still covers the poisoned record, so
        # ledger coverage stays contiguous.
        assert span.first == 0 and span.last == src.offset
        assert _counter("hops_tpu_streaming_poison_decodes_total",
                        stream="s2") >= 1


# -- consumer replay visibility (satellite: mid-batch kill) --------------------


@in_both
class TestConsumerReplayVisibility:
    def test_mid_batch_kill_replays_with_visibility(self, workspace):
        pubsub.create_topic("r1")
        _publish("r1", 5)
        c1 = pubsub.Consumer("r1", group="g", from_beginning=True)
        assert len(c1.poll_records(3)) == 3
        # Crash here: the batch was delivered (and maybe flushed
        # downstream) but the offset never committed. A restarted
        # consumer replays it — and must SAY so.
        base = flight.FLIGHT.seq
        replayed0 = _counter("hops_tpu_pubsub_replayed_records_total",
                             topic="r1", group="g")
        c2 = pubsub.Consumer("r1", group="g", from_beginning=True)
        recs = c2.poll_records()
        assert len(recs) == 5  # full replay from byte 0
        assert _counter("hops_tpu_pubsub_replayed_records_total",
                        topic="r1", group="g") == replayed0 + 3
        # The replayed span is on the record (WARNING log + the flight
        # ring — the hops_tpu logger does not propagate to caplog, so
        # the flight event is the assertable surface) with its
        # first/last offsets.
        events = [e for e in flight.FLIGHT.events(kind="span_replayed",
                                                  after_seq=base)
                  if e["data"].get("topic") == "r1"]
        assert events and events[0]["data"]["first"] == 0
        assert events[0]["data"]["last"] > 0

    def test_committed_offset_resume_replays_nothing(self, workspace):
        pubsub.create_topic("r2")
        _publish("r2", 4)
        c1 = pubsub.Consumer("r2", group="g", from_beginning=True)
        c1.poll()
        c1.commit()
        replayed0 = _counter("hops_tpu_pubsub_replayed_records_total",
                             topic="r2", group="g")
        _publish("r2", 2, start=4)
        c2 = pubsub.Consumer("r2", group="g", from_beginning=True)
        assert [r["value"]["seq"] for _, r in c2.poll_records()] == [4, 5]
        assert _counter("hops_tpu_pubsub_replayed_records_total",
                        topic="r2", group="g") == replayed0


# -- the pubsub.poll fault point (satellite) -----------------------------------


@in_both
class TestPubsubPollFault:
    def test_error_fault_restores_offset_for_retry(self, workspace):
        pubsub.create_topic("f1")
        _publish("f1", 3)
        c = pubsub.Consumer("f1", group="g", from_beginning=True)
        faultinject.arm("pubsub.poll=error:OSError@times=1,after=1")
        with pytest.raises(OSError):
            c.poll_records()
        faultinject.disarm()
        # The aborted poll restored its offset: the retry re-delivers
        # the WHOLE batch (at-least-once), nothing skipped.
        assert [r["value"]["seq"] for _, r in c.poll_records()] == [0, 1, 2]

    def test_corrupt_fault_is_consumer_side_only(self, workspace):
        pubsub.create_topic("f2")
        _publish("f2", 3)
        poison0 = _counter("hops_tpu_pubsub_poison_records_total", topic="f2")
        c = pubsub.Consumer("f2", group="victim", from_beginning=True)
        faultinject.arm("pubsub.poll=corrupt@times=1")
        seqs = [r["value"]["seq"] for _, r in c.poll_records()]
        faultinject.disarm()
        assert seqs == [1, 2]  # record 0 poisoned on the consumer side
        assert _counter("hops_tpu_pubsub_poison_records_total",
                        topic="f2") == poison0 + 1
        # The durable topic is untouched: a fresh group reads all 3.
        c2 = pubsub.Consumer("f2", group="fresh", from_beginning=True)
        assert [r["value"]["seq"] for _, r in c2.poll_records()] == [0, 1, 2]

    def test_lag_gauge_sampled_at_poll(self, workspace):
        pubsub.create_topic("f3")
        _publish("f3", 2)
        c = pubsub.Consumer("f3", group="g", from_beginning=True)
        c.poll()
        assert REGISTRY.get("hops_tpu_pubsub_consumer_lag").value(
            topic="f3", group="g") == 0.0
        _publish("f3", 2, start=2)
        assert c.lag() > 0  # gauge refreshes at the next poll


# -- the span stream + continuous loop -----------------------------------------


@in_both
class TestContinuousExactlyOnce:
    def test_chaos_run_matches_fault_free_run(self, workspace, tmp_path):
        """The fast-tier headline: one poisoned record on the wire, a
        consumer-side poll fault mid-run, and a corrupt newest
        checkpoint at recovery — the loop converges to the byte-exact
        fault-free state with an exactly-once ledger."""
        topic = "cl-chaos"
        pubsub.create_topic(topic)
        producer = pubsub.Producer(topic)
        faultinject.arm("pubsub.publish=corrupt@times=1,after=9")
        for i in range(32):
            producer.send({"x": [float(i)] * 2, "seq": i})
        faultinject.disarm()

        ref = run_continuous(
            _train_step, _fresh_state(),
            _stream(topic, tmp_path / "ref", group="ref"),
            directory=str(tmp_path / "ref"), eval_fn=lambda s: float(s["n"]),
            save_every=2, guard=PreemptionGuard(install=False))
        assert ref.ledger["records"] == 31  # the poisoned record is lost

        faultinject.arm("pubsub.poll=error:OSError@times=1,after=12;"
                        "checkpoint.restore=corrupt@times=1")
        res = run_continuous(
            _train_step, _fresh_state(),
            _stream(topic, tmp_path / "chaos", group="chaos"),
            directory=str(tmp_path / "chaos"),
            eval_fn=lambda s: float(s["n"]), save_every=2,
            max_recoveries=4,
            recovery_policy=RetryPolicy(base_delay_s=0.01, seed=0),
            guard=PreemptionGuard(install=False))
        faultinject.disarm()

        np.testing.assert_array_equal(res.state["w"], ref.state["w"])
        assert int(res.state["n"]) == int(ref.state["n"]) == 31
        assert res.recoveries >= 1
        for v in (res.ledger, ref.ledger):
            assert v["contiguous"] and v["disjoint"] and v["steps_monotonic"]
            assert v["records"] == 31
        assert res.ledger["end"] == ref.ledger["end"]
        return (np.asarray(res.state["w"]).tolist(), int(res.state["n"]),
                _account(res.ledger), [(g["step"], g["metric"], g["outcome"])
                             for g in res.gates])

    def test_ledger_dedupes_replayed_offsets(self, workspace, tmp_path):
        """Crash between ledger flush and... anything that rewinds the
        consumer below the committed coverage: the covered records are
        deduped (never re-trained), visible on the counter and the
        flight ring."""
        topic = "cl-dedupe"
        pubsub.create_topic(topic)
        _publish(topic, 8)
        stream = _stream(topic, tmp_path, min_records=4, max_records=4)
        stream(0)
        batch = next(stream)
        assert [int(s) for s in batch["seq"]] == [0, 1, 2, 3]
        stream.state_dict()  # flush + commit: records 0-3 are covered
        base = flight.FLIGHT.seq
        deduped0 = _counter("hops_tpu_continuous_records_total",
                            result="deduped")
        stream.source.offset = 0  # the replay, worst case: from byte 0
        batch2 = next(stream)
        # Only fresh records trained; the covered prefix was deduped.
        assert [int(s) for s in batch2["seq"]] == [4, 5, 6, 7]
        assert _counter("hops_tpu_continuous_records_total",
                        result="deduped") == deduped0 + 4
        assert flight.FLIGHT.events(kind="span_replayed", after_seq=base)
        stream.state_dict()
        v = stream.ledger.verify()
        assert v["records"] == 8 and v["contiguous"] and v["disjoint"]
        return _account(v)

    def test_corrupt_record_at_poll_boundary_keeps_coverage(
            self, workspace, tmp_path):
        """Regression: a corrupt record landing exactly at a poll
        boundary (the consumer skips it BEFORE any record parses) used
        to leave its bytes outside the next entry's range and wedge the
        loop on the ledger's contiguity check. Entries start at the
        coverage cursor now — poison bytes stay covered."""
        topic = "cl-boundary"
        pubsub.create_topic(topic)
        _publish(topic, 4)
        stream = _stream(topic, tmp_path, min_records=4, max_records=4)
        stream(0)
        next(stream)
        stream.state_dict()  # coverage committed exactly at the boundary
        producer = pubsub.Producer(topic)
        faultinject.arm("pubsub.publish=corrupt@times=1")
        producer.send({"x": [9.0, 9.0], "seq": 99})  # head of next poll
        faultinject.disarm()
        _publish(topic, 4, start=4)
        batch = next(stream)  # must not raise / wedge
        assert [int(s) for s in batch["seq"]] == [4, 5, 6, 7]
        stream.state_dict()
        v = stream.ledger.verify()
        assert v["contiguous"] and v["disjoint"]
        # Every consumed byte — the poisoned record's included — is
        # inside the covered range.
        records = _topic_records(topic)
        assert v["end"] == records[-1]["offset"] + records[-1]["length"]
        assert v["records"] == 8  # 4 + 4 valid; the poison trained nothing
        return _account(v)

    def test_resume_across_processes_shaped_by_ledger(self, workspace,
                                                     tmp_path):
        """Same directory, two sequential stream incarnations (the
        restarted-trainer shape, minus the SIGKILL): the second resumes
        at the committed coverage and trains only the tail."""
        topic = "cl-resume"
        pubsub.create_topic(topic)
        _publish(topic, 12)
        r1 = run_continuous(
            _train_step, _fresh_state(),
            _stream(topic, tmp_path, max_records=4, min_records=4,
                    max_steps=2),
            directory=str(tmp_path), eval_fn=None, save_every=1,
            guard=PreemptionGuard(install=False))
        assert r1.steps == 2 and r1.ledger["records"] == 8
        r2 = run_continuous(
            _train_step, _fresh_state(),
            _stream(topic, tmp_path, max_records=4, min_records=4),
            directory=str(tmp_path), eval_fn=None, save_every=1,
            guard=PreemptionGuard(install=False))
        assert int(r2.state["n"]) == 12  # restored 8 + trained 4
        v = r2.ledger
        assert v["records"] == 12 and v["contiguous"] and v["disjoint"]
        return _account(v), np.asarray(r2.state["w"]).tolist()


@in_both
class TestEvalGateAndCutover:
    def test_regressed_candidate_never_published(self, workspace, tmp_path):
        topic = "cl-gate"
        pubsub.create_topic(topic)
        _publish(topic, 36)
        published = []

        def export_fn(state, step, metric):
            published.append((step, metric))
            return {"version": len(published)}

        gates = []

        def eval_fn(state):
            gates.append(1)
            return -1.0 if len(gates) == 2 else float(state["n"])

        base = flight.FLIGHT.seq
        res = run_continuous(
            _train_step, _fresh_state(), _stream(topic, tmp_path),
            directory=str(tmp_path), eval_fn=eval_fn, save_every=2,
            publisher=RegistryFleetPublisher("m", export_fn),
            guard=PreemptionGuard(install=False))
        outcomes = [g["outcome"] for g in res.gates]
        assert outcomes.count("fail") == 1 and outcomes[1] == "fail"
        # The regressed candidate was held back; every pass published.
        assert len(published) == outcomes.count("pass")
        assert len(res.cutovers) == len(published)
        assert all(c["outcome"] == "pushed" for c in res.cutovers)
        events = flight.FLIGHT.events(after_seq=base)
        gate_events = [e for e in events if e["kind"] == "eval_gate"]
        cut_events = [e for e in events if e["kind"] == "cutover"]
        assert [e["data"]["outcome"] for e in gate_events] == outcomes
        assert len(cut_events) == len(published)
        assert _counter("hops_tpu_continuous_eval_gates_total",
                        outcome="fail") >= 1
        return res.gates and [(g["step"], g["metric"], g["outcome"], g["best"])
                              for g in res.gates], published, res.cutovers

    def test_rolled_back_cutover_keeps_the_bar(self, workspace, tmp_path):
        """A candidate that passes eval but is rolled back by the
        canary (breaker trip) must NOT become the comparison bar —
        the next candidate is judged against the incumbent."""
        topic = "cl-bar"
        pubsub.create_topic(topic)
        _publish(topic, 72)  # 9 full spans -> gates at steps 3, 6, 9
        rollouts = []

        class _FlakyFleet:
            def roll_out(self, version, **kw):
                rollouts.append(version)
                outcome = ("rolled_back" if len(rollouts) == 2
                           else "completed")
                return {"outcome": outcome, "version": version,
                        "duration_s": 0.0}

        res = run_continuous(
            _train_step, _fresh_state(), _stream(topic, tmp_path),
            directory=str(tmp_path), eval_fn=lambda s: float(s["n"]),
            save_every=2,
            publisher=RegistryFleetPublisher(
                "m", lambda s, st, m: {"version": st}, fleet=_FlakyFleet()),
            guard=PreemptionGuard(install=False))
        # Gate 2's metric was higher than gate 1's, but its rollout
        # rolled back — so gate 3 is judged against gate 1's bar (and
        # passes, since the metric is monotone).
        assert [c["outcome"] for c in res.cutovers][:3] == [
            "completed", "rolled_back", "completed"]
        return [(c["step"], c["outcome"]) for c in res.cutovers]

    def test_tolerated_candidate_does_not_lower_the_bar(self, workspace,
                                                        tmp_path):
        """Regression: min_delta tolerates a slightly-worse candidate,
        but accepting it must not RATCHET the bar down — a model
        regressing by less than min_delta per gate has to hit the gate
        once the cumulative slide exceeds the tolerance."""
        topic = "cl-ratchet"
        pubsub.create_topic(topic)
        _publish(topic, 72)  # gates at steps 3, 6, 9
        metrics = iter([10.0, 9.98, 9.93])
        res = run_continuous(
            _train_step, _fresh_state(), _stream(topic, tmp_path),
            directory=str(tmp_path), eval_fn=lambda s: next(metrics),
            min_delta=0.05, save_every=2,
            guard=PreemptionGuard(install=False))
        outcomes = [g["outcome"] for g in res.gates]
        # 9.98 is tolerated (within 0.05 of the bar 10.0) but the bar
        # STAYS 10.0, so the cumulative slide to 9.93 fails.
        assert outcomes == ["pass", "pass", "fail"]
        assert res.gates[2]["best"] == 10.0
        return [(g["step"], g["metric"], g["outcome"], g["best"])
                for g in res.gates]

    def test_preemption_notice_stops_and_resumes(self, workspace, tmp_path):
        topic = "cl-preempt"
        pubsub.create_topic(topic)
        _publish(topic, 24)
        guard = PreemptionGuard(install=False)
        steps = []

        def noticing_step(state, batch):
            steps.append(1)
            if len(steps) == 2:
                guard.notice()
            return _train_step(state, batch)

        r1 = run_continuous(
            noticing_step, _fresh_state(),
            _stream(topic, tmp_path, min_records=4, max_records=4),
            directory=str(tmp_path), eval_fn=None, save_every=1, guard=guard)
        assert r1.steps <= 3  # stopped at a step boundary, checkpointed
        r2 = run_continuous(
            _train_step, _fresh_state(),
            _stream(topic, tmp_path, min_records=4, max_records=4),
            directory=str(tmp_path), eval_fn=None, save_every=1,
            guard=PreemptionGuard(install=False))
        assert int(r2.state["n"]) == 24
        v = r2.ledger
        assert v["records"] == 24 and v["contiguous"] and v["disjoint"]
        return _account(v)


# -- the slow-tier chaos e2e ---------------------------------------------------


_DRIVER = """\
import json, sys, time
import numpy as np
from hops_tpu.featurestore.loader import StreamingSource
from hops_tpu.pipeline import continuous as C
from hops_tpu.runtime.preemption import PreemptionGuard
from hops_tpu.runtime.resilience import RetryPolicy

out, ckdir, topic = sys.argv[1], sys.argv[2], sys.argv[3]
src = StreamingSource(topic, group="chaos-trainer", from_beginning=True)
stream = C.SpanStream(
    src, ckdir, collate=C.collate_column_batch(["x", "seq"]),
    min_records=4, max_records=4, eval_every=4,
    stop_on_idle=True, idle_grace_s=0.5)

def train_step(state, batch):
    time.sleep(0.03)  # slow enough for the parent to SIGKILL mid-span
    return ({"w": state["w"] + batch["x"].sum(axis=0),
             "n": np.asarray(state["n"] + len(batch["seq"]))}, {})

res = C.run_continuous(
    train_step, {"w": np.zeros(2), "n": np.asarray(0)}, stream,
    directory=ckdir, eval_fn=lambda s: float(s["n"]), save_every=2,
    max_recoveries=4, recovery_policy=RetryPolicy(base_delay_s=0.01, seed=0),
    guard=PreemptionGuard(install=False))
json.dump({"n": int(res.state["n"]), "w": [float(v) for v in res.state["w"]],
           "steps": res.steps, "ledger": res.ledger,
           "gates": len(res.gates)}, open(out, "w"))
"""


def _topic_records(topic: str) -> list[dict]:
    """Ground truth straight from the topic log: every record's byte
    offset, length, and (when parseable) payload."""
    log_path = Path(pubsub._topic_dir(topic)) / "log.jsonl"
    out = []
    offset = 0
    with log_path.open("rb") as f:
        for line in f:
            rec = {"offset": offset, "length": len(line), "valid": True}
            try:
                rec["value"] = json.loads(line)["value"]
            except ValueError:
                rec["valid"] = False
            out.append(rec)
            offset += len(line)
    return out


@in_both
class TestContinuousChaosE2E:
    def test_trainer_sigkilled_mid_span_exactly_once(
            self, workspace, tmp_path):
        """The headline kill test: broker faults + a corrupt record on
        the wire + SIGKILL of the trainer process mid-span. The
        restarted trainer resumes from the ledger; the final account
        covers every published byte exactly once and the state equals
        the sum of every valid record — nothing lost, nothing trained
        twice."""
        topic = "chaos-e2e"
        pubsub.create_topic(topic)
        producer = pubsub.Producer(topic)
        faultinject.arm("pubsub.publish=corrupt@times=1,after=17")
        for i in range(60):
            producer.send({"x": [float(i)] * 2, "seq": i})
        faultinject.disarm()

        ckdir = tmp_path / "ck"
        outfile = tmp_path / "result.json"
        repo = Path(__file__).resolve().parents[1]
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
        # The child resolves the shared workspace from the environment;
        # the project name must ride along too or it tails an empty
        # topic in a different project dir.
        env["HOPS_TPU_PROJECT"] = "testproj"
        # Broker faults inside the trainer: a transient consumer-side
        # poll error, survived by the supervisor.
        env["HOPS_TPU_FAULTS"] = "pubsub.poll=error:OSError@times=1,after=6"
        args = [sys.executable, str(tmp_path / "driver.py"),
                str(outfile), str(ckdir), topic]
        (tmp_path / "driver.py").write_text(
            _DRIVER.replace("hops_tpu.", f"{PKG}."))

        # Incarnation 1: let it make durable progress, then SIGKILL —
        # no goodbye, mid-span by construction (steps take ~30ms and
        # kills land between manifest flushes).
        p1 = subprocess.Popen(args, env=env, cwd=str(tmp_path))
        deadline = time.monotonic() + 120
        try:
            while time.monotonic() < deadline:
                if list(ckdir.glob("manifest_*.json")) and \
                        (ckdir / "span_ledger.jsonl").exists():
                    break
                if p1.poll() is not None:
                    pytest.fail("trainer exited before it could be killed")
                time.sleep(0.02)
            time.sleep(0.2)  # strictly inside a later span
            p1.send_signal(signal.SIGKILL)
        finally:
            p1.wait(timeout=30)
        assert not outfile.exists()  # it really died mid-run

        # Incarnation 2: resumes from the ledger, drains, reports.
        # PR 8's write-through tails the SAME topic in parallel — the
        # online features must end in sync with what the model trained
        # on (the loop's serving-side feature freshness contract).

        store = ShardedOnlineStore("chaosfeat", 1, primary_key=["seq"],
                                   shards=2)
        daemon = Materializer(store, topic, group="chaos-online").start()
        p2 = subprocess.run(args, env=env, cwd=str(tmp_path), timeout=300)
        assert p2.returncode == 0 and outfile.exists()
        result = json.loads(outfile.read_text())

        records = _topic_records(topic)
        valid = [r for r in records if r["valid"]]
        assert len(valid) == 59  # exactly one record corrupted on the wire

        # Write-through in sync: every trained record's features are
        # online (the poisoned record is lost to BOTH consumers).
        assert daemon.drain(30.0)
        daemon.stop()
        assert store.count() == len(valid)
        assert store.get({"seq": valid[0]["value"]["seq"]}) is not None
        store.close()

        # Exactly-once, audited against the topic's real offsets:
        led = result["ledger"]
        assert led["contiguous"] and led["disjoint"] and \
            led["steps_monotonic"]
        assert led["start"] == 0
        assert led["end"] == records[-1]["offset"] + records[-1]["length"]
        assert led["records"] == len(valid)
        ledger = SpanLedger(ckdir)
        for r in valid:
            hits = [e for e in ledger.entries
                    if e.first <= r["offset"] < e.last]
            assert len(hits) == 1, r
        # ... and from the model state: the sum of every valid record,
        # applied exactly once.
        assert result["n"] == len(valid)
        expected = float(sum(r["value"]["seq"] for r in valid))
        assert result["w"] == [expected, expected]
        assert result["gates"] >= 2
        return result["n"], result["w"], led["records"]

    def test_serving_leg_replica_killed_mid_cutover_zero_errors(
            self, workspace, tmp_path):
        """The serving half: continuous training publishes passing
        candidates into a live fleet under client load, one gate is
        poisoned (the regressed candidate must never be served), and a
        replica is KILLED while a cutover rollout is in flight — with
        zero client-visible failures throughout."""

        topic = "cl-serve"
        pubsub.create_topic(topic)

        def export_version(state, step, metric):
            art = tmp_path / f"art_{step}"
            art.mkdir()
            w = [float(v) for v in state["w"]]
            (art / "p.py").write_text(
                f"_W = {w!r}\n"
                f"_STEP = {step}\n"
                "class Predict:\n"
                "    def predict(self, instances):\n"
                "        return [[sum(w * x for w, x in zip(_W, v)),"
                " _STEP] for v in instances]\n")
            return registry.export(art, "contserve",
                                   metrics={"eval": metric})

        meta0 = export_version(_fresh_state(), 0, 0.0)
        serving.create_or_update("contserve", model_name="contserve",
                                 model_version=meta0["version"],
                                 model_server="PYTHON")
        _publish(topic, 54)

        gates = []

        def eval_fn(state):
            gates.append(1)
            return -1.0 if len(gates) == 2 else float(state["n"])

        errors: list = []
        served_steps: set[int] = set()
        stop_load = threading.Event()
        rollout_started = threading.Event()
        policy = AutoscalePolicy(min_replicas=2, max_replicas=4,
                                 target_load=50.0)  # heal-only band
        with fleet.start_fleet("contserve", 2, inprocess=True,
                               scrape_interval_s=0.05, autoscale=policy,
                               autoscale_interval_s=0.05) as f:

            def client():
                while not stop_load.is_set():
                    try:
                        out = f.predict([[1.0, 1.0]], timeout_s=30.0)
                        served_steps.add(int(out["predictions"][0][1]))
                    except Exception as e:  # noqa: BLE001 — the assertion
                        errors.append(e)

            threads = [threading.Thread(target=client, daemon=True)
                       for _ in range(3)]
            for t in threads:
                t.start()

            class _KilledFleet:
                """First cutover: SIGKILL a ready replica mid-rollout
                (the rollout's replacement/heal machinery owns it)."""

                def roll_out(self, version, **kw):
                    first = not rollout_started.is_set()
                    rollout_started.set()
                    if first:
                        victim = f.manager.ready()[0]
                        killer = threading.Timer(
                            0.05, lambda: f.manager.kill(victim.rid))
                        killer.start()
                    return f.roll_out(version, canary_requests=2,
                                      canary_window_s=10.0, **kw)

            publisher = RegistryFleetPublisher(
                "contserve", export_version, fleet=_KilledFleet())
            res = run_continuous(
                _train_step, _fresh_state(),
                _stream(topic, tmp_path / "ck", group="serve-trainer",
                        min_records=6, max_records=6, eval_every=3),
                directory=str(tmp_path / "ck"), eval_fn=eval_fn,
                save_every=2, publisher=publisher,
                guard=PreemptionGuard(install=False))
            time.sleep(0.2)
            stop_load.set()
            for t in threads:
                t.join(timeout=10)

        assert errors == []  # ZERO client-visible failures
        assert rollout_started.is_set()
        completed = [c for c in res.cutovers if c["outcome"] == "completed"]
        assert completed  # the loop really cut over under fire
        # The fleet only ever served v1 (step 0) and candidates that
        # PASSED their gate — the regressed candidate was never even
        # exported, let alone served.
        passing_steps = {c["step"] for c in res.cutovers}
        assert served_steps <= passing_steps | {0}
        assert len(served_steps) >= 2  # the cutovers actually landed
        failed = [g for g in res.gates if g["outcome"] == "fail"]
        assert len(failed) == 1
        v = res.ledger
        assert v["records"] == 54 and v["contiguous"] and v["disjoint"]


@in_both
class TestContinuousBenchTier:
    def test_bench_continuous_loop_smoke_end_to_end(self, tmp_path):
        # The tier's result under the metric name ``bench.py
        # --continuous-loop`` prints it with.
        result = bench_tier("run_continuous_loop_bench", PKG)(smoke=True)
        line = {"metric": "continuous_loop_spans_per_sec", **result}
        assert line["metric"] == "continuous_loop_spans_per_sec"
        assert line["client_errors"] == 0
        assert line["ledger_contiguous"] is True
        assert line["records_trained"] == line["records_published"]
        assert line["eval_gates"] >= 2
        assert line["eval_gate_rollbacks"] >= 1  # the poisoned gate
        assert line["cutovers_completed"] >= 1
        assert line["recoveries"] >= 1  # the injected transient fault


# -- the LM through the loop, in both packages ---------------------------------

LM = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
LM_SEQ, LM_ROWS, LM_LR = 16, 36, 0.05
TOL = dict(rtol=1e-4, atol=1e-5)  # the LM train step's (tests/test_torch_train.py)


@pytest.fixture
def torch_ws(tmp_path, monkeypatch):
    """The port's runtime config in a workspace of its own (the JAX
    package's is tests/conftest.py's)."""
    from hops_tpu_torch.runtime import config

    monkeypatch.setattr(config, "_current", config.runtime())
    config.configure(workspace=str(tmp_path / "torch_ws"), project="testproj")
    return tmp_path / "torch_ws"


def _lm_rows(seed: int, n: int) -> np.ndarray:
    """Rows that count up by 3 from a random start: learnable, so the
    held-out loss falls and the gates have something to judge."""
    starts = np.random.default_rng(seed).integers(0, LM["vocab_size"], (n, 1))
    return ((starts + 3 * np.arange(LM_SEQ + 1)) % LM["vocab_size"]).astype(np.int32)


def _lm_loop(pkg: str, tmp_path: Path, params) -> dict:
    """``run_continuous`` over a topic of packed LM rows in ``pkg``: SGD
    with momentum (Adam's ``sqrt(v) + eps`` turns last-bit gradient
    differences between the frameworks into weight differences up to
    lr), the held-out loss as a ``mode="min"`` gate, gate 2 poisoned,
    and each passed candidate's parameters exported."""
    n = NAMES[pkg]
    topic = f"lm-{pkg}"
    n["pubsub"].create_topic(topic)
    producer = n["pubsub"].Producer(topic)
    for row in _lm_rows(0, LM_ROWS):
        producer.send({"tokens": row.tolist()})
    heldout = _lm_rows(1, 4)
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        import optax
        from hops_tpu.models import common as jax_common
        from hops_tpu.models.transformer import TransformerLM as JaxLM
        from hops_tpu.models.transformer import make_lm_train_step as jax_step

        jm = JaxLM(**LM, dtype=jnp.float32)
        state = jax_common.TrainState.create(
            apply_fn=jm.apply, params=params, tx=optax.sgd(LM_LR, momentum=0.9),
            rng=jax.random.PRNGKey(1))
        step_fn = jax.jit(jax_step())

        def eval_loss(s):
            logits = jm.apply({"params": s.params}, heldout[:, :-1])
            return float(jax_common.cross_entropy_loss(logits, heldout[:, 1:]))

        def weights(s):
            return convert.flatten(jax.device_get(s.params))
    else:
        model = TransformerLM(**LM, dtype="float32", device="cpu").load_flax(params)
        state = TrainState(model=model, optimizer=torch.optim.SGD(
            model.parameters(), lr=LM_LR, momentum=0.9))
        step_fn = make_lm_train_step()

        def eval_loss(s):
            with torch.no_grad():
                logits = s.model(torch.as_tensor(heldout[:, :-1]).long())
                return float(cross_entropy_loss(logits, torch.as_tensor(heldout[:, 1:]).long()))

        def weights(s):
            return convert.flatten(convert.params_to_flax(s.model))

    losses, gates, exported = [], [], {}

    def train_step(s, batch):
        s, metrics = step_fn(s, batch)
        losses.append(float(metrics["loss"]))
        return s, metrics

    def eval_fn(s):
        gates.append(1)
        return float("inf") if len(gates) == 2 else eval_loss(s)

    def export_fn(s, step, metric):
        exported[step] = weights(s)
        return {"version": len(exported)}

    src = n["StreamingSource"](topic, group="lm", from_beginning=True)
    stream = n["SpanStream"](
        src, tmp_path / pkg, min_records=4, max_records=4, eval_every=3,
        stop_on_idle=True, idle_grace_s=0.3,
        collate=lambda vals: {"tokens": np.asarray([v["tokens"] for v in vals], np.int32)})
    res = n["run_continuous"](
        train_step, state, stream, directory=str(tmp_path / pkg),
        eval_fn=eval_fn, mode="min", save_every=2,
        publisher=n["RegistryFleetPublisher"]("lm", export_fn),
        guard=n["PreemptionGuard"](install=False))
    return {"losses": losses, "gates": res.gates, "cutovers": res.cutovers,
            "ledger": _account(res.ledger), "exported": exported,
            "steps": res.steps}


def test_lm_trains_through_the_loop_as_in_jax(tmp_path, torch_ws):
    """A 2-layer LM (d_model 64, fp32) trained from a stream through
    ``run_continuous`` in both packages from the same weights: losses
    at ``rtol 1e-4, atol 1e-5``, the same gate outcomes and bars, the
    same cutovers and ledger, and each exported candidate's parameters
    within the same tolerance."""
    import jax
    import jax.numpy as jnp

    from hops_tpu.models import common as jax_common
    from hops_tpu.models.transformer import TransformerLM as JaxLM

    torch.set_num_threads(1)
    params = jax.device_get(jax_common.create_train_state(
        JaxLM(**LM, dtype=jnp.float32), jax.random.PRNGKey(0), (1, 8),
        input_dtype=jnp.int32).params)
    ref = _lm_loop("jax", tmp_path, params)
    got = _lm_loop("torch", tmp_path, params)
    assert ref["steps"] == got["steps"] == LM_ROWS // 4
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    assert [g["outcome"] for g in got["gates"]] == \
        [g["outcome"] for g in ref["gates"]] == ["pass", "fail", "pass"]
    for g, r in zip(got["gates"], ref["gates"]):
        assert g["step"] == r["step"]
        np.testing.assert_allclose(g["metric"], r["metric"], **TOL)
        np.testing.assert_allclose(np.float64(g["best"] if g["best"] is not None else np.nan),
                                   np.float64(r["best"] if r["best"] is not None else np.nan), **TOL)
    strip = lambda cs: [(c["step"], c["version"], c["outcome"]) for c in cs]  # noqa: E731
    assert strip(got["cutovers"]) == strip(ref["cutovers"])
    assert got["ledger"] == ref["ledger"]
    assert sorted(got["exported"]) == sorted(ref["exported"])
    for step, w in ref["exported"].items():
        assert sorted(got["exported"][step]) == sorted(w)
        for name, arr in w.items():
            np.testing.assert_allclose(got["exported"][step][name], arr,
                                       err_msg=f"step {step} {name}", **TOL)


# -- in-place state and the cutover thread ---------------------------------------


def test_cutover_exports_the_judged_parameters(tmp_path, torch_ws):
    """A torch train step updates its module in place and the next
    segment trains while the cutover thread exports. The exporter must
    read the parameters the gate judged, not a later (or torn) step's:
    ``run_continuous`` hands the cutover thread a snapshot taken on the
    training thread. Submitting the live state fails this test."""
    from hops_tpu_torch.pipeline import continuous as C

    torch.manual_seed(0)
    model = torch.nn.Linear(2, 1, dtype=torch.float64)
    state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.01))

    def step_fn(s, batch):
        x = torch.as_tensor(batch["x"])
        loss = (s.model(x).squeeze(-1) - torch.as_tensor(batch["seq"])).pow(2).mean()
        s.optimizer.zero_grad()
        loss.backward()
        s.optimizer.step()  # in place
        time.sleep(0.02)  # the next segment is still training during an export
        return dataclasses.replace(s, step=s.step + 1), {"loss": loss.detach()}

    judged = []

    def eval_fn(s):
        judged.append(s.model.weight.detach().clone())
        return float(len(judged))  # mode "max": every gate passes

    exported = {}

    def export_fn(s, step, metric):
        time.sleep(0.15)  # read well after the next segment started
        exported[step] = s.model.weight.detach().clone()
        return {"version": step}

    t_pubsub.create_topic("inplace")
    producer = t_pubsub.Producer("inplace")
    for i in range(48):
        producer.send({"x": [float(i % 7), 1.0], "seq": float(i % 5)})
    stream = C.SpanStream(
        t_StreamingSource("inplace", group="g", from_beginning=True), tmp_path / "ck",
        collate=C.collate_column_batch(["x", "seq"]), min_records=4, max_records=4,
        eval_every=3, stop_on_idle=True, idle_grace_s=0.3)
    res = C.run_continuous(
        step_fn, state, stream, directory=str(tmp_path / "ck"), eval_fn=eval_fn,
        save_every=1, publisher=C.RegistryFleetPublisher("inplace", export_fn),
        guard=t_PreemptionGuard(install=False))
    assert [g["outcome"] for g in res.gates] == ["pass"] * 4
    assert sorted(exported) == [g["step"] for g in res.gates]
    for g, w in zip(res.gates, judged):
        assert torch.equal(exported[g["step"]], w), f"gate at step {g['step']}"
    # The test can see the fault: the live weights moved after each of
    # the first three gates.
    assert not torch.equal(judged[0], judged[1])
