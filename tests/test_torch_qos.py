"""The port's copy of the QoS runtime (``hops_tpu_torch.runtime.qos``)
against the JAX package's: the JAX package's own cases (priority
resolution, the brownout controller's hysteresis, scoped brownout
levels, the bounded priority queue, the starvation guard) run on the
copy, a random trace must drive both to the same answers, and the
engine's priority admission and the predictor's brownout clamp hold on
the CPU.
"""

from __future__ import annotations

import queue as stdlib_queue
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hops_tpu.runtime import qos as jax_qos
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact
from hops_tpu_torch.runtime import qos


# -- priority resolution ------------------------------------------------------


class TestPriorityResolution:
    def test_header_alone_is_honored(self):
        assert qos.parse_priority("batch") == "batch"
        assert qos.parse_priority("interactive") == "interactive"

    def test_no_signal_defaults_interactive(self):
        assert qos.parse_priority(None) == "interactive"
        assert qos.parse_priority("") == "interactive"
        assert qos.parse_priority("garbage") == "interactive"

    def test_header_can_demote_never_promote(self):
        # Tenant configured batch: an interactive claim must NOT jump
        # the queue; a batch claim on an interactive tenant may demote.
        assert qos.parse_priority("interactive", configured="batch") == "batch"
        assert qos.parse_priority("batch", configured="interactive") == "batch"
        assert qos.parse_priority(None, configured="batch") == "batch"

    def test_scope_rides_the_thread(self):
        assert qos.request_priority() == "interactive"
        with qos.priority_scope("batch"):
            assert qos.request_priority() == "batch"
        assert qos.request_priority() == "interactive"


# -- brownout -----------------------------------------------------------------


class TestBrownoutController:
    def _ctl(self, **kw):
        kw.setdefault("slo_p99_ms", 100.0)
        kw.setdefault("burn_window_s", 1.0)
        kw.setdefault("recover_window_s", 2.0)
        clock = [0.0]
        ctl = qos.BrownoutController(
            qos.BrownoutPolicy(**kw), clock=lambda: clock[0])
        return ctl, clock

    def test_sustained_burn_degrades_then_sheds(self):
        ctl, clock = self._ctl()
        assert ctl.observe(150.0) == 0  # breach begins, not sustained
        clock[0] = 1.1
        assert ctl.observe(150.0) == qos.DEGRADE
        # Deeper burn (> shed_factor * slo) sustained -> SHED.
        clock[0] = 2.0
        ctl.observe(250.0)
        clock[0] = 3.2
        assert ctl.observe(250.0) == qos.SHED

    def test_one_bursty_tick_never_flaps(self):
        ctl, clock = self._ctl()
        ctl.observe(500.0)
        clock[0] = 0.5
        assert ctl.observe(50.0) == 0  # burn not sustained; timer reset
        clock[0] = 2.0
        assert ctl.observe(500.0) == 0  # a fresh breach starts over

    def test_recovery_steps_down_one_level_per_window(self):
        ctl, clock = self._ctl()
        ctl.observe(300.0)
        clock[0] = 1.1
        assert ctl.observe(300.0) == qos.SHED
        clock[0] = 2.0
        ctl.observe(50.0)  # clearing begins (below exit_factor * slo)
        clock[0] = 4.1
        assert ctl.observe(50.0) == qos.DEGRADE  # one notch down
        clock[0] = 6.2
        assert ctl.observe(50.0) == 0  # next window clears fully

    def test_no_signal_holds_level(self):
        ctl, clock = self._ctl()
        ctl.observe(300.0)
        clock[0] = 1.1
        assert ctl.observe(300.0) == qos.SHED
        clock[0] = 10.0
        assert ctl.observe(None) == qos.SHED  # blind ticks hold

    def test_policy_validation(self):
        with pytest.raises(ValueError):
            qos.BrownoutPolicy(slo_p99_ms=0)
        with pytest.raises(ValueError):
            qos.BrownoutPolicy(slo_p99_ms=10, exit_factor=1.5)

    def test_global_level_expires_by_ttl(self):
        clock = [0.0]
        qos.set_brownout(qos.DEGRADE, hold_s=1.0, clock=lambda: clock[0])
        assert qos.brownout_level(clock=lambda: clock[0]) == qos.DEGRADE
        clock[0] = 1.5
        assert qos.brownout_level(clock=lambda: clock[0]) == 0

    def test_remote_brownout_only_raises(self):
        qos.set_brownout(0)
        qos.note_remote_brownout("2", hold_s=5.0)
        assert qos.brownout_level() == qos.SHED
        qos.note_remote_brownout("garbage")  # ignored
        qos.note_remote_brownout("0")  # a zero never lowers anything
        assert qos.brownout_level() == qos.SHED
        qos.set_brownout(0)


class TestScopedBrownout:
    """Per-endpoint brownout levels: one model's degradation must not
    brown out its neighbors on a multi-fleet host (the two-fleets-in-
    one-process integration rides in test_fleet.py)."""

    def test_scoped_level_isolated_from_neighbors_and_global(self):
        clock = [0.0]
        qos.set_brownout(qos.SHED, hold_s=5.0, clock=lambda: clock[0],
                         scope="fleet-a")
        try:
            assert qos.brownout_level(
                clock=lambda: clock[0], scope="fleet-a") == qos.SHED
            assert qos.brownout_level(
                clock=lambda: clock[0], scope="fleet-b") == 0
            assert qos.brownout_level(clock=lambda: clock[0]) == 0
        finally:
            qos.set_brownout(0, scope="fleet-a")

    def test_global_level_floors_every_scope(self):
        qos.set_brownout(qos.DEGRADE, hold_s=5.0)
        qos.set_brownout(qos.SHED, hold_s=5.0, scope="fleet-a")
        try:
            # The global scope is the operator big-red-switch: every
            # endpoint sees at least it; a deeper scoped level wins.
            assert qos.brownout_level(scope="fleet-a") == qos.SHED
            assert qos.brownout_level(scope="fleet-b") == qos.DEGRADE
        finally:
            qos.set_brownout(0)
            qos.set_brownout(0, scope="fleet-a")

    def test_scope_rides_the_request_context(self):
        qos.set_brownout(qos.DEGRADE, hold_s=5.0, scope="model-m")
        try:
            assert qos.brownout_level() == 0  # outside any scope
            with qos.brownout_scope("model-m"):
                # The layers underneath (joins, decode budgets) call
                # brownout_level() bare and resolve the request's own
                # endpoint through the contextvar.
                assert qos.brownout_level() == qos.DEGRADE
            assert qos.brownout_level() == 0
        finally:
            qos.set_brownout(0, scope="model-m")

    def test_remote_adoption_is_scoped(self):
        qos.note_remote_brownout("2", hold_s=5.0, scope="model-m")
        try:
            assert qos.brownout_level(scope="model-m") == qos.SHED
            assert qos.brownout_level(scope="other") == 0
            assert qos.brownout_level() == 0
        finally:
            qos.set_brownout(0, scope="model-m")

    def test_scoped_level_expires_by_ttl(self):
        clock = [0.0]
        qos.set_brownout(qos.SHED, hold_s=1.0, clock=lambda: clock[0],
                         scope="model-m")
        assert qos.brownout_level(
            clock=lambda: clock[0], scope="model-m") == qos.SHED
        clock[0] = 1.5
        assert qos.brownout_level(
            clock=lambda: clock[0], scope="model-m") == 0


# -- bounded priority queue ---------------------------------------------------


class TestBoundedPriorityQueue:
    def test_priority_order_fifo_within_class(self):
        q = qos.BoundedPriorityQueue(8)
        q.put("b1", rank=1)
        q.put("i1", rank=0)
        q.put("b2", rank=1)
        q.put("i2", rank=0)
        assert [q.get_nowait() for _ in range(4)] == ["i1", "i2", "b1", "b2"]

    def test_full_queue_evicts_newest_of_worst_class(self):
        q = qos.BoundedPriorityQueue(2)
        q.put("b-old", rank=1)
        q.put("b-new", rank=1)
        evicted = q.put("i1", rank=0)
        assert evicted == "b-new"  # newest, least-sunk batch work sheds
        assert q.get_nowait() == "i1"
        assert q.get_nowait() == "b-old"

    def test_full_of_equal_or_better_refuses_the_incomer(self):
        q = qos.BoundedPriorityQueue(1)
        q.put("b1", rank=1)
        with pytest.raises(qos.ShedError):
            q.put("b2", rank=1)  # same class: nothing worse to evict
        q2 = qos.BoundedPriorityQueue(1)
        q2.put("i1", rank=0)
        with pytest.raises(qos.ShedError):
            q2.put("b1", rank=1)  # everything queued outranks it

    def test_batch_is_starvation_free_under_interactive_load(self):
        q = qos.BoundedPriorityQueue(64, starvation_limit=3)
        q.put("batch", rank=1)
        for i in range(10):
            q.put(f"i{i}", rank=0)
        served = []
        # Keep refilling interactive as fast as we drain — batch must
        # still surface within starvation_limit picks.
        for n in range(8):
            item = q.get_nowait()
            served.append(item)
            q.put(f"extra{n}", rank=0)
        assert "batch" in served
        assert served.index("batch") <= 3

    def test_control_lane_preempts_and_is_never_evicted(self):
        q = qos.BoundedPriorityQueue(1)
        q.put("i1", rank=0)
        q.put(None, rank=-1)  # sentinel: no bound, no eviction
        assert q.get_nowait() is None
        assert q.get_nowait() == "i1"

    def test_get_timeout_raises_stdlib_empty(self):
        q = qos.BoundedPriorityQueue(4)
        with pytest.raises(stdlib_queue.Empty):
            q.get(timeout=0.01)

    def test_blocked_get_wakes_on_put(self):
        q = qos.BoundedPriorityQueue(4)
        out = []
        t = threading.Thread(target=lambda: out.append(q.get(timeout=5)))
        t.start()
        time.sleep(0.05)
        q.put("x", rank=0)
        t.join(timeout=5)
        assert out == ["x"]

    def test_bound_validation(self):
        with pytest.raises(ValueError):
            qos.BoundedPriorityQueue(0)


class TestStarvationGuard:
    def test_forces_worst_class_after_limit(self):
        g = qos.StarvationGuard(limit=2)
        assert g.pick_rank([0, 1]) == 0
        assert g.pick_rank([0, 1]) == 0
        assert g.pick_rank([0, 1]) == 1  # the forced batch pick
        assert g.pick_rank([0, 1]) == 0  # streak reset

    def test_single_class_resets_the_streak(self):
        g = qos.StarvationGuard(limit=2)
        g.pick_rank([0, 1])
        assert g.pick_rank([0]) == 0  # nothing waiting behind
        assert g.pick_rank([0, 1]) == 0
        assert g.pick_rank([0, 1]) == 0


# -- parity with the JAX package's module --------------------------------------


def test_random_trace_matches_the_jax_module():
    """The same operations on both modules give the same answers: priority
    resolution, guard picks, controller levels and queue pops/evictions."""
    rng = random.Random(0)
    claims = [None, "", "batch", "interactive", "garbage"]
    for h in claims:
        for c in claims:
            assert qos.parse_priority(h, c) == jax_qos.parse_priority(h, c)
    guards = (qos.StarvationGuard(limit=3), jax_qos.StarvationGuard(limit=3))
    clocks = [0.0]
    ctls = [m.BrownoutController(m.BrownoutPolicy(slo_p99_ms=100.0), clock=lambda: clocks[0])
            for m in (qos, jax_qos)]
    queues = (qos.BoundedPriorityQueue(5, starvation_limit=2),
              jax_qos.BoundedPriorityQueue(5, starvation_limit=2))
    for i in range(300):
        ranks = rng.sample([0, 1], rng.randint(1, 2))
        assert guards[0].pick_rank(ranks) == guards[1].pick_rank(ranks)
        clocks[0] += rng.uniform(0.0, 0.7)
        p99 = rng.choice([None, 50.0, 90.0, 150.0, 260.0])
        assert ctls[0].observe(p99) == ctls[1].observe(p99)
        if rng.random() < 0.6:
            rank = rng.randint(0, 1)
            outs = []
            for q in queues:
                try:
                    outs.append(("evicted", q.put(i, rank=rank)))
                except q_shed(q):
                    outs.append(("shed", None))
            assert outs[0] == outs[1]
        else:
            outs = []
            for q in queues:
                try:
                    outs.append(q.get_nowait())
                except stdlib_queue.Empty:
                    outs.append("empty")
            assert outs[0] == outs[1]


def q_shed(q):
    return qos.ShedError if isinstance(q, qos.BoundedPriorityQueue) else jax_qos.ShedError


# -- the engine and the predictor ------------------------------------------------

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)


@pytest.fixture(scope="module")
def params():
    jm = JaxLM(**CFG, dtype=jnp.float32)
    return jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


def _engine(params, **kw):
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True, device="cpu")
    return LMEngine(model.load_flax(params), device="cpu", **kw)


def _admission_order(engine) -> list[int]:
    """On one slot, requests finish in the order they were admitted."""
    order = []
    while engine.has_work:
        order += engine.step()
    return order


def test_engine_priority_fifo_within_class(params):
    """Interactive requests are admitted first, each class FIFO, and
    priority changes no request's tokens."""
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 64, (4,)) for _ in range(4)]
    kinds = ["batch", "interactive", "batch", "interactive"]
    engine = _engine(params, slots=1)
    tickets = [engine.submit(p, max_new_tokens=2, priority=k) for p, k in zip(prompts, kinds)]
    assert _admission_order(engine) == [tickets[1], tickets[3], tickets[0], tickets[2]]
    fifo = _engine(params, slots=1)
    plain = [fifo.submit(p, max_new_tokens=2) for p in prompts]
    assert [engine.result(t) for t in tickets] == [fifo.run()[t] for t in plain]
    assert engine.submit(prompts[0], priority="unknown") is not None  # counts as batch


def test_engine_batch_never_starves(params):
    """Under a sustained interactive load the starvation guard (limit 8)
    admits the waiting batch request after 8 interactive ones."""
    rs = np.random.RandomState(1)
    engine = _engine(params, slots=1)
    batch = engine.submit(rs.randint(0, 64, (3,)), max_new_tokens=1, priority="batch")
    inter = [engine.submit(rs.randint(0, 64, (3,)), max_new_tokens=1) for _ in range(12)]
    order = []
    while engine.has_work:
        order += engine.step()
        if len(inter) < 30:
            inter.append(engine.submit(rs.randint(0, 64, (3,)), max_new_tokens=1))
        if batch in order:
            break
    assert order.index(batch) == 8


def test_predictor_clamps_budgets_under_brownout(params, tmp_path):
    save_lm_artifact(tmp_path / "lm", dict(CFG, dtype="float32"), params)
    predictor = LMEnginePredictor(tmp_path / "lm", {"slots": 2, "brownout_max_new_tokens": 3},
                                  device="cpu")
    prompt = np.random.RandomState(2).randint(0, 64, (5,)).tolist()
    try:
        assert len(predictor.predict([{"prompt": prompt, "max_new_tokens": 6}])[0]) == 6
        qos.set_brownout(qos.DEGRADE, hold_s=30.0)
        try:
            clamped = predictor.predict([{"prompt": prompt, "max_new_tokens": 6}, prompt])
        finally:
            qos.set_brownout(0)
        assert [len(a) for a in clamped] == [3, 3]
        with qos.priority_scope("batch"):
            assert len(predictor.predict([prompt])[0]) == 32
    finally:
        predictor.stop()
