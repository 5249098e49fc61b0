"""The port's phase clock (``telemetry/spans.py`` ``Phases``,
``annotate``) inside ``LMEngine`` and the LM train step, on the CPU:
the engine's ``stats()`` keys of each phase, per-request queue wait and
first-token hold, the profiler-only ranges (opened under a profiler,
never without one), ``span()``'s gated range and the serving path's
``lm_engine.dispatch`` request span.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from hops_tpu_torch.models.common import create_train_state
from hops_tpu_torch.models.convert import random_params
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact
from hops_tpu_torch.telemetry import tracing
from hops_tpu_torch.telemetry.metrics import Registry
from hops_tpu_torch.telemetry.spans import Phases, annotate, profiling, span

CFG = dict(vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
KINDS = {
    "dense": dict(prefill_buckets=(8, 16)),
    "paged": dict(kv_page_size=8, prefill_chunk=8),
    "dense-horizon": dict(prefill_buckets=(8, 16), decode_horizon=4),
    "paged-horizon": dict(kv_page_size=8, prefill_chunk=8, decode_horizon=4),
    "spec": dict(prefill_buckets=(8, 16), spec_k=3),
}
NEW_KEYS = ("queue_wait_s", "admitted", "prefill_launch_s", "first_token_hold_s",
            "decode_launch_s", "decode_readback_s")


@pytest.fixture(scope="module")
def params():
    return random_params(**CFG, seed=0)


def _model(params, **kw):
    return TransformerLM(**CFG, dtype="float32", device="cpu", **kw).load_flax(params)


def _engine(params, kind, slots=2):
    kw = dict(KINDS[kind])
    model = _model(params, ragged_decode=True)
    if "spec_k" in kw:
        kw["draft_model"] = model
    return LMEngine(model, slots=slots, device="cpu", **kw)


def _requests(n=5, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 64, (int(rs.randint(3, 14)),)), int(rs.randint(2, 9)))
            for _ in range(n)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_stats_phase_keys(params, kind):
    """Every new key is there and non-negative; the decode children fit
    inside their parent; ``admitted`` counts the requests served and
    ``readbacks`` the decode read-back phases (every dispatch but the
    paged prompt-chunk calls)."""
    engine = _engine(params, kind)
    reqs = _requests()
    tickets = [engine.submit(p, max_new_tokens=n) for p, n in reqs]
    results = engine.run()
    assert [len(results[t]) for t in tickets] == [n for _, n in reqs]
    s = engine.stats()
    for key in NEW_KEYS:
        assert s[key] >= 0, key
    assert s["admitted"] == len(reqs)
    assert s["decode_tokens"] > 0 and s["decode_s"] > 0
    assert 0 < s["decode_launch_s"] and 0 < s["decode_readback_s"]
    assert s["decode_launch_s"] + s["decode_readback_s"] <= s["decode_s"]
    assert 0 < s["prefill_launch_s"] <= s["prefill_s"]
    assert s["first_token_hold_s"] > 0 and s["queue_wait_s"] > 0
    phases = engine._phases
    assert s["readbacks"] == phases.count("lm_engine.decode.readback") \
        == phases.count("lm_engine.decode")
    chunk_calls = phases.count("lm_engine.prefill") if "paged" in kind else 0
    assert s["readbacks"] == s["dispatches"] - chunk_calls


def test_run_offline_counts_admissions_and_readbacks(params):
    """An offline wave pops its requests from the queue (each an
    admission) and reads back once per dispatch."""
    engine = _engine(params, "dense")
    for p, n in _requests(7, seed=1):
        engine.submit(p, max_new_tokens=n)
    engine.run_offline()
    s = engine.stats()
    assert s["admitted"] == 7
    assert s["readbacks"] == s["dispatches"] == -(-7 // 2)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_queue_wait_behind_a_full_engine(params, kind):
    """One slot, two requests: the second waits in the queue at least
    through the first step, which admits and decodes the first."""
    engine = _engine(params, kind, slots=1)
    (p0, _), (p1, _) = _requests(2, seed=2)
    engine.submit(p0, max_new_tokens=6)
    second = engine.submit(p1, max_new_tokens=3)
    t0 = time.perf_counter()
    engine.step()
    first_step = time.perf_counter() - t0
    assert engine.request_times(second)["queue_wait_s"] == 0.0  # still queued
    engine.run()
    wait = engine.request_times(second)["queue_wait_s"]
    assert wait >= first_step
    assert engine.stats()["queue_wait_s"] >= wait
    engine.take_result(second)
    assert engine.request_times(second) is None


@pytest.mark.parametrize("kind", ["dense", "paged", "dense-horizon"])
def test_lone_request_ttft_is_wait_prefill_and_hold(params, kind):
    """A lone request's time to its first token, to the end of the
    ``step()`` that brought it, is its queue wait plus the admission's
    prefill plus its first-token hold, within 5%."""
    engine = _engine(params, kind)
    prompt = np.arange(1, 8)
    t0 = time.perf_counter()
    ticket = engine.submit(prompt, max_new_tokens=12)
    time.sleep(0.01)  # the request waits in the queue before the first step
    while ticket not in engine.ttft_s:
        engine.step()
    ttft = time.perf_counter() - t0
    s = engine.stats()
    times = engine.request_times(ticket)
    assert times["queue_wait_s"] == pytest.approx(s["queue_wait_s"])
    assert times["first_token_hold_s"] == pytest.approx(s["first_token_hold_s"])
    parts = s["queue_wait_s"] + s["prefill_s"] + s["first_token_hold_s"]
    assert parts == pytest.approx(ttft, rel=0.05)
    if "horizon" in kind or kind == "dense":
        # the dense first token waits on the host through the step's decode
        assert s["first_token_hold_s"] >= s["decode_s"]


class _Counting:
    """Stands in for ``record_function``: notes the calling module and
    the range's name, then opens the real range."""

    def __init__(self, real, calls):
        self.real, self.calls = real, calls

    def __call__(self, name, *args, **kw):
        self.calls.append((sys._getframe(1).f_globals.get("__name__", ""), name))
        return self.real(name, *args, **kw)


def _one_engine_and_train_step(params):
    engine = _engine(params, "dense-horizon")
    for p, n in _requests(3, seed=3):
        engine.submit(p, max_new_tokens=n)
    engine.step()  # admission and a decode horizon
    engine.step()
    model = _model(params)
    state = create_train_state(model)
    tokens = np.random.RandomState(4).randint(0, 64, (2, 9))
    make_lm_train_step(loss_chunk=4)(state, {"tokens": tokens})


def test_no_range_without_a_profiler(params, monkeypatch):
    """With no profiler recording, an engine step and a train step open
    no ``record_function`` from the port; under one, the same steps open
    the port's ranges through the same patched function."""
    calls: list[tuple[str, str]] = []
    fake = _Counting(autograd_profiler.record_function, calls)
    monkeypatch.setattr(autograd_profiler, "record_function", fake)
    monkeypatch.setattr(torch.profiler, "record_function", fake)
    assert not profiling()
    _one_engine_and_train_step(params)
    assert not [c for c in calls if c[0].startswith("hops_tpu_torch")]
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling()
        _one_engine_and_train_step(params)
    ours = {name for mod, name in calls if mod.startswith("hops_tpu_torch")}
    assert {"lm_engine.step", "lm_engine.decode", "transformer.mlp",
            "train_step.optimizer"} <= ours


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_ranges_nest_under_the_profiler(params):
    """The profiler's events hold ``lm_engine.decode.launch`` inside
    ``lm_engine.decode`` inside ``lm_engine.step``, the block and
    logits ranges, and the four train-step ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _one_engine_and_train_step(params)
    events = prof.events()
    by = {}
    for e in events:
        by.setdefault(e.name, []).append(e)
    names = set(by)
    assert {"lm_engine.prefill", "lm_engine.prefill.launch", "lm_engine.decode.readback",
            "transformer.forward", "transformer.attention", "transformer.mlp",
            "transformer.logits", "train_step.forward", "train_step.loss",
            "train_step.backward", "train_step.optimizer"} <= names
    launch = by["lm_engine.decode.launch"][0]
    decode = next(e for e in by["lm_engine.decode"] if _inside(launch, e))
    assert any(_inside(decode, e) for e in by["lm_engine.step"])
    assert any(_inside(a, f) for a in by["transformer.attention"]
               for f in by["transformer.forward"])


def test_span_gates_its_range_and_records(monkeypatch):
    """``span()`` with no profiler opens no range and still observes its
    histogram; under one it opens the range."""
    calls: list[tuple[str, str]] = []
    fake = _Counting(autograd_profiler.record_function, calls)
    monkeypatch.setattr(autograd_profiler, "record_function", fake)
    reg = Registry()
    with span("test_gated_span", registry=reg):
        pass
    assert calls == []
    hist = reg.histogram("test_gated_span_seconds", "", labels=()).labels()
    assert hist.count == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with span("test_gated_span", registry=reg):
            pass
    assert [name for _, name in calls] == ["test_gated_span"]
    assert hist.count == 2


def test_phases_clock():
    """``phase`` adds the block's seconds and a count, also when the
    block raises; ``add`` books an interval; ``annotate`` is the shared
    no-op with no profiler."""
    ph = Phases()
    with ph.phase("a"):
        time.sleep(0.002)
    with pytest.raises(ValueError):
        with ph.phase("a"):
            raise ValueError
    ph.add("b", 0.5, count=2)
    assert ph.count("a") == 2 and ph.seconds("a") >= 0.002
    assert (ph.seconds("b"), ph.count("b"), ph.seconds("c"), ph.count("c")) == (0.5, 2, 0.0, 0)
    assert annotate("x") is annotate("y")


def test_predictor_records_the_dispatch_span(params, tmp_path, monkeypatch):
    """A sampled request through ``LMEnginePredictor`` records one
    ``lm_engine.dispatch`` span per instance under its trace, with the
    documented attributes and the engine's marks; a failed step records
    ``error``."""
    monkeypatch.setattr(tracing, "_ENABLED", True)
    save_lm_artifact(tmp_path / "lm", dict(CFG, dtype="float32"), params)
    predictor = LMEnginePredictor(tmp_path / "lm", {"slots": 2, "prefill_buckets": [8, 16]},
                                  device="cpu")
    try:
        root = tracing.start_trace("test.request", force_sample=True)
        with root:
            out = predictor.predict([{"prompt": [1, 2, 3, 4], "max_new_tokens": 5},
                                     {"prompt": [5, 6, 7], "max_new_tokens": 3}])
        assert [len(o) for o in out] == [5, 3]
        spans = [s for s in tracing.TRACER.get_trace(root.trace_id)
                 if s["name"] == "lm_engine.dispatch"]
        assert len(spans) == 2
        assert sorted(s["attrs"]["tokens"] for s in spans) == [3, 5]
        for s in spans:
            assert s["parent_id"] == root.span_id
            a = s["attrs"]
            assert a["ttft_ms"] > 0 and a["queue_wait_ms"] >= 0 and a["first_token_hold_ms"] >= 0
            assert a["queue_wait_ms"] + a["first_token_hold_ms"] <= a["ttft_ms"]
            assert "error" not in a

        def boom(self, *args, **kw):
            raise RuntimeError("injected")

        monkeypatch.setattr(TransformerLM, "forward", boom)
        root = tracing.start_trace("test.request", force_sample=True)
        with root, pytest.raises(RuntimeError, match="injected"):
            predictor.predict([[1, 2, 3]])
        failed = [s for s in tracing.TRACER.get_trace(root.trace_id)
                  if s["name"] == "lm_engine.dispatch"]
        assert [s["attrs"]["error"] for s in failed] == ["RuntimeError"]
        assert failed[0]["attrs"]["tokens"] == 0
    finally:
        predictor.stop()
