"""The engine's phase readers: a traced run of the tiny serve cell on
the CPU reports all six, launch, read-back and self time add up to the
decode time a token, and on a program whose ``stats()`` lacks the
phase keys every reader returns None without raising."""

from __future__ import annotations

import types

import pytest

from portbench import harness
from portbench.tests import tiny

NEW = ("engine.queue_wait_ms_per_request.serve", "engine.prefill_launch_ms_per_request.serve",
       "engine.first_token_hold_ms_per_request.serve", "engine.decode_launch_us_per_token.serve",
       "engine.decode_readback_us_per_token.serve", "engine.decode_self_us_per_token.serve")
PARENT_STATS = {"prefill_s": 1.0, "decode_s": 2.0, "decode_tokens": 100, "readbacks": 10}


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", "portbench_metric")


def test_traced_serve_reports_the_phases(tmp_path):
    copy = tiny.make_copy(tmp_path)
    line = tiny.last_json(tiny.run_cpu(copy, tiny.SERVE_CELL, trace=1))
    assert line["correct"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    for name in NEW:
        assert m[name] >= 0, name
    parts = sum(m[f"engine.decode_{p}_us_per_token.serve"] for p in ("launch", "readback", "self"))
    assert parts == pytest.approx(m["engine.decode_us_per_token.serve"], rel=0.01)
    assert m["engine.decode_launch_us_per_token.serve"] > 0
    assert m["engine.first_token_hold_ms_per_request.serve"] > 0


@pytest.mark.parametrize("name", NEW)
def test_readers_without_the_phase_keys(name):
    out = types.SimpleNamespace(layer={"stats0": PARENT_STATS, "stats1": dict(
        PARENT_STATS, decode_s=3.0, decode_tokens=150), "admitted": 5})
    assert reader(name).read(None, out) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_with_no_count_in_the_window(name):
    stats = dict(PARENT_STATS, queue_wait_s=0.1, admitted=4, prefill_launch_s=0.2,
                 first_token_hold_s=0.3, decode_launch_s=0.4, decode_readback_s=0.5)
    out = types.SimpleNamespace(layer={"stats0": stats, "stats1": dict(stats)})
    assert reader(name).read(None, out) is None
