"""The port's checkpoint manager and preemption-safe loop, on the CPU.

The JAX package's own cases (``tests/test_checkpoint.py``: round trip,
``max_to_keep``, ``restore_or_init``, async visibility, the preemption
guard and ``run_preemptible``) on port train states, plus what the port
rebuilds on ``torch.save`` where orbax did it for the JAX package: an
async save snapshots before an in-place step, atomic publish,
manifests with quarantine and fallback, the supervisor, bit-identical
preempt-and-resume (a narrow LM with dropout, a BatchNorm ResNet, the
CNN with dropout) and the stop agreement of two gloo processes.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hops_tpu_torch.models import common
from hops_tpu_torch.models.convert import random_params
from hops_tpu_torch.models.mnist import CNN, FFN
from hops_tpu_torch.models.resnet import ResNet18ish
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
from hops_tpu_torch.runtime import checkpoint, faultinject
from hops_tpu_torch.runtime.preemption import PreemptionGuard, run_preemptible

REPO = Path(__file__).resolve().parents[1]


# One intra-op thread: parallel test workers do not oversubscribe the CPU.
@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    return common.create_train_state(FFN(dtype="float32", device="cpu", seed=seed))


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"image": rs.rand(2, 28, 28, 1).astype(np.float32), "label": rs.randint(0, 10, 2)}
            for _ in range(n)]


def _weights(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _assert_same_weights(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _train(state, n=1, seed=0):
    step = common.make_train_step()
    for batch in _batches(n, seed):
        state, _ = step(state, batch)
    return state


# -- the JAX package's cases --------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    state = _train(_state(), 2)
    with checkpoint.CheckpointManager(tmp_path / "ckpt", async_save=False) as mgr:
        assert mgr.save(0, state)
        restored = mgr.restore(_state(seed=1))
    _assert_same_weights(_weights(restored), _weights(state))
    assert restored.step == state.step == 2
    opt_a, opt_b = restored.optimizer.state_dict(), state.optimizer.state_dict()
    for i in opt_b["state"]:
        for k, v in opt_b["state"][i].items():
            assert torch.equal(opt_a["state"][i][k], v), k


def test_max_to_keep_and_latest(tmp_path):
    state = _state()
    with checkpoint.CheckpointManager(tmp_path / "c", max_to_keep=2, async_save=False) as m:
        for s in (0, 1, 2, 3):
            m.save(s, state)
        assert m.latest_step() == 3
        assert m.all_steps() == [2, 3]
        assert sorted(p.name for p in m.directory.glob("manifest_*.json")) == [
            "manifest_2.json", "manifest_3.json"]


def test_restore_or_init_fresh_and_resume(tmp_path):
    state = _state()
    out, start = checkpoint.restore_or_init(state, tmp_path / "r")
    assert start == 0 and out is state
    with checkpoint.CheckpointManager(tmp_path / "r", async_save=False) as m:
        m.save(7, state)
    _, start = checkpoint.restore_or_init(state, tmp_path / "r")
    assert start == 8


def test_async_save_visible_after_wait(tmp_path):
    state = _state()
    with checkpoint.CheckpointManager(tmp_path / "a", async_save=True) as m:
        m.save(0, state)
        m.wait()
        assert m.latest_step() == 0
        assert m.verify_step(0) is None and (m.directory / "manifest_0.json").exists()


def test_preemption_guard_catches_sigterm():
    with PreemptionGuard() as guard:
        assert not guard.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert guard.should_stop()
    assert signal.getsignal(signal.SIGTERM) != guard._handler


def test_preemption_guard_chains_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)
            assert guard.should_stop() and seen == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is not None
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_run_preemptible_checkpoints_and_resumes(tmp_path):
    step_fn = common.make_train_step()
    batches = _batches(6)
    guard = PreemptionGuard(install=False)
    calls = []

    def preempting_step(state, batch):
        calls.append(1)
        if len(calls) == 3:
            guard.notice()  # delivered "mid-step"; honored at the boundary
        return step_fn(state, batch)

    state, metrics, done = run_preemptible(
        preempting_step, _state(), batches,
        directory=str(tmp_path / "ck"), save_every=100, guard=guard)
    assert done == 3 and len(calls) == 3
    assert np.isfinite(float(metrics["loss"]))
    with checkpoint.CheckpointManager(tmp_path / "ck", async_save=False) as mgr:
        assert mgr.latest_step() == 2

    state2, metrics2, done2 = run_preemptible(
        step_fn, _state(), batches, directory=str(tmp_path / "ck"),
        save_every=100, guard=PreemptionGuard(install=False))
    assert done2 == 6
    assert state2.step == 6  # 3 restored + 3 new optimizer steps


def test_run_preemptible_preempt_on_interval_step(tmp_path):
    """A preemption landing on a step the interval save just wrote must
    not save it again (a published step is never overwritten)."""
    step_fn = common.make_train_step()
    guard = PreemptionGuard(install=False)

    def step_then_preempt(state, batch):
        guard.notice()
        return step_fn(state, batch)

    _, _, done = run_preemptible(step_then_preempt, _state(), _batches(4),
                                 directory=str(tmp_path / "ck"), save_every=1, guard=guard)
    assert done == 1


def test_run_preemptible_final_state_is_durable(tmp_path):
    run_preemptible(common.make_train_step(), _state(), _batches(5),
                    directory=str(tmp_path / "ck"), save_every=100,
                    guard=PreemptionGuard(install=False))
    with checkpoint.CheckpointManager(tmp_path / "ck", async_save=False) as mgr:
        assert mgr.latest_step() == 4


def test_preemption_guard_install_is_idempotent():
    guard = PreemptionGuard()
    try:
        guard.install()  # a second install must not chain to itself
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert guard.should_stop()
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) != guard._handler


def test_run_preemptible_callable_batches_fast_forward(tmp_path):
    step_fn = common.make_train_step()
    all_batches = _batches(6)
    requested = []

    def make_stream(start):
        requested.append(start)
        return all_batches[start:]

    guard = PreemptionGuard(install=False)
    calls = []

    def preempting_step(state, batch):
        calls.append(1)
        if len(calls) == 3:
            guard.notice()
        return step_fn(state, batch)

    run_preemptible(preempting_step, _state(), make_stream,
                    directory=str(tmp_path / "ck"), save_every=100, guard=guard)
    state2, _, done2 = run_preemptible(
        step_fn, _state(), make_stream, directory=str(tmp_path / "ck"),
        save_every=100, guard=PreemptionGuard(install=False))
    assert requested == [0, 3]
    assert done2 == 6 and state2.step == 6


# -- what the port rebuilds ---------------------------------------------------


def test_save_semantics_interval_first_step_and_no_overwrite(tmp_path):
    state = _state()
    with checkpoint.CheckpointManager(tmp_path / "c", async_save=False,
                                      save_interval_steps=4) as m:
        assert m.save(1, state)  # a directory's first save is taken
        assert not m.save(2, state)  # off-interval
        assert m.save(4, state)
        assert not m.save(4, state)  # not newer than the latest
        assert not m.save(3, state)
        assert m.save(6, state, force=True)
        with pytest.raises(checkpoint.StepAlreadyExistsError):
            m.save(6, state, force=True)
        assert m.all_steps() == [1, 4, 6]
        index = json.loads((m.directory / "6" / "index.json").read_text())
        assert index["kind"] == "train_state" and index["files"] == ["state.pt"]


def test_async_save_snapshots_before_an_in_place_step(tmp_path, monkeypatch):
    """The train step updates the weights and Adam's moments in place:
    the saved step must hold the values of the moment ``save`` was
    called, not the later ones. The writer is held back until three more
    steps have run."""
    state = _train(_state(), 1)
    saved = _weights(state)
    saved_opt = {k: v.clone() for k, v in state.optimizer.state[
        next(iter(state.model.parameters()))].items()}
    release, real_save = threading.Event(), torch.save

    def held_save(*args, **kwargs):
        assert release.wait(timeout=60)
        real_save(*args, **kwargs)

    monkeypatch.setattr(torch, "save", held_save)
    with checkpoint.CheckpointManager(tmp_path / "a", async_save=True) as m:
        assert m.save(0, state)
        state = _train(state, 3, seed=1)
        release.set()
    restored = checkpoint.CheckpointManager(tmp_path / "a").restore(_state(seed=2))
    _assert_same_weights(_weights(restored), saved)
    assert restored.step == 1
    got_opt = restored.optimizer.state[next(iter(restored.model.parameters()))]
    for k, v in saved_opt.items():
        assert torch.equal(got_opt[k], v), k
    assert not torch.equal(next(iter(state.model.parameters())),
                           next(iter(restored.model.parameters())))


def test_a_tree_of_tensors_round_trips(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "meta": {"n": 3, "names": ["a", "b"]},
            "pair": (torch.ones(2, dtype=torch.int32), 0.5)}
    with checkpoint.CheckpointManager(tmp_path / "t", async_save=False) as m:
        m.save(0, tree)
        template = {"w": torch.zeros(2, 3, dtype=torch.float64), "meta": {},
                    "pair": (torch.zeros(2, dtype=torch.int32), 0.0)}
        got = m.restore(template)
    assert got["w"].dtype == torch.float64 and torch.equal(got["w"], tree["w"].double())
    assert got["meta"] == {"n": 3, "names": ["a", "b"]}
    assert torch.equal(got["pair"][0], tree["pair"][0]) and got["pair"][1] == 0.5


def test_corrupt_newest_step_is_quarantined_and_restore_falls_back(tmp_path):
    state = _state()
    with checkpoint.CheckpointManager(tmp_path / "q", async_save=False) as m:
        m.save(0, _train(state, 1))
        first = _weights(state)
        m.save(1, _train(state, 1, seed=3))
        faultinject.corrupt_directory(m.directory / "1")
        assert "checksum" in m.verify_step(1) or "size" in m.verify_step(1)
        restored = m.restore(_state(seed=5))
        assert restored.step == 1 and m.all_steps() == [0]
        assert (m.directory / "corrupt_1.quarantined").is_dir()
        assert not (m.directory / "manifest_1.json").exists()
    _assert_same_weights(_weights(restored), first)
    # restore_or_init starts over once every step is corrupt.
    faultinject.corrupt_directory(tmp_path / "q" / "0")
    fresh = _state(seed=6)
    out, start = checkpoint.restore_or_init(fresh, tmp_path / "q")
    assert out is fresh and start == 0


def test_chunk_digests_find_a_flipped_byte_and_whole_file_manifests_still_verify(
        tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "_DIGEST_CHUNK", 4096)
    with checkpoint.CheckpointManager(tmp_path / "c", async_save=False) as m:
        m.save(0, _state())
        manifest = json.loads((m.directory / "manifest_0.json").read_text())
        meta = manifest["files"]["state.pt"]
        path = m.directory / "0" / "state.pt"
        assert meta["chunk_bytes"] == 4096
        assert len(meta["sha256_chunks"]) == -(-path.stat().st_size // 4096) > 2
        assert m.verify_step(0) is None
        # A manifest of whole-file digests (the format before chunks).
        whole = {"step": 0, "files": {
            rel: {"size": f["size"], "sha256": checkpoint._file_sha256(m.directory / "0" / rel)}
            for rel, f in manifest["files"].items()}}
        (m.directory / "manifest_0.json").write_text(json.dumps(whole))
        assert m.verify_step(0) is None
        (m.directory / "manifest_0.json").write_text(json.dumps(manifest))
        data = bytearray(path.read_bytes())
        data[4096 * 2 + 7] ^= 1  # one bit in the third chunk; the size is unchanged
        path.write_bytes(bytes(data))
        assert m.verify_step(0) == "state.pt: checksum mismatch"
        (m.directory / "manifest_0.json").write_text(json.dumps(whole))
        assert m.verify_step(0) == "state.pt: checksum mismatch"


def test_explicit_corrupt_step_raises_and_renames_nothing(tmp_path):
    with checkpoint.CheckpointManager(tmp_path / "e", async_save=False) as m:
        m.save(0, _state())
        faultinject.corrupt_directory(m.directory / "0")
        with pytest.raises(checkpoint.CheckpointCorruptError):
            m.restore(_state(), step=0)
        assert m.all_steps() == [0]
        assert not list(m.directory.glob("corrupt_*"))


def test_manifest_less_step_is_quarantined_only_when_damaged(tmp_path):
    with checkpoint.CheckpointManager(tmp_path / "l", async_save=False) as m:
        m.save(0, _state())
        m.save(1, _state())
        (m.directory / "manifest_1.json").unlink()
        (m.directory / "1" / "state.pt").write_bytes(b"not a checkpoint")
        (m.directory / "1" / "index.json").unlink()  # structurally damaged
        restored = m.restore(_state())
        assert restored.step == 0 and m.all_steps() == [0]


def test_fault_points_corrupt_on_save_and_restore(tmp_path):
    state = _state()
    try:
        faultinject.arm(faultinject.FaultPlan.parse("checkpoint.save=corrupt@times=1,after=1"))
        with checkpoint.CheckpointManager(tmp_path / "f", async_save=True) as m:
            m.save(0, _train(state, 1))
            m.save(1, _train(state, 1))  # corrupted after its manifest
            m.wait()
            assert m.verify_step(0) is None and m.verify_step(1) is not None
            assert m.restore(_state()).step == 1  # step 1 quarantined
        faultinject.arm(faultinject.FaultPlan.parse("checkpoint.restore=corrupt@times=1"))
        with checkpoint.CheckpointManager(tmp_path / "f", async_save=False) as m:
            m.save(2, state)
            assert m.restore(_state()).step == 1  # the newest, 2, damaged at rest
            assert m.all_steps() == [0]
    finally:
        faultinject.disarm()


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_write_interrupted_before_publish_leaves_no_step(tmp_path, monkeypatch, async_save):
    real_save = torch.save

    def half_then_die(obj, f, *a, **k):
        Path(f).write_bytes(b"PK\x03\x04 partial")
        raise OSError("disk went away mid-write")

    with checkpoint.CheckpointManager(tmp_path / "w", async_save=async_save) as m:
        m.save(0, _state())
        m.wait()
        monkeypatch.setattr(torch, "save", half_then_die)
        with pytest.raises(OSError, match="mid-write"):
            m.save(1, _state(), force=True)
            m.wait()  # an async write's error surfaces here
        monkeypatch.setattr(torch, "save", real_save)
        assert m.all_steps() == [0]
        assert not list(m.directory.glob(".tmp-*"))
    assert checkpoint.CheckpointManager(tmp_path / "w").latest_step() == 0


def test_abandoned_temporary_directory_is_invisible_and_swept(tmp_path):
    d = tmp_path / "s"
    (d / ".tmp-3-deadbeef").mkdir(parents=True)
    (d / ".tmp-3-deadbeef" / "state.pt").write_bytes(b"x")
    m = checkpoint.CheckpointManager(d)
    assert m.all_steps() == [] and not (d / ".tmp-3-deadbeef").exists()


def test_supervisor_recovers_from_a_planted_step_failure(tmp_path):
    step_fn = common.make_train_step()
    failed = []

    def flaky(state, batch):
        if state.step == 3 and not failed:
            failed.append(state.step)
            raise RuntimeError("transient device fault")
        return step_fn(state, batch)

    state, _, done = run_preemptible(
        flaky, _state(), _batches(6), directory=str(tmp_path / "ck"), save_every=2,
        guard=PreemptionGuard(install=False), max_recoveries=1)
    assert failed == [3] and done == 6 and state.step == 6
    ref, _, _ = run_preemptible(
        step_fn, _state(), _batches(6), directory=str(tmp_path / "ref"), save_every=2,
        guard=PreemptionGuard(install=False))
    _assert_same_weights(_weights(state), _weights(ref))
    with pytest.raises(RuntimeError, match="transient"):
        failed.clear()
        run_preemptible(flaky, _state(), _batches(6), directory=str(tmp_path / "none"),
                        save_every=2, guard=PreemptionGuard(install=False))


# -- preempt-and-resume is bit-identical --------------------------------------


def _lm_case():
    cfg = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2)
    params = random_params(**cfg, seed=0)

    def make():
        model = TransformerLM(**cfg, dtype="float32", dropout_rate=0.1, max_decode_len=32,
                              device="cpu").load_flax(params)
        return common.create_train_state(model, seed=11)

    rs = np.random.RandomState(0)
    batches = [{"tokens": rs.randint(0, 64, (2, 9)).astype(np.int32)} for _ in range(8)]
    return make, make_lm_train_step(), batches


def _resnet_case():
    def make():
        return common.create_bn_train_state(
            ResNet18ish(dtype="float32", device="cpu", seed=3), learning_rate=0.01)

    data = common.SyntheticClassData(shape=(16, 16, 3), seed=4, device="cpu")
    return make, common.make_bn_train_step(), list(data.batches(4, 8))


def _cnn_case():
    def make():
        return common.create_train_state(CNN(dtype="float32", device="cpu", seed=5), seed=9)

    data = common.SyntheticClassData(seed=6, device="cpu")
    return make, common.make_train_step(), list(data.batches(4, 8))


@pytest.mark.parametrize("case", [_lm_case, _resnet_case, _cnn_case], ids=["lm", "resnet", "cnn"])
def test_preempt_and_resume_is_bit_identical(tmp_path, case):
    """Eight steps straight through against five, a real SIGTERM, a
    checkpoint, and a second incarnation that restores and finishes:
    the same losses and the same final weights, statistics and optimizer
    state, bit for bit (dropout masks derive from the restored step)."""
    make, step_fn, batches = case()
    losses_a = []

    def logged(losses, preempt_at=None):
        def fn(state, batch):
            if preempt_at is not None and state.step == preempt_at:
                os.kill(os.getpid(), signal.SIGTERM)
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return fn

    a, _, done = run_preemptible(logged(losses_a), make(), batches,
                                 directory=str(tmp_path / "a"), save_every=4)
    assert done == 8
    losses_b = []
    with PreemptionGuard() as guard:
        _, _, done = run_preemptible(logged(losses_b, preempt_at=4), make(), batches,
                                     directory=str(tmp_path / "b"), save_every=4, guard=guard)
    assert done == 5
    c, _, done = run_preemptible(logged(losses_b), make(), batches,
                                 directory=str(tmp_path / "b"), save_every=4)
    assert done == 8 and c.step == 8
    assert losses_b == losses_a
    _assert_same_weights(_weights(c), _weights(a))
    opt_a, opt_c = a.optimizer.state_dict()["state"], c.optimizer.state_dict()["state"]
    for i in opt_a:
        for k, v in opt_a[i].items():
            assert torch.equal(opt_c[i][k], v), (i, k)


# -- two processes agree on the stop step -------------------------------------

_GLOO_WORKER = textwrap.dedent("""
    import sys, time
    import torch.distributed as dist
    from hops_tpu_torch.runtime.preemption import PreemptionGuard

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    with PreemptionGuard() as guard:
        for step in range(2000):
            time.sleep(0.01)
            print(f"step {step}", flush=True)
            if guard.should_stop(sync=True):
                print(f"stopped {step}", flush=True)
                break
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sigterm_to_one_gloo_process_stops_both_at_the_same_step():
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r), str(port)],
                              stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for r in range(2)]
    try:
        for line in procs[1].stdout:
            if line.startswith("step 20"):
                break
        procs[1].send_signal(signal.SIGTERM)
        stops = []
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0
            stops.append([ln for ln in out.splitlines() if ln.startswith("stopped")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert stops[0] == stops[1] and len(stops[0]) == 1
    assert int(stops[0][0].split()[1]) >= 20
