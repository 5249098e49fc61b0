"""The port's distribution layer (``hops_tpu_torch.parallel`` and
``hops_tpu_torch.launch``) against the JAX package's, on the CPU.

In one process (no process group, the world of one rank) the cases of
``tests/test_parallel.py``'s ``TestMesh``, ``TestStrategy``,
``TestMultihost``, the launch CLI and ``TestHybridMesh``'s axes and
strategy cases run on meshes of explicit ranks. Across processes,
``python -m hops_tpu_torch.launch --platform cpu`` starts 2 or 4 gloo
ranks (a free port per test, a timeout per child) that train the
reference's tiny linear model and a 2-layer, d_model 32 LM (SGD with
momentum) for 3 steps through ``experiment.collective_all_reduce`` (DDP) and
``ShardedStrategy(fsdp=2)`` (FSDP2), each rank fed its slice of a
global batch; the JAX package trains the same models from the same
weights on the same global batches with ``CollectiveAllReduceStrategy``
over the fake 8-device mesh. Losses and final weights must agree at
``rtol 1e-5, atol 1e-6`` (fp32; other summation orders). The workers
also check the multi-rank mesh, multihost, sharding and batch-inference
helpers. The tensor-parallel cases wait for tensor parallelism.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hops_tpu.models import common as jax_common
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.models.transformer import make_lm_train_step as jax_lm_step
from hops_tpu.parallel import CollectiveAllReduceStrategy as JaxCAR
from hops_tpu_torch import launch
from hops_tpu_torch.models.convert import flatten
from hops_tpu_torch.parallel import (
    CollectiveAllReduceStrategy,
    MirroredStrategy,
    ParameterServerStrategy,
    ShardedStrategy,
    Strategy,
    current_strategy,
    get_strategy,
    mesh as mesh_lib,
    multihost,
)
from hops_tpu_torch.parallel import sharding

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
# The LM trains under SGD with momentum 0.9 (optax.sgd; torch.optim.SGD,
# whose trace also starts at the first gradient): its update is linear in
# the gradient. Adam divides by sqrt(v) + eps, which turns the two
# frameworks' last-bit differences in a near-zero gradient element into
# weight differences of up to lr (2.9e-5 at lr 1e-3 in one element of
# 4096, measured), whatever the distribution does.
LR = 0.1
GLOBAL_ROWS = 8
CHUNK = 8  # 8 rows x 12 targets: 12 chunks of the LM-head loss
CHILD_TIMEOUT = 150


@pytest.fixture
def cpu_process():
    """This process's device is the CPU (as ``--platform cpu`` makes it);
    forgotten again after the test."""
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


# -- one process ----------------------------------------------------------------


class TestMesh:
    def test_default_mesh_covers_all(self):
        # No process group: the world is one rank.
        assert mesh_lib.global_mesh().shape["data"] == 1

    def test_dict_shape(self):
        m = mesh_lib.make_mesh({"data": 4, "model": 2}, devices=range(8))
        assert m.shape == {"data": 4, "model": 2}

    def test_minus_one_infers(self):
        m = mesh_lib.make_mesh((-1, 2), ("data", "model"), devices=range(8))
        assert m.shape["data"] == 4

    def test_bad_shape_raises(self):
        with pytest.raises(ValueError):
            mesh_lib.make_mesh((3, 2), ("data", "model"), devices=range(8))

    def test_shard_batch_places_the_ranks_rows(self):
        m = mesh_lib.make_mesh(devices=range(8))
        batch = {"x": np.arange(64, dtype=np.float32).reshape(16, 4)}
        out = mesh_lib.shard_batch(m, batch, device="cpu")
        # 16 rows over 8 ranks -> rank 0 holds rows 0-1.
        np.testing.assert_array_equal(out["x"].numpy(), batch["x"][:2])
        assert mesh_lib.batch_sharding(m)[0] == torch.distributed.tensor.Shard(0)

    def test_device_scope_limits_default_meshes(self):
        with mesh_lib.device_scope([0]):
            assert mesh_lib.scoped_devices() == [0]
            assert mesh_lib.global_mesh().size == mesh_lib.local_mesh().size == 1
        assert mesh_lib.scoped_devices() is None

    def test_pvary_and_replicate(self):
        x = torch.ones(3)
        assert mesh_lib.pvary(x, ("data", None)) is x
        m = mesh_lib.global_mesh()
        out = mesh_lib.replicate(m, {"w": np.ones(3, np.float32), "n": 2}, device="cpu")
        assert out["n"] == 2 and out["w"].dtype == torch.float32

    def test_device_mesh_needs_a_process_group(self):
        with pytest.raises(RuntimeError, match="process group"):
            mesh_lib.global_mesh().device_mesh()


class TestSharding:
    @pytest.mark.parametrize("shape,want", [
        ((64, 128), 1), ((128, 64), 0), ((3, 4096), 1), ((8,), None), ((4, 4), None)])
    def test_infer_param_spec_matches_the_jax_rule(self, shape, want):
        from jax.sharding import PartitionSpec as P

        from hops_tpu.parallel import sharding as jax_sharding

        jspec = jax_sharding.infer_param_spec(np.zeros(shape), "model", 2, min_size=64)
        spec = sharding.infer_param_spec({"p": torch.zeros(shape)}, "model", 2, min_size=64)["p"]
        if want is None:
            assert jspec == P() and isinstance(spec, torch.distributed.tensor.Replicate)
        else:
            assert jspec[want] == "model" and spec == torch.distributed.tensor.Shard(want)

    def test_sharding_tree_places_one_axis(self):
        from torch.distributed.tensor import Replicate, Shard

        m = mesh_lib.make_mesh({"data": 2, "model": 4}, devices=range(8))
        tree = sharding.sharding_tree(m, {"w": Shard(1)}, axis="model")
        assert tree["w"] == [Replicate(), Shard(1)]


def _linear_data():
    rs = np.random.RandomState(0)
    x = rs.randn(16, 4).astype(np.float32)
    y = x @ np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    return x, y


def _torch_linear_step(w, batch):
    loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
    (g,) = torch.autograd.grad(loss, w)
    return w - 0.1 * g, {"loss": loss.detach()}


def _jax_linear_step(w, batch):
    def loss(w):
        return jnp.mean((batch["x"] @ w - batch["y"]) ** 2)

    return w - 0.1 * jax.grad(loss)(w), {"loss": loss(w)}


class TestStrategy:
    def test_replica_counts(self, cpu_process):
        assert CollectiveAllReduceStrategy().num_replicas_in_sync == 1
        assert MirroredStrategy().num_replicas_in_sync == 1
        assert ParameterServerStrategy is CollectiveAllReduceStrategy
        assert Strategy().num_hosts == 1

    def test_global_batch_size(self):
        s = Strategy(mesh_lib.make_mesh(devices=range(8)), device="cpu")
        assert s.global_batch_size(32) == 256

    def test_scope_stack(self, cpu_process):
        assert current_strategy() is None
        s = MirroredStrategy()
        with s.scope():
            assert current_strategy() is s
            assert get_strategy() is s
        assert current_strategy() is None
        assert get_strategy().num_replicas_in_sync == 1  # default strategy

    def test_step_matches_the_jax_strategy_on_the_global_batch(self, cpu_process):
        """A linear-regression step on plain tensors: the port's update
        equals the JAX strategy's over 8 replicas of the global batch."""
        x, y = _linear_data()
        js = JaxCAR()
        jw, jm = js.step(_jax_linear_step, donate_state=False)(
            js.replicate(jnp.zeros((4,))), js.distribute_batch({"x": x, "y": y}))
        s = CollectiveAllReduceStrategy()
        w, m = s.step(_torch_linear_step, donate_state=False)(
            s.replicate(torch.zeros(4)), s.distribute_batch({"x": x, "y": y}))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **TOL)
        assert m["loss"].shape == () and not w.requires_grad

    def test_steps_are_memoized(self, cpu_process):
        s = Strategy()
        assert s.step(_torch_linear_step) is s.step(_torch_linear_step)
        assert s.step(_torch_linear_step, donate_state=False) is not s.step(_torch_linear_step)

    def test_gradient_communication_is_a_later_slice(self):
        with pytest.raises(NotImplementedError, match="gradient-communication slice"):
            Strategy(mesh_lib.global_mesh(), grad_comms=object())
        with pytest.raises(NotImplementedError, match="gradient-communication slice"):
            CollectiveAllReduceStrategy(update_sharding="cross_replica")
        with pytest.raises(NotImplementedError, match="gradient-communication slice"):
            MirroredStrategy(grad_comms=object())
        with pytest.raises(NotImplementedError, match="gradient-communication slice"):
            Strategy(device="cpu").step(_torch_linear_step, grad_comms=object())

    def test_sharded_strategy_limits(self):
        with pytest.raises(NotImplementedError, match="item 5"):
            ShardedStrategy(model=2)
        s = ShardedStrategy(fsdp=-1, device="cpu")
        assert s.mesh.shape == {"data": 1, "fsdp": 1, "model": 1}
        with pytest.raises(ValueError, match="already owns its collectives"):
            s.step(_torch_linear_step, grad_comms=object())
        with pytest.raises(TypeError, match="TrainState"):
            s.shard_state({"w": torch.zeros(2)})


class TestMultihost:
    def test_single_process_helpers(self):
        multihost.initialize()  # no-op single process
        assert multihost.is_chief()
        assert multihost.process_count() == 1
        assert multihost.all_hosts_agree(3.0)
        multihost.barrier("t")
        assert multihost.broadcast_from_chief(np.float32(5.0)) == 5.0

    def test_joining_needs_every_coordinate(self):
        with pytest.raises(ValueError, match="process_id"):
            multihost.initialize("127.0.0.1:1", num_processes=2, device="cpu")


def test_launch_cli_single_host(tmp_path, capsys):
    """python -m hops_tpu_torch.launch script.py — a single process needs
    no flags; --platform cpu makes the CPU its device, then forgets it."""
    script = tmp_path / "train.py"
    script.write_text(
        "import sys\n"
        "from hops_tpu_torch.parallel import multihost\n"
        "print('launched', sys.argv[1:], multihost.device())\n")
    launch.main(["--platform", "cpu", str(script), "--epochs", "3"])
    assert "launched ['--epochs', '3'] cpu" in capsys.readouterr().out
    assert multihost._device is None


class TestHybridMesh:
    """Multi-host (network x NVLink) mesh layout (mesh.hybrid_mesh), with
    rank quartets standing in for hosts."""

    def _mesh(self):
        return mesh_lib.hybrid_mesh(
            ici={"data": 2, "model": 2}, dcn={"replica": 2},
            devices=range(8), slice_id=lambda r: r // 4)

    def test_axes_and_slice_locality(self):
        mesh = self._mesh()
        assert mesh.shape == {"replica": 2, "data": 2, "model": 2}
        for r in range(2):
            assert len({int(d) // 4 for d in mesh.devices[r].flat}) == 1

    def test_mismatched_slices_raise(self):
        with pytest.raises(ValueError, match="slices"):
            mesh_lib.hybrid_mesh(ici={"data": 4}, dcn={"replica": 3},
                                 devices=range(8), slice_id=lambda r: r // 4)
        with pytest.raises(ValueError, match="chips per slice"):
            mesh_lib.hybrid_mesh(ici={"data": 2}, dcn={"replica": 2},
                                 devices=range(8), slice_id=lambda r: r // 4)

    def test_strategy_over_hybrid_mesh(self):
        st = Strategy(self._mesh(), data_axis=("replica", "data"), device="cpu")
        assert st.num_replicas_in_sync == 4
        assert st.global_batch_size(2) == 8
        # Rank 0 sits at replica 0, data 0: the first quarter of the rows.
        rows = st.distribute_batch({"x": np.arange(8)})["x"]
        np.testing.assert_array_equal(rows.numpy(), [0, 1])


# -- several processes ------------------------------------------------------------

WORKER = r'''
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from hops_tpu_torch import experiment
from hops_tpu_torch.models.common import create_train_state
from hops_tpu_torch.models.convert import load_npz
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
from hops_tpu_torch.modelrepo.batch import batch_predict
from hops_tpu_torch.parallel import (CollectiveAllReduceStrategy, MirroredStrategy,
                                     ShardedStrategy, get_strategy, mesh, multihost, sharding)
from hops_tpu_torch.runtime import config, rundir

mode, data, out = sys.argv[1], sys.argv[2], sys.argv[3]
cfg = json.loads(sys.argv[4])
config.configure(workspace=sys.argv[5], project="parity")
rank, n = multihost.process_index(), multihost.process_count()
arrays = dict(np.load(data))
params = load_npz(data.replace("data.npz", "params.npz"))


def lm(strategy, chunk):
    model = TransformerLM(**cfg["model"], dtype="float32", device=strategy.device).load_flax(params)
    opt = torch.optim.SGD(model.parameters(), lr=cfg["lr"], momentum=0.9)
    state = create_train_state(model, optimizer=opt)
    state = (strategy.shard_state(state) if isinstance(strategy, ShardedStrategy)
             else strategy.replicate(state))
    step = strategy.step(make_lm_train_step(loss_chunk=chunk))
    losses = []
    for i in range(3):
        state, m = step(state, strategy.distribute_batch({"tokens": arrays[f"tokens{i}"]}))
        losses.append(m["loss"].item())
    weights = {}
    for name, p in state.model.named_parameters():
        full = p.full_tensor() if hasattr(p, "full_tensor") else p
        weights[name.replace(".", "/")] = full.detach().numpy()
    return losses, weights


def linear(strategy):
    def step(w, batch):
        loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
        (g,) = torch.autograd.grad(loss, w)
        return w - 0.1 * g, {"loss": loss.detach()}

    w = strategy.replicate(torch.zeros(4))
    losses = []
    for _ in range(3):
        w, m = strategy.step(step)(w, strategy.distribute_batch({"x": arrays["x"], "y": arrays["y"]}))
        losses.append(m["loss"].item())
    return losses, w.numpy()


def checks(s):
    mh = mesh.make_mesh({"data": n // 2, "model": 2})
    rows = s.distribute_batch({"r": np.arange(2 * n)})["r"].tolist()
    sp = sharding.shard_params(mesh.make_mesh({"model": n}), {"w": torch.arange(8.0 * 16).reshape(8, 16)}, min_size=1)["w"]
    rep = s.replicate({"v": torch.full((2,), float(rank))})["v"].tolist()
    preds = batch_predict(lambda t: t * 2, np.arange(10, dtype=np.float32).reshape(10, 1), per_chip_batch=2, strategy=s)
    multihost.barrier("checks")
    return {
        "count": n, "index": rank, "chief": multihost.is_chief(),
        "bcast": multihost.broadcast_from_chief(rank), "agree": multihost.all_hosts_agree(3.0),
        "disagree": multihost.all_hosts_agree(float(rank)),
        "global": mesh.global_mesh().shape["data"], "local": mesh.local_mesh().shape["data"],
        "hybrid": mh.shape, "coords": mh.coords(), "rows": rows,
        "mirrored": MirroredStrategy().num_replicas_in_sync,
        "replicas": s.num_replicas_in_sync, "hosts": s.num_hosts,
        "shard": list(sp.to_local().shape), "shard_ok": bool(torch.equal(sp.full_tensor(), torch.arange(8.0 * 16).reshape(8, 16))),
        "replicated": rep, "preds": preds.reshape(-1).tolist(),
        "session": rundir.session_id(),
    }


result = {}
if mode == "car":
    got = {}

    def train_fn():
        s = get_strategy()
        got["checks"], got["linear"] = checks(s), linear(s)
        got["lm"] = {str(c): lm(s, c or None) for c in cfg["chunks"]}
        return {"loss": got["lm"][str(cfg["chunks"][0])][0][-1]}

    path, _ = experiment.collective_all_reduce(train_fn, name="parity")
    result = {"path": path, "checks": got["checks"],
              "linear": [got["linear"][0], got["linear"][1].tolist()],
              "lm": {c: v[0] for c, v in got["lm"].items()}}
    weights = {f"{c}/{k}": w for c, v in got["lm"].items() for k, w in v[1].items()}
else:
    s = ShardedStrategy(fsdp=2)
    with s.scope():
        losses, w = lm(s, cfg["chunks"][0] or None)
    # An optimizer with state before sharding (the same step on every
    # rank) carries it onto the sharded parameters.
    model = TransformerLM(**cfg["model"], dtype="float32", device="cpu").load_flax(params)
    state = create_train_state(model)
    model(torch.from_numpy(arrays["tokens0"]).long()).square().mean().backward()
    state.optimizer.step()
    before = {n: state.optimizer.state[p]["exp_avg"].clone() for n, p in model.named_parameters()}
    state = s.shard_state(state)
    carried = all(
        torch.equal(state.optimizer.state[p]["exp_avg"].full_tensor(), before[n])
        and state.optimizer.state[p]["exp_avg"].placements == p.placements
        for n, p in state.model.named_parameters())
    result = {"lm": {str(cfg["chunks"][0]): losses}, "fsdp_mesh": s.mesh.shape,
              "carried": carried}
    weights = {f"{cfg['chunks'][0]}/{k}": v for k, v in w.items()}
json.dump(result, open(f"{out}/rank{rank}.json", "w"))
if rank == 0:
    np.savez(f"{out}/weights.npz", **weights)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path: Path, n: int, *args: str) -> list[str]:
    """``python -m hops_tpu_torch.launch --platform cpu`` on ``n`` gloo
    ranks running ``WORKER`` with ``args``; each child has its own
    timeout. Returns their outputs."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hops_tpu_torch.launch", "--platform", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(i), str(worker), *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
    ) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    return outs


def _tokens(i: int) -> np.ndarray:
    return np.random.default_rng(10 + i).integers(
        0, CFG["vocab_size"], (GLOBAL_ROWS, 13)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's CollectiveAllReduceStrategy over the fake
    8-device mesh: the linear model and the LM (dense and chunked loss),
    3 steps on the global batches, from the weights the workers load."""
    d = tmp_path_factory.mktemp("jax_parity")
    js = JaxCAR()
    assert js.num_replicas_in_sync == 8
    x, y = _linear_data()
    w, lin_losses = js.replicate(jnp.zeros((4,))), []
    step = js.step(_jax_linear_step, donate_state=False)
    for _ in range(3):
        w, m = step(w, js.distribute_batch({"x": x, "y": y}))
        lin_losses.append(float(m["loss"]))
    jm = JaxLM(**CFG, dtype=jnp.float32, attention_impl="reference")
    init = jax_common.create_train_state(jm, jax.random.PRNGKey(0), (1, 8),
                                         optax.sgd(LR, momentum=0.9), input_dtype=jnp.int32)
    params = flatten(jax.device_get(init.params))
    np.savez(d / "params.npz", **params)
    np.savez(d / "data.npz", x=x, y=y, **{f"tokens{i}": _tokens(i) for i in range(3)})
    lm = {}
    for chunk in (0, CHUNK):
        state = js.replicate(init)
        lm_step = js.step(jax_lm_step(loss_chunk=chunk or None), donate_state=False)
        losses = []
        for i in range(3):
            state, m = lm_step(state, js.distribute_batch({"tokens": _tokens(i)}))
            losses.append(float(m["loss"]))
        lm[chunk] = losses, flatten(jax.device_get(state.params))
    return {"dir": d, "linear": (lin_losses, np.asarray(w)), "lm": lm}


def _check_lm(got_losses, weights, chunk, jax_runs):
    want_losses, want = jax_runs["lm"][chunk]
    np.testing.assert_allclose(got_losses, want_losses, **TOL)
    for name, arr in want.items():
        np.testing.assert_allclose(weights[f"{chunk}/{name}"], arr, err_msg=name, **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_collective_all_reduce_matches_jax(tmp_path, jax_runs, n):
    """N gloo ranks through the launch CLI and experiment.collective_all_reduce
    (DDP) on their slices of the global batch train the linear model and
    the LM (dense and chunked loss) to the JAX strategy's losses and
    weights; the workers' multi-rank helper checks hold."""
    cfg = {"model": CFG, "lr": LR, "chunks": [0, CHUNK]}
    _run_ranks(tmp_path, n, "car", str(jax_runs["dir"] / "data.npz"), str(tmp_path),
               json.dumps(cfg), str(tmp_path / "ws"))
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(n)]
    weights = dict(np.load(tmp_path / "weights.npz"))
    lin_losses, lin_w = jax_runs["linear"]
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["linear"][0], lin_losses, **TOL)
        np.testing.assert_allclose(res["linear"][1], lin_w, **TOL)
        for chunk in (0, CHUNK):
            np.testing.assert_allclose(res["lm"][str(chunk)], jax_runs["lm"][chunk][0], **TOL)
        c = res["checks"]
        assert (c["count"], c["index"], c["chief"]) == (n, r, r == 0)
        assert c["bcast"] == 0 and c["agree"] and not c["disagree"]
        assert c["global"] == c["local"] == c["mirrored"] == c["replicas"] == n
        assert c["hybrid"] == {"data": n // 2, "model": 2} and c["hosts"] == 1
        assert c["coords"] == {"data": r // 2, "model": r % 2}
        assert c["rows"] == [2 * r, 2 * r + 1]
        assert c["shard"] == [8, 16 // n] and c["shard_ok"]
        assert c["replicated"] == [0.0, 0.0]
        assert c["preds"] == [2.0 * i for i in range(10)]
    # Every rank agreed on one session, so one run directory.
    assert len({res["checks"]["session"] for res in results}) == 1
    assert len({res["path"] for res in results}) == 1
    for chunk in (0, CHUNK):
        _check_lm(results[0]["lm"][str(chunk)], weights, chunk, jax_runs)


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["dense", "chunked"])
def test_sharded_strategy_matches_jax(tmp_path, jax_runs, chunk):
    """ShardedStrategy(fsdp=2) on 2 gloo ranks (FSDP2; the chunked loss
    reads unembed.kernel after the forward) trains the LM to the JAX
    strategy's losses and weights."""
    cfg = {"model": CFG, "lr": LR, "chunks": [chunk]}
    _run_ranks(tmp_path, 2, "sharded", str(jax_runs["dir"] / "data.npz"), str(tmp_path),
               json.dumps(cfg), str(tmp_path / "ws"))
    res = json.loads((tmp_path / "rank0.json").read_text())
    assert res["fsdp_mesh"] == {"data": 1, "fsdp": 2, "model": 1} and res["carried"]
    _check_lm(res["lm"][str(chunk)], dict(np.load(tmp_path / "weights.npz")), chunk, jax_runs)
