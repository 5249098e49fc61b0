"""The port's gradient communication (``hops_tpu_torch.parallel.grad_comms``)
against the JAX package's, on the CPU.

In one process, against the JAX functions on the same arrays: the
config (``parse`` of every mode, the validation, ``mode``),
``quantize_blockwise`` (int8 values and scales exactly equal), the
bucket round trip and layout, ``hier_groups``, ``wire_bytes``, and the
strategy's marker checks, memo and constructors; at one rank every mode
trains bit for bit like the plain step.

Across four gloo processes (``python -m hops_tpu_torch.launch --platform
cpu``, one launch for the whole family, the results gathered in a
module-scoped fixture): the cases of ``tests/test_grad_comms.py``, each its
own test. The JAX package runs the same tiny MLP (bias before kernel, in
its tree order, so the buckets coincide) from the same weights on the same
global batch over the fake mesh's first 4 devices; the hierarchy runs at
2 hosts x 2. Every mode of ``GradCommsConfig.parse`` under SGD with
momentum matches JAX's losses and weights at ``rtol 1e-5, atol 1e-6``
(fp32; the quantized modes quantize the same buffers, so their int8
steps agree). Within the port: ZeRO-1/2/3 equal the replicated update
at ``atol 1e-6`` (SGD and Adam, weights and moments); overlap equals
sequential, hier equals flat and quantized hier equals quantized flat
bit for bit — every floating reduction folds the addends in rank order.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
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
from flax import linen as fnn

from hops_tpu.models import common as jax_common
from hops_tpu.parallel import grad_comms as jgc
from hops_tpu.parallel import mesh as jax_mesh
from hops_tpu.parallel.strategy import Strategy as JaxStrategy
from hops_tpu_torch.models import common
from hops_tpu_torch.models.convert import flatten
from hops_tpu_torch.parallel import (
    CollectiveAllReduceStrategy,
    ShardedStrategy,
    Strategy,
    grad_comms as gc,
    mesh as mesh_lib,
    multihost,
)
from hops_tpu_torch.telemetry.metrics import REGISTRY

ROOT = Path(__file__).resolve().parent.parent
N = 4
TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ["allreduce", "quantized", "overlap", "quantized+overlap", "zero1", "quantized+zero1",
         "zero2", "quantized+zero2", "zero3", "quantized+zero3", "hier", "quantized+hier",
         "hier+overlap", "quantized+hier+overlap", "hier+zero1"]
CHILD_TIMEOUT = 240

torch.set_num_threads(1)


def _qd(jdt):
    return {jnp.dtype(jnp.int8): torch.int8, jnp.dtype(jnp.bfloat16): torch.bfloat16}[jnp.dtype(jdt)]


# -- one process: the config ------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", *MODES])
def test_parse_matches_jax(mode):
    want, got = jgc.GradCommsConfig.parse(mode), gc.GradCommsConfig.parse(mode)
    if want is None:
        assert got is None and gc.GradCommsConfig.parse(None) is None
        return
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert (_qd(w) if f.name == "qdtype" else w) == g, f.name
    assert got.mode == want.mode == mode and got.zero_stage == want.zero_stage


@pytest.mark.parametrize("kw,match", [
    (dict(update_sharding="sideways"), "update_sharding"),
    (dict(overlap=True, update_sharding="cross_replica"), "replicated update only"),
    (dict(local_only=True, overlap=True), "bench timing"),
    (dict(local_only=True, hierarchy=2), "bench timing"),
    (dict(hierarchy=1), "counts hosts"),
    (dict(hierarchy=2, update_sharding="zero3"), "zero3"),
])
def test_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jgc.GradCommsConfig(**kw)
    with pytest.raises(ValueError, match=match):
        gc.GradCommsConfig(**kw)


def test_modes_and_unknown_flag():
    assert gc.GradCommsConfig(local_only=True).mode == jgc.GradCommsConfig(local_only=True).mode
    both = gc.GradCommsConfig.parse("quantized+zero1")
    assert dataclasses.replace(both, quantize=False).mode == "zero1"
    with pytest.raises(ValueError):
        gc.GradCommsConfig.parse("fp4")
    with pytest.raises(ValueError, match="qdtype"):
        gc.GradCommsConfig(qdtype=torch.float16)


# -- one process: the wire format, buckets, groups, bytes ----------------------------


@pytest.mark.parametrize("shape,block", [((3, 50), 32), ((1000,), 256), ((7, 9, 5), 64),
                                         ((4, 128), 128)])
def test_quantize_blockwise_matches_jax_exactly(shape, block):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 3.0
    flat = x.reshape(-1)
    flat[:block] = 0.0  # an all-zero block: scale 1
    flat[block:block + 4] = [127.0, 2.5, -3.5, 0.5]  # amax 127: scale 1, ties to even
    flat[block + 4:2 * block] = 0.0
    wq, ws = jgc.quantize_blockwise(jnp.asarray(x), block)
    q, s = gc.quantize_blockwise(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert q.reshape(-1)[block:block + 4].tolist() == [127, 2, -4, 0]
    back = gc.dequantize_blockwise(q, s, x.size, x.shape, torch.float32)
    want = jgc.dequantize_blockwise(wq, ws, x.size, x.shape, jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    assert np.abs(back.numpy() - x).max() <= 0.5 * s.max().item()
    qb, sb = gc.quantize_blockwise(torch.from_numpy(x), block, torch.bfloat16)
    wqb, _ = jgc.quantize_blockwise(jnp.asarray(x), block, jnp.bfloat16)
    assert sb is None and qb.dtype == torch.bfloat16
    np.testing.assert_array_equal(qb.float().numpy(), np.asarray(wqb, np.float32))


def _tree(rs):
    return {
        "a": rs.randn(3, 5).astype(np.float32),
        "b": {"c": rs.randn(2, 2).astype(np.float32), "w": rs.randn(7).astype(np.float32)},
        "d": rs.randn(11).astype(np.float32),
    }


@pytest.mark.parametrize("bucket_bytes,pad", [(1 << 20, 1), (40, 8), (1, 4)])
def test_bucket_roundtrip_and_layout_match_jax(bucket_bytes, pad):
    tree = _tree(np.random.RandomState(3))
    leaves = [tree["a"], tree["b"]["c"], tree["b"]["w"], tree["d"]]  # JAX's tree order
    wbufs, _ = jgc.flatten_buckets(jax.tree.map(jnp.asarray, tree), bucket_bytes, pad)
    ttree = [torch.from_numpy(x) for x in leaves]
    bufs, layout = gc.flatten_buckets(ttree, bucket_bytes, pad)
    assert len(bufs) == len(wbufs)
    for b, w in zip(bufs, wbufs):
        assert b.ndim == 1 and b.shape[0] % pad == 0
        np.testing.assert_array_equal(b.numpy(), np.asarray(w))
    out = gc.unflatten_buckets(bufs, layout)
    for a, b in zip(out, ttree):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    bf = {"x": torch.ones(3), "y": torch.ones(5, dtype=torch.bfloat16)}
    bbufs, blayout = gc.flatten_buckets(bf, bucket_bytes, pad)
    back = gc.unflatten_buckets(bbufs, blayout)
    assert back["y"].dtype == torch.bfloat16 and torch.equal(back["x"], bf["x"])


def test_bucketing_amortizes_small_leaves():
    bufs, _ = gc.flatten_buckets({f"p{i}": torch.ones(4) for i in range(16)})
    assert len(bufs) == 1 and bufs[0].shape == (64,)


@pytest.mark.parametrize("n,hosts", [(8, 2), (8, 4), (4, 2), (4, 4)])
def test_hier_groups_match_jax(n, hosts):
    assert gc.hier_groups(n, hosts) == jgc.hier_groups(n, hosts)


def test_hier_groups_validation():
    with pytest.raises(ValueError, match=">= 2 hosts"):
        gc.hier_groups(8, 1)
    with pytest.raises(ValueError, match="not divisible"):
        gc.hier_groups(8, 3)


@pytest.mark.parametrize("kw", [dict(quantize=True, block_size=256), dict(),
                                dict(quantize=True, qdtype="bf16"), dict(quantize=True, block_size=64)])
def test_wire_bytes_match_jax(kw):
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("qdtype"):
        jkw["qdtype"], tkw["qdtype"] = jnp.bfloat16, torch.bfloat16
    tree = {"w": np.zeros((1000,), np.float32), "s": np.zeros((), np.int32),
            "m": np.zeros((33, 7), np.float32)}
    want = jgc.wire_bytes(jax.tree.map(jnp.asarray, tree), jgc.GradCommsConfig(**jkw))
    got = gc.wire_bytes({k: torch.from_numpy(v) for k, v in tree.items()},
                        gc.GradCommsConfig(**tkw))
    assert got == want
    if kw.get("block_size") == 256:
        assert want[0] == 4000 + 4 + 4 * 231 and want[0] / want[1] > 3


# -- one process: the strategy ------------------------------------------------------


@pytest.fixture
def cpu_process():
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


def test_step_is_memoized_per_fn_and_config(cpu_process):
    s = Strategy()
    fn = common.make_train_step()
    assert s.step(fn) is s.step(fn)
    assert s.step(fn) is not s.step(fn, donate_state=False)
    cfg = gc.GradCommsConfig()
    fn2 = common.make_train_step(grad_comms=cfg)
    assert s.step(fn2, grad_comms=cfg) is s.step(fn2, grad_comms=cfg)
    assert s.step(fn) is not s.step(fn2, grad_comms=cfg)


def test_collective_strategy_update_sharding(cpu_process):
    st = CollectiveAllReduceStrategy(update_sharding="cross_replica")
    assert st.grad_comms.update_sharding == "cross_replica" and st.grad_comms.mode == "zero1"
    quant = CollectiveAllReduceStrategy(update_sharding="cross_replica",
                                        grad_comms=gc.GradCommsConfig(quantize=True))
    assert quant.grad_comms.mode == "quantized+zero1"
    assert CollectiveAllReduceStrategy().grad_comms is None


def test_step_rejects_mismatched_grad_comms_marker(cpu_process):
    s = Strategy()
    cfg = gc.GradCommsConfig()
    with pytest.raises(ValueError, match="no implicit gradient all-reduce"):
        s.step(common.make_train_step(), grad_comms=cfg)
    with pytest.raises(ValueError, match="no implicit gradient all-reduce"):
        s.step(lambda st, b: (st, b), grad_comms=cfg)
    with pytest.raises(ValueError, match="same config"):
        s.step(common.make_train_step(grad_comms=gc.GradCommsConfig(quantize=True)),
               grad_comms=cfg)
    with pytest.raises(ValueError, match="explicit"):
        s.step(common.make_train_step(grad_comms=cfg))


def test_sharded_strategy_rejects_grad_comms():
    st = ShardedStrategy(device="cpu")
    with pytest.raises(ValueError, match="already owns its collectives"):
        st.step(common.make_train_step(), grad_comms=gc.GradCommsConfig())


class _Dense(torch.nn.Module):
    """flax ``Dense`` with the bias registered first: the parameters come
    in the JAX tree's (sorted) order, so the bucket layouts coincide."""

    def __init__(self, i, o):
        super().__init__()
        self.bias = torch.nn.Parameter(torch.zeros(o))
        self.kernel = torch.nn.Parameter(torch.zeros(i, o))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = _Dense(16, 31)  # odd width: exercises shard padding
        self.Dense_1 = _Dense(31, 10)

    def forward(self, x, train=False, generator=None):
        return self.Dense_1(torch.relu(self.Dense_0(x.reshape(x.shape[0], -1))))


class _JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = x.reshape((x.shape[0], -1))
        x = fnn.relu(fnn.Dense(31)(x))
        return fnn.Dense(10)(x)


def _batch(n=16, seed=0):
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(n, 4, 4, 1).astype(np.float32), "label": rs.randint(0, 10, (n,))}


@pytest.fixture(scope="module")
def init_params():
    state = jax_common.create_train_state(_JaxMLP(), jax.random.PRNGKey(0), (8, 4, 4, 1))
    return flatten(jax.device_get(state.params))


def test_one_rank_modes_train_like_the_plain_step(cpu_process, init_params):
    """At one rank there is no wire: every mode's losses and weights equal
    the plain step's bit for bit (hier takes the one-rank path and builds
    no process group)."""
    from hops_tpu_torch.models.convert import params_from_flax

    def run(cfg):
        m = _MLP()
        m.load_state_dict(params_from_flax(init_params))
        state = common.create_train_state(m, optimizer=torch.optim.Adam(m.parameters(), 1e-3))
        s = Strategy()
        if cfg is not None and cfg.update_sharding == "zero3":
            state = gc.zero3_init(state, s.mesh)
        step = s.step(common.make_train_step(grad_comms=cfg), grad_comms=cfg)
        losses = [step(state, _batch())[1]["loss"].item() for _ in range(3)]
        if cfg is not None and cfg.update_sharding == "zero3":
            state = gc.zero3_unshard(state)
        return losses, [p.detach().clone() for p in m.parameters()]

    want = run(None)
    for mode in ("allreduce", "quantized+overlap", "zero1", "zero2", "zero3", "hier"):
        got = run(gc.GradCommsConfig.parse(mode))
        assert got[0] == want[0], mode
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), mode


def test_state_specs_place_the_shards(cpu_process, init_params):
    """The port's counterpart of the shard_map specs: a state without a
    ZeRO carrier is all replicated; ZeRO-3's parameters are Shard(0) over
    the data axis, its buffers replicated."""
    from torch.distributed.tensor import Replicate, Shard

    from hops_tpu_torch.models.convert import params_from_flax

    m = _MLP()
    m.load_state_dict(params_from_flax(init_params))
    state = common.create_train_state(m)
    specs = gc.zero12_state_specs(state)
    assert specs["shards"] == [] and set(specs["params"].values()) == {Replicate()}
    assert not gc.has_sharded_moments(state)
    z3 = gc.zero3_init(state, Strategy().mesh)
    specs = gc.zero3_state_specs(z3)
    assert list(specs["params"]) == [n for n, _ in m.named_parameters()]
    assert set(specs["params"].values()) == {Shard(0)} and specs["buffers"] == {}
    with pytest.raises(RuntimeError, match="process group"):
        gc.mesh_axis(mesh_lib.make_mesh({"data": 2}, devices=[0, 1]))


# -- four processes ---------------------------------------------------------------

WORKER = r'''
import dataclasses, pickle, sys
import numpy as np
import torch
from torch import nn

torch.set_num_threads(1)
from hops_tpu_torch.models import common
from hops_tpu_torch.models.convert import load_npz, params_from_flax
from hops_tpu_torch.parallel import Strategy, grad_comms as gc, mesh as mesh_lib, multihost
from hops_tpu_torch.telemetry.metrics import REGISTRY

d, out = sys.argv[1], sys.argv[2]
modes = sys.argv[3].split(",")
HOOK_MODES = sys.argv[4].split(",")
rank, n = multihost.process_index(), multihost.process_count()
init = params_from_flax(load_npz(f"{d}/params.npz"))
arr = dict(np.load(f"{d}/data.npz"))
res = {}


class Dense(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(o))
        self.kernel = nn.Parameter(torch.zeros(i, o))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = Dense(16, 31), Dense(31, 10)

    def forward(self, x, train=False, generator=None):
        return self.Dense_1(torch.relu(self.Dense_0(x.reshape(x.shape[0], -1))))


OPTS = {"sgd": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
        "adam": lambda p: torch.optim.Adam(p, lr=1e-3),
        "sgd05": lambda p: torch.optim.SGD(p, lr=0.05)}
strategy = Strategy(mesh_lib.make_mesh({"data": n}), device="cpu")
mesh = strategy.mesh
batch = strategy.distribute_batch({"image": arr["image"], "label": arr["label"]})


def fresh(opt):
    m = MLP()
    m.load_state_dict(init)
    return strategy.replicate(common.create_train_state(m, optimizer=OPTS[opt](m.parameters())))


def dense(st, cfg):
    if isinstance(st.shards, gc.Zero3Shards):
        st = gc.zero3_unshard(st)
    elif gc.has_sharded_moments(st):
        st = gc.zero12_unshard(st, cfg)
    params = {k.replace(".", "/"): p.detach().numpy().copy() for k, p in st.model.named_parameters()}
    moments = {}
    for k, p in st.model.named_parameters():
        for key, v in st.optimizer.state.get(p, {}).items():
            moments[f"{k.replace('.', '/')}|{key}"] = v.detach().numpy().copy()
    return params, moments


def run(name, cfg, opt, steps=3, st=None, convert=None):
    fn = common.make_train_step(grad_comms=cfg)
    step = strategy.step(fn, donate_state=False, grad_comms=cfg)
    st = st if st is not None else fresh(opt)
    if convert is not None:
        st = convert(st)
    losses = []
    for _ in range(steps):
        st, m = step(st, batch)
        losses.append(m["loss"].item())
    if name:
        params, moments = dense(st, cfg)
        res[name] = {"losses": losses, "params": params, "moments": moments}
    return st


def z3(st):
    return gc.zero3_init(st, mesh)


# Every mode of parse, SGD with momentum (against JAX), and the DDP path.
for mode in modes:
    cfg = gc.GradCommsConfig.parse(mode)
    run(f"sgd/{mode}", cfg, "sgd", convert=z3 if cfg.update_sharding == "zero3" else None)
run("sgd/none", None, "sgd")
run("adam/none", None, "adam")
# Adam: the ZeRO stages against the replicated update, and the bit-identity pairs.
for mode in ("allreduce", "zero1", "zero2", "zero3", "overlap", "hier", "quantized",
             "quantized+hier"):
    cfg = gc.GradCommsConfig.parse(mode)
    run(f"adam/{mode}", cfg, "adam", convert=z3 if mode == "zero3" else None)
# The quantized trajectories against fp32 (block 64, plain SGD at 0.05, 4 steps).
for name, cfg in (("q/fp32", gc.GradCommsConfig()),
                  ("q/int8", gc.GradCommsConfig(quantize=True, block_size=64)),
                  ("q/overlap-fp32", gc.GradCommsConfig(overlap=True)),
                  ("q/overlap-int8", gc.GradCommsConfig(quantize=True, overlap=True, block_size=64))):
    run(name, cfg, "sgd05", steps=4)
# ZeRO-1/2 persistent moments.
for mode in ("cross_replica", "zero2"):
    for opt in ("sgd", "adam"):
        cfg = gc.GradCommsConfig(update_sharding=mode)
        st = gc.zero12_init(fresh(opt), mesh, cfg)
        res[f"persist/{mode}/{opt}/sharded"] = bool(gc.has_sharded_moments(st))
        st = run(None, cfg, opt, st=st)
        res[f"persist/{mode}/{opt}/at_rest"] = [
            [int(v.numel()) for v in st.shards.optimizer.state[sp].values() if v.dim()]
            for sp in st.shards.params]
        res[f"persist/{mode}/{opt}/shard_sizes"] = [int(sp.numel()) for sp in st.shards.params]
        params, moments = dense(st, cfg)
        res[f"persist/{mode}/{opt}"] = {"params": params, "moments": moments}
# Mid-training conversions.
z1 = gc.GradCommsConfig(update_sharding="cross_replica")
st = run(None, z1, "adam", steps=2)
run("mid/zero12", z1, "adam", steps=1, st=gc.zero12_init(st, mesh, z1))
st = run(None, gc.GradCommsConfig(), "adam", steps=2)
run("mid/zero3", gc.GradCommsConfig(update_sharding="zero3"), "adam", steps=1, st=z3(st))
# zero12_init's validation and its round trip.
try:
    gc.zero12_init(fresh("adam"), mesh, gc.GradCommsConfig(update_sharding="zero3"))
    res["zero12/validation"] = None
except ValueError as e:
    res["zero12/validation"] = str(e)
st = run(None, gc.GradCommsConfig(), "adam", steps=1)
before = dense(st, None)[1]
back = gc.zero12_unshard(gc.zero12_init(st, mesh, z1), z1)
res["zero12/roundtrip"] = (before, dense(back, None)[1])
one = mesh_lib.make_mesh({"data": 1}, devices=[rank])
st = fresh("adam")
res["zero12/one_rank_is_state"] = gc.zero12_init(st, one, z1) is st
# ZeRO-3 at rest.
st = z3(fresh("adam"))
res["zero3/at_rest"] = {
    "shards": [int(s.numel()) for s in st.shards.params],
    "padded": [int(m[3]) for m in st.shards.meta],
    "module": [int(p.numel()) for p in st.model.parameters()],
}
res["zero3/roundtrip"] = dense(st, None)[0]
# ZeRO-1 keeps fp32 parameters under bf16 gradients.
w = nn.Linear(16, 1, bias=False)
with torch.no_grad():
    w.weight.copy_(torch.linspace(0.0, 1.0, 16)[None])
st = common.create_train_state(w, optimizer=torch.optim.SGD(w.parameters(), lr=0.1))
g = torch.linspace(-1.0, 1.0, 16)[None].to(torch.bfloat16)
with gc.bind_axis("data", gc.mesh_axis(mesh)):
    st = gc.sharded_apply_gradients(st, [g], "data")
res["zero1/bf16"] = (str(w.weight.dtype), w.weight.detach().numpy().copy())
# Collectives on tensors.
rs = np.random.RandomState(0)
res["psum/quantized"] = gc.psum_quantized(torch.from_numpy(rs.randn(n, 1, 1024).astype(np.float32)[rank]),
                                          block_size=128).numpy()
rs = np.random.RandomState(1)
small = rs.randn(n, 1, 64).astype(np.float32) * 1e-3
large = rs.randn(n, 1, 64).astype(np.float32) * 1e3
res["psum/blocks"] = gc.psum_quantized(
    torch.from_numpy(np.concatenate([small, large], -1)[rank]), block_size=64).numpy()
res["psum/mean"] = gc.psum_quantized(torch.ones(4), mean=True).numpy()
x = torch.from_numpy(np.random.RandomState(1).randn(n, 3, 85).astype(np.float32)[rank])
res["psum/flat"] = gc.psum(x).numpy()
for hosts in (2, 4):
    res[f"psum/hier{hosts}"] = gc.psum_hierarchical(x, hosts=hosts).numpy()
v = torch.from_numpy(np.random.RandomState(2).randn(n, 256).astype(np.float32)[rank])
res["rs/flat"] = gc.psum_scatter(v).numpy()
res["rs/hier"] = gc.hier_reduce_scatter(v, None, 2).numpy()
q = torch.from_numpy(np.random.RandomState(3).randn(n, 1, 1024).astype(np.float32)[rank])
res["psum/qflat"] = gc.psum_quantized(q, block_size=128).numpy()
for hosts in (2, 4):
    res[f"psum/qhier{hosts}"] = gc.psum_quantized(q, block_size=128, hierarchy=hosts).numpy()
t = torch.from_numpy(np.random.RandomState(4).randn(n, 1, 33).astype(np.float32)[rank])
tree = gc.all_reduce_grads({"a": t[..., :20], "b": t[..., 20:]}, None, gc.GradCommsConfig())
res["ar/tree"] = torch.cat([tree["a"], tree["b"]], -1).numpy()
# What the backward hooks hold: the receive buffer of each parameter,
# read after every hook and once more after backward.
for mode in HOOK_MODES:
    cfg = gc.GradCommsConfig.parse(mode)
    m = MLP()
    m.load_state_dict(init)
    params = list(m.parameters())
    with gc.bind_axis("data", gc.mesh_axis(mesh)):
        comms = gc.tag_backward_comms(params, "data", cfg)
        during = []
        spies = [p.register_post_accumulate_grad_hook(
            lambda _p: during.append({i: int(e[1].numel()) for i, e in comms.pending.items()}))
            for p in params]
        logits = m(torch.as_tensor(batch["image"]))
        torch.nn.functional.cross_entropy(logits, torch.as_tensor(batch["label"]).long()).backward()
        after = {i: int(e[1].numel()) for i, e in comms.pending.items()}
        comms.wait()
        for h in spies:
            h.remove()
    res[f"held/{mode}"] = {"during": during, "after": after,
                           "numel": [int(p.numel()) for p in params]}
# Telemetry through a quantized step.
cfg = gc.GradCommsConfig(quantize=True, block_size=256)
counter = REGISTRY.counter("hops_tpu_grad_comms_bytes_pre_total", labels=("mode",))
before = counter.value(mode="quantized")
run(None, cfg, "sgd", steps=1)
hist = REGISTRY.histogram("grad_comms_all_reduce_seconds", labels=("mode",))
res["telemetry"] = {
    "pre": counter.value(mode="quantized") - before,
    "ratio": REGISTRY.gauge("hops_tpu_grad_comms_compression_ratio", labels=("mode",)).value(mode="quantized"),
    "observed": any(v > 0 for _, _, v in hist.samples()),
}
with open(f"{out}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp: Path, n: int, worker: str, *args: str) -> list:
    """``python -m hops_tpu_torch.launch --platform cpu`` on ``n`` gloo
    ranks running ``worker`` with ``args``; returns each rank's pickled
    results (``rank<i>.pkl`` in ``tmp``)."""
    path = tmp / "worker.py"
    path.write_text(worker)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hops_tpu_torch.launch", "--platform", "cpu", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id", str(i), str(path),
         *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT)) for i in range(n)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    return [pickle.loads((tmp / f"rank{i}.pkl").read_bytes()) for i in range(n)]


def shared_once(tmp_path_factory, name: str, make):
    """``make()``'s result, computed once per test session: under
    pytest-xdist the workers share it through a pickle beside their
    temporary directories (the first to take the lock computes it), so a
    family of multi-process cases spread over the workers launches its
    ranks once."""
    import fcntl

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the session's directory, shared by the workers
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(make()))
    return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, init_params):
    def launch():
        d = tmp_path_factory.mktemp("grad_comms")
        np.savez(d / "params.npz", **init_params)
        np.savez(d / "data.npz", **_batch())
        return run_ranks(d, N, WORKER, str(d), str(d), ",".join(MODES), ",".join(HOOK_MODES))

    return shared_once(tmp_path_factory, "grad_comms_ranks", launch)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, init_params):
    """The JAX strategy on the fake mesh's first 4 devices: every mode
    (and the implicit path) for 3 SGD-momentum steps from the same
    weights on the same global batch."""
    return shared_once(tmp_path_factory, "grad_comms_jax", lambda: _jax_runs(init_params))


def _jax_runs(init_params):
    from flax.traverse_util import unflatten_dict

    strategy = JaxStrategy(jax_mesh.make_mesh({"data": N}, devices=jax.devices()[:N]))
    batch = strategy.distribute_batch(_batch())
    base = jax_common.create_train_state(_JaxMLP(), jax.random.PRNGKey(0), (8, 4, 4, 1),
                                         optimizer=optax.sgd(0.1, momentum=0.9))
    base = base.replace(params=unflatten_dict(
        {k: jnp.asarray(v) for k, v in init_params.items()}, sep="/"))
    out = {}
    for mode in ["none", *MODES]:
        cfg = jgc.GradCommsConfig.parse(mode)
        step = strategy.step(jax_common.make_train_step(grad_comms=cfg), donate_state=False,
                             grad_comms=cfg)
        state = strategy.replicate(base)
        if cfg is not None and cfg.update_sharding == "zero3":
            state = jgc.zero3_init(state, strategy.mesh, "data")
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        params = (jgc.zero3_unshard(state)[0] if cfg is not None and cfg.update_sharding == "zero3"
                  else state.params)
        out[mode] = losses, flatten(jax.device_get(params))
    return out


HOOK_MODES = ["overlap", "zero2", "quantized+zero2", "hier+overlap"]


@pytest.mark.parametrize("mode", HOOK_MODES)
def test_backward_hooks_hold_tiles_not_gradients(ranks, mode):
    """ZeRO-2's memory: every exchange launched in backward is folded to
    this rank's 1/N tile once the next one is launched, so at any hook
    (and after backward) at most the newest receive buffer holds a whole
    padded gradient; the hierarchical schedule reduces in the hook and
    holds tiles only."""
    for r in ranks:
        held = r[f"held/{mode}"]
        tile = [-(-k // N) for k in held["numel"]]
        snaps = held["during"] + [held["after"]]
        assert len(held["during"]) == len(tile) and len(held["after"]) == len(tile)
        for snap in snaps:
            whole = [i for i, k in snap.items() if k != tile[i]]
            assert all(snap[i] == N * tile[i] for i in whole), snap
            assert len(whole) <= (0 if "hier" in mode else 1), snap


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(r[key])):
            np.testing.assert_array_equal(a, b, err_msg=key)
    return first


@pytest.mark.parametrize("mode", ["none", *MODES])
def test_mode_matches_jax(ranks, jax_runs, mode):
    """4 gloo ranks through Strategy.step(make_train_step(grad_comms=...))
    train the MLP to the JAX strategy's losses and weights (the DDP path
    for ``none``); every rank holds the same weights."""
    got = _same_on_every_rank(ranks, f"sgd/{mode}")
    want_losses, want = jax_runs[mode]
    for name, arr in want.items():
        np.testing.assert_allclose(got["params"][name], arr, err_msg=name, **TOL)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("mode", ["zero1", "zero2", "zero3"])
def test_zero_update_matches_replicated(ranks, mode, opt):
    """ZeRO-1/2/3 equal the replicated update, weights AND moments."""
    ref, got = ranks[0][f"{opt}/allreduce"], ranks[0][f"{opt}/{mode}"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for part in ("params", "moments"):
        assert set(got[part]) == set(ref[part])
        for k in ref[part]:
            np.testing.assert_allclose(got[part][k], ref[part][k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("mode", ["cross_replica", "zero2"])
def test_zero12_persistent_moments_match_replicated(ranks, mode, opt):
    """Moments 1/N at rest between steps (each rank's moment shards hold
    a quarter of its padded flat buffers); unsharded they equal the
    replicated-contract run's."""
    stage = "zero1" if mode == "cross_replica" else "zero2"
    for r in ranks:
        assert r[f"persist/{mode}/{opt}/sharded"]
        sizes = r[f"persist/{mode}/{opt}/shard_sizes"]
        for shard, rest in zip(sizes, r[f"persist/{mode}/{opt}/at_rest"]):
            assert rest and all(x == shard for x in rest)
    got, ref = ranks[0][f"persist/{mode}/{opt}"], ranks[0][f"{opt}/{stage}"]
    for part in ("params", "moments"):
        for k in ref[part]:
            np.testing.assert_allclose(got[part][k], ref[part][k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("which,ref", [("zero12", "adam/zero1"), ("zero3", "adam/allreduce")])
def test_mid_training_conversion_keeps_trajectory(ranks, which, ref):
    """2 replicated steps, convert, 1 sharded step == 3 steps."""
    got, want = ranks[0][f"mid/{which}"], ranks[0][ref]
    for part in ("params", "moments"):
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k], atol=1e-6, err_msg=k)


def test_zero12_init_validation_and_unshard_roundtrip(ranks):
    for r in ranks:
        assert "cross_replica" in r["zero12/validation"]
        before, after = r["zero12/roundtrip"]
        assert set(before) == set(after) and before
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        assert r["zero12/one_rank_is_state"]


def test_zero3_state_is_sharded_at_rest(ranks, init_params):
    for r in ranks:
        rest = r["zero3/at_rest"]
        assert all(p % N == 0 and s == p // N for s, p in zip(rest["shards"], rest["padded"]))
        assert rest["module"] == [0] * len(rest["module"])
        for k, v in r["zero3/roundtrip"].items():
            np.testing.assert_array_equal(v, init_params[k], err_msg=k)


def test_zero1_preserves_param_dtype_with_lower_precision_grads(ranks):
    w0 = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    g = np.asarray(jnp.linspace(-1.0, 1.0, 16).astype(jnp.bfloat16).astype(jnp.float32))
    for r in ranks:
        dtype, w = r["zero1/bf16"]
        assert dtype == "torch.float32"
        np.testing.assert_allclose(w[0], w0 - 0.1 * g, atol=5e-3)


def _assert_bitwise(a, b):
    assert a["losses"] == b["losses"]
    for part in ("params", "moments"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)


@pytest.mark.parametrize("pair", [("overlap", "allreduce"), ("hier", "allreduce"),
                                  ("quantized+hier", "quantized")],
                         ids=["overlap-vs-sequential", "hier-vs-flat", "qhier-vs-qflat"])
def test_bit_identical_schedules(ranks, pair):
    """Per-leaf hooks vs per-bucket reduction, hierarchical vs flat: the
    same addends folded in the same rank order, so 3 Adam steps agree
    bit for bit (losses, weights, moments) on every rank."""
    for r in ranks:
        _assert_bitwise(r[f"adam/{pair[0]}"], r[f"adam/{pair[1]}"])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_explicit_comms_matches_the_ddp_path(ranks, opt):
    got, want = ranks[0][f"{opt}/allreduce"], ranks[0][f"{opt}/none"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("which", ["", "overlap-"])
def test_quantized_trains_close_to_fp32(ranks, which):
    f, q = ranks[0][f"q/{which}fp32"], ranks[0][f"q/{which}int8"]
    assert np.isfinite(q["losses"]).all()
    flat_f = np.concatenate([v.ravel() for v in f["params"].values()])
    flat_q = np.concatenate([v.ravel() for v in q["params"].values()])
    assert not np.array_equal(flat_f, flat_q)
    assert np.abs(flat_f - flat_q).max() < 5e-3


def test_psum_quantized_matches_fp32_psum_bounded(ranks):
    per_dev = np.random.RandomState(0).randn(N, 1, 1024).astype(np.float32)
    exact = per_dev.sum(0)
    got = _same_on_every_rank(ranks, "psum/quantized")
    bound = (N * 0.5 + 0.5) * (N * np.abs(per_dev).max() / 127.0)
    err = np.abs(got - exact)
    assert 0 < err.max() <= bound
    assert err.mean() / np.abs(exact).mean() < 0.02
    want = jax_collective(lambda v: jgc.psum_quantized(v, "data", block_size=128), per_dev)[0]
    assert np.abs(got - want).max() <= 2 * N * np.abs(per_dev).max() / 127.0


def jax_collective(fn, per_device):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jax_mesh.make_mesh({"data": N}, devices=jax.devices()[:N])
    g = shard_map(fn, mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_rep=False)
    return np.asarray(jax.jit(g)(jnp.asarray(per_device)))


def test_psum_quantized_per_block_scales_preserve_small_blocks(ranks):
    rs = np.random.RandomState(1)
    small = rs.randn(N, 1, 64).astype(np.float32) * 1e-3
    large = rs.randn(N, 1, 64).astype(np.float32) * 1e3
    exact = np.concatenate([small, large], -1).sum(0)[0]
    got = _same_on_every_rank(ranks, "psum/blocks")[0]
    err_small = np.abs(got[:64] - exact[:64])
    assert err_small.max() <= (N * 0.5 + 0.5) * (N * np.abs(small).max() / 127.0)
    assert err_small.max() < np.abs(large).max() / 127.0


def test_psum_quantized_mean(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["psum/mean"], 1.0, atol=1e-6)


@pytest.mark.parametrize("hosts", [2, 4])
def test_psum_hierarchical_bit_identical_to_flat(ranks, hosts):
    """Padding path included (255 elements do not divide by 4)."""
    for r in ranks:
        np.testing.assert_array_equal(r[f"psum/hier{hosts}"], r["psum/flat"])
    per_dev = np.random.RandomState(1).randn(N, 3, 85).astype(np.float32)
    np.testing.assert_allclose(ranks[0]["psum/flat"], per_dev.sum(0), rtol=1e-6, atol=1e-6)


def test_hier_reduce_scatter_matches_psum_scatter(ranks):
    per_dev = np.random.RandomState(2).randn(N, 256).astype(np.float32)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["rs/hier"], r["rs/flat"])
        np.testing.assert_allclose(r["rs/flat"], per_dev.sum(0)[i * 64:(i + 1) * 64], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("hosts", [2, 4])
def test_quantized_hier_bit_identical_to_quantized_flat(ranks, hosts):
    for r in ranks:
        np.testing.assert_array_equal(r[f"psum/qhier{hosts}"], r["psum/qflat"])


def test_all_reduce_grads_unquantized_is_exact_pmean(ranks):
    per_dev = np.random.RandomState(4).randn(N, 1, 33).astype(np.float32)
    got = _same_on_every_rank(ranks, "ar/tree")
    np.testing.assert_allclose(got, per_dev.mean(0), rtol=1e-6)


def test_wire_bytes_and_telemetry_compression_ratio(ranks, init_params):
    cfg = gc.GradCommsConfig(quantize=True, block_size=256)
    model = _MLP()
    pre, post = gc.wire_bytes(model, cfg)
    assert pre == 4 * sum(v.size for v in init_params.values())
    for r in ranks:
        t = r["telemetry"]
        assert t["pre"] == pre and t["ratio"] == pytest.approx(pre / post) and t["ratio"] > 1
        assert t["observed"]
