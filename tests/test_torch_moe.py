"""The port's Mixture-of-Experts layer and MoE LM against the JAX
package, fp32 on the CPU.

In one process: ``MoEMLP`` and ``MoEBlock`` outputs and the
load-balancing loss (``atol 1e-5``), ties (``probs >= kth`` selects every
tied expert), capacity drops, the MoE LM's logits (``atol 1e-4``), its
loss and gradients over three SGD-momentum steps (``rtol 1e-4, atol
1e-5``; Adam only within the port, since ``sqrt(v) + eps`` turns
last-bit gradient differences into weight differences up to lr), the
weight tree both ways, and the MoE engine's greedy streams (dense and
int8 caches) identical to the JAX engine's. Across two gloo processes
(``python -m hops_tpu_torch.launch --platform cpu``): ``MoEMLP`` with
its experts split over an expert axis equals the dense dispatch.
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
from flax.traverse_util import unflatten_dict

from hops_tpu.modelrepo.lm_engine import LMEngine as JaxEngine
from hops_tpu.models import common as jax_common
from hops_tpu.models.moe import MoEBlock as JaxMoEBlock
from hops_tpu.models.moe import MoEMLP as JaxMoEMLP
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.models.transformer import make_lm_train_step as jax_lm_step
from hops_tpu_torch.models.common import create_train_state
from hops_tpu_torch.models.convert import flatten, params_from_flax, params_to_flax, random_params
from hops_tpu_torch.models.moe import MoEBlock, MoEMLP, expert_specs, sum_sown_losses
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64,
           moe_every=2, num_experts=4, moe_top_k=2)
TOL = dict(rtol=1e-4, atol=1e-5)
MLP_TOL = dict(rtol=1e-5, atol=1e-5)
LR = 0.05

torch.set_num_threads(1)


def _x(b=2, s=16, d=32, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _jax_mlp(x, **kw):
    m = JaxMoEMLP(dtype=jnp.float32, **kw)
    variables = jax.device_get(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    out, state = m.apply(variables, jnp.asarray(x), mutable=["losses"])
    return variables["params"], np.asarray(out), float(state["losses"]["moe_aux"][0])


def _port_mlp(params, x, **kw):
    m = MoEMLP(x.shape[-1], dtype=torch.float32, device="cpu", **kw)
    m.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    return out.numpy(), float(m.aux_loss)


@pytest.mark.parametrize("kw", [
    dict(num_experts=4, top_k=2),
    dict(num_experts=4, top_k=1),
    dict(num_experts=8, top_k=2, capacity_factor=2.0),
    dict(num_experts=2, top_k=1, capacity_factor=0.25),
    dict(num_experts=4, top_k=2, capacity_factor=1.1),  # capacity int(17.6): truncated
], ids=["e4k2", "e4k1", "e8k2-cap2", "e2k1-tight", "e4k2-cap1.1"])
def test_moe_mlp_matches_jax(kw):
    x = _x()
    params, want, want_aux = _jax_mlp(x, **kw)
    got, aux = _port_mlp(params, x, **kw)
    np.testing.assert_allclose(got, want, **MLP_TOL)
    np.testing.assert_allclose(aux, want_aux, **MLP_TOL)


def test_ties_select_every_tied_expert():
    """A zero router makes every probability equal: ``probs >= kth``
    selects all E experts (not top_k indices), so the aux loss is E."""
    x = _x(seed=1)
    params, want, want_aux = _jax_mlp(x, num_experts=4, top_k=2, capacity_factor=4.0)
    params = {**params, "router": {"kernel": np.zeros_like(params["router"]["kernel"])}}
    m = JaxMoEMLP(num_experts=4, top_k=2, capacity_factor=4.0, dtype=jnp.float32)
    want, state = m.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    got, aux = _port_mlp(params, x, num_experts=4, top_k=2, capacity_factor=4.0)
    np.testing.assert_allclose(got, np.asarray(want), **MLP_TOL)
    assert aux == pytest.approx(4.0) and float(state["losses"]["moe_aux"][0]) == pytest.approx(4.0)


def test_capacity_drops_overflow_like_jax():
    """Tokens past an expert's capacity drop to zero output (the
    residual carries them), the same tokens as in JAX."""
    x = _x(b=1, s=32, d=16, seed=2)
    params, want, _ = _jax_mlp(x, num_experts=2, top_k=1, capacity_factor=0.25)
    got, _ = _port_mlp(params, x, num_experts=2, top_k=1, capacity_factor=0.25)
    dropped = np.linalg.norm(got.reshape(-1, 16), axis=-1) == 0
    assert dropped.any()
    np.testing.assert_array_equal(dropped, np.linalg.norm(want.reshape(-1, 16), axis=-1) == 0)


def test_moe_block_matches_jax():
    x = _x(b=2, s=16, d=32, seed=3)
    jb = JaxMoEBlock(num_heads=4, num_experts=4, dtype=jnp.float32, attention_impl="reference")
    variables = {"params": jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])}
    want, state = jb.apply(variables, jnp.asarray(x), mutable=["losses"])
    block = MoEBlock(32, 4, num_experts=4, dtype=torch.float32, param_dtype=torch.float32,
                     device="cpu", attention_impl="reference")
    block.load_state_dict(params_from_flax(variables))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLP_TOL)
    np.testing.assert_allclose(float(block.moe.aux_loss),
                               float(state["losses"]["moe"]["moe_aux"][0]), **MLP_TOL)


@pytest.fixture(scope="module")
def lm_pair():
    jm = JaxLM(**CFG, dtype=jnp.float32, attention_impl="reference")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, {"params": jax.device_get(params)}


def _tokens(b=2, s=13, seed=0):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (b, s)).astype(np.int32)


def test_moe_lm_logits_and_tree_match_jax(lm_pair):
    jm, params = lm_pair
    tokens = _tokens()
    want, state = jm.apply(params, jnp.asarray(tokens), mutable=["losses"])
    tm = TransformerLM(**CFG, dtype="float32", device="cpu").load_flax(params)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    jax_aux = sum(float(v[0]) for v in jax.tree.leaves(
        state["losses"], is_leaf=lambda t: isinstance(t, tuple)))
    np.testing.assert_allclose(float(sum_sown_losses(tm)), jax_aux, **MLP_TOL)
    # The tree both ways: random_params draws JAX's names and shapes,
    # params_to_flax gives them back.
    want_shapes = {k: v.shape for k, v in flatten(params).items()}
    assert {k: v.shape for k, v in random_params(**CFG).items()} == want_shapes
    back = params_to_flax(tm)
    assert {k: v.shape for k, v in back.items()} == want_shapes
    jm.apply({"params": unflatten_dict(back, sep="/")}, jnp.asarray(tokens))


def test_moe_lm_trains_like_jax_under_sgd(lm_pair):
    """Three SGD-momentum steps: losses, then every weight."""
    jm, params = lm_pair
    batches = [_tokens(seed=10 + i) for i in range(3)]
    jstate = jax_common.create_train_state(
        jm, jax.random.PRNGKey(0), (1, 8), optax.sgd(LR, momentum=0.9), input_dtype=jnp.int32)
    jstate = jstate.replace(params=params["params"])
    jstep = jax.jit(jax_lm_step())
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)})
        want.append(float(m["loss"]))
    model = TransformerLM(**CFG, dtype="float32", device="cpu").load_flax(params)
    state = create_train_state(model, optimizer=torch.optim.SGD(model.parameters(), lr=LR,
                                                                momentum=0.9))
    step = make_lm_train_step()
    got = []
    for b in batches:
        state, m = step(state, {"tokens": b})
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, **TOL)
    jw = flatten(jax.device_get(jstate.params))
    for name, arr in params_to_flax(state.model).items():
        np.testing.assert_allclose(arr, jw[name], err_msg=name, **TOL)


def test_moe_lm_trains_under_adam_with_remat():
    """Within the port: Adam lowers the loss, and remat gives the same
    losses as no remat (the aux loss rides the recomputed blocks)."""
    params = random_params(**CFG, seed=4)
    tokens = _tokens(b=4, s=17, seed=5)
    runs = []
    for remat in (False, True):
        model = TransformerLM(**CFG, dtype="float32", remat=remat, device="cpu").load_flax(params)
        state = create_train_state(model, learning_rate=1e-2)
        step = make_lm_train_step()
        runs.append([float(step(state, {"tokens": tokens})[1]["loss"]) for _ in range(6)])
    assert runs[0][-1] < runs[0][0]
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6, atol=1e-6)


def test_moe_refusals_and_specs():
    with pytest.raises(NotImplementedError, match="dense TransformerLMs"):
        TransformerLM(**CFG, dtype="float32", device="cpu", tp_shards=2)
    with pytest.raises(NotImplementedError, match="paged_decode"):
        TransformerLM(**CFG, dtype="float32", device="cpu", ragged_decode=True,
                      paged_decode=True, kv_pool_blocks=8)
    from torch.distributed.tensor import Replicate, Shard

    tm = TransformerLM(**CFG, dtype="float32", device="cpu")
    specs = expert_specs(dict(tm.state_dict()))
    assert specs["block_1.moe.w_in"] == Shard(0) and specs["block_1.moe.w_out"] == Shard(0)
    assert specs["block_1.moe.router.kernel"] == Replicate()
    nested = expert_specs({"moe": {"w_in": 0, "router": {"kernel": 0}}})
    assert nested["moe"]["w_in"] == Shard(0) and nested["moe"]["router"]["kernel"] == Replicate()
    dense = TransformerLM(**{**CFG, "moe_every": 0}, dtype="float32", device="cpu")
    assert sum_sown_losses(dense) == 0.0


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
            for n in (5, 11, 3, 17, 8, 2)]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["dense", "int8"])
def test_moe_engine_streams_match_the_jax_engine(lm_pair, kv, tmp_path):
    """Six greedy requests on 4 slots (a wave of four admissions, then
    single ones): MoE capacity is per call, so the port's engine calls
    the model at the JAX engine's shapes and the streams are identical.
    Through LMEnginePredictor too."""
    jm, params = lm_pair
    prompts = _prompts()
    jengine = JaxEngine(jm.clone(ragged_decode=True, kv_cache_dtype=kv, attention_impl="flash"),
                        params["params"], slots=4, prefill_buckets=(8, 16, 32))
    tickets = [jengine.submit(p, max_new_tokens=9) for p in prompts]
    res = jengine.run()
    want = [res[t] for t in tickets]
    model = TransformerLM(**CFG, dtype="float32", ragged_decode=True, kv_cache_dtype=kv,
                          device="cpu").load_flax(params)
    engine = LMEngine(model, slots=4, prefill_buckets=(8, 16, 32), device="cpu")
    tickets = [engine.submit(p, max_new_tokens=9) for p in prompts]
    res = engine.run()
    assert [res[t] for t in tickets] == want
    assert engine.stats()["admission_waves"] >= 2
    art = tmp_path / "moe"
    save_lm_artifact(art, {**CFG, "dtype": "float32", "kv_cache_dtype": kv},
                     flatten(params))
    pred = LMEnginePredictor(art, {"slots": 4, "prefill_buckets": [8, 16, 32]}, device="cpu")
    try:
        out = pred.predict([{"prompt": p.tolist(), "max_new_tokens": 9} for p in prompts])
    finally:
        pred.stop()
    assert out == want


# -- the expert split, across two processes --------------------------------------

WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from hops_tpu_torch.models.convert import load_npz, params_from_flax
from hops_tpu_torch.models.moe import MoEMLP
from hops_tpu_torch.parallel import multihost

data, out = sys.argv[1], sys.argv[2]
rank, n = multihost.process_index(), multihost.process_count()
params = params_from_flax(load_npz(data))
x = torch.from_numpy(np.load(data.replace("params.npz", "x.npy")))
e_local = 4 // n
local = dict(params)
for k in ("w_in", "w_out"):
    local[k] = params[k][rank * e_local:(rank + 1) * e_local]
m = MoEMLP(16, num_experts=4, top_k=2, dtype=torch.float32, device="cpu",
           expert_axis=dist.group.WORLD, expert_shards=n)
m.load_state_dict(local)
with torch.no_grad():
    y = m(x)
json.dump({"out": y.numpy().tolist(), "aux": float(m.aux_loss)}, open(f"{out}/rank{rank}.json", "w"))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_expert_split_over_two_ranks_equals_dense_dispatch(tmp_path):
    x = _x(b=2, s=8, d=16, seed=9)
    params, want, want_aux = _jax_mlp(x, num_experts=4, top_k=2)
    np.savez(tmp_path / "params.npz", **flatten(params))
    np.save(tmp_path / "x.npy", x)
    (tmp_path / "worker.py").write_text(WORKER)
    dense, _ = _port_mlp(params, x, num_experts=4, top_k=2)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hops_tpu_torch.launch", "--platform", "cpu", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i),
         str(tmp_path / "worker.py"), str(tmp_path / "params.npz"), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT))
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        np.testing.assert_allclose(np.asarray(res["out"], np.float32), dense, **MLP_TOL)
        np.testing.assert_allclose(np.asarray(res["out"], np.float32), want, **MLP_TOL)
        np.testing.assert_allclose(res["aux"], want_aux, **MLP_TOL)
