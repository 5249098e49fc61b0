"""The port's tensor parallelism (``hops_tpu_torch.parallel.tp_inference``,
``TransformerLM(tp_axis=, tp_shards=)``, ``LMEngine(mesh=)``,
``ShardedStrategy(model > 1)``) against the JAX package, on the CPU.

Across gloo processes (``python -m hops_tpu_torch.launch --platform
cpu``, one launch per rank count, each case's results handed to its own
test): the cases of ``tests/test_parallel.py``'s ``TestTPInference``,
``TestTPSpeculative`` and ``TestHybridMesh``, the engine's ``mesh=``
workloads of ``tests/test_lm_engine.py`` and ``ShardedStrategy(model=2)``
on the FFN and the LM. JAX runs the same tiny fp32 models (vocab 64,
d_model 32, 4 heads, 2 layers) from the same weights. Greedy streams are
identical to JAX's; logits within ``atol 1e-4``; losses and weights
after three SGD steps within ``rtol 1e-4, atol 1e-5``; every rank's
result equal to rank 0's bit for bit (the per-block sums fold in rank
order). Sampled streams are the port's own (JAX's PRNG is not
reproduced): a tensor-parallel stream equals the one-rank port stream of
the same seed, keyed by global row ids.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hops_tpu.models import common as jax_common
from hops_tpu.models.generation import generate as jax_generate
from hops_tpu.models.generation import generate_speculative as jax_generate_speculative
from hops_tpu.models.mnist import FFN as JaxFFN
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.models.transformer import make_lm_train_step as jax_lm_step
from hops_tpu.modelrepo.lm_engine import LMEngine as JaxEngine
from hops_tpu.parallel import ShardedStrategy as JaxSharded
from hops_tpu_torch.models.convert import flatten
from hops_tpu_torch.models.transformer import TransformerLM
from tests.test_torch_grad_comms import run_ranks, shared_once

TINY = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=48)
ENGINE = dict(TINY, max_decode_len=64)
PAGED = dict(kv_page_size=8, prefill_chunk=8)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)

WORKER = r'''
import json, pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
from hops_tpu_torch.models.common import create_train_state, make_train_step
from hops_tpu_torch.models.convert import params_from_flax
from hops_tpu_torch.models.generation import generate, generate_speculative
from hops_tpu_torch.models.mnist import FFN
from hops_tpu_torch.models.transformer import TransformerLM, make_lm_train_step
from hops_tpu_torch.modelrepo.lm_engine import LMEngine
from hops_tpu_torch.parallel import ShardedStrategy, mesh as mesh_lib, multihost
from hops_tpu_torch.parallel.tp_inference import (
    tp_generate, tp_generate_speculative, tp_shard_model)

data, out = sys.argv[1], sys.argv[2]
spec = json.load(open(f"{data}/spec.json"))
rank = multihost.process_index()
res = {}


def lm(cfg, params, **kw):
    m = TransformerLM(**cfg, dtype="float32", device="cpu", **kw)
    return m.load_flax(f"{data}/{params}.npz")


def arr(name):
    return np.load(f"{data}/{name}.npy")


def engine_run(engine, case):
    for name, toks in case.get("prefixes", {}).items():
        engine.register_prefix(name, toks)
    ts = [engine.submit(arr(p), **kw) for p, kw in case["requests"]]
    r = engine.run()
    return [r[t] for t in ts]


for case in spec["cases"]:
    name, kind = case["name"], case["kind"]
    mesh = mesh_lib.make_mesh(case["mesh"])
    cfg = case.get("cfg")
    if kind == "generate":
        m = lm(cfg, name)
        prompt = torch.from_numpy(arr("prompt")).long()
        local = tp_shard_model(m, mesh, "model")
        with torch.no_grad():
            logits = local(prompt).numpy()
        res[name] = {"logits": logits,
                     "tokens": tp_generate(m, prompt, mesh, max_new_tokens=9,
                                           temperature=0.0).numpy()}
    elif kind == "sampled_dp":
        m = lm(cfg, name)
        prompt = torch.from_numpy(arr("prompt")).long()
        kw = dict(max_new_tokens=6, temperature=0.7, top_k=8, top_p=0.9, seed=5)
        res[name] = {"tp": tp_generate(m, prompt, mesh, batch_axis="data", **kw).numpy(),
                     "one": generate(m, prompt, device="cpu", **kw).numpy()}
        try:
            tp_generate(m, prompt, mesh, row_offset=1, max_new_tokens=2)
            res[name]["row_offset"] = None
        except ValueError as e:
            res[name]["row_offset"] = str(e)
    elif kind == "spec":
        m, d = lm(cfg, name), lm({**cfg, "num_layers": 1}, name + "_draft")
        prompt = torch.from_numpy(arr("prompt_spec")).long()
        greedy = tp_generate_speculative(m, d, prompt, mesh, batch_axis="data",
                                         max_new_tokens=9, k=3).numpy()
        kw = dict(max_new_tokens=6, k=3, temperature=0.8, top_k=16, seed=11)
        got = {"greedy": greedy,
               "sampled": tp_generate_speculative(m, d, prompt, mesh, batch_axis="data",
                                                  **kw).numpy(),
               "again": tp_generate_speculative(m, d, prompt, mesh, batch_axis="data",
                                                **kw).numpy(),
               "one": generate_speculative(m, d, prompt, device="cpu", **kw).numpy()}
        try:
            tp_generate_speculative(m, d, prompt, mesh, temperature=0.5)
            got["no_seed"] = None
        except ValueError as e:
            got["no_seed"] = str(e)
        res[name] = got
    elif kind == "engine":
        ecfg = dict(slots=2, **case["engine"])
        model = lm(cfg, name, ragged_decode=True, **case.get("model", {}))
        if "draft" in case:
            ecfg["draft_model"] = lm(cfg, name + "_draft", ragged_decode=True,
                                     **case.get("model", {}))
        got = {}
        for horizon in case.get("horizons", [ecfg.pop("decode_horizon", 1)]):
            tp = LMEngine(model, mesh=mesh, decode_horizon=horizon, device="cpu", **ecfg)
            one = LMEngine(model, decode_horizon=horizon, device="cpu", **ecfg)
            got[horizon] = {"tp": engine_run(tp, case), "one": engine_run(one, case)}
        got["kv_shape"] = list(tp._cache.k[0].shape)
        got["dense_kv_shape"] = list(one._cache.k[0].shape)
        if case.get("sampled_twice"):
            eng = LMEngine(model, mesh=mesh, device="cpu", **ecfg)
            kw = dict(max_new_tokens=6, temperature=0.9, top_p=0.9, seed=11)
            t1 = eng.submit(arr("e_p0"), **kw)
            t2 = eng.submit(arr("e_p0"), **kw)
            r = eng.run()
            got["twice"] = [r[t1], r[t2]]
        res[name] = got
    elif kind == "levers":
        model = lm(cfg, name, ragged_decode=True)
        got = {}
        for label, engine in (("tp", LMEngine(model, mesh=mesh, slots=2, device="cpu",
                                              kv_page_size=8, prefill_chunk=8)),
                              ("one", LMEngine(model, slots=2, device="cpu", kv_page_size=8,
                                               prefill_chunk=8))):
            got[label] = {"paged": engine_run(engine, case),
                          "hits": engine.stats()["prefix_hits"]}
        for label, mesh_ in (("tp", mesh), ("one", None)):
            engine = LMEngine(model, mesh=mesh_, slots=2, device="cpu")
            ts = [engine.submit(arr(p), **kw) for p, kw in case["offline"]]
            r = engine.run_offline()
            got[label]["offline"] = [r[t] for t in ts]
        res[name] = got
    elif kind == "sharded":
        st = ShardedStrategy(**case["shape"], min_shard_size=1024, device="cpu")
        if case["model_kind"] == "ffn":
            m = FFN(dtype="float32", device="cpu")
            m.load_state_dict(params_from_flax(f"{data}/{name}.npz"), strict=True)
            batch = {"image": arr("images"), "label": arr("labels")}
            fn = make_train_step()
        else:
            m = lm(cfg, name, attention_impl="reference")
            batch = {"tokens": arr("lm_tokens")}
            fn = make_lm_train_step()
        state = st.shard_state(create_train_state(m, optimizer=torch.optim.SGD(m.parameters(),
                                                                              lr=0.1)))
        step = st.step(fn)
        losses = []
        for _ in range(3):
            state, met = step(state, st.distribute_batch(batch))
            losses.append(float(met["loss"]))
        full = st.unshard_model(state.model)
        res[name] = {"losses": losses,
                     "params": {k.replace(".", "/"): v.numpy() for k, v in full.items()}}
with open(f"{out}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
'''


def _prompt(seed=3, shape=(2, 7)):
    return np.random.RandomState(seed).randint(1, 64, shape).astype(np.int64)


def _jax_lm(cfg, **knobs):
    return JaxLM(**cfg, **knobs, dtype=jnp.float32, attention_impl="reference")


def _init(model, seed=0):
    return model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]


def _engine_prompts():
    rs = np.random.RandomState(21)
    dense = [rs.randint(1, 64, (n,)) for n in (3, 7, 5, 2)]
    rs = np.random.RandomState(63)
    spec = [rs.randint(1, 64, (n,)) for n in (3, 7, 5)]

    def mixed(seed):
        rs = np.random.RandomState(seed)
        return [rs.randint(1, 64, (rs.randint(3, 30),)) for _ in range(4)]

    return {"e_p": dense, "s_p": spec, "pg_p": mixed(8), "q8_p": mixed(24)}


# name: (ranks, kind, mesh, extras)
CASES = {
    "tp2_gqa": (2, "generate", {"model": 2}, {"knobs": {"num_kv_heads": 2}}),
    "tp2_int8_window16": (2, "generate", {"model": 2},
                          {"knobs": {"kv_cache_dtype": "int8", "window": 16}}),
    "tp4": (4, "generate", {"model": 4}, {"knobs": {}}),
    "sampled_dp": (4, "sampled_dp", {"data": 2, "model": 2}, {"knobs": {}}),
    "speculative": (4, "spec", {"data": 2, "model": 2}, {"knobs": {}}),
    "engine_dense": (2, "engine", {"model": 2}, {}),
    "engine_spec": (2, "engine", {"model": 2}, {}),
    "engine_paged": (2, "engine", {"model": 2}, {}),
    "engine_paged_int8": (2, "engine", {"model": 2}, {}),
    "engine_levers": (2, "levers", {"model": 2}, {}),
    "sharded_ffn_tp2": (2, "sharded", None, {"shape": dict(data=1, fsdp=1, model=2)}),
    "sharded_lm_tp2": (2, "sharded", None, {"shape": dict(data=1, fsdp=1, model=2)}),
    "sharded_ffn_dp2_tp2": (4, "sharded", None, {"shape": dict(data=2, fsdp=1, model=2)}),
    "sharded_lm_dp2_tp2": (4, "sharded", None, {"shape": dict(data=2, fsdp=1, model=2)}),
}


def _engine_case(name):
    """The JAX engine tests' workloads (``tests/test_lm_engine.py`` :592,
    :1023, :1329, :1475): requests as (prompt name, submit kwargs)."""
    if name == "engine_dense":
        return dict(engine={"prefill_buckets": [8], "decode_horizon": 2},
                    prefixes={"sys": list(range(1, 7))},
                    requests=[["e_p0", {"max_new_tokens": 8}],
                              ["e_p1", {"max_new_tokens": 5, "temperature": 0.8, "top_p": 0.9,
                                        "seed": 4}],
                              ["e_p2", {"max_new_tokens": 6, "prefix_id": "sys"}],
                              ["e_p3", {"max_new_tokens": 4, "eos_id": 1}]])
    if name == "engine_spec":
        return dict(engine={"prefill_buckets": [8], "spec_k": 3}, draft=True, horizons=[1, 3],
                    sampled_twice=True,
                    requests=[["s_p0", {"max_new_tokens": 8}],
                              ["s_p1", {"max_new_tokens": 5, "eos_id": 1}],
                              ["s_p2", {"max_new_tokens": 6}]])
    if name == "engine_levers":
        # A 12-token prefix: one full page of 8 shared, the rest
        # recomputed (copy-on-write); batch-priority requests behind
        # interactive ones; an offline drain in waves.
        return dict(prefixes={"sys": list(range(1, 13))},
                    requests=[["e_p0", {"max_new_tokens": 6, "prefix_id": "sys"}],
                              ["e_p1", {"max_new_tokens": 5, "priority": "batch"}],
                              ["e_p2", {"max_new_tokens": 6, "prefix_id": "sys"}],
                              ["e_p3", {"max_new_tokens": 4, "priority": "batch"}],
                              ["s_p0", {"max_new_tokens": 5, "prefix_id": "sys"}]],
                    offline=[[f"pg_p{i}", {"max_new_tokens": 3 + i}] for i in range(4)])
    key = "pg_p" if name == "engine_paged" else "q8_p"
    return dict(engine=dict(PAGED), requests=[[f"{key}{i}", {"max_new_tokens": 8}]
                                              for i in range(4)],
                model={"kv_cache_dtype": "int8"} if name == "engine_paged_int8" else {})


def _ffn_state():
    return jax_common.create_train_state(JaxFFN(dtype=jnp.float32), jax.random.PRNGKey(0),
                                         (2, 28, 28, 1), optimizer=optax.sgd(0.1))


def _lm_state():
    return jax_common.create_train_state(_jax_lm(TINY), jax.random.PRNGKey(7), (8, 16),
                                         optimizer=optax.sgd(0.1), input_dtype=jnp.int32)


def _sharded_batches():
    rs = np.random.RandomState(0)
    return ({"image": rs.rand(8, 28, 28, 1).astype(np.float32),
             "label": rs.randint(0, 10, 8)},
            {"tokens": rs.randint(0, 64, (8, 17))})


def _launch(tmp_path_factory, ranks: int):
    d = tmp_path_factory.mktemp(f"tp{ranks}")
    np.save(d / "prompt.npy", _prompt())
    np.save(d / "prompt_spec.npy", _prompt(6))
    for key, prompts in _engine_prompts().items():
        for i, p in enumerate(prompts):
            np.save(d / f"{key}{i}.npy", p)
    images, lm_batch = _sharded_batches()
    np.save(d / "images.npy", images["image"])
    np.save(d / "labels.npy", images["label"])
    np.save(d / "lm_tokens.npy", lm_batch["tokens"])
    cases = []
    for name, (n, kind, mesh, extra) in CASES.items():
        if n != ranks:
            continue
        case = dict(name=name, kind=kind, mesh=mesh or {"data": -1})
        if kind in ("generate", "sampled_dp", "spec"):
            model = _jax_lm(TINY, **extra["knobs"])
            case["cfg"] = {**TINY, **extra["knobs"]}
            np.savez(d / f"{name}.npz", **flatten(_init(model)))
            if kind == "spec":
                np.savez(d / f"{name}_draft.npz",
                         **flatten(_init(_jax_lm({**TINY, "num_layers": 1}), seed=4)))
        elif kind in ("engine", "levers"):
            case.update(_engine_case(name), cfg=ENGINE)
            np.savez(d / f"{name}.npz", **flatten(_init(_jax_lm(ENGINE))))
            if case.get("draft"):
                np.savez(d / f"{name}_draft.npz", **flatten(_init(_jax_lm(ENGINE), seed=5)))
        else:
            lm = "lm" in name
            state = _lm_state() if lm else _ffn_state()
            np.savez(d / f"{name}.npz", **flatten(state.params))
            case.update(shape=extra["shape"], model_kind="lm" if lm else "ffn", cfg=TINY)
        cases.append(case)
    (d / "spec.json").write_text(json.dumps({"cases": cases}))
    return run_ranks(d, ranks, WORKER, str(d), str(d))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    memo = {}

    def get(ranks):
        if ranks not in memo:
            memo[ranks] = shared_once(tmp_path_factory, f"tp_ranks{ranks}",
                                      lambda: _launch(tmp_path_factory, ranks))
        return memo[ranks]

    return get


def _results(launched, name):
    runs = launched(CASES[name][0])
    for r, other in enumerate(runs[1:], 1):
        _assert_equal_tree(other[name], runs[0][name], f"rank {r}")
    return runs[0][name]


def _assert_equal_tree(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_equal_tree(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", ["tp4", "tp2_gqa", "tp2_int8_window16"])
def test_tp_generate_matches_jax_generate(launched, name):
    """``TestTPInference.test_tp_generate_matches_dense``: tp 4; tp 2 with
    GQA (one kv head per rank); tp 2 on the int8 cache with window 16.
    Greedy ``tp_generate`` equals JAX's one-device ``generate`` token for
    token, and the sharded model's logits equal JAX's apply."""
    got = _results(launched, name)
    model = _jax_lm(TINY, **CASES[name][3]["knobs"])
    params = _init(model)
    prompt = jnp.asarray(_prompt(), jnp.int32)
    ref = jax_generate(model, params, prompt, jax.random.PRNGKey(1), max_new_tokens=9,
                       temperature=0.0)
    np.testing.assert_array_equal(got["tokens"], np.asarray(ref))
    np.testing.assert_allclose(got["logits"], np.asarray(model.apply({"params": params}, prompt)),
                               **LOGIT_TOL)


def test_tp_generate_sampled_and_dp(launched):
    """``test_tp_generate_sampled_and_dp``: sampled rows over a {data: 2,
    model: 2} mesh draw by global row ids, so the stream equals the
    one-rank ``generate`` of the same seed; a caller's ``row_offset`` is
    refused (the wrapper owns it)."""
    got = _results(launched, "sampled_dp")
    np.testing.assert_array_equal(got["tp"], got["one"])
    assert got["row_offset"] is not None and "row_offset" in got["row_offset"]


def test_tp_speculative_greedy_and_sampled(launched):
    """``TestTPSpeculative``: greedy speculation over {data: 2, model: 2}
    equals JAX's one-device ``generate_speculative``; sampled runs are
    deterministic and agree with the one-rank run on most of at least one
    row (acceptance compares sums that add in another order); sampling
    without a seed is refused."""
    got = _results(launched, "speculative")
    model = _jax_lm(TINY)
    draft = _jax_lm({**TINY, "num_layers": 1})
    prompt = jnp.asarray(_prompt(6), jnp.int32)
    ref = jax_generate_speculative(model, _init(model), draft, _init(draft, seed=4), prompt,
                                   max_new_tokens=9, k=3)
    np.testing.assert_array_equal(got["greedy"], np.asarray(ref))
    np.testing.assert_array_equal(got["sampled"], got["again"])
    per_row = (got["sampled"][:, 7:] == got["one"][:, 7:]).mean(axis=1)
    assert per_row.max() >= 0.5, per_row
    assert got["no_seed"] is not None and "seed" in got["no_seed"]


@pytest.mark.parametrize("name", ["engine_dense", "engine_spec", "engine_paged",
                                  "engine_paged_int8"])
def test_engine_mesh_matches_jax_engine(launched, name):
    """The engine's ``mesh=`` workloads (``tests/test_lm_engine.py`` :592
    prefix + top-p sampling + eos + horizon 2; :1023 speculation at
    horizons 1 and 3; :1329 paged; :1475 paged int8): the tp=2 engine
    emits what the one-rank port engine does (sampled rows too), its
    greedy streams equal the JAX one-device engine's, and its caches hold
    half the (kv) heads."""
    got = _results(launched, name)
    case = _engine_case(name)
    prompts = {f"{k}{i}": p for k, ps in _engine_prompts().items() for i, p in enumerate(ps)}
    model = JaxLM(**ENGINE, dtype=jnp.float32, attention_impl="reference", ragged_decode=True,
                  **case.get("model", {}))
    params = _init(_jax_lm(ENGINE))
    ecfg = dict(slots=2, **{k: tuple(v) if isinstance(v, list) else v
                            for k, v in case["engine"].items()})
    if case.get("draft"):
        ecfg.update(draft_model=model, draft_params=_init(_jax_lm(ENGINE), seed=5))
    horizons = case.get("horizons", [ecfg.pop("decode_horizon", 1)])
    for h in horizons:
        key = h if h in got else str(h)
        assert got[key]["tp"] == got[key]["one"], h
        eng = JaxEngine(model, params, decode_horizon=h, **ecfg)
        for pname, toks in case.get("prefixes", {}).items():
            eng.register_prefix(pname, toks)
        ts = [eng.submit(prompts[p], **kw) for p, kw in case["requests"]]
        r = eng.run()
        for (p, kw), t, mine in zip(case["requests"], ts, got[key]["tp"]):
            if kw.get("temperature", 0.0) == 0.0:
                assert mine == [int(x) for x in r[t]], (h, p)
    heads_dim = 0 if "paged" in name else 1
    assert got["kv_shape"][heads_dim] * 2 == got["dense_kv_shape"][heads_dim]
    if case.get("sampled_twice"):
        assert got["twice"][0] == got["twice"][1]


def test_engine_mesh_composes_with_the_levers(launched):
    """Paged prefixes with copy-on-write pages, priority admission and
    ``run_offline`` under ``mesh=`` (as they compose in the JAX engine):
    the tp=2 engine emits what the one-rank engine does and hits the
    prefix as often; the one-rank engine's streams are held to JAX's by
    ``tests/test_torch_{prefix,qos}.py``."""
    got = _results(launched, "engine_levers")
    assert got["tp"]["paged"] == got["one"]["paged"]
    assert got["tp"]["offline"] == got["one"]["offline"]
    assert got["tp"]["hits"] == got["one"]["hits"] >= 1


@pytest.mark.parametrize("name", ["sharded_ffn_tp2", "sharded_lm_tp2", "sharded_ffn_dp2_tp2",
                                  "sharded_lm_dp2_tp2"])
def test_sharded_strategy_model_axis_matches_jax(launched, name):
    """``ShardedStrategy(model=2)`` (and ``data=2, model=2``, the
    ``TestHybridMesh`` dp x tp layout) on the FFN (DTensor ``Shard``
    placements by ``spec_for``) and the LM (the Megatron layout): three
    SGD steps' losses and the unsharded weights against JAX's
    ``ShardedStrategy(model=2)`` on the fake mesh."""
    got = _results(launched, name)
    lm = "lm" in name
    jst = JaxSharded(model=2, min_shard_size=1024)
    state = jst.shard_state(_lm_state() if lm else _ffn_state())
    batch = _sharded_batches()[1 if lm else 0]
    step = jst.step(jax_lm_step() if lm else jax_common.make_train_step())
    losses = []
    for _ in range(3):
        state, metrics = step(state, jst.distribute_batch(batch))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(got["losses"], losses, **TRAIN_TOL)
    assert got["losses"][-1] < got["losses"][0]
    want = flatten(jax.device_get(state.params))
    assert got["params"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got["params"][k], np.asarray(w), **TRAIN_TOL, err_msg=k)


def test_tp_refuses_moe_and_indivisible_heads():
    """``test_tp_rejects_moe``: tensor parallelism composes with dense LMs
    only; heads (and kv heads) must divide the degree."""
    cfg = dict(TINY, dtype="float32", device="cpu")
    with pytest.raises(NotImplementedError, match="expert"):
        TransformerLM(**cfg, moe_every=2, num_experts=2, tp_shards=2, tp_axis="model")
    with pytest.raises(ValueError, match="not divisible"):
        TransformerLM(**cfg, tp_shards=3, tp_axis="model")
    with pytest.raises(ValueError, match="kv heads not divisible"):
        TransformerLM(**cfg, num_kv_heads=2, tp_shards=4, tp_axis="model")


@pytest.mark.parametrize("layout", ["dense", "int8", "paged"])
def test_tp_cache_specs_slice_the_head_axis(layout):
    """``tp_cache_specs`` (the JAX package's one definition of both cache
    layouts): dense and int8 leaves cut on dim 1, paged pools on dim 0,
    ``idx`` and ``pages`` replicated; the cut equals the cache a
    ``tp_shards=2`` model sizes at its local heads."""
    from hops_tpu_torch.parallel.tp_inference import tp_cache_specs

    kw = dict(ragged_decode=True, kv_cache_dtype="int8" if layout == "int8" else None)
    if layout == "paged":
        kw.update(paged_decode=True, kv_pool_blocks=5, kv_page_size=8)
    dense = TransformerLM(**TINY, dtype="float32", device="cpu", **kw)
    cache = dense.init_cache(3)
    for t in cache.tensors():
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    local = tp_cache_specs(cache, 2, 1)
    want = TransformerLM(**TINY, dtype="float32", device="cpu", tp_axis="model", tp_shards=2,
                         **kw).init_cache(3)
    dim = 0 if layout == "paged" else 1
    for got, full, w in zip(local.tensors(), cache.tensors(), want.tensors()):
        assert got.shape == w.shape
        torch.testing.assert_close(got, full.chunk(2, dim)[1], rtol=0, atol=0)
    assert local.idx is cache.idx
    if layout == "paged":
        assert local.pages is cache.pages
