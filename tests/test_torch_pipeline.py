"""The port's pipeline parallelism (``hops_tpu_torch.parallel.pipeline``,
``pp_schedule``) against the JAX package, on the CPU.

In one process: the copied schedule tables (``tests/test_pipeline_schedule.py``'s
checks, and equal to the JAX module's tables), the refusals that need no
process group.

Across gloo processes (``python -m hops_tpu_torch.launch --platform
cpu``, one launch per rank count, the results handed to one parametrised
test per case): the cases of ``tests/test_pipeline.py`` and
``tests/test_pipeline_schedule.py``. JAX runs the same tiny fp32 LMs (or
the stage MLP) from the same weights on the dense model, as the JAX
tests hold their pipelines to it: logits at ``atol 1e-4``; losses,
gradients and the weights after an SGD step at ``rtol 1e-4, atol 1e-5``;
every rank's result equal to rank 0's bit for bit (the dense tree is
replicated and updated everywhere); the schedules (gpipe, 1f1b,
interleaved, and the autodiff ring) against each other bit for bit.
Three-axis compositions run on 8 ranks, the rest on 2 or 4.
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
from hops_tpu.models.moe import sum_sown_losses
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.models.transformer import make_lm_train_step as jax_lm_step
from hops_tpu.parallel import pp_schedule as jax_pp_schedule
from hops_tpu_torch.models.convert import flatten
from hops_tpu_torch.parallel import pp_schedule
from hops_tpu_torch.parallel.pp_schedule import PipelineSchedule, build_pp_schedule
from tests.test_torch_grad_comms import run_ranks, shared_once

LOGIT_TOL = dict(atol=1e-4, rtol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STAGES, DIM = 4, 16

# -- the schedule tables, in one process -----------------------------------------


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("m,s", [(4, 4), (8, 2), (2, 2)])
def test_schedule_covers_all_work_in_order(kind, m, s):
    sch = build_pp_schedule(kind, m, s)
    assert isinstance(sch, PipelineSchedule)
    for dev in range(s):
        for c in range(sch.v):
            fseq = [int(sch.f_mb[t, dev]) for t in range(sch.ticks) if sch.f_chunk[t, dev] == c]
            bseq = [int(sch.b_mb[t, dev]) for t in range(sch.ticks) if sch.b_chunk[t, dev] == c]
            assert sorted(fseq) == list(range(m))
            assert bseq == list(range(m))  # the accumulation-order invariant
    ref = jax_pp_schedule.build_pp_schedule(kind, m, s)
    for field in ("f_chunk", "f_mb", "b_chunk", "b_mb", "in_f_chunk", "in_f_mb",
                  "in_b_chunk", "in_b_mb"):
        np.testing.assert_array_equal(getattr(sch, field), getattr(ref, field))
    assert sch.bubble_fraction == ref.bubble_fraction


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "interleaved"])
def test_schedule_dependencies_hold(kind):
    m, s = 4, 4
    sch = build_pp_schedule(kind, m, s)
    done_f, done_b = {}, {}
    for t in range(sch.ticks):
        for dev in range(s):
            c, mb = int(sch.f_chunk[t, dev]), int(sch.f_mb[t, dev])
            if c >= 0:
                vs = c * s + dev
                if vs > 0:
                    assert done_f[(vs - 1, mb)] < t
                done_f[(vs, mb)] = t
            c, mb = int(sch.b_chunk[t, dev]), int(sch.b_mb[t, dev])
            if c >= 0:
                vs = c * s + dev
                assert done_f[(vs, mb)] < t
                if vs < sch.n_virtual - 1:
                    assert done_b[(vs + 1, mb)] < t
                done_b[(vs, mb)] = t
    assert len(done_b) == m * sch.n_virtual


def test_bubble_and_inflight_stats_and_validation():
    m, s = 8, 4
    gp, ob, il = (build_pp_schedule(k, m, s) for k in ("gpipe", "1f1b", "interleaved"))
    for sch in (gp, ob, il):
        assert 0.0 < sch.bubble_fraction < 1.0
        assert sch.microbatch_work_units() == 2 * m * sch.v
    assert ob.peak_in_flight <= s < gp.peak_in_flight
    assert il.bubble_fraction < gp.bubble_fraction
    with pytest.raises(ValueError, match="gpipe|1f1b|interleaved"):
        build_pp_schedule("pipedream", 4, 2)
    with pytest.raises(ValueError, match=">= 1"):
        build_pp_schedule("gpipe", 4, 2, 0)
    assert build_pp_schedule("gpipe", 4, 2, 2).v == 2
    assert "numpy" in pp_schedule.__doc__ and "torch" not in dir(pp_schedule)


def test_chunk_stage_params_layout():
    from hops_tpu_torch.parallel.pipeline import chunk_stage_params

    layers = [{"w": torch.full((2, 2), float(i))} for i in range(8)]
    chunked = chunk_stage_params(layers, 4)
    assert chunked["w"].shape == (4, 2, 2, 2)
    assert float(chunked["w"][1, 0, 0, 0]) == 2.0  # stage 1 holds layers 2, 3
    with pytest.raises(ValueError, match="divisible"):
        chunk_stage_params(layers, 3)


# -- the cases on gloo ranks ---------------------------------------------------------

WORKER = r'''
import json, pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
from hops_tpu_torch.models.common import create_train_state
from hops_tpu_torch.models.convert import load_npz, params_to_flax
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.parallel import mesh as mesh_lib, multihost
from hops_tpu_torch.parallel import pipeline as pp
from hops_tpu_torch.telemetry.metrics import REGISTRY

data, out = sys.argv[1], sys.argv[2]
spec = json.load(open(f"{data}/spec.json"))
rank = multihost.process_index()
res = {}


def lm(case):
    m = TransformerLM(**case["cfg"], dtype="float32", device="cpu", attention_impl="reference")
    return m.load_flax(f"{data}/{case['name']}.npz")


def arr(name):
    return torch.from_numpy(np.load(f"{data}/{name}.npy"))


def stage_fn(p, h):
    return h + torch.tanh(h @ p["w"] + p["b"])


def train(case, mesh, schedule=None, v=None, steps=1, opt="sgd"):
    m = lm(case)
    o = (torch.optim.SGD(m.parameters(), lr=0.1) if opt == "sgd"
         else torch.optim.Adam(m.parameters(), lr=1e-2))
    state = create_train_state(m, optimizer=o)
    step = pp.make_pp_lm_train_step(m, mesh, schedule=schedule, virtual_stages=v,
                                    num_microbatches=case.get("m"), **case.get("kw", {}))
    if schedule is not None:
        step = pp.instrument_pp_step(step)
    losses = []
    for _ in range(steps):
        state, met = step(state, {"tokens": arr(case["name"] + "_tokens").long()})
        losses.append(float(met["loss"]))
    return {"losses": losses, "params": params_to_flax(m)}


for case in spec["cases"]:
    name, kind = case["name"], case["kind"]
    mesh = mesh_lib.make_mesh(case["mesh"])
    kw = case.get("kw", {})
    if kind in ("apply", "grads"):
        m = lm(case)
        tok = arr(name + "_tokens").long()
        taps = pp.GradTaps() if kind == "grads" else None
        with torch.set_grad_enabled(kind == "grads"):
            logits, aux = pp.pipelined_lm_apply(m, tok, mesh, return_aux=True, taps=taps,
                                                num_microbatches=case.get("m"), **kw)
        got = {"logits": logits.detach().numpy(), "aux": float(aux)}
        if kind == "grads":
            target = aux if case.get("of") == "aux" else (logits ** 2).mean()
            target.backward()
            taps.reduce(m, mesh, pp.pipeline_grad_axes(m, mesh, **kw))
            got["grads"] = {n: (p.grad.numpy() if p.grad is not None else None)
                            for n, p in m.named_parameters()}
        res[name] = got
    elif kind == "step":
        res[name] = train(case, mesh, steps=case.get("steps", 1), opt=case.get("opt", "sgd"))
    elif kind == "schedules":
        got = {}
        for label, sched, v in case["runs"]:
            got[label] = train(case, mesh, schedule=sched, v=v, steps=2)
        gauge = REGISTRY.gauge("hops_tpu_pp_bubble_fraction", labels=("schedule",))
        hist = REGISTRY.histogram("hops_tpu_pp_microbatch_seconds", labels=("schedule",))
        got["bubble"] = {k: gauge.value(schedule=k) for k in ("gpipe", "1f1b", "interleaved")}
        got["timed"] = any(v > 0 for *_, v in hist.samples())
        res[name] = got
    elif kind == "refusals":
        m = lm(case)
        moe = TransformerLM(**{**case["cfg"], "moe_every": 2, "num_experts": 2,
                               "moe_top_k": 2}, dtype="float32", device="cpu",
                            attention_impl="reference")
        got = {}
        for label, fn in (
                ("compose", lambda: pp.make_pp_lm_train_step(m, mesh, schedule="1f1b",
                                                              seq_axis="seq")),
                ("moe_sched", lambda: pp.make_pp_lm_train_step(moe, mesh, schedule="1f1b")),
                ("v4", lambda: pp.make_pp_lm_train_step(m, mesh, schedule="interleaved",
                                                        virtual_stages=4)),
                ("sp_moe", lambda: pp.pipelined_lm_apply(moe, torch.zeros((4, 8), dtype=torch.long),
                                                         mesh, seq_axis="seq")),
                ("tp_moe", lambda: pp.pipelined_lm_apply(moe, torch.zeros((4, 8), dtype=torch.long),
                                                         mesh, tp_axis="seq")),
                ("ep_dense", lambda: pp.pipelined_lm_apply(m, torch.zeros((4, 8), dtype=torch.long),
                                                           mesh, expert_axis="seq"))):
            try:
                fn()
                got[label] = None
            except Exception as e:
                got[label] = (type(e).__name__, str(e))
        res[name] = got
    elif kind == "generic":
        w, b = arr("mlp_w"), arr("mlp_b")
        stacked = {"w": w.clone().requires_grad_(), "b": b.clone().requires_grad_()}
        x = arr("mlp_x")
        got = {"out": pp.pipeline_apply(stage_fn, stacked, x, mesh).detach().numpy()}
        x16 = arr("mlp_x16")
        got["more"] = pp.pipeline_apply(stage_fn, stacked, x16, mesh,
                                        num_microbatches=8).detach().numpy()
        pp.pipeline_apply(stage_fn, stacked, x, mesh).sum().backward()
        pp.psum_grads([stacked["w"], stacked["b"]], mesh, ["stage"])
        got["grads"] = {k: t.grad.numpy() for k, t in stacked.items()}
        got["ingest"] = pp.pipeline_apply(
            stage_fn, stacked, arr("mlp_tok").long(), mesh,
            ingest_fn=lambda p, t: p[t], ingest_params=arr("mlp_table"),
            emit_fn=lambda p, h: h @ p, emit_params=arr("mlp_head")).detach().numpy()
        try:
            pp.pipeline_apply(stage_fn, stacked, torch.zeros((6, w.shape[-1])), mesh)
            got["bad"] = None
        except ValueError as e:
            got["bad"] = str(e)
        res[name] = got
with open(f"{out}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
'''

TINY32 = dict(vocab_size=32, d_model=16, num_heads=2, num_layers=4, max_decode_len=32)
TINY64 = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=8, max_decode_len=64)
MOE = dict(moe_every=2, num_experts=2, moe_top_k=2)

# name: (ranks, kind, mesh, cfg, tokens shape, extras)
CASES = {
    "lm_matches_dense": (4, "apply", {"stage": 4}, TINY64, (8, 16), {}),
    "lm_grads_match_dense": (4, "grads", {"stage": 4}, TINY32, (4, 8), {}),
    "moe_matches_dense": (4, "apply", {"stage": 4},
                          dict(TINY64, moe_every=2, num_experts=4, moe_top_k=4), (8, 16), {}),
    "all_moe_matches_dense": (4, "apply", {"stage": 4},
                              dict(TINY32, moe_every=1, num_experts=2, moe_top_k=2), (4, 8), {}),
    "moe_token_dropping_runs": (4, "apply", {"stage": 4},
                                dict(TINY64, moe_every=2, num_experts=4, moe_top_k=1), (8, 16),
                                {"no_ref": True}),
    "moe_grads_match_dense": (4, "grads", {"stage": 4}, dict(TINY32, num_layers=8, **MOE),
                              (4, 8), {}),
    "moe_aux_matches_dense": (4, "grads", {"stage": 4},
                              dict(TINY64, moe_every=2, num_experts=4, moe_top_k=4), (8, 16),
                              {"of": "aux"}),
    "sp_inside": (4, "apply", {"stage": 2, "seq": 2}, dict(TINY64, num_layers=4), (4, 16),
                  {"kw": {"seq_axis": "seq"}}),
    "ep_inside": (4, "apply", {"stage": 2, "expert": 2},
                  dict(TINY64, num_layers=4, moe_every=2, num_experts=4, moe_top_k=4), (4, 16),
                  {"kw": {"expert_axis": "expert"}}),
    "sp_gqa_windowed": (4, "apply", {"stage": 2, "seq": 2},
                        dict(TINY64, num_layers=4, num_kv_heads=2, window=4), (4, 16),
                        {"kw": {"seq_axis": "seq"}}),
    "train_step_matches_dense": (4, "step", {"stage": 4}, TINY32, (4, 9), {}),
    "train_with_inner_sp": (4, "step", {"stage": 2, "seq": 2}, TINY32, (4, 9),
                            {"kw": {"seq_axis": "seq"}, "steps": 5, "opt": "adam"}),
    "dp_outside_pp": (4, "step", {"data": 2, "stage": 2}, TINY32, (8, 9),
                      {"kw": {"batch_axis": "data"}}),
    "dp_outside_pp_logits": (4, "apply", {"data": 2, "stage": 2}, TINY32, (8, 8),
                             {"kw": {"batch_axis": "data"}}),
    "tp_inside": (4, "step", {"stage": 2, "model": 2}, TINY32, (4, 9),
                  {"kw": {"tp_axis": "model"}}),
    "tp_inside_grads": (4, "grads", {"stage": 2, "model": 2}, TINY32, (4, 8),
                        {"kw": {"tp_axis": "model"}}),
    "ep_inside_grads": (4, "grads", {"stage": 2, "expert": 2}, dict(TINY32, **MOE), (4, 8),
                        {"kw": {"expert_axis": "expert"}}),
    "gqa": (4, "apply", {"stage": 4}, dict(TINY32, num_heads=4, num_kv_heads=2), (4, 8), {}),
    "gqa_tp": (4, "apply", {"stage": 2, "model": 2}, dict(TINY32, num_heads=4, num_kv_heads=2),
               (4, 8), {"kw": {"tp_axis": "model"}}),
    "windowed": (4, "apply", {"stage": 4}, dict(TINY32, window=4), (4, 16), {}),
    "gqa_moe": (4, "apply", {"stage": 4}, dict(TINY32, num_layers=8, num_heads=4,
                                              num_kv_heads=2, **MOE), (4, 8), {}),
    "windowed_moe": (4, "apply", {"stage": 4}, dict(TINY32, num_layers=8, window=4, **MOE),
                     (4, 16), {}),
    "dp_pp_sp": (8, "apply", {"data": 2, "stage": 2, "seq": 2}, TINY32, (4, 16),
                 {"kw": {"batch_axis": "data", "seq_axis": "seq"}}),
    "dp_pp_tp": (8, "step", {"data": 2, "stage": 2, "model": 2}, TINY32, (8, 9),
                 {"kw": {"batch_axis": "data", "tp_axis": "model"}}),
    "dp_pp_ep": (8, "apply", {"data": 2, "stage": 2, "expert": 2}, dict(TINY32, **MOE), (8, 8),
                 {"kw": {"batch_axis": "data", "expert_axis": "expert"}}),
    "schedules": (2, "schedules", {"stage": 2}, TINY32, (8, 9),
                  {"m": 4, "runs": [["ring", None, None], ["gpipe", "gpipe", 1],
                                    ["1f1b", "1f1b", 1], ["gpipe_v2", "gpipe", 2],
                                    ["interleaved", "interleaved", 2]]}),
    "refusals": (2, "refusals", {"stage": 2}, TINY32, (4, 8), {}),
}
GENERIC = {4: "generic"}


def _case_names(ranks: int) -> list[str]:
    return [n for n, c in CASES.items() if c[0] == ranks]


def _jax_setup(name):
    """The case's JAX model, its initial params (a train state's for step
    cases) and its tokens, from fixed seeds."""
    _, kind, _, cfg, shape, extra = CASES[name]
    seed = sum(map(ord, name))
    model = JaxLM(**cfg, dtype=jnp.float32, attention_impl="reference")
    tokens = jax.random.randint(jax.random.PRNGKey(seed), shape, 0, cfg["vocab_size"])
    if kind in ("step", "schedules"):
        state = jax_common.create_train_state(
            model, jax.random.PRNGKey(seed + 1), (shape[0], shape[1] - 1),
            optimizer=optax.sgd(0.1) if extra.get("opt", "sgd") == "sgd" else optax.adam(1e-2),
            input_dtype=jnp.int32)
        return model, state.params, tokens, state
    params = model.init(jax.random.PRNGKey(seed + 1), tokens)["params"]
    return model, params, tokens, None


def _launch(tmp_path_factory, ranks: int):
    d = tmp_path_factory.mktemp(f"pipeline{ranks}")
    cases = []
    for name in _case_names(ranks):
        _, kind, mesh, cfg, _, extra = CASES[name]
        _, params, tokens, _ = _jax_setup(name)
        np.savez(d / f"{name}.npz", **flatten(params))
        np.save(d / f"{name}_tokens.npy", np.asarray(tokens))
        cases.append(dict(name=name, kind=kind, mesh=mesh, cfg=cfg,
                          **{k: v for k, v in extra.items() if k != "no_ref"}))
    if ranks in GENERIC:
        rs = np.random.RandomState(0)
        np.save(d / "mlp_w.npy", (rs.randn(STAGES, DIM, DIM) * 0.3).astype(np.float32))
        np.save(d / "mlp_b.npy", (rs.randn(STAGES, DIM) * 0.1).astype(np.float32))
        np.save(d / "mlp_x.npy", rs.randn(8, DIM).astype(np.float32))
        np.save(d / "mlp_x16.npy", rs.randn(16, DIM).astype(np.float32))
        np.save(d / "mlp_table.npy", (rs.randn(32, DIM) * 0.2).astype(np.float32))
        np.save(d / "mlp_head.npy", (rs.randn(DIM, 7) * 0.2).astype(np.float32))
        np.save(d / "mlp_tok.npy", rs.randint(0, 32, (8,)))
        cases.append(dict(name="generic", kind="generic", mesh={"stage": STAGES}))
    (d / "spec.json").write_text(json.dumps({"cases": cases}))
    return {"dir": str(d), "ranks": run_ranks(d, ranks, WORKER, str(d), str(d))}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    memo = {}

    def get(ranks):
        if ranks not in memo:
            memo[ranks] = shared_once(tmp_path_factory, f"pipeline_ranks{ranks}",
                                      lambda: _launch(tmp_path_factory, ranks))
        return memo[ranks]

    return get


def _results(launched, name, ranks):
    runs = launched(ranks)["ranks"]
    for r, other in enumerate(runs[1:], 1):  # the replicated result, bit for bit
        _assert_equal_tree(other[name], runs[0][name], f"rank {r}")
    return runs[0][name]


def _assert_equal_tree(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_equal_tree(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _assert_equal_tree(x, y, what)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _port_grads_to_flax(grads: dict) -> dict:
    return {n.replace(".", "/"): g for n, g in grads.items()}


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][1] in ("apply", "grads")])
def test_pipelined_lm_matches_jax_dense(launched, name):
    """The cases of ``tests/test_pipeline.py``: ``pipelined_lm_apply`` (and
    its compositions) against the dense JAX apply — logits, the
    ring-carried aux, and (``grads`` cases) the replicated gradients of
    ``mean(logits**2)`` (or of aux) after ``GradTaps.reduce``."""
    ranks, kind, _, _, shape, extra = CASES[name]
    got = _results(launched, name, ranks)
    model, params, tokens, _ = _jax_setup(name)
    logits = got["logits"]
    assert logits.shape == (*shape, model.vocab_size) and np.isfinite(logits).all()
    if extra.get("no_ref"):  # capacity drops are per microbatch under pp
        return
    dense, mods = model.apply({"params": params}, tokens, mutable=["losses"])
    np.testing.assert_allclose(logits, np.asarray(dense), **LOGIT_TOL)
    if model.moe_every:
        np.testing.assert_allclose(got["aux"], float(sum_sown_losses(mods)), rtol=1e-5)
    if kind != "grads":
        return
    if extra.get("of") == "aux":
        def target(p):
            return sum_sown_losses(model.apply({"params": p}, tokens, mutable=["losses"])[1])
    else:
        def target(p):
            return jnp.mean(model.apply({"params": p}, tokens) ** 2)
    want = flatten(jax.grad(target)(params))
    port = _port_grads_to_flax(got["grads"])
    assert port.keys() == want.keys()
    for k, g in want.items():
        have = np.zeros_like(g) if port[k] is None else port[k]
        np.testing.assert_allclose(have, np.asarray(g), **GRAD_TOL, err_msg=k)
    if extra.get("of") == "aux":
        assert np.abs(port["block_1/moe/router/kernel"]).max() > 0


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][1] == "step"])
def test_pp_train_step_matches_jax_dense_step(launched, name):
    """``make_pp_lm_train_step`` (ring; sp, dp, tp, dp x tp inside) against
    the JAX dense train step from the same state: the loss and the
    weights after one SGD step; with inner sp, five Adam steps whose loss
    falls (``test_pp_train_step_with_inner_sp``)."""
    ranks, _, _, _, _, extra = CASES[name]
    got = _results(launched, name, ranks)
    model, _, tokens, state = _jax_setup(name)
    if extra.get("steps", 1) > 1:
        assert got["losses"][-1] < got["losses"][0]
        return
    new, metrics = jax_lm_step()(state, {"tokens": tokens})
    np.testing.assert_allclose(got["losses"][0], float(metrics["loss"]), **GRAD_TOL)
    want = flatten(new.params)
    for k, w in want.items():
        np.testing.assert_allclose(got["params"][k], np.asarray(w), **GRAD_TOL, err_msg=k)


def test_all_schedules_bit_identical_losses_and_grads(launched):
    """``tests/test_pipeline.py``'s equivalence matrix and more: gpipe,
    1f1b, interleaved (v=2) and the autodiff ring give bit-identical
    losses and weights over two SGD steps (every schedule folds each
    parameter's microbatch gradients in ascending order); gpipe agrees
    with the JAX dense step; the bubble gauge holds each schedule's
    fraction and the instrumented steps observed their wall time."""
    got = _results(launched, "schedules", 2)
    runs = ["ring", "gpipe", "1f1b", "gpipe_v2", "interleaved"]
    for other in runs[1:]:
        assert got[other]["losses"] == got["ring"]["losses"], other
        _assert_equal_tree(got[other]["params"], got["ring"]["params"], other)
    model, _, tokens, state = _jax_setup("schedules")
    _, metrics = jax_lm_step()(state, {"tokens": tokens})
    np.testing.assert_allclose(got["gpipe"]["losses"][0], float(metrics["loss"]), **GRAD_TOL)
    # The gauge holds each kind's last built schedule (gpipe's at v=2).
    for kind, v in (("gpipe", 2), ("1f1b", None), ("interleaved", None)):
        sched = build_pp_schedule(kind, 4, 2, v)
        assert got["bubble"][kind] == pytest.approx(sched.bubble_fraction)
    assert got["bubble"]["interleaved"] < build_pp_schedule("gpipe", 4, 2).bubble_fraction
    assert got["timed"]


def test_schedule_weights_match_jax_after_one_step(launched):
    """One scheduled step (1f1b) from the JAX state equals the JAX dense
    step: the explicit tick program is another derivation of the same
    math (``test_scheduled_gpipe_matches_autodiff_ring_and_dense``)."""
    got = _results(launched, "schedules", 2)
    model, _, tokens, state = _jax_setup("schedules")
    s1, _ = jax_lm_step()(state, {"tokens": tokens})
    s2, m2 = jax_lm_step()(s1, {"tokens": tokens})
    np.testing.assert_allclose(got["1f1b"]["losses"][1], float(m2["loss"]), **GRAD_TOL)
    for k, w in flatten(s2.params).items():
        np.testing.assert_allclose(got["1f1b"]["params"][k], np.asarray(w), **GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("label,exc,match", [
    ("compose", "NotImplementedError", "pure stage mesh"),
    ("moe_sched", "NotImplementedError", "dense"),
    ("v4", "ValueError", "divisible"),
    ("sp_moe", "NotImplementedError", "expert_axis"),
    ("tp_moe", "NotImplementedError", "dense LMs"),
    ("ep_dense", "ValueError", "MoE model"),
])
def test_pipeline_refusals(launched, label, exc, match):
    """The JAX package's refusals (``pipeline.py:274``, ``:282``, ``:463``,
    ``:706``, and the ``expert_axis`` check), raised before any
    collective."""
    got = _results(launched, "refusals", 2)[label]
    assert got is not None and got[0] == exc and match in got[1], got


def _seq_stage(params, x):
    for s in range(STAGES):
        x = x + jnp.tanh(x @ params["w"][s] + params["b"][s])
    return x


@pytest.mark.parametrize("what", ["out", "more", "grads", "ingest", "bad"])
def test_generic_pipeline_apply(launched, what):
    """``pipeline_apply`` over 4 stages of a residual MLP against the
    sequential JAX computation: outputs, 8 microbatches, the gradients of
    ``sum(out)`` (summed over the stage axis by ``psum_grads``), ingest
    and emit hooks with other shapes, and a batch that does not split."""
    got = _results(launched, "generic", 4)[what]
    d = launched(4)["dir"]
    p = {"w": jnp.asarray(np.load(f"{d}/mlp_w.npy")), "b": jnp.asarray(np.load(f"{d}/mlp_b.npy"))}
    x = jnp.asarray(np.load(f"{d}/mlp_x.npy"))
    if what == "out":
        np.testing.assert_allclose(got, _seq_stage(p, x), atol=1e-5, rtol=1e-5)
    elif what == "more":
        x16 = jnp.asarray(np.load(f"{d}/mlp_x16.npy"))
        np.testing.assert_allclose(got, _seq_stage(p, x16), atol=1e-5, rtol=1e-5)
    elif what == "grads":
        want = jax.grad(lambda q: _seq_stage(q, x).sum())(p)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4, rtol=1e-4)
    elif what == "ingest":
        table = jnp.asarray(np.load(f"{d}/mlp_table.npy"))
        head = jnp.asarray(np.load(f"{d}/mlp_head.npy"))
        tok = np.load(f"{d}/mlp_tok.npy")
        assert got.shape == (8, 7)
        np.testing.assert_allclose(got, _seq_stage(p, table[tok]) @ head, atol=1e-5, rtol=1e-5)
    else:
        assert got is not None and "microbatches" in got
