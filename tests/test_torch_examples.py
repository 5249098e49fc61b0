"""The port's example suite (``examples_torch/``) held to the JAX
package's (``examples/``): each example's ``main`` runs in both packages
on the CPU, each in a workspace of its own, at the sizes
``tests/test_docs_and_examples.py`` runs the JAX examples.

What does not depend on a random stream must be equal across the two:
counts, dispatch numbers, parity counts, ledger and gate outcomes, row
counts and columns, feature-group and split counts, job states. What
depends on the initial weights or on sampling (the frameworks draw
different numbers from one seed) is held to the JAX example's own
thresholds. Where a JAX example's weights carry across
(``continuous_batching``, ``lm_serving``, ``long_context_lm``: through
``models.convert.params_from_flax``), the greedy streams must be
identical, the logits within ``atol 1e-4`` (fp32, another summation
order) and the loss within ``rtol 1e-4``. ``decode_bench`` builds its
own weights and is held within the port: its four modes at 2 layers,
``d_model`` 64 and 16 tokens, and its continuous engine's greedy streams
against plain ``generate``.

The port's examples take ``device="cpu"`` here (their default is the
card). ``long_context_lm`` runs on 4 gloo ranks (data 2 x seq 2, launched
once per session) against JAX's fake 8-device mesh (data 2 x seq 4), the
same global batch of 4 rows.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from hops_tpu import jobs as j_jobs
from hops_tpu.jobs import api as j_api
from hops_tpu.jobs import dataset as j_dataset
from hops_tpu_torch import jobs as t_jobs
from hops_tpu_torch.jobs import api as t_api
from hops_tpu_torch.jobs import dataset as t_dataset
from hops_tpu_torch.runtime import config as t_config
from test_torch_grad_comms import run_ranks, shared_once

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
WAIT_S = 120


@pytest.fixture
def port_workspace(tmp_path, monkeypatch):
    """Call after the JAX run: points the port's runtime config (and the
    workspace variable its job children inherit) at a workspace of its
    own."""
    def switch() -> Path:
        ws = tmp_path / "torch_ws"
        monkeypatch.setattr(t_config, "_current", t_config.runtime())
        t_config.configure(workspace=str(ws), project="testproj")
        monkeypatch.setenv("HOPS_TPU_WORKSPACE", str(ws))
        return ws

    return switch


@pytest.fixture(autouse=True)
def _relay_lock(tmp_path, monkeypatch):
    monkeypatch.setenv("HOPS_TPU_RELAY_LOCK", str(tmp_path / "relay.lock"))


def _numpy_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# -- the feature store and jobs ----------------------------------------------


def test_featurestore_tour_inprocess(port_workspace):
    from examples import featurestore_tour as j_tour
    from examples_torch import featurestore_tour as t_tour

    want = j_tour.main([])
    port_workspace()
    got = t_tour.main([], device=CPU)
    assert want["feature_groups"] == 5 and want["td_splits"]["train"] > 0
    assert got == want


def _job(jobs, api, name: str, app: str, args: list[str]):
    jobs.create_job(name, api.JobConfig(app_file=app, default_args=args))
    ex = jobs.start_job(name)
    return jobs.wait_for_completion(name, ex.execution_id, timeout_s=WAIT_S)


def test_featurestore_tour_as_job(port_workspace):
    want = _job(j_jobs, j_api, "fs_tour", str(REPO / "examples/featurestore_tour.py"),
                ["--td-version", "2"])
    port_workspace()
    got = _job(t_jobs, t_api, "fs_tour", str(REPO / "examples_torch/featurestore_tour.py"),
               ["--td-version", "2", "--device", CPU])
    for done in (want, got):
        assert done.state == "FINISHED", done.stdout()
        assert "tour complete" in done.stdout()


def test_pi_job_with_staged_workspace(tmp_path, port_workspace):
    """jobs-client workflow: zip workspace -> stage -> extract -> run as job."""
    outs = []
    for pkg, jobs, api, dataset, src, extra in (
            ("jax", j_jobs, j_api, j_dataset, "examples", []),
            ("torch", t_jobs, t_api, t_dataset, "examples_torch", ["--device", CPU])):
        if pkg == "torch":
            port_workspace()
        ws = tmp_path / pkg / "ws"
        ws.mkdir(parents=True)
        for name in ("pi.py", "pi_util.py"):
            (ws / name).write_text((REPO / src / name).read_text())
        staged = dataset.upload_workspace(ws, "Resources", name="pi_program.zip")
        rundir = dataset.extract(staged, tmp_path / pkg / "run")
        done = _job(jobs, api, "pi_job", str(Path(rundir) / "pi.py"), ["200000", *extra])
        assert done.state == "FINISHED", done.stdout()
        assert "pi is roughly 3.1" in done.stdout()
        outs.append((done.state, sorted(p.name for p in Path(rundir).iterdir())))
    assert outs[1] == outs[0]


def test_taxi_pipeline_inprocess(port_workspace):
    from examples import taxi_pipeline as j_taxi
    from examples_torch import taxi_pipeline as t_taxi

    want = j_taxi.main()
    port_workspace()
    got = t_taxi.main(device=CPU)
    for r in (want, got):
        assert r["metrics"]["accuracy"] > 0.5
        assert r["best"]["version"] == 1


def test_feature_serving_inprocess(port_workspace):
    from examples import feature_serving as j_fs
    from examples_torch import feature_serving as t_fs

    want = j_fs.main([])
    port_workspace()
    got = t_fs.main([], device=CPU)
    for r in (want, got):
        assert r["online_matches_offline"]
        assert len(r["predictions"]) == 3 and all(len(p) == 2 for p in r["predictions"])
    assert got["entities"] == want["entities"] == 32


# -- search, plotting, the Python predictor ----------------------------------


def test_lagom_search_inprocess(port_workspace):
    from examples import lagom_search as j_lagom
    from examples_torch import lagom_search as t_lagom

    want = j_lagom.main()
    port_workspace()
    got = t_lagom.main(device=CPU)
    for r in (want, got):
        assert r["best_metric"] > 0.5
        assert r["best_config"].keys() == {"kernel", "pool", "dropout"}
    assert got["num_trials"] == want["num_trials"]


def test_plotting_tour_inprocess(port_workspace):
    from examples import plotting_tour as j_plot
    from examples_torch import plotting_tour as t_plot

    want = j_plot.main()
    port_workspace()
    got = t_plot.main(device=CPU)
    for r in (want, got):
        assert len(r["figures"]) == 3
        for f in r["figures"]:
            assert Path(f).read_bytes()[:4] == b"\x89PNG", f
    assert [Path(f).name for f in got["figures"]] == [Path(f).name for f in want["figures"]]


def test_iris_sklearn_python_predictor(port_workspace):
    from examples import iris_sklearn as j_iris
    from examples_torch import iris_sklearn as t_iris

    want = j_iris.main()
    port_workspace()
    got = t_iris.main(device=CPU)
    assert want["accuracy"] > 0.9 and len(want["predictions"]) == 3
    assert got == want


# -- the launchers and classifiers -------------------------------------------


@pytest.fixture
def one_thread():
    """Sums in one order on any machine (and no oversubscription under
    xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_golden_metric_parity_on_real_data(port_workspace, one_thread):
    """The reference's golden accuracies on real handwritten digits, met
    by both packages' launcher twins (the port on one rank: the
    mirrored CNN takes 8 rows a step where JAX's 8 fake devices take 64)."""
    from examples import golden_parity as j_golden
    from examples_torch import golden_parity as t_golden

    want = j_golden.main()
    port_workspace()
    got = t_golden.main(device=CPU)
    assert (t_golden.GOLDEN_FFN, t_golden.GOLDEN_CNN) == (j_golden.GOLDEN_FFN,
                                                          j_golden.GOLDEN_CNN)
    for r in (want, got):
        assert r["ffn"] >= j_golden.GOLDEN_FFN, r
        assert r["cnn"] >= j_golden.GOLDEN_CNN, r


def test_torch_example_through_launch_and_de(port_workspace, one_thread):
    from examples import torch_mnist as j_tm
    from examples_torch import torch_mnist as t_tm

    want = j_tm.main(generations=1, population=4)
    port_workspace()
    got = t_tm.main(generations=1, population=4, device=CPU)
    for r in (want, got):
        assert r["launch"]["accuracy"] > 0.85
        assert r["de"]["best_metric"] > 0.85
        assert 1e-4 <= r["de"]["best_config"]["lr"] <= 1e-2
        assert (Path(r["logdir"]) / "model.pt").exists()


def test_mnist_pipeline_serves_the_best_version(port_workspace, one_thread):
    from examples import mnist_pipeline as j_mp
    from examples_torch import mnist_pipeline as t_mp

    want = j_mp.main()
    port_workspace()
    got = t_mp.main(device=CPU)
    for r in (want, got):
        assert len(r["predictions"]) == 2 and all(len(p) == 10 for p in r["predictions"])
        assert r["logged"] >= 1
    assert (got["best"]["version"], got["logged"]) == (want["best"]["version"], want["logged"])


def test_distributed_training_twins(port_workspace, one_thread):
    from examples import distributed_training as j_dt
    from examples_torch import distributed_training as t_dt

    want = j_dt.main()
    port_workspace()
    got = t_dt.main(device=CPU)
    for r in (want, got):
        for kind in ("mirrored", "collective"):
            assert 0.0 <= r[kind]["metric"] <= 1.0 and np.isfinite(r[kind]["loss"])
    assert got.keys() == want.keys()


def test_preemptible_training_example(port_workspace, one_thread):
    from examples import preemptible_training as j_pre
    from examples_torch import preemptible_training as t_pre

    want = j_pre.main(num_steps=8, preempt_at=3)
    port_workspace()
    got = t_pre.main(num_steps=8, preempt_at=3, device=CPU)

    def counts(r):
        return {k: (r[k]["steps_completed"], r[k]["optimizer_steps"]) for k in r}

    assert counts(want) == counts(got) == {"first": (3, 3), "second": (8, 8)}
    assert np.isfinite(got["second"]["loss"])


def test_continuous_training_example(port_workspace):
    from examples import continuous_training as j_ct
    from examples_torch import continuous_training as t_ct

    want = j_ct.main(records=24, span_records=4, eval_every=2)
    port_workspace()
    got = t_ct.main(records=24, span_records=4, eval_every=2, device=CPU)

    def outcome(r):
        ledger = r["ledger"]
        return (r["steps"], r["records_trained"], ledger["contiguous"], ledger["disjoint"],
                [tuple(g) for g in r["gates"]], r["published_versions"], r["held_back"])

    assert outcome(got) == outcome(want)
    assert want["records_trained"] == 24 and want["held_back"] == 1


def test_batch_inference_example(port_workspace, one_thread):
    from examples import batch_inference as j_bi
    from examples_torch import batch_inference as t_bi

    want = j_bi.main(n_images=70, per_chip_batch=4)
    port_workspace()
    got = t_bi.main(n_images=70, per_chip_batch=4, device=CPU)
    frames = []
    for r in (want, got):
        assert r["rows"] == 70
        df = pd.read_parquet(r["path"])
        assert set(df.columns) == {"image_id", "prediction", "probability"}
        assert df["prediction"].between(0, 9).all()
        assert df["probability"].between(0.0, 1.0).all()
        frames.append((len(df), list(df.columns), df["image_id"].tolist()))
    assert frames[1] == frames[0]
    assert (got["rows"], got["version"], got["lm_generated"]) == (
        want["rows"], want["version"], want["lm_generated"])


# -- the language-model examples ---------------------------------------------


def test_continuous_batching_example_with_jax_weights(port_workspace):
    """Six ragged requests through 3 slots, the speculative and the paged
    engines: the port's outcome on the JAX example's weights equals the
    JAX example's, and its greedy streams are JAX ``generate``'s."""
    import jax
    import jax.numpy as jnp

    from examples import continuous_batching as j_cb
    from examples_torch import continuous_batching as t_cb
    from hops_tpu.models.generation import generate as j_generate
    from hops_tpu.models.transformer import TransformerLM as JLM
    from hops_tpu_torch.models.generation import generate as t_generate

    want = j_cb.main()
    assert want["parity"] == want["requests"] == 6 and want["spec_parity"] == 6
    assert want["dispatches"] < want["naive_dispatches"]
    kw = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, dtype=jnp.float32,
              attention_impl="reference", max_decode_len=64)
    jmodel = JLM(**kw)
    zeros = jnp.zeros((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), zeros)["params"]
    draft = jmodel.init(jax.random.PRNGKey(7), zeros)["params"]
    port_workspace()
    got = t_cb.main(params=_numpy_tree(params), draft_params=_numpy_tree(draft), device=CPU)
    assert got == want
    # The streams themselves, and the logits they were drawn from.
    plain, _, _ = t_cb.build(_numpy_tree(params), _numpy_tree(draft), device=CPU)
    for prompt, budget in t_cb.make_requests():
        ref = j_generate(jmodel, params, jnp.asarray(prompt)[None], jax.random.PRNGKey(0),
                         max_new_tokens=budget, temperature=0.0)
        out = t_generate(plain, prompt[None], max_new_tokens=budget, temperature=0.0,
                         device=CPU)
        assert out[0].tolist() == np.asarray(ref[0]).tolist()
        with torch.no_grad():
            logits = plain(torch.as_tensor(out[:, :-1])).numpy()
        np.testing.assert_allclose(logits, np.asarray(jmodel.apply({"params": params},
                                                                   jnp.asarray(out[:, :-1]))),
                                   atol=1e-4, rtol=0)


def test_continuous_batching_example_own_weights(port_workspace):
    from examples_torch import continuous_batching as t_cb

    port_workspace()
    got = t_cb.main(device=CPU)
    assert got["parity"] == got["requests"] == 6
    assert got["dispatches"] < got["naive_dispatches"]
    assert got["spec_parity"] == got["paged_parity"] == 6
    assert got["spec_dispatches"] <= got["dispatches"]


def test_lm_generation_serving(port_workspace):
    """Export, serve through the Python predictor, ragged concurrent
    clients. On the JAX example's trained weights the port serves the
    same continuations at the same accuracy; trained by the port itself
    it meets the JAX example's thresholds."""
    import jax.numpy as jnp

    from examples import lm_serving as j_lm
    from examples_torch import lm_serving as t_lm

    want = j_lm.main()
    jmodel, jparams, jacc = j_lm._train()
    assert jacc == want["accuracy"]
    port_workspace()
    carried = t_lm.main(params=_numpy_tree(jparams), device=CPU)
    assert carried == want
    ev = t_lm.eval_tokens()
    with torch.no_grad():
        logits = t_lm.build(_numpy_tree(jparams), device=CPU)(torch.as_tensor(ev[:, :-1]))
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ev[:, :-1]))),
        atol=1e-4, rtol=0)
    own = t_lm.main(device=CPU)
    cyc = t_lm.CYCLE
    assert cyc == j_lm.CYCLE
    for r in (want, own):
        assert r["accuracy"] > 0.9
        assert r["continuation"][:8] == [cyc[(4 + i) % len(cyc)] for i in range(8)]
        assert r["ragged"]["short"][:4] == [cyc[(2 + i) % 8] for i in range(4)]
        assert r["ragged"]["long"][:4] == [cyc[(6 + i) % 8] for i in range(4)]


LONG_WORKER = '''
import pickle, sys
import numpy as np
from examples_torch import long_context_lm
from hops_tpu_torch.models.convert import load_npz
from hops_tpu_torch.parallel import multihost

out = long_context_lm.main(seq_len=256, steps=2, params=load_npz(sys.argv[1]))
with open(f"{sys.argv[2]}/rank{multihost.process_index()}.pkl", "wb") as f:
    pickle.dump(out, f)
'''


def _long_context_jax_params():
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from examples import long_context_lm as j_lc
    from hops_tpu.models import common
    from hops_tpu.models.transformer import TransformerLM as JLM
    from hops_tpu.parallel import mesh as mesh_lib

    # The example's own init: the same module and key as its main.
    mesh = mesh_lib.make_mesh({"data": 2, "seq": 4})
    model = JLM(vocab_size=256, d_model=128, num_heads=8, num_layers=2, dtype=jnp.float32,
                attention_impl="ring", mesh=mesh, remat=True)
    state = common.create_train_state(model, jax.random.PRNGKey(0), (2, 256),
                                      input_dtype=jnp.int32)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(state.params).items()}
    return flat, j_lc.main(seq_len=256, steps=2)


@pytest.fixture(scope="module")
def long_context(tmp_path_factory):
    """JAX's run on the fake mesh (data 2 x seq 4) and the port's on 4
    gloo ranks (data 2 x seq 2) from the same weights, once per session."""
    def make():
        flat, want = _long_context_jax_params()
        d = tmp_path_factory.mktemp("long_context")
        np.savez(d / "params.npz", **flat)
        return want, run_ranks(d, 4, LONG_WORKER, str(d / "params.npz"), str(d))

    return shared_once(tmp_path_factory, "long_context_lm", make)


def test_long_context_lm_ring_on_4_ranks_matches_jax(long_context):
    want, ranks = long_context
    assert want["mesh"] == {"data": 2, "seq": 4}
    for r in ranks:
        assert r["mesh"] == {"data": 2, "seq": 2}
        assert np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-4)


def test_long_context_lm_on_one_device(port_workspace):
    """One rank (seq 1): the flash path, a finite loss."""
    from examples_torch import long_context_lm as t_lc

    port_workspace()
    got = t_lc.main(seq_len=256, steps=2, device=CPU)
    assert np.isfinite(got["loss"]) and got["mesh"] == {"data": 1, "seq": 1}


DECODE_SMALL = ["--layers", "2", "--d-model", "64", "--tokens", "16", "--max-decode-len",
                "512", "--device", CPU]


@pytest.mark.parametrize("mode", [[], ["--kv-dtype", "int8"], ["--continuous", "--horizon", "8"],
                                  ["--valid-sweep"]], ids=["bf16", "int8", "continuous",
                                                           "valid-sweep"])
def test_decode_bench_modes_run_to_their_end(mode, port_workspace):
    from examples_torch import decode_bench
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.generation import generate
    from hops_tpu_torch.models.transformer import TransformerLM

    port_workspace()
    out = decode_bench.main(DECODE_SMALL + mode)
    if mode[:1] == ["--valid-sweep"]:
        assert [r["valid_len"] for r in out["rows"]] == [32, 64, 128, 256, 512]
        assert out["head_dim"] == 8 and out["control"]["valid_len"] == 128
        return
    if mode[:1] != ["--continuous"]:
        assert out["ms_per_token_step"] > 0 and out["roofline"] is None
        return
    # The engine's greedy streams are plain generate()'s on the same prompts.
    assert len(out["streams"]) == 24
    cfg = dict(vocab_size=decode_bench.VOCAB, d_model=64, num_heads=8, num_layers=2,
               dtype="bfloat16", max_decode_len=512)
    plain = TransformerLM(**cfg, device=CPU).load_flax(random_params(**cfg, seed=1))
    for (prompt, budget), stream in zip(out["requests"], out["streams"]):
        ref = generate(plain, [prompt], max_new_tokens=budget, temperature=0.0, device=CPU)
        assert stream == ref[0, len(prompt):].tolist()
