"""The PyTorch port stands alone: no JAX, no JAX package, and no silent
CPU fallback for an entry point that was not asked for the CPU."""

from __future__ import annotations

import ast
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hops_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "hops_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "hops_tpu")


def _modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(hops_tpu_torch.__path__, "hops_tpu_torch.")
    )


def test_every_module_imports_with_jax_blocked():
    """Each module imports in a fresh interpreter in which the JAX stack
    and the JAX package cannot be imported at all."""
    mods = _modules()
    assert "hops_tpu_torch.ops.attention" in mods
    assert "hops_tpu_torch.modelrepo.serving" in mods
    assert {"hops_tpu_torch.ops.xent", "hops_tpu_torch.models.common"} <= set(mods)
    assert "hops_tpu_torch.modelrepo.paged" in mods
    assert {"hops_tpu_torch.runtime.qos", "hops_tpu_torch.modelrepo.registry",
            "hops_tpu_torch.modelrepo.lm_engine", "hops_tpu_torch.models.generation"} <= set(mods)
    assert {
        "hops_tpu_torch.experiment.core", "hops_tpu_torch.experiment.registry",
        "hops_tpu_torch.experiment.tensorboard", "hops_tpu_torch.runtime.checkpoint",
        "hops_tpu_torch.runtime.preemption", "hops_tpu_torch.runtime.config",
        "hops_tpu_torch.runtime.fs", "hops_tpu_torch.runtime.rundir",
        "hops_tpu_torch.runtime.logging", "hops_tpu_torch.runtime.flight",
        "hops_tpu_torch.runtime.faultinject", "hops_tpu_torch.runtime.resilience",
        "hops_tpu_torch.telemetry.metrics", "hops_tpu_torch.telemetry.tracing",
        "hops_tpu_torch.telemetry.spans", "hops_tpu_torch.messaging.searchindex",
        "hops_tpu_torch.parallel.multihost", "hops_tpu_torch.models.mnist",
        "hops_tpu_torch.models.resnet", "hops_tpu_torch.models.layers",
    } <= set(mods)
    assert {
        "hops_tpu_torch.jobs", "hops_tpu_torch.jobs.api", "hops_tpu_torch.telemetry.workload",
        "hops_tpu_torch.telemetry.workload.capture", "hops_tpu_torch.telemetry.workload.replay",
        "hops_tpu_torch.telemetry.workload.synthesize", "hops_tpu_torch.telemetry.export",
        "hops_tpu_torch.runtime.wirecodec", "hops_tpu_torch.runtime.httpserver",
        "hops_tpu_torch.runtime.httpclient", "hops_tpu_torch.messaging.pubsub",
        "hops_tpu_torch.modelrepo.serving_host",
    } <= set(mods)
    assert {
        f"hops_tpu_torch.featurestore.{m}" for m in (
            "storage", "feature", "statistics", "query", "validation", "online",
            "columnar", "feature_group", "training_dataset", "builders", "connectors",
            "bias", "connection", "online_serving")
    } | {"hops_tpu_torch.sql", "hops_tpu_torch.sql.gateway"} <= set(mods)
    assert {
        f"hops_tpu_torch.{m}" for m in (
            "modelrepo.fleet", "modelrepo.fleet.autoscale", "modelrepo.fleet.replicas",
            "modelrepo.fleet.router", "modelrepo.fleet.rollout", "pipeline",
            "pipeline.continuous", "jobs.placement", "jobs.placement.registry",
            "jobs.placement.lease", "jobs.placement.invariants", "jobs.placement.client",
            "jobs.placement.shardd", "jobs.placement.hostd")
    } <= set(mods)
    assert {
        f"hops_tpu_torch.{m}" for m in (
            "jobs.api", "jobs.dag", "jobs.dataset", "jobs.streaming", "messaging.tls",
            "runtime.relaylock", "plotting", "compat")
    } | {
        f"hops_tpu_torch.compat.{m}" for m in (
            "beam", "dataset", "devices", "elasticsearch", "experiment", "hdfs", "hive",
            "jobs", "kafka", "maggy", "model", "numpy_helper", "pandas_helper", "project",
            "serving", "tensorboard", "tls", "util")
    } <= set(mods)
    code = (
        "import sys, importlib, json\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"print(json.dumps(sorted(n for n in sys.modules if n.split('.')[0] in {BLOCKED!r} "
        "and sys.modules[n] is not None)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")) + ["chip_smoke.py"]
    + sorted(p.relative_to(REPO).as_posix() for p in (REPO / "examples_torch").glob("*.py"))
    + ["make_torch.py"],
)
def test_no_source_imports_jax_or_the_jax_package(path):
    # safetensors: checkpoints are torch.save files, needing nothing the
    # card's machine lacks. examples: the JAX package's example scripts
    # (the port's examples import examples_torch).
    assert not _imported_roots(REPO / path) & (set(BLOCKED) | {"safetensors", "examples"})


def test_every_example_has_its_port():
    """``examples_torch/`` holds one file for each of ``examples/``, and
    each names its counterpart in its docstring."""
    ours = sorted(p.name for p in (REPO / "examples_torch").glob("*.py"))
    assert ours == sorted(p.name for p in (REPO / "examples").glob("*.py"))
    for name in ours:
        doc = ast.get_docstring(ast.parse((REPO / "examples_torch" / name).read_text()))
        assert f"examples/{name}" in doc, name


def test_make_torch_builds_the_port_site(tmp_path):
    """The docs generator walks the port and its examples (ast only)."""
    sys.path.insert(0, str(REPO))
    try:
        import make_torch
    finally:
        sys.path.remove(str(REPO))
    pages = make_torch.build(tmp_path / "site")
    assert len(pages) > 40
    index = (tmp_path / "site/content/_index.md").read_text()
    assert "hops_tpu_torch.ops.attention" in index
    assert "examples_torch.decode_bench" in index
    attn = (tmp_path / "site/content/hops_tpu_torch.ops.attention.md").read_text()
    assert "flash_attention" in attn


def _jax_module_literals(tree: ast.AST) -> list[tuple[int, str]]:
    """String literals that name a module of the JAX package, and
    ``python -m`` arguments that name anything but the port's modules:
    what a child process would run. The import sweep above cannot see a
    module named in a string (a worker argv, ``importlib``)."""
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and re.fullmatch(r"hops_tpu(\.\w+)*", node.value):
            bad.append((node.lineno, node.value))
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for flag, arg in zip(elts, elts[1:]):
                if isinstance(flag, ast.Constant) and flag.value == "-m" \
                        and isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and arg.value.startswith("hops_tpu") \
                        and not arg.value.startswith("hops_tpu_torch."):
                    bad.append((arg.lineno, arg.value))
    return bad


def test_argv_guard_sees_a_jax_worker_module():
    """The guard below fails on the literal a copied worker argv keeps
    (``"-m", "hops_tpu.modelrepo.serving_host"``) and passes the port's."""
    jax_argv = '[sys.executable, "-m", "hops_tpu.modelrepo.serving_host", "--fleet-worker", d]'
    mod = 'mod = ("hops_tpu.modelrepo.serving_host" if k else "hops_tpu.jobs.placement.shardd")'
    port = '[sys.executable, "-m", "hops_tpu_torch.modelrepo.serving_host", "--fleet-worker", d]'
    assert [v for _, v in _jax_module_literals(ast.parse(jax_argv))] == \
        ["hops_tpu.modelrepo.serving_host", "hops_tpu.modelrepo.serving_host"]
    assert len(_jax_module_literals(ast.parse(mod))) == 2
    assert _jax_module_literals(ast.parse(port)) == []


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_names_a_jax_module_for_a_child_process(path):
    """No port file (nor ``chip_smoke.py``) names a JAX-package module
    in a string: a process spawned with it would run the JAX package
    (``modelrepo/fleet/replicas.py``'s and ``jobs/placement/hostd.py``'s
    worker argv are the cases this closes)."""
    src = REPO / path
    assert _jax_module_literals(ast.parse(src.read_text(), str(src))) == []


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")


def _tiny_model(**kw):
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.models.transformer import TransformerLM

    cfg = dict(vocab_size=32, d_model=32, num_heads=2, num_layers=1, dtype="float32",
               max_decode_len=32)
    return TransformerLM(**cfg, **kw, device="cpu").load_flax(random_params(**cfg)), cfg


def _entry_transformer():
    from hops_tpu_torch.models.transformer import TransformerLM

    TransformerLM(vocab_size=32, d_model=32, num_heads=2, num_layers=1)


def _entry_generate():
    from hops_tpu_torch.models.generation import generate

    model, _ = _tiny_model()
    generate(model, np.zeros((1, 4), np.int32), max_new_tokens=2, temperature=0.0)


def _entry_engine():
    from hops_tpu_torch.modelrepo.lm_engine import LMEngine

    model, _ = _tiny_model(ragged_decode=True)
    LMEngine(model, slots=2)


def _entry_speculative():
    from hops_tpu_torch.models.generation import generate_speculative

    model, _ = _tiny_model()
    generate_speculative(model, model, np.zeros((1, 4), np.int32), max_new_tokens=2)


def _entry_beam_search():
    from hops_tpu_torch.models.generation import beam_search

    model, _ = _tiny_model()
    beam_search(model, np.zeros((1, 4), np.int32), max_new_tokens=2)


def _entry_predictor(tmp_path):
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact

    _, cfg = _tiny_model()
    save_lm_artifact(tmp_path / "lm", cfg, random_params(**cfg))
    LMEnginePredictor(tmp_path / "lm", {"slots": 2})


def _entry_classifier(name):
    from hops_tpu_torch.models import mnist, resnet

    {"cnn": mnist.CNN, "ffn": mnist.FFN, "resnet": resnet.ResNet18ish}[name]()


def _entry_classifier_predictor(tmp_path):
    from hops_tpu_torch.models.convert import params_to_flax
    from hops_tpu_torch.models.mnist import FFN
    from hops_tpu_torch.modelrepo.serving import ClassifierPredictor, save_classifier_artifact

    model = FFN(in_features=4, device="cpu")
    save_classifier_artifact(tmp_path / "ffn", "FFN", {}, params_to_flax(model))
    ClassifierPredictor(tmp_path / "ffn")


def _entry_synthetic_data():
    from hops_tpu_torch.models.common import SyntheticClassData

    next(SyntheticClassData().batches(2, 1))


@pytest.mark.parametrize("entry", ["transformer", "generate", "engine", "predictor",
                                   "classifier_predictor", "cnn", "ffn", "resnet",
                                   "synthetic_data",
                                   "generate_speculative", "beam_search"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry, tmp_path):
    _no_card()
    call = {
        "transformer": _entry_transformer,
        "generate": _entry_generate,
        "engine": _entry_engine,
        "predictor": lambda: _entry_predictor(tmp_path),
        "classifier_predictor": lambda: _entry_classifier_predictor(tmp_path),
        "cnn": lambda: _entry_classifier("cnn"),
        "ffn": lambda: _entry_classifier("ffn"),
        "resnet": lambda: _entry_classifier("resnet"),
        "synthetic_data": _entry_synthetic_data,
        "generate_speculative": _entry_speculative,
        "beam_search": _entry_beam_search,
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_default_device_is_cuda0():
    from hops_tpu_torch.runtime.devices import default_device, resolve_device

    assert default_device() == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
