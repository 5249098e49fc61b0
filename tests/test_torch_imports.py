"""The PyTorch port stands alone: no JAX, no JAX package, and no silent
CPU fallback for an entry point that was not asked for the CPU."""

from __future__ import annotations

import ast
import json
import pkgutil
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
    sorted(p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_imports_jax_or_the_jax_package(path):
    # safetensors: checkpoints are torch.save files, needing nothing the
    # card's machine lacks.
    assert not _imported_roots(REPO / path) & (set(BLOCKED) | {"safetensors"})


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


def _entry_predictor(tmp_path):
    from hops_tpu_torch.models.convert import random_params
    from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact

    _, cfg = _tiny_model()
    save_lm_artifact(tmp_path / "lm", cfg, random_params(**cfg))
    LMEnginePredictor(tmp_path / "lm", {"slots": 2})


def _entry_classifier(name):
    from hops_tpu_torch.models import mnist, resnet

    {"cnn": mnist.CNN, "ffn": mnist.FFN, "resnet": resnet.ResNet18ish}[name]()


def _entry_synthetic_data():
    from hops_tpu_torch.models.common import SyntheticClassData

    next(SyntheticClassData().batches(2, 1))


@pytest.mark.parametrize("entry", ["transformer", "generate", "engine", "predictor",
                                   "cnn", "ffn", "resnet", "synthetic_data"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry, tmp_path):
    _no_card()
    call = {
        "transformer": _entry_transformer,
        "generate": _entry_generate,
        "engine": _entry_engine,
        "predictor": lambda: _entry_predictor(tmp_path),
        "cnn": lambda: _entry_classifier("cnn"),
        "ffn": lambda: _entry_classifier("ffn"),
        "resnet": lambda: _entry_classifier("resnet"),
        "synthetic_data": _entry_synthetic_data,
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_default_device_is_cuda0():
    from hops_tpu_torch.runtime.devices import default_device, resolve_device

    assert default_device() == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
