"""The port's model registry (``hops_tpu_torch.modelrepo.registry``)
against the JAX package's on the same artifacts and metrics: versions,
lookups and best-model selection answer alike; a language model
round-trips through the port's artifact format; and the predictor
resolves its draft model by registry name.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.models.generation import generate as jax_generate
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.modelrepo import registry as jax_registry
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.modelrepo import registry
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, load_lm_artifact
from hops_tpu_torch.runtime import config

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
# Skipped by get_best_model: "note" is not numeric, "acc" missing from v4.
METRICS = [{"acc": 0.7, "loss": 1.0}, {"acc": 0.9, "loss": 0.4, "note": "x"},
           {"acc": 0.8, "loss": 0.2}, {"loss": 0.3}]


@pytest.fixture()
def workspace(tmp_path, monkeypatch):
    """The port's registry in its own workspace (tests/conftest.py points
    the JAX package's at another)."""
    monkeypatch.setattr(config, "_current", config.runtime())
    config.configure(workspace=str(tmp_path / "torch_ws"), project="testproj")
    return tmp_path


def _export_both(tmp_path, name, metrics_list):
    art = tmp_path / "model.txt"
    art.write_text("v")
    return [(jax_registry.export(art, name, metrics=m), registry.export(art, name, metrics=m))
            for m in metrics_list]


def _strip(meta):
    return {k: v for k, v in meta.items() if k not in ("created", "path")}


def test_export_versioning_matches_jax(workspace):
    pairs = _export_both(workspace, "m", METRICS)
    for want, got in pairs:
        assert _strip(got) == _strip(want)
    assert _strip(registry.get_model("m")) == _strip(jax_registry.get_model("m"))
    assert registry.get_model("m", 2)["version"] == jax_registry.get_model("m", 2)["version"] == 2
    assert [_strip(m) for m in registry.list_models()] == [
        _strip(m) for m in jax_registry.list_models()]
    assert (workspace / "torch_ws" / "testproj" / "Models" / "m" / "4" / "model.txt").is_file()


@pytest.mark.parametrize("metric,direction", [
    ("acc", "max"), ("acc", "min"), ("loss", "max"), ("loss", "min"),
])
def test_get_best_model_matches_jax(workspace, metric, direction):
    _export_both(workspace, "best", METRICS)
    got = registry.get_best_model("best", metric, direction)
    assert _strip(got) == _strip(jax_registry.get_best_model("best", metric, direction))


def test_missing_models_and_metrics_raise_like_jax(workspace):
    _export_both(workspace, "m", METRICS[:1])
    for reg in (registry, jax_registry):
        with pytest.raises(KeyError):
            reg.get_model("ghost")
        with pytest.raises(KeyError):
            reg.get_model("m", 7)
        with pytest.raises(KeyError):
            reg.get_best_model("m", "note")
    with pytest.raises(FileNotFoundError):
        registry.export(workspace / "absent", "m")


@pytest.fixture(scope="module")
def lms():
    """A JAX target and a one-layer JAX draft with their parameters."""
    target = JaxLM(**CFG, dtype=jnp.float32)
    draft = JaxLM(**dict(CFG, num_layers=1), dtype=jnp.float32)
    init = jnp.zeros((1, 8), jnp.int32)
    return (target, jax.device_get(target.init(jax.random.PRNGKey(0), init)),
            jax.device_get(draft.init(jax.random.PRNGKey(3), init)))


def test_lm_round_trip(workspace, lms):
    _, params, _ = lms
    meta = registry.save_lm(dict(CFG, dtype="float32"), params, "lm", metrics={"ppl": 3})
    assert meta["version"] == 1 and meta["metrics"] == {"ppl": 3.0}
    path = registry.lm_artifact("lm")
    model = load_lm_artifact(path, torch.device("cpu"))
    want = TransformerLM(**CFG, dtype="float32", device="cpu").load_flax(params)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 9)))
    torch.testing.assert_close(model(tokens), want(tokens), atol=0, rtol=0)
    (workspace / "model.txt").write_text("v")
    registry.export(workspace / "model.txt", "plain")
    with pytest.raises(ValueError, match="not a language-model artifact"):
        registry.lm_artifact("plain")


def test_predictor_loads_its_draft_by_name(workspace, lms):
    target, params, draft_params = lms
    registry.save_lm(dict(CFG, dtype="float32"), params, "target")
    registry.save_lm(dict(CFG, num_layers=1, dtype="float32"), draft_params, "draft")
    registry.save_lm(dict(CFG, dtype="float32"), params, "draft")  # v2: the target itself
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 64, (n,)).astype(np.int32) for n in (5, 9, 3)]
    want = [np.asarray(jax_generate(target, params["params"], p[None], jax.random.PRNGKey(0),
                                    max_new_tokens=7, temperature=0.0))[0, p.size:].tolist()
            for p in prompts]
    for version, acceptance in ((1, None), (2, 1.0)):
        predictor = LMEnginePredictor(
            registry.lm_artifact("target"),
            {"slots": 2, "draft_model": "draft", "draft_version": version, "spec_k": 3},
            device="cpu")
        try:
            got = predictor.predict([{"prompt": p.tolist(), "max_new_tokens": 7} for p in prompts])
            stats = predictor.stats()
        finally:
            predictor.stop()
        assert got == want
        assert predictor.engine.draft_model.num_layers == (1 if version == 1 else 2)
        assert stats["spec_k"] == 3
        if acceptance is not None:
            assert stats["spec_acceptance"] == acceptance
    with pytest.raises(KeyError):
        LMEnginePredictor(registry.lm_artifact("target"), {"draft_model": "ghost"}, device="cpu")
