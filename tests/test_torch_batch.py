"""The port's batch inference (``hops_tpu_torch.modelrepo.batch``) against
the JAX package's ``hops_tpu.modelrepo.batch``, on the CPU.

The JAX package's FFN and CNN weights (``model.init``) are converted into
the port's modules; the JAX package predicts over the fake 8-device mesh,
the port over one CPU rank, so their chunks and ragged tails differ and
the predictions must agree anyway: ``atol 1e-5`` fp32, a ragged tail and
an empty input included, from a module and from each package's registry.
The port's fill-ratio and row metrics and its assembly pool are held to
the JAX package's cases; ``lm_generate_with_model``'s greedy tokens
(ragged budgets, fewer slots than prompts) must equal the JAX
function's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hops_tpu.modelrepo import batch as jax_batch
from hops_tpu.modelrepo import registry as jax_registry
from hops_tpu.models.mnist import CNN as JaxCNN
from hops_tpu.models.mnist import FFN as JaxFFN
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu_torch.modelrepo import batch, registry
from hops_tpu_torch.models.convert import params_from_flax
from hops_tpu_torch.models.mnist import CNN, FFN
from hops_tpu_torch.parallel import Strategy
from hops_tpu_torch.runtime import config
from hops_tpu_torch.telemetry.metrics import REGISTRY

ATOL = 1e-5
CPU = Strategy(device="cpu")


@pytest.fixture(autouse=True)
def torch_workspace(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(config, "_current", config.runtime())
    config.configure(workspace=str(tmp_path / "torch_ws"), project="testproj")


def _pair(kind: str):
    """A JAX classifier, its variables, and the port's module with them."""
    jm = {"ffn": JaxFFN, "cnn": JaxCNN}[kind](dtype=jnp.float32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1))))
    port = {"ffn": FFN, "cnn": CNN}[kind](dtype="float32", device="cpu")
    port.load_state_dict(params_from_flax(variables))
    return jm, variables, port.eval()


def _images(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 28, 28, 1)).astype(np.float32)


@pytest.mark.parametrize("kind", ["ffn", "cnn"])
@pytest.mark.parametrize("n", [37, 0], ids=["ragged", "empty"])
def test_batch_predict_matches_jax(kind, n):
    jm, variables, port = _pair(kind)
    inputs = _images(n)
    want = jax_batch.batch_predict(lambda x: jm.apply(variables, x), inputs, per_chip_batch=2)
    got = batch.batch_predict(port, inputs, per_chip_batch=4, strategy=CPU)
    assert got.shape == want.shape == (n, 10) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_predict_with_model_matches_jax():
    jm, variables, _ = _pair("ffn")
    jax_registry.save_flax(jm, variables["params"], "batch-model")
    fields = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}
    registry.save_classifier("FFN", fields, variables, "batch-model")
    inputs = _images(13, seed=1)
    want = jax_batch.predict_with_model("batch-model", inputs)
    got = batch.predict_with_model("batch-model", inputs, per_chip_batch=4, strategy=CPU)
    assert got.shape == (13, 10)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fill_ratio_and_rows():
    rows = REGISTRY.counter("hops_tpu_batch_rows_total", "Batch-inference rows predicted")
    fill = REGISTRY.histogram("hops_tpu_batch_fill_ratio", "").labels()
    rows_before, fills_before = rows.value(), fill.count
    out = batch.batch_predict(lambda x: x * 2, np.ones((5, 2), np.float32), per_chip_batch=2,
                              strategy=CPU)
    np.testing.assert_array_equal(out, np.full((5, 2), 2.0, np.float32))
    assert rows.value() - rows_before == 5
    # Chunks of 2 rows: two full, then the tail at 1/2.
    assert fill.count - fills_before == 3


def test_stream_yields_each_batch():
    blocks = [np.full((4, 3), i, np.float32) for i in range(3)]
    outs = list(batch.batch_predict_stream(lambda x: x + 1, iter(blocks), strategy=CPU))
    assert [o.tolist() for o in outs] == [(b + 1).tolist() for b in blocks]


def test_assembly_pool_reuses_buffers():
    pool = batch.AssemblyPool(depth=2)
    a = pool.take((4, 3), np.float32)
    pool.give(a)
    b = pool.take((4, 3), np.float32)
    assert b is a  # second checkout of the spec reuses the buffer
    assert pool.take((4, 3), np.float32) is not a  # pool drained: fresh
    assert pool.take((8, 3), np.float32).shape == (8, 3)  # new spec
    assert pool.hit_rate() == pytest.approx(1 / 4)


def test_assembly_pool_depth_cap():
    pool = batch.AssemblyPool(depth=1)
    a = pool.take((2,), np.float32)
    b = pool.take((2,), np.float32)
    pool.give(a)
    pool.give(b)  # over depth: dropped, not hoarded
    assert pool.take((2,), np.float32) is a
    assert pool.take((2,), np.float32) is not b


def test_batch_predict_tail_pad_rides_the_pool():
    _, _, port = _pair("ffn")
    hits = REGISTRY.counter("hops_tpu_batch_assembly_reuse_total", labels=("site", "result"))
    hits0 = hits.value(site="batch", result="hit")
    inputs = _images(9, seed=2)
    p1 = batch.batch_predict(port, inputs, per_chip_batch=4, strategy=CPU)
    p2 = batch.batch_predict(port, inputs, per_chip_batch=4, strategy=CPU)
    np.testing.assert_array_equal(p1, p2)
    assert hits.value(site="batch", result="hit") >= hits0 + 1


def test_lm_generate_with_model_matches_jax():
    """Greedy tokens from each registry through each package's offline
    drain, ragged per-prompt budgets, 2 slots for 3 prompts."""
    tiny = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_decode_len=64)
    jm = JaxLM(**tiny, dtype=jnp.float32, attention_impl="reference")
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    jax_registry.save_flax(jm, params, "batch-lm")
    registry.save_lm(dict(tiny, dtype="float32"), params, "batch-lm")
    rs = np.random.RandomState(91)
    prompts = [rs.randint(1, 64, (n,)) for n in (3, 7, 5)]
    budgets = [6, 3, 8]
    want = jax_batch.lm_generate_with_model("batch-lm", prompts, max_new_tokens=budgets, slots=2)
    got = batch.lm_generate_with_model("batch-lm", [p.tolist() for p in prompts],
                                       max_new_tokens=budgets, slots=2, device="cpu")
    assert [len(g) for g in got] == budgets
    assert got == [[int(t) for t in w] for w in want]
    with pytest.raises(ValueError, match="budgets"):
        batch.lm_generate_with_model("batch-lm", prompts, max_new_tokens=[1, 2], device="cpu")
