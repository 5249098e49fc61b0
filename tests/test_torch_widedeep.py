"""The port's wide-and-deep model (``hops_tpu_torch.models.widedeep``)
against ``hops_tpu.models.widedeep``, on the CPU.

The JAX module's variables (``model.init``) load into the port by name
(``wide_i``, ``embed_i``, ``deep_j``, ``deep_out``); the same numpy
batch goes through both. Tolerances: logits ``atol 1e-5`` in fp32 (the
wide one-hot products are a row gather in the port), and in bf16 within
the bf16 rounding of the logits (``2^-7`` of their magnitude); 3 Adam
steps against optax ``rtol 1e-4, atol 1e-5`` (fp32, other summation
orders); ``batch_from_vectors`` exact; the reference's "learns" case
on the port's own taxi batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hops_tpu.models import common as jax_common
from hops_tpu.models import widedeep as jax_wd
from hops_tpu_torch.models.common import cross_entropy_loss
from hops_tpu_torch.models.convert import flatten, params_from_flax, params_to_flax
from hops_tpu_torch.models.widedeep import (
    WideAndDeep,
    batch_from_vectors,
    make_taxi_batch,
)

VOCAB = [24, 7, 100]  # examples/taxi_pipeline.py's vocabularies


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _batch(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, 5)).astype(np.float32)
    cats = np.stack([rng.integers(0, v, n) for v in VOCAB], axis=1).astype(np.int32)
    label = ((dense[:, 0] + (cats[:, 0] % 2) * 0.5) > 0.25).astype(np.int32)
    return {"dense": dense, "categorical": cats, "label": label}


def _pair(dtype: str):
    jm = jax_wd.WideAndDeep(vocab_sizes=VOCAB, dtype=getattr(jnp, dtype))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), _batch(2)))
    port = WideAndDeep(VOCAB, dtype=dtype, device="cpu")
    port.load_state_dict(params_from_flax(variables))
    return jm, variables, port


def test_names_and_shapes_are_flax():
    _, variables, port = _pair("float32")
    want = {k: v.shape for k, v in flatten(variables).items()}
    assert {k: v.shape for k, v in params_to_flax(port).items()} == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    jm, variables, port = _pair(dtype)
    b = _batch(64, seed=1)
    want = np.asarray(jm.apply(variables, b))
    with torch.no_grad():
        got = port(b).numpy()
    assert got.dtype == np.float32 and got.shape == (64, 2)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max(), rtol=0)


def test_batch_from_vectors_is_exact():
    vectors = [[0.5, -1.0, 2.0, 3, 4, 99], [1.5, 0.0, -2.0, 1, 6, 0]]
    want = jax_wd.batch_from_vectors(vectors, num_dense=3)
    got = batch_from_vectors(vectors, num_dense=3)
    for k in ("dense", "categorical"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="feature vectors"):
        batch_from_vectors([[1.0, 2.0]], num_dense=2)


def test_three_adam_steps_track_optax():
    jm, variables, port = _pair("float32")
    tx = optax.adam(1e-2)
    params = variables["params"]
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state, b):
        def loss_fn(p):
            return jax_common.cross_entropy_loss(jm.apply({"params": p}, b), b["label"])

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    opt = torch.optim.Adam(port.parameters(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for i in range(3):
        b = _batch(32, seed=10 + i)
        params, opt_state, jloss = jstep(params, opt_state, b)
        loss = cross_entropy_loss(port(b), torch.from_numpy(b["label"]))
        opt.zero_grad()
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-5)
    want = flatten(jax.device_get(params))
    for name, arr in params_to_flax(port).items():
        np.testing.assert_allclose(arr, want[name], rtol=1e-4, atol=1e-5, err_msg=name)


def test_taxi_batch_follows_the_label_rule():
    b = make_taxi_batch(torch.Generator().manual_seed(3), 256, VOCAB, device="cpu")
    assert b["dense"].shape == (256, 5) and b["categorical"].shape == (256, 3)
    assert b["categorical"].dtype == torch.int32 and b["label"].dtype == torch.int32
    for i, v in enumerate(VOCAB):
        assert 0 <= int(b["categorical"][:, i].min()) and int(b["categorical"][:, i].max()) < v
    rule = ((b["dense"][:, 0] + (b["categorical"][:, 0] % 2) * 0.5) > 0.25).int()
    assert torch.equal(b["label"], rule)
    again = make_taxi_batch(torch.Generator().manual_seed(3), 256, VOCAB, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_wide_and_deep_learns():
    """The reference's case (tests/test_models.py): 60 Adam steps at lr
    1e-2 on fresh taxi batches of 256 fit the label rule (accuracy on the
    last batch > 0.85)."""
    model = WideAndDeep(VOCAB, dtype="float32", device="cpu")
    logits = model(make_taxi_batch(torch.Generator().manual_seed(0), 256, VOCAB, device="cpu"))
    assert logits.shape == (256, 2)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    g = torch.Generator().manual_seed(1)
    for _ in range(60):
        b = make_taxi_batch(g, 256, VOCAB, device="cpu")
        loss = cross_entropy_loss(model(b), b["label"])
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():
        acc = float((model(b).argmax(-1) == b["label"]).float().mean())
    assert acc > 0.85
