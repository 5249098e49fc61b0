"""The port's LM training path against the JAX package, fp32 on the CPU.

The same weights (``model.init`` in JAX, carried over by
``params_from_flax``) and the same seeded tokens go through the flax
module and the port's ``TransformerLM``: the loss and every parameter
gradient against ``jax.value_and_grad`` (dense and chunked loss), three
``make_lm_train_step`` steps under Adam against JAX's step under
``optax.adam``, and the weights carried back by ``params_to_flax``.
Dropout and remat are held inside the port (JAX's dropout bits cannot be
reproduced): deterministic per seed, off in eval, and remat giving the
same gradients as no remat.

Tolerances: ``rtol 1e-4, atol 1e-5`` for losses, gradients and weights
(fp32 through two layers, other summation orders); logits ``atol 1e-4``
as in ``tests/test_torch_transformer.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import unflatten_dict

from hops_tpu.models import common as jax_common
from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.models.transformer import make_lm_train_step as jax_train_step
from hops_tpu.ops.xent import chunked_softmax_xent as jax_xent
from hops_tpu_torch.models.common import accuracy, create_train_state, cross_entropy_loss
from hops_tpu_torch.models.convert import flatten, load_npz, params_to_flax, random_params
from hops_tpu_torch.models.transformer import TransformerLM, dropout, make_lm_train_step
from hops_tpu_torch.modelrepo.serving import save_lm_artifact
from hops_tpu_torch.ops.xent import chunked_softmax_xent

CFG = dict(vocab_size=64, d_model=64, num_heads=4, num_layers=2, max_decode_len=64)
TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK = 8  # 2 x 12 tokens: three chunks


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def pair(request):
    kv = request.param
    jm = JaxLM(**CFG, dtype=jnp.float32, num_kv_heads=kv)
    state = jax_common.create_train_state(
        jm, jax.random.PRNGKey(0), (1, 8), input_dtype=jnp.int32
    )
    return jm, jax.device_get(state.params), kv


def _port(params, kv, **kw):
    return TransformerLM(**CFG, dtype="float32", num_kv_heads=kv, device="cpu", **kw).load_flax(
        params)


def _tokens(b=2, s=13, seed=0):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (b, s)).astype(np.int32)


def _port_loss(model, tokens, loss_chunk, **kw):
    toks = torch.from_numpy(tokens).long()
    inputs, targets = toks[:, :-1], toks[:, 1:]
    out = model(inputs, train=True, return_hidden=bool(loss_chunk), **kw)
    if loss_chunk:
        return chunked_softmax_xent(out, model.unembed.kernel, targets, chunk=loss_chunk)
    return cross_entropy_loss(out, targets)


def _grads(model):
    return {n.replace(".", "/"): p.grad.numpy().copy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("loss_chunk", [None, CHUNK], ids=["dense", "chunked"])
def test_loss_and_every_gradient_match_jax(pair, loss_chunk):
    jm, params, kv = pair
    tokens = _tokens()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def loss_fn(p):
        out = jm.apply({"params": p}, inputs, train=True, return_hidden=bool(loss_chunk))
        if loss_chunk:
            return jax_xent(out, p["unembed"]["kernel"], targets, chunk=loss_chunk)
        return optax.softmax_cross_entropy_with_integer_labels(out, targets).mean()

    want, jgrads = jax.value_and_grad(loss_fn)(params)
    model = _port(params, kv)
    loss = _port_loss(model, tokens, loss_chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    got, jflat = _grads(model), flatten(jax.device_get(jgrads))
    assert set(got) == set(jflat)
    for name, g in got.items():
        np.testing.assert_allclose(g, jflat[name], err_msg=name, **TOL)


@pytest.mark.parametrize("loss_chunk", [None, CHUNK], ids=["dense", "chunked"])
def test_three_adam_steps_track_jax(pair, loss_chunk):
    jm, params, kv = pair
    jstate = jax_common.TrainState.create(
        apply_fn=jm.apply, params=params, tx=optax.adam(1e-3), rng=jax.random.PRNGKey(1)
    )
    jstep = jax.jit(jax_train_step(loss_chunk=loss_chunk))
    state = create_train_state(_port(params, kv), seed=1, learning_rate=1e-3)
    step = make_lm_train_step(loss_chunk=loss_chunk)
    for i in range(3):
        batch = _tokens(seed=10 + i)
        jstate, jm_metrics = jstep(jstate, {"tokens": jnp.asarray(batch)})
        state, metrics = step(state, {"tokens": batch})
        np.testing.assert_allclose(metrics["loss"].item(), float(jm_metrics["loss"]), **TOL)
        np.testing.assert_allclose(metrics["perplexity"].item(),
                                   float(jm_metrics["perplexity"]), **TOL)
    assert state.step == 3
    want = flatten(jax.device_get(jstate.params))
    for name, arr in params_to_flax(state.model).items():
        np.testing.assert_allclose(arr, want[name], err_msg=name, **TOL)


def test_params_to_flax_loads_into_jax_and_an_artifact(pair, tmp_path):
    """Weights trained by the port go back to the JAX module (same
    logits) and into an artifact the port reloads bit for bit."""
    jm, params, kv = pair
    state = create_train_state(_port(params, kv), seed=0)
    state, _ = make_lm_train_step()(state, {"tokens": _tokens(seed=3)})
    flat = params_to_flax(state.model)
    assert all(a.dtype == np.float32 for a in flat.values())
    toks = _tokens(1, 10, seed=4)
    want = np.asarray(jm.apply({"params": unflatten_dict(flat, sep="/")}, toks))
    with torch.inference_mode():
        got = state.model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    save_lm_artifact(tmp_path / "lm", dict(CFG, num_kv_heads=kv), flat)
    again = _port(load_npz(tmp_path / "lm" / "params.npz"), kv)
    with torch.inference_mode():
        torch.testing.assert_close(again(torch.from_numpy(toks).long()), got, rtol=0, atol=0)


def test_dropout_is_deterministic_per_seed_and_off_in_eval():
    params = random_params(**CFG, seed=4)
    model = _port(params, None, dropout_rate=0.3)
    plain = _port(params, None)
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        a = model(toks, train=True, generator=torch.Generator().manual_seed(5))
        b = model(toks, train=True, generator=torch.Generator().manual_seed(5))
        c = model(toks, train=True, generator=torch.Generator().manual_seed(6))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (a - c).abs().max() > 1e-3
        torch.testing.assert_close(model(toks), plain(toks), rtol=0, atol=0)
        torch.testing.assert_close(model(toks, train=False), plain(toks), rtol=0, atol=0)
        assert (a - plain(toks)).abs().max() > 1e-3
    with pytest.raises(ValueError, match="generator"):
        model(toks, train=True)


def test_dropout_keeps_the_expected_share():
    x = torch.ones(200_000)
    y = dropout(x, 0.25, seed=7)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    torch.testing.assert_close(dropout(x, 0.25, seed=7), y, rtol=0, atol=0)


@pytest.mark.parametrize("loss_chunk", [None, CHUNK], ids=["dense", "chunked"])
def test_remat_with_dropout_gives_the_same_gradients(pair, loss_chunk):
    """Each block recomputed in backward draws the same dropout masks,
    so remat changes nothing: same loss, same gradients."""
    _, params, kv = pair
    tokens = _tokens(seed=8)
    results = []
    for remat in (False, True):
        model = _port(params, kv, dropout_rate=0.2, remat=remat)
        loss = _port_loss(model, tokens, loss_chunk, generator=torch.Generator().manual_seed(9))
        loss.backward()
        results.append((loss.item(), _grads(model)))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], rtol=0, atol=1e-7, err_msg=name)


def test_train_steps_lower_the_loss_with_dropout_and_remat():
    cfg = dict(CFG, dropout_rate=0.1, remat=True)
    model = TransformerLM(**cfg, dtype="float32", device="cpu").load_flax(
        random_params(**cfg, seed=2))
    state = create_train_state(model, seed=3, learning_rate=3e-3)
    step = make_lm_train_step(loss_chunk=CHUNK)
    batch = {"tokens": _tokens(seed=11)}
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_create_train_state_refuses_low_precision_weights():
    model = TransformerLM(**CFG, dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="fp32 master"):
        create_train_state(model)
    mixed = TransformerLM(**CFG, dtype="bfloat16", param_dtype="float32", device="cpu")
    assert mixed.unembed.kernel.dtype == torch.float32
    assert create_train_state(mixed).optimizer.defaults["eps"] == 1e-8


def test_mixed_precision_casts_where_flax_does(pair):
    """bf16 compute over fp32 weights matches the flax module with
    ``dtype=bfloat16`` (fp32 params) on the same tokens, up to bf16
    rounding, and the gradients land on the fp32 weights."""
    jm, params, kv = pair
    jb = jm.clone(dtype=jnp.bfloat16)
    toks = _tokens(2, 9, seed=12)
    want = np.asarray(jb.apply({"params": params}, toks))
    model = _port(params, kv, param_dtype="float32").clone(dtype="bfloat16")
    assert model.block_0.mlp.up.kernel.dtype == torch.float32
    out = model(torch.from_numpy(toks).long())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, atol=5e-2, rtol=0)
    out.sum().backward()
    assert model.embed.embedding.grad.dtype == torch.float32


def test_cross_entropy_and_accuracy_match_optax():
    rs = np.random.RandomState(13)
    logits, labels = rs.randn(3, 5, 11).astype(np.float32), rs.randint(0, 11, (3, 5))
    want = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        accuracy(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(jax_common.accuracy(logits, labels)), rtol=0)
