"""The port's sequence parallelism (``hops_tpu_torch.parallel.ringattention``)
against the JAX package's, fp32 on the CPU.

Four gloo processes (``python -m hops_tpu_torch.launch --platform cpu``,
one launch, results gathered in a module-scoped fixture) run the cases
of ``tests/test_ringattention.py`` on a ``seq`` mesh of 4 ranks: ring and
Ulysses against full attention, causal and not, with a sliding window,
GQA (un-repeated kv heads on the wire), the refusals, the gradients
(every rank ends with the full gradient of the global inputs), and the
GQA LM with ``attention_impl="ring"`` (plain and windowed) and
``"ulysses"`` on a data 2 x seq 2 mesh against ``"reference"``; and
``"ring_local"``, each rank feeding its own chunk of the sequence. Every
output is held to the JAX package's reference attention (its gradient,
its reference LM); four cases also to JAX's ``ring_attention`` /
``ulysses_attention`` over the fake mesh's first 4 devices.

Tolerances: outputs ``atol 3e-5`` (the reference's own), gradients
``5e-5``, LM logits ``2e-4``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hops_tpu.models.transformer import TransformerLM as JaxLM
from hops_tpu.ops.attention import attention_reference, repeat_kv
from hops_tpu.parallel import mesh as jax_mesh
from hops_tpu.parallel.ringattention import ring_attention, ulysses_attention
from hops_tpu_torch.models.convert import flatten

from test_torch_grad_comms import run_ranks, shared_once

N = 4
TOL = dict(atol=3e-5, rtol=3e-5)
LM = dict(vocab_size=32, d_model=32, num_heads=4, num_layers=2, num_kv_heads=2,
          max_decode_len=64)
MOE = dict(moe_every=2, num_experts=4, moe_top_k=2)


def _inputs(batch=1, heads=4, kv_heads=None, seq=256, d=32, seed=0):
    rng = np.random.default_rng(seed)
    kv = kv_heads or heads
    return (rng.standard_normal((batch, heads, seq, d)).astype(np.float32),
            rng.standard_normal((batch, kv, seq, d)).astype(np.float32),
            rng.standard_normal((batch, kv, seq, d)).astype(np.float32))


#: name -> (impl, input kwargs, call kwargs)
CASES = {
    "ring": ("ring", {}, dict(causal=False)),
    "ring-causal": ("ring", {}, dict(causal=True)),
    "ulysses": ("ulysses", {}, dict(causal=False)),
    "ulysses-causal": ("ulysses", {}, dict(causal=True)),
    "ulysses-plain": ("ulysses", {}, dict(causal=True, use_flash=False)),
    "ring-window": ("ring", dict(seed=5), dict(causal=True, window=96)),
    "ulysses-window": ("ulysses", dict(seed=5), dict(causal=True, window=96)),
    "ring-gqa": ("ring", dict(heads=8, kv_heads=2, seq=128, seed=3), dict(causal=False)),
    "ring-gqa-causal": ("ring", dict(heads=8, kv_heads=2, seq=128, seed=3), dict(causal=True)),
    "ring-gqa-window": ("ring", dict(heads=8, kv_heads=2, seq=256, seed=3),
                        dict(causal=True, window=64)),
    "ulysses-gqa4": ("ulysses", dict(heads=8, kv_heads=4, seq=128, seed=3), dict(causal=True)),
    "ulysses-gqa2": ("ulysses", dict(heads=8, kv_heads=2, seq=128, seed=3), dict(causal=True)),
}
#: Cases also run through JAX's ring_attention / ulysses_attention on the
#: fake mesh (each compiles a shard_map program; the rest are held to
#: JAX's reference attention, as the reference's own tests hold them).
ON_JAX_SP = ("ring-causal", "ring-gqa-window", "ulysses-causal", "ulysses-gqa2")
GRAD_CASES = {"ring-grads": ("ring", dict(seq=128), dict(causal=True)),
              "ulysses-grads": ("ulysses", dict(seq=128), dict(causal=True))}

WORKER = r'''
import json, pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
from hops_tpu_torch.models.convert import load_npz
from hops_tpu_torch.models.transformer import TransformerLM
from hops_tpu_torch.parallel import mesh as mesh_lib, multihost
from hops_tpu_torch.parallel.ringattention import ring_attention, ulysses_attention, axis_group

out, spec = sys.argv[1], json.loads(open(sys.argv[2]).read())
rank = multihost.process_index()
data = dict(np.load(spec["data"]))
seq = mesh_lib.make_mesh({"seq": 4})
dseq = mesh_lib.make_mesh({"data": 2, "seq": 2})
FN = {"ring": ring_attention, "ulysses": ulysses_attention}
res = {}
for name, (impl, kw) in spec["cases"].items():
    q, k, v = (torch.from_numpy(data[f"{name}/{t}"]) for t in "qkv")
    res[name] = FN[impl](q, k, v, seq, **kw).numpy()
for name, (impl, kw) in spec["grads"].items():
    q, k, v = (torch.from_numpy(data[f"{name}/{t}"]).requires_grad_() for t in "qkv")
    FN[impl](q, k, v, seq, **kw).sum().backward()
    res[name] = [t.grad.numpy() for t in (q, k, v)]
for name, (impl, kw) in spec["rejects"].items():
    q, k, v = (torch.from_numpy(data[f"{name}/{t}"]) for t in "qkv")
    try:
        FN[impl](q, k, v, seq, **kw)
        res[name] = None
    except ValueError as e:
        res[name] = str(e)
params = load_npz(spec["params"])
tokens = torch.from_numpy(data["tokens"]).long()
for name, kw in spec["lm"].items():
    mesh = seq if kw["attention_impl"] == "ring_local" else dseq
    m = TransformerLM(**spec["cfg"], **kw, dtype="float32", device="cpu", mesh=mesh,
                      batch_axis=None if mesh is seq else "data").load_flax(params)
    with torch.no_grad():
        if kw["attention_impl"] == "ring_local":
            chunk = tokens.shape[1] // 4
            res[name] = m(tokens[:, rank * chunk:(rank + 1) * chunk]).numpy()
        else:
            res[name] = m(tokens).numpy()
# Training through the LM on the data 2 x seq 2 mesh: every rank's
# gradients, and the activation shapes its blocks saw.
train_tokens = torch.from_numpy(data["train_tokens"]).long()
inputs, targets = train_tokens[:, :-1], train_tokens[:, 1:]
for name, kw in spec["lm_grads"].items():
    kw = dict(kw)
    against = kw.pop("against", None)
    p = load_npz(spec["moe_params"] if kw.get("moe_every") else spec["params"])
    seen = {}

    def spy(key):
        def hook(mod, args):
            seen.setdefault(key, tuple(args[0].shape))
        return hook

    out_ = {}
    for impl, mesh in ((kw.pop("attention_impl"), dseq), (against, None)):
        if impl is None:
            continue
        torch.manual_seed(0)
        m = TransformerLM(**spec["cfg"], **kw, attention_impl=impl, dtype="float32",
                          device="cpu", mesh=mesh,
                          batch_axis="data" if mesh is not None else None).load_flax(p)
        if mesh is not None:
            for i, blk in enumerate(m.blocks()):
                ffn = blk.moe if hasattr(blk, "moe") else blk.mlp
                ffn.register_forward_pre_hook(spy(f"block_{i}"))
            m.final_norm.register_forward_pre_hook(spy("final_norm"))
        logits = m(inputs, train=True, generator=torch.Generator().manual_seed(7))
        torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                          targets.reshape(-1)).backward()
        out_[impl if mesh is None else "sp"] = {
            "logits": logits.detach().numpy(),
            "grads": {k.replace(".", "/"): q.grad.numpy() for k, q in m.named_parameters()}}
    res[name] = {"seen": seen, **out_}
res["axis"] = (axis_group(dseq, "seq").ranks, axis_group(dseq, "data").ranks)
with open(f"{out}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
'''

LM_CASES = {"lm-ring": dict(attention_impl="ring"),
            "lm-ring-window": dict(attention_impl="ring", window=8),
            "lm-ulysses": dict(attention_impl="ulysses"),
            "lm-ring-local": dict(attention_impl="ring_local")}
#: Training through the sequence-parallel LM (data 2 x seq 2, batch 2 x
#: 64): held to JAX's reference LM, or with ``against`` (dropout masks
#: are the port's own draws) to the port's LM on that impl in one process.
LM_GRAD_CASES = {
    "lm-grads-ring": dict(attention_impl="ring"),
    "lm-grads-ring-window": dict(attention_impl="ring", window=8),
    "lm-grads-ulysses": dict(attention_impl="ulysses"),
    "lm-grads-ring-moe": dict(attention_impl="ring", moe_every=2, num_experts=4, moe_top_k=2),
    "lm-grads-ulysses-dropout-remat": dict(attention_impl="ulysses", dropout_rate=0.25,
                                           remat=True, against="reference"),
}
REJECTS = {"reject-ulysses-heads": ("ulysses", dict(heads=3), {}),
           "reject-ring-gqa": ("ring", dict(heads=6, kv_heads=4, seq=128), dict(causal=True))}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return shared_once(tmp_path_factory, "ringattention_ranks", lambda: _launch(tmp_path_factory))


def _launch(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("ring")
    data = {}
    for name, (_, ikw, _) in {**CASES, **GRAD_CASES, **REJECTS}.items():
        for t, arr in zip("qkv", _inputs(**ikw)):
            data[f"{name}/{t}"] = arr
    data["tokens"] = np.random.default_rng(0).integers(0, 32, (2, 64)).astype(np.int32)
    ref_lm = JaxLM(**LM, dtype=jnp.float32, attention_impl="reference")
    params = flatten(jax.device_get(ref_lm.init(jax.random.PRNGKey(1),
                                                jnp.asarray(data["tokens"]))))
    data["train_tokens"] = np.random.default_rng(1).integers(0, 32, (2, 65)).astype(np.int32)
    moe_lm = JaxLM(**LM, dtype=jnp.float32, attention_impl="reference", **MOE)
    moe_params = flatten(jax.device_get(moe_lm.init(jax.random.PRNGKey(2),
                                                    jnp.asarray(data["tokens"]))["params"]))
    np.savez(d / "data.npz", **data)
    np.savez(d / "params.npz", **params)
    np.savez(d / "moe_params.npz", **moe_params)

    def calls(cases):
        return {k: (impl, kw) for k, (impl, _, kw) in cases.items()}

    spec = {"data": str(d / "data.npz"), "params": str(d / "params.npz"), "cfg": LM,
            "cases": calls(CASES), "grads": calls(GRAD_CASES), "rejects": calls(REJECTS),
            "lm": {k: {kk: vv for kk, vv in v.items()} for k, v in LM_CASES.items()},
            "lm_grads": LM_GRAD_CASES, "moe_params": str(d / "moe_params.npz")}
    (d / "spec.json").write_text(json.dumps(spec))
    ranks = run_ranks(d, N, WORKER, str(d), str(d / "spec.json"))
    return ranks, data, {"dense": params, "moe": moe_params}


@pytest.fixture(scope="module")
def seq_mesh():
    return jax_mesh.make_mesh({"seq": N}, devices=jax.devices()[:N])


def _all_ranks(ranks, name):
    first = ranks[0][name]
    for r in ranks[1:]:
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(r[name])):
            np.testing.assert_array_equal(a, b, err_msg=name)
    return first


@pytest.mark.parametrize("name", list(CASES))
def test_matches_full_attention_and_jax(setup, seq_mesh, name):
    ranks, data, _ = setup
    impl, _, kw = CASES[name]
    q, k, v = (jnp.asarray(data[f"{name}/{t}"]) for t in "qkv")
    got = _all_ranks(ranks, name)
    kr, vr = repeat_kv(q, k, v)
    causal, window = kw.get("causal", False), kw.get("window")
    np.testing.assert_allclose(got, attention_reference(q, kr, vr, causal=causal, window=window),
                               **TOL)
    if name in ON_JAX_SP:  # and the JAX package's own sequence-parallel function
        jfn = ring_attention if impl == "ring" else ulysses_attention
        jkw = {**kw, "use_flash": False} if impl == "ulysses" else kw
        np.testing.assert_allclose(got, jfn(q, k, v, seq_mesh, **jkw), **TOL)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_gradients_match_jax(setup, name):
    """Every rank holds the full gradient of the global q, k, v, equal to
    the gradient of JAX's reference attention."""
    ranks, data, _ = setup
    impl, _, kw = GRAD_CASES[name]
    q, k, v = (jnp.asarray(data[f"{name}/{t}"]) for t in "qkv")
    got = _all_ranks(ranks, name)
    want = jax.grad(lambda q, k, v: attention_reference(q, k, v, **kw).sum(),
                    argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("name,match", [("reject-ulysses-heads", "heads"),
                                        ("reject-ring-gqa", "divisible")])
def test_refusals(setup, name, match):
    for r in setup[0]:
        assert r[name] is not None and match in r[name]


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_matches_reference_impl(setup, name):
    """A GQA LM with a sequence-parallel impl on a data 2 x seq 2 mesh
    (``ring_local``: each of 4 seq ranks feeds its own chunk) gives the
    single-process reference impl's logits."""
    ranks, data, params = setup
    kw = LM_CASES[name]
    window = kw.get("window")
    ref = JaxLM(**LM, dtype=jnp.float32, attention_impl="reference", window=window)
    want = np.asarray(ref.apply({"params": params_tree(params["dense"])},
                                jnp.asarray(data["tokens"])))
    if kw["attention_impl"] == "ring_local":
        got = np.concatenate([r[name] for r in ranks], axis=1)
    else:
        got = _all_ranks(ranks, name)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", list(LM_GRAD_CASES))
def test_lm_training_gradients(setup, name):
    """The sequence-parallel LM trains on this rank's block of the
    activations: each block's MLP (and the final norm's join aside) sees
    (batch/2, seq/2) while the experts see the global batch, and every
    rank ends with the full gradient of every parameter, equal to the
    single-process reference's (JAX's, or the port's with dropout)."""
    ranks, data, params = setup
    kw = dict(LM_GRAD_CASES[name])
    against = kw.pop("against", None)
    got = _all_ranks(ranks, name)
    b, s = data["train_tokens"].shape[0], data["train_tokens"].shape[1] - 1
    moe_every = kw.get("moe_every", 0)
    for i in range(LM["num_layers"]):
        is_moe = moe_every and (i + 1) % moe_every == 0
        want_shape = (b, s, LM["d_model"]) if is_moe else (b // 2, s // 2, LM["d_model"])
        assert got["seen"][f"block_{i}"] == want_shape, (i, got["seen"])
    assert got["seen"]["final_norm"] == (b, s, LM["d_model"])
    if against is not None:
        want_logits, want_grads = got[against]["logits"], got[against]["grads"]
    else:
        jkw = {k: v for k, v in kw.items() if k != "attention_impl"}
        ref = JaxLM(**LM, dtype=jnp.float32, attention_impl="reference", **jkw)
        tree = params_tree(params["moe" if moe_every else "dense"])
        tokens = jnp.asarray(data["train_tokens"])

        def loss(p):
            logits = ref.apply({"params": p}, tokens[:, :-1])
            logp = jax.nn.log_softmax(logits, axis=-1)
            return -jnp.take_along_axis(logp, tokens[:, 1:, None], -1).mean(), logits

        (_, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(tree)
        want_grads = flatten(jax.device_get(want_grads))
    np.testing.assert_allclose(got["sp"]["logits"], want_logits, atol=2e-4, rtol=2e-4)
    assert set(got["sp"]["grads"]) == set(want_grads)
    for k, g in got["sp"]["grads"].items():
        np.testing.assert_allclose(g, want_grads[k], atol=2e-5, rtol=2e-4, err_msg=k)


def params_tree(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def test_axis_groups_are_the_mesh_lines(setup):
    for i, r in enumerate(setup[0]):
        seq_ranks, data_ranks = r["axis"]
        assert tuple(seq_ranks) == (2 * (i // 2), 2 * (i // 2) + 1)
        assert tuple(data_ranks) == (i % 2, i % 2 + 2)
