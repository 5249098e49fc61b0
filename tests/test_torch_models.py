"""The port's classification models and steps against the JAX package,
fp32 on the CPU.

The JAX package's weights (``model.init``, with every BatchNorm scale,
bias, mean and variance redrawn from a seed: the zero-initialised last
scale of a bottleneck would otherwise hide its whole 3x3 path) are
carried over by ``params_from_flax``; the same numpy batches go through
the flax module and the port's. ResNet runs at 32x32 with JAX's
space-to-depth stem on and off (the port always computes the plain 7x7
stride-2 stem) and at 33x33, where JAX takes the plain stem too and
every stride-2 3x3 pads symmetrically.

Tolerances: logits ``atol 1e-4`` (fp32 convolutions in other summation
orders), running statistics ``atol 1e-5``, three train steps ``rtol
1e-4, atol 1e-5`` on loss, accuracy, every parameter and statistic;
gradients and momentum traces (sums over the batch) within ``1e-4`` of
each tensor's largest entry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from hops_tpu.models import common as jax_common
from hops_tpu.models import mnist as jax_mnist
from hops_tpu.models import resnet as jax_resnet
from hops_tpu_torch.models import common
from hops_tpu_torch.models.convert import params_from_flax, params_to_flax
from hops_tpu_torch.models.layers import same_pads
from hops_tpu_torch.models.mnist import CNN, FFN
from hops_tpu_torch.models.resnet import ResNet, ResNet18ish, ResNet50

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 4
STEP_LR = 1e-4

# name -> (JAX module, port constructor, image shape)
SPECS = {
    "cnn": (lambda: jax_mnist.CNN(dropout_rate=0.0, dtype=jnp.float32),
            lambda: CNN(dropout_rate=0.0, dtype="float32", device="cpu"), (28, 28, 1)),
    "ffn": (lambda: jax_mnist.FFN(dtype=jnp.float32),
            lambda: FFN(dtype="float32", device="cpu"), (28, 28, 1)),
    "resnet18ish-32-s2d": (lambda: jax_resnet.ResNet18ish(dtype=jnp.float32),
                           lambda: ResNet18ish(dtype="float32", device="cpu"), (32, 32, 3)),
    "resnet18ish-32-plain": (
        lambda: jax_resnet.ResNet([1, 1, 1, 1], num_classes=10, width=16, dtype=jnp.float32,
                                  s2d_stem=False),
        lambda: ResNet18ish(dtype="float32", device="cpu"), (32, 32, 3)),
    "resnet-w16-33": (
        lambda: jax_resnet.ResNet([1, 1, 1, 1], num_classes=10, width=16, dtype=jnp.float32),
        lambda: ResNet([1, 1, 1, 1], num_classes=10, width=16, dtype="float32", device="cpu"),
        (33, 33, 3)),
}


# One intra-op thread: the port's CPU sums in one order whatever the
# machine's core count, and parallel test workers do not oversubscribe it.
@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_bn(module_name):
    return module_name.startswith("BatchNorm") or module_name == "proj_bn"


def _randomize_bn(variables, seed=1):
    """Seeded non-trivial BatchNorm scale, bias, mean and variance."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = {k: np.array(v) for k, v in flatten_dict(tree).items()}
        for key, arr in flat.items():
            leaf = key[-1]
            if leaf in ("scale", "var"):
                flat[key] = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            elif leaf == "mean" or (leaf == "bias" and _is_bn(key[-2])):
                flat[key] = (0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out


def _images(shape, seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, *shape)).astype(np.float32)


def _labels(seed=0, n=BATCH):
    return np.random.default_rng(seed + 100).integers(0, 10, n).astype(np.int32)


@pytest.fixture(scope="module", params=list(SPECS))
def pair(request):
    jax_ctor, port_ctor, shape = SPECS[request.param]
    jm = jax_ctor()
    init = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(0),
                                      "dropout": jax.random.PRNGKey(1)}, x, train=False))
    variables = init(jnp.zeros((1, *shape)))
    variables = _randomize_bn(jax.device_get(dict(variables)))
    return request.param, jm, variables, port_ctor, shape


def _port(pair):
    _, _, variables, port_ctor, _ = pair
    model = port_ctor()
    model.load_state_dict(params_from_flax(variables), strict=True)
    return model


def _assert_close_to_largest(got, want, name):
    """Gradient sums: within 1e-4 of the tensor's largest entry."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-7,
                               err_msg=name)


def _stats(model):
    return {n: b.numpy().copy() for n, b in model.named_buffers()}


def _jax_stats(batch_stats):
    return {".".join(k): np.asarray(v) for k, v in flatten_dict(batch_stats).items()}


def test_eval_forward_matches_jax(pair):
    _, jm, variables, _, shape = pair
    x = _images(shape)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    got = _port(pair)(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_train_forward_and_running_statistics_match_jax(pair):
    name, jm, variables, _, shape = pair
    x = _images(shape, seed=3)
    if "batch_stats" in variables:
        want, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, x)
    else:
        want, upd = jm.apply(variables, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)}), {}
    model = _port(pair)
    got = model(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    stats = _stats(model)
    want_stats = _jax_stats(upd.get("batch_stats", {}))
    assert set(stats) == set(want_stats)
    for key, val in want_stats.items():
        np.testing.assert_allclose(stats[key], val, atol=1e-5, rtol=0, err_msg=key)


def test_three_train_steps_track_jax(pair):
    """Adam (``make_train_step``) for the CNN and FFN, SGD with momentum
    (``make_bn_train_step``) for the BatchNorm ResNets; the optimizer's
    state (Adam's moments, the momentum trace) is compared too.

    Both run at ``STEP_LR``, where three updates move a weight by less
    than its size, and the ResNets on 16-image batches, so that the
    weights' ``rtol 1e-4, atol 1e-5`` reads the step's semantics, not
    fp32 rounding amplified: an update is the learning rate times
    gradient sums that agree to 1e-4 of their largest entry (the state
    check), and Adam moves an element whose gradient is at the rounding
    level by up to the learning rate either way. At the defaults these
    narrow nets with redrawn statistics diverge (SGD at 0.1: loss 2.5 to
    9.7 in three steps) and no two fp32 implementations agree to 1e-4.
    At 32x32 the ResNets' last stage is 1x1, so each of its BatchNorm
    channels normalizes one value per image: on 8 images JAX's own fp32
    gradients differ from its fp64 ones by up to 23% of a tensor's
    largest entry (the port's by 1e-5)."""
    name, jm, variables, _, shape = pair
    bn = "batch_stats" in variables
    # The optimizers of create_bn_train_state / create_train_state, on the
    # carried-over variables (no second, op-by-op model.init).
    if bn:
        jstate = jax_common.BNTrainState.create(
            apply_fn=jm.apply, params=variables["params"], batch_stats=variables["batch_stats"],
            tx=optax.sgd(STEP_LR, momentum=0.9), rng=jax.random.PRNGKey(0))
        pstate = common.create_bn_train_state(_port(pair), learning_rate=STEP_LR)
        jstep, pstep = jax_common.make_bn_train_step(), common.make_bn_train_step()
    else:
        jstate = jax_common.TrainState.create(
            apply_fn=jm.apply, params=variables["params"], tx=optax.adam(STEP_LR),
            rng=jax.random.PRNGKey(0))
        pstate = common.create_train_state(_port(pair), learning_rate=STEP_LR)
        jstep, pstep = jax_common.make_train_step(), common.make_train_step()
    jstep = jax.jit(jstep)
    n = 16 if bn else BATCH
    for i in range(3):
        batch = {"image": _images(shape, seed=10 + i, n=n), "label": _labels(seed=i, n=n)}
        jstate, jm_ = jstep(jstate, batch)
        pstate, pm = pstep(pstate, batch)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(float(pm[k]), float(jm_[k]), **TOL, err_msg=f"{k} {i}")
    assert pstate.step == 3
    want = dict(params=jax.device_get(jstate.params))
    if bn:
        want["batch_stats"] = jax.device_get(jstate.batch_stats)
    got = params_to_flax(pstate.model)
    got = got if bn else {"params": got}
    for col in want:
        flat_want = {"/".join(k): v for k, v in flatten_dict(want[col]).items()}
        assert set(got[col]) == set(flat_want)
        for key, val in flat_want.items():
            np.testing.assert_allclose(got[col][key], np.asarray(val), **TOL, err_msg=key)
    opt = jax.device_get(jstate.opt_state[0])
    pairs = [("momentum_buffer", opt.trace)] if bn else [("exp_avg", opt.mu),
                                                         ("exp_avg_sq", opt.nu)]
    for torch_key, tree in pairs:
        flat = {".".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}
        for pname, p in pstate.model.named_parameters():
            buf = pstate.optimizer.state[p][torch_key].numpy()
            if buf.ndim == 4:
                buf = buf.transpose(2, 3, 1, 0)
            _assert_close_to_largest(buf, flat[pname], f"{torch_key} {pname}")


def test_first_step_gradients_match_jax(pair):
    """Every parameter's gradient of a train-mode loss, BatchNorm on
    batch statistics, within 1e-4 of the tensor's largest entry."""
    name, jm, variables, _, shape = pair
    x, labels = _images(shape, seed=10), _labels(seed=0)

    def loss(params):
        v = {**variables, "params": params}
        kw = {"mutable": ["batch_stats"]} if "batch_stats" in v else {}
        out = jm.apply(v, x, train=True, **kw)
        return jax_common.cross_entropy_loss(out[0] if kw else out, labels)

    want = {".".join(k): np.asarray(g) for k, g in
            flatten_dict(jax.jit(jax.grad(loss))(variables["params"])).items()}
    model = _port(pair)
    logits = model(torch.from_numpy(x), train=True, generator=torch.Generator())
    common.cross_entropy_loss(logits, torch.from_numpy(labels)).backward()
    for pname, p in model.named_parameters():
        got = p.grad.numpy()
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)
        _assert_close_to_largest(got, want[pname], pname)


def test_eval_step_matches_jax(pair):
    _, jm, variables, _, shape = pair
    batch = {"image": _images(shape, seed=5), "label": _labels(seed=5)}
    logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, batch["image"])
    want_loss = float(jax_common.cross_entropy_loss(logits, batch["label"]))
    want_acc = float(jax_common.accuracy(logits, batch["label"]))
    got = common.make_eval_step()(common.TrainState(_port(pair), None), batch)
    np.testing.assert_allclose(float(got["loss"]), want_loss, **TOL)
    assert float(got["accuracy"]) == want_acc


def test_weights_round_trip_through_params_to_flax(pair):
    _, _, variables, _, _ = pair
    got = params_to_flax(_port(pair))
    got = got if "batch_stats" in variables else {"params": got}
    assert set(got) == set(variables)
    for col, tree in variables.items():
        flat = {"/".join(k): v for k, v in flatten_dict(tree).items()}
        assert set(got[col]) == set(flat)
        for key, val in flat.items():
            np.testing.assert_array_equal(got[col][key], np.asarray(val), err_msg=key)


def test_port_trained_cnn_loads_into_the_jax_cnn():
    model = CNN(dropout_rate=0.5, dtype="float32", device="cpu", seed=3)
    state = common.create_train_state(model)
    step = common.make_train_step()
    for i in range(2):
        state, _ = step(state, {"image": _images((28, 28, 1), seed=i), "label": _labels(i)})
    x = _images((28, 28, 1), seed=9)
    want = model(torch.from_numpy(x), train=False).detach().numpy()
    params = unflatten_dict(params_to_flax(model), sep="/")
    got = jax_mnist.CNN(dtype=jnp.float32).apply({"params": params}, x, train=False)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4, rtol=0)


def _resnet_grads(remat, x, labels):
    model = ResNet18ish(dtype="float32", remat=remat, device="cpu", seed=4)
    with torch.no_grad():
        for name, b in model.named_buffers():  # non-trivial statistics
            b.add_(0.1 * torch.randn(b.shape, generator=torch.Generator().manual_seed(7)).abs())
        for m in model.modules():
            if hasattr(m, "scale_init"):
                m.scale.fill_(0.7)
    logits = model(x, train=True)
    loss = common.cross_entropy_loss(logits, labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return logits.detach(), grads, _stats(model)


def test_remat_gives_identical_values_gradients_and_statistics():
    """Recomputing each bottleneck in backward leaves logits, gradients
    and the running statistics (updated once, not again by the
    recompute) as they were without remat."""
    x = torch.from_numpy(_images((32, 32, 3), seed=6))
    labels = torch.from_numpy(_labels(6)).long()
    base, remat = _resnet_grads(False, x, labels), _resnet_grads(True, x, labels)
    torch.testing.assert_close(remat[0], base[0], rtol=0, atol=0)
    for name in base[1]:
        torch.testing.assert_close(remat[1][name], base[1][name], rtol=0, atol=0, msg=name)
    for name in base[2]:
        np.testing.assert_array_equal(remat[2][name], base[2][name], err_msg=name)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (16, 1, 2, (0, 0)), (28, 3, 1, (1, 1)),
])
def test_same_padding_is_lax_same_padding(size, kernel, stride, want):
    assert same_pads(size, kernel, stride) == want
    lo, hi = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert (lo, hi) == want


def test_synthetic_class_data_is_deterministic_and_fast_forwards():
    data = common.SyntheticClassData(num_classes=5, shape=(8, 8, 3), seed=2, device="cpu")
    a = list(data.batches(4, 5))
    b = list(data.batches(4, 5))
    tail = list(data.batches(4, 5, start=3))
    assert len(a) == 5 and len(tail) == 2
    assert a[0]["image"].shape == (4, 8, 8, 3) and a[0]["label"].shape == (4,)
    for x, y in zip(a, b):
        assert torch.equal(x["image"], y["image"]) and torch.equal(x["label"], y["label"])
    for x, y in zip(a[3:], tail):
        assert torch.equal(x["image"], y["image"]) and torch.equal(x["label"], y["label"])
    assert not torch.equal(a[0]["image"], a[1]["image"])
    other = list(common.SyntheticClassData(num_classes=5, shape=(8, 8, 3), seed=3,
                                           device="cpu").batches(4, 1))
    assert not torch.equal(a[0]["image"], other[0]["image"])


def test_synthetic_data_is_learnable_by_the_cnn():
    data = common.SyntheticClassData(seed=0, device="cpu")
    state = common.create_train_state(CNN(dtype="float32", device="cpu"))
    step = common.make_train_step()
    losses = []
    for batch in data.batches(32, 15):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.5


def test_grad_comms_is_a_later_slice():
    """Gradient communication is ported: a ``grad_comms`` step carries
    its marker and, through ``Strategy.step`` on one rank (no wire),
    trains bit for bit like the plain step."""
    from hops_tpu_torch.parallel import Strategy
    from hops_tpu_torch.parallel.grad_comms import GradCommsConfig

    cfg = GradCommsConfig(quantize=True, overlap=True)
    assert common.make_train_step(grad_comms=cfg).grad_comms == cfg
    data = common.SyntheticClassData(seed=0, device="cpu")
    runs = []
    for c in (None, cfg):
        state = common.create_train_state(FFN(dtype="float32", device="cpu", seed=0))
        step = Strategy(device="cpu").step(common.make_train_step(grad_comms=c), grad_comms=c)
        runs.append([step(state, b)[1]["loss"].item() for b in data.batches(32, 3)])
    assert runs[0] == runs[1]


def test_resnet50_has_the_jax_parameter_tree():
    """Every name and shape of JAX's ResNet-50 (conv kernels
    transposed), at full width on the meta device."""
    jm = jax_resnet.ResNet50()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    want = {}
    for col, tree in shapes.items():
        for k, v in flatten_dict(tree).items():
            name = ".".join(k)
            shape = tuple(v.shape)
            if len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            want[name] = shape
    with torch.device("meta"):
        model = ResNet50(device="meta")
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == want
