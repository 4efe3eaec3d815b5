"""autodist_tpu_torch's VGG, Inception and DenseNet vs the JAX package's
(``models/cnn.py``), on the same variables (the JAX init with its
BatchNorm statistics, scales and biases drawn at random, converted with
``convert.params_from_jax``) and the same numpy batches.

float32 on the CPU, batch 2: ``VGGTiny`` and ``DenseNetTiny`` at image
32, ``InceptionTiny`` at image 75 (the smallest its stem and two VALID
reductions take):

- logits and loss within 1e-5, grads within 1e-4 of each leaf's largest
  magnitude (the two frameworks sum convolutions in different orders), as
  ``tests/test_torch_resnet.py`` holds ResNet;
- a bf16 loss within 2e-2 of the JAX bf16 loss (bf16 convs, f32 norms);
- three ``Runner.run`` Adam steps against three JAX AllReduce steps:
  losses within 1e-5, params within 1e-4, the ``batch_stats`` bit-equal
  to their init in both packages;
- the conversion round trip, and the full-width models' variable names
  and flax shapes against the JAX init's (shapes only, no arrays);
- flax's pooling at each drift point: SAME max-pool at stride 2 on an
  even size (-inf padding, the odd pixel after), SAME avg-pool at a
  border (the padded zeros counted), VALID pools at odd and even sizes.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.checkpoint.saver import _tree_to_flat
from autodist_tpu.kernel.common import variable_utils
from autodist_tpu.models import cnn as jcnn
from autodist_tpu.models import resnet as jresnet
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import (flax_shape, jax_name,
                                        params_from_jax, params_to_jax)
from autodist_tpu_torch.model_item import BATCH_STATS_PREFIX
from autodist_tpu_torch.models import cnn as tcnn
from autodist_tpu_torch.models import resnet as tresnet

BATCH, CLASSES, LR, STEPS = 2, 10, 1e-3, 3
ONE_DEVICE = {"nodes": [{"address": "127.0.0.1", "chief": True,
                         "cpus": [0]}]}
MODELS = {"vgg": (jcnn.VGGTiny, tcnn.VGGTiny, 32),
          "inception": (jcnn.InceptionTiny, tcnn.InceptionTiny, 75),
          "densenet": (jcnn.DenseNetTiny, tcnn.DenseNetTiny, 32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()


def _randomized(variables, seed):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        key = path[-1].key
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key in ("mean", "bias"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(draw, variables)


_CACHE = {}


def _setups(model, dtype=(jnp.float32, torch.float32)):
    """(JAX loss, JAX variables, batch, port loss, converted params, port
    init, port apply, JAX apply); the f32 variables serve both dtypes."""
    key = (model, dtype[1])
    if key not in _CACHE:
        jcls, tcls, image = MODELS[model]
        jl, jvars, batch, japply = jresnet.make_train_setup(
            jcls, num_classes=CLASSES, image_size=image, batch_size=BATCH,
            dtype=dtype[0])
        tl, tinit, _, tapply = tresnet.make_train_setup(
            tcls, num_classes=CLASSES, image_size=image, batch_size=BATCH,
            dtype=dtype[1])
        if dtype[1] != torch.float32:
            jvars = _setups(model)[1]
        else:
            jvars = jax.tree_util.tree_map(np.asarray,
                                           _randomized(jvars, seed=3))
        _CACHE[key] = (jl, jvars, batch, tl, params_from_jax(jvars), tinit,
                       tapply, japply)
    return _CACHE[key]


def _batches(model, n, seed):
    image = MODELS[model][2]
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(BATCH, image, image, 3).astype(np.float32),
             "label": rng.randint(0, CLASSES, (BATCH,)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_conversion_and_init_cover_every_variable(model):
    _, jvars, _, _, tparams, tinit, _, _ = _setups(model)
    assert tparams.keys() == tinit.keys()
    for name, t in tinit.items():
        assert tuple(t.shape) == tuple(tparams[name].shape), name
    stats = [n for n in tinit if n.startswith(BATCH_STATS_PREFIX)]
    assert len(stats) == len(jax.tree_util.tree_leaves(jvars["batch_stats"]))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_logits_loss_and_grads_match_jax(model):
    jl, jvars, batch, tl, tparams, _, tapply, japply = _setups(model)
    np.testing.assert_allclose(
        tapply(tparams, batch["image"]).numpy(),
        np.asarray(japply(jvars, batch["image"])), atol=1e-5, rtol=1e-5)
    jloss, jgrads = jax.value_and_grad(jl)(jvars, batch)
    leaves = {n: t.clone().requires_grad_() for n, t in tparams.items()}
    tloss = tl(leaves, batch)
    tgrads = dict(zip(leaves, torch.autograd.grad(
        tloss, list(leaves.values()), allow_unused=True)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert jgrads.keys() == tgrads.keys()
    for name, g in tgrads.items():
        want = jgrads[name].numpy()
        got = np.zeros_like(want) if g is None else g.numpy()
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bf16_loss_matches_jax(model):
    jl, jvars, batch, tl, tparams, _, _, _ = _setups(
        model, dtype=(jnp.bfloat16, torch.bfloat16))
    np.testing.assert_allclose(float(tl(tparams, batch)),
                               float(jl(jvars, batch)), rtol=2e-2)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_runner_matches_jax_three_steps_and_holds_batch_stats(model):
    jl, jvars, batch, tl, tparams, _, _, _ = _setups(model)
    batches = _batches(model, STEPS, seed=5)
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                           resource_spec=JSpec.from_dict(ONE_DEVICE))
        runner = ad.build(jl, optax.adam(LR), jvars, batch)
        runner.init(jvars)
        jlosses = [float(runner.run(b)["loss"]) for b in batches]
        jfinal = params_from_jax(jax.tree_util.tree_map(
            np.asarray, runner.gather_params()))
    finally:
        jadt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    trunner = ad.build(tl, functools.partial(torch.optim.Adam, lr=LR),
                       tparams, batch)
    trunner.init(tparams)
    losses = [float(trunner.run(b)["loss"]) for b in batches]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=1e-5)
    final = trunner.gather_params()
    for name, value in final.items():
        if name.startswith(BATCH_STATS_PREFIX):
            assert torch.equal(value, tparams[name]), name
            assert torch.equal(jfinal[name], tparams[name]), name
        else:
            assert not torch.equal(value, tparams[name]), name
            np.testing.assert_allclose(value.numpy(), jfinal[name].numpy(),
                                       atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_params_to_jax_inverts_params_from_jax(model):
    _, jvars, _, _, tparams, tinit, _, _ = _setups(model)
    want = _tree_to_flat(jvars)
    got = params_to_jax(tparams)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert {k: v.shape for k, v in params_to_jax(tinit).items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("name,jcls,tcls,image", [
    ("vgg16", jcnn.VGG16, tcnn.VGG16, 224),
    ("inceptionv3", jcnn.InceptionV3, tcnn.InceptionV3, 299),
    ("densenet121", jcnn.DenseNet121, tcnn.DenseNet121, 224)])
def test_full_width_variables_are_the_jax_models(name, jcls, tcls, image):
    """The full-width models' variables under their JAX names in flax's
    shapes equal the JAX init's (``jax.eval_shape``: no arrays), and the
    registry builds them at those sizes."""
    abstract = jax.eval_shape(
        lambda: jcls(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.ones((1, image, image, 3)),
            train=False))
    names, leaves, _ = variable_utils.flatten_named(abstract)
    want = {n: tuple(leaf.shape) for n, leaf in zip(names, leaves)}
    kw = {"image_size": image} if name == "vgg16" else {}
    with torch.device("meta"):
        model = tcls(num_classes=1000, **kw)
    got = {}
    for n, p in model.named_parameters():
        if n.endswith((".mean", ".var")):      # BatchNorm statistics
            n = BATCH_STATS_PREFIX + n
        got[jax_name(n, tuple(p.shape))] = flax_shape(n, tuple(p.shape))
    assert got == want


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("case,size", [
    ("max SAME 3x3 s2 (DenseNet stem), even size", 8),
    ("max SAME 3x3 s2, odd size", 7),
    ("avg SAME 3x3 s1 (Inception pool tower), border", 6),
    ("max VALID 3x3 s2 (Inception stem, reductions), odd size", 15),
    ("max VALID 3x3 s2, even size", 16),
    ("max VALID 2x2 s2 (VGG), odd size", 7),
    ("avg VALID 2x2 s2 (DenseNet transition), odd size", 7)])
def test_pooling_matches_flax(case, size):
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(
        np.float32)
    k = 2 if "2x2" in case else 3
    s = 1 if " s1 " in case else 2
    padding = "SAME" if "SAME" in case else "VALID"
    if case.startswith("max"):
        want = fnn.max_pool(jnp.asarray(x), (k, k), (s, s), padding)
        got = (tresnet.max_pool_same(_nchw(x), k, s) if padding == "SAME"
               else F.max_pool2d(_nchw(x), k, s))
        assert np.array_equal(_nhwc(got), np.asarray(want))
    else:
        want = fnn.avg_pool(jnp.asarray(x), (k, k), (s, s), padding)
        got = (tcnn.avg_pool_same(_nchw(x), k, s) if padding == "SAME"
               else F.avg_pool2d(_nchw(x), k, s))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    assert _nhwc(got).shape == want.shape
