"""autodist_tpu_torch's ResNet vs the JAX package's, on the same variables
(the JAX init with its BatchNorm statistics, scales and biases drawn at
random so every term of the norm counts, converted with
``convert.params_from_jax``) and the same numpy batches.

float32 on the CPU, batch 4, image 32: ``ResNetTiny`` (basic blocks) and
a two-stage bottleneck config (resnet50's block, one block a stage), both
of which pad asymmetrically (flax ``"SAME"``: the stride-2 3x3 conv and
the stride-2 max pool pad 0 before, 1 after at even sizes):

- loss within 1e-5 and grads within 1e-4 of each leaf's largest
  magnitude (the two frameworks sum convolutions in different orders);
- a bf16 loss within 2e-2 of the JAX bf16 loss (bf16 convs, f32 norms);
- three ``Runner.run`` Adam steps against three JAX AllReduce steps
  (losses 1e-5), with the ``batch_stats`` bit-equal to their init after
  the steps in both packages and their Adam moments 0 in both;
- ``params_from_jax`` on conv and BatchNorm leaves, and its errors;
- the model ``REGISTRY``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.models import resnet as jresnet
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import models, strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.model_item import BATCH_STATS_PREFIX
from autodist_tpu_torch.models import resnet as tresnet

IMAGE, BATCH, CLASSES, LR, STEPS = 32, 4, 10, 1e-3, 3
ONE_DEVICE = {"nodes": [{"address": "127.0.0.1", "chief": True,
                         "cpus": [0]}]}
CONFIGS = {
    "tiny": (jresnet.ResNetTiny, tresnet.ResNetTiny),
    "bottleneck": (functools.partial(jresnet.ResNet, stage_sizes=[1, 1],
                                     block_cls=jresnet.BottleneckBlock,
                                     num_filters=8),
                   functools.partial(tresnet.ResNet, stage_sizes=[1, 1],
                                     block_cls=tresnet.BottleneckBlock,
                                     num_filters=8)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()


def _randomized(variables, seed):
    """The flax variables with BatchNorm scale, bias, mean and var drawn at
    random (the init's zero scales would hide the blocks' last convs)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        key = path[-1].key
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key in ("mean", "bias"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(draw, variables)


def _setups(config, dtype=(jnp.float32, torch.float32)):
    jcls, tcls = CONFIGS[config]
    jl, jvars, batch, _ = jresnet.make_train_setup(
        jcls, num_classes=CLASSES, image_size=IMAGE, batch_size=BATCH,
        dtype=dtype[0])
    tl, tinit, _, tapply = tresnet.make_train_setup(
        tcls, num_classes=CLASSES, image_size=IMAGE, batch_size=BATCH,
        dtype=dtype[1])
    jvars = _randomized(jvars, seed=3)
    return jl, jvars, batch, tl, params_from_jax(jvars), tinit, tapply


def _batches(n, seed):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
             "label": rng.randint(0, CLASSES, (BATCH,)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_conversion_and_init_cover_every_variable(config):
    _, jvars, _, _, tparams, tinit, _ = _setups(config)
    assert tparams.keys() == tinit.keys()
    for name, t in tinit.items():
        assert tuple(t.shape) == tuple(tparams[name].shape), name
    stats = [n for n in tinit if n.startswith(BATCH_STATS_PREFIX)]
    assert len(stats) == len(jax.tree_util.tree_leaves(jvars["batch_stats"]))
    # the last norm of each block starts at scale 0, as flax's does
    zero = sorted(n for n, t in tinit.items()
                  if n.endswith("weight") and float(t.abs().max()) == 0.0)
    last = "BatchNorm_1" if config == "tiny" else "BatchNorm_2"
    assert zero and all(n.split(".")[1] == last for n in zero)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_loss_and_grads_match_jax(config):
    jl, jvars, batch, tl, tparams, _, tapply = _setups(config)
    jloss, jgrads = jax.value_and_grad(jl)(jvars, batch)
    leaves = {n: t.clone().requires_grad_() for n, t in tparams.items()}
    tloss = tl(leaves, batch)
    tgrads = dict(zip(leaves, torch.autograd.grad(tloss,
                                                  list(leaves.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert jgrads.keys() == tgrads.keys()
    for name, g in tgrads.items():
        want = jgrads[name].numpy()
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, err)
    logits = tapply(tparams, batch["image"])
    assert logits.shape == (BATCH, CLASSES) and logits.dtype == torch.float32


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_bf16_loss_matches_jax(config):
    jl, jvars, batch, tl, tparams, _, _ = _setups(
        config, dtype=(jnp.bfloat16, torch.bfloat16))
    np.testing.assert_allclose(float(tl(tparams, batch)),
                               float(jl(jvars, batch)), rtol=2e-2)


def test_runner_matches_jax_three_steps_and_holds_batch_stats():
    jl, jvars, batch, tl, tparams, _, _ = _setups("bottleneck")
    batches = _batches(STEPS, seed=5)
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                           resource_spec=JSpec.from_dict(ONE_DEVICE))
        runner = ad.build(jl, optax.adam(LR), jvars, batch)
        runner.init(jvars)
        jlosses = [float(runner.run(b)["loss"]) for b in batches]
        jfinal = params_from_jax(jax.tree_util.tree_map(
            np.asarray, runner.gather_params()))
        jmu = params_from_jax(jax.tree_util.tree_map(
            np.asarray, runner.state.opt_state[0].mu))
    finally:
        jadt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    trunner = ad.build(tl, functools.partial(torch.optim.Adam, lr=LR),
                       tparams, batch)
    trunner.init(tparams)
    losses = [float(trunner.run(b)["loss"]) for b in batches]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=1e-5)
    final = trunner.gather_params()
    item = trunner.distributed_step.model_item
    stats = [n for n in final if n.startswith(BATCH_STATS_PREFIX)]
    assert stats and not any(item.var_infos[n].trainable for n in stats)
    for name, value in final.items():
        if name in stats:
            assert torch.equal(value, tparams[name]), name
            assert torch.equal(jfinal[name], tparams[name]), name
            assert float(trunner.state.opt_state["mu"][name].abs().max()) \
                == 0.0 == float(trunner.state.opt_state["nu"][name].abs()
                                .max()) == float(jmu[name].abs().max())
        else:
            assert not torch.equal(value, tparams[name]), name
            np.testing.assert_allclose(value.numpy(), jfinal[name].numpy(),
                                       atol=1e-4, rtol=0, err_msg=name)


def test_params_from_jax_conv_and_batchnorm_leaves():
    rng = np.random.RandomState(0)
    kernel = rng.randn(3, 5, 2, 4).astype(np.float32)       # HWIO
    tree = {"params": {"blk": {"Conv_0": {"kernel": kernel},
                               "BatchNorm_0": {"scale": np.ones(4, np.float32),
                                               "bias": np.zeros(4,
                                                                np.float32)}}},
            "batch_stats": {"blk": {"BatchNorm_0": {
                "mean": np.full(4, 0.5, np.float32),
                "var": np.full(4, 2.0, np.float32)}}}}
    out = params_from_jax(tree)
    assert sorted(out) == ["batch_stats.blk.BatchNorm_0.mean",
                           "batch_stats.blk.BatchNorm_0.var",
                           "blk.BatchNorm_0.bias", "blk.BatchNorm_0.weight",
                           "blk.Conv_0.weight"]
    w = out["blk.Conv_0.weight"]
    assert tuple(w.shape) == (4, 2, 3, 5)                   # OIHW
    for o, i, h, x in ((0, 0, 0, 0), (3, 1, 2, 4), (1, 0, 2, 3)):
        assert float(w[o, i, h, x]) == float(kernel[h, x, i, o])
    # back to HWIO, bit for bit
    assert np.array_equal(w.numpy().transpose(2, 3, 1, 0), kernel)
    assert float(out["batch_stats.blk.BatchNorm_0.var"][0]) == 2.0
    # the params subtree alone converts as before
    assert sorted(params_from_jax(tree["params"])) == sorted(
        n for n in out if not n.startswith(BATCH_STATS_PREFIX))


@pytest.mark.parametrize("tree,match", [
    ({"params": {"m": {"gamma": np.ones(2)}}}, "m/gamma"),
    ({"params": {"m": {"mean": np.ones(2)}}}, "m/mean"),
    ({"params": {}, "batch_stats": {"m": {"scale": np.ones(2)}}},
     "batch_stats/m/scale"),
    ({"params": {}, "cache": {"m": {"k": np.ones(2)}}}, "cache"),
    ({"params": {"m": {"kernel": np.ones((1, 1, 1, 1, 1))}}}, "rank 5"),
])
def test_params_from_jax_raises_on_a_leaf_without_a_rule(tree, match):
    with pytest.raises(ValueError, match=match):
        params_from_jax(tree)


def test_same_padding_is_flax_s():
    """flax "SAME": the odd pixel goes after."""
    assert tresnet.same_pads(56, 3, 2) == (0, 1)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)
    assert tresnet.same_pads(56, 3, 1) == (1, 1)
    assert tresnet.same_pads(57, 3, 2) == (1, 1)
    assert tresnet.same_pads(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("name", sorted(models.REGISTRY))
def test_registry_builds_each_model(name, monkeypatch):
    """Each registered name builds at full width (small batches, and small
    images for the CNNs) and its loss is finite on its example batch.
    bert_large's 366M-parameter init (20 s and 3 GB on a CPU) is left out:
    its entry is checked for the config it passes, and the model for its
    size."""
    kw = {"resnet18": dict(image_size=32, batch_size=2),
          "resnet50": dict(image_size=32, batch_size=2),
          "resnet101": dict(image_size=32, batch_size=2),
          "vgg16": dict(image_size=32, batch_size=2),
          "inceptionv3": dict(image_size=75, batch_size=2),
          "densenet121": dict(image_size=32, batch_size=2),
          "bert_base": dict(seq_len=16, batch_size=2),
          "lm": dict(seq_len=16, batch_size=2)}
    if name == "bert_large":
        from autodist_tpu_torch.models import bert
        seen = {}
        monkeypatch.setattr(bert, "make_train_setup",
                            lambda cfg, **kw: seen.update(cfg=cfg, **kw))
        models.make_train_setup(name, dtype=torch.bfloat16, seq_len=16)
        assert seen == {"cfg": bert.BertConfig.large(dtype=torch.bfloat16),
                        "seq_len": 16}
        model = bert.make_model(seen["cfg"])
        assert sum(p.numel() for p in model.parameters()) == 366_428_986
        return
    loss_fn, params, batch, apply_fn = models.make_train_setup(name,
                                                               **kw[name])
    assert all(t.dtype == torch.float32 for t in params.values())
    assert np.isfinite(float(loss_fn(params, batch)))


def test_registry_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown model"):
        models.make_train_setup("ncf")
