"""autodist_tpu_torch's BERT (masked LM) vs the JAX package's, on the same
parameters (the JAX init, converted with ``convert.params_from_jax``) and
the same numpy batches.

float32 on the CPU at ``BertConfig.tiny()``, seq 32, batch 4:

- logits and loss within 1e-5, grads within rtol 1e-4 / atol 1e-5, for
  the plain ("xla") attention with the all-ones mask and with a ragged
  padding mask, and for flash attention with the ragged mask (the port
  through the plain versions of its three kernels, the JAX package
  through its Pallas kernels in interpret mode);
- the port's flash and plain paths against each other on real tokens
  (``mlm_weights`` times the mask), at the JAX package's own bound for
  that comparison (tests/test_models.py): loss 2e-5, grads rtol 5e-3 /
  atol 2e-4;
- a bf16 loss within 2e-2 of the JAX bf16 loss (bf16 residual stream in
  both; 8 mantissa bits);
- three ``Runner.run`` Adam steps against three JAX AllReduce steps
  (losses 1e-5). The JAX runner is given a one-device resource spec: the
  MLM loss divides by the batch's weight sum, so the mean of per-device
  losses over the test run's 8 virtual CPU devices would be another
  function;
- the AllReduce plan's JSON bytes against the JAX plan for the same
  variable list.
"""
import functools

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.model_item import VarInfo as JVarInfo
from autodist_tpu.models import bert as jbert
from autodist_tpu.ops import flash_attention as jfa
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import bert as tbert
from autodist_tpu_torch.models.layers import apply
from autodist_tpu_torch.ops import flash_attention as tfa
from autodist_tpu_torch.resource_spec import ResourceSpec

SEQ, BATCH, LR, STEPS = 32, 4, 1e-3, 3
ONE_DEVICE = {"nodes": [{"address": "127.0.0.1", "chief": True,
                         "cpus": [0]}]}


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


def _ragged(batch, seed):
    """The batch with key-padding lengths from ``seed`` in [SEQ/2, SEQ]
    (row 0 unpadded) and ``mlm_weights`` on real tokens only."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(SEQ // 2, SEQ + 1, BATCH)
    lengths[0] = SEQ
    mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int32)
    out = dict(batch)
    out["attention_mask"] = mask
    out["mlm_weights"] = batch["mlm_weights"] * mask
    return out


def _batches(cfg, n, seed):
    """``n`` ragged batches of fresh ids and labels."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        shape = (BATCH, SEQ)
        out.append(_ragged({
            "input_ids": rng.randint(0, cfg.vocab_size, shape).astype(
                np.int32),
            "token_type_ids": rng.randint(0, 2, shape).astype(np.int32),
            "attention_mask": np.ones(shape, np.int32),
            "labels": rng.randint(0, cfg.vocab_size, shape).astype(np.int32),
            "mlm_weights": (rng.rand(*shape) < 0.3).astype(np.float32),
        }, seed + i))
    return out


@pytest.fixture(scope="module")
def jax_init():
    """The JAX tiny init (numpy), its converted port params and its example
    batch."""
    _, jparams, batch, _ = jbert.make_train_setup(
        jbert.BertConfig.tiny(), seq_len=SEQ, batch_size=BATCH,
        attention="xla")
    jnp_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jnp_params, params_from_jax(jnp_params), batch


def _setups(attention, dtype=None):
    kw = {} if dtype is None else {"dtype": dtype[0]}
    jl, _, _, _ = jbert.make_train_setup(
        jbert.BertConfig.tiny(**kw), seq_len=SEQ, batch_size=BATCH,
        attention=attention)
    kw = {} if dtype is None else {"dtype": dtype[1]}
    tl, _, _, _ = tbert.make_train_setup(
        tbert.BertConfig.tiny(**kw), seq_len=SEQ, batch_size=BATCH,
        attention=attention)
    return jl, tl


def _port_loss_and_grads(loss_fn, params, batch):
    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def test_conversion_covers_every_parameter(jax_init):
    _, tparams, _ = jax_init
    model = tbert.make_model(tbert.BertConfig.tiny())
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in tparams.items()}
    assert all(t.dtype == torch.float32 for t in tparams.values())
    init = tbert.init_params(tbert.BertConfig.tiny(), seed=0)
    assert {n: tuple(t.shape) for n, t in init.items()} == shapes


def test_bert_base_parameter_shapes_match_jax():
    """Full width, abstractly: every converted JAX bert_base parameter has
    the port's shape (no weights are materialized)."""
    cfg = jbert.BertConfig.base()
    model = jbert.BertForMLM(cfg)
    ids = jax.ShapeDtypeStruct((1, 128), np.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), ids, ids,
                            ids)
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    converted = {n: tuple(t.shape) for n, t in params_from_jax(zeros).items()}
    tmodel = tbert.make_model(tbert.BertConfig.base())
    assert converted == {n: tuple(p.shape)
                         for n, p in tmodel.named_parameters()}
    assert sum(int(np.prod(s)) for s in converted.values()) == 132_955_194


@pytest.mark.parametrize("attention,ragged", [("xla", False), ("xla", True),
                                              ("flash", True)])
def test_logits_loss_and_grads_match_jax(jax_init, attention, ragged):
    jparams, tparams, batch = jax_init
    if ragged:
        batch = _ragged(batch, seed=7)
    jl, tl = _setups(attention)
    jattn, tattn = None, None
    if attention == "flash":
        jattn = jfa.make_flash_attn_fn(causal=False)
        tattn = tfa.make_flash_attn_fn(causal=False)
    jmodel = jbert.BertForMLM(jbert.BertConfig.tiny(), attn_fn=jattn)
    tmodel = tbert.make_model(tbert.BertConfig.tiny(), attn_fn=tattn)
    args = [batch[k] for k in ("input_ids", "token_type_ids",
                               "attention_mask")]
    jlogits = np.asarray(jmodel.apply(jparams, *args))
    tlogits = apply(tmodel, tparams, *(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=1e-5,
                               rtol=1e-5)
    jloss, jgrads = jax.value_and_grad(jl)(jparams, batch)
    tloss, tgrads = _port_loss_and_grads(tl, tparams, batch)
    np.testing.assert_allclose(tloss, float(jloss), atol=1e-5, rtol=1e-5)
    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert jgrads.keys() == tgrads.keys()
    for name, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_flash_matches_plain_attention_on_real_tokens(jax_init):
    """The port's two attention paths give the same loss and grads when the
    loss weighs real tokens only (padded query rows differ by design)."""
    _, tparams, batch = jax_init
    batch = _ragged(batch, seed=8)
    assert batch["attention_mask"].min() == 0
    _, flash = _setups("flash")
    _, plain = _setups("xla")
    lf, gf = _port_loss_and_grads(flash, tparams, batch)
    lp, gp = _port_loss_and_grads(plain, tparams, batch)
    np.testing.assert_allclose(lf, lp, rtol=2e-5, atol=2e-5)
    for name in gf:
        np.testing.assert_allclose(gf[name].numpy(), gp[name].numpy(),
                                   rtol=5e-3, atol=2e-4, err_msg=name)


def test_bf16_loss_matches_jax(jax_init):
    """bf16 compute (bf16 residual stream, f32 ``mlm_output`` and loss) in
    both packages from the same f32 params."""
    import jax.numpy as jnp
    jparams, tparams, batch = jax_init
    jl, tl = _setups("xla", dtype=(jnp.bfloat16, torch.bfloat16))
    jloss = float(jl(jparams, batch))
    tloss = float(tl(tparams, batch))
    np.testing.assert_allclose(tloss, jloss, rtol=2e-2)


def test_runner_matches_jax_three_steps(jax_init):
    """Three port ``Runner.run`` steps (flash attention through the plain
    kernel versions, ragged padding) equal three JAX AllReduce steps."""
    jparams, tparams, batch = jax_init
    cfg = tbert.BertConfig.tiny()
    batches = _batches(cfg, STEPS, seed=11)
    jl, tl = _setups("flash")
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(),
                           resource_spec=JSpec.from_dict(ONE_DEVICE))
        runner = ad.build(jl, optax.adam(LR), jparams, batch)
        runner.init(jparams)
        jlosses = [float(runner.run(b)["loss"]) for b in batches]
    finally:
        jadt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    trunner = ad.build(tl, functools.partial(torch.optim.Adam, lr=LR),
                       tparams, batch)
    trunner.init(tparams)
    losses = [float(trunner.run(b)["loss"]) for b in batches]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=1e-5)
    final = trunner.gather_params()
    assert all(not torch.equal(final[n], tparams[n]) for n in final)


def test_allreduce_plan_bytes_match_jax(jax_init):
    """The port's AllReduce plan for BERT's variables (as its ModelItem
    lists them) serializes to the JAX plan's bytes for the same list."""
    import json
    from autodist_tpu.strategy.all_reduce_strategy import AllReduce as JAR
    _, tparams, batch = jax_init
    _, tl = _setups("flash")
    item = adt.ModelItem(loss_fn=tl, params=tparams,
                         example_batch=batch).prepare()
    infos = list(item.var_infos.values())

    class _Item:
        def __init__(self, var_infos):
            self.var_infos = {i.name: i for i in var_infos}
            self.trainable_var_names = [i.name for i in var_infos
                                        if i.trainable]
    jitem = _Item([JVarInfo(i.name, i.shape, i.dtype, i.trainable)
                   for i in infos])
    jplan = JAR().build(jitem, JSpec.from_dict(ONE_DEVICE))
    tplan = strategy.AllReduce().build(_Item(infos),
                                       ResourceSpec.from_dict(ONE_DEVICE))
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    assert len(tplan.node_config) == len(tparams)


def test_attention_choices():
    with pytest.raises(ValueError, match="attention"):
        tbert.make_train_setup(tbert.BertConfig.tiny(), seq_len=SEQ,
                               batch_size=2, attention="default")
    for attention in ("auto", "xla"):
        loss_fn, params, batch, apply_fn = tbert.make_train_setup(
            tbert.BertConfig.tiny(), seq_len=SEQ, batch_size=2,
            attention=attention)
        assert np.isfinite(float(loss_fn(params, batch)))
        assert apply_fn(params, batch["input_ids"]).shape == (2, SEQ, 128)
