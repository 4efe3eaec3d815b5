"""autodist_tpu_torch's bf16 compute tier (``graph_config.compute_dtype``)
and remat (``strategy.WithRemat``, ``graph_config.remat``) at every
replica count, against the JAX package's, on the CPU.

- One replica (the fault this file pins: the lowering once read neither
  field at N = 1): lm tiny with flash attention (the kernels' plain
  versions) under ``AllReduce(compute_dtype="bf16")`` gives the JAX
  runner's bf16-tier losses within 2e-2 relative (bf16 rounding in two
  frameworks), differs from the port's f32 run, and keeps f32 masters.
- N = 2: two gloo ranks (one 2-rank job of ``tests/torch_dist_worker.py``)
  against the JAX runner on 2 virtual CPU devices under the bf16 tier:
  losses within 2e-2 relative; the ranks bit-equal. Remat ("full" and
  "dots") at N = 2 is bit-equal to the plain plan.
- Remat at one replica is bit-equal to the plain plan, as the JAX
  package's ``tests/test_remat.py`` holds its own: losses and params, for
  lm tiny (flash) and bert tiny, under "full" and "dots", each
  transformer layer checkpointed on its own every step; a user's module
  that sets ``recompute_unit`` is one too; a loss with no unit is
  checkpointed whole, with a warning; a loss the units' fake-tensor probe
  cannot run raises; the plan serializes ``remat`` to the JAX builder's
  bytes.
- A fused k = 4 loop under the tier and under remat equals the per-step
  loop bit for bit at N = 1.
"""
import functools
import json

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as jstrategy
from autodist_tpu.model_item import VarInfo as JVarInfo
from autodist_tpu.models import lm as jlm
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.model_item import VarInfo
from autodist_tpu_torch.models import bert as tbert
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import remat
from torch_dist_worker import LR, launch

STEPS = 3
LM_SEQ, LM_BATCH = 16, 8
ONE = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}


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


def _batches(seed=1, n=STEPS):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, 128, (LM_BATCH, LM_SEQ + 1)).astype(
        np.int32)} for _ in range(n)]


def _jax_lm(spec, compute_dtype):
    loss_fn, jparams, example, _ = jlm.make_train_setup(
        jlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=LM_BATCH,
        attention="flash", lean_head=True)
    init = {n: t.numpy() for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce(
            compute_dtype=compute_dtype), resource_spec=JSpec.from_dict(spec))
        runner = ad.build(loss_fn, optax.adam(LR), jparams, example)
        runner.init(jparams)
        losses = [float(runner.run(b)["loss"]) for b in _batches()]
    finally:
        jadt.reset()
    return init, losses


def _port_lm(builder, init, batches=None, fuse=0):
    loss_fn, _, example, _ = tlm.make_train_setup(
        tlm.LMConfig.tiny(), seq_len=LM_SEQ, batch_size=LM_BATCH,
        attention="flash", lean_head=True)
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      init, example)
    runner.init(init)
    batches = batches or _batches()
    if fuse:
        losses = [float(m["loss"]) for m in runner.fit(iter(batches),
                                                       fuse_steps=fuse)]
    else:
        losses = [float(runner.run(b)["loss"]) for b in batches]
    out = (losses, runner.gather_params(), runner.distributed_step)
    adt.reset()
    return out


def test_bf16_tier_at_one_replica_is_the_jax_tier():
    init, want = _jax_lm(ONE, "bf16")
    got, params, dstep = _port_lm(strategy.AllReduce(compute_dtype="bf16"),
                                  init)
    f32, _, _ = _port_lm(strategy.AllReduce(), init)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)
    assert all(a != b for a, b in zip(got, f32)), (got, f32)
    assert dstep.metadata["compute_dtype"] == "bf16"
    assert all(t.dtype == torch.float32 for t in params.values())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    init, want = _jax_lm(TWO, "bf16")
    base = {"model": "lm", "seq_len": LM_SEQ, "batch_size": LM_BATCH,
            "attention": "flash", "init": init, "batches": _batches()}
    payload = [dict(base, strategy={"compute_dtype": "bf16"}),
               dict(base), dict(base, remat="full"), dict(base, remat="dots")]
    ranks = launch("train", 2, tmp_path_factory.mktemp("tier"), payload)
    return want, ranks


def test_bf16_tier_at_two_ranks_is_the_jax_tier(two_ranks):
    want, ranks = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r[0]["losses"], want, rtol=2e-2, atol=0)
        assert r[0]["losses"] != r[1]["losses"]
        assert r[0]["metadata"]["compute_dtype"] == "bf16"
    for name, value in ranks[0][0]["params"].items():
        assert value.dtype == np.float32
        assert np.array_equal(value, ranks[1][0]["params"][name]), name


@pytest.mark.parametrize("policy", [2, 3], ids=["full", "dots"])
def test_remat_at_two_ranks_is_bit_equal_to_plain(two_ranks, policy):
    _, ranks = two_ranks
    for r in ranks:
        assert r[policy]["losses"] == r[1]["losses"]
        assert r[policy]["metadata"]["remat"] in ("full", "dots")
        for name, value in r[1]["params"].items():
            assert np.array_equal(r[policy]["params"][name], value), name


def test_with_remat_plan_bytes_match_jax():
    class _Item:
        def __init__(self, infos):
            self.var_infos = {i.name: i for i in infos}
            self.trainable_var_names = [i.name for i in infos]
    vars_ = [("dense/kernel", (64, 64)), ("dense/bias", (64,))]
    jplan = jstrategy.WithRemat(jstrategy.ZeroSharded(), "dots").build(
        _Item([JVarInfo(n, s, "float32") for n, s in vars_]),
        JSpec.from_dict(TWO))
    tplan = strategy.WithRemat(strategy.ZeroSharded(), "dots").build(
        _Item([VarInfo(n, s, "float32") for n, s in vars_]),
        ResourceSpec.from_dict(TWO))
    tplan.id = jplan.id
    dump = lambda p: json.dumps(p.to_dict(), sort_keys=True)  # noqa: E731
    assert dump(tplan) == dump(jplan)
    assert tplan.graph_config.remat == "dots"
    with pytest.raises(ValueError, match="remat policy"):
        strategy.WithRemat(strategy.AllReduce(), policy="everything")


def _bert(builder):
    loss_fn, params, batch, _ = tbert.make_train_setup(
        tbert.BertConfig.tiny(), seq_len=32, batch_size=4, attention="xla")
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      params, batch)
    runner.init(params)
    losses = [float(runner.run(batch)["loss"]) for _ in range(STEPS)]
    out = (losses, runner.gather_params(), runner.distributed_step)
    adt.reset()
    return out


@pytest.mark.parametrize("model", ["lm", "bert"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_plain_exactly_at_one_replica(model, policy,
                                                    monkeypatch):
    if model == "lm":
        init = tlm.make_train_setup(tlm.LMConfig.tiny(), seq_len=LM_SEQ,
                                    batch_size=LM_BATCH)[1]
        run = functools.partial(_port_lm, init=dict(init))
    else:
        run = _bert
    l0, p0, _ = run(strategy.AllReduce())
    units = _count_checkpoints(monkeypatch)
    l1, p1, dstep = run(strategy.WithRemat(strategy.AllReduce(), policy))
    assert dstep.remat == policy and dstep.metadata["remat"] == policy
    # each transformer layer is its own recompute unit, every step
    assert len(units) == STEPS * 2 and all(u.__name__ == "run"
                                           for u in units)
    assert l0 == l1
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


@pytest.mark.parametrize("builder", [
    strategy.AllReduce(compute_dtype="bf16"),
    strategy.WithRemat(strategy.AllReduce(), "full")], ids=["bf16", "remat"])
def test_fused_k4_matches_per_step_under_tier_and_remat(builder):
    init = dict(tlm.make_train_setup(tlm.LMConfig.tiny(), seq_len=LM_SEQ,
                                     batch_size=LM_BATCH)[1])
    batches = _batches(seed=5, n=8)
    per_step, p0, _ = _port_lm(builder, init, batches)
    fused, p1, dstep = _port_lm(builder, init, batches, fuse=4)
    assert dstep.dispatches == 2
    assert fused == per_step
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def _regression(builder, loss_fn, steps=3):
    """``steps`` Adam steps of a 4x3 regression on one fixed batch:
    (losses, the learned ``w``)."""
    rng = np.random.RandomState(0)
    params = {"w": torch.as_tensor(rng.randn(4, 3).astype(np.float32))}
    batch = {"x": rng.randn(8, 4).astype(np.float32),
             "y": rng.randn(8, 3).astype(np.float32)}
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    try:
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=0.1), params, batch)
        runner.init(params)
        out = [float(runner.run(batch)["loss"]) for _ in range(steps)]
        return out, runner.gather_params()["w"]
    finally:
        adt.reset()


def _count_checkpoints(monkeypatch):
    units = []
    real = remat._checkpoint
    monkeypatch.setattr(remat, "_checkpoint",
                        lambda *a, **k: units.append(a[1]) or real(*a, **k))
    return units


def test_a_loss_without_blocks_is_checkpointed_whole(monkeypatch):
    """A loss that calls no recompute unit (here a plain regression) runs
    as one recompute unit, from the first step, bit-equal to plain, and
    the lowering warns that this saves no memory."""
    def loss_fn(p, b):
        return ((torch.tanh(torch.as_tensor(b["x"]) @ p["w"])
                 - torch.as_tensor(b["y"])) ** 2).mean()
    units = _count_checkpoints(monkeypatch)
    warned = []
    monkeypatch.setattr(remat.logging, "warning",
                        lambda msg, *a: warned.append(msg % a))
    plain = _regression(strategy.AllReduce(), loss_fn)
    assert units == [] and warned == []
    full = _regression(strategy.WithRemat(strategy.AllReduce(), "full"),
                       loss_fn)
    assert plain[0] == full[0] and torch.equal(plain[1], full[1])
    assert len(units) == 3 and units[0] is loss_fn
    assert len(warned) == 1 and "saves no memory" in warned[0]


def test_a_users_own_recompute_unit_is_checkpointed(monkeypatch):
    """A user's module that sets ``recompute_unit`` is checkpointed on its
    own, once a call, with its parameters bound again in the backward:
    bit-equal to plain."""
    class Layer(torch.nn.Module):
        recompute_unit = True

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(4, 3))

        def forward(self, x):
            return torch.tanh(x @ self.w)
    layer = Layer()

    def loss_fn(p, b):
        out = torch.func.functional_call(layer, {"w": p["w"]},
                                         (torch.as_tensor(b["x"]),))
        return ((out - torch.as_tensor(b["y"])) ** 2).mean()
    plain = _regression(strategy.AllReduce(), loss_fn)
    units = _count_checkpoints(monkeypatch)
    dots = _regression(strategy.WithRemat(strategy.AllReduce(), "dots"),
                       loss_fn)
    assert plain[0] == dots[0] and torch.equal(plain[1], dots[1])
    assert len(units) == 3 and all(u.__name__ == "run" for u in units)
    assert "forward" not in vars(layer)


def test_a_loss_the_unit_probe_cannot_run_raises():
    """The units are found by running the loss on fake tensors; a loss
    that reads a value on the host cannot run there, and remat refuses it
    rather than guess."""
    def loss_fn(p, b):
        w = p["w"] * (1.0 if float(p["w"].detach().sum()) > 0 else -1.0)
        return ((torch.as_tensor(b["x"]) @ w) ** 2).mean()
    _regression(strategy.AllReduce(), loss_fn, steps=1)
    from torch._subclasses.fake_tensor import DataDependentOutputException
    with pytest.raises(DataDependentOutputException):
        _regression(strategy.WithRemat(strategy.AllReduce(), "full"),
                    loss_fn, steps=1)
