"""Fused supersteps with host-PS variables (the device-resident PS carry,
``DistributedStep.multi_step``/``run_multi``) against the JAX package's
fused program, on the CPU.

- The matrix of ``tests/test_fused.py``: ``fit(fuse_steps=4,
  metrics_every=2)`` over 8 batches of NCF tiny and DLRM tiny (the JAX
  init converted) under ``PS()``, ``UnevenPartitionedPS()`` and
  ``Parallax()``, against the JAX runner on one device: per-microstep
  losses, params, the optimizer state (as the JAX saver flattens it) and
  the store's counters (one pull of the carry, one write-back of it),
  and the port's own per-step loop.
- The int8 PS wire emulated inside the microsteps, against the JAX fused
  program on ``tests/test_quantized_wire.py``'s problem, at its bounds.
- The refusals of ``tests/test_fused.py``: a stale store and an async
  one raise the JAX ``ValueError``.
- The carry is written back wherever the store is read: ``close()``, a
  per-step ``run`` after supersteps, a save (which the JAX package
  restores), and at N = 2 over gloo against the JAX fused program on 2
  virtual devices (one 2-rank job for every case).
- The store's halves of the carry (``full_little_opt``,
  ``absorb_device_state``) against the JAX store's.

Bounds: losses within 1e-5 relative, params and optimizer state within
1e-6 absolute (the Adam tests' bounds, ``tests/test_torch_recsys.py``),
the counters equal; the int8 wire's fused losses within ``rtol=1e-4,
atol=1e-5`` of the JAX fused program's (``tests/test_quantized_wire.py``).
On the CPU the fused microsteps are the per-step arithmetic, so fused
and per step agree within 1e-6 (the densify of the (ids, values) pairs
runs on the device, in a scatter-add, instead of ``np.add.at``).
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
from autodist_tpu.checkpoint.saver import Saver as JSaver
from autodist_tpu.checkpoint.saver import _tree_to_flat
from autodist_tpu.models import dlrm as jdlrm
from autodist_tpu.models import ncf as jncf
from autodist_tpu.parallel import ps as jps
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import convert, optim, strategy
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.models import dlrm as tdlrm
from autodist_tpu_torch.models import ncf as tncf
from autodist_tpu_torch.parallel import ps as tps
from autodist_tpu_torch.resource_spec import ResourceSpec
from torch_dist_worker import LR, launch

K, N_BATCHES, BATCH = 4, 8, 8
LOSS_RTOL, ATOL = 1e-5, 1e-6
ONE = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]}
TWO = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]}
MODELS = {"ncf": (jncf, tncf, "NCFConfig"), "dlrm": (jdlrm, tdlrm,
                                                     "DLRMConfig")}
BUILDERS = ("PS", "UnevenPartitionedPS", "Parallax")
CASES = [(m, b) for m in MODELS for b in BUILDERS]
IDS = ["%s-%s" % c for c in CASES]
STATS = ("pulls", "pushes", "applies", "bytes_pulled", "bytes_pushed")


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


def _setup(model, n=N_BATCHES):
    jmod, tmod, cfg = MODELS[model]
    jl, jp, example, _ = jmod.make_train_setup(getattr(jmod, cfg).tiny(),
                                               batch_size=BATCH)
    tl = tmod.make_train_setup(getattr(tmod, cfg).tiny(),
                               batch_size=BATCH)[0]
    batches = [tmod.make_train_setup(getattr(tmod, cfg).tiny(),
                                     batch_size=BATCH, seed=s)[2]
               for s in range(1, n + 1)]
    init = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jl, jp, tl, init, example, batches


def _jax_fused(model, builder, spec=ONE):
    """The JAX runner's evaluate, then fit(fuse_steps=4, metrics_every=2)
    over the batches: losses, params, the flattened optimizer state, the
    store's counters and the dispatches."""
    jl, jp, _, _, example, batches = _setup(model)
    try:
        ad = jadt.AutoDist(strategy_builder=getattr(jstrategy, builder)(),
                           resource_spec=JSpec.from_dict(spec))
        runner = ad.build(jl, optax.adam(LR), jp, example)
        runner.init(jp)
        ev = float(runner.evaluate(batches[:1])["loss"])
        hist = runner.fit(iter(batches), fuse_steps=K, metrics_every=2)
        dstep = runner.distributed_step
        out = {"eval": ev, "losses": [float(m["loss"]) for m in hist],
               "params": {n: t.numpy() for n, t in convert.params_from_jax(
                   jax.tree_util.tree_map(np.asarray,
                                          runner.gather_params())).items()},
               "opt": {k: np.asarray(v) for k, v in _tree_to_flat(
                   dstep.gather_opt_state(runner.state)).items()},
               "stats": {k: dstep.ps_store.stats[k] for k in STATS},
               "dispatches": dstep.dispatches}
    finally:
        jadt.reset()
    return out


def _port(model, builder, fuse=K, spec=ONE, **build_kw):
    _, _, tl, init, example, batches = _setup(model)
    ad = adt.AutoDist(strategy_builder=getattr(strategy, builder)(
        **build_kw), resource_spec=ResourceSpec.from_dict(spec),
        device="cpu")
    runner = ad.build(tl, functools.partial(torch.optim.Adam, lr=LR), init,
                      example)
    runner.init(init)
    return runner, batches


def _port_fused(model, builder, fuse=K):
    runner, batches = _port(model, builder)
    ev = float(runner.evaluate(batches[:1])["loss"])
    hist = runner.fit(iter(batches), fuse_steps=fuse, metrics_every=2)
    dstep = runner.distributed_step
    item = dstep.model_item
    out = {"eval": ev, "losses": [float(m["loss"]) for m in hist],
           "params": {n: t.numpy() for n, t in
                      runner.gather_params().items()},
           "opt": convert.opt_state_to_jax(
               dstep.gather_opt_state(runner.state), item.flax_shapes,
               item.optimizer_spec),
           "stats": {k: dstep.ps_store.stats[k] for k in STATS},
           "dispatches": dstep.dispatches}
    adt.reset()
    return out


def _check(got, want, stats=True):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=LOSS_RTOL)
    for name, value in want["params"].items():
        np.testing.assert_allclose(got["params"][name], value, atol=ATOL,
                                   rtol=0, err_msg=name)
    assert sorted(got["opt"]) == sorted(want["opt"])
    for key, value in want["opt"].items():
        np.testing.assert_allclose(np.asarray(got["opt"][key]), value,
                                   atol=ATOL, rtol=0, err_msg=key)
    if stats:
        assert got["stats"] == want["stats"]


# ------------------------------------------------------------- the matrix


@pytest.fixture(scope="module")
def one_replica():
    return {case: (_jax_fused(*case), _port_fused(*case),
                   _port_fused(*case, fuse=1)) for case in CASES}


@pytest.mark.parametrize("model,builder", CASES, ids=IDS)
def test_fused_matches_the_jax_fused_program(one_replica, model, builder):
    want, got, per_step = one_replica[(model, builder)]
    _check(got, want)
    # one pull of the carry and one write-back, as in the JAX store
    assert got["stats"]["pulls"] == 2 and got["stats"]["pushes"] == 1
    assert got["dispatches"] == want["dispatches"] == N_BATCHES // K
    # and the port's own per-step loop, which pushes every step
    _check(got, per_step, stats=False)
    assert per_step["stats"]["pushes"] == N_BATCHES


def test_int8_wire_fused_matches_the_jax_fused_program():
    """``tests/test_quantized_wire.py``'s problem under ``PS(wire_dtype=
    "int8")``: the codec runs inside each fused microstep in the JAX
    element order, as in the JAX scan body."""
    rng = np.random.RandomState(5)
    params = {"w": (rng.randn(64, 8) * 0.1).astype(np.float32),
              "v": (rng.randn(8, 8) * 0.1).astype(np.float32)}
    batch = {"x": rng.randn(32, 64).astype(np.float32),
             "y": rng.randn(32, 8).astype(np.float32)}

    def jax_loss(p, b):
        return jnp.mean((jnp.tanh(b["x"] @ p["w"]) @ p["v"] - b["y"]) ** 2)

    def port_loss(p, b):
        x, y = torch.as_tensor(b["x"]), torch.as_tensor(b["y"])
        return ((torch.tanh(x @ p["w"]) @ p["v"] - y) ** 2).mean()
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.PS(wire_dtype="int8"),
                           resource_spec=JSpec.from_dict(ONE))
        jr = ad.build(jax_loss, optax.adam(0.05),
                      {k: jnp.asarray(v) for k, v in params.items()}, batch)
        jr.init({k: jnp.asarray(v) for k, v in params.items()})
        want = [float(m["loss"]) for m in jr.fit([batch] * 8, fuse_steps=K)]
    finally:
        jadt.reset()
    got = []
    for fuse in (K, 1):
        adt.reset()
        ad = adt.AutoDist(strategy_builder=strategy.PS(wire_dtype="int8"),
                          resource_spec=ResourceSpec.from_dict(ONE),
                          device="cpu")
        tp = {k: torch.as_tensor(v) for k, v in params.items()}
        r = ad.build(port_loss, functools.partial(torch.optim.Adam, lr=0.05),
                     tp, batch)
        r.init(tp)
        assert r.distributed_step.ps_store.wire_quant == ["w"]
        got.append([float(m["loss"]) for m in
                    r.fit([batch] * 8, fuse_steps=fuse)])
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0], got[1], rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------- refusals


def test_fused_refuses_a_stale_and_an_async_store():
    """A superstep emulates the store against its start snapshot, exact
    for a synchronous store only: the JAX ``ValueError`` for staleness >
    0 (``tests/test_fused.py``) and for ``sync=False``, whose plan the
    lowering refuses first (ROADMAP A item 8), so the async store is
    built here past that refusal."""
    from autodist_tpu_torch.kernel.graph_transformer import DistributedStep
    runner, batches = _port("ncf", "PS", staleness=2)
    stack = {k: np.stack([b[k] for b in batches[:2]]) for k in batches[0]}
    for call in (lambda: runner.run_superstep(stack),
                 lambda: runner.distributed_step.multi_step(2),
                 lambda: runner.fit(iter(batches), fuse_steps=2)):
        with pytest.raises(ValueError, match="fused multi-step requires "
                                             "synchronous host-PS"):
            call()
    assert runner.distributed_step.ps_store.stats["pulls"] == 0
    adt.reset()
    from autodist_tpu_torch.strategy.base import StrategyCompiler
    loss_fn, params, example, _ = tncf.make_train_setup(
        tncf.NCFConfig.tiny(), batch_size=BATCH)
    item = adt.ModelItem(loss_fn=loss_fn, params=params,
                         optimizer=torch.optim.Adam,
                         example_batch=example).prepare()
    spec = ResourceSpec.from_dict(ONE)
    plan = StrategyCompiler(item, spec).compile(
        strategy.PS(sync=False).build(item, spec))
    dstep = DistributedStep(strategy=plan, model_item=item, device="cpu")
    assert dstep.ps_store.any_async()
    with pytest.raises(ValueError, match="fused multi-step requires "
                                         "synchronous host-PS"):
        dstep.multi_step(2)


# ------------------------------------------------ where the carry lands


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def test_close_flushes_the_carry():
    """``tests/test_fused.py::test_close_flushes_fused_ps_carry``: a close
    right after supersteps lands the carry in the store."""
    runner, batches = _port("ncf", "PS")
    store = runner.distributed_step.ps_store
    before = store.full_values()
    runner.run_superstep(_stack(batches[:K]), sync=False)
    assert store.stats["pushes"] == 0      # the carry is on the device
    runner.close()
    assert store.stats["pushes"] == 1 and store.stats["applies"] == len(
        store.var_names)
    after = store.full_values()
    assert any(not torch.equal(before[n], after[n]) for n in before)


@pytest.mark.parametrize("builder", ["PS", "UnevenPartitionedPS"])
def test_a_step_after_supersteps_reads_the_carry(builder):
    """A per-step ``run`` after fused supersteps flushes the carry before
    its pull: the same losses and params as five steps per step."""
    runner, batches = _port("dlrm", builder)
    runner.fit(iter(batches[:K]), fuse_steps=K)
    fused = [float(runner.run(b)["loss"]) for b in batches[K:K + 2]]
    fused_params = runner.gather_params()
    adt.reset()
    runner, _ = _port("dlrm", builder)
    per = [float(runner.run(b)["loss"]) for b in batches[:K + 2]][K:]
    np.testing.assert_allclose(fused, per, rtol=1e-6, atol=0)
    for n, t in runner.gather_params().items():
        np.testing.assert_allclose(fused_params[n].numpy(), t.numpy(),
                                   atol=ATOL, rtol=0, err_msg=n)


def test_a_save_right_after_supersteps_restores_in_jax(tmp_path):
    """The save flushes the carry first: the JAX saver restores the
    port's files bit for bit, and they hold the supersteps' training."""
    runner, batches = _port("ncf", "UnevenPartitionedPS")
    runner.fit(iter(batches), fuse_steps=K)
    path = Saver(directory=str(tmp_path)).save(runner)
    dstep = runner.distributed_step
    item = dstep.model_item
    want_params = convert.params_to_jax(runner.gather_params(),
                                        item.flax_shapes)
    want_opt = convert.opt_state_to_jax(dstep.gather_opt_state(runner.state),
                                        item.flax_shapes, item.optimizer_spec)
    assert int(want_opt["0/count"]) == N_BATCHES
    adt.reset()
    jl, jp, _, _, example, _ = _setup("ncf")
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.UnevenPartitionedPS(),
                           resource_spec=JSpec.from_dict(ONE))
        jr = ad.build(jl, optax.adam(LR), jp, example)
        jr.init(jp)
        _, step = JSaver(directory=str(tmp_path)).restore(jr)
        params = _tree_to_flat(jr.gather_params())
        opt = _tree_to_flat(jr.distributed_step.gather_opt_state(jr.state))
    finally:
        jadt.reset()
    assert step == N_BATCHES and path.endswith("ckpt-%d" % N_BATCHES)
    for got, want in ((params, want_params), (opt, want_opt)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(np.asarray(got[k]), v), k


# ------------------------------------------------------------------ N = 2

TWO_CASES = [("ncf", "PS"), ("dlrm", "UnevenPartitionedPS"),
             ("dlrm", "Parallax")]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    want, payload = {}, []
    for model, builder in TWO_CASES:
        want[(model, builder)] = _jax_fused(model, builder, TWO)
        _, _, _, init, example, batches = _setup(model)
        payload.append({"model": model, "seq_len": 0, "batch_size": BATCH,
                        "attention": "", "builder": builder,
                        "fuse_steps": K, "example": example,
                        "init": {n: t.numpy() for n, t in init.items()},
                        "batches": batches})
    ranks = launch("train", 2, tmp_path_factory.mktemp("fused_ps"), payload)
    return {key: (want[key], [r[i] for r in ranks])
            for i, key in enumerate(TWO_CASES)}


@pytest.mark.parametrize("model,builder", TWO_CASES,
                         ids=["%s-%s" % c for c in TWO_CASES])
def test_two_ranks_fused_match_the_jax_fused_program(two_ranks, model,
                                                     builder):
    want, ranks = two_ranks[(model, builder)]
    for out in ranks:
        got = dict(out, opt=out["opt_jax"],
                   stats=dict(out["stats"], applies=out["ps_applies"]))
        _check(got, want)
        assert out["dispatches"] == N_BATCHES // K
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"] and r0["ps_digest"] == r1["ps_digest"]


# ------------------------------------------------------ the store's halves


def test_store_carry_halves_match_the_jax_store():
    """``full_little_opt`` assembles a full variable's state from uneven
    shards, and ``absorb_device_state`` splits it back with the JAX
    store's counters, for a chain whose state sits at ``1/0/``."""
    from test_torch_ps import _Info
    infos = {"w": _Info("w", (7, 3))}
    kw = dict(var_name="w", destinations=("h:CPU:0",) * 3,
              shard_sizes=(3, 2, 2))
    spec = optim.chain(optim.clip_by_global_norm(1.0), functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9))
    port = tps.PSStore({"w": tps.PSVarPlan(**kw)}, infos, spec)
    jstore = jps.PSStore({"w": jps.PSVarPlan(**kw)}, infos, optax.chain(
        optax.clip_by_global_norm(1.0), optax.sgd(0.1, momentum=0.9)))
    rng = np.random.RandomState(0)
    full = rng.randn(7, 3).astype(np.float32)
    port.init_params({"w": torch.from_numpy(full)})
    jstore.init_params({"w": full})
    g = rng.randn(7, 3).astype(np.float32)
    port.apply_local({"w": torch.from_numpy(g)})
    jstore.apply_local({"w": g})
    little = port.full_little_opt("w")
    jlittle = _tree_to_flat(jstore.full_little_opt("w"))
    assert sorted(jlittle) == ["1/0/trace/v"]
    np.testing.assert_allclose(little["trace"]["v"].numpy(),
                               jlittle["1/0/trace/v"], atol=1e-7)
    new_v = rng.randn(7, 3).astype(np.float32)
    new_t = rng.randn(7, 3).astype(np.float32)
    port.absorb_device_state({"w": torch.from_numpy(new_v)},
                             {"w": {"trace": {"v": torch.from_numpy(new_t)}}})
    jstore.absorb_device_state({"w": new_v}, {"w": (
        optax.EmptyState(), (optax.TraceState(trace={"v": new_t}),
                             optax.EmptyState()))})
    assert port.full_values()["w"].numpy().tolist() == new_v.tolist()
    assert [tuple(st["trace"]["v"].shape) for st in port._opt["w"]] == \
        [(3, 3), (2, 3), (2, 3)]
    assert torch.equal(port.full_opt_leaf("trace", "w"),
                       torch.from_numpy(new_t))
    for key in STATS:
        assert port.stats[key] == jstore.stats[key], key
