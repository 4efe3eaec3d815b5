"""autodist_tpu_torch's host-resident parameter server (``parallel/ps.py``)
and its lowering, against the JAX package, on the CPU.

- C6: a PS plan at one replica takes the host path. lm tiny under a
  builder that gives every variable ``PSSynchronizer(local_replication=
  False, staleness=s)``: at ``s = 0`` the store holds all 38 variables
  (none on the device, nor their moments), and an ``evaluate`` and 3
  Adam (1e-3) steps match the JAX runner on the same plan (one device);
  at ``s = 2`` the reads lag the applies by at most 2 (stale reads depend
  on timing, so they are not held to JAX value for value). On the tree
  before the port's PS family, the plan compiled and trained every
  variable on the device.
- The combinations once refused: ``sync=False`` now lowers at one
  replica a process and ``staleness > 0`` at N > 1 lowers too (their
  training is ``tests/test_torch_async_ps.py``'s); fused supersteps
  (``fit(fuse_steps=k)``, ``multi_step``) over a stale store stay
  refused with the JAX package's ``ValueError`` (fused supersteps over a
  synchronous store are ``tests/test_torch_fused_ps.py``'s).
- The pipeline (``PSPipeline``): exact mode ``torch.equal`` to the serial
  path (``ADT_PS_OVERLAP=0``), and a checkpoint taken with a push in
  flight equal to the serial one; the threaded apply
  (``ADT_PS_APPLY_THREADS``) bit-exact to one thread; ``Runner.evaluate``
  pulls once for its loop.
- Compute-then-swap: an apply replaces the values (a staged pull's
  tensors never change) with the in-place update's bits, and a pull
  during an apply returns at once with the version before it.
- The store's pieces against the JAX store: ragged (uneven) shards, the
  optimizer state rebuilt from a full layout and gathered back, the
  ``np.add.at`` densify of repeated ids bit for bit, and the mirror
  digest.
- ``AutoDist()`` with no builder compiles the JAX package's default plan
  (``PSLoadBalancing``), byte for byte.

Bounds of lm tiny against JAX: losses within 1e-5; params within 1e-4,
except the attention key biases, whose gradient is zero analytically, so
Adam turns its rounding noise into a step of up to lr: 2 x steps x lr
(``tests/test_torch_train.py``).
"""
import functools
import json
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import ncf as jncf
from autodist_tpu.parallel import ps as jps
from autodist_tpu.resource_spec import ResourceSpec as JSpec
from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.kernel.common.proxy_variable import ProxyVariable
from autodist_tpu_torch.models import dlrm as tdlrm
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.model_item import VarInfo
from autodist_tpu_torch.models import ncf as tncf
from autodist_tpu_torch.parallel import ps as tps
from autodist_tpu_torch.resource_spec import ResourceSpec

LR, STEPS = 1e-3, 3
ADAM = functools.partial(torch.optim.Adam, lr=LR)
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


def _all_ps(base, staleness=0, sync=True):
    """A builder (of the strategy module ``base``) that gives every
    trainable variable a host-resident PS synchronizer."""
    class AllPS(base.StrategyBuilder):
        def build(self, item, spec):
            nodes = [base.VarConfig(var_name=n, synchronizer=(
                base.PSSynchronizer(
                    reduction_destination="127.0.0.1:CPU:0",
                    local_replication=False, staleness=staleness,
                    sync=sync))) for n in item.trainable_var_names]
            return base.Strategy(node_config=nodes, graph_config=(
                base.GraphConfig(replicas=[d.name_string()
                                           for d in spec.devices])))
    return AllPS()


def _lm_batches(n=STEPS, seed=1):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, 128, (8, 17)).astype(np.int32)}
            for _ in range(n)]


def _lm_port(staleness=0, sync=True, spec=ONE):
    cfg = tlm.LMConfig.tiny()
    loss_fn, params, batch, _ = tlm.make_train_setup(cfg, seq_len=16,
                                                     batch_size=8)
    from autodist_tpu_torch.strategy import base
    ad = adt.AutoDist(strategy_builder=_all_ps(base, staleness, sync),
                      resource_spec=ResourceSpec.from_dict(spec),
                      device="cpu")
    return ad, loss_fn, params, batch


# ---------------------------------------------------------------------- C6


@pytest.fixture(scope="module")
def c6_jax():
    """The JAX runner on the all-PS plan, one device: the converted init,
    evaluate, 3 losses, final params and the store's counters."""
    from autodist_tpu.strategy import base as jbase
    loss_fn, jparams, batch, _ = jlm.make_train_setup(
        jlm.LMConfig.tiny(), seq_len=16, batch_size=8)
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    batches = _lm_batches()
    try:
        ad = jadt.AutoDist(strategy_builder=_all_ps(jbase),
                           resource_spec=JSpec.from_dict(ONE))
        runner = ad.build(loss_fn, optax.adam(LR), jparams, batch)
        runner.init(jparams)
        ev = float(runner.evaluate(batches[:1])["loss"])
        losses = [float(runner.run(b)["loss"]) for b in batches]
        final = params_from_jax(jax.tree_util.tree_map(
            np.asarray, runner.gather_params()))
        meta = runner.distributed_step.metadata
        stats = dict(runner.distributed_step.ps_store.stats)
        routed = (meta["ps_host_resident"], meta["sparse_wire"])
    finally:
        jadt.reset()
    return init, batch, batches, ev, losses, final, stats, routed


def test_c6_one_replica_ps_plan_trains_from_the_host_store(c6_jax):
    init, example, batches, jev, jlosses, jfinal, jstats, jrouted = c6_jax
    ad, loss_fn, _, _ = _lm_port()
    runner = ad.build(loss_fn, ADAM, init, example)
    runner.init(init)
    dstep = runner.distributed_step
    store = dstep.ps_store
    assert store is not None and len(store.var_names) == 38
    assert runner.state.params == {}
    assert runner.state.opt_state["mu"] == {} == runner.state.opt_state["nu"]
    ev = float(runner.evaluate(batches[:1])["loss"])
    losses = [float(runner.run(b)["loss"]) for b in batches]
    np.testing.assert_allclose(ev, jev, rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    final = runner.gather_params()
    for name, want in jfinal.items():
        tol = 2 * STEPS * LR if name.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(final[name].numpy(), want.numpy(),
                                   atol=tol, rtol=0, err_msg=name)
    infos = dstep.model_item.var_infos
    assert sorted(infos[n].collective_name for n in dstep.ps_names) == \
        jrouted[0]
    assert sorted(infos[n].collective_name for n in dstep.sparse_wire) == \
        jrouted[1]
    for key in ("pulls", "pushes", "bytes_pulled", "bytes_pushed"):
        assert store.stats[key] == jstats[key], key
    opt = dstep.gather_opt_state(runner.state)
    assert sorted(opt["mu"]) == store.var_names
    assert int(opt["count"]) == STEPS
    assert sorted(dstep.pull_ps()) == store.var_names


def test_c6_stale_plan_reads_lag_at_most_the_staleness():
    ad, loss_fn, params, batch = _lm_port(staleness=2)
    runner = ad.build(loss_fn, ADAM, params, batch)
    runner.init(params)
    dstep = runner.distributed_step
    assert len(dstep.ps_store.var_names) == 38
    assert dstep.metadata["staleness"] == 2
    losses = [float(runner.run(b)["loss"]) for b in _lm_batches(6)]
    assert all(np.isfinite(losses))
    lags = list(dstep.ps_read_lags)
    assert len(lags) == 6 and 0 <= min(lags) and max(lags) <= 2, lags
    # the applies all land: the store counts every push once flushed
    dstep.flush_ps()
    assert dstep.ps_store.stats["pushes"] == 6


# ---------------------------------------------------------------- refusals


def _refusal(case):
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.strategy.base import StrategyCompiler
    if case.startswith("fused"):
        ad, loss_fn, params, batch = _lm_port(staleness=2)
        runner = ad.build(loss_fn, ADAM, params, batch)
        runner.init(params)
        if case == "fused_fit":
            runner.fit([batch] * 4, fuse_steps=2)
        else:
            runner.distributed_step.multi_step(2)
        return
    stale, sync, n = {"async_one": (0, False, 1),
                      "async_two": (0, False, 2),
                      "stale_two": (2, True, 2)}[case]
    from autodist_tpu_torch.strategy import base
    cfg = tlm.LMConfig.tiny()
    loss_fn, params, batch, _ = tlm.make_train_setup(cfg, seq_len=16,
                                                     batch_size=4)
    item = ModelItem(loss_fn=loss_fn, params=params,
                     example_batch=batch).prepare()
    spec = ResourceSpec.from_dict(ONE if n == 1 else TWO)
    plan = StrategyCompiler(item, spec).compile(
        _all_ps(base, stale, sync).build(item, spec))
    return GraphTransformer(plan, item, "cpu",
                            ReplicaInfo(n, 0)).transform()


@pytest.mark.parametrize("case,item", [("async_one", 8), ("async_two", 8),
                                       ("stale_two", 8), ("fused_fit", 14),
                                       ("fused_multi_step", 14)])
def test_unreached_ps_combinations_raise_with_their_item(case, item):
    """The PS combinations the port once refused by their ROADMAP item.
    Item 8's first part (async PS, staleness at N > 1) is ported: an
    async plan lowers at one replica a process (``AutoDist`` builds it
    so), so a transform handed two ranks says the plan trains at one; a
    stale plan lowers at two replicas (the Runner paces it). Item 14
    ported the fused carry, and a stale store stays refused there, as the
    JAX package refuses it (tests/test_fused.py)."""
    if case.startswith("fused"):
        with pytest.raises(ValueError, match="fused multi-step requires "
                                             "synchronous host-PS"):
            _refusal(case)
        return
    if case == "async_two":
        with pytest.raises(ValueError, match="the plan has 1 replicas but "
                                             "the process group has 2"):
            _refusal(case)
        return
    dstep = _refusal(case)
    assert dstep.metadata["async"] == (case == "async_one")
    assert dstep.metadata["staleness"] == (2 if case == "stale_two" else 0)
    assert dstep.num_replicas == (1 if case == "async_one" else 2)
    assert len(dstep.ps_store.var_names) == 38


def test_proxied_ps_stays_on_the_device():
    assert ProxyVariable.plan("w", strategy.PSSynchronizer(
        local_replication=True)).cached
    assert not ProxyVariable.plan("w", strategy.PSSynchronizer()).cached
    loss_fn, params, batch, _ = tncf.make_train_setup(tncf.NCFConfig.tiny(),
                                                      batch_size=8)
    ad = adt.AutoDist(strategy_builder=strategy.PS(local_proxy_variable=True,
                                                   wire_dtype="int8"),
                      device="cpu")
    runner = ad.build(loss_fn, ADAM, params, batch)
    runner.init(params)
    assert runner.distributed_step.ps_store is None
    assert sorted(runner.state.params) == sorted(params)
    assert runner.distributed_step.pull_ps() == {}


# ---------------------------------------------------------------- pipeline


def _dlrm_run(builder, steps=6, **env):
    loss_fn, params, batch, _ = tdlrm.make_train_setup(
        tdlrm.DLRMConfig.tiny(), batch_size=8)
    batches = [tdlrm.make_train_setup(tdlrm.DLRMConfig.tiny(), batch_size=8,
                                      seed=s)[2] for s in range(1, steps + 1)]
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-2),
                      params, batch)
    runner.init(params)
    losses = [float(runner.run(b)["loss"]) for b in batches]
    return runner, losses


@pytest.mark.parametrize("knob,values", [
    ("ADT_PS_OVERLAP", ("0", "1")), ("ADT_PS_APPLY_THREADS", ("1", "4"))])
def test_pipeline_and_threaded_apply_are_bit_exact(monkeypatch, knob,
                                                   values):
    """The exact pipeline runs the serial path's calls in its order, and
    the thread pool groups shards without changing their arithmetic:
    losses and params ``torch.equal``."""
    got = []
    for v in values:
        monkeypatch.setenv(knob, v)
        runner, losses = _dlrm_run(strategy.PartitionedPS())
        dstep = runner.distributed_step
        if knob == "ADT_PS_OVERLAP":
            assert (dstep._ps_pipe is None) == (v == "0")
        else:
            dstep.flush_ps()
            assert dstep.ps_store._apply_threads == int(v)
            assert (dstep.ps_store._apply_pool is not None) == (v != "1")
        got.append((losses, runner.gather_params()))
        adt.reset()
    (la, pa), (lb, pb) = got
    assert la == lb
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


def test_checkpoint_with_a_push_in_flight_equals_the_serial_one(
        tmp_path, monkeypatch):
    from autodist_tpu_torch.checkpoint import Saver
    files = []
    for overlap in ("1", "0"):
        monkeypatch.setenv("ADT_PS_OVERLAP", overlap)
        runner, _ = _dlrm_run(strategy.PS(), steps=3)
        path = Saver(directory=str(tmp_path / overlap)).save(runner)
        files.append(dict(np.load(path + ".params.npz")))
        files.append(dict(np.load(path + ".opt.npz")))
        adt.reset()
    for got, want in ((files[0], files[2]), (files[1], files[3])):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_evaluate_pulls_once_for_the_whole_loop():
    runner, _ = _dlrm_run(strategy.PS(), steps=1)
    store = runner.distributed_step.ps_store
    runner.distributed_step.flush_ps()
    before = store.stats["pulls"]
    _, _, batch, _ = tdlrm.make_train_setup(tdlrm.DLRMConfig.tiny(),
                                            batch_size=8)
    runner.evaluate(iter([batch] * 5))
    assert store.stats["pulls"] - before <= 1, store.stats


def test_a_pull_does_not_wait_for_an_apply(monkeypatch):
    """Compute-then-swap: while an apply is held inside its optimizer
    update, a pull returns at once with the version before it; the
    apply then swaps its values in."""
    infos = {"w": VarInfo(name="w", shape=(4, 2), dtype="float32")}
    plans = {"w": tps.PSVarPlan(var_name="w",
                                destinations=("127.0.0.1:CPU:0",))}
    opt = optim.capture(functools.partial(torch.optim.SGD, lr=0.1))
    store = tps.PSStore(plans, infos, opt)
    store.init_params({"w": torch.ones(4, 2)})
    entered, release = threading.Event(), threading.Event()
    real = type(opt).delta

    def held(self, grads, state, params):
        entered.set()
        assert release.wait(10)
        return real(self, grads, state, params)
    monkeypatch.setattr(type(opt), "delta", held)
    t = threading.Thread(target=store.apply_local,
                         args=({"w": torch.ones(4, 2)},))
    t.start()
    try:
        assert entered.wait(10)
        t0 = time.monotonic()
        vals, version = store.pull()
        assert time.monotonic() - t0 < 1.0
        assert version == 0
        np.testing.assert_array_equal(vals["w"].numpy(), np.ones((4, 2)))
    finally:
        release.set()
        t.join(10)
    vals, version = store.pull()
    assert version == 1
    np.testing.assert_allclose(vals["w"].numpy(), np.full((4, 2), 0.9))
    store.close()


def test_pulls_read_one_version_while_applies_swap():
    """Stress: eight threads pull while another applies 300 times, with a
    short switch interval; every pull's values are the ones of exactly the
    version it reports, for all four variables (two partitioned): an
    apply that swapped the variables one at a time, or a version read
    apart from its values, fails this."""
    import sys
    names = ("a", "b", "c", "d")
    infos = {n: VarInfo(name=n, shape=(6, 2), dtype="float32")
             for n in names}
    plans = {n: tps.PSVarPlan(var_name=n, destinations=("h:CPU:0",) * k,
                              shard_sizes=(4, 2) if k == 2 else None)
             for n, k in zip(names, (2, 1, 2, 1))}
    store = tps.PSStore(plans, infos, optim.capture(
        functools.partial(torch.optim.SGD, lr=0.1)))
    store.init_params({n: torch.ones(6, 2) for n in names})
    applies = 300
    want = [np.float32(1.0)]
    for _ in range(applies):   # the float32 SGD trajectory of gradient 1
        want.append(np.float32(want[-1] + np.float32(-0.1)))
    seen, errors, done = [], [], threading.Event()

    def puller():
        while not done.is_set():
            vals, version = store.pull()
            for name in names:
                if not np.all(vals[name].numpy() == want[version]):
                    errors.append((name, version))
            seen.append(version)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=puller) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for _ in range(applies):
            store.apply_local({n: torch.ones(6, 2) for n in names})
    finally:
        done.set()
        for t in threads:
            t.join(10)
        sys.setswitchinterval(old)
        store.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert store.version == applies and len(set(seen)) > 1


def test_an_apply_replaces_the_values_and_never_writes_them():
    """The values a pull staged stay as they were after an apply (it
    computes fresh tensors and swaps them in), and the result is the
    in-place update's, bit for bit (the JAX store's compute-then-swap)."""
    rng = np.random.RandomState(3)
    full = rng.randn(7, 3).astype(np.float32)
    port, jstore = _stores((7, 3), (3, 2, 2))
    port.init_params({"w": torch.from_numpy(full)})
    before = list(port._values["w"])
    copies = [t.clone() for t in before]
    g = rng.randn(7, 3).astype(np.float32)
    port.apply_local({"w": torch.from_numpy(g)})
    for old, copy, new in zip(before, copies, port._values["w"]):
        assert torch.equal(old, copy) and new is not old
    # the same update in place, through the optimizer's own update
    opt = port._optimizer
    for si, (v, gs) in enumerate(zip(copies, port._split(
            port.plans["w"], torch.from_numpy(g)))):
        state = opt.init({"v": v})
        opt.update({"v": gs.contiguous()}, state, {"v": v})
        assert torch.equal(v, port._values["w"][si]), si
    port.close()


# ------------------------------------------------------------------- store


class _Info:
    def __init__(self, name, shape, sparse=False):
        self.name, self.shape, self.sparse = name, tuple(shape), sparse
        self.dtype, self.trainable = "float32", True
        self.collective_name = name
        self.num_elements = int(np.prod(shape))
        self.byte_size = 4 * self.num_elements


def _stores(shape, sizes, sparse=False):
    """A port store and a JAX store over one variable ``w`` of ``shape``,
    its shards ``sizes`` along axis 0 (None: unpartitioned)."""
    from autodist_tpu_torch import optim
    infos = {"w": _Info("w", shape, sparse)}
    kw = dict(var_name="w", destinations=("h:CPU:0",) * len(sizes or [1]),
              shard_sizes=tuple(sizes) if sizes else None, sparse=sparse)
    port = tps.PSStore({"w": tps.PSVarPlan(**kw)}, infos,
                       optim.capture(ADAM))
    jax_store = jps.PSStore({"w": jps.PSVarPlan(**kw)}, infos,
                            optax.adam(LR))
    return port, jax_store


def test_store_keeps_uneven_shards_ragged_and_applies_as_jax():
    rng = np.random.RandomState(0)
    full = rng.randn(7, 3).astype(np.float32)
    port, jstore = _stores((7, 3), (3, 2, 2))
    port.init_params({"w": torch.from_numpy(full)})
    jstore.init_params({"w": full})
    assert [tuple(s.shape) for s in port._values["w"]] == \
        [(3, 3), (2, 3), (2, 3)]
    for _ in range(2):
        g = rng.randn(7, 3).astype(np.float32)
        port.apply_local({"w": torch.from_numpy(g)})
        jstore.apply_local({"w": g})
    np.testing.assert_allclose(port.full_values()["w"].numpy(),
                               jstore.full_values()["w"], atol=1e-7)
    for slot in ("mu", "nu"):
        np.testing.assert_allclose(
            port.full_opt_leaf(slot, "w").numpy(),
            np.asarray(jstore.full_opt_leaf("0/%s/w" % slot, "w")),
            rtol=1e-6, atol=1e-12)
    # a full-layout optimizer state sliced back into the shards
    full_opt = {"count": torch.tensor(5, dtype=torch.int32),
                "mu": {"w": torch.arange(21.0).reshape(7, 3)},
                "nu": {"w": torch.ones(7, 3)}}
    port.load_opt_from_full(full_opt)
    assert torch.equal(port.full_opt_leaf("mu", "w"), full_opt["mu"]["w"])
    assert [int(st["count"]) for st in port._opt["w"]] == [5, 5, 5]
    # the values only, as the JAX store counts them (C7)
    assert port.resident_bytes() == jstore.resident_bytes() == 7 * 3 * 4


@pytest.mark.parametrize("sizes", [None, (3, 2, 2)],
                         ids=["whole", "uneven"])
def test_resident_bytes_count_values_by_owner_as_the_jax_store(sizes):
    """C7: ``resident_bytes`` counts the resident values (not the
    optimizer state), and ``resident_bytes_by_destination`` each owner's
    share of them, summing to it; both equal the JAX store's for the same
    plan, where each shard has its own owner."""
    infos = {"w": _Info("w", (7, 3)), "v": _Info("v", (5,))}
    dests = tuple("h%d:CPU:0" % i for i in range(len(sizes or [1])))
    plans = {"w": dict(var_name="w", destinations=dests,
                       shard_sizes=sizes),
             "v": dict(var_name="v", destinations=("h0:CPU:0",))}
    from autodist_tpu_torch import optim
    port = tps.PSStore({n: tps.PSVarPlan(**kw) for n, kw in plans.items()},
                       infos, optim.capture(ADAM))
    jstore = jps.PSStore({n: jps.PSVarPlan(**kw)
                          for n, kw in plans.items()}, infos,
                         optax.adam(LR))
    full = {"w": np.ones((7, 3), np.float32), "v": np.ones(5, np.float32)}
    port.init_params({n: torch.from_numpy(v) for n, v in full.items()})
    jstore.init_params(full)
    assert port.resident_bytes() == jstore.resident_bytes() == 4 * 26
    loads = port.resident_bytes_by_destination()
    assert loads == jstore.resident_bytes_by_destination()
    assert sum(loads.values()) == port.resident_bytes()
    assert loads["h0:CPU:0"] == 4 * (5 + (3 * 3 if sizes else 21))


def test_store_densifies_repeated_ids_in_order_as_jax():
    ids = np.array([3, 1, 3, 3, 0, 1], np.int32)
    vals = np.array([[1e8], [1.0], [-1e8], [1.0], [2.5], [3e-8]],
                    np.float32)
    port, jstore = _stores((4, 1), None, sparse=True)
    got = port._densify("w", (torch.from_numpy(ids),
                              torch.from_numpy(vals))).numpy()
    want = jstore._densify("w", jstore.plans["w"], (ids, vals))
    np.testing.assert_array_equal(got, want)
    # the order shows: (1e8 + -1e8) + 1 = 1, not 1e8 + (-1e8 + 1) = 0
    assert got[3, 0] == 1.0


def test_mirror_digest_tracks_the_values():
    port, _ = _stores((4, 2), None)
    port.init_params({"w": torch.zeros(4, 2)})
    d0 = port.mirror_digest()
    other, _ = _stores((4, 2), None)
    other.init_params({"w": torch.zeros(4, 2)})
    assert other.mirror_digest() == d0
    port.apply_local({"w": torch.ones(4, 2)})
    assert port.mirror_digest() != d0
    assert port.version == 1


# ------------------------------------------------------------ the default


def test_autodist_default_builder_compiles_the_jax_default_plan():
    """``AutoDist()`` with no builder: the JAX package's default plan
    (``PSLoadBalancing``) for ncf tiny, byte for byte, the port's names
    spelled as the JAX item spells them."""
    loss_fn, jparams, batch, _ = jncf.make_train_setup(jncf.NCFConfig.tiny(),
                                                       batch_size=8)
    try:
        ad = jadt.AutoDist(resource_spec=JSpec.from_dict(ONE))
        jrunner = ad.build(loss_fn, optax.adam(LR), jparams, batch)
        jplan = jrunner.distributed_step.strategy
    finally:
        jadt.reset()
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tl = tncf.make_train_setup(tncf.NCFConfig.tiny(), batch_size=8)[0]
    ad = adt.AutoDist(resource_spec=ResourceSpec.from_dict(ONE), device="cpu")
    runner = ad.build(tl, ADAM, init, batch)
    dstep = runner.distributed_step
    assert isinstance(ad._strategy_builder, strategy.PSLoadBalancing)
    tplan = dstep.strategy.to_dict()
    infos = dstep.model_item.var_infos
    for node in tplan["node_config"]:
        node["var_name"] = infos[node["var_name"]].collective_name
    tplan["id"] = jplan.id
    assert json.dumps(tplan, sort_keys=True) == \
        json.dumps(jplan.to_dict(), sort_keys=True)
    assert dstep.ps_names == set(infos)


def test_stale_pipeline_reads_never_tear_under_thread_stress(monkeypatch):
    """The stale pipeline's pull lane runs beside its push lane and the
    apply pool (16 threads, more than the cores): with a constant
    gradient every element of the variable moves alike, so a pull that
    saw some shards before an apply and some after would hold unequal
    elements. Every read is one version, and lags the applies by at most
    the staleness."""
    import sys
    monkeypatch.setenv("ADT_PS_APPLY_THREADS", "16")
    from autodist_tpu_torch import optim
    shards = (9, 8, 8, 8, 8, 8, 8, 7)
    infos = {"w": _Info("w", (64, 4))}
    plan = tps.PSVarPlan("w", ("h:CPU:0",) * len(shards),
                         shard_sizes=shards, staleness=1)
    store = tps.PSStore({"w": plan}, infos, optim.capture(ADAM))
    store.init_params({"w": torch.zeros(64, 4)})
    pipe = tps.PSPipeline(store, stale_ok=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(200):
            vals, version = pipe.values()
            w = vals["w"]
            assert torch.equal(w, torch.full_like(w, float(w[0, 0]))), step
            assert 0 <= step - version <= 1, (step, version)
            pipe.submit({"w": torch.ones(64, 4)})
        pipe.flush()
    finally:
        sys.setswitchinterval(interval)
        pipe.close()
        store.close()
    assert store.stats["pushes"] == 200 and store.version == 200
