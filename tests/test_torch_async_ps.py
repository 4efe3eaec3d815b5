"""Async host PS (``sync=False``) and bounded staleness across ranks:
autodist_tpu_torch against the JAX package, on the CPU.

- The wire: ``pack_arrays`` writes the JAX package's bytes for the same
  seeded arrays (numpy or tensors), and a blob packed by either package
  unpacks in the other.
- The owner loop (JAX ``tests/test_async_ps.py``): an owner store and a
  worker store over in-process services — the push/pull cycle, and
  applies that interleave without a barrier — value for value against
  the JAX stores on the same pushes (SGD bit for bit; Adam within 1e-6
  relative, XLA's FMAs); per-shard ownership with Adam, each
  owner applying only its own shard range, and a checkpoint read on
  either side holding the peer's moments from the optimizer side
  channel; the values channel carries no optimizer leaves.
- ``PS``, ``PSLoadBalancing``, ``PartitionedPS``, ``UnevenPartitionedPS``
  and ``Parallax`` with ``sync=False`` at one process, drained after each
  step on the serial path (``flush_ps(); store.drain()`` with
  ``ADT_PS_OVERLAP=0``, the JAX tests' pacing): the losses and params
  within 1e-5 of the JAX run, and ``torch.equal`` to the port's serial
  sync PS path; the linear model of JAX
  ``test_async_e2e_single_process`` converges undrained, on the
  pipeline.
- The refusals, with the JAX package's messages: a mixed strategy,
  staleness with async, fused supersteps with async, ``build_step`` with
  async.
- Two processes (``tests/torch_dist_worker.py``, one gloo group that no
  async step may touch), each on a coordination service the test starts:
  the JAX ``tests/dist_driver.py`` cases ``PSAsync``, ``PSAsyncLB``,
  ``PSAsyncPart`` (with a checkpoint under Adam) and ``PSStale``
  (``PS(staleness=2)`` at N = 2), with the assertions of JAX
  ``tests/test_distributed.py``: each rank's loss falls; the owners
  publish, their shard keys disjoint, their blobs unpacked by the JAX
  ``unpack_arrays``; no collective ran under async (``sync.wire_bytes``
  and the group's calls at 0); a checkpoint's moments live in every
  shard range; under ``PSStale`` no rank was ever more than 2 steps
  ahead of the slowest on the service, the ranks' losses are equal and
  their mirror digests too, and both ranks said goodbye.
"""
import functools
import socket
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu as jadt
import autodist_tpu_torch as adt
from autodist_tpu import strategy as JS
from autodist_tpu.model_item import VarInfo as JVarInfo
from autodist_tpu.ops import embedding as jE
from autodist_tpu.parallel import ps as jps
from autodist_tpu.runtime import ps_service as jpss
from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as TS
from autodist_tpu_torch.model_item import VarInfo
from autodist_tpu_torch.ops import embedding as E
from autodist_tpu_torch.parallel import ps as tps
from autodist_tpu_torch.runtime import ps_service as pss
from torch_dist_worker import launch

TOL = 1e-5


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


def _wait(cond, what, timeout=10):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# ------------------------------------------------------------------- wire


def _seeded_arrays():
    rng = np.random.RandomState(0)
    return {"a/w": rng.randn(3, 5).astype(np.float32),
            "b": np.arange(7, dtype=np.int32),
            "ids": rng.randint(0, 100, (6,)).astype(np.int64),
            "scalar": np.float64(3.5) * np.ones(()),
            "empty": np.zeros((0, 4), np.float32),
            "t3::1": rng.randn(2, 3, 4).astype(np.float32)}


def test_pack_writes_the_jax_bytes():
    arrays = _seeded_arrays()
    want = jpss.pack_arrays(arrays)
    assert bytes(pss.pack_arrays(arrays)) == want
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}
    assert bytes(pss.pack_arrays(tensors)) == want


@pytest.mark.parametrize("packer", ["torch", "jax"])
def test_blobs_unpack_in_the_other_package(packer):
    arrays = _seeded_arrays()
    pack, unpack = ((pss.pack_arrays, jpss.unpack_arrays)
                    if packer == "torch" else
                    (jpss.pack_arrays, pss.unpack_arrays))
    out = unpack(pack(arrays))
    assert sorted(out) == sorted(arrays)
    for k, v in arrays.items():
        # the format packs np.ascontiguousarray(v): a 0-d array as (1,)
        ref = np.ascontiguousarray(v)
        assert out[k].dtype == ref.dtype and out[k].shape == ref.shape, k
        np.testing.assert_array_equal(out[k], ref)


# -------------------------------------------------------------- owner loop


def _plans(mod, dests=("hostA:CPU:0",), shard_sizes=None):
    return {"w": mod.PSVarPlan(var_name="w", destinations=dests,
                               shard_sizes=shard_sizes, sync=False)}


def _port_pair(opt, dests=("hostA:CPU:0",), shard_sizes=None):
    """Owner ('hostA') and worker ('hostB') stores over one plan, sharing
    in-process services."""
    infos = {"w": VarInfo(name="w", shape=(4, 2), dtype="float32")}
    services = {}

    def service_for_host(host):
        return services.setdefault(host, pss.LocalPSService())
    stores = []
    for host in ("hostA", "hostB"):
        s = tps.PSStore(_plans(tps, dests, shard_sizes), infos, opt)
        s.init_params({"w": torch.ones(4, 2)})
        s.enable_serving(service_for_host, my_host=host)
        stores.append(s)
    return stores[0], stores[1], services


def _jax_pair(opt, dests=("hostA:CPU:0",), shard_sizes=None):
    infos = {"w": JVarInfo(name="w", shape=(4, 2), dtype="float32")}
    services = {}

    def service_for_host(host):
        return services.setdefault(host, jpss.LocalPSService())
    stores = []
    for host in ("hostA", "hostB"):
        s = jps.PSStore(_plans(jps, dests, shard_sizes), infos, opt)
        s.init_params({"w": np.ones((4, 2), np.float32)})
        s.enable_serving(service_for_host, my_host=host)
        stores.append(s)
    return stores[0], stores[1], services


SGD = functools.partial(torch.optim.SGD, lr=0.1)
ADAM = functools.partial(torch.optim.Adam, lr=0.1)


def test_owner_worker_push_pull_cycle():
    owner, worker, _ = _port_pair(optim.capture(SGD))
    jowner, jworker, _ = _jax_pair(optax.sgd(0.1))
    try:
        vals0, _ = worker.pull()   # the owner's initial publish
        np.testing.assert_array_equal(vals0["w"].numpy(), np.ones((4, 2)))
        g = np.full((4, 2), 2.0, np.float32)
        worker.push({"w": torch.from_numpy(g)})
        jworker.push({"w": jnp.asarray(g)})
        # the owner's apply thread applies and republishes, with nothing
        # from the owner's main thread
        _wait(lambda: owner.applied_total() >= 1, "apply loop never ran")
        _wait(lambda: jowner.applied_total() >= 1, "JAX loop never ran")
        want = jowner._local_full()["w"]
        np.testing.assert_array_equal(owner._local_full()["w"].numpy(), want)
        _wait(lambda: not np.allclose(worker.pull()[0]["w"].numpy(), 1.0),
              "new version never served")
        np.testing.assert_array_equal(worker.pull()[0]["w"].numpy(), want)
        assert worker.applied_total() == 0   # it owns nothing
        assert worker.stats["bytes_pushed"] > 0
        assert worker.stats["bytes_pushed"] == jworker.stats["bytes_pushed"]
    finally:
        for s in (owner, worker, jowner, jworker):
            s.close()


def test_async_applies_interleave_without_barrier():
    """Two pushes while the owner's main thread idles: each applies on
    its own (one gradient at a time, no averaging)."""
    owner, worker, _ = _port_pair(optim.capture(SGD))
    jowner, jworker, _ = _jax_pair(optax.sgd(0.1))
    try:
        for _ in range(2):
            worker.push({"w": torch.ones(4, 2)})
            jworker.push({"w": jnp.ones((4, 2))})
        _wait(lambda: owner.applied_total() >= 2, "port applies")
        _wait(lambda: jowner.applied_total() >= 2, "JAX applies")
        got = owner._local_full()["w"].numpy()
        np.testing.assert_array_equal(got, jowner._local_full()["w"])
        np.testing.assert_allclose(got, np.full((4, 2), 0.8), rtol=1e-6)
    finally:
        for s in (owner, worker, jowner, jworker):
            s.close()


def test_per_shard_ownership_and_the_opt_side_channel():
    """Shards owned by different hosts: each owner applies only its
    range; a pull reassembles both; a checkpoint read on either side
    takes the peer's Adam moments off the side channel; equal to the JAX
    stores throughout."""
    kw = dict(dests=("hostA:CPU:0", "hostB:CPU:0"), shard_sizes=(2, 2))
    a, b, services = _port_pair(optim.capture(ADAM), **kw)
    ja, jb, _ = _jax_pair(optax.adam(0.1), **kw)
    try:
        g = np.arange(8, dtype=np.float32).reshape(4, 2) + 1.0
        a.push({"w": torch.from_numpy(g)})
        ja.push({"w": jnp.asarray(g)})
        for s in (a, b, ja, jb):
            _wait(lambda s=s: s.applied_total() >= 1, "apply loops")
            s.drain()
        with a._lock:
            np.testing.assert_array_equal(a._values["w"][1].numpy(),
                                          np.ones((2, 2)))
            assert not np.allclose(a._values["w"][0].numpy(), 1.0)
        with b._lock:
            np.testing.assert_array_equal(b._values["w"][0].numpy(),
                                          np.ones((2, 2)))
        for port, jax_store in ((a, ja), (b, jb)):
            # Adam in float32 both ways; XLA's jitted apply contracts to
            # FMAs, so the values may part by a float32 ulp
            vals, _ = port.pull()
            np.testing.assert_allclose(vals["w"].numpy(),
                                       jax_store.pull()["w"], rtol=1e-6)
            mu = port.full_opt_leaf("mu", "w").numpy()
            np.testing.assert_allclose(
                mu, np.asarray(jax_store.full_opt_leaf("0/mu/w", "w")),
                rtol=1e-6)
            np.testing.assert_allclose(mu, 0.1 * g, rtol=1e-5)
        # values only on the hot channel; the moments on the side channel,
        # under the JAX package's leaf names
        vals = pss.unpack_arrays(services["hostA"].fetch()[1])
        assert set(vals) == {"w::0"}
        opts = jpss.unpack_arrays(services["hostA"].fetch_opt()[1])
        assert set(opts) == {"w::0!0/count", "w::0!0/mu/v", "w::0!0/nu/v"}
    finally:
        for s in (a, b, ja, jb):
            s.close()


# ------------------------------------------------ one process, end to end


def _mlp(pkg, seed=0):
    """The JAX ``tests/dist_driver.py`` MLP in either package."""
    rng = np.random.RandomState(seed)
    init = {"w1": (rng.randn(8, 16) * 0.3).astype(np.float32),
            "b1": np.zeros((16,), np.float32),
            "w2": (rng.randn(16, 4) * 0.3).astype(np.float32)}
    batch = {"x": rng.randn(16, 8).astype(np.float32),
             "y": rng.randn(16, 4).astype(np.float32)}
    if pkg == "jax":
        def loss_fn(p, b):
            h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
            return jnp.mean((h @ p["w2"] - b["y"]) ** 2)
        return loss_fn, {k: jnp.asarray(v) for k, v in init.items()}, batch

    def loss_fn(p, b):
        h = torch.tanh(torch.as_tensor(b["x"]) @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] - torch.as_tensor(b["y"])) ** 2)
    return loss_fn, {k: torch.from_numpy(v) for k, v in init.items()}, batch


def _tables(pkg, seed=0):
    """Two lookup tables and a dot product: every variable sparse, so
    ``Parallax`` puts both on the host PS."""
    rng = np.random.RandomState(seed)
    init = {"user": (rng.randn(64, 8) * 0.3).astype(np.float32),
            "item": (rng.randn(32, 8) * 0.3).astype(np.float32)}
    batch = {"u": rng.randint(0, 64, (16,)).astype(np.int32),
             "i": rng.randint(0, 32, (16,)).astype(np.int32),
             "y": rng.randn(16).astype(np.float32)}
    if pkg == "jax":
        def loss_fn(p, b):
            u = jE.embedding_lookup(p["user"], b["u"], name="user")
            i = jE.embedding_lookup(p["item"], b["i"], name="item")
            return jnp.mean((jnp.sum(u * i, -1) - b["y"]) ** 2)
        return loss_fn, {k: jnp.asarray(v) for k, v in init.items()}, batch

    def loss_fn(p, b):
        u = E.embedding_lookup(p["user"], torch.as_tensor(b["u"]),
                               name="user")
        i = E.embedding_lookup(p["item"], torch.as_tensor(b["i"]),
                               name="item")
        return torch.mean((torch.sum(u * i, -1) - torch.as_tensor(b["y"]))
                          ** 2)
    return loss_fn, {k: torch.from_numpy(v) for k, v in init.items()}, batch


MODELS = {"mlp": _mlp, "tables": _tables}
STEPS = 6


def _drained(runner, batch, steps=STEPS):
    """Steps paced as the JAX tests pace async: every push applied
    before the next step's pull."""
    dstep = runner.distributed_step
    losses = []
    for _ in range(steps):
        losses.append(float(runner.run(batch)["loss"]))
        dstep.flush_ps()
        dstep.ps_store.drain()
    return losses


def _jax_run(builder, model, steps=STEPS):
    loss_fn, params, batch = MODELS[model]("jax")
    try:
        ad = jadt.AutoDist(strategy_builder=builder)
        runner = ad.build(loss_fn, optax.adam(1e-2), params, batch)
        runner.init(params)
        store = runner.distributed_step.ps_store
        assert store.serving and runner.distributed_step.metadata["async"]
        losses = _drained(runner, batch, steps)
        final = {k: np.asarray(v)
                 for k, v in runner.gather_params().items()}
    finally:
        jadt.reset()
    return losses, final


def _port_run(builder, model, steps=STEPS):
    loss_fn, params, batch = MODELS[model]("torch")
    ad = adt.AutoDist(strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-2),
                      params, batch)
    runner.init(params)
    dstep = runner.distributed_step
    if dstep.metadata["async"]:
        assert dstep.ps_store.serving and dstep.num_replicas == 1
        losses = _drained(runner, batch, steps)
        assert dstep.ps_store.applied_total() == steps
    else:
        losses = [float(runner.run(batch)["loss"]) for _ in range(steps)]
    final = runner.gather_params()
    adt.reset()
    return losses, final


ASYNC_CASES = [("PS", "mlp"), ("PSLoadBalancing", "mlp"),
               ("PartitionedPS", "mlp"), ("UnevenPartitionedPS", "mlp"),
               ("PS", "tables"), ("PartitionedPS", "tables"),
               ("Parallax", "tables")]


@pytest.mark.parametrize("name,model", ASYNC_CASES)
def test_async_builders_train_as_the_jax_package(monkeypatch, name, model):
    monkeypatch.setenv("ADT_PS_OVERLAP", "0")
    jlosses, jfinal = _jax_run(getattr(JS, name)(sync=False), model)
    losses, final = _port_run(getattr(TS, name)(sync=False), model)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    assert losses[-1] < losses[0]
    for k, want in jfinal.items():
        np.testing.assert_allclose(final[k].numpy(), want, rtol=TOL,
                                   atol=TOL, err_msg=k)
    # drained async is the serial sync PS path, bit for bit
    slosses, sfinal = _port_run(getattr(TS, name)(), model)
    assert slosses == losses
    for k in sfinal:
        assert torch.equal(sfinal[k], final[k]), k


def test_async_e2e_single_process_converges_on_the_pipeline():
    """The JAX ``test_async_e2e_single_process``'s linear model under
    PS(sync=False) on the pipeline (reads may lag the applies), paced
    every 5 steps: the applies all land and it converges to the closed
    form; the reads lag the pushes by at most ``ADT_PS_MAX_LAG`` + 2 (the
    queue, the blob in the apply thread, the push in the pipeline). SGD
    at 0.05, not the JAX test's 0.2: on this quadratic (Hessian
    eigenvalues 1.08-3.23) a step of 0.2 diverges once reads lag by 2,
    which a loaded host makes common; 0.05 converges at every lag up to
    5."""
    rng = np.random.RandomState(0)
    true_w = rng.randn(8, 1).astype(np.float32)
    X = rng.randn(64, 8).astype(np.float32)
    batch = {"x": X, "y": X @ true_w}
    params = {"w": torch.zeros(8, 1)}

    def loss_fn(p, b):
        return torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                           - torch.as_tensor(b["y"])) ** 2)
    ad = adt.AutoDist(strategy_builder=TS.PS(sync=False), device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.SGD, lr=0.05),
                      params, batch)
    runner.init(params)
    dstep = runner.distributed_step
    assert dstep.metadata["async"] is True
    store = dstep.ps_store
    assert store.serving
    losses = []
    for i in range(100):
        losses.append(float(runner.run(batch)["loss"]))
        if i % 5 == 4:
            dstep.flush_ps()
            store.drain()
    dstep.flush_ps()
    store.drain()
    assert store.applied_total() == 100
    assert losses[-1] < 1e-2 < losses[0]
    np.testing.assert_allclose(runner.gather_params()["w"].numpy(), true_w,
                               atol=5e-2)
    from autodist_tpu_torch import const
    lags = list(dstep.ps_read_lags)
    assert 0 <= min(lags) and max(lags) <= const.ENV.ADT_PS_MAX_LAG.val + 2


# -------------------------------------------------------------- refusals


def _mixed(base):
    class Mixed(base.StrategyBuilder):
        def build(self, item, spec):
            dest = "%s:CPU:0" % spec.node_addresses[0]
            return base.Strategy(
                node_config=[
                    base.VarConfig(var_name="w", synchronizer=(
                        base.PSSynchronizer(reduction_destination=dest,
                                            sync=False))),
                    base.VarConfig(var_name="b",
                                   synchronizer=base.AllReduceSynchronizer())],
                graph_config=base.GraphConfig(replicas=[
                    d.name_string() for d in spec.devices]))
    return Mixed()


def _stale_async(base):
    class StaleAsync(base.StrategyBuilder):
        def build(self, item, spec):
            dest = "%s:CPU:0" % spec.node_addresses[0]
            return base.Strategy(
                node_config=[base.VarConfig(var_name=n, synchronizer=(
                    base.PSSynchronizer(reduction_destination=dest,
                                        sync=False, staleness=1)))
                    for n in ("b", "w")],
                graph_config=base.GraphConfig(replicas=[
                    d.name_string() for d in spec.devices]))
    return StaleAsync()


def _refusal_message(pkg, case):
    params_np = {"w": np.zeros((8, 2), np.float32),
                 "b": np.zeros((2,), np.float32)}
    batch = {"x": np.zeros((8, 8), np.float32),
             "y": np.zeros((8, 2), np.float32)}
    if pkg == "jax":
        from autodist_tpu.strategy import base
        params = {k: jnp.asarray(v) for k, v in params_np.items()}
        opt = optax.sgd(0.1)

        def loss_fn(p, b):
            return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

        def step_fn(state, b):
            return state, {"loss": loss_fn(state, b)}
        make = functools.partial(jadt.AutoDist)
    else:
        from autodist_tpu_torch.strategy import base
        params = {k: torch.from_numpy(v) for k, v in params_np.items()}
        opt = SGD

        def loss_fn(p, b):
            return torch.mean((torch.as_tensor(b["x"]) @ p["w"] + p["b"]
                               - torch.as_tensor(b["y"])) ** 2)

        def step_fn(state, b):
            return state, {"loss": loss_fn(state, b)}
        make = functools.partial(adt.AutoDist, device="cpu")
    builder = {"mixed": _mixed, "stale": _stale_async}.get(case)
    S = JS if pkg == "jax" else TS
    try:
        if case == "fused":
            ad = make(strategy_builder=S.PS(sync=False))
            runner = ad.build(loss_fn, opt, params, batch)
            runner.init(params)
            runner.fit([batch] * 4, fuse_steps=2)
        elif case == "step_fn":
            ad = make(strategy_builder=S.PS(sync=False))
            ad.build_step(step_fn, params, batch)
        else:
            ad = make(strategy_builder=builder(base))
            ad.build(loss_fn, opt, params, batch)
    except ValueError as e:
        return str(e)
    finally:
        (jadt if pkg == "jax" else adt).reset()
    raise AssertionError("%s %s: no refusal" % (pkg, case))


@pytest.mark.parametrize("case,match", [
    ("mixed", "requires EVERY trainable var"),
    ("stale", "staleness is a SYNC-training window"),
    ("fused", "fused multi-step requires synchronous host-PS"),
    ("step_fn", "cannot lower an opaque step_fn")])
def test_async_refusals_carry_the_jax_messages(case, match):
    got = _refusal_message("torch", case)
    assert match in got
    assert got == _refusal_message("jax", case)


# ------------------------------------------------------------ two processes


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


TWO_CASES = ("PSAsync", "PSAsyncLB", "PSAsyncPart", "PSStale")
TWO_STEPS = 10


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """One launch of two gloo ranks on the CPU runs every case in turn,
    each on its own coordination service (started here, stopped after
    the parent has read it); returns the ranks' results and what the
    services held."""
    from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                         CoordinationServer)
    tmp = tmp_path_factory.mktemp("async_two")
    servers = {c: CoordinationServer(_free_port()).start()
               for c in TWO_CASES}
    try:
        _, _, batch = _mlp("torch")
        payload = {"cases": list(TWO_CASES), "steps": TWO_STEPS,
                   "batch": batch,
                   "init": {k: v.numpy() for k, v in
                            _mlp("torch")[1].items()},
                   "ports": {c: s.port for c, s in servers.items()},
                   "ckpt_dir": str(tmp / "ckpt")}
        ranks = launch("async", 2, tmp, payload)
        held = {}
        for case, srv in servers.items():
            c = CoordinationClient("127.0.0.1", srv.port)
            held[case] = {
                "vals": {h: c.bget("ps:%s/vals" % h)
                         for h in ("127.0.0.1", "localhost")},
                "min_step": c.min_step(),
                "dead": c.dead_workers(0.0)}
            c.close()
    finally:
        for s in servers.values():
            s.stop()
    return ranks, held, str(tmp / "ckpt")


@pytest.mark.parametrize("case", TWO_CASES)
def test_two_processes_train_and_losses_fall(two_processes, case):
    ranks, _, _ = two_processes
    for r in ranks:
        losses = r[case]["losses"]
        assert len(losses) == TWO_STEPS and np.all(np.isfinite(losses))
        assert losses[-1] < losses[0], (case, losses)


@pytest.mark.parametrize("case", ("PSAsync", "PSAsyncLB", "PSAsyncPart"))
def test_two_process_async_touches_no_collective(two_processes, case):
    ranks, _, _ = two_processes
    for r in ranks:
        res = r[case]
        assert res["serving"] and res["async"] and res["replicas"] == 1
        assert res["collectives"] == 0
        assert res["counters"].get("sync.wire_bytes", 0.0) == 0.0


def test_two_process_async_single_owner(two_processes):
    """PS(sync=False): the chief owns every variable and applies the
    blobs of both processes."""
    ranks, held, _ = two_processes
    assert ranks[0]["PSAsync"]["owned"] == ["127.0.0.1"]
    assert ranks[1]["PSAsync"]["owned"] == []
    res = held["PSAsync"]["vals"]["127.0.0.1"]
    assert res is not None and held["PSAsync"]["vals"]["localhost"] is None
    version, blob = res
    assert version >= TWO_STEPS, "the chief applied fewer blobs than its own"
    assert ranks[0]["PSAsync"]["applied"] == version
    assert sorted(jpss.unpack_arrays(blob)) == ["b1::0", "w1::0", "w2::0"]


@pytest.mark.parametrize("case", ("PSAsyncLB", "PSAsyncPart"))
def test_two_process_async_multi_owner(two_processes, case):
    """Both hosts own a group and publish it; each (variable, shard) is
    published by exactly one owner; the port's blobs unpack with the JAX
    ``unpack_arrays``."""
    ranks, held, _ = two_processes
    assert ranks[0][case]["owned"] == ["127.0.0.1"]
    assert ranks[1][case]["owned"] == ["localhost"]
    owners = {}
    for host, res in held[case]["vals"].items():
        assert res is not None, "host %s never published" % host
        for key in jpss.unpack_arrays(res[1]):
            name, si = key.rsplit("::", 1)
            owners.setdefault(name, {}).setdefault(int(si), []).append(host)
    assert sorted(owners) == ["b1", "w1", "w2"]
    for name, by_si in owners.items():
        assert sorted(by_si) == list(range(len(by_si))), owners
        assert all(len(h) == 1 for h in by_si.values()), owners
    if case == "PSAsyncPart":
        split = [n for n, by_si in owners.items()
                 if len({h[0] for h in by_si.values()}) > 1]
        assert split, owners


def test_two_process_async_checkpoint_holds_every_owners_moments(
        two_processes):
    """Under PartitionedPS(sync=False) and Adam, the chief's checkpoint
    holds live moments in every shard range of a partitioned variable,
    the worker-owned ones from the owner's side channel."""
    import glob
    _, _, ckpt = two_processes
    metas = sorted(glob.glob(ckpt + "/ckpt-*.meta.json"))
    assert metas, "the chief saved no checkpoint"
    opt = np.load(metas[-1][: -len(".meta.json")] + ".opt.npz")
    mu_keys = [k for k in opt.files if "/mu/" in k and "w1" in k]
    assert mu_keys, opt.files
    mu = opt[mu_keys[0]]
    half = mu.shape[0] // 2
    assert np.abs(mu[:half]).max() > 0
    assert np.abs(mu[half:]).max() > 0, "the peer-owned moments are zero"


def test_two_process_staleness_window(two_processes):
    """PS(staleness=2) at N = 2: each rank reported every step to the
    service and no rank was ever more than 2 steps ahead of the slowest;
    the ranks' losses and mirror digests are equal; both said goodbye."""
    ranks, held, _ = two_processes
    a, b = (r["PSStale"] for r in ranks)
    assert a["losses"] == b["losses"]
    assert a["digest"] == b["digest"]
    for r in (a, b):
        assert r["staleness"] == 2 and not r["async"]
        assert r["pacing"]
        assert 0 <= max(r["gaps"]) <= 2, r["gaps"]
        assert r["barrier_spans"] == TWO_STEPS
        assert r["counters"].get("ps.mirror_checks", 0) >= 1
    assert held["PSStale"]["min_step"] == 0      # both step records gone
    assert held["PSStale"]["dead"] == []
