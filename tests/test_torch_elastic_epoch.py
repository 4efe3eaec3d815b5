"""The in-run elastic plane's parts (``runtime/elastic.py``), held to the
JAX package's ``tests/test_elastic_epoch.py`` where both give the same
answer, against a real coordination service (the port's build of the
native one).

C12 first (``clear()`` and ``reset()`` leave no membership installed),
then the epoch protocol (monotonic publish, an epoch either package wrote
read by the other, the roster layout, its expansion into ranks and the
epoch's rendezvous address), the write fence (a zombie rejected on every
path, a lagging survivor not, open with the service out of reach, fenced
plain and sharded saves leave the directory as it was, the partition
fault holding then delivering), the ADT430/431 rules, the ZeRO re-layout
of the snapshot's sync state, a single-process reconfigure end to end
(the losses bit-equal to an uninterrupted run) and the re-run rule: a
step whose collective fails before its first write runs again from the
live state, one that fails after it restores the newest checkpoint; a
straggler flag that does not carry into the next epoch's incarnation, and
a planned shrink, published while its leaver is alive, held until the
rescue plan's step at more than one replica. The two-process shrink and
grow is in ``test_torch_elastic_launch.py``, the preemption plane's
planned departure in ``test_torch_preemption.py``.
"""
import functools
import os
import socket
import time
import types

import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     CoordinationServer)
from autodist_tpu_torch.telemetry import spans as tel

_ENV = ("ADT_ELASTIC", "ADT_ELASTIC_SYNC", "ADT_ELASTIC_INRUN",
        "ADT_ELASTIC_POLL_S", "ADT_WORKER", "ADT_COORDSVC_PORT",
        "ADT_COORDINATOR_ADDR", "ADT_CKPT_DIR", "ADT_NUM_PROCESSES",
        "ADT_PROCESS_ID", "ADT_AUTO_RESUME")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server():
    srv = CoordinationServer(port=_free_port())
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    yield
    elastic.clear()
    adt.reset()


def _client(server):
    return CoordinationClient("127.0.0.1", server.port)


_EPOCHS = iter(range(1000, 10 ** 6, 10))


def _base_epoch():
    """An epoch above any this module published before: epochs on the
    shared service only move forward."""
    return next(_EPOCHS)


# ------------------------------------------------------------------- C12


class _Stub:
    epoch = 7
    closed = False

    def close(self):
        self.closed = True


@pytest.mark.parametrize("how", ["clear", "reset"])
def test_clear_and_reset_uninstall_the_membership(how):
    """C12: ``elastic.clear()`` closes the installed membership and
    uninstalls it, and ``autodist_tpu_torch.reset()`` clears it as the JAX
    ``reset()`` does — else a fence of one AutoDist outlived it and
    rejected the writes of the next."""
    stub = elastic.install(_Stub())
    assert elastic.current() is stub
    if how == "clear":
        elastic.clear()
    else:
        adt.reset()
    assert elastic.current() is None
    assert stub.closed


# -------------------------------------------------------- epoch protocol


def test_epoch_publish_read_monotonic(server):
    c = _client(server)
    base = _base_epoch()
    elastic.publish_epoch(c, base, ["a", "b"])
    assert elastic.read_epoch(c) == (base, ["a", "b"])
    with pytest.raises(ValueError, match="monotonically"):
        elastic.publish_epoch(c, base, ["a"])
    elastic.publish_epoch(c, base + 1, ["a"])
    assert elastic.read_epoch(c) == (base + 1, ["a"])
    c.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_an_epoch_crosses_the_packages(server, writer):
    """An epoch and roster one package published is what the other
    reads, and its monotonicity guard holds across them."""
    from autodist_tpu.runtime import elastic as jax_elastic
    from autodist_tpu.runtime.coordination import \
        CoordinationClient as JaxClient
    jc = JaxClient("127.0.0.1", server.port)
    pc = _client(server)
    base = _base_epoch()
    pub, read = ((jax_elastic, jc), (elastic, pc))[::1 if writer == "jax"
                                                   else -1]
    pub[0].publish_epoch(pub[1], base, ["127.0.0.1", "localhost"])
    assert read[0].read_epoch(read[1]) == (base, ["127.0.0.1", "localhost"])
    with pytest.raises(ValueError, match="monotonically"):
        read[0].publish_epoch(read[1], base, ["127.0.0.1"])
    jc.close()
    pc.close()


def test_admission_grows_the_roster_as_the_jax_one(server):
    """A joiner's announcement is pending until ``admit_worker`` publishes
    the next epoch with it appended and consumes the announcement; a
    member is admitted as a no-op; with no epoch there is nothing to
    grow. The JAX package reads the grown epoch."""
    from autodist_tpu.runtime import elastic as jax_elastic
    from autodist_tpu.runtime.coordination import \
        CoordinationClient as JaxClient
    fresh = CoordinationServer(port=_free_port())
    fresh.start()
    try:
        c = _client(fresh)
        with pytest.raises(RuntimeError, match="no membership epoch"):
            elastic.admit_worker(c, "w1")
        elastic.publish_epoch(c, 1, ["chief"])
        assert not elastic.pending_join(c, "w1")
        elastic.announce_join(c, "w1")
        assert elastic.pending_join(c, "w1")
        assert elastic.admit_worker(c, "w1") == 2
        assert not elastic.pending_join(c, "w1")
        assert elastic.admit_worker(c, "w1") == 2  # a member already
        jc = JaxClient("127.0.0.1", fresh.port)
        assert jax_elastic.read_epoch(jc) == (2, ["chief", "w1"])
        assert not jax_elastic.pending_join(jc, "w1")
        jc.close()
        c.close()
    finally:
        fresh.stop()


@pytest.mark.parametrize("roster, chief", [
    (["w2", "chiefy", "w1"], "chiefy"), (["b", "a"], None),
    (["10.0.0.9", "10.0.0.1", "10.0.0.9"], "10.0.0.1"), (["w1"], "chiefy")])
def test_roster_layout_equals_the_jax_one(roster, chief):
    from autodist_tpu.runtime import elastic as jax_elastic
    try:
        want = jax_elastic.roster_layout(roster, chief)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            elastic.roster_layout(roster, chief)
        assert str(got.value) == str(e)
        return
    assert elastic.roster_layout(roster, chief) == want


@pytest.mark.parametrize("addr", ["10.0.0.1:16000", "127.0.0.1:30001", None])
def test_epoch_address_equals_the_jax_one(monkeypatch, addr):
    from autodist_tpu.runtime import elastic as jax_elastic
    if addr is not None:
        monkeypatch.setenv("ADT_COORDINATOR_ADDR", addr)
    got = [elastic.epoch_coordinator_address(e) for e in (1, 2, 3, 89, 90,
                                                          91)]
    assert got == [jax_elastic.epoch_coordinator_address(e)
                   for e in (1, 2, 3, 89, 90, 91)]
    assert got[0] == (addr or "127.0.0.1:15999")
    # 89 ports in turn: epoch 90 binds the launch's again
    assert len(set(got[:4])) == 4 and got[4:] == got[:2]


def test_the_roster_expands_into_the_clusters_ranks(monkeypatch):
    """Two ranks on one node: the chief's node lists two device entries.
    Every member expands a roster of nodes into ranks with one rule,
    which is the Cluster's layout of the same nodes — at launch, after a
    shrink to the chief's node, and after the grow back."""
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runtime.cluster import Cluster
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "localhost", "cpus": [0]},
        {"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]})
    cluster = Cluster(spec)
    entries = cluster.entries_per_node
    assert entries == {"127.0.0.1": 2, "localhost": 1}
    procs = elastic.roster_processes(["localhost", "127.0.0.1"], entries,
                                     "127.0.0.1")
    assert procs == [("127.0.0.1", 0), ("127.0.0.1", 1), ("localhost", 0)]
    assert procs == [(a, cluster.local_rank(i)) for i, a in
                     enumerate(cluster.process_addresses)]
    joined = []
    monkeypatch.setattr(elastic, "rejoin_process_set",
                        lambda roster, epoch, ents, chief=None:
                        joined.append((list(roster), epoch)))
    for roster, epoch in ((["127.0.0.1"], 2),
                          (["127.0.0.1", "localhost"], 3)):
        cluster.reconfigure(roster, epoch)
        assert [(a, cluster.local_rank(i)) for i, a in enumerate(
            cluster.process_addresses)] == elastic.roster_processes(
                roster, entries, "127.0.0.1")
    assert joined == [(["127.0.0.1"], 2), (["127.0.0.1", "localhost"], 3)]
    m = elastic.Membership("127.0.0.1", 1, ["127.0.0.1", "localhost"])
    m.entries = entries
    assert m.world(["127.0.0.1", "localhost"]) == 3
    assert m.world(["127.0.0.1"]) == 2


# ---------------------------------------------------------------- the fence


def _counter(name):
    return tel.counters().get(name, 0.0)


def test_fence_rejects_zombie_but_not_lagging_survivor(server):
    """A zombie (a stale epoch, out of the roster) gets FencedOut on every
    mutating path; a lagging survivor (a stale epoch, still in the
    roster) writes on until its own reconfigure."""
    c = _client(server)
    base = _base_epoch()
    elastic.publish_epoch(c, base, ["chief", "w2"])

    def factory():
        return _client(server)
    zombie = elastic.Membership("w2", base, ["chief", "w2"],
                                client_factory=factory)
    survivor = elastic.Membership("chief", base, ["chief", "w2"],
                                  client_factory=factory)
    elastic.publish_epoch(c, base + 1, ["chief"])

    survivor.fence("anything")  # lagging but in the roster: allowed
    before = _counter("elastic.fenced_writes")
    with pytest.raises(elastic.FencedOut) as e:
        zombie.fence("ps.push")
    assert e.value.op == "ps.push"
    assert e.value.my_epoch == base and e.value.current_epoch == base + 1
    assert _counter("elastic.fenced_writes") == before + 1

    elastic.install(zombie)
    from autodist_tpu_torch.runtime.resilience import \
        ResilientCoordinationClient
    rc = ResilientCoordinationClient("127.0.0.1", server.port)
    rejected = 0
    for call in (lambda: rc.put("straggler/w2", "123.0"),
                 lambda: rc.heartbeat("w2"),
                 lambda: rc.barrier("late-barrier", 1),
                 lambda: rc.report_step("w2", 9),
                 lambda: rc.bput("ps/vals", 7, b"zzz"),
                 lambda: rc.qpush("ps/grads", b"zzz")):
        with pytest.raises(elastic.FencedOut):
            call()
        rejected += 1
    assert rc.get("straggler/w2") is None  # the marks never landed
    assert _counter("elastic.fenced_writes") >= before + 1 + rejected

    from autodist_tpu_torch.runtime import ps_service
    svc = ps_service.CoordPSService(factory, prefix="fencetest")
    with pytest.raises(elastic.FencedOut):
        svc.push_grads(b"blob")
    with pytest.raises(elastic.FencedOut):
        svc.publish(1, b"blob")
    assert svc.pending_grads() == 0  # reads pass; nothing was queued
    svc.close()
    rc.close()
    zombie.close()
    survivor.close()
    c.close()


def test_fence_open_when_service_unreachable():
    """The fence guards against zombies, not against control-plane
    blips: with the service down, writes proceed."""
    def refuse():
        raise OSError("nobody home")
    m = elastic.Membership("w", 1, ["w"], client_factory=refuse)
    m.fence("ps.push")  # no raise
    m.close()


def _tiny_runner(builder=None, optimizer=None):
    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy((rng.randn(8, 4) * 0.3).astype(
        np.float32))}
    batch = {"x": rng.randn(8, 8).astype(np.float32),
             "y": rng.randn(8, 4).astype(np.float32)}

    def loss_fn(p, b):
        return torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                           - torch.as_tensor(b["y"])) ** 2)
    ad = adt.AutoDist(strategy_builder=builder or strategy.AllReduce(),
                      device="cpu")
    runner = ad.build(loss_fn, optimizer or functools.partial(
        torch.optim.SGD, lr=0.05), params, batch)
    runner.init(params)
    return runner, batch


@pytest.mark.parametrize("kind", ["plain", "sharded"])
def test_fenced_save_leaves_the_directory_untouched(server, tmp_path, kind):
    """A zombie's late save is rejected before any file is written (the
    plain saver and the sharded one); its successor saves into the same
    directory."""
    from autodist_tpu_torch.checkpoint import Saver, ShardedSaver
    runner, batch = _tiny_runner()
    runner.run(batch)
    ckpt = tmp_path / "ckpt"
    saver = (Saver if kind == "plain" else ShardedSaver)(
        directory=str(ckpt))
    c = _client(server)
    base = _base_epoch()

    def factory():
        return _client(server)
    elastic.publish_epoch(c, base, ["chief", "w9"])
    elastic.install(elastic.Membership("w9", base, ["chief", "w9"],
                                       client_factory=factory))
    elastic.publish_epoch(c, base + 1, ["chief"])  # w9 is a zombie now
    before = _counter("elastic.fenced_writes")
    with pytest.raises(elastic.FencedOut, match="ckpt.save"):
        saver.save(runner)
    assert not ckpt.exists() or sorted(os.listdir(ckpt)) == []
    assert _counter("elastic.fenced_writes") == before + 1
    elastic.clear()
    elastic.install(elastic.Membership("chief", base + 1, ["chief"],
                                       client_factory=factory))
    assert saver.save(runner) is not None
    assert any(f.endswith("meta.json") for f in os.listdir(ckpt))
    c.close()


def test_partition_fault_holds_and_then_delivers(server):
    """The ``partition`` op holds every proxied request for its window,
    then delivers it late: the zombie-revival timing the fence must
    beat."""
    from autodist_tpu_torch.runtime.faultinject import FaultPlan, FaultyProxy
    plan = FaultPlan({"faults": [
        {"op": "partition", "match": "INC", "nth": 1, "duration_s": 0.8}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan) as proxy:
        c = CoordinationClient("127.0.0.1", proxy.port)
        t0 = time.monotonic()
        assert c.incr("part-n") >= 1      # fires and is held itself
        held = time.monotonic() - t0
        assert held >= 0.7, held           # delivered late, not dropped
        t0 = time.monotonic()
        c.put("part-k", "v")               # the window is over: fast
        assert time.monotonic() - t0 < 0.5
        assert c.get("part-k") == "v"
        assert "partition:INC" in plan.injected
        c.close()


# ------------------------------------------------------- ADT430 / ADT431


def _plan(pkg, kind):
    if pkg == "jax":
        from autodist_tpu.strategy import base
    else:
        from autodist_tpu_torch.strategy import base
    sync = {"allreduce": base.AllReduceSynchronizer(),
            "zero": base.ZeroShardedSynchronizer(),
            "ps_dead_owner": base.PSSynchronizer(
                reduction_destination="localhost:CPU:0", sync=True),
            "ps_chief_owner": base.PSSynchronizer(
                reduction_destination="127.0.0.1:CPU:0", sync=True),
            "tp2": base.AllReduceSynchronizer()}[kind]
    st = base.Strategy(node_config=[
        base.VarConfig(var_name="w", synchronizer=sync),
        base.VarConfig(var_name="b", synchronizer=base.AllReduceSynchronizer(
        ))])
    if kind == "tp2":
        st.graph_config.mesh_shape = {"data": 1, "model": 2}
    return st


@pytest.mark.parametrize("kind", ["allreduce", "zero", "ps_dead_owner",
                                  "ps_chief_owner", "tp2"])
def test_verify_elastic_equals_the_jax_rules(kind):
    """ADT430 (a model axis of size > 1) and ADT431 (a PS group owned by
    the dead worker) with the JAX package's codes, variables, messages
    and fixes."""
    from autodist_tpu.analysis import rules as jax_rules
    from autodist_tpu_torch.analysis import rules
    got = rules.verify_elastic(_plan("torch", kind), dead_worker="localhost")
    want = jax_rules.verify_elastic(_plan("jax", kind),
                                    dead_worker="localhost")
    key = [(d.code, d.var, d.message, d.fixit) for d in got]
    assert key == [(d.code, d.var, d.message, d.fixit) for d in want]
    assert [d.code for d in got] == {
        "allreduce": [], "zero": [], "ps_dead_owner": ["ADT431"],
        "ps_chief_owner": [], "tp2": ["ADT430"]}[kind]
    assert rules.fail_fast_model_axes(_plan("torch", kind)) == \
        jax_rules.fail_fast_model_axes(_plan("jax", kind))


# ------------------------------------------------- snapshot and ZeRO moves


def _zero_dsteps(n):
    """The port's and the JAX package's ZeroSharded steps of one model at
    ``n`` replicas (the port's built with no process group: nothing here
    runs a collective)."""
    import jax.numpy as jnp
    import optax
    import autodist_tpu as jadt
    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.kernel.replicator import ReplicaInfo
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy.base import StrategyCompiler
    spec = {"nodes": [{"address": "127.0.0.1", "chief": True,
                       "cpus": list(range(n))}]}
    params = {"w": torch.ones(8, 5), "b": torch.ones(3)}
    batch = {"x": np.ones((8, 8), np.float32)}

    def loss_fn(p, b):
        return ((torch.as_tensor(b["x"]) @ p["w"]).sum() + p["b"].sum())
    item = ModelItem(loss_fn=loss_fn, optimizer=functools.partial(
        torch.optim.Adam, lr=0.1), params=params,
        example_batch=batch).prepare()
    rs = ResourceSpec.from_dict(spec)
    compiled = StrategyCompiler(item, rs).compile(
        strategy.ZeroSharded().build(item, rs))
    port = GraphTransformer(compiled, item, "cpu",
                            ReplicaInfo(n, 0)).transform()
    jadt.reset()
    try:
        ad = jadt.AutoDist(strategy_builder=jstrategy.ZeroSharded(),
                           resource_spec=JSpec.from_dict(spec))
        jrunner = ad.build(
            lambda p, b: (b["x"] @ p["w"]).sum() + p["b"].sum(),
            optax.adam(0.1), {"w": jnp.ones((8, 5)), "b": jnp.ones(3)},
            batch)
        return port, jrunner.distributed_step
    finally:
        jadt.reset()


@pytest.mark.parametrize("n_old, n_new", [(2, 1), (1, 2), (2, 4), (4, 2)])
def test_zero_moments_move_as_in_the_jax_package(n_old, n_new):
    """The snapshot's ZeRO moments (each leaf ``[N, ...]``, row r rank r's)
    aligned to the rebuilt step's replica count equal the JAX package's
    ``_align_sync_state`` on the same host arrays: re-laid for another
    count, absent at one replica (ZeroSharded degrades to AllReduce
    there) and fresh when the snapshot had none."""
    from autodist_tpu.kernel.common import variable_utils
    from autodist_tpu.runtime import elastic as jax_elastic
    _, jax_old = _zero_dsteps(n_old)
    port_new, jax_new = _zero_dsteps(n_new)
    names, leaves, _ = variable_utils.flatten_named(
        jax_old._sync_state_init())
    rng = np.random.RandomState(n_old * 10 + n_new)
    host_j, host_p = {}, {}
    for name, leaf in zip(names, leaves):
        arr = (np.full(np.shape(leaf), 3, np.asarray(leaf).dtype)
               if name.endswith("count") else
               rng.randn(*np.shape(leaf)).astype(np.float32))
        host_j[name] = arr
        host_p[name.replace("/0/", "/")] = torch.from_numpy(arr)
    tree_j = variable_utils.unflatten_named(
        variable_utils.flatten_named(jax_old._sync_state_init())[2],
        [host_j[n] for n in names])
    tree_p = {}
    for name, t in host_p.items():
        node = tree_p
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    want = jax_elastic._align_sync_state(
        tree_j, {"axes": ["data"], "shape": [n_old], "data_axis": "data"},
        jax_new)
    got, _ = elastic._align_sync_state(tree_p, {"replicas": n_old},
                                       port_new)
    w_names, w_leaves, _ = variable_utils.flatten_named(want)
    want_flat = {n.replace("/0/", "/"): np.asarray(v)
                 for n, v in zip(w_names, w_leaves)}
    from autodist_tpu_torch.kernel.graph_transformer import _named_leaves
    got_flat = _named_leaves(got)
    assert sorted(got_flat) == sorted(want_flat)
    for name, v in want_flat.items():
        np.testing.assert_array_equal(got_flat[name].numpy(), v, err_msg=name)
    assert bool(want_flat) == (n_new > 1)


def test_a_plan_no_survivor_can_rebuild_has_no_snapshot():
    """ZeRO moments sharded across two processes: no survivor holds them
    whole, so the snapshot is None (the rebuild restores a checkpoint)."""
    port, _ = _zero_dsteps(2)

    class _Runner:
        state = object()
        distributed_step = port
    assert elastic.snapshot_runner_state(_Runner()) is None


# ------------------------------------------------ single-process reconfigure


def _arm(monkeypatch, server, tmp_path=None):
    monkeypatch.setenv("ADT_COORDSVC_PORT", str(server.port))
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    monkeypatch.setenv("ADT_ELASTIC_INRUN", "1")
    monkeypatch.setenv("ADT_ELASTIC_POLL_S", "0.01")
    if tmp_path is not None:
        monkeypatch.setenv("ADT_CKPT_DIR", str(tmp_path / "ckpt"))
    # a service of this module holds the epochs of earlier tests: start
    # this job's from a fresh key space by publishing above them
    c = _client(server)
    base = _base_epoch()
    elastic.publish_epoch(c, base, ["127.0.0.1"])
    return c, base


def _builder(name):
    return strategy.PS(sync=True) if name == "PS" else strategy.AllReduce()


@pytest.mark.parametrize("builder", ["AllReduce", "PS"])
def test_inrun_reconfigure_single_process(monkeypatch, server, builder):
    """A real in-run reconfigure at one process: a published epoch with
    the same roster is picked up at the next boundary, the step is
    rebuilt and the state re-placed from the on-card snapshot (for PS the
    new store re-seeded from it); the losses equal the uninterrupted
    run's bit for bit, and the span and counters advance."""
    runner, batch = _tiny_runner(_builder(builder))
    ref = [float(runner.run(batch)["loss"]) for _ in range(8)]
    adt.reset()
    c, base = _arm(monkeypatch, server)
    tel.configure("1")
    try:
        runner, batch = _tiny_runner(_builder(builder))
        m = elastic.current()
        assert m is not None and m.epoch == base, m
        losses = []
        for i in range(8):
            losses.append(float(runner.run(batch)["loss"]))
            if i == 3:
                elastic.publish_epoch(c, base + 1, m.roster)
                time.sleep(0.06)  # past the membership's 50 ms read cache
        stats = runner.step_stats()["elastic"]
        spans = tel.get_recorder().durations_s("elastic.reconfigure")
        reconfigs = tel.counters().get("elastic.reconfigs")
    finally:
        tel.configure(None)
        c.close()
    assert losses == ref
    assert stats["reconfigs"] == 1 and stats["epoch"] == base + 1
    assert stats["last_reconfigure_s"] > 0
    assert len(spans) == 1 and spans[0] > 0
    assert reconfigs == 1.0


@pytest.mark.parametrize("when", ["before_write", "after_write"])
def test_a_failed_step_reruns_or_restores(monkeypatch, server, tmp_path,
                                          when):
    """The re-run rule. A collective failure injected before the step's
    first write (in the metrics' reduction) leaves the state as it was:
    the runner takes the chief's epoch, rebuilds and runs the step again,
    and the losses equal an uninterrupted run's bit for bit. One injected
    after the first write (the optimizer has applied) leaves the state
    torn: the rebuild restores the newest checkpoint (step 2), and the
    step runs on that state."""
    from autodist_tpu_torch.checkpoint import Saver
    opt = functools.partial(torch.optim.Adam, lr=0.05)
    runner, batch = _tiny_runner(optimizer=opt)
    ref = [float(runner.run(batch)["loss"]) for _ in range(6)]
    adt.reset()
    c, base = _arm(monkeypatch, server, tmp_path)
    try:
        runner, batch = _tiny_runner(optimizer=opt)
        losses = [float(runner.run(batch)["loss"]) for _ in range(2)]
        Saver(directory=str(tmp_path / "ckpt")).save(runner)
        losses.append(float(runner.run(batch)["loss"]))
        dstep = runner.distributed_step
        real = {"metrics": dstep._metrics, "update": dstep.optimizer.update}
        fired = []

        def fail():
            fired.append(dstep.writes_begun)
            elastic.publish_epoch(c, base + 1, ["127.0.0.1"])
            raise RuntimeError("[gloo] Connection reset by peer (injected)")

        if when == "before_write":
            def metrics(*a, **kw):
                if not fired:
                    fail()
                return real["metrics"](*a, **kw)
            dstep._metrics = metrics
        else:
            class _Opt:
                def __getattr__(self, k):
                    return getattr(real["update"].__self__, k)

                def update(self, *a, **kw):
                    out = real["update"](*a, **kw)
                    if not fired:
                        fail()
                    return out
            dstep.optimizer = _Opt()
        before = tel.counters().get("elastic.ckpt_fallbacks", 0.0)
        losses.append(float(runner.run(batch)["loss"]))
        fallbacks = tel.counters().get("elastic.ckpt_fallbacks", 0.0) - before
        losses.append(float(runner.run(batch)["loss"]))
    finally:
        c.close()
    assert fired == [when == "after_write"]
    assert runner.step_stats()["elastic"]["reconfigs"] == 1
    assert runner.distributed_step is not dstep
    if when == "before_write":
        assert losses == ref[:5]
        assert int(runner.state.step) == 5 and fallbacks == 0
    else:
        # the checkpoint held step 2: the failed call ran step 2 again
        assert losses[:3] == ref[:3] and losses[3:] == ref[2:4]
        assert int(runner.state.step) == 4 and fallbacks == 1


# ------------------------------------------ straggler marks across epochs


def _mini_coordinator(tmp_path, monkeypatch, server):
    monkeypatch.setenv("ADT_COORDSVC_PORT", str(server.port))
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runtime.cluster import Cluster
    from autodist_tpu_torch.runtime.coordinator import Coordinator
    spec = tmp_path / "spec.yml"
    spec.write_text(
        "nodes:\n  - address: 127.0.0.1\n    chief: true\n    cpus: [0]\n"
        "  - address: localhost\n    cpus: [0]\n")
    return Coordinator("sid-epoch", Cluster(ResourceSpec(str(spec))),
                       heartbeat_timeout=5.0, max_restarts=0)


def test_straggler_flag_does_not_carry_across_epochs(server, tmp_path,
                                                     monkeypatch):
    """A worker flagged straggling in epoch N does not carry the flag
    into its epoch N + 1 incarnation: the admission path collects the
    marks, and the new incarnation's own compile-grace mark still works
    from a clean slate (the JAX test's sequence, answered alike by the
    JAX coordinator on the same service)."""
    from autodist_tpu.runtime.coordinator import Coordinator as JCoordinator
    coord = _mini_coordinator(tmp_path, monkeypatch, server)
    jcoord = types.SimpleNamespace(_heartbeat_timeout=5.0)
    answers = []

    def ask(c):
        mine = (coord._is_straggling(c, "wsx"),
                coord._in_compile_grace(c, "wsx"))
        theirs = (JCoordinator._is_straggling(jcoord, c, "wsx"),
                  mine[1])
        answers.append((mine, theirs))
        return mine
    c = _client(server)
    c.put("straggler/wsx", repr(time.time()))
    c.put("compiling/wsx", repr(time.time()))
    assert ask(c) == (True, True)
    # epoch N + 1: wsx died, was shrunk away, relaunched and admitted —
    # the admission (Coordinator._maybe_admit_joiners) collects its marks
    elastic.gc_worker_marks(c, "wsx")
    assert ask(c) == (False, False)
    c.put("compiling/wsx", repr(time.time()))
    assert ask(c) == (False, True)
    assert all(m[0] == t[0] for m, t in answers)
    coord.stop_watchdog()
    c.close()


def test_a_planned_shrink_waits_for_the_rescue_step(monkeypatch, server):
    """The lockstep rule at the Runner: with a rescue plan for an
    announced leaver at a later step, a parked epoch without the leaver
    is held (more than one replica) until that step, while an epoch that
    keeps it, or one replica, is not; and a leaver that sees its own
    exclusion first runs on to the plan's step, then departs."""
    from autodist_tpu_torch.runtime import preemption
    runner, _ = _tiny_runner()
    guard = runner._preempt
    guard._notice = preemption.PreemptionNotice("peer", time.time() + 30,
                                                "drain")
    guard._plan = {"rescue_step": 5}
    guard._plan_shared = True
    runner._step_count = 3
    assert not guard.holds_reconfigure(["127.0.0.1"])  # one replica
    monkeypatch.setattr(runner.distributed_step.replica_info,
                        "num_processes", 2)
    assert guard.holds_reconfigure(["127.0.0.1"])
    assert not guard.holds_reconfigure(["127.0.0.1", "peer"])
    runner._reconfig_pending = (9, ["127.0.0.1"])
    runner._maybe_reconfigure()
    assert runner._reconfig_pending == (9, ["127.0.0.1"])  # held
    runner._step_count = 5
    assert not guard.holds_reconfigure(["127.0.0.1"])
    runner._reconfig_pending = None
    # the leaver's own exclusion seen before its notice poll: it agrees the
    # plan there and runs on to the plan's step instead of departing
    me = guard.worker
    runner._membership = types.SimpleNamespace(
        worker=me, epoch=8, roster=[me, "other"],
        _with_client=lambda fn: None)
    guard._notice = preemption.PreemptionNotice(me, time.time() + 30,
                                                "drain")
    guard._plan = None

    def agree(notice):
        guard._plan_shared = True
        return {"rescue_step": 7}
    monkeypatch.setattr(guard, "_agree_plan", agree)
    runner._reconfig_pending = (9, ["other"])
    runner._maybe_reconfigure()
    assert runner._reconfig_pending == (9, ["other"])  # held, not departed
    runner._step_count = 7
    with pytest.raises(preemption.PlannedDeparture):
        runner._maybe_reconfigure()
