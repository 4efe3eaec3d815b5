"""The port's launch plane in dry run (``ADT_DEBUG_REMOTE``): layout,
worker env, the remote helpers and the Coordinator's launch, held to the
JAX package's ``tests/test_cluster.py`` cases where both packages give
the same answer; then the port's own: one process a device entry, the
backend rule, the address helpers against the JAX ones, the elastic
bring-up (in-run shrink and grow accepted) and the refusals."""
import functools
import os
import socket

import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu_torch import const
from autodist_tpu_torch import strategy
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import server_starter
from autodist_tpu_torch.runtime import cluster as cluster_lib
from autodist_tpu_torch.runtime.cluster import Cluster
from autodist_tpu_torch.runtime.coordinator import Coordinator
from autodist_tpu_torch.utils import network


@pytest.fixture(autouse=True)
def _debug_remote(monkeypatch):
    monkeypatch.setenv(const.ENV.ADT_DEBUG_REMOTE.name_str, "1")
    for k in ("ADT_WORKER", "ADT_COORDINATOR_ADDR", "ADT_NUM_PROCESSES",
              "ADT_PROCESS_ID", "ADT_DEVICE", "ADT_ELASTIC",
              "ADT_ELASTIC_SYNC", "ADT_ELASTIC_INRUN",
              "ADT_EXTERNAL_LAUNCH", "ADT_STRATEGY_ID"):
        monkeypatch.delenv(k, raising=False)
    yield
    adt.reset()


def _spec_dict():
    """The JAX test's spec, the chief listed second, at one device entry
    a node (where the two packages' layouts agree)."""
    return {"nodes": [{"address": "10.0.0.2", "tpus": 1},
                      {"address": "10.0.0.1", "tpus": 1, "chief": True}],
            "ssh": {"g": {"username": "u", "key_file": "/k"}}}


def _package(pkg):
    """(ResourceSpec, cluster class, Coordinator, Strategy, const) of one
    package."""
    if pkg == "jax":
        from autodist_tpu import const as jconst
        from autodist_tpu.resource_spec import ResourceSpec as JSpec
        from autodist_tpu.runtime.cluster import SSHCluster as JCluster
        from autodist_tpu.runtime.coordinator import Coordinator as JCoord
        from autodist_tpu.strategy.base import Strategy as JStrategy
        return JSpec, JCluster, JCoord, JStrategy, jconst
    from autodist_tpu_torch.strategy.base import Strategy
    return ResourceSpec, Cluster, Coordinator, Strategy, const


PACKAGES = ["jax", "torch"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_deterministic_process_layout(pkg):
    spec_cls, cluster_cls, _, _, pconst = _package(pkg)
    c = cluster_cls(spec_cls.from_dict(_spec_dict()))
    assert c.num_processes == 2
    assert c.process_addresses == ["10.0.0.1", "10.0.0.2"]  # chief first
    assert c.process_id("10.0.0.1") == 0
    assert c.process_id("10.0.0.2") == 1
    assert c.coordinator_address == \
        "10.0.0.1:%d" % pconst.DEFAULT_COORDINATOR_PORT


@pytest.mark.parametrize("pkg", PACKAGES)
def test_worker_env(pkg):
    spec_cls, cluster_cls, _, _, _ = _package(pkg)
    c = cluster_cls(spec_cls.from_dict(_spec_dict()))
    env = c.worker_env("10.0.0.2")
    assert env["ADT_WORKER"] == "10.0.0.2"
    assert env["ADT_PROCESS_ID"] == "1"
    assert env["ADT_NUM_PROCESSES"] == "2"
    assert env["ADT_COORDINATOR_ADDR"] == c.coordinator_address


@pytest.mark.parametrize("pkg", PACKAGES)
def test_remote_exec_dry_run(pkg):
    spec_cls, cluster_cls, _, _, _ = _package(pkg)
    c = cluster_cls(spec_cls.from_dict(_spec_dict()))
    assert c.remote_exec("echo hi", "10.0.0.2", env={"A": "1"}) is None
    assert c.remote_copy("/tmp/x", "/tmp/dir", "10.0.0.2") is True


@pytest.mark.parametrize("pkg", PACKAGES)
def test_coordinator_launch_dry_run(pkg):
    spec_cls, cluster_cls, coord_cls, strategy_cls, _ = _package(pkg)
    s = strategy_cls()
    s.serialize()
    c = cluster_cls(spec_cls.from_dict(_spec_dict()))
    coord = coord_cls(s, c)
    coord.launch_clients()  # dry-run: no processes spawned
    coord.join()


def test_launch_command_and_env(monkeypatch):
    """The relaunched command is this interpreter on the same script;
    the env carries the layout, the strategy id, the service port and
    the chief's working dir, for process 1 only (process 0 is the
    chief)."""
    from autodist_tpu_torch.utils import logging as tlogging
    lines = []
    monkeypatch.setattr(tlogging, "info",
                        lambda msg, *a: lines.append(msg % a))
    monkeypatch.setattr("sys.argv", ["/job/train.py", "spec one.yml"])
    c = Cluster(ResourceSpec.from_dict(_spec_dict()), coordsvc_port=4242)
    Coordinator("sid-1", c).launch_clients(copy_strategy=False)
    launched = [x for x in lines if x.startswith("remote_exec[")]
    assert len(launched) == 1 and launched[0].startswith(
        "remote_exec[10.0.0.2]: ssh ")
    for part in ("ADT_PROCESS_ID=1", "ADT_STRATEGY_ID=sid-1",
                 "ADT_COORDSVC_PORT=4242", "ADT_DEVICE=cuda:0",
                 "ADT_WORKING_DIR=", "LOCAL_RANK=0", "-u /job/train.py",
                 "'spec one.yml'"):
        assert part in launched[0], (part, launched[0])


def test_one_process_a_device_entry():
    """2 nodes x 2 entries: four processes, the chief's node first, each
    on its own listed card (not on cuda:<LOCAL_RANK>), with LOCAL_RANK
    its position within its node; the second process of the chief's
    node is a worker."""
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "10.0.0.2", "gpus": [0, 1]},
        {"address": "10.0.0.1", "gpus": [3, 5], "chief": True}]})
    c = Cluster(spec)
    assert c.num_processes == 4
    assert c.process_addresses == ["10.0.0.1", "10.0.0.1", "10.0.0.2",
                                   "10.0.0.2"]
    assert c.node_addresses == ["10.0.0.1", "10.0.0.2"]
    assert [c.device(p) for p in range(4)] == ["cuda:3", "cuda:5",
                                               "cuda:0", "cuda:1"]
    assert [c.local_rank(p) for p in range(4)] == [0, 1, 0, 1]
    assert [c.process_id(a, r) for a in ("10.0.0.1", "10.0.0.2")
            for r in (0, 1)] == [0, 1, 2, 3]
    env = c.worker_env("10.0.0.1", 1)
    assert env["ADT_WORKER"] == "10.0.0.1"      # a worker on the chief node
    assert (env["ADT_PROCESS_ID"], env["LOCAL_RANK"], env["ADT_DEVICE"],
            env["ADT_NUM_PROCESSES"]) == ("1", "1", "cuda:5", "4")
    env = c.worker_env("10.0.0.2", 1)
    assert (env["ADT_PROCESS_ID"], env["LOCAL_RANK"],
            env["ADT_DEVICE"]) == ("3", "1", "cuda:1")
    with pytest.raises(ValueError, match="no local rank 2"):
        c.process_id("10.0.0.2", 2)


def test_cpu_nodes_lay_out_their_cpu_entries():
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "127.0.0.1", "chief": True, "cpus": [0, 1]},
        {"address": "localhost", "cpus": [0, 1, 2]}]})
    c = Cluster(spec)
    assert c.num_processes == 5
    assert {c.device(p) for p in range(5)} == {"cpu"}
    assert c.process_addresses == ["127.0.0.1"] * 2 + ["localhost"] * 3
    assert c._is_local("localhost") and c._is_local("127.0.0.1")


def test_coordinator_copies_the_strategy_to_the_other_nodes_only(
        monkeypatch):
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "10.0.0.1", "gpus": [0, 1], "chief": True},
        {"address": "10.0.0.2", "gpus": [0, 1]},
        {"address": "10.0.0.3", "gpus": [0]}]})
    c = Cluster(spec)
    copied = []
    monkeypatch.setattr(c, "remote_copy",
                        lambda path, d, address: copied.append(address))
    Coordinator("sid", c).distribute_strategy()
    assert copied == ["10.0.0.2", "10.0.0.3"]


ADDRESSES = ["127.0.0.1", "127.0.0.1:TPU:0", "localhost", "localhost:15999",
             "::1", "[::1]:80", "[fe80::1]:8470", "fe80::1", "10.0.0.1",
             "10.0.0.1:GPU:3", "h:GPU:0", "192.0.2.7", "0.0.0.0"]


def test_network_helpers_agree_with_the_jax_package(monkeypatch):
    """``_host_of``, ``is_loopback_address`` and ``is_local_address`` on
    a fixed list of addresses. The JAX module's outbound-interface probe
    (a UDP socket toward a public address) is stubbed to fail, as on a
    machine without a route, so the test touches no outside address."""
    from autodist_tpu.utils import network as jnetwork

    def no_socket(*a, **kw):
        raise OSError("no outbound probe in tests")
    monkeypatch.setattr(jnetwork.socket, "socket", no_socket)
    addresses = ADDRESSES + [socket.gethostname(),
                             socket.gethostname() + ":GPU:1"]
    for a in addresses:
        assert network._host_of(a) == jnetwork._host_of(a), a
        assert network.is_loopback_address(a) == \
            jnetwork.is_loopback_address(a), a
        assert network.is_local_address(a) == jnetwork.is_local_address(a), a
    assert network._host_of("h:GPU:0") == "h"
    assert network._host_of("[::1]:80") == "::1"
    assert network.is_local_address(socket.gethostname())
    assert not network.is_local_address("192.0.2.7")


@pytest.mark.parametrize("placements,backend,reason", [
    ([("a", "GPU-0"), ("a", "GPU-1")], "nccl",
     "each of the 2 ranks has a card of its own"),
    ([("a", "GPU-0"), ("b", "GPU-0")], "nccl",
     "each of the 2 ranks has a card of its own"),
    ([("a", "GPU-0")], "nccl", "each of the 1 ranks has a card of its own"),
    ([("a", "GPU-0"), ("a", "GPU-1"), ("a", "GPU-0")], "gloo",
     "ranks 0 and 2 share card GPU-0 on a"),
    ([("a", "GPU-0"), ("b", None)], "gloo", "rank 1 runs on the CPU"),
    ([("a", None), ("a", None)], "gloo", "rank 0 runs on the CPU"),
], ids=["two_cards", "two_hosts", "one_rank", "shared_card", "a_cpu_rank",
        "cpus"])
def test_backend_rule(placements, backend, reason):
    got, why = server_starter.choose_backend(placements)
    assert got == backend
    assert why.startswith(reason), why


def _elastic_coordinator():
    coord = Coordinator("sid", Cluster(ResourceSpec.from_dict(_spec_dict())))
    # in-run shrink is tried before any whole-job restart
    assert coord._inrun == bool(const.ENV.ADT_ELASTIC_INRUN.val)


def _elastic_autodist():
    """Construct, build and init a one-process job: under the in-run knobs
    its membership is armed at the launch epoch on the job's service."""
    import functools
    import numpy as np
    import torch
    from autodist_tpu_torch.runtime import elastic
    from autodist_tpu_torch.runtime.coordination import CoordinationServer
    inrun = const.ENV.ADT_ELASTIC_INRUN.val
    srv = None
    if inrun:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            srv = CoordinationServer(port=sock.getsockname()[1])
    try:
        if srv is not None:
            srv.start()
            os.environ[const.ENV.ADT_COORDSVC_PORT.name_str] = str(srv.port)
        ad = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                          device="cpu")
        params = {"w": torch.ones(4, 2)}
        batch = {"x": np.ones((4, 4), np.float32)}
        runner = ad.build(lambda p, b: (torch.as_tensor(b["x"])
                                        @ p["w"]).sum(),
                          functools.partial(torch.optim.SGD, lr=0.1),
                          params, batch)
        runner.init(params)
        m = elastic.current()
        if inrun:
            assert m is not None and m.epoch == 1 and m.roster == [
                "127.0.0.1"], m
            assert runner.step_stats()["elastic"]["epoch"] == 1
        else:
            assert m is None
    finally:
        os.environ.pop(const.ENV.ADT_COORDSVC_PORT.name_str, None)
        adt.reset()
        if srv is not None:
            srv.stop()


@pytest.mark.parametrize("construct", [
    _elastic_coordinator, server_starter.maybe_init_distributed,
    _elastic_autodist], ids=["coordinator", "maybe_init_distributed",
                             "autodist"])
def test_elastic_is_refused_naming_its_roadmap_item(monkeypatch, construct):
    """``ADT_ELASTIC=1`` (supervised recovery, item 8.3a) is accepted, and
    so, since item 8.3b is ported, is in-run shrink and grow
    (``ADT_ELASTIC_INRUN=1`` with the knobs it needs): the Coordinator
    comes up with its in-run plane on, the bring-up joins as before, and
    AutoDist arms the membership at epoch 1."""
    monkeypatch.setenv("ADT_ELASTIC", "1")
    construct()
    adt.reset()
    monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    monkeypatch.setenv("ADT_ELASTIC_INRUN", "1")
    construct()


def _two_cpu_nodes():
    return ResourceSpec.from_dict({"nodes": [
        {"address": "127.0.0.1", "chief": True, "cpus": [0]},
        {"address": "localhost", "cpus": [0]}]})


@pytest.mark.parametrize("env", [{"ADT_EXTERNAL_LAUNCH": "1"},
                                 {"ADT_WORKER": "localhost"}],
                         ids=["external", "worker"])
def test_no_launch_outside_the_chief_launched_flow(monkeypatch, env):
    """A multi-node spec launches nothing under an external launcher or
    on a worker; nor does a single-node spec."""
    from autodist_tpu_torch.runtime import coordinator

    def refuse(*a, **kw):
        raise AssertionError("a Coordinator was made")
    monkeypatch.setattr(coordinator.Coordinator, "__init__", refuse)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ad = adt.AutoDist(resource_spec=_two_cpu_nodes(), device="cpu")
    assert ad._coordinator is None
    adt.reset()
    monkeypatch.delenv("ADT_DEBUG_REMOTE")
    ad = adt.AutoDist(device="cpu")
    assert ad._coordinator is None and ad.resource_spec.is_single_node()


@pytest.mark.parametrize("builder", ["async", "sync"])
def test_dry_run_logs_the_launch_and_joins_nothing(monkeypatch, builder):
    """A multi-node chief under ``ADT_DEBUG_REMOTE``: ``AutoDist()``
    logs the worker's launch command and ``build()`` logs the strategy's
    copy, and nothing is started or joined. The one process then builds
    as the one replica it is: an async plan (one replica a process)
    builds and runs, a sync plan of two replicas raises the replica
    check at once."""
    from autodist_tpu_torch.utils import logging as tlogging
    lines = []
    monkeypatch.setattr(tlogging, "info",
                        lambda msg, *a: lines.append(msg % a))

    def refuse(*a, **kw):
        raise AssertionError("a dry run started or joined something")
    monkeypatch.setattr(cluster_lib.subprocess, "Popen", refuse)
    monkeypatch.setattr(server_starter, "init_distributed", refuse)
    sid = "dry-run-%s" % builder
    monkeypatch.setenv("ADT_STRATEGY_ID", sid)
    ad = adt.AutoDist(
        resource_spec=_two_cpu_nodes(), device="cpu",
        strategy_builder=(strategy.PS(sync=False) if builder == "async"
                          else strategy.AllReduce()))
    assert [x for x in lines if x.startswith("local_exec[")] == [
        x for x in lines if x.startswith("local_exec[localhost]: ")
        and "ADT_PROCESS_ID=1" in x and "ADT_STRATEGY_ID=" + sid in x]
    assert not server_starter.initialized()
    params = {"w": torch.ones(4, 2)}
    batch = {"x": np.ones((2, 4), np.float32)}

    def loss_fn(p, b):
        return (torch.as_tensor(b["x"]) @ p["w"]).square().mean()
    if builder == "sync":
        with pytest.raises(ValueError, match="the plan has 2 replicas but "
                                             "the process group has 1"):
            ad.build(loss_fn, None, params, batch)
    else:
        runner = ad.build(loss_fn, functools.partial(torch.optim.SGD,
                                                     lr=0.1), params, batch)
        runner.init(params)
        assert np.isfinite(float(runner.run(batch)["loss"]))
    assert any(x.startswith("local_copy[localhost]: ") and sid in x
               for x in lines), lines


def test_async_ps_refuses_two_processes_on_one_node(monkeypatch):
    """Async PS owner groups are per host: two processes on one node
    would both claim it, so the layout is refused."""
    monkeypatch.setenv("ADT_NUM_PROCESSES", "2")
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "127.0.0.1", "chief": True, "cpus": [0, 1]}]})
    ad = adt.AutoDist(strategy_builder=strategy.PS(sync=False),
                      resource_spec=spec, device="cpu")
    params = {"w": torch.zeros(4, 2)}
    with pytest.raises(ValueError,
                       match="node 127.0.0.1 lists 2 device entries, so 2 "
                             "processes would claim its one owner group"):
        ad.build(lambda p, b: (torch.as_tensor(b["x"]) @ p["w"]).sum(),
                 None, params, {"x": torch.ones(2, 4).numpy()})


def test_a_listed_card_that_is_not_visible_raises(monkeypatch):
    """``gpus: [0, 1]`` on a machine that sees one card: the launched
    process of ``cuda:1`` raises the missing-card error before it meets
    any peer, and never carries on with one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "127.0.0.1", "chief": True, "gpus": [0, 1]},
        {"address": "localhost", "gpus": [0]}]})
    env = Cluster(spec).worker_env("127.0.0.1", 1)
    assert env["ADT_DEVICE"] == "cuda:1"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        env["ADT_COORDINATOR_ADDR"] = "127.0.0.1:%d" % s.getsockname()[1]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="device cuda:1 does not exist: "
                                           "1 CUDA device"):
        adt.AutoDist(resource_spec=spec)
    assert not server_starter.initialized()
