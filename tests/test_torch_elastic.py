"""Supervised recovery's parts, held to the JAX package where both give
the same answer; no job is launched (``test_torch_elastic_launch.py``
launches them).

The elastic knobs' loud validation (the JAX ``tests/test_elastic_epoch.py``
cases), the reap helpers, the restart soundness gate and budget (the JAX
``tests/test_elastic.py`` cases), mark hygiene on the port's coordination
service, the watchdog's filters, supervision across a service bounce (the
JAX ``tests/test_faults.py`` case, in a subprocess), then the port's own:
the whole-job restart's once-guard and earliest-exit blame under gloo's
fast errors, the chief's wait on a failed collective, the ``build``
refusals, and the acceptance of in-run shrink and grow (ROADMAP A item
8.3b; ``test_torch_elastic_epoch.py`` holds its plane).
"""
import os
import re
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import coordinator as port_coordinator
from autodist_tpu_torch.runtime import elastic as port_elastic
from autodist_tpu_torch.runtime import server_starter
from autodist_tpu_torch.runtime.cluster import Cluster

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGES = ["jax", "torch"]
_ELASTIC_ENV = ("ADT_ELASTIC", "ADT_ELASTIC_SYNC", "ADT_ELASTIC_INRUN",
                "ADT_ELASTIC_EXCLUDE", "ADT_ELASTIC_RESTARTS",
                "ADT_ELASTIC_LAST_DEAD", "ADT_ELASTIC_LAST_DEAD_STEP",
                "ADT_AUTO_RESUME", "ADT_WORKER", "ADT_NUM_PROCESSES",
                "ADT_PROCESS_ID", "ADT_STRATEGY_ID", "ADT_DEVICE",
                "ADT_EXTERNAL_LAUNCH", "ADT_COORDINATOR_ADDR",
                "ADT_DEBUG_REMOTE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # set, then delete: the undo then restores each variable as it was,
    # also one the whole-job restart writes into os.environ itself
    for k in _ELASTIC_ENV:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    adt.reset()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pkg(name):
    """(elastic module, coordinator module, strategy base module, Cluster,
    ResourceSpec) of one package."""
    if name == "jax":
        from autodist_tpu.resource_spec import ResourceSpec as JSpec
        from autodist_tpu.runtime import coordinator, elastic
        from autodist_tpu.runtime.cluster import Cluster as JCluster
        from autodist_tpu.strategy import base
        return elastic, coordinator, base, JCluster, JSpec
    from autodist_tpu_torch.strategy import base
    return port_elastic, port_coordinator, base, Cluster, ResourceSpec


SPEC = {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]},
                  {"address": "localhost", "cpus": [0]}]}


# ------------------------------------------------------------ knob validation


# (env, error raised or None, the knob the message names)
KNOB_CASES = [
    ({"ADT_ELASTIC": "-1"}, "config", "ADT_ELASTIC"),
    ({"ADT_ELASTIC": "two"}, "config", "ADT_ELASTIC"),
    ({"ADT_ELASTIC": "1", "ADT_ELASTIC_SYNC": "yes"}, "config",
     "ADT_ELASTIC_SYNC"),
    ({"ADT_ELASTIC": "1", "ADT_ELASTIC_SYNC": "0", "ADT_ELASTIC_INRUN": "1"},
     "config", "ADT_ELASTIC_INRUN"),
    ({"ADT_ELASTIC": "0", "ADT_ELASTIC_SYNC": "1", "ADT_ELASTIC_INRUN": "1"},
     "config", "ADT_ELASTIC_INRUN"),
    ({"ADT_ELASTIC": "2", "ADT_ELASTIC_SYNC": "1"}, None, (2, True, False)),
    ({"ADT_ELASTIC": "2", "ADT_ELASTIC_SYNC": "1", "ADT_ELASTIC_INRUN": "1"},
     None, (2, True, True)),
    ({"ADT_ELASTIC": "3"}, None, (3, False, False)),
    ({}, None, (0, False, False)),
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("env, error, knob", KNOB_CASES,
                         ids=["negative", "not_int", "sync_not_bool",
                              "inrun_without_sync", "inrun_without_budget",
                              "sync", "inrun", "async", "unset"])
def test_elastic_knobs_validated_loudly(monkeypatch, pkg, env, error, knob):
    """Garbage knobs raise ``ElasticConfigError`` naming the knob, with
    the same message in both packages; valid ones parse alike."""
    elastic = _pkg(pkg)[0]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if error is None:
        assert tuple(elastic.validate_elastic_knobs()) == knob
        return
    with pytest.raises(elastic.ElasticConfigError) as e:
        elastic.validate_elastic_knobs()
    assert e.value.knob == knob
    if pkg == "torch":
        from autodist_tpu.runtime import elastic as jax_elastic
        with pytest.raises(jax_elastic.ElasticConfigError) as j:
            jax_elastic.validate_elastic_knobs()
        assert str(e.value) == str(j.value)


def test_inrun_refused_naming_its_item(monkeypatch):
    """A valid in-run request is no longer refused (ROADMAP A item 8.3b
    is ported): the knobs parse to the JAX package's ``(2, True, True)``,
    ``AutoDist()`` comes up, and a Coordinator comes up with its in-run
    plane on (it shrinks in-run before any whole-job restart)."""
    for k, v in (("ADT_ELASTIC", "2"), ("ADT_ELASTIC_SYNC", "1"),
                 ("ADT_ELASTIC_INRUN", "1")):
        monkeypatch.setenv(k, v)
    from autodist_tpu.runtime import elastic as jax_elastic
    assert jax_elastic.validate_elastic_knobs() == (2, True, True)
    assert port_elastic.validate_elastic_knobs() == (2, True, True)
    adt.AutoDist(device="cpu")
    coord = port_coordinator.Coordinator(
        "sid", Cluster(ResourceSpec.from_dict(SPEC)))
    assert coord._inrun is True
    assert coord._sync_elastic


@pytest.mark.parametrize("pkg", PACKAGES)
def test_coordinator_validates_knobs_at_construction(monkeypatch, pkg):
    """The chief's supervision refuses to come up over a garbage budget:
    the error fires at bring-up, not at the first death."""
    elastic, coordinator, _, cluster, spec = _pkg(pkg)
    monkeypatch.setenv("ADT_ELASTIC", "nope")
    with pytest.raises(elastic.ElasticConfigError, match="ADT_ELASTIC"):
        coordinator.Coordinator("sid", cluster(spec.from_dict(SPEC)))


# ---------------------------------------------------------- reap helpers


COMMANDS = ["python -u /tmp/s.py a b",
            "python -u /runs/exp+1/train.py --lr (0.1)",
            "/srv/env/bin/python -u '/a b/[x]{2}^$.py' --k=v|w\\z?"]


@pytest.mark.parametrize("command", COMMANDS)
def test_reap_helpers_equal_the_jax_ones(command):
    """The pkill pattern matches the launched command (regex
    metacharacters included) but never the wrapper that embeds it, and
    both helpers give the JAX package's strings."""
    from autodist_tpu.runtime import coordinator as jax_coordinator
    pat = port_coordinator._reap_pattern(command)
    assert pat == jax_coordinator._reap_pattern(command)
    assert re.search(pat, command), (pat, command)
    assert not re.search(pat, "bash -c pkill -f %s || true" % pat)
    assert port_coordinator._reap_command(command, "sid-1") == \
        jax_coordinator._reap_command(command, "sid-1")
    assert port_coordinator._ere_escape(command) == \
        jax_coordinator._ere_escape(command)


# ------------------------------------------------ soundness gate and budget


def _coordinator_for(pkg, strategy, max_restarts=1):
    """A Coordinator of ``pkg`` over the 2-node loopback cluster with
    ``strategy`` serialized under an id of this test (nothing
    launched)."""
    _, coordinator, _, cluster, spec = _pkg(pkg)
    strategy.id = "elastic-unit-%s-%d-%d" % (pkg, os.getpid(),
                                             time.monotonic_ns())
    strategy.serialize()
    return coordinator.Coordinator(strategy.id, cluster(spec.from_dict(SPEC)),
                                   max_restarts=max_restarts)


def _strategy(pkg, kind, dest="127.0.0.1:CPU:0"):
    base = _pkg(pkg)[2]
    if kind == "allreduce":
        sync = base.AllReduceSynchronizer()
    else:
        sync = base.PSSynchronizer(reduction_destination=dest,
                                   sync=kind == "sync_ps")
    return base.Strategy(node_config=[base.VarConfig(var_name="w",
                                                     synchronizer=sync)])


# (strategy kind, owner, ADT_ELASTIC, dead worker, verdict: None or a word
# of the reason)
SOUNDNESS = [
    ("async_ps", "127.0.0.1:CPU:0", "1", "localhost", None),
    ("sync_ps", "127.0.0.1:CPU:0", "1", "localhost", "not async"),
    ("async_ps", "localhost:CPU:0", "1", "localhost", "OWNS"),
    ("async_ps", "localhost:CPU:0", "1", "10.0.0.9", None),
    ("allreduce", "", "1", "localhost", "not async"),
    ("async_ps", "127.0.0.1:CPU:0", None, "localhost", "ADT_ELASTIC"),
]


@pytest.mark.parametrize("kind, owner, budget, dead, verdict", SOUNDNESS,
                         ids=["async_ps", "sync_ps", "dead_owner",
                              "surviving_owner", "allreduce", "no_elastic"])
def test_restart_soundness_verdicts_equal_the_jax_ones(
        monkeypatch, kind, owner, budget, dead, verdict):
    """A restart is sound only for all-async host PS whose owners
    survive, and only after an ``ADT_ELASTIC`` bring-up: both packages
    give the same verdict for the same serialized strategy."""
    if budget is not None:
        monkeypatch.setenv("ADT_ELASTIC", budget)
    for pkg in PACKAGES:
        coord = _coordinator_for(pkg, _strategy(pkg, kind, owner))
        reason = coord._restart_unsound_reason(dead)
        if verdict is None:
            assert reason is None, (pkg, reason)
        else:
            assert verdict in reason, (pkg, reason)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restart_budget_exhausts_to_fail_fast(monkeypatch, pkg):
    """The first death relaunches (a dry run: nothing starts), the second
    finds the budget of 1 spent. The port keys its bookkeeping by process
    id, the JAX package by node address."""
    monkeypatch.setenv("ADT_DEBUG_REMOTE", "1")
    monkeypatch.setenv("ADT_ELASTIC", "1")
    coord = _coordinator_for(pkg, _strategy(pkg, "async_ps"))
    if pkg == "jax":
        key = "localhost"
        coord._launch_cmds[key] = ("python -u x.py", {})
    else:
        key = 1
        coord._launch_cmds[key] = ("localhost", "python -u x.py", {})
    assert coord._try_restart(key, 3) is True
    assert coord._try_restart(key, 3) is False


# ------------------------------------------------------- watchdog filters


@pytest.fixture(scope="module")
def service():
    from autodist_tpu_torch.runtime.coordination import CoordinationServer
    srv = CoordinationServer(port=_free_port())
    srv.start()
    yield srv
    srv.stop()


def test_mark_gc_scrubs_a_dead_incarnation(service):
    """``gc_worker_marks`` deregisters the worker's heartbeat and
    tombstones its compiling and straggler marks, so a dead incarnation
    neither ages into a false death nor covers the next one."""
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    coord = port_coordinator.Coordinator(
        "sid-gc", Cluster(ResourceSpec.from_dict(SPEC),
                          coordsvc_port=service.port),
        heartbeat_timeout=5.0, max_restarts=0)
    c = CoordinationClient("127.0.0.1", service.port)
    try:
        c.heartbeat("wgc")
        c.put("compiling/wgc", repr(time.time()))
        c.put("straggler/wgc", repr(time.time()))
        assert coord._in_compile_grace(c, "wgc") is True
        assert "wgc" not in c.dead_workers(5.0)
        port_elastic.gc_worker_marks(c, "wgc")
        assert coord._in_compile_grace(c, "wgc") is False
        assert c.get("straggler/wgc") == "0"
        assert "wgc" not in c.dead_workers(0.0)
    finally:
        c.close()


class _Marks:
    """A coordination client's ``get`` over a dict of marks."""

    def __init__(self, marks):
        self.marks = marks

    def get(self, key):
        return self.marks.get(key)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("age_s, mark, in_grace", [
    (1.0, None, True), (700.0, None, False), (None, "0", False),
    (None, None, False)], ids=["fresh", "expired", "cleared", "none"])
def test_compile_grace(pkg, age_s, mark, in_grace):
    """A fresh ``compiling`` mark shields a silent worker; one older than
    ``max(2 x the heartbeat window, ADT_COMPILE_GRACE_S)`` (600 s), the
    "0" tombstone and no mark do not."""
    coord = _pkg(pkg)[1].Coordinator(
        "sid", _pkg(pkg)[3](_pkg(pkg)[4].from_dict(SPEC)),
        heartbeat_timeout=6.0)
    if age_s is not None:
        mark = repr(time.time() - age_s)
    client = _Marks({} if mark is None else {"compiling/w": mark})
    assert coord._in_compile_grace(client, "w") is in_grace


def _silent_worker(service, name, window_s):
    """A watchdog on ``service`` and a client, with ``name`` silent past
    ``window_s`` while its compile mark is fresh (a long first
    dispatch)."""
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    coord = port_coordinator.Coordinator(
        "sid-" + name, Cluster(ResourceSpec.from_dict(SPEC),
                               coordsvc_port=service.port),
        heartbeat_timeout=window_s, max_restarts=0)
    c = CoordinationClient("127.0.0.1", service.port)
    c.heartbeat(name)
    c.put("compiling/%s" % name, repr(time.time()))
    time.sleep(window_s + 0.2)
    return coord, c


def test_the_end_of_a_long_first_dispatch_is_no_death(service):
    """The watchdog reads the silent list, then the worker's first
    dispatch returns (``Runner._compile_grace_end``: a beat, then the
    mark cleared), then the watchdog reads the marks: the cleared mark no
    longer shields the worker, but the list read again after the marks
    (``Coordinator._still_silent``) drops it, so a live worker is not
    declared dead at the end of a first dispatch longer than the
    window."""
    from autodist_tpu_torch.runtime.runner import Runner
    coord, c = _silent_worker(service, "wend", 1.0)
    try:
        dead = [d for d in c.dead_workers(1.0) if d == "wend"]
        assert dead == ["wend"]
        runner = types.SimpleNamespace(
            _compile_grace_marked=True, _compile_grace_cleared=False,
            _async_hb=c, _coord=None, _worker="wend", _last_hb=0.0)
        Runner._compile_grace_end(runner)
        assert c.get("compiling/wend") == "0" and runner._last_hb > 0
        assert coord._supervised(c, dead) == ["wend"]
        assert coord._still_silent(c, coord._supervised(c, dead)) == []
    finally:
        port_elastic.gc_worker_marks(c, "wend")
        c.close()


def test_a_worker_silent_on_both_reads_stays_dead(service):
    """The second read keeps a worker that stayed silent: with its mark
    cleared and no beat since, the watchdog acts on it."""
    coord, c = _silent_worker(service, "wstill", 1.0)
    try:
        c.put("compiling/wstill", "0")
        dead = [d for d in c.dead_workers(1.0) if d == "wstill"]
        assert coord._still_silent(c, coord._supervised(c, dead)) == [
            "wstill"]
        assert coord._still_silent(c, []) == []
    finally:
        port_elastic.gc_worker_marks(c, "wstill")
        c.close()


def test_watchdog_filters_bring_up_grace_and_the_chief():
    """The watchdog leaves alone the chief, a worker whose relaunch is
    younger than twice the heartbeat window, and one in its compile
    grace; an older relaunch is acted on. The relaunch time is kept by
    process id and read by the heartbeat's node name."""
    coord = port_coordinator.Coordinator(
        "sid", Cluster(ResourceSpec.from_dict(
            {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]},
                       {"address": "localhost", "cpus": [0]},
                       {"address": "10.0.0.2", "cpus": [0]}]})),
        heartbeat_timeout=6.0)
    coord._launch_cmds = {1: ("10.0.0.2", "c", {}), 2: ("localhost", "c", {})}
    now = time.monotonic()
    coord._restart_at = {1: now - 13.0, 2: now - 5.0}
    client = _Marks({"compiling/w3": repr(time.time())})
    got = coord._supervised(client, ["chief", "localhost", "10.0.0.2", "w3",
                                     "w4"])
    assert got == ["10.0.0.2", "w4"]


def test_supervision_resumes_after_a_service_bounce(tmp_path):
    """Bounce the service under a live watchdog, then let a worker go
    silent: the watchdog reconnects, sees the silence and aborts (no
    budget), exiting 1. In a subprocess, because the abort is
    ``os._exit(1)``."""
    port = _free_port()
    script = tmp_path / "watchdog_bounce.py"
    script.write_text("""
import time
import types
PORT = %d
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime.cluster import Cluster
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     CoordinationServer)
from autodist_tpu_torch.runtime.coordinator import Coordinator

srv = CoordinationServer(PORT)
srv.start()
spec = ResourceSpec.from_dict(
    {"nodes": [{"address": "127.0.0.1", "chief": True, "cpus": [0]}]})
coord = Coordinator("watchdog-bounce-test", Cluster(spec, coordsvc_port=PORT),
                    heartbeat_timeout=1.0)
coord.start_watchdog()
print("WATCHDOG_UP", flush=True)
time.sleep(1.5)   # the watchdog polls at least once
srv.stop()        # a service blip: the watchdog's client dies
time.sleep(1.0)
srv = CoordinationServer(PORT)
srv.start()       # the service returns on the same port
print("BOUNCED", flush=True)
c = CoordinationClient("127.0.0.1", PORT)
c.heartbeat("w1") # a fresh record on the fresh service...
c.close()
time.sleep(20)    # ...then silence: the reconnected watchdog must abort
print("STILL_ALIVE", flush=True)
""" % port)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE)
    env["OMP_NUM_THREADS"] = "1"
    env.pop("ADT_ELASTIC", None)
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        try:
            os.killpg(proc.pid, 9)
        except OSError:
            pass
    assert "WATCHDOG_UP" in out and "BOUNCED" in out, out + err
    assert "STILL_ALIVE" not in out, out
    assert "re-established; supervision resumed" in err, err[-3000:]
    assert "missed heartbeats — aborting" in err, err[-3000:]
    assert proc.returncode == 1


# ------------------------------------------------- the whole-job restart


@pytest.fixture
def sync_chief(monkeypatch, tmp_path):
    """A sync-elastic Coordinator of three processes (127.0.0.1 with two
    entries, localhost with one) in a dry run, whose exec is recorded
    instead of made; a checkpoint at step 3 exists."""
    monkeypatch.setenv("ADT_DEBUG_REMOTE", "1")
    monkeypatch.setenv("ADT_ELASTIC", "3")
    monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    monkeypatch.setenv("ADT_CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(port_coordinator, "RESTART_SETTLE_S", 0.3)
    monkeypatch.setattr(port_coordinator, "_close_inherited_on_exec",
                        lambda: None)
    from autodist_tpu_torch import checkpoint
    monkeypatch.setattr(checkpoint, "latest_checkpoint",
                        lambda d: (3, None))
    execs = []
    monkeypatch.setattr(os, "execv", lambda *a: execs.append(a))
    coord = port_coordinator.Coordinator(
        "sid-sync", Cluster(ResourceSpec.from_dict(
            {"nodes": [{"address": "127.0.0.1", "chief": True,
                        "cpus": [0, 1]},
                       {"address": "localhost", "cpus": [0]}]})))
    coord._launch_cmds = {1: ("127.0.0.1", "c1", {}),
                          2: ("localhost", "c2", {})}
    return coord, execs


def _deaths(coord, deaths):
    """Deliver ``(pid, code, stamp, delay)`` deaths from one thread each,
    as the process watchers do; returns each ``_on_exit``'s verdict."""
    got = {}

    def die(pid, code, stamp, delay):
        time.sleep(delay)
        got[pid] = coord._on_exit(pid, code, stamp)
    threads = [threading.Thread(target=die, args=d) for d in deaths]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return got


def test_one_restart_blames_the_earliest_exit(sync_chief):
    """Under gloo the survivors exit within milliseconds of the death that
    took their collective, and their watchers may run first: the restart
    is claimed once (every death reads as handled, one exec), and it
    blames the process whose exit came first, not the first watcher."""
    coord, execs = sync_chief
    t0 = time.monotonic()
    got = _deaths(coord, [(1, 1, t0 + 0.2, 0.0),     # a survivor, first
                          (2, 3, t0 + 0.1, 0.05)])   # the death, earlier
    assert got == {1: True, 2: True}
    assert len(execs) == 1
    assert execs[0][1][1:] == sys.argv
    assert os.environ["ADT_ELASTIC_LAST_DEAD"] == "localhost"
    assert os.environ["ADT_ELASTIC_LAST_DEAD_STEP"] == "3"
    assert os.environ["ADT_ELASTIC_RESTARTS"] == "1"
    assert os.environ["ADT_AUTO_RESUME"] == "1"
    assert "ADT_ELASTIC_EXCLUDE" not in os.environ
    # a death after the claim is the teardown: no second exec
    assert coord._on_exit(1, 1, time.monotonic()) is True
    assert len(execs) == 1


def test_the_restart_waits_for_a_save_in_flight(sync_chief, monkeypatch):
    """The worker dies right after the save before its death, while the
    chief still writes that checkpoint: the restart reads the newest
    checkpoint only once the write has committed."""
    coord, execs = sync_chief
    from autodist_tpu_torch import checkpoint
    committed = []
    probed = []
    monkeypatch.setattr(checkpoint, "latest_checkpoint", lambda d: (
        probed.append(bool(committed)), (3, None))[1])

    def write():
        with checkpoint.saver._writing():
            time.sleep(1.0)
            committed.append(True)
    t = threading.Thread(target=write)
    t.start()
    time.sleep(0.05)
    assert coord._on_exit(2, 3, time.monotonic()) is True
    t.join()
    assert probed == [True] and len(execs) == 1


@pytest.mark.parametrize("last_dead, excluded, restarts", [
    ("localhost", "localhost", 1),   # twice, no progress: excluded
    ("127.0.0.1", None, 1),          # the chief's node: fail fast
    ("localhost", None, 3),          # the budget (3) is spent
], ids=["excluded", "chief_node", "budget_spent"])
def test_restart_exclusion_and_fail_fast(sync_chief, monkeypatch, last_dead,
                                         excluded, restarts):
    """A node whose worker dies again with no checkpoint progress is
    excluded and the job restarts without it; the chief's node cannot be
    excluded, and a spent budget fails fast."""
    coord, execs = sync_chief
    monkeypatch.setenv("ADT_ELASTIC_RESTARTS", str(restarts))
    monkeypatch.setenv("ADT_ELASTIC_LAST_DEAD", last_dead)
    monkeypatch.setenv("ADT_ELASTIC_LAST_DEAD_STEP", "3")
    pid = 2 if last_dead == "localhost" else 1
    ok = coord._on_exit(pid, 3, time.monotonic())
    if excluded:
        assert ok is True and len(execs) == 1
        assert os.environ["ADT_ELASTIC_EXCLUDE"] == excluded
        assert os.environ["ADT_ELASTIC_RESTARTS"] == "2"
    else:
        assert ok is False and execs == []


def test_a_failed_collective_waits_for_the_restart(sync_chief):
    """The chief's main thread hands a failed collective to the
    Coordinator: it returns only after the restart's exec (here
    recorded; a real exec replaces the process), never before the
    watcher has decided."""
    coord, execs = sync_chief

    def later():
        time.sleep(0.3)
        coord._on_exit(2, 3, time.monotonic())
    t = threading.Thread(target=later)
    t.start()
    coord.await_restart(RuntimeError("Connection closed by peer"),
                        timeout=20)
    assert len(execs) == 1
    t.join()


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_a_failed_collective_with_no_death_propagates(monkeypatch, sync):
    """No worker dies: a sync-elastic chief gives up after its timeout,
    any other returns at once, and the error is the caller's."""
    monkeypatch.setenv("ADT_ELASTIC", "1")
    if sync:
        monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    coord = port_coordinator.Coordinator(
        "sid", Cluster(ResourceSpec.from_dict(SPEC)))
    t0 = time.monotonic()
    coord.await_restart(RuntimeError("shape mismatch"), timeout=0.5)
    took = time.monotonic() - t0
    assert (0.5 <= took < 5) if sync else took < 0.5


def test_the_runner_hands_a_failed_collective_over(monkeypatch):
    """At more than one replica a ``RuntimeError`` inside a step goes to
    ``coordinator.collective_failed`` before it propagates; at one
    replica it does not."""
    from autodist_tpu_torch.runtime.runner import Runner
    seen = []
    monkeypatch.setattr(port_coordinator, "collective_failed", seen.append)
    errors = []
    for replicas in (2, 1):
        fake = type("R", (), {})()
        fake._dstep = type("D", (), {"num_replicas": replicas})()
        errors.append(RuntimeError("Connection closed by peer"))
        with pytest.raises(RuntimeError) as e:
            with Runner._collectives(fake):
                raise errors[-1]
        assert e.value is errors[-1]
    assert seen == errors[:1]


# --------------------------------------------------- bring-up and build


@pytest.mark.parametrize("pkg", PACKAGES)
def test_elastic_refuses_an_external_launch(monkeypatch, pkg):
    """Async elastic needs the chief-launched flow: an external launcher
    gets the JAX package's ValueError, word for word."""
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_EXTERNAL_LAUNCH", "1")
    if pkg == "jax":
        from autodist_tpu.runtime import server_starter as starter
    else:
        starter = server_starter
    with pytest.raises(ValueError, match=re.escape(
            "ADT_ELASTIC requires the chief-launched flow; externally-"
            "launched jobs (ADT_EXTERNAL_LAUNCH) restart workers through "
            "their own launcher instead")):
        starter.maybe_init_distributed()


def _build(pkg, builder_name, **kw):
    """Build a one-variable model in ``pkg`` under ``builder_name``."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 8).astype(np.float32)
    w = (rng.randn(8, 4) * 0.3).astype(np.float32)
    if pkg == "jax":
        import jax.numpy as jnp
        import optax
        import autodist_tpu as jadt
        from autodist_tpu import strategy as jstrategy
        from autodist_tpu.resource_spec import ResourceSpec as JSpec
        jadt.reset()
        try:
            ad = jadt.AutoDist(
                strategy_builder=getattr(jstrategy, builder_name)(**kw),
                resource_spec=JSpec.from_dict({"nodes": [{
                    "address": "127.0.0.1", "cpus": [0]}]}))
            ad.build(lambda p, b: jnp.mean(b["x"] @ p["w"]), optax.sgd(0.1),
                     {"w": jnp.asarray(w)}, {"x": x})
        finally:
            jadt.reset()
        return
    from autodist_tpu_torch import strategy
    ad = adt.AutoDist(strategy_builder=getattr(strategy, builder_name)(**kw),
                      device="cpu")
    ad.build(lambda p, b: torch.mean(torch.as_tensor(b["x"]) @ p["w"]),
             None, {"w": torch.from_numpy(w)}, {"x": x})


@pytest.mark.parametrize("pkg", PACKAGES)
def test_build_refuses_a_sync_plan_without_elastic_sync(monkeypatch, pkg):
    """``ADT_ELASTIC`` on a sync plan of more than one process needs
    ``ADT_ELASTIC_SYNC=1`` at bring-up."""
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match=re.escape(
            "ADT_ELASTIC on a sync strategy needs ADT_ELASTIC_SYNC=1 at "
            "bring-up (the ")):
        _build(pkg, "AllReduce")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_build_refuses_elastic_sync_on_an_async_plan(monkeypatch, pkg):
    """``ADT_ELASTIC_SYNC`` on an async-PS plan is refused."""
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    with pytest.raises(ValueError, match=re.escape(
            "ADT_ELASTIC_SYNC is set but the strategy is async PS: unset it "
            "— async elastic restarts workers individually and must not "
            "pin the process set with ")):
        _build(pkg, "PS", sync=False)


def test_async_elastic_bring_up_joins_no_group(monkeypatch):
    """An async-elastic worker joins no process group, and the chief's
    ``Cluster.start`` starts the service and marks the bring-up done
    without joining."""
    import torch.distributed as dist
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_WORKER", "localhost")
    monkeypatch.setenv("ADT_COORDINATOR_ADDR", "127.0.0.1:%d" % _free_port())
    monkeypatch.setenv("ADT_NUM_PROCESSES", "2")
    monkeypatch.setenv("ADT_PROCESS_ID", "1")
    server_starter.maybe_init_distributed("cpu")
    assert not dist.is_initialized()
    monkeypatch.delenv("ADT_WORKER")
    monkeypatch.setattr(server_starter, "_ELASTIC_STARTED", False)
    cluster = Cluster(ResourceSpec.from_dict(SPEC), coordsvc_port=_free_port())
    try:
        cluster.start("cpu")
        assert server_starter.initialized() and not dist.is_initialized()
        assert cluster._coordsvc is not None
    finally:
        cluster.stop_coordination_service()
