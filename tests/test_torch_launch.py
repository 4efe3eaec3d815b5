"""Real chief->worker launches of the port over the local transport.

The port's counterpart of the JAX package's ``tests/test_local_launch.py``
and the handoff cases of ``tests/test_distributed.py``: loopback nodes
route ``remote_exec``/``remote_copy`` through local bash/cp, so the
chief-launched flow (the chief relaunches its own script for every other
device entry of the spec, joins every process into one gloo group, builds
the strategy and hands it over, supervises, fail-fasts) runs for real on
the CPU. Every job runs its chief as a subprocess of a user script in
``tmp_path``, on free ports, under a timeout; each process of a job
carries a marker in its environment, and whatever is left of the job is
killed in ``finally``. The JAX references run in the pytest process on
its virtual CPU devices.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest

import autodist_tpu_torch as adt
from autodist_tpu_torch import const

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 5
# a kill limit for one job, far above its usual run (a few seconds to
# some tens under a parallel test run)
JOB_TIMEOUT = 120

# The user script every process runs (the chief from the test, the
# workers as the chief relaunches them). It imports the port only.
USER_SCRIPT = r'''
import functools, json, os, sys, time
import numpy as np
import torch
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.strategy.base import Strategy

spec, outdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
worker = bool(os.environ.get("ADT_WORKER"))
if mode == "external" and worker:
    # the broadcast hands the strategy over: reading a file is a fault
    def no_file(*a, **kw):
        raise AssertionError("the worker read a strategy file")
    Strategy.deserialize = no_file
builder = {"train": lambda: strategy.AllReduce(chunk_size=2),
           "crash": lambda: strategy.AllReduce(chunk_size=2),
           "file": lambda: strategy.AllReduce(chunk_size=2),
           "external": lambda: strategy.PartitionedPS(),
           "async": lambda: strategy.PS(sync=False)}[mode]()
t0 = time.perf_counter()
ad = adt.AutoDist(resource_spec_file=spec, strategy_builder=builder,
                  device="cpu")
construct_s = time.perf_counter() - t0
if mode == "crash" and worker:
    os._exit(3)  # the supervised worker dies; the chief must fail fast
pid = torch.distributed.get_rank()
handed = []
build_or_load = ad._build_or_load_strategy
def capture(item):
    handed.append(build_or_load(item))
    return handed[-1]
ad._build_or_load_strategy = capture

# the JAX tests/dist_driver.py make_case(0), drawn in the same order
rng = np.random.RandomState(0)
params = {"w1": torch.from_numpy((rng.randn(8, 16) * 0.3).astype(np.float32)),
          "b1": torch.zeros(16),
          "w2": torch.from_numpy((rng.randn(16, 4) * 0.3).astype(np.float32))}
batch = {"x": rng.randn(16, 8).astype(np.float32),
         "y": rng.randn(16, 4).astype(np.float32)}

def loss_fn(p, b):
    h = torch.tanh(torch.as_tensor(b["x"]) @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] - torch.as_tensor(b["y"])) ** 2)

step = ad.function(loss_fn, optimizer=functools.partial(torch.optim.SGD,
                                                        lr=0.1),
                   params=params)
losses = [float(step(batch)["loss"]) for _ in range(int(sys.argv[4]))]
out = {"losses": losses, "world": torch.distributed.get_world_size(),
       "device": str(ad.device), "construct_s": construct_s,
       "local_rank": os.environ.get("LOCAL_RANK"),
       "strategy_id": handed[0].id,
       "strategy_json": json.dumps(handed[0].to_dict(), sort_keys=True,
                                   indent=1)}
if mode == "async":
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    runner = step.get_runner()
    store = runner.distributed_step.ps_store
    coord = CoordinationClient("127.0.0.1",
                               adt.ENV.ADT_COORDSVC_PORT.val)
    # every push queued, then every owner queue drained, before the
    # chief reads what its owner published
    runner.distributed_step.flush_ps()
    coord.barrier("launch/pushed", 2)
    store.drain()
    coord.barrier("launch/drained", 2)
    out["applied"] = store.applied_total()
    out["published_version"] = coord.bget("ps:127.0.0.1/vals")[0]
    out["replicas"] = runner.distributed_step.num_replicas
    coord.barrier("launch/read", 2)
    coord.close()
with open(os.path.join(outdir, "out_%d.json" % pid), "w") as f:
    json.dump(out, f)
print("LAUNCH_DONE", pid, losses[-1], flush=True)
'''


def _spec_yaml(entries_a_node):
    cpus = ", ".join(str(i) for i in range(entries_a_node))
    return ("nodes:\n"
            "  - address: 127.0.0.1\n    chief: true\n    cpus: [%s]\n"
            "  - address: localhost\n    cpus: [%s]\n" % (cpus, cpus))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job_pids(marker):
    """Every live process whose environment carries ``marker``."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open("/proc/%s/environ" % entry, "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if marker.encode() in env:
            pids.append(int(entry))
    return pids


def _kill_job(marker):
    for pid in _job_pids(marker):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def _env(tmp_path, marker, **extra):
    env = dict(os.environ)
    for k in ("ADT_DEBUG_REMOTE", "ADT_WORKER", "ADT_STRATEGY_ID",
              "ADT_EXTERNAL_LAUNCH", "ADT_NUM_PROCESSES", "ADT_PROCESS_ID",
              "ADT_DEVICE", "ADT_ELASTIC", "LOCAL_RANK"):
        env.pop(k, None)
    env.update({
        "ADT_COORDINATOR_ADDR": "127.0.0.1:%d" % _free_port(),
        "ADT_COORDSVC_PORT": str(_free_port()),
        "ADT_WORKING_DIR": str(tmp_path / "work"),
        "OMP_NUM_THREADS": "1",
        "ADT_TEST_JOB": marker,
        "PYTHONPATH": os.pathsep.join(
            [os.path.dirname(HERE)] +
            ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
             else [])),
    })
    env.update(extra)
    return env


def _write(tmp_path, entries_a_node=1):
    script = tmp_path / "user_script.py"
    script.write_text(USER_SCRIPT)
    spec = tmp_path / "spec.yml"
    spec.write_text(_spec_yaml(entries_a_node))
    return script, spec


def _run_chief(tmp_path, mode, entries_a_node=1, steps=STEPS, **extra):
    """Run the user script as the CHIEF only — it must launch its own
    workers through the local transport. Returns the completed process
    and the pids of the job's processes still alive a few seconds after
    the chief's exit (read before whatever is left is killed)."""
    script, spec = _write(tmp_path, entries_a_node)
    marker = "ADT_TEST_JOB=%s" % uuid.uuid4().hex
    env = _env(tmp_path, marker.split("=", 1)[1], **extra)
    # files, not pipes: a process the chief leaves behind would hold a
    # pipe open and hide the chief's own exit
    logs = [tmp_path / "chief.out", tmp_path / "chief.err"]
    with open(logs[0], "w") as out_f, open(logs[1], "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, str(script), str(spec), str(tmp_path), mode,
             str(steps)], env=env, stdout=out_f, stderr=err_f, text=True,
            start_new_session=True)
    try:
        proc.wait(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail("the job outlived %d s:\n%s" % (
            JOB_TIMEOUT, "".join(p.read_text() for p in logs)[-4000:]))
    finally:
        # a process the chief stopped on its way out may take a moment
        deadline = time.monotonic() + 5
        while _job_pids(marker) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = _job_pids(marker)
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        _kill_job(marker)
        proc.wait()
    out, err = (p.read_text() for p in logs)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out,
                                       err), left


def _outputs(tmp_path, n, log):
    outs = []
    for pid in range(n):
        path = tmp_path / ("out_%d.json" % pid)
        assert path.exists(), "process %d wrote no output\n%s" % (
            pid, log[-4000:])
        outs.append(json.loads(path.read_text()))
    return outs


def _jax_losses(devices):
    """The JAX package's run of the same case in this process, on
    ``devices`` of its virtual CPU devices (one node)."""
    import optax
    import autodist_tpu as jadt
    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    from dist_driver import make_case
    jadt.reset()
    try:
        params, loss_fn, batch = make_case()
        ad = jadt.AutoDist(
            strategy_builder=jstrategy.AllReduce(chunk_size=2),
            resource_spec=JSpec.from_dict({"nodes": [{
                "address": "127.0.0.1", "cpus": list(range(devices))}]}))
        step = ad.function(loss_fn, optimizer=optax.sgd(0.1), params=params)
        return [float(step(batch)["loss"]) for _ in range(STEPS)]
    finally:
        jadt.reset()


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()


@pytest.mark.parametrize("entries_a_node", [1, 2],
                         ids=["two_nodes", "two_nodes_two_entries"])
def test_chief_launches_and_trains_with_its_workers(tmp_path,
                                                    entries_a_node):
    """One command on the chief: the chief launches every other entry's
    process (with two entries a node, two of them on its own host), the
    job trains in lockstep, and every rank's losses are bit-equal and
    within 1e-5 of the JAX package on as many devices."""
    n = 2 * entries_a_node
    res, left = _run_chief(tmp_path, "train", entries_a_node)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-4000:]
    assert "local_exec[localhost]" in res.stderr, res.stderr[-2000:]
    assert "process group backend gloo: rank 0 runs on the CPU" in \
        res.stderr, res.stderr[-2000:]
    outs = _outputs(tmp_path, n, log)
    for pid, out in enumerate(outs):
        assert out["world"] == n and out["device"] == "cpu"
        assert out["local_rank"] == (None if pid == 0 else
                                     str(pid % entries_a_node))
        np.testing.assert_array_equal(out["losses"], outs[0]["losses"])
        # every worker trains the chief's plan, handed over as a file
        assert out["strategy_json"] == outs[0]["strategy_json"]
    assert outs[0]["losses"][-1] < outs[0]["losses"][0]
    np.testing.assert_allclose(outs[0]["losses"], _jax_losses(n),
                               rtol=1e-5, atol=1e-6)
    assert not left


def test_chief_fails_fast_when_a_worker_dies(tmp_path):
    """The launched worker exits 3 right after ``AutoDist()``: the
    chief's watcher aborts the whole job with exit code 1 instead of
    hanging in a collective, and no process of the job is left."""
    res, left = _run_chief(tmp_path, "crash")
    assert res.returncode == 1, (res.returncode, res.stderr[-4000:])
    assert "exited with code 3 — aborting job" in res.stderr, \
        res.stderr[-2000:]
    # the watcher stopped the service and the other workers before
    # exiting
    assert not left


def test_a_chief_that_fails_to_start_stops_its_workers(tmp_path):
    """The chief launches its worker, then its own join fails (its
    coordinator port is taken): the error reaches the chief's caller,
    and the worker it launched is stopped, not left waiting for a
    rendezvous that never comes."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        res, left = _run_chief(
            tmp_path, "train",
            ADT_COORDINATOR_ADDR="127.0.0.1:%d" % taken.getsockname()[1])
    assert res.returncode == 1, (res.returncode, res.stderr[-4000:])
    assert "local_exec[localhost]" in res.stderr, res.stderr[-2000:]
    assert "EADDRINUSE" in res.stderr, res.stderr[-2000:]
    assert not left


def test_async_ps_launched_by_the_chief(tmp_path):
    """``PS(sync=False)`` launched by the chief: the test starts no
    service — the chief's ``Cluster.start`` does. Each process trains at
    one replica of its own, its loss falls, and the chief's owner group
    published at least its own applies."""
    res, left = _run_chief(tmp_path, "async", steps=10)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-4000:]
    chief, worker = _outputs(tmp_path, 2, log)
    for out in (chief, worker):
        assert out["replicas"] == 1
        assert out["losses"][-1] < out["losses"][0]
    assert chief["published_version"] >= 10, chief
    assert chief["applied"] == chief["published_version"]
    assert not left


# ------------------------------------------------------------ the handoffs


def _run_pair(tmp_path, mode, strategy_id, external):
    """Start chief and worker from the test (no launch: the test stands
    in for the Coordinator), joined from the env; returns both outputs."""
    script, spec = _write(tmp_path)
    marker = uuid.uuid4().hex
    addr, svc = "127.0.0.1:%d" % _free_port(), str(_free_port())
    procs = []
    try:
        for pid in range(2):
            extra = {"ADT_COORDINATOR_ADDR": addr, "ADT_COORDSVC_PORT": svc,
                     "ADT_NUM_PROCESSES": "2", "ADT_PROCESS_ID": str(pid),
                     "ADT_STRATEGY_ID": strategy_id,
                     "ADT_DEBUG_REMOTE": "1"}
            if external:
                extra["ADT_EXTERNAL_LAUNCH"] = "1"
            if pid:
                extra["ADT_WORKER"] = "localhost"
                # the worker's own (empty) working dir under the broadcast
                if external:
                    extra["ADT_WORKING_DIR"] = str(tmp_path / "worker_work")
            env = _env(tmp_path, marker, **extra)
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(spec), str(tmp_path),
                 mode, "3"], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                start_new_session=True))
        logs = [p.communicate(timeout=JOB_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail("the pair outlived %d s" % JOB_TIMEOUT)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
        _kill_job("ADT_TEST_JOB=" + marker)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return _outputs(tmp_path, 2, "\n".join(logs))


def _fresh_id(tag):
    """A strategy id of this test alone."""
    return "launch-test-%s-%d-%s" % (tag, os.getpid(), uuid.uuid4().hex[:8])


def test_external_launch_hands_the_strategy_over_a_broadcast(tmp_path):
    """``ADT_EXTERNAL_LAUNCH``: both processes started together under
    ``PartitionedPS()``; the worker's strategy arrives over
    ``broadcast_bytes`` byte-equal to the chief's serialized file, and no
    file for that id is read on the worker (its working dir is empty and
    ``Strategy.deserialize`` raises there)."""
    sid = _fresh_id("external")
    chief, worker = _run_pair(tmp_path, "external", sid, external=True)
    written = (tmp_path / "work" / "strategies" / sid).read_text()
    assert chief["strategy_json"] == written
    assert worker["strategy_json"] == written
    assert worker["strategy_id"] == sid
    assert not (tmp_path / "worker_work" / "strategies" / sid).exists()
    np.testing.assert_array_equal(chief["losses"], worker["losses"])


def test_file_handoff_by_preset_id(tmp_path):
    """The chief-launched handoff with the test standing in for the copy
    (the JAX ``test_distributed.py`` pair, ``external=False``): a preset
    ``ADT_STRATEGY_ID`` pins the id, the chief serializes, the worker
    polls for the file and trains the same plan in lockstep."""
    sid = _fresh_id("file")
    stale = tmp_path / "work" / "strategies" / sid
    assert not stale.exists()
    chief, worker = _run_pair(tmp_path, "file", sid, external=False)
    assert chief["strategy_id"] == worker["strategy_id"] == sid
    assert worker["strategy_json"] == stale.read_text()
    np.testing.assert_array_equal(chief["losses"], worker["losses"])


def test_worker_raises_when_the_strategy_file_never_comes(monkeypatch):
    """A chief-launched worker whose strategy file never lands raises the
    JAX message after ``ADT_STRATEGY_WAIT_S``."""
    import torch
    from autodist_tpu_torch import strategy
    sid = _fresh_id("missing")
    path = os.path.join(const.DEFAULT_SERIALIZATION_DIR, sid)
    if os.path.exists(path):
        os.unlink(path)
    monkeypatch.setenv("ADT_WORKER", "localhost")
    monkeypatch.setenv("ADT_STRATEGY_ID", sid)
    monkeypatch.setenv("ADT_STRATEGY_WAIT_S", "1")
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    params = {"w": torch.zeros(2, 2)}
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="strategy %s not available after 1s; did the "
                             "chief fail before serializing" % sid):
        ad.build(lambda p, b: (p["w"] * b["x"]).sum(), None, params,
                 {"x": np.ones((2, 2), np.float32)})
    assert 1.0 <= time.monotonic() - t0 < 10


def test_broadcast_bytes_delivers_rank_zeros_payload(tmp_path):
    """``server_starter.broadcast_bytes`` over a two-rank gloo group:
    0 bytes, 1 byte and 1 MiB arrive equal on both ranks."""
    from torch_dist_worker import launch
    rng = np.random.RandomState(0)
    payloads = [b"", b"\x07", rng.bytes(1 << 20)]
    ranks = launch("broadcast_bytes", 2, tmp_path, payloads)
    for got in ranks:
        assert got == payloads
