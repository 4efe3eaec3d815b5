"""Supervised recovery of chief-launched jobs over the local transport.

The port's counterpart of the JAX package's ``tests/test_elastic.py``
launch cases: loopback nodes run ``remote_exec`` through local bash, so
the chief relaunches its own script for every other device entry of the
spec, and ``ADT_ELASTIC=<budget>`` makes a worker's death recoverable —
a relaunch of the dead worker under async PS (crashed or wedged: the
heartbeat watchdog), a re-exec of the whole job from its newest
checkpoint under ``ADT_ELASTIC_SYNC=1`` (at full world, and at reduced
world once a node is found permanently lost), or with
``ADT_ELASTIC_INRUN=1`` an in-run shrink to the survivor and a grow when
the relaunched worker is admitted back (the JAX ``tests/test_elastic.py``
in-run case), which falls back to the whole-job restart when the
survivors never ack the shrink or the topology cannot shrink (a
``TensorParallel`` mesh, ADT430). A spent budget or a job
with nothing to restore still fails fast with exit code 1. Every job runs
its chief as a subprocess on free ports under a timeout, on the CPU over
gloo; each process of a job carries a marker in its environment (the
re-exec keeps the chief's pid and environment), and whatever is left of
the job is killed in ``finally``. The JAX references run in the pytest
process on its virtual CPU devices.
"""
import json
import os
import re
import signal
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest

import autodist_tpu_torch as adt
from test_torch_launch import _free_port, _job_pids, _kill_job

HERE = os.path.dirname(os.path.abspath(__file__))
# a kill limit for one job, far above its usual run (a few seconds to a
# minute under a parallel test run)
JOB_TIMEOUT = 240
# the relaunched async worker's first dispatch lasts this long: past the
# watchdog's bring-up grace (2 x 6 s after the relaunch) and a heartbeat
# window, so only its compile-grace mark keeps it alive
SLOW_FIRST_DISPATCH_S = 14

# The async job (the JAX USER_SCRIPT): the worker's first incarnation
# crashes or hangs after step 2; the chief steps until the (relaunched)
# worker reports in. argv: spec, out dir, mode ("crash" or "hang").
ASYNC_SCRIPT = r'''
import functools, json, os, sys, time
import numpy as np
import torch
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy

spec, outdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
ad = adt.AutoDist(resource_spec_file=spec,
                  strategy_builder=strategy.PS(sync=False), device="cpu")
rng = np.random.RandomState(0)
params = {"w": torch.from_numpy((rng.randn(8, 4) * 0.3).astype(np.float32))}
batch = {"x": rng.randn(8, 8).astype(np.float32),
         "y": rng.randn(8, 4).astype(np.float32)}
slow = []

def loss_fn(p, b):
    if slow:
        time.sleep(slow.pop())
    return torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                       - torch.as_tensor(b["y"])) ** 2)

runner = ad.build(loss_fn, functools.partial(torch.optim.SGD, lr=0.05),
                  params, batch)
runner.init(params)
is_worker = bool(os.environ.get("ADT_WORKER"))
marker = os.path.join(outdir, "crashed_once")
if is_worker:
    restarted = os.path.exists(marker)
    if restarted and mode == "hang":
        slow.append(float(os.environ["SLOW_FIRST_DISPATCH_S"]))
    losses = []
    for i in range(12):
        losses.append(float(runner.run(batch)["loss"]))
        if i == 2 and not restarted:
            with open(marker, "w") as f:
                f.write("x")
            if mode == "crash":
                os._exit(3)  # the first incarnation dies mid-run
            time.sleep(3600)  # alive but silent: the watchdog must act
    with open(os.path.join(outdir, "out_worker.json"), "w") as f:
        json.dump({"losses": losses, "restarted": restarted}, f)
    print("WORKER_DONE", restarted, flush=True)
else:
    # the chief keeps stepping (async: no barrier with the worker) and
    # exits once the (relaunched) worker reports in
    worker_out = os.path.join(outdir, "out_worker.json")
    losses = []
    deadline = time.monotonic() + 200
    while time.monotonic() < deadline and not os.path.exists(worker_out):
        losses.append(float(runner.run(batch)["loss"]))
        time.sleep(0.05)
    runner.distributed_step.flush_ps()
    applied = runner.distributed_step.ps_store.applied_total()
    with open(os.path.join(outdir, "out_chief.json"), "w") as f:
        json.dump({"losses": losses, "applied": applied,
                   "worker_done": os.path.exists(worker_out)}, f)
    print("CHIEF_DONE", flush=True)
'''

# The sync job (the JAX SYNC_USER_SCRIPT and REDUCED_WORLD_SCRIPT): SGD at
# 0.05, a save after every step. argv: spec, out dir, mode, rows, the
# builder (a name in ``strategy``), SGD's momentum. The modes: "once" —
# the localhost worker's first incarnation dies after step 2's save;
# "forever" — the same, and every later incarnation of it dies at its
# start (the node is gone); "early" — it dies right after AutoDist(),
# before any save.
SYNC_SCRIPT = r'''
import functools, json, os, sys
import numpy as np
spec, outdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
rows, builder, momentum = int(sys.argv[4]), sys.argv[5], float(sys.argv[6])
doomed = os.environ.get("ADT_WORKER") == "localhost"
gone = os.path.join(outdir, "worker_gone")
if doomed and os.path.exists(gone):
    os._exit(3)  # the host is "gone": every relaunch dies at its start
import torch
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.checkpoint import Saver

ad = adt.AutoDist(resource_spec_file=spec,
                  strategy_builder=getattr(strategy, builder)(), device="cpu")
if doomed and mode == "early":
    os._exit(3)
rng = np.random.RandomState(0)
params = {"w": torch.from_numpy((rng.randn(8, 4) * 0.3).astype(np.float32))}
batch = {"x": rng.randn(rows, 8).astype(np.float32),
         "y": rng.randn(rows, 4).astype(np.float32)}

def loss_fn(p, b):
    return torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                       - torch.as_tensor(b["y"])) ** 2)

runner = ad.build(loss_fn, functools.partial(torch.optim.SGD, lr=0.05,
                                             momentum=momentum),
                  params, batch)
runner.init(params)  # ADT_AUTO_RESUME restores on the re-exec'd run
start = int(runner.state.step)
saver = Saver(directory=os.environ["ADT_CKPT_DIR"])
rank = torch.distributed.get_rank()
marker = os.path.join(outdir, "crashed_once")
losses = {}
for i in range(start, 8):
    losses[i] = float(runner.run(batch)["loss"])
    saver.save(runner)  # every process calls it; rank 0 writes
    if doomed and i == 2 and not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("x")
        if mode == "forever":
            with open(gone, "w") as f:
                f.write("x")
        os._exit(3)  # the first incarnation dies mid-lockstep
with open(os.path.join(outdir, "out_%d.json" % rank), "w") as f:
    json.dump({"start": start, "losses": losses,
               "world": torch.distributed.get_world_size(),
               "params": runner.gather_params()["w"].tolist()}, f)
print("DONE rank=%d start=%d" % (rank, start), flush=True)
'''


# The in-run job (the JAX INRUN_CHAOS_SCRIPT): SGD at 0.05, 8 rows, a save
# after every step; the localhost worker's first incarnation exits 3 after
# step 2. argv: spec, out dir, mode — "grow": the chief, after step 3,
# waits (at most 60 s) until the relaunched worker is admitted; "noack":
# the chief's first incarnation sleeps 8 s after step 2, past the ack
# timeout, so the shrink escalates to the whole-job restart; "tp": under
# TensorParallel(2) (a model axis of size 2, ADT430), which cannot
# shrink in-run.
INRUN_SCRIPT = r'''
import functools, json, os, sys, time
import numpy as np
spec, outdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
worker = os.environ.get("ADT_WORKER") == "localhost"
resumed = bool(os.environ.get("ADT_AUTO_RESUME"))
import torch
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.telemetry import spans as tel

tel.configure("1")
builder = (strategy.TensorParallel(2, []) if mode == "tp"
           else strategy.AllReduce())
ad = adt.AutoDist(resource_spec_file=spec, strategy_builder=builder,
                  device="cpu")
rng = np.random.RandomState(0)
params = {"w": torch.from_numpy((rng.randn(8, 4) * 0.3).astype(np.float32))}
batch = {"x": rng.randn(8, 8).astype(np.float32),
         "y": rng.randn(8, 4).astype(np.float32)}

def loss_fn(p, b):
    return torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                       - torch.as_tensor(b["y"])) ** 2)

runner = ad.build(loss_fn, functools.partial(torch.optim.SGD, lr=0.05),
                  params, batch)
runner.init(params)  # a joiner adopts the chief's state here
start = int(runner.state.step)
saver = Saver(directory=os.environ["ADT_CKPT_DIR"])
marker = os.path.join(outdir, "died_once")
losses, worlds = {}, {}
for i in range(start, 8):
    losses[i] = float(runner.run(batch)["loss"])
    worlds[i] = runner.distributed_step.num_replicas
    saver.save(runner)  # every process calls it; rank 0 writes
    if worker and i == 2 and not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(3)  # the first incarnation dies after step 2
    if not worker and i == 2 and mode == "noack" and not resumed:
        time.sleep(8)  # never at a boundary while the ack timer runs
    if not worker and i == 3 and mode == "grow":
        m = elastic.current()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            info = m.peek(fresh=True)
            if info is not None and info[0] > m.epoch:
                break
            time.sleep(0.05)
m = elastic.current()
role = "worker" if worker else "chief"
with open(os.path.join(outdir, "inrun_%s_%d.json" % (role, start)),
          "w") as f:
    json.dump({"start": start, "losses": losses, "worlds": worlds,
               "reconfigs": runner.step_stats()["elastic"]["reconfigs"],
               "epoch": m.epoch if m is not None else None,
               "spans": tel.get_recorder().durations_s(
                   "elastic.reconfigure"),
               "params": runner.gather_params()["w"].tolist()}, f)
print("DONE", role, start, flush=True)
'''


def _spec_yaml(chief_entries=1):
    cpus = ", ".join(str(i) for i in range(chief_entries))
    return ("nodes:\n"
            "  - address: 127.0.0.1\n    chief: true\n    cpus: [%s]\n"
            "  - address: localhost\n    cpus: [0]\n" % cpus)


def _run_chief(tmp_path, script_text, args, chief_entries=1, **extra):
    """Run ``script_text`` as the chief only (it launches its workers);
    returns the completed process and the pids of the job's processes
    still alive a few seconds after the chief's exit (read before
    whatever is left is killed by the marker)."""
    script = tmp_path / "user_script.py"
    script.write_text(script_text)
    spec = tmp_path / "spec.yml"
    spec.write_text(_spec_yaml(chief_entries))
    marker = uuid.uuid4().hex
    env = dict(os.environ)
    for k in ("ADT_DEBUG_REMOTE", "ADT_WORKER", "ADT_STRATEGY_ID",
              "ADT_EXTERNAL_LAUNCH", "ADT_NUM_PROCESSES", "ADT_PROCESS_ID",
              "ADT_DEVICE", "LOCAL_RANK", "ADT_ELASTIC_SYNC",
              "ADT_ELASTIC_INRUN", "ADT_ELASTIC_EXCLUDE",
              "ADT_ELASTIC_RESTARTS", "ADT_ELASTIC_LAST_DEAD",
              "ADT_ELASTIC_LAST_DEAD_STEP", "ADT_AUTO_RESUME",
              "ADT_HEARTBEAT_TIMEOUT_S"):
        env.pop(k, None)
    coord_port = _free_port()
    env.update({
        "ADT_COORDINATOR_ADDR": "127.0.0.1:%d" % coord_port,
        "ADT_COORDSVC_PORT": str(_free_port()),
        "ADT_WORKING_DIR": str(tmp_path / "work"),
        "ADT_CKPT_DIR": str(tmp_path / "ckpt"),
        "ADT_ELASTIC": "1",
        "OMP_NUM_THREADS": "1",
        "ADT_TEST_JOB": marker,
        "PYTHONPATH": os.pathsep.join(
            [os.path.dirname(HERE)] +
            ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
             else [])),
    })
    env.update(extra)
    marker = "ADT_TEST_JOB=" + marker
    # files, not pipes: a process the chief leaves behind would hold a
    # pipe open and hide the chief's own exit
    logs = [tmp_path / "chief.out", tmp_path / "chief.err"]
    with open(logs[0], "w") as out_f, open(logs[1], "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / "spec.yml"),
             str(tmp_path)] + [str(a) for a in args], env=env, stdout=out_f,
            stderr=err_f, text=True, start_new_session=True)
    try:
        proc.wait(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail("the job outlived %d s:\n%s" % (
            JOB_TIMEOUT, "".join(p.read_text() for p in logs)[-6000:]))
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
    res = subprocess.CompletedProcess(proc.args, proc.returncode, out, err)
    res.coord_port = coord_port
    return res, left


def _read(tmp_path, name, log):
    path = tmp_path / name
    assert path.exists(), "no %s\n%s" % (name, log[-6000:])
    return json.loads(path.read_text())


def _jax_run(rows, momentum=None, steps=8):
    """The JAX package's uninterrupted run of the sync job's math in this
    process, on two of its virtual CPU devices: (losses, final w)."""
    import jax.numpy as jnp
    import optax
    import autodist_tpu as jadt
    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    jadt.reset()
    try:
        rng = np.random.RandomState(0)
        params = {"w": jnp.asarray(rng.randn(8, 4) * 0.3, jnp.float32)}
        batch = {"x": rng.randn(rows, 8).astype(np.float32),
                 "y": rng.randn(rows, 4).astype(np.float32)}

        def loss_fn(p, b):
            return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

        ad = jadt.AutoDist(
            strategy_builder=jstrategy.AllReduce(),
            resource_spec=JSpec.from_dict({"nodes": [{
                "address": "127.0.0.1", "cpus": [0, 1]}]}))
        step = ad.function(loss_fn, optimizer=optax.sgd(0.05, momentum),
                           params=params)
        losses = [float(step(batch)["loss"]) for _ in range(steps)]
        return losses, np.asarray(step.get_runner().gather_params()["w"])
    finally:
        jadt.reset()


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    adt.reset()


# ------------------------------------------------------------ async PS


def _assert_relaunched(tmp_path, res, left):
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    assert "relaunching worker" in res.stderr, res.stderr[-4000:]
    worker = _read(tmp_path, "out_worker.json", log)
    chief = _read(tmp_path, "out_chief.json", log)
    # the SECOND incarnation wrote the output (the first stopped at step 2)
    assert worker["restarted"] is True
    assert chief["worker_done"] is True
    assert worker["losses"][-1] < worker["losses"][0]
    assert chief["losses"][-1] < chief["losses"][0]
    # the chief's owner loop applied its own steps' gradients and both
    # worker incarnations'
    assert chief["applied"] > len(chief["losses"]), chief
    assert not left


def test_async_worker_crash_is_relaunched(tmp_path):
    """``PS(sync=False)`` with ``ADT_ELASTIC=1``: the worker's first
    incarnation exits 3 at step 2, the chief's process watcher relaunches
    it, and the job trains on to the end."""
    res, left = _run_chief(tmp_path, ASYNC_SCRIPT, ["crash"])
    _assert_relaunched(tmp_path, res, left)


def test_async_worker_hang_is_killed_and_relaunched(tmp_path):
    """The worker's first incarnation hangs at step 2, alive and silent:
    the heartbeat watchdog (``ADT_HEARTBEAT_TIMEOUT_S=6``) kills it and
    the process watcher relaunches it. The relaunched incarnation's first
    dispatch outlasts the bring-up grace and a heartbeat window, and its
    compile-grace mark keeps it from being killed too."""
    res, left = _run_chief(tmp_path, ASYNC_SCRIPT, ["hang"],
                           ADT_HEARTBEAT_TIMEOUT_S="6",
                           SLOW_FIRST_DISPATCH_S=str(SLOW_FIRST_DISPATCH_S))
    assert "deadlock" in res.stderr, res.stderr[-4000:]
    assert res.stderr.count("killing it for an elastic restart") == 1, \
        res.stderr[-6000:]
    assert "inside its compile grace window" in res.stderr, \
        res.stderr[-6000:]
    _assert_relaunched(tmp_path, res, left)


# ------------------------------------------------------------- sync jobs


def test_sync_worker_death_restarts_the_whole_job(tmp_path):
    """``AllReduce()`` with ``ADT_ELASTIC=1 ADT_ELASTIC_SYNC=1``: the
    worker dies after step 2's save, the chief re-execs (its new
    rendezvous binds the same coordinator port), and every rank resumes
    at step 3. The resumed losses and the final params are within 1e-5 of
    the JAX package's uninterrupted run."""
    res, left = _run_chief(tmp_path, SYNC_SCRIPT, ["once", 8, "AllReduce", 0.0],
                           ADT_ELASTIC_SYNC="1")
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    assert "restarting the WHOLE job" in res.stderr, res.stderr[-4000:]
    assert res.stderr.count("sync-elastic: re-exec") == 1, res.stderr[-4000:]
    assert "ADT_AUTO_RESUME: restored step 3" in res.stderr, \
        res.stderr[-4000:]
    # both incarnations of the chief joined as process 0 on the same port
    joins = re.findall(r"joining the process group at 127\.0\.0\.1:%d "
                       r"\(num_processes=2, process_id=0" % res.coord_port,
                       res.stderr)
    assert len(joins) == 2, res.stderr[-4000:]
    chief = _read(tmp_path, "out_0.json", log)
    worker = _read(tmp_path, "out_1.json", log)
    assert chief["start"] == worker["start"] == 3
    assert sorted(map(int, chief["losses"])) == [3, 4, 5, 6, 7]
    np.testing.assert_array_equal(
        [chief["losses"][k] for k in sorted(chief["losses"])],
        [worker["losses"][k] for k in sorted(chief["losses"])])
    ref_losses, ref_w = _jax_run(8)
    for i in range(3, 8):
        np.testing.assert_allclose(chief["losses"][str(i)], ref_losses[i],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(chief["params"], ref_w, rtol=1e-5, atol=1e-6)
    assert not left


@pytest.mark.parametrize("builder", ["AllReduce", "ZeroSharded",
                                     "PartitionedAR"])
def test_sync_permanent_loss_resumes_at_reduced_world(tmp_path, builder):
    """Three processes (the chief's node with two CPU entries, localhost
    with one) and ``ADT_ELASTIC=3``: the localhost worker dies after step
    2's save, and again at the start of the restarted job with no
    checkpoint progress in between. The chief excludes its node and the
    job resumes at world 2 from step 3, within 1e-5 of the JAX package's
    uninterrupted run (12 rows: divisible by 3 and by 2 replicas). SGD
    keeps a momentum trace, so under ``ZeroSharded`` and
    ``PartitionedAR`` the plain saver's whole state is re-sharded from 3
    ranks to 2 at the restore."""
    res, left = _run_chief(tmp_path, SYNC_SCRIPT, ["forever", 12, builder, 0.9],
                           chief_entries=2, ADT_ELASTIC="3",
                           ADT_ELASTIC_SYNC="1")
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    assert "PERMANENTLY lost" in res.stderr, res.stderr[-6000:]
    assert res.stderr.count("sync-elastic: re-exec") == 2, res.stderr[-4000:]
    outs = [_read(tmp_path, "out_%d.json" % r, log) for r in range(2)]
    assert not (tmp_path / "out_2.json").exists()
    for out in outs:
        assert out["world"] == 2 and out["start"] == 3, out
    assert sorted(map(int, outs[0]["losses"])) == [3, 4, 5, 6, 7]
    ref_losses, ref_w = _jax_run(12, momentum=0.9)
    for i in range(3, 8):
        np.testing.assert_allclose(outs[0]["losses"][str(i)], ref_losses[i],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0]["params"], ref_w, rtol=1e-5,
                               atol=1e-6)
    assert not left


@pytest.mark.parametrize("mode, budget, message", [
    ("early", "1", "nothing to restore, failing fast"),
    ("forever", "1", "restart budget (1) is spent — failing fast"),
], ids=["no_checkpoint", "budget_spent"])
def test_sync_elastic_still_fails_fast(tmp_path, mode, budget, message):
    """A sync-elastic worker that dies before any checkpoint, or a second
    death that finds the budget of 1 spent: the chief exits 1 with the
    JAX package's message, and no process of the job is left."""
    res, left = _run_chief(tmp_path, SYNC_SCRIPT, [mode, 8, "AllReduce", 0.0],
                           ADT_ELASTIC=budget, ADT_ELASTIC_SYNC="1")
    assert res.returncode == 1, (res.returncode, res.stderr[-6000:])
    assert message in res.stderr, res.stderr[-6000:]
    assert "aborting job" in res.stderr, res.stderr[-4000:]
    assert not left


# ------------------------------------------------------ in-run shrink/grow

_INRUN_ENV = {"ADT_ELASTIC": "2", "ADT_ELASTIC_SYNC": "1",
              "ADT_ELASTIC_INRUN": "1", "ADT_ELASTIC_POLL_S": "0.05"}


def test_inrun_shrink_to_the_survivor_then_grow_on_join(tmp_path):
    """The in-run acceptance path: the worker exits 3 after step 2; the
    chief publishes epoch 2, its step 3 (whose collective failed) runs
    again at one process, in-run — no whole-job restart; the relaunched
    worker announces itself, is admitted at epoch 3, adopts the chief's
    state by broadcast, and both train steps 4-7 at two processes. The
    chief's losses are within 1e-5 of the JAX package's uninterrupted run
    (a data-parallel step is world-size invariant on a fixed global
    batch), and the worker's equal the chief's."""
    res, left = _run_chief(tmp_path, INRUN_SCRIPT, ["grow"], **_INRUN_ENV)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    err = res.stderr
    assert "published cluster epoch 2" in err, err[-6000:]
    assert "published cluster epoch 3" in err, err[-6000:]
    assert "restarting the WHOLE job" not in err, err[-6000:]
    chief = _read(tmp_path, "inrun_chief_0.json", log)
    assert chief["reconfigs"] == 2 and chief["epoch"] == 3, chief
    assert len(chief["spans"]) == 2, chief
    assert [chief["worlds"][str(i)] for i in range(8)] == \
        [2, 2, 2, 1, 2, 2, 2, 2], chief["worlds"]
    joined = [f for f in os.listdir(tmp_path)
              if f.startswith("inrun_worker_") and f != "inrun_worker_0.json"]
    assert joined == ["inrun_worker_4.json"], os.listdir(tmp_path)
    worker = _read(tmp_path, joined[0], log)
    assert worker["start"] == 4 and worker["epoch"] == 3, worker
    ref_losses, ref_w = _jax_run(8)
    for i in range(8):
        np.testing.assert_allclose(chief["losses"][str(i)], ref_losses[i],
                                   rtol=1e-5, atol=1e-7)
    for i_str, loss in worker["losses"].items():
        assert loss == chief["losses"][i_str], (i_str, worker, chief)
    assert worker["params"] == chief["params"]
    np.testing.assert_allclose(chief["params"], ref_w, rtol=1e-5, atol=1e-7)
    assert not left


@pytest.mark.parametrize("mode, message", [
    ("noack", "never acked epoch 2"),
    ("tp", "cannot shrink past worker localhost")],
    ids=["survivors_never_ack", "tensor_parallel"])
def test_inrun_falls_back_to_the_whole_job_restart(tmp_path, mode, message):
    """Where the in-run shrink cannot complete, the job still recovers by
    the whole-job restart: survivors that never ack the shrink epoch
    within ``ADT_ELASTIC_ACK_TIMEOUT_S`` (the chief sleeps past it), and
    a ``TensorParallel`` tp 2 job, whose model axis fails ADT430. Every
    rank resumes at step 3 from the checkpoint of step 2."""
    res, left = _run_chief(tmp_path, INRUN_SCRIPT, [mode],
                           ADT_ELASTIC_ACK_TIMEOUT_S="2", **_INRUN_ENV)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    assert message in res.stderr, res.stderr[-6000:]
    assert "restarting the WHOLE job" in res.stderr, res.stderr[-6000:]
    assert res.stderr.count("sync-elastic: re-exec") == 1, \
        res.stderr[-6000:]
    chief = _read(tmp_path, "inrun_chief_3.json", log)
    worker = _read(tmp_path, "inrun_worker_3.json", log)
    assert sorted(map(int, chief["losses"])) == [3, 4, 5, 6, 7]
    assert chief["losses"] == worker["losses"]
    ref_losses, _ = _jax_run(8)
    for i in range(3, 8):
        np.testing.assert_allclose(chief["losses"][str(i)], ref_losses[i],
                                   rtol=1e-5, atol=1e-7)
    assert not left
