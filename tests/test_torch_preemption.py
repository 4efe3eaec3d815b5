"""The preemption plane (``runtime/preemption.py``), held to the JAX
package's ``tests/test_preemption.py`` on the same inputs, against a real
coordination service (the port's build of the native one).

The counterparts of the JAX tier-1 legs: the knobs validated loudly (the
same parsed values as the JAX package's), the notice/plan/left protocol
and the drain CLI, the maintenance poller (the same notices as the JAX
poller's), the watchdog's departure mark, the planned shrink published
while the leaver is alive, the SIGTERM chain with the flight recorder's
dump hook in both install orders, the serving drain under concurrent
submits (the port's decode engine: the port has no micro-batcher yet),
the rescue-skip branch, the solo departure, the epoch that outruns the
notice poll, the fence that yields until the deadline,
``deliver_preemption`` and the ``preempt`` wire op, and ADT432 (equal to
the JAX rule's). Then a notice, a plan and a left stamp written by either
package read by the other, byte for byte; the JAX phantom-peer driver
ported as written (its losses held to the JAX package's uninterrupted
run); and a real two-process gloo job whose worker is evicted by a real
SIGTERM (the lockstep rule: no step re-runs, no checkpoint fallback, the
leaver exits 0). The JAX chaos campaign (``tests/test_preemption.py``'s
slow leg) is not ported yet.
"""
import functools
import itertools
import json
import os
import signal
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
from autodist_tpu_torch import strategy
from autodist_tpu_torch.runtime import elastic, preemption
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     CoordinationServer)
from autodist_tpu_torch.telemetry import blackbox
from autodist_tpu_torch.telemetry import spans as tel

HERE = os.path.dirname(os.path.abspath(__file__))
_ENV = ("ADT_ELASTIC", "ADT_ELASTIC_SYNC", "ADT_ELASTIC_INRUN",
        "ADT_ELASTIC_POLL_S", "ADT_WORKER", "ADT_COORDSVC_PORT",
        "ADT_COORDINATOR_ADDR", "ADT_CKPT_DIR", "ADT_NUM_PROCESSES",
        "ADT_PROCESS_ID", "ADT_AUTO_RESUME", "ADT_PREEMPT_DEADLINE_S",
        "ADT_PREEMPT_POLL_S", "ADT_DRAIN_RETRY_AFTER_S",
        "ADT_MAINTENANCE_FILE", "ADT_BLACKBOX_DIR")


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
def _clean_plane(monkeypatch):
    original = signal.getsignal(signal.SIGTERM)
    for k in _ENV:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    yield
    elastic.clear()
    adt.reset()
    preemption.reset()
    # a later test's SIGTERM must not be eaten by a grace window
    signal.signal(signal.SIGTERM, original)


def _client(server, **kw):
    return CoordinationClient("127.0.0.1", server.port, **kw)


def _counter(name):
    return tel.counters().get(name, 0.0)


_EPOCHS = iter(range(1000, 10 ** 6, 10))


def _base_epoch():
    """An epoch above any this module published before: epochs on the
    shared service only move forward."""
    return next(_EPOCHS)


# ----------------------------------------------------------- knob validation


def test_preempt_knobs_validated_loudly(monkeypatch):
    """Garbage or negative knobs raise the typed config error naming the
    knob at bring-up; valid ones parse to the JAX package's values."""
    from autodist_tpu.runtime import preemption as jpreemption
    monkeypatch.setenv("ADT_PREEMPT_DEADLINE_S", "soon")
    with pytest.raises(elastic.ElasticConfigError) as e:
        preemption.validate_preempt_knobs()
    assert e.value.knob == "ADT_PREEMPT_DEADLINE_S"

    monkeypatch.setenv("ADT_PREEMPT_DEADLINE_S", "-5")
    with pytest.raises(elastic.ElasticConfigError,
                       match="ADT_PREEMPT_DEADLINE_S"):
        preemption.validate_preempt_knobs()

    monkeypatch.setenv("ADT_PREEMPT_DEADLINE_S", "45")
    monkeypatch.setenv("ADT_PREEMPT_POLL_S", "-1")
    with pytest.raises(elastic.ElasticConfigError,
                       match="ADT_PREEMPT_POLL_S"):
        preemption.validate_preempt_knobs()

    monkeypatch.setenv("ADT_PREEMPT_POLL_S", "0")
    monkeypatch.setenv("ADT_DRAIN_RETRY_AFTER_S", "later")
    with pytest.raises(elastic.ElasticConfigError,
                       match="ADT_DRAIN_RETRY_AFTER_S"):
        preemption.validate_preempt_knobs()

    monkeypatch.setenv("ADT_DRAIN_RETRY_AFTER_S", "2.5")
    assert preemption.validate_preempt_knobs() == (45.0, 0.0, 2.5)
    assert jpreemption.validate_preempt_knobs() == (45.0, 0.0, 2.5)
    for k in ("ADT_PREEMPT_DEADLINE_S", "ADT_PREEMPT_POLL_S",
              "ADT_DRAIN_RETRY_AFTER_S"):
        monkeypatch.delenv(k)
    assert preemption.validate_preempt_knobs() == \
        jpreemption.validate_preempt_knobs()


# ----------------------------------------------------------- notice protocol


def test_notice_protocol_roundtrip(server):
    """publish/read/plan/left/clear over a real service; the seq cursor
    moves on every publish, so pollers scan again only on a change."""
    c = _client(server)
    seq0 = c.get(preemption.SEQ_KEY)
    before = _counter("preempt.notices")
    notice = preemption.publish_notice(c, "w7", deadline_s=30,
                                       reason="maintenance")
    assert _counter("preempt.notices") == before + 1
    assert c.get(preemption.SEQ_KEY) != seq0
    got = preemption.read_notice(c, "w7")
    assert got is not None and got.reason == "maintenance"
    assert got.worker == "w7"
    assert abs(got.deadline - notice.deadline) < 1e-3
    assert 0 < got.remaining_s() <= 30

    preemption.publish_plan(c, "w7", 12, notice)
    plan = preemption.read_plan(c, "w7")
    assert plan["rescue_step"] == 12 and plan["reason"] == "maintenance"

    assert preemption.has_left(c, "w7") is False
    preemption.mark_left(c, "w7")
    assert preemption.has_left(c, "w7") is True

    preemption.clear_notice(c, "w7")
    assert preemption.read_notice(c, "w7") is None
    assert preemption.read_plan(c, "w7") is None
    assert preemption.has_left(c, "w7") is False

    # an expired notice reads as None (stale: a cancelled eviction)
    c.put(preemption.NOTICE_PREFIX + "w8", preemption.PreemptionNotice(
        "w8", time.time() - preemption.NOTICE_STALE_AFTER_S - 1,
        "drain").to_json())
    assert preemption.read_notice(c, "w8") is None
    c.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_marks_cross_the_packages_byte_for_byte(server, writer):
    """A notice, a plan and a left stamp written by either package are
    read by the other on one service, and the JSON each package writes
    for the same notice is the same bytes."""
    from autodist_tpu.runtime import preemption as jpreemption
    from autodist_tpu.runtime.coordination import \
        CoordinationClient as JClient
    w, r = (jpreemption, preemption) if writer == "jax" else \
        (preemption, jpreemption)
    wc = (JClient if writer == "jax" else CoordinationClient)(
        "127.0.0.1", server.port)
    rc = (CoordinationClient if writer == "jax" else JClient)(
        "127.0.0.1", server.port)
    worker = "wx-" + writer
    notice = w.publish_notice(wc, worker, deadline_s=40, reason="kernel")
    raw = rc.get(preemption.NOTICE_PREFIX + worker)
    assert raw == notice.to_json()
    got = r.read_notice(rc, worker)
    assert (got.worker, got.reason) == (worker, "kernel")
    assert abs(got.deadline - notice.deadline) < 1e-6
    # the same notice, serialized by the other package: the same bytes
    twin = r.PreemptionNotice(notice.worker, notice.deadline, notice.reason,
                              notice.announced)
    assert twin.to_json() == raw
    w.publish_plan(wc, worker, 7, notice)
    raw_plan = rc.get(preemption.PLAN_PREFIX + worker)
    r.publish_plan(rc, worker + "-twin", 7, twin)
    assert rc.get(preemption.PLAN_PREFIX + worker + "-twin") == raw_plan
    assert r.read_plan(rc, worker) == json.loads(raw_plan)
    assert r.read_plan(rc, worker)["rescue_step"] == 7
    assert r.has_left(rc, worker) is False
    w.mark_left(wc, worker)
    assert r.has_left(rc, worker) is True
    r.clear_notice(rc, worker)
    assert w.read_notice(wc, worker) is None
    assert w.read_plan(wc, worker) is None and not w.has_left(wc, worker)
    wc.close()
    rc.close()


def test_drain_cli_publishes_and_reports(server, capsys):
    """The operator ``drain`` verb publishes the mark; ``status`` reads it
    back as JSON; an unreachable service exits 1."""
    port = str(server.port)
    rc = preemption.main(["drain", "w-cli", "--deadline", "42",
                          "--reason", "kernel-upgrade", "--port", port])
    assert rc == 0
    assert "w-cli" in capsys.readouterr().out
    c = _client(server)
    notice = preemption.read_notice(c, "w-cli")
    assert notice is not None and notice.reason == "kernel-upgrade"
    assert 0 < notice.remaining_s() <= 42
    c.close()

    rc = preemption.main(["status", "w-cli", "--port", port])
    assert rc == 0
    status = json.loads(capsys.readouterr().out)
    assert status["notice"]["reason"] == "kernel-upgrade"
    assert status["left"] is False
    assert preemption.main(["drain", "w-cli", "--port",
                            str(_free_port())]) == 1
    assert "unreachable" in capsys.readouterr().out


def test_drain_cli_as_a_module(server):
    """``python -m autodist_tpu_torch.runtime.preemption drain`` works as
    the operator runs it."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    proc = subprocess.run(
        [sys.executable, "-m", "autodist_tpu_torch.runtime.preemption",
         "drain", "w-mod", "--deadline", "9", "--port", str(server.port)],
        env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "drain published: w-mod" in proc.stdout
    c = _client(server)
    assert preemption.read_notice(c, "w-mod").reason == "drain"
    c.close()


def test_maintenance_poller_one_shot(tmp_path):
    """The maintenance hook: the file's existence signals the eviction,
    its JSON body carries deadline and reason, the event is one-shot —
    and each body gives the JAX poller's notice."""
    from autodist_tpu.runtime import preemption as jpreemption
    path = tmp_path / "maintenance.json"
    poller = preemption.MaintenancePoller(str(path))
    assert poller.check() is None
    path.write_text(json.dumps({"deadline_s": 90, "reason": "tpu-maint"}))
    notice = poller.check()
    assert notice is not None and notice.reason == "tpu-maint"
    assert 80 < notice.remaining_s() <= 90
    assert poller.check() is None  # consumed

    bare = tmp_path / "bare"
    bare.write_text("")
    partial = tmp_path / "partial.json"
    partial.write_text(json.dumps({"reason": "kernel-upgrade"}))
    for f, reason in ((path, "tpu-maint"), (bare, "maintenance"),
                      (partial, "kernel-upgrade")):
        mine = preemption.MaintenancePoller(str(f)).check()
        theirs = jpreemption.MaintenancePoller(str(f)).check()
        assert (mine.worker, mine.reason) == (theirs.worker, theirs.reason)
        assert mine.reason == reason and mine.remaining_s() > 0
        assert abs((mine.deadline - mine.announced)
                   - (theirs.deadline - theirs.announced)) < 1e-6


# -------------------------------------------- watchdog x announced departure


def _mini_coordinator(tmp_path, monkeypatch, server, inrun=False):
    monkeypatch.setenv("ADT_COORDSVC_PORT", str(server.port))
    if inrun:
        monkeypatch.setenv("ADT_ELASTIC", "1")
        monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
        monkeypatch.setenv("ADT_ELASTIC_INRUN", "1")
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runtime.cluster import Cluster
    from autodist_tpu_torch.runtime.coordinator import Coordinator
    spec = tmp_path / "spec.yml"
    spec.write_text(
        "nodes:\n  - address: 127.0.0.1\n    chief: true\n    cpus: [0]\n"
        "  - address: localhost\n    cpus: [0]\n")
    return Coordinator("sid-preempt", Cluster(ResourceSpec(str(spec))),
                       heartbeat_timeout=5.0,
                       max_restarts=1 if inrun else 0)


def test_watchdog_consults_departure_mark(server, tmp_path, monkeypatch):
    """An announced leaver whose heartbeat stops mid-handoff is not
    declared dead (the supervised list drops it) until a grace past its
    deadline; a slow-but-alive straggler's fresh mark keeps it too."""
    coord = _mini_coordinator(tmp_path, monkeypatch, server)
    c = _client(server)
    assert coord._is_departing(c, "wdep") is False
    assert coord._supervised(c, ["wdep"]) == ["wdep"]
    preemption.publish_notice(c, "wdep", deadline_s=30, reason="drain")
    assert coord._is_departing(c, "wdep") is True
    assert "wdep" in coord._planned_departures
    assert coord._supervised(c, ["wdep"]) == []
    # an aged-out notice: a NEXT incarnation is supervised again
    coord._planned_departures["wdep"] = (
        time.time() - 2 * coord._heartbeat_timeout - 1)
    assert coord._is_departing(c, "wdep") is False
    assert "wdep" not in coord._planned_departures
    preemption.clear_notice(c, "wdep")
    c.put("straggler/wslow", repr(time.time()))
    assert coord._supervised(c, ["wslow"]) == []
    c.put("straggler/wslow", "0")
    assert coord._supervised(c, ["wslow"]) == ["wslow"]
    coord.stop_watchdog()
    c.close()


def test_planned_shrink_published_while_leaver_alive(server, tmp_path,
                                                     monkeypatch):
    """The chief's watchdog answers an announced departure by publishing
    the survivors' roster at epoch + 1 before the leaver dies — no reap,
    no relaunch, no restart of the budget — and the planned leaver's exit
    is the end of a departure, never an abort."""
    coord = _mini_coordinator(tmp_path, monkeypatch, server, inrun=True)
    # the shrink-soundness gate has its own tests; here it must not veto
    # the plan over an unreadable test-strategy id
    monkeypatch.setattr(coord, "_shrink_unsound_reason", lambda a: None)
    c = _client(server)
    base = _base_epoch()
    elastic.publish_epoch(c, base, ["127.0.0.1", "localhost"])
    before = _counter("preempt.planned_shrinks")
    coord._maybe_plan_departures(c)  # no notice: nothing happens
    assert elastic.read_epoch(c)[0] == base

    preemption.publish_notice(c, "localhost", deadline_s=30,
                              reason="maintenance")
    coord._maybe_plan_departures(c)
    epoch, roster = elastic.read_epoch(c)
    assert epoch == base + 1 and roster == ["127.0.0.1"]
    assert _counter("preempt.planned_shrinks") == before + 1
    assert coord._restarts == {}  # planned: no budget spent
    assert "localhost" in coord._departures_shrunk
    # idempotent: a handled departure is not planned again
    coord._maybe_plan_departures(c)
    assert elastic.read_epoch(c)[0] == base + 1
    # the leaver's exit (even the deadline SIGKILL's code) ends its
    # departure: no abort, no restart
    coord._launch_cmds[1] = ("localhost", "true", {})
    assert coord._on_exit(1, -9, time.monotonic()) is True
    assert coord._exits == {} and coord._restarts == {}
    preemption.clear_notice(c, "localhost")
    coord.stop_watchdog()
    coord.join()
    c.close()


# ----------------------------------------------- SIGTERM chaining (dump last)


def _fire_sigterm_handler():
    handler = signal.getsignal(signal.SIGTERM)
    assert callable(handler), "no SIGTERM handler installed"
    handler(signal.SIGTERM, None)


@pytest.mark.parametrize("order", ["blackbox-first", "preempt-first"])
def test_sigterm_chain_both_fire_dump_last(tmp_path, monkeypatch, order):
    """The notice handler and the flight recorder's dump hook chain in
    both install orders: both fire, the dump runs last (its event tail
    holds the notice), the process survives (a grace window, no re-raise
    of the default disposition), and ``reset`` puts back the handler that
    was there before."""
    monkeypatch.setenv("ADT_BLACKBOX_DIR", str(tmp_path))
    monkeypatch.setenv("ADT_PREEMPT_DEADLINE_S", "30")
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    monkeypatch.setattr(blackbox, "_signal_hook_installed", False)
    monkeypatch.setattr(preemption, "_sigterm_installed", False)
    monkeypatch.setattr(preemption, "_signal_notice", None)
    # a guard is armed (the grace is active): the chain must not re-raise
    preemption._armed_guards.append(object())
    fr = blackbox.get_flight_recorder()
    fr.clear()
    if order == "blackbox-first":
        blackbox._install_hooks()
        assert preemption.install_sigterm_notice() is True
    else:
        assert preemption.install_sigterm_notice() is True
        blackbox._install_hooks()
    dumps_before = fr.dumps
    _fire_sigterm_handler()
    assert preemption.signal_notice() is not None
    assert fr.dumps == dumps_before + 1
    dump = blackbox.load_dump(fr.last_dump_path)
    kinds = [e["kind"] for e in dump["events"]]
    assert "preempt.notice" in kinds and "signal" in kinds
    assert kinds.index("preempt.notice") < kinds.index("signal")
    preemption.reset()
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    assert preemption.signal_notice() is None
    assert not preemption._sigterm_installed
    assert not blackbox._signal_hook_installed


def test_no_handler_from_a_thread(monkeypatch):
    """A handler is process state only the main thread may set: a Runner's
    guard built in another thread installs none and leaves the grace off,
    so SIGTERM keeps killing."""
    monkeypatch.setattr(preemption, "_sigterm_installed", False)
    got = []
    t = threading.Thread(
        target=lambda: got.append(preemption.install_sigterm_notice()))
    t.start()
    t.join()
    assert got == [False] and not preemption.grace_active()


# --------------------------------------------------- serving drain satellite


def test_serving_drain_under_concurrent_submit(monkeypatch):
    """``drain_serving`` with traffic in flight: the sequences in flight
    complete, queued requests shed typed with the Retry-After, submits
    during and after the drain shed at once, and the shed count is
    returned and counted."""
    from autodist_tpu_torch.models import lm as tlm
    from autodist_tpu_torch.serving.decode import DecodeConfig, DecodeEngine
    from autodist_tpu_torch.serving.engine import ServingUnavailable
    cfg = tlm.LMConfig.tiny()
    loss_fn, params, batch, _ = tlm.make_train_setup(cfg, seq_len=16,
                                                     batch_size=8)
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(loss_fn, None, params, batch)
    runner.init(params)
    engine = DecodeEngine(runner, tlm.make_decode_setup(cfg),
                          DecodeConfig(slots=2, max_new_tokens=6,
                                       prefill_len=8)).warmup()
    hold, entered = threading.Event(), threading.Event()
    real_step = engine._dispatch_step

    def held_step():
        entered.set()
        hold.wait(timeout=30)
        return real_step()
    monkeypatch.setattr(engine, "_dispatch_step", held_step)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (3,)).astype(np.int32)
               for _ in range(6)]
    in_flight = [engine.submit(p) for p in prompts[:2]]
    assert entered.wait(timeout=30)  # both admitted, the step is held
    queued = [engine.submit(p) for p in prompts[2:5]]
    shed_before = _counter("serve.shed")
    stop, late = threading.Event(), []

    def keep_submitting():
        while not stop.is_set():
            try:
                late.append(engine.submit(prompts[5]))
            except ServingUnavailable as e:
                late.append(e)
            time.sleep(0.01)
    submitter = threading.Thread(target=keep_submitting, daemon=True)
    submitter.start()
    threading.Timer(0.3, hold.set).start()
    shed = preemption.drain_serving(retry_after_s=7.5)
    stop.set()
    submitter.join(timeout=10)
    drained_sheds = [x for x in late if isinstance(x, ServingUnavailable)]
    late_futures = [x for x in late if not isinstance(x, Exception)]
    assert shed == len(queued) + len(late_futures)
    for f in in_flight:
        assert f.result(timeout=30)["tokens"].shape == (6,)
    for f in queued + late_futures:
        with pytest.raises(ServingUnavailable) as e:
            f.result(timeout=1)
        assert e.value.retry_after_s == 7.5
    assert drained_sheds and all(e.retry_after_s == 7.5
                                 for e in drained_sheds)
    with pytest.raises(ServingUnavailable, match="draining") as e:
        engine.submit(prompts[0])
    assert e.value.retry_after_s == 7.5
    stats = engine.stats()
    assert stats["drained"] == 2 and stats["shed"] >= shed
    assert _counter("serve.shed") == shed_before + shed
    assert preemption.drain_serving() == 0  # idempotent


# ------------------------------------------------ rescue deadline budgeting


def _build_tiny_runner(server, ckpt_dir, monkeypatch, preempt_poll="0.01"):
    monkeypatch.setenv("ADT_COORDSVC_PORT", str(server.port))
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    monkeypatch.setenv("ADT_ELASTIC_INRUN", "1")
    monkeypatch.setenv("ADT_ELASTIC_POLL_S", "0.01")
    monkeypatch.setenv("ADT_PREEMPT_POLL_S", preempt_poll)
    monkeypatch.setenv("ADT_CKPT_DIR", str(ckpt_dir))
    adt.reset()
    c = _client(server)
    elastic.publish_epoch(c, _base_epoch(), ["127.0.0.1"])
    c.close()
    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(
        (rng.randn(8, 4) * 0.3).astype(np.float32))}

    def loss_fn(p, b):
        return torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                           - torch.as_tensor(b["y"])) ** 2)

    batch = {"x": rng.randn(8, 8).astype(np.float32),
             "y": rng.randn(8, 4).astype(np.float32)}
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.SGD, lr=0.05),
                      params, batch)
    runner.init(params)
    return runner, batch


def test_rescue_checkpoint_deadline_skip_branch(server, tmp_path,
                                                monkeypatch):
    """When the remaining grace cannot cover the measured ckpt.save_ms
    p99 (x the safety factor), the rescue save is skipped — counted, no
    file written — and the departure goes straight to the handoff."""
    ckpt_dir = tmp_path / "ckpt"
    runner, batch = _build_tiny_runner(server, ckpt_dir, monkeypatch)
    runner.run(batch)
    tel.hist_observe("ckpt.save_ms", 60000.0)  # saves far slower than 0.8 s
    c = _client(server)
    preemption.publish_notice(c, runner._preempt.worker, deadline_s=0.8,
                              reason="spot")
    time.sleep(0.05)
    skips_before = _counter("preempt.rescue_skips")
    with pytest.raises(preemption.PlannedDeparture):
        for _ in range(5):
            runner.run(batch)
    assert _counter("preempt.rescue_skips") == skips_before + 1
    stats = runner.step_stats()["preempt"]
    assert not os.path.exists(ckpt_dir) or not any(
        f.endswith(".meta.json") for f in os.listdir(ckpt_dir))
    assert stats["handoffs"] >= 1.0
    preemption.clear_notice(c, runner._preempt.worker)
    c.close()


def test_solo_graceful_departure_e2e(server, tmp_path, monkeypatch):
    """A real drain end to end (one worker, no survivors): operator
    notice -> the agreed rescue plan -> a committed rescue checkpoint ->
    serving drained -> PlannedDeparture with exit code 0 and the left
    stamp published; fit's unwind does not mask the departure, and the
    flight recorder holds the notice, the rescue and the handoff."""
    ckpt_dir = tmp_path / "ckpt"
    runner, batch = _build_tiny_runner(server, ckpt_dir, monkeypatch)
    c = _client(server)
    worker = runner._preempt.worker
    runner.run(batch)
    fallback = _counter("ckpt.fallback")
    blackbox.get_flight_recorder().clear()

    def drain_soon():
        time.sleep(0.3)
        preemption.publish_notice(c, worker, deadline_s=30, reason="drain")
    threading.Thread(target=drain_soon, daemon=True).start()
    with pytest.raises(preemption.PlannedDeparture) as e:
        runner.fit(itertools.repeat(batch), steps=10_000)
    assert e.value.code == 0 and e.value.reason == "drain"
    stats = runner.step_stats()["preempt"]
    assert stats["rescue_saves"] >= 1.0
    assert stats["handoffs"] >= 1.0 and stats["last_handoff_s"] > 0
    from autodist_tpu_torch.checkpoint import integrity
    committed = [s for s in integrity.scan(str(ckpt_dir))
                 if s.state == "committed"]
    plan = preemption.read_plan(c, worker)
    assert committed and plan is not None
    assert max(s.step for s in committed) >= plan["rescue_step"]
    assert preemption.has_left(c, worker) is True
    assert _counter("ckpt.fallback") == fallback
    kinds = [k for _, k, _ in blackbox.get_flight_recorder()._events]
    assert kinds.index("preempt.rescue_save") < kinds.index(
        "preempt.handoff")
    preemption.clear_notice(c, worker)
    c.close()


def test_exclusion_epoch_outrunning_notice_poll_still_departs(
        server, tmp_path, monkeypatch):
    """The shrink epoch lands right after the drain notice, and the
    leaver's epoch poll sees its exclusion before its throttled notice
    poll (60 s) adopted the mark: the reconfigure path reads the notice
    unthrottled and departs gracefully, never the zombie FencedOut."""
    runner, batch = _build_tiny_runner(server, tmp_path / "ckpt",
                                       monkeypatch, preempt_poll="60")
    c = _client(server)
    worker = runner._preempt.worker
    runner.run(batch)
    m = elastic.current()
    preemption.publish_notice(c, worker, deadline_s=30, reason="drain")
    elastic.publish_epoch(c, m.epoch + 1, ["the-survivor"])
    time.sleep(0.06)
    handoffs = _counter("preempt.handoffs")
    with pytest.raises(preemption.PlannedDeparture) as e:
        for _ in range(5):
            runner.run(batch)
    assert e.value.code == 0 and e.value.reason == "drain"
    assert _counter("preempt.handoffs") == handoffs + 1
    preemption.clear_notice(c, worker)
    c.close()


def test_fence_yields_to_announced_departure_until_deadline(server):
    """An announced leaver's writes (rescue checkpoint, flush, left
    stamp) pass the epoch fence until its deadline, and are fenced as a
    zombie's again after it."""
    c = _client(server)
    base = _base_epoch()
    elastic.publish_epoch(c, base, ["chief", "wleave"])
    leaver = elastic.Membership("wleave", base, ["chief", "wleave"],
                                client_factory=lambda: _client(server))
    elastic.publish_epoch(c, base + 1, ["chief"])  # the announced shrink
    with pytest.raises(elastic.FencedOut):
        leaver.fence("ckpt.save")  # unannounced: a zombie
    leaver.expect_departure(time.time() + 30)
    leaver.fence("ckpt.save")  # announced: the last boundary proceeds
    leaver.fence("ps.push")
    leaver.expect_departure(time.time() - 1)  # an earlier deadline...
    leaver.expect_departure(time.time() + 30)  # ...never shrinks it back
    leaver.fence("ckpt.save")
    leaver._departure_until = time.time() - 1  # force-expire
    with pytest.raises(elastic.FencedOut):
        leaver.fence("ckpt.save")  # past the deadline: fenced again
    leaver.close()
    c.close()


# --------------------------------------------------- faultinject preempt op


STUBBORN = ("import signal, sys, time\n"
            "signal.signal(signal.SIGTERM, lambda *a: None)\n"
            "print('up', flush=True)\n"
            "time.sleep(60)\n")

GRACEFUL = ("import signal, sys, time\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
            "print('up', flush=True)\n"
            "time.sleep(60)\n")


def _spawn_target(code):
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "up"
    return proc


def test_deliver_preemption_sigterm_then_deadline_sigkill():
    """A stubborn target (it ignores SIGTERM) is SIGKILLed at the
    deadline; a graceful one departs inside the window and the killer
    never touches it."""
    from autodist_tpu_torch.runtime import faultinject
    stubborn = _spawn_target(STUBBORN)
    killer = faultinject.deliver_preemption(stubborn.pid, deadline_s=0.5)
    assert stubborn.wait(timeout=10) == -signal.SIGKILL
    killer.join(timeout=5)

    graceful = _spawn_target(GRACEFUL)
    killer = faultinject.deliver_preemption(graceful.pid, deadline_s=2.0)
    assert graceful.wait(timeout=10) == 0
    killer.join(timeout=5)


def test_preempt_wire_op_fires_through_proxy(server):
    """The declarative ``{"op": "preempt"}`` rule delivers the real
    SIGTERM and the deadline SIGKILL when its nth matching RPC crosses
    the proxy."""
    from autodist_tpu_torch.runtime.faultinject import FaultPlan, FaultyProxy
    stubborn = _spawn_target(STUBBORN)
    plan = FaultPlan({"faults": [
        {"op": "preempt", "match": "PUT", "nth": 2, "deadline_s": 0.5}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan,
                     preempt_pid=stubborn.pid) as proxy:
        c = CoordinationClient("127.0.0.1", proxy.port)
        c.put("preop/one", "1")     # nth=1: no fire
        assert stubborn.poll() is None
        c.put("preop/two", "2")     # nth=2: SIGTERM + deadline SIGKILL
        assert stubborn.wait(timeout=10) == -signal.SIGKILL
        assert "preempt:PUT" in plan.injected
        c.close()


# ------------------------------------------------------------------- ADT432


def test_adt432_warns_on_model_parallel_handoff():
    """A handoff armed on a fail-fast (model-parallel) family warns; a
    data-parallel one and a degenerate model axis stay clean — the JAX
    rule's codes and messages on the same strategies."""
    from autodist_tpu.analysis import rules as jrules

    from autodist_tpu_torch.analysis import rules
    cases = [({"data": 2, "model": 4}, ["ADT432"]),
             ({"data": 8}, []), ({"data": 4, "model": 1}, [])]
    for mesh, codes in cases:
        s = types.SimpleNamespace(
            graph_config=types.SimpleNamespace(mesh_shape=mesh),
            node_config=[])
        mine, theirs = rules.verify_preemption(s), jrules.verify_preemption(s)
        assert [d.code for d in mine] == codes
        assert [(d.code, d.message) for d in mine] == \
            [(d.code, d.message) for d in theirs]
    assert "model" in rules.verify_preemption(types.SimpleNamespace(
        graph_config=types.SimpleNamespace(mesh_shape=cases[0][0]),
        node_config=[]))[0].message


def test_adt432_at_build(server, monkeypatch):
    """The in-run build lints the handoff: a model-parallel plan warns
    ADT432 (beside ADT430), and a bad knob fails it naming the knob."""
    monkeypatch.setenv("ADT_COORDSVC_PORT", str(server.port))
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    monkeypatch.setenv("ADT_ELASTIC_INRUN", "1")
    c = _client(server)
    elastic.publish_epoch(c, _base_epoch(), ["127.0.0.1"])
    c.close()
    from autodist_tpu_torch import autodist as autodist_mod
    warned = []
    monkeypatch.setattr(autodist_mod.logging, "warning",
                        lambda msg, *a, **k: warned.append(msg % a))
    mp = types.SimpleNamespace(
        graph_config=types.SimpleNamespace(mesh_shape={"data": 1,
                                                       "model": 2}),
        node_config=[])
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    ad._arm_inrun_elastic(mp)
    assert any("ADT432" in w for w in warned), warned
    assert any("ADT430" in w for w in warned), warned
    elastic.clear()
    monkeypatch.setenv("ADT_PREEMPT_POLL_S", "often")
    with pytest.raises(elastic.ElasticConfigError,
                       match="ADT_PREEMPT_POLL_S"):
        ad._arm_inrun_elastic(mp)


# --------------------------------- planned peer departure: phantom-peer e2e


PEER_DRIVER = r"""
import functools, json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.runtime import elastic, preemption
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     CoordinationServer)
from autodist_tpu_torch.telemetry import spans as tel

outdir = sys.argv[1]
port = int(os.environ["ADT_COORDSVC_PORT"])
srv = CoordinationServer(port)
srv.start()

rng = np.random.RandomState(0)
params = {"w": torch.from_numpy((rng.randn(8, 4) * 0.3).astype(np.float32))}

def loss_fn(p, batch):
    return torch.mean((torch.as_tensor(batch["x"]) @ p["w"]
                       - torch.as_tensor(batch["y"])) ** 2)

batch = {"x": rng.randn(8, 8).astype(np.float32),
         "y": rng.randn(8, 4).astype(np.float32)}
sgd = functools.partial(torch.optim.SGD, lr=0.05)

# the uninterrupted run first (no elastic knobs read at build)
ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
step = ad.function(loss_fn, optimizer=sgd, params=params)
ref = [float(step(batch)["loss"]) for _ in range(10)]
adt.reset()

os.environ["ADT_ELASTIC"] = "1"
os.environ["ADT_ELASTIC_SYNC"] = "1"
os.environ["ADT_ELASTIC_INRUN"] = "1"
os.environ["ADT_ELASTIC_POLL_S"] = "0.01"
os.environ["ADT_PREEMPT_POLL_S"] = "0.01"

# pre-publish a TWO-member roster (this process and a phantom peer about
# to be evicted) so the build adopts it: the survivor's view of a real
# two-worker job whose peer announces its departure
client = CoordinationClient("127.0.0.1", port)
me = "127.0.0.1"
elastic.publish_epoch(client, 1, [me, "peer-leaving"])

ad = adt.AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
runner = ad.build(loss_fn, sgd, params, batch)
runner.init(params)
m = elastic.current()
assert m is not None and m.roster == [me, "peer-leaving"], m.roster

losses = []
for i in range(10):
    losses.append(float(runner.run(batch)["loss"]))
    if i == 3:
        # the peer announces its departure: this survivor joins the
        # rescue checkpoint and stages its snapshot for the shrink
        preemption.publish_notice(client, "peer-leaving", deadline_s=30,
                                  reason="maintenance")
        time.sleep(0.05)
    if i == 5:
        # the chief's planned shrink: the survivor-only roster, published
        # while the leaver is alive (here: the phantom peer)
        elastic.publish_epoch(client, 2, [me])
        time.sleep(0.05)

stats = runner.step_stats()
rec = tel.get_recorder()
reconf = [e for e in rec.events() if e.name == "elastic.reconfigure"]
out = {
    "ref": ref, "losses": losses,
    "reconfigs": stats["elastic"]["reconfigs"],
    "epoch": elastic.current().epoch,
    "preempt": stats["preempt"],
    "ckpt_fallback": tel.counters().get("ckpt.fallback", 0.0),
    "elastic_fallbacks": tel.counters().get("elastic.ckpt_fallbacks", 0.0),
    "planned_flags": [bool(e.args.get("planned")) for e in reconf],
    "reconfigure_s": rec.durations_s("elastic.reconfigure"),
    "jax_loaded": any(k == "jax" or k.startswith(("jax.", "autodist_tpu."))
                      for k in sys.modules),
}
with open(os.path.join(outdir, "out.json"), "w") as f:
    json.dump(out, f)
print("DRIVER_DONE", flush=True)
srv.stop()
"""


def _jax_uninterrupted(steps=10):
    """The JAX package's uninterrupted run of the drivers' math, in this
    process."""
    import jax.numpy as jnp
    import optax

    import autodist_tpu as jadt
    from autodist_tpu import strategy as jstrategy
    jadt.reset()
    try:
        rng = np.random.RandomState(0)
        params = {"w": jnp.asarray(rng.randn(8, 4) * 0.3, jnp.float32)}
        batch = {"x": rng.randn(8, 8).astype(np.float32),
                 "y": rng.randn(8, 4).astype(np.float32)}

        def loss_fn(p, b):
            return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

        ad = jadt.AutoDist(strategy_builder=jstrategy.AllReduce())
        step = ad.function(loss_fn, optimizer=optax.sgd(0.05), params=params)
        return [float(step(batch)["loss"]) for _ in range(steps)]
    finally:
        jadt.reset()


def test_planned_peer_departure_reconfigures_without_fallback(tmp_path):
    """The JAX phantom-peer test, ported as written: the survivor
    rescue-checkpoints at the agreed step, stages its snapshot,
    reconfigures under the announced shrink epoch with the ``planned``
    flag on its span, and ``ckpt.fallback`` stays 0, while its losses
    match the JAX package's uninterrupted run."""
    script = tmp_path / "driver.py"
    script.write_text(PEER_DRIVER)
    env = dict(os.environ)
    for k in _ENV:
        env.pop(k, None)
    env.update({
        "ADT_COORDSVC_PORT": str(_free_port()),
        "ADT_CKPT_DIR": str(tmp_path / "ckpt"),
        "ADT_WORKING_DIR": str(tmp_path / "work"),
        "ADT_TRACE": "1",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": os.pathsep.join(
            [os.path.dirname(HERE)] +
            ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
             else [])),
    })
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["reconfigs"] == 1 and out["epoch"] == 2, out
    assert out["preempt"]["rescue_saves"] == 1.0, out["preempt"]
    assert out["planned_flags"] == [True], out
    assert out["ckpt_fallback"] == 0.0 and out["elastic_fallbacks"] == 0.0
    assert out["reconfigure_s"][0] > 0
    assert not out["jax_loaded"]
    np.testing.assert_allclose(out["losses"], out["ref"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out["losses"], _jax_uninterrupted(),
                               rtol=1e-6, atol=1e-7)


# ----------------------------- planned peer departure: a real gloo job


# The chief runs it and relaunches it for its worker (spec, out dir,
# mode). After step 1 the chief evicts the worker — "sigterm": a real
# SIGTERM and a SIGKILL at 60 s; "drain": the operator's drain verb — the
# worker departs at the agreed boundary and the chief trains on alone.
PREEMPT_SCRIPT = r'''
import functools, json, os, sys, time
import numpy as np
spec, outdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
worker = os.environ.get("ADT_WORKER") == "localhost"
import torch
import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.runtime import elastic, faultinject, preemption
from autodist_tpu_torch.runtime.coordination import CoordinationClient
from autodist_tpu_torch.telemetry import blackbox
from autodist_tpu_torch.telemetry import spans as tel

tel.configure("1")
ad = adt.AutoDist(resource_spec_file=spec,
                  strategy_builder=strategy.AllReduce(), device="cpu")
rng = np.random.RandomState(0)
params = {"w": torch.from_numpy((rng.randn(8, 4) * 0.3).astype(np.float32))}
batch = {"x": rng.randn(8, 8).astype(np.float32),
         "y": rng.randn(8, 4).astype(np.float32)}

def loss_fn(p, b):
    return torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                       - torch.as_tensor(b["y"])) ** 2)

runner = ad.build(loss_fn, functools.partial(torch.optim.SGD, lr=0.05),
                  params, batch)
runner.init(params)
role = "worker" if worker else "chief"
pid_file = os.path.join(outdir, "worker.pid")
if worker:
    with open(pid_file + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.replace(pid_file + ".tmp", pid_file)
losses, worlds = {}, {}

def write(**kw):
    c = tel.counters()
    rec = tel.get_recorder()
    kw.update(losses=losses, worlds=worlds,
              step_reruns=c.get("elastic.step_reruns", 0.0),
              elastic_fallbacks=c.get("elastic.ckpt_fallbacks", 0.0),
              ckpt_fallback=c.get("ckpt.fallback", 0.0),
              preempt=runner.step_stats()["preempt"],
              epoch=elastic.current().epoch,
              planned=[bool(e.args.get("planned")) for e in rec.events()
                       if e.name == "elastic.reconfigure"],
              t=time.time())
    with open(os.path.join(outdir, "preempt_%s.json" % role), "w") as f:
        json.dump(kw, f)

try:
    for i in range(8):
        losses[i] = float(runner.run(batch)["loss"])
        worlds[i] = runner.distributed_step.num_replicas
        if not worker and i == 1 and mode == "sigterm":
            while not os.path.exists(pid_file):
                time.sleep(0.01)
            faultinject.deliver_preemption(int(open(pid_file).read()),
                                           deadline_s=60)
        if not worker and i == 1 and mode == "drain":
            assert preemption.main(
                ["drain", "localhost", "--deadline", "60", "--port",
                 os.environ["ADT_COORDSVC_PORT"]]) == 0
except preemption.PlannedDeparture as e:
    write(departed=True, code=e.code, reason=e.reason,
          dump=blackbox.dump("departure"))
    raise
c = CoordinationClient("127.0.0.1", int(os.environ["ADT_COORDSVC_PORT"]))
t = time.monotonic()  # the leaver stamps its departure as it exits
while not preemption.has_left(c, "localhost") and time.monotonic() - t < 30:
    time.sleep(0.05)
write(departed=False, left=preemption.has_left(c, "localhost"))
c.close()
print("DONE", role, flush=True)
'''


@pytest.mark.parametrize("mode", ["sigterm", "drain"])
def test_planned_departure_of_a_real_peer_over_gloo(tmp_path, mode):
    """A real two-process job launched by the chief over gloo: after step
    1 the chief SIGTERMs its worker (or drains it with the operator's
    verb, which the worker reads from the service); both take the rescue
    checkpoint at the agreed step, the chief publishes the survivors'
    epoch while the worker is alive, the worker departs at that boundary
    with exit code 0 and its left stamp, and the chief trains on alone
    with the ``planned`` flag on its reconfigure span — no step re-run,
    no checkpoint fallback, no whole-job restart. The losses hold to the
    JAX package's uninterrupted run at 1e-5 (a data-parallel step is
    world-size invariant on a fixed global batch)."""
    from test_torch_elastic_launch import _read, _run_chief
    bb = tmp_path / "bb"
    res, left = _run_chief(
        tmp_path, PREEMPT_SCRIPT, [mode], ADT_ELASTIC="2",
        ADT_ELASTIC_SYNC="1",
        ADT_ELASTIC_INRUN="1", ADT_ELASTIC_POLL_S="0.05",
        ADT_PREEMPT_POLL_S="0.05", ADT_BLACKBOX_DIR=str(bb))
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    err = res.stderr
    assert "restarting the WHOLE job" not in err, err[-6000:]
    shrink = err.index("planned shrink for announced leaver localhost")
    done = err.index("announced leaver localhost exited with code 0")
    assert shrink < done, err[-6000:]
    chief = _read(tmp_path, "preempt_chief.json", log)
    wk = _read(tmp_path, "preempt_worker.json", log)
    assert wk["departed"] and wk["code"] == 0 and wk["reason"] == mode
    assert chief["left"] is True
    r = wk["preempt"]["rescue_saves"] + wk["preempt"]["rescue_skips"]
    assert chief["preempt"]["rescue_saves"] == 1.0 and r == 1.0, (chief, wk)
    assert chief["planned"] == [True] and chief["epoch"] == 2, chief
    for who in (chief, wk):
        assert who["step_reruns"] == 0 and who["elastic_fallbacks"] == 0
        assert who["ckpt_fallback"] == 0
    n_two = len(wk["losses"])
    assert n_two >= 3, wk
    worlds = [chief["worlds"][str(i)] for i in range(8)]
    assert worlds == [2] * n_two + [1] * (8 - n_two), worlds
    assert wk["losses"] == {k: chief["losses"][k] for k in wk["losses"]}
    ref = _jax_uninterrupted(8)
    np.testing.assert_allclose([chief["losses"][str(i)] for i in range(8)],
                               ref, rtol=1e-5, atol=1e-7)
    # the worker's black box holds the notice (before the signal record,
    # when a SIGTERM brought it) and the handoff
    kinds = [e["kind"] for e in blackbox.load_dump(wk["dump"])["events"]]
    assert "preempt.handoff" in kinds
    if mode == "sigterm":
        assert kinds.index("preempt.notice") < kinds.index("signal")
    assert not left
