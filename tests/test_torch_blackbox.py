"""The flight recorder (``telemetry/blackbox.py``) and the online straggler
detector (``telemetry/goodput.py``), held to the JAX package's
``tests/test_cluster_telemetry.py`` on the same inputs.

The divergence dump (an injected unbounded gradient fault through the
sentinel's ladder to ``TrainingDiverged``), the breaker-open dump,
bounded retention and the log tail, a disabled recorder that writes
nothing; the records the port's planes write (the fence's, the
reconfigure's, the sentinel's); a dump either package wrote read by the
other's ``load_dump``; and the straggler detector's flag and clear
transitions and z-scores equal to the JAX detector's on the same samples,
with the Runner's mark that the chief's watchdog reads.
"""
import functools
import itertools
import json
import os
import signal
import socket
import time

import numpy as np
import pytest
import torch

import autodist_tpu_torch as adt
from autodist_tpu_torch import strategy
from autodist_tpu_torch.runtime import elastic, preemption
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     CoordinationServer)
from autodist_tpu_torch.telemetry import blackbox, goodput
from autodist_tpu_torch.telemetry import spans as tel


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


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    original = signal.getsignal(signal.SIGTERM)
    for k in ("ADT_ELASTIC", "ADT_ELASTIC_SYNC", "ADT_ELASTIC_INRUN",
              "ADT_ELASTIC_POLL_S", "ADT_WORKER", "ADT_COORDSVC_PORT",
              "ADT_CKPT_DIR", "ADT_BLACKBOX", "ADT_BLACKBOX_DIR",
              "ADT_BLACKBOX_KEEP", "ADT_GRAD_FAULT_PLAN"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    yield
    tel.configure(None)
    elastic.clear()
    adt.reset()
    preemption.reset()
    signal.signal(signal.SIGTERM, original)


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 2).astype(np.float32),
              "b": np.zeros((2,), np.float32)}
    batch = {"x": rng.randn(16, 4).astype(np.float32),
             "y": rng.randn(16, 2).astype(np.float32)}
    return params, batch


def _loss(p, b):
    return torch.mean((torch.as_tensor(b["x"]) @ p["w"] + p["b"]
                       - torch.as_tensor(b["y"])) ** 2)


def _runner(sentinel=False, builder=None):
    params, batch = _problem()
    ad = adt.AutoDist(strategy_builder=builder or strategy.AllReduce(),
                      device="cpu")
    runner = ad.build(_loss, functools.partial(torch.optim.Adam, lr=0.1),
                      {n: torch.as_tensor(v) for n, v in params.items()},
                      batch, sentinel=sentinel)
    runner.init({n: torch.as_tensor(v) for n, v in params.items()})
    return runner, batch


# ------------------------------------------------------------------- dumps


def test_blackbox_dump_on_injected_training_diverged(monkeypatch, tmp_path):
    """An injected unbounded gradient fault drives rollback, the ladder's
    end and ``TrainingDiverged``; the run leaves a dump holding the fatal
    verdict, the rollback events and the last rollback's span, and each
    rollback dumped its own box on the way — the JAX package's triggers
    and kinds. ``format_dump`` renders it."""
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.runtime.sentinel import (SentinelPolicy,
                                                     TrainingDiverged)
    bb_dir = str(tmp_path / "blackbox")
    monkeypatch.setenv("ADT_BLACKBOX_DIR", bb_dir)
    monkeypatch.setenv("ADT_BLACKBOX_KEEP", "16")
    monkeypatch.setenv("ADT_GRAD_FAULT_PLAN", json.dumps(
        {"faults": [{"var": "w", "mode": "nan", "step": 4,
                     "until": 100000}]}))
    tel.configure("1")  # the span tail carries sentinel.rollback
    runner, batch = _runner(sentinel=SentinelPolicy(
        max_skips_per_window=1, window_steps=50, max_rollbacks_per_step=2))
    saver = Saver(directory=str(tmp_path / "ckpt"), max_to_keep=10)
    with pytest.raises(TrainingDiverged):
        runner.fit(itertools.repeat(batch), steps=64, save_every=2,
                   saver=saver)
    dumps = sorted(os.listdir(bb_dir))
    assert dumps, "no blackbox dump written"
    loaded = [blackbox.load_dump(os.path.join(bb_dir, f)) for f in dumps]
    d = max(loaded, key=lambda x: x["dumped_at"])
    assert d["trigger"] == "training_diverged"
    kinds = [e["kind"] for e in d["events"]]
    for kind in ("sentinel.diverged", "sentinel.rollback",
                 "sentinel.verdict", "sentinel.rollback_pending"):
        assert kind in kinds, kinds
    assert any(s["name"] == "sentinel.rollback" for s in d["spans"])
    assert d["counters"]["sentinel.rollbacks"] >= 1
    triggers = {x["trigger"] for x in loaded}
    assert any(t.startswith("sentinel rollback") for t in triggers)
    text = blackbox.format_dump(d)
    assert "training_diverged" in text and "sentinel.rollback" in text


def test_blackbox_dump_on_breaker_open(monkeypatch, tmp_path):
    """A breaker that opens against an unreachable service dumps the box
    with the breaker event and the retry trail."""
    from autodist_tpu_torch.runtime.resilience import (
        CoordinationUnavailable, ResilientCoordinationClient)
    bb_dir = str(tmp_path / "bb")
    monkeypatch.setenv("ADT_BLACKBOX_DIR", bb_dir)
    client = ResilientCoordinationClient(
        "127.0.0.1", 1, rpc_timeout=0.2, max_retries=2,
        backoff_base_s=0.001, backoff_max_s=0.002,
        breaker_failures=2, breaker_cooldown_s=0.2,
        connect_timeout=0.1, seed=0)
    with pytest.raises(CoordinationUnavailable):
        client.ping()
    dumps = [f for f in os.listdir(bb_dir) if f.endswith(".json")]
    assert dumps
    d = blackbox.load_dump(os.path.join(bb_dir, sorted(dumps)[-1]))
    assert d["trigger"] == "breaker_open"
    assert any(e["kind"] == "coord.breaker_open" for e in d["events"])
    assert d["counters"]["coord.breaker_opens"] >= 1


@pytest.mark.parametrize("dumps_before", [0, 9])
def test_blackbox_bounded_retention_and_log_tail(monkeypatch, tmp_path,
                                                 dumps_before):
    """Retention keeps the newest ``ADT_BLACKBOX_KEEP`` dumps, also when
    the process's dump count crosses a digit (9 -> 10: the JAX package's
    unpadded names then sort the oldest last, ROADMAP C13), and a dump
    holds the log tail and the events in order."""
    monkeypatch.setenv("ADT_BLACKBOX_KEEP", "2")
    from autodist_tpu_torch.utils import logging as adt_logging
    fr = blackbox.get_flight_recorder()
    fr.clear()
    monkeypatch.setattr(fr, "dumps", dumps_before)
    adt_logging.warning("blackbox tail marker %d", 42)
    for i in range(4):
        fr.record("test.event", i=i)
        fr.dump("retention-test", directory=str(tmp_path))
    kept = [f for f in os.listdir(str(tmp_path)) if f.endswith(".json")]
    assert len(kept) == 2  # pruned to ADT_BLACKBOX_KEEP
    d = blackbox.load_dump(os.path.join(str(tmp_path), sorted(kept)[-1]))
    assert any("blackbox tail marker 42" in rec["msg"]
               for rec in d["logs"])
    assert [e["data"]["i"] for e in d["events"]] == [0, 1, 2, 3]


def test_blackbox_disabled_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("ADT_BLACKBOX", "0")
    blackbox.record("test.event")
    assert blackbox.dump("disabled-test", directory=str(tmp_path)) is None
    assert not os.listdir(str(tmp_path))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_dump_crosses_the_packages(tmp_path, writer):
    """Each package's ``load_dump`` reads the other's dump, with the same
    events, and renders it."""
    from autodist_tpu.telemetry import blackbox as jblackbox
    w, r = (jblackbox, blackbox) if writer == "jax" else \
        (blackbox, jblackbox)
    fr = w.get_flight_recorder()
    fr.clear()
    fr.record("cross.event", worker="w1", step=3, ratio=float("nan"))
    path = fr.dump("cross-test", directory=str(tmp_path))
    d = r.load_dump(path)
    assert d["format"] == "adt-blackbox-v1" and d["trigger"] == "cross-test"
    ev = [e for e in d["events"] if e["kind"] == "cross.event"]
    assert ev and ev[0]["data"] == {"worker": "w1", "step": 3,
                                    "ratio": "nan"}
    assert "cross.event" in r.format_dump(d)
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"format": "other"}))
        r.load_dump(str(bad))


# ---------------------------------------------------------------- records


def _kinds():
    return [k for _, k, _ in blackbox.get_flight_recorder()._events]


def test_the_fence_records_a_fenced_write(server):
    """A zombie's fenced write leaves an ``elastic.fenced_write`` record
    (the JAX fence's)."""
    c = CoordinationClient("127.0.0.1", server.port)
    base = 5000
    elastic.publish_epoch(c, base, ["chief", "wz"])
    zombie = elastic.Membership(
        "wz", base, ["chief", "wz"],
        client_factory=lambda: CoordinationClient("127.0.0.1", server.port))
    elastic.publish_epoch(c, base + 1, ["chief"])
    blackbox.get_flight_recorder().clear()
    with pytest.raises(elastic.FencedOut):
        zombie.fence("ckpt.save")
    ev = [e for e in blackbox.get_flight_recorder()._events
          if e[1] == "elastic.fenced_write"]
    assert ev and ev[0][2] == {"op": "ckpt.save", "mine": base,
                               "current": base + 1, "worker": "wz"}
    zombie.close()
    c.close()


def test_the_reconfigure_and_the_sentinel_record(server, monkeypatch):
    """A single-process in-run reconfigure writes ``elastic.reconfigure``
    (epoch, world, planned, downtime) and a bad verdict
    ``sentinel.verdict``; every Runner arms the recorder."""
    from autodist_tpu_torch.runtime.sentinel import SentinelPolicy
    monkeypatch.setenv("ADT_COORDSVC_PORT", str(server.port))
    monkeypatch.setenv("ADT_ELASTIC", "1")
    monkeypatch.setenv("ADT_ELASTIC_SYNC", "1")
    monkeypatch.setenv("ADT_ELASTIC_INRUN", "1")
    monkeypatch.setenv("ADT_ELASTIC_POLL_S", "0.01")
    monkeypatch.setenv("ADT_GRAD_FAULT_PLAN", json.dumps(
        {"faults": [{"var": "w", "mode": "nan", "step": 1}]}))
    c = CoordinationClient("127.0.0.1", server.port)
    elastic.publish_epoch(c, 6000, ["127.0.0.1"])
    runner, batch = _runner(sentinel=SentinelPolicy(max_skips_per_window=5))
    blackbox.get_flight_recorder().clear()
    runner.run(batch)
    runner.run(batch)  # the faulted step: a bad verdict
    elastic.publish_epoch(c, 6001, ["127.0.0.1"])
    time.sleep(0.06)
    runner.run(batch)
    runner.run(batch)
    events = list(blackbox.get_flight_recorder()._events)
    kinds = [k for _, k, _ in events]
    assert "sentinel.verdict" in kinds
    rec = [d for _, k, d in events if k == "elastic.reconfigure"]
    assert len(rec) == 1 and rec[0]["epoch"] == 6001, rec
    assert rec[0]["world"] == 1 and rec[0]["planned"] is False
    assert rec[0]["downtime_s"] > 0
    c.close()


# --------------------------------------------------------------- straggler


def test_straggler_ewma_flags_and_clears():
    """The JAX detector's test, and the same samples through both
    packages' detectors: the same flag and clear transitions and the same
    z to 1e-12."""
    from autodist_tpu.telemetry import goodput as jgoodput
    det = goodput.StragglerEwma(alpha=0.2, zscore=4.0, patience=2,
                                warmup=4)
    for _ in range(10):
        assert det.observe(0.010 + np.random.RandomState(0).rand() * 1e-4) \
            is None
    assert det.observe(0.100) is None       # patience 1/2
    assert det.observe(0.100) == "flag"     # sustained: flag
    assert det.flagged and det.flags == 1
    assert det.observe(0.100) is None       # still flagged, no re-fire
    assert det.observe(0.010) == "clear"    # recovery
    assert not det.flagged
    stats = det.stats()
    assert stats["flags"] == 1 and stats["ewma_s"] is not None

    rng = np.random.RandomState(7)
    samples = list(0.02 + rng.rand(40) * 1e-3)
    for burst in (12, 25):
        samples[burst:burst + 4] = [0.2] * 4
    mine = goodput.StragglerEwma(alpha=0.2, zscore=4.0, patience=2,
                                 warmup=4)
    theirs = jgoodput.StragglerEwma(alpha=0.2, zscore=4.0, patience=2,
                                    warmup=4)
    got, want = [], []
    for x in samples:
        got.append((mine.observe(x), mine.last_z))
        want.append((theirs.observe(x), theirs.last_z))
    assert [t for t, _ in got] == [t for t, _ in want]
    assert [t for t, _ in got].count("flag") == 2
    assert [t for t, _ in got].count("clear") == 2
    for (_, z), (_, zj) in zip(got, want):
        assert (z is None) == (zj is None)
        if z is not None:
            assert abs(z - zj) <= 1e-12 * max(1.0, abs(zj))
    assert mine.stats() == theirs.stats()


def test_the_runner_marks_its_straggler_flag(server, monkeypatch):
    """The Runner feeds each dispatch's wall time to the detector and, on
    a flag, marks ``straggler/<worker>`` on the service (refreshed while
    flagged, "0" on recovery) — the mark the chief's watchdog reads."""
    monkeypatch.setenv("ADT_STRAGGLER_Z", "4")
    monkeypatch.setenv("ADT_STRAGGLER_PATIENCE", "2")
    runner, _ = _runner()
    c = CoordinationClient("127.0.0.1", server.port)
    runner._coord, runner._worker = c, "wslow"
    flags = tel.counters().get("telemetry.straggler_flags", 0.0)
    try:
        for x in [0.01] * 10:
            runner._observe_straggler(x)
        assert not c.get("straggler/wslow")
        runner._observe_straggler(0.5)
        runner._observe_straggler(0.5)
        mark = c.get("straggler/wslow")
        assert float(mark) > time.time() - 60
        assert tel.counters()["telemetry.straggler_flags"] == flags + 1
        runner._observe_straggler(0.01)
        assert c.get("straggler/wslow") == "0"
    finally:
        runner._coord = None
        c.close()
    assert "runner.straggler" in _kinds()
