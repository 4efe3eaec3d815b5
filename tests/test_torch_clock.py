"""autodist_tpu_torch's cluster plane (``telemetry/cluster.py``) against
the JAX package's:

- the clock-offset handshake recovers an injected skew within its own
  error bound, keeps the least-RTT round when most rounds jitter, times
  out without a responder, and works over the port's coordination service
  behind ``runtime/faultinject.py``'s delaying proxy;
- the profiling flag's round trip, ``parse_profile_env`` and
  ``step_alignment`` equal the JAX functions' on the JAX cases (the same
  Python on the same inputs: equal results);
- ``ADT_PROFILE_STEPS=1:2`` on a CPU Runner writes one ``torch.profiler``
  profile of exactly those steps (``fleet-0-<worker>/trace.json``), with
  the ``profiler.windows`` counter and the window's instants; a window
  over the first step goes first and ``tracing=True``'s first-step trace
  takes the next dispatch.
"""
import functools
import json
import os
import socket
import threading
import time

import pytest
import torch

from autodist_tpu.telemetry import cluster as jcluster
from autodist_tpu.telemetry import export as jexport
from autodist_tpu.telemetry import spans as jtel
from autodist_tpu_torch.telemetry import cluster, export
from autodist_tpu_torch.telemetry import spans as tel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_isolation():
    yield
    tel.configure(None)
    tel.reset()


class FakeCoordClient:
    """In-process stand-in for the coordination client's KV, queue and
    blob calls (the JAX test's), with an optional wire delay."""

    def __init__(self, delay_s=0.0):
        self.kv, self.queues, self.blobs, self.counters = {}, {}, {}, {}
        self.delay_s = delay_s
        self._lock = threading.Lock()

    def _wire(self):
        if self.delay_s:
            time.sleep(self.delay_s)

    def put(self, key, value):
        self._wire()
        with self._lock:
            self.kv[key] = value

    def get(self, key):
        self._wire()
        with self._lock:
            return self.kv.get(key)

    def incr(self, name):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + 1
            return self.counters[name]

    def qpush(self, queue, payload, token=None):
        self._wire()
        with self._lock:
            self.queues.setdefault(queue, []).append(payload)

    def qpop(self, queue):
        self._wire()
        with self._lock:
            q = self.queues.get(queue)
            return q.pop(0) if q else None

    def bput(self, key, version, payload, token=None):
        with self._lock:
            self.blobs[key] = (version, payload)

    def bget(self, key):
        with self._lock:
            return self.blobs.get(key)


def test_clock_offset_recovers_injected_skew():
    client = FakeCoordClient()
    skew_ns = 3_000_000_000
    with cluster.ClockSyncResponder(client, poll_s=0.001):
        est = cluster.estimate_clock_offset(
            client, "w0", rounds=4, clock=lambda: time.time_ns() + skew_ns)
    assert est.rounds == 4
    assert abs(est.offset_ns + skew_ns) <= max(est.error_ns, 50_000_000)
    assert est.error_ns == est.rtt_ns // 2 + 1
    assert cluster.ClockOffset.from_dict(est.to_dict()) == est
    assert est.to_dict().keys() == jcluster.ClockOffset(
        1, 2, 3, 4).to_dict().keys()


def test_clock_offset_least_rtt_filters_jitter():
    client = FakeCoordClient()
    delays = iter([0.05, 0.0, 0.05, 0.0, 0.002, 0.0, 0.03, 0.0] * 8)
    push = client.qpush

    def jittered(queue, payload, token=None):
        time.sleep(next(delays, 0.0))
        push(queue, payload, token=token)
    client.qpush = jittered
    with cluster.ClockSyncResponder(client, poll_s=0.001):
        est = cluster.estimate_clock_offset(client, "w0", rounds=4)
    assert abs(est.offset_ns) <= max(est.error_ns, 20_000_000)
    assert est.error_ns < 25_000_000   # a fast round won, not a 50 ms one


def test_clock_offset_times_out_without_responder():
    with pytest.raises(TimeoutError, match="ClockSyncResponder"):
        cluster.estimate_clock_offset(FakeCoordClient(), "w0", rounds=2,
                                      round_timeout_s=0.05)


def test_clock_offset_over_the_service_behind_the_fault_proxy():
    """An injected 2.5 s skew and an 80 ms delay on every third QPUSHB
    (the worker's requests) on the port's native service: a clean round
    wins and the offset cancels the skew; the recorder then exports in
    reference time."""
    from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                         CoordinationServer)
    from autodist_tpu_torch.runtime.faultinject import (FaultPlan,
                                                        FaultyProxy)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = CoordinationServer(port=port)
    srv.start()
    proxy = FaultyProxy("127.0.0.1", port, plan=FaultPlan({
        "faults": [{"op": "delay", "match": "QPUSHB", "nth": 3,
                    "repeat": True, "delay_s": 0.08}]}))
    proxy.start()
    ref = CoordinationClient("127.0.0.1", port)
    worker = CoordinationClient("127.0.0.1", proxy.port)
    skew_ns = 2_500_000_000
    rec = tel.TraceRecorder(capacity=8, sample=1, pid=7, host="w0")
    try:
        with cluster.ClockSyncResponder(ref, poll_s=0.001) as responder:
            est = cluster.sync_recorder_clock(
                worker, "w0", recorder=rec, rounds=6,
                clock=lambda: time.time_ns() + skew_ns)
        assert responder.answered >= 4
        assert abs(est.offset_ns + skew_ns) <= max(est.error_ns, 50_000_000)
        assert est.rtt_ns < 80_000_000
        assert (rec.clock_offset_ns, rec.clock_error_ns) == (
            est.offset_ns, est.error_ns)
        assert export.chrome_trace(rec)["otherData"]["clock_offset_ns"] \
            == est.offset_ns
    finally:
        worker.close()
        ref.close()
        proxy.stop()
        srv.stop()


def test_profile_flag_round_trip_equals_jax():
    for mod in (cluster, jcluster):
        client = FakeCoordClient()
        assert mod.read_profile_window(client) is None
        seq = mod.request_profile(client, 3, 5)
        assert mod.read_profile_window(client) == (seq, 3, 5)
        seq2 = mod.request_profile(client, 10, 12)
        assert seq2 > seq and client.kv == {"profile/window": "2 10 12"}
        mod.clear_profile(client)
        assert mod.read_profile_window(client) is None
        with pytest.raises(ValueError):
            mod.request_profile(client, 5, 3)


@pytest.mark.parametrize("raw", ["", "3:5", "4", "5:3", "nope", " 2:2 ",
                                 "7:"])
def test_parse_profile_env_equals_jax(raw):
    assert cluster.parse_profile_env(raw) == jcluster.parse_profile_env(raw)


def test_step_alignment_equals_jax():
    """Two processes' dispatch spans (one of them dispatching step 1
    twice, a rollback's replay) through both packages' recorders and
    exports: the merged traces and the alignment are equal."""
    traces = {}
    for name, t, ex in (("port", tel, export), ("jax", jtel, jexport)):
        recs = [t.TraceRecorder(capacity=16, sample=1, pid=pid, host=h)
                for pid, h in ((1, "a"), (2, "b"))]
        for rec in recs:
            rec.epoch_offset_ns = 1_000_000_000   # one timebase
            for step in (0, 1, 1, 2):
                with rec.span("runner.dispatch", "runner", step=step):
                    pass
        traces[name] = ex.merge_traces([ex.chrome_trace(r) for r in recs])
    align = cluster.step_alignment(traces["port"])
    assert align == jcluster.step_alignment(traces["port"])
    assert align["aligned_steps"] == 3 and set(align["steps"]) == {0, 1, 2}
    assert len(jcluster.step_alignment(traces["jax"])["steps"]) == 3


def test_env_window_writes_one_profile_of_exactly_those_steps(monkeypatch,
                                                               tmp_path):
    from autodist_tpu_torch import const as const_mod
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    monkeypatch.setenv("ADT_PROFILE_STEPS", "1:2")
    monkeypatch.setattr(const_mod, "DEFAULT_TRACE_DIR",
                        str(tmp_path / "traces"))
    tel.configure("1")
    loss_fn, params, batch, _ = lm.make_train_setup(
        lm.LMConfig.tiny(), seq_len=16, batch_size=8)
    adt.reset()
    try:
        runner = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                              device="cpu", tracing=True).build(
            loss_fn, functools.partial(torch.optim.Adam, lr=1e-3), params,
            batch)
        runner.init(params)
        written = []
        for _ in range(4):
            runner.run(batch)
            written.append(runner.last_profile_path)
        out = tmp_path / "traces" / ("fleet-0-%s" % runner._worker)
        first = written[0]
        assert written == [first, first] + [str(out / "trace.json")] * 2
        assert sorted(os.listdir(tmp_path / "traces")) == sorted(
            [out.name, os.path.basename(os.path.dirname(first))])
        assert runner._profile_prof is None and \
            runner._profile_window is None
        assert tel.counters()["profiler.windows"] == 1
        inst = {e.name: e.args for e in tel.get_recorder().events()
                if e.name.startswith("profiler.window_")}
        assert inst["profiler.window_start"]["step"] == 1
        assert inst["profiler.window_stop"]["step"] == 3

        def sqrt_updates(path):   # Adam's one _foreach_sqrt_ a step
            with open(path) as f:
                return sum(e.get("name") == "aten::_foreach_sqrt_"
                           for e in json.load(f)["traceEvents"])
        assert sqrt_updates(first) == 1                 # step 0 (tracing)
        assert sqrt_updates(out / "trace.json") == 2    # steps 1 and 2
    finally:
        adt.reset()


def test_window_over_the_first_step_defers_the_first_step_trace(
        monkeypatch, tmp_path):
    """``ADT_PROFILE_STEPS=0:1`` with ``tracing=True``: the window owns
    the profiler for steps 0 and 1, and the first-step trace (as the JAX
    runner defers it) covers step 2 alone."""
    from autodist_tpu_torch import const as const_mod
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    monkeypatch.setenv("ADT_PROFILE_STEPS", "0:1")
    monkeypatch.setattr(const_mod, "DEFAULT_TRACE_DIR",
                        str(tmp_path / "traces"))
    loss_fn, params, batch, _ = lm.make_train_setup(
        lm.LMConfig.tiny(), seq_len=16, batch_size=8)
    adt.reset()
    try:
        runner = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                              device="cpu", tracing=True).build(
            loss_fn, functools.partial(torch.optim.Adam, lr=1e-3), params,
            batch)
        runner.init(params)
        written = []
        for _ in range(4):
            runner.run(batch)
            written.append(runner.last_profile_path)
        window = str(tmp_path / "traces" / ("fleet-0-%s" % runner._worker)
                     / "trace.json")
        assert written[:2] == [None, window]
        assert written[2] == written[3] != window
        assert runner._profile_prof is None and not runner._tracing

        def sqrt_updates(path):   # Adam's one _foreach_sqrt_ a step
            with open(path) as f:
                return sum(e.get("name") == "aten::_foreach_sqrt_"
                           for e in json.load(f)["traceEvents"])
        assert sqrt_updates(window) == 2                # steps 0 and 1
        assert sqrt_updates(written[2]) == 1            # step 2
    finally:
        adt.reset()
