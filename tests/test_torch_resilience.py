"""The port's resilient control-plane client and owner loop under faults.

The cases of the JAX package's ``tests/test_faults.py`` for the
coordination wire, with the port's clients against the port's service:
idempotency tokens replayed exactly once, the port's
``ResilientCoordinationClient`` through the JAX package's
``runtime/faultinject.FaultyProxy`` (test scaffolding: the port does not
import it) under connection resets, delays, a truncated blob and a
service restart mid-run, the retry budget and the circuit breaker; then
the port's async-PS owner loop through a service blip and past its
reconnect budget, and a worker's degraded pulls.
"""
import functools
import socket
import threading
import time

import numpy as np
import pytest
import torch

from autodist_tpu.runtime.faultinject import FaultPlan, FaultyProxy
from autodist_tpu_torch.runtime import ps_service as pss
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     CoordinationServer)
from autodist_tpu_torch.runtime.resilience import (CircuitOpenError,
                                                   CoordinationUnavailable,
                                                   ResilientCoordinationClient)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture()
def server():
    srv = CoordinationServer(port=_free_port())
    srv.start()
    yield srv
    srv.stop()


# ------------------------------------- idempotency tokens: exactly once


def test_incr_token_replay_exactly_once(server):
    c1 = CoordinationClient("127.0.0.1", server.port)
    assert c1.incr("chaos/n", token="tok-incr-1") == 1
    c1.close()
    c2 = CoordinationClient("127.0.0.1", server.port)
    assert c2.incr("chaos/n", token="tok-incr-1") == 1  # replayed, not 2
    assert c2.incr("chaos/n") == 2
    c2.close()


def test_qpush_token_exactly_once(server):
    c1 = CoordinationClient("127.0.0.1", server.port)
    c1.qpush("chaos/q", b"grad-blob", token="tok-q-1")
    c1.close()
    c2 = CoordinationClient("127.0.0.1", server.port)
    c2.qpush("chaos/q", b"grad-blob", token="tok-q-1")  # deduped
    assert c2.qlen("chaos/q") == 1
    assert c2.qpop("chaos/q") == b"grad-blob"
    assert c2.qlen("chaos/q") == 0
    c2.close()


def test_bput_token_replay(server):
    c = CoordinationClient("127.0.0.1", server.port)
    c.bput("chaos/blob", 3, b"v3", token="tok-b-1")
    c.bput("chaos/blob", 4, b"v4")
    # the stale retry replays OK but must not clobber version 4
    c.bput("chaos/blob", 3, b"v3", token="tok-b-1")
    assert c.bget("chaos/blob") == (4, b"v4")
    c.close()


def test_barrier_token_replay_does_not_rewait(server):
    c = CoordinationClient("127.0.0.1", server.port)
    c.barrier("chaos/b", 1, token="tok-bar-1")
    c.close()
    c2 = CoordinationClient("127.0.0.1", server.port, timeout=5.0)
    c2.barrier("chaos/b", 1, token="tok-bar-1")  # would hang without replay
    c2.close()


def test_parked_barrier_drop_then_retry_counts_once(server):
    """An arrival whose connection dies while parked is forgotten; its
    retry (same token) is the one arrival."""
    dead = CoordinationClient("127.0.0.1", server.port)
    dead._sock.sendall(b"BARRIER chaos/b2 2 tok-bar-2\n")
    time.sleep(0.2)
    dead._sock.close()
    time.sleep(0.2)
    released = threading.Event()

    def retry_then_wait():
        c = CoordinationClient("127.0.0.1", server.port)
        c.barrier("chaos/b2", 2, token="tok-bar-2")
        released.set()
        c.close()

    t = threading.Thread(target=retry_then_wait, daemon=True)
    t.start()
    time.sleep(0.3)
    assert not released.is_set()  # one live arrival, not two
    c = CoordinationClient("127.0.0.1", server.port)
    c.barrier("chaos/b2", 2)
    t.join(timeout=5)
    assert released.is_set()
    c.close()


# ------------------------------------------- the wire path, through faults


def test_connection_reset_storm_exactly_once(server):
    """Resets after every 3rd INC (applied, reply lost): the retries ride
    their tokens and the counter advances once a logical increment."""
    plan = FaultPlan({"seed": 7, "faults": [
        {"op": "reset", "match": "INC", "nth": 3, "repeat": True,
         "when": "after"}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan) as proxy:
        rc = ResilientCoordinationClient("127.0.0.1", proxy.port,
                                         rpc_timeout=5.0, seed=0)
        values = [rc.incr("chaos/storm") for _ in range(10)]
        rc.close()
    assert values == list(range(1, 11)), values
    assert any(i.startswith("reset:") for i in plan.injected), plan.injected
    c = CoordinationClient("127.0.0.1", server.port)
    assert c.incr("chaos/storm") == 11
    c.close()


def test_qpush_through_resets_no_duplicates(server):
    plan = FaultPlan({"seed": 3, "faults": [
        {"op": "reset", "match": "QPUSHB", "nth": 2, "repeat": True,
         "when": "after"}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan) as proxy:
        rc = ResilientCoordinationClient("127.0.0.1", proxy.port,
                                         rpc_timeout=5.0, seed=0)
        for i in range(6):
            rc.qpush("chaos/gq", b"blob-%d" % i)
        rc.close()
    c = CoordinationClient("127.0.0.1", server.port)
    assert c.qlen("chaos/gq") == 6
    assert [c.qpop("chaos/gq") for _ in range(6)] == [
        b"blob-%d" % i for i in range(6)]
    c.close()


def test_rpc_delay_past_deadline_is_retried(server):
    plan = FaultPlan({"seed": 1, "faults": [
        {"op": "delay", "match": "GET", "nth": 1, "delay_s": 1.0}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan) as proxy:
        rc = ResilientCoordinationClient("127.0.0.1", proxy.port,
                                         rpc_timeout=0.25, seed=0)
        rc.put("chaos/k", "v")
        t0 = time.monotonic()
        assert rc.get("chaos/k") == "v"
        assert rc.stats["retries"] >= 1
        assert time.monotonic() - t0 < 10.0
        rc.close()


def test_truncated_blob_detected_and_retried(server):
    """A value blob cut mid-payload reads as a dead connection, never as
    a short array, and the retry fetches it whole."""
    payload = np.arange(4096, dtype=np.float32).tobytes()
    seed_client = CoordinationClient("127.0.0.1", server.port)
    seed_client.bput("chaos/big", 9, payload)
    seed_client.close()
    plan = FaultPlan({"seed": 2, "faults": [
        {"op": "truncate", "match": "BGETB", "nth": 1, "bytes": 64}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan) as proxy:
        rc = ResilientCoordinationClient("127.0.0.1", proxy.port,
                                         rpc_timeout=5.0, seed=0)
        ver, got = rc.bget("chaos/big")
        rc.close()
    assert (ver, got) == (9, payload)
    assert "truncate:BGETB" in plan.injected


def test_service_restart_midrun_reconnects(server):
    """The service is killed and started again on its port when step 3
    passes; the client reconnects through the proxy and keeps working
    (the volatile state died with the service)."""
    restarts = []

    def restart_service():
        server.stop()
        server.start()
        restarts.append(time.monotonic())

    plan = FaultPlan({"seed": 5, "faults": [{"op": "restart", "at_step": 3}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan,
                     restart_fn=restart_service) as proxy:
        rc = ResilientCoordinationClient("127.0.0.1", proxy.port,
                                         rpc_timeout=5.0, seed=0)
        for step in range(1, 6):
            rc.report_step("w0", step)
        deadline = time.monotonic() + 10
        while not restarts and time.monotonic() < deadline:
            time.sleep(0.02)
        assert restarts, "restart fault never fired"
        assert "restart:STEP" in plan.injected
        rc.put("chaos/after", "alive")
        assert rc.get("chaos/after") == "alive"
        assert 3 <= rc.min_step() <= 5
        assert rc.stats["reconnects"] >= 2
        rc.close()


def test_retry_budget_exhaustion_is_loud():
    rc = ResilientCoordinationClient("127.0.0.1", _free_port(),
                                     max_retries=1, backoff_base_s=0.01,
                                     breaker_failures=100, seed=0)
    with pytest.raises(CoordinationUnavailable, match="failed after 2"):
        rc.ping()
    assert rc.stats["retries"] == 1
    rc.close()


def test_circuit_breaker_opens_then_recovers():
    port = _free_port()
    rc = ResilientCoordinationClient(
        "127.0.0.1", port, max_retries=1, backoff_base_s=0.01,
        breaker_failures=2, breaker_cooldown_s=0.4, seed=0)
    with pytest.raises(CoordinationUnavailable):
        rc.ping()  # 2 transport failures: the breaker opens
    t0 = time.monotonic()
    with pytest.raises(CircuitOpenError):
        rc.ping()  # fails fast, no connect
    assert time.monotonic() - t0 < 0.3
    srv = CoordinationServer(port=port)
    srv.start()
    try:
        time.sleep(0.5)
        assert rc.ping()
        assert rc.stats["breaker_opens"] >= 1
    finally:
        rc.close()
        srv.stop()


def test_qpop_is_at_most_once(server):
    """A pop whose connection is reset around it raises instead of
    retrying (a retry could pop a second blob and lose the first): the
    blob it may have popped is lost, never delivered twice. Whether the
    service saw the pop before the reset is a race, so the rest of the
    queue is either both blobs or the second."""
    c = CoordinationClient("127.0.0.1", server.port)
    c.qpush("chaos/pq", b"a")
    c.qpush("chaos/pq", b"b")
    c.close()
    plan = FaultPlan({"seed": 4, "faults": [
        {"op": "reset", "match": "QPOPB", "nth": 1, "when": "after"}]})
    with FaultyProxy("127.0.0.1", server.port, plan=plan) as proxy:
        rc = ResilientCoordinationClient("127.0.0.1", proxy.port,
                                         rpc_timeout=5.0, seed=0)
        with pytest.raises(OSError):
            rc.qpop("chaos/pq")
        assert rc.stats["retries"] == 0
        rest = []
        while True:
            blob = rc.qpop("chaos/pq")
            if blob is None:
                break
            rest.append(blob)
        assert rest in ([b"a", b"b"], [b"b"]), rest
        rc.close()


# ------------------------------------------ the owner loop and the pulls


class _FlakyService(pss.LocalPSService):
    """In-process service whose transport can be forced down (every call
    raises ConnectionResetError); counts reconnect() kicks."""

    def __init__(self):
        super().__init__()
        self.down = False
        self.reconnects = 0

    def _check(self):
        if self.down:
            raise ConnectionResetError("injected transport failure")

    def reconnect(self):
        self.reconnects += 1

    def publish(self, version, blob):
        self._check()
        super().publish(version, blob)

    def fetch(self):
        self._check()
        return super().fetch()

    def push_grads(self, blob):
        self._check()
        super().push_grads(blob)

    def pop_grads(self):
        self._check()
        return super().pop_grads()

    def pending_grads(self):
        self._check()
        return super().pending_grads()


def _worker_pair(service, **kw):
    applied = []

    def apply_fn(arrays):
        applied.append(arrays["g"].copy())

    worker = pss.AsyncPSWorker(
        service, apply_fn,
        lambda: {"v": torch.full((2,), float(len(applied)))}, **kw)
    return worker, applied


def _wait(cond, what, timeout=10):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_async_worker_survives_service_blip():
    """A transport error reconnects and republishes the last applied
    version; the applies go on."""
    svc = _FlakyService()
    worker, applied = _worker_pair(svc, reconnect_budget_s=30.0)
    worker.start()
    try:
        svc.push_grads(pss.pack_arrays({"g": np.ones(2, np.float32)}))
        _wait(lambda: len(applied) >= 1, "first apply")
        svc.down = True
        time.sleep(0.3)
        assert worker.healthy          # degraded, not dead
        assert worker.last_error is not None
        svc.down = False
        _wait(lambda: svc.fetch() is not None and svc.fetch()[0] == 1,
              "no republish after the blip")
        svc.push_grads(pss.pack_arrays({"g": np.ones(2, np.float32) * 2}))
        _wait(lambda: len(applied) >= 2, "applies did not resume")
        # the apply's publish follows its apply_fn call
        _wait(lambda: svc.fetch()[0] == 2, "no publish after the apply")
        assert worker.healthy and worker.last_error is None
        assert svc.reconnects >= 1
        # the republished values are the port's tensors, packed
        got = pss.unpack_arrays(svc.fetch()[1])["v"]
        np.testing.assert_array_equal(got, np.full(2, 2.0, np.float32))
    finally:
        assert worker.stop()


def test_async_worker_unhealthy_after_budget_and_runner_fails_loud():
    svc = _FlakyService()
    worker, _ = _worker_pair(svc, reconnect_budget_s=0.3)
    worker.start()
    try:
        svc.down = True
        _wait(lambda: not worker.healthy, "never turned unhealthy")
        assert worker.last_error is not None
        from autodist_tpu_torch.runtime.runner import Runner

        class _StubStore:
            serving = True

            @staticmethod
            def owner_health_errors():
                return [("hostA", str(worker.last_error))]

        class _StubStep:
            ps_store = _StubStore()

        stub = Runner.__new__(Runner)
        stub._dstep = _StubStep()
        with pytest.raises(RuntimeError, match="owner apply loop"):
            Runner._check_ps_owner_health(stub)
    finally:
        worker.stop()


def _serving_pair(svc, optimizer_kw=None):
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.model_item import VarInfo
    from autodist_tpu_torch.parallel.ps import PSStore, PSVarPlan
    infos = {"w": VarInfo(name="w", shape=(4, 2), dtype="float32")}
    plans = {"w": PSVarPlan(var_name="w", destinations=("hostA:CPU:0",),
                            sync=False)}
    opt = optim.capture(functools.partial(torch.optim.SGD, lr=0.1))
    init = {"w": torch.ones(4, 2)}
    owner = PSStore(dict(plans), infos, opt)
    owner.init_params(init)
    owner.enable_serving(lambda host: svc, my_host="hostA")
    worker = PSStore(dict(plans), infos, opt)
    worker.init_params(init)
    worker.enable_serving(lambda host: svc, my_host="hostB")
    return owner, worker


def test_worker_pull_degrades_to_last_fetch_then_fails(monkeypatch):
    """A worker that cannot reach an owner serves its last fetch for up
    to the staleness/lag bound, then fails with a diagnostic (the JAX
    ``test_worker_pull_degrades_to_last_fetch_then_fails``)."""
    monkeypatch.setenv("ADT_PS_MAX_LAG", "2")   # a window of 2 pulls
    svc = _FlakyService()
    owner, worker = _serving_pair(svc)
    try:
        vals, _ = worker.pull()
        np.testing.assert_array_equal(vals["w"].numpy(), np.ones((4, 2)))
        svc.down = True
        for _ in range(2):
            vals, _ = worker.pull()
            np.testing.assert_array_equal(vals["w"].numpy(), np.ones((4, 2)))
        assert worker.stats["degraded_pulls"] == 2
        with pytest.raises(RuntimeError, match="degraded-serve window"):
            worker.pull()
    finally:
        svc.down = False
        owner.close()
        worker.close()


def test_worker_push_drops_within_window_then_fails(monkeypatch):
    """A push that cannot reach its owner is dropped (counted) within the
    degraded window, then fails loudly."""
    monkeypatch.setenv("ADT_PS_MAX_LAG", "2")
    svc = _FlakyService()
    owner, worker = _serving_pair(svc)
    try:
        svc.down = True
        for _ in range(2):
            worker.push({"w": torch.ones(4, 2)})
        assert worker.stats["dropped_pushes"] == 2
        with pytest.raises(RuntimeError, match="pushes to owner hostA"):
            worker.push({"w": torch.ones(4, 2)})
    finally:
        svc.down = False
        owner.close()
        worker.close()
