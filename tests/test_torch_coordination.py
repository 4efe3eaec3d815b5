"""The port's coordination service and client against the JAX package's.

The service is the port's byte-identical copy of the C++ source, built by
``autodist_tpu_torch/runtime/coordination.py`` with ``g++``. Every case of
the JAX package's ``tests/test_coordination.py`` (but the coordinator's
watchdog, which comes with ``coordinator.py``) runs once with the port's
client and once with the JAX client against that service, and the mixed
cases drive one service from both clients at once: a key, a counter, a
barrier, a staleness window, a blob and a queue written by one package
are read by the other.
"""
import base64
import filecmp
import os
import socket
import threading
import time

import pytest
import torch

from autodist_tpu.runtime import coordination as jax_coord
from autodist_tpu_torch.runtime import coordination as port_coord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = {"torch": port_coord.CoordinationClient,
           "jax": jax_coord.CoordinationClient}


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


@pytest.fixture(scope="module")
def server():
    srv = port_coord.CoordinationServer(port=_free_port())
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(params=sorted(CLIENTS))
def client(request, server):
    """A factory of one package's clients on the port's service; each
    case's keys are namespaced by the package, so the two runs of a case
    share the module's service without meeting."""
    cls = CLIENTS[request.param]

    def make(**kw):
        return cls("127.0.0.1", server.port, **kw)
    make.cls = cls
    make.ns = request.param
    return make


def test_service_source_is_the_jax_packages_byte_for_byte():
    src = os.path.join(ROOT, "autodist_tpu_torch", "native", "coordination",
                       "coordination_service.cc")
    ref = os.path.join(ROOT, "autodist_tpu", "native", "coordination",
                       "coordination_service.cc")
    assert filecmp.cmp(src, ref, shallow=False)
    assert port_coord.SOURCE == src


def test_binary_builds_into_the_ignored_build_dir(server):
    path = port_coord.build_binary()
    assert os.path.dirname(path) == os.path.join(ROOT, "autodist_tpu_torch",
                                                 "build")
    assert os.access(path, os.X_OK)
    c = port_coord.CoordinationClient("127.0.0.1", server.port)
    assert c.ping()
    c.close()


def test_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises with the compiler's output: nothing carries
    on without the service."""
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( {")
    monkeypatch.setattr(port_coord, "SOURCE", str(bad))
    monkeypatch.setattr(port_coord, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="build failed"):
        port_coord.build_binary()


def test_ping_kv_counter(client):
    c = client()
    ns = client.ns
    assert c.ping()
    c.put(ns + "/strategy_id", "20260729T0001 with spaces")
    assert c.get(ns + "/strategy_id") == "20260729T0001 with spaces"
    assert c.get(ns + "/missing") is None
    assert c.incr(ns + "/n") == 1
    assert c.incr(ns + "/n") == 2
    c.close()


def test_barrier_releases_all(client):
    results = []
    name = client.ns + "/b1"

    def worker(i):
        c = client()
        c.barrier(name, 3)
        results.append(i)
        c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    assert results == []  # nobody through until the third arrives
    c = client()
    c.barrier(name, 3)
    for t in threads:
        t.join(timeout=5)
    assert sorted(results) == [0, 1]
    c.close()


def test_staleness_window_blocks_fast_worker(client):
    """A fast worker at step 3 with staleness 1 blocks until the slowest
    reaches 2. MINSTEP is global to the service, so this case's slow
    worker reports the lowest step any case of this module reports, and
    says goodbye after."""
    slow = client.ns + "-slow"
    c_fast, c_slow = client(), client()
    c_slow.report_step(slow, -50)
    assert c_fast.min_step() == -50
    released = threading.Event()

    def fast_wait():
        c = client()
        c.wait_staleness(-47, 1)
        released.set()
        c.close()

    t = threading.Thread(target=fast_wait)
    t.start()
    time.sleep(0.2)
    assert not released.is_set()
    c_slow.report_step(slow, -48)
    t.join(timeout=5)
    assert released.is_set()
    # staleness 0 == lockstep: a step equal to the min passes at once
    c_fast.wait_staleness(-48, 0)
    c_slow.goodbye(slow)
    c_fast.close()
    c_slow.close()


def test_heartbeat_dead_detection(client):
    c = client()
    w = client.ns + "-w0"
    c.heartbeat(w)
    assert w not in c.dead_workers(5.0)
    time.sleep(0.3)
    assert w in c.dead_workers(0.1)
    c.goodbye(w)
    c.close()


def test_queue_cap_rejects_then_recovers(client):
    """QPUSH past the service's cap is rejected loudly, and a pop makes
    room again."""
    c = client()
    q = client.ns + "/capq"
    for _ in range(4096):
        c.qpush(q, b"x")
    with pytest.raises(RuntimeError, match="queue full"):
        c.qpush(q, b"y")
    assert c.qlen(q) == 4096
    assert c.qpop(q) == b"x"
    c.qpush(q, b"y")  # room again
    c.close()


def test_goodbye_deregisters(client):
    """GOODBYE takes the worker out of the DEADLIST universe and off the
    staleness window."""
    c = client()
    w = client.ns + "-w7"
    c.heartbeat(w)
    c.report_step(w, -100)  # below any other case's steps
    time.sleep(0.3)
    assert w in c.dead_workers(0.1)
    assert c.min_step() == -100
    c.goodbye(w)
    assert w not in c.dead_workers(0.1)
    assert c.min_step() != -100
    c.close()


def test_binary_blob_roundtrip_and_text_interop(client):
    """The binary frames carry raw payloads; the text b64 commands read
    and write the same keys and queues."""
    c = client()
    ns = client.ns
    payload = bytes(range(256)) * 64 + b"\n\r binary-hostile \x00\xff"
    c.bput(ns + "/bin/key", 7, payload)
    assert c.bget(ns + "/bin/key") == (7, payload)
    resp = c._cmd("BGET %s/bin/key" % ns)
    assert resp.startswith("BVAL 7 ")
    assert base64.b64decode(resp.split(" ", 2)[2]) == payload
    c._cmd("BPUT %s/bin/key2 3 %s" % (ns, base64.b64encode(payload).decode()))
    assert c.bget(ns + "/bin/key2") == (3, payload)
    c.qpush(ns + "/bin/q", payload)
    c.qpush(ns + "/bin/q", payload)
    assert c.qpop(ns + "/bin/q") == payload
    resp = c._cmd("QPOP %s/bin/q" % ns)
    assert base64.b64decode(resp[5:]) == payload
    c.bput(ns + "/bin/empty", 1, b"")
    assert c.bget(ns + "/bin/empty") == (1, b"")
    c.close()


def test_rejected_blob_frame_does_not_desync(client):
    """An oversized BPUTB is rejected and its payload drained, never
    parsed as command lines."""
    c = client()
    cap = client.cls.MAX_BLOB_BYTES
    hostile = b"\nSHUTDOWN\nPUT pwned yes\n"
    c._sock.sendall(b"BPUTB bad/key 1 %d\n" % (cap + 16) + hostile)
    assert c._recv_line().startswith("ERR bad length")
    remaining = cap + 16 - len(hostile)
    chunk = b"\x00" * (1 << 20)
    while remaining > 0:
        n = min(remaining, len(chunk))
        c._sock.sendall(chunk[:n])
        remaining -= n
    assert c.ping()
    assert c.get("pwned") is None
    c.close()
    c2 = client()
    assert c2.ping()
    c2.close()


def test_negative_blob_length_closes_connection(client):
    c = client()
    c._sock.sendall(b"QPUSHB q/neg -5\ngarbage")
    assert c._recv_line().startswith("ERR bad length")
    c._sock.settimeout(5.0)
    assert c._sock.recv(1) == b""
    c2 = client()
    assert c2.ping()
    c2.close()


class _FakeBytes(bytes):
    """len()-only stand-in for a payload past the cap."""

    def __new__(cls, n):
        obj = super().__new__(cls)
        obj._n = n
        return obj

    def __len__(self):
        return self._n


def test_client_rejects_oversized_payload_before_send(client):
    c = client()
    big = _FakeBytes(client.cls.MAX_BLOB_BYTES + 1)
    with pytest.raises(ValueError, match="exceeds the service cap"):
        c._cmd_raw("BPUTB k 1 %d" % len(big), big)
    assert c.ping()
    c.close()


def test_unparseable_blob_length_closes_connection(client):
    c = client()
    c._sock.sendall(b"BPUTB k 1 x16\n" + b"\nSHUTDOWN\nPUT pwned2 yes\n"[:16])
    assert c._recv_line().startswith("ERR bad length")
    c._sock.settimeout(5.0)
    assert c._sock.recv(1) == b""
    c2 = client()
    assert c2.ping()
    assert c2.get("pwned2") is None
    c2.close()


def test_whitespace_keys_rejected_client_side(client):
    c = client()
    for call in (lambda: c.bput("my weight", 1, b"x"),
                 lambda: c.qpush("q one", b"x"),
                 lambda: c.put("a key", "v"),
                 lambda: c.get("a\tkey"),
                 lambda: c.heartbeat("worker one"),
                 lambda: c.qpush("", b"x")):
        with pytest.raises(ValueError, match="no\\s+whitespace|non-empty"):
            call()
    assert c.ping()
    c.close()


# ------------------------------------------------------- the two packages


def _pair(server):
    return (port_coord.CoordinationClient("127.0.0.1", server.port),
            jax_coord.CoordinationClient("127.0.0.1", server.port))


def test_mixed_kv_counter_and_blobs(server):
    t, j = _pair(server)
    t.put("mix/k", "from torch")
    assert j.get("mix/k") == "from torch"
    j.put("mix/k2", "from jax")
    assert t.get("mix/k2") == "from jax"
    assert t.incr("mix/n") == 1
    assert j.incr("mix/n") == 2
    assert t.incr("mix/n", token="mix-tok") == 3
    assert j.incr("mix/n", token="mix-tok") == 3   # the token's replay
    payload = bytes(range(256)) * 4096
    t.bput("mix/blob", 5, payload)
    assert j.bget("mix/blob") == (5, payload)
    j.bput("mix/blob", 6, payload[::-1])
    assert t.bget("mix/blob") == (6, payload[::-1])
    t.close()
    j.close()


def test_mixed_queues_and_dead_workers(server):
    t, j = _pair(server)
    for i in range(3):
        (t if i % 2 else j).qpush("mix/q", b"blob-%d" % i)
    assert t.qlen("mix/q") == j.qlen("mix/q") == 3
    assert [t.qpop("mix/q"), j.qpop("mix/q"), t.qpop("mix/q")] == [
        b"blob-0", b"blob-1", b"blob-2"]
    assert j.qpop("mix/q") is None
    t.heartbeat("mix-t")
    j.heartbeat("mix-j")
    time.sleep(0.3)
    dead = t.dead_workers(0.1)
    assert {"mix-t", "mix-j"} <= set(dead)
    assert set(j.dead_workers(0.1)) == set(dead)
    t.goodbye("mix-j")
    j.goodbye("mix-t")
    assert not {"mix-t", "mix-j"} & set(t.dead_workers(0.1))
    t.close()
    j.close()


def test_mixed_barrier_and_staleness_window(server):
    """One barrier arrival from each package releases a barrier of two;
    a torch worker's window waits on a jax worker's step."""
    t, j = _pair(server)
    released = threading.Event()

    def torch_side():
        c = port_coord.CoordinationClient("127.0.0.1", server.port)
        c.barrier("mix/b", 2)
        released.set()
        c.close()

    th = threading.Thread(target=torch_side)
    th.start()
    time.sleep(0.2)
    assert not released.is_set()
    j.barrier("mix/b", 2)
    th.join(timeout=5)
    assert released.is_set()
    j.report_step("mix-jax", -40)
    t.report_step("mix-torch", -37)
    released.clear()

    def torch_wait():
        c = port_coord.CoordinationClient("127.0.0.1", server.port)
        c.wait_staleness(-37, 2)
        released.set()
        c.close()

    th = threading.Thread(target=torch_wait)
    th.start()
    time.sleep(0.2)
    assert not released.is_set()     # -37 > -40 + 2
    j.report_step("mix-jax", -39)
    th.join(timeout=5)
    assert released.is_set()
    t.goodbye("mix-jax")
    j.goodbye("mix-torch")
    t.close()
    j.close()


def test_jax_server_serves_the_port_client():
    """The JAX package's build of the same source answers the port's
    client too."""
    srv = jax_coord.CoordinationServer(port=_free_port())
    srv.start()
    try:
        c = port_coord.CoordinationClient("127.0.0.1", srv.port)
        assert c.ping()
        c.bput("x/blob", 1, b"abc")
        assert c.bget("x/blob") == (1, b"abc")
        c.close()
    finally:
        srv.stop()


def test_server_start_timeout_and_stop_of_a_wedged_service(monkeypatch):
    """``ADT_COORDSVC_START_TIMEOUT_S`` bounds the bring-up wait and reaps
    the process; ``stop`` kills a wedged (SIGSTOPped) service within its
    deadline."""
    import signal

    class _NeverUp:
        def __init__(self, *a, **k):
            raise ConnectionRefusedError("never up")

    with monkeypatch.context() as m:
        m.setattr(port_coord, "CoordinationClient", _NeverUp)
        m.setenv("ADT_COORDSVC_START_TIMEOUT_S", "0.3")
        srv = port_coord.CoordinationServer(port=_free_port())
        t0 = time.monotonic()
        with pytest.raises(TimeoutError,
                           match="ADT_COORDSVC_START_TIMEOUT_S"):
            srv.start()
        assert time.monotonic() - t0 < 5.0
        assert srv._proc is None
    srv = port_coord.CoordinationServer(port=_free_port())
    srv.start()
    proc = srv._proc
    os.kill(proc.pid, signal.SIGSTOP)
    try:
        t0 = time.monotonic()
        srv.stop()
        assert time.monotonic() - t0 < 15.0
        assert proc.poll() is not None
    finally:
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGCONT)
            proc.kill()
