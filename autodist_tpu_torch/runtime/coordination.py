"""Client and lifecycle of the native coordination service.

PyTorch counterpart of ``autodist_tpu/runtime/coordination.py`` (that
module imports nothing of JAX; the port keeps its own copy). The service
is the port's own copy of the C++ source
(``autodist_tpu_torch/native/coordination/coordination_service.cc``,
byte-identical to the JAX package's), built at first use with ``g++ -O2
-std=c++17 -Wall`` (the JAX ``native/Makefile``'s flags) into the
git-ignored ``autodist_tpu_torch/build/``, named by a hash of the source
and flags (:func:`build_binary`). Nothing builds at import time, and a
failed build raises: no part of the port runs without the service it
asked for.

This module:

- builds the binary and starts/stops it (:class:`CoordinationServer`);
- exposes a blocking client (:class:`CoordinationClient`): kv, counters,
  barriers, bounded-staleness step windows, heartbeats and dead-worker
  queries, versioned blobs and FIFO queues (the async PS wire).

The bounded-staleness window is the ``staleness`` knob across processes:
each process reports its step and blocks in ``wait_staleness`` while it is
more than ``staleness`` steps ahead of the slowest worker (reference
``ps_synchronizer.py:388-458``'s size-``s`` token queues).

A job at N > 1 that trains async or stale starts the service once, on the
chief, and tells every process its port::

    srv = CoordinationServer(port).start()      # ADT_COORDSVC_PORT=port
"""
import hashlib
import os
import socket
import subprocess
import threading
import time
from typing import List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "coordination",
                      "coordination_service.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall")
_build_lock = threading.Lock()


def binary_path() -> str:
    """The binary the service's source builds into: its name hashes the
    source and the compiler flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, "coordination_service-%s"
                        % digest.hexdigest()[:16])


def build_binary() -> str:
    """Compile the service with ``g++`` unless its binary exists; returns
    the binary's path. Raises with the compiler's output when the build
    fails."""
    path = binary_path()
    with _build_lock:
        if os.path.isfile(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        tmp = "%s.tmp.%d" % (path, os.getpid())
        logging.info("building the coordination service (%s)", SOURCE)
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(
                "coordination service build failed (%s exit %d):\n%s"
                % (cxx, out.returncode, out.stderr))
        os.replace(tmp, path)
    return path


def job_processes() -> int:
    """The job's processes: ``ADT_NUM_PROCESSES`` when it says more than
    one, else the default ``torch.distributed`` group's world size (an
    async job builds each process at one replica, so its plan cannot
    say)."""
    n = const.ENV.ADT_NUM_PROCESSES.val
    if n > 1:
        return n
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class CoordinationServer:
    """Owns a service process (chief-side)."""

    def __init__(self, port: int = const.DEFAULT_COORDSVC_PORT):
        self.port = port
        self._proc: Optional[subprocess.Popen] = None

    def start(self, wait: Optional[float] = None):
        """Launch the service and wait up to ``wait`` seconds for it to
        answer a ping (default: ``ADT_COORDSVC_START_TIMEOUT_S``)."""
        if wait is None:
            wait = const.ENV.ADT_COORDSVC_START_TIMEOUT_S.val
        binary = build_binary()
        # detached stdio: the service must not hold the parent's pipes
        # open (it can outlive the chief)
        self._proc = subprocess.Popen([binary, str(self.port)],
                                      stdin=subprocess.DEVNULL,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
        deadline = time.time() + wait
        while time.time() < deadline:
            try:
                CoordinationClient("127.0.0.1", self.port).ping()
                return self
            except OSError:
                if self._proc.poll() is not None:
                    raise RuntimeError(
                        "coordination service exited with %s (port %d busy?)"
                        % (self._proc.returncode, self.port))
                time.sleep(0.05)
        # a process that exists but never answered is killed and reaped
        self._proc.kill()
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass
        self._proc = None
        raise TimeoutError("coordination service did not come up within "
                           "%.1fs (ADT_COORDSVC_START_TIMEOUT_S)" % wait)

    def stop(self):
        if self._proc and self._proc.poll() is None:
            try:
                # finite deadlines on the connect and the reply: a wedged
                # service falls through to the kill
                CoordinationClient("127.0.0.1", self.port,
                                   timeout=2.0, connect_timeout=2.0).shutdown()
                self._proc.wait(timeout=2)
            except (OSError, subprocess.TimeoutExpired):
                self._proc.kill()
                try:
                    self._proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass  # unreapable; teardown must not raise
        self._proc = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class CoordinationClient:
    """One blocking connection to the service (not thread safe: one a
    thread)."""

    # kMaxBlobBytes in coordination_service.cc: an oversized payload fails
    # here, before any byte is on the wire
    MAX_BLOB_BYTES = 1 << 31

    def __init__(self, host: str = "127.0.0.1",
                 port: int = const.DEFAULT_COORDSVC_PORT,
                 timeout: Optional[float] = None,
                 connect_timeout: Optional[float] = None):
        if connect_timeout is None:
            connect_timeout = const.ENV.ADT_CONNECT_TIMEOUT_S.val
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        # a large frame is sent as its header, then its payload (no
        # copy): without this the payload's write would wait on the
        # delayed ACK of the header's
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(timeout)
        self._buf = b""

    def set_rpc_timeout(self, timeout: Optional[float]):
        """Deadline of the following calls (None: block). A call past it
        raises ``socket.timeout`` (an OSError) with the connection in an
        unknown state: the caller reconnects (the resilient client
        does)."""
        self._sock.settimeout(timeout)

    def _recv_line(self) -> str:
        while b"\n" not in self._buf:
            chunk = self._sock.recv(262144)
            if not chunk:
                raise OSError("coordination service closed connection")
            self._buf += chunk
        resp, self._buf = self._buf.split(b"\n", 1)
        return resp.decode().strip()

    def _recv_raw(self, n: int) -> bytes:
        if len(self._buf) >= n:
            payload, self._buf = self._buf[:n], self._buf[n:]
            return payload
        # a large blob lands in one preallocated buffer, not by repeated
        # concatenation
        out = bytearray(n)
        have = len(self._buf)
        out[:have] = self._buf
        self._buf = b""
        view = memoryview(out)
        while have < n:
            got = self._sock.recv_into(view[have:], min(n - have, 1 << 24))
            if not got:
                raise OSError("coordination service closed connection")
            have += got
        return bytes(out)

    def _cmd(self, line: str) -> str:
        self._sock.sendall(line.encode() + b"\n")
        return self._recv_line()

    def _cmd_raw(self, header: str, payload: bytes) -> str:
        """A length-prefixed binary frame: the header line, then the raw
        payload (the B-suffixed commands)."""
        if len(payload) > self.MAX_BLOB_BYTES:
            raise ValueError(
                "blob payload %d bytes exceeds the service cap %d" %
                (len(payload), self.MAX_BLOB_BYTES))
        head = header.encode() + b"\n"
        if len(payload) < (1 << 20):
            self._sock.sendall(head + payload)
        else:
            self._sock.sendall(head)
            self._sock.sendall(payload)
        return self._recv_line()

    # ----------------------------------------------------------------- api

    @staticmethod
    def _token(name: str) -> str:
        """Names ride the line protocol as single space-separated tokens:
        whitespace would shift the arity (and on the binary commands make
        the service parse the payload as command lines)."""
        if not name or any(c.isspace() for c in name):
            raise ValueError(
                "coordination-service name %r must be non-empty with no "
                "whitespace" % (name,))
        return name

    def _cmd_ok(self, line: str) -> None:
        """A side-effecting RPC that must succeed (not an assert: under
        ``python -O`` the RPC would never be sent)."""
        resp = self._cmd(line)
        if resp != "OK":
            raise RuntimeError("coordination service rejected %r: %s"
                               % (line.split(" ", 1)[0], resp))

    def ping(self) -> bool:
        return self._cmd("PING") == "PONG"

    def put(self, key: str, value: str):
        self._cmd_ok("PUT %s %s" % (self._token(key), value))

    def get(self, key: str) -> Optional[str]:
        resp = self._cmd("GET %s" % self._token(key))
        return None if resp == "NONE" else resp[4:]

    @staticmethod
    def _tok_suffix(token) -> str:
        """An optional idempotency token the service dedups replies on (a
        retry of one logical call reuses it)."""
        if token is None:
            return ""
        if not token or any(c.isspace() for c in token):
            raise ValueError("idempotency token %r must be non-empty with "
                             "no whitespace" % (token,))
        return " " + token

    def incr(self, name: str, token: Optional[str] = None) -> int:
        return int(self._cmd("INC %s%s" % (self._token(name),
                                           self._tok_suffix(token)))[4:])

    def barrier(self, name: str, num_workers: int,
                token: Optional[str] = None):
        """Block until ``num_workers`` processes reach this barrier."""
        self._cmd_ok("BARRIER %s %d%s" % (self._token(name), num_workers,
                                          self._tok_suffix(token)))

    def report_step(self, worker: str, step: int,
                    token: Optional[str] = None):
        self._cmd_ok("STEP %s %d%s" % (self._token(worker), step,
                                       self._tok_suffix(token)))

    def min_step(self) -> int:
        return int(self._cmd("MINSTEP")[4:])

    def wait_staleness(self, my_step: int, staleness: int):
        """Block while ``my_step > min_step + staleness`` (staleness 0 is
        lockstep)."""
        self._cmd_ok("WAITMIN %d %d" % (my_step, staleness))

    def goodbye(self, worker: str):
        """Deregister: a finished worker is neither counted dead nor
        bounds the staleness window."""
        return self._cmd("GOODBYE %s" % self._token(worker))

    def heartbeat(self, worker: str):
        self._cmd_ok("HEARTBEAT %s" % self._token(worker))

    # ---- versioned blobs and FIFO queues (the async PS wire)

    def bput(self, key: str, version: int, payload: bytes,
             token: Optional[str] = None):
        """Publish a versioned blob (binary frame)."""
        resp = self._cmd_raw("BPUTB %s %d %d%s"
                             % (self._token(key), version, len(payload),
                                self._tok_suffix(token)),
                             payload)
        if resp != "OK":
            raise RuntimeError("bput rejected: %s" % resp)

    def bget(self, key: str):
        """(version, payload) of the latest published blob, or None."""
        resp = self._cmd("BGETB %s" % self._token(key))
        if resp == "NONE":
            return None
        _, ver, n = resp.split(" ", 2)
        return int(ver), self._recv_raw(int(n))

    def qpush(self, queue: str, payload: bytes,
              token: Optional[str] = None):
        """Enqueue a blob (binary frame); raises when the service's queue
        cap rejects it."""
        resp = self._cmd_raw("QPUSHB %s %d%s"
                             % (self._token(queue), len(payload),
                                self._tok_suffix(token)), payload)
        if resp != "OK":
            raise RuntimeError("qpush rejected: %s" % resp)

    def qpop(self, queue: str):
        resp = self._cmd("QPOPB %s" % self._token(queue))
        if resp == "NONE":
            return None
        return self._recv_raw(int(resp.split(" ", 1)[1]))

    def qlen(self, queue: str) -> int:
        return int(self._cmd("QLEN %s" % self._token(queue))[4:])

    def dead_workers(self, timeout_s: float) -> List[str]:
        resp = self._cmd("DEADLIST %s" % timeout_s)
        return [] if resp == "NONE" else resp[4:].split(",")

    def shutdown(self):
        self._cmd("SHUTDOWN")

    def close(self):
        self._sock.close()
