"""Async parameter-server serving over the native coordination service.

PyTorch counterpart of ``autodist_tpu/runtime/ps_service.py`` (that
module imports nothing of JAX; the port keeps its own copy). The
reference implements asynchronous PS with graph kernels: each worker's
update op pushes its gradient into a per-worker ``ConditionalAccumulator``
on the PS and applies without waiting for peers (reference
``autodist/kernel/synchronization/ps_synchronizer.py:556-633``). Async
training cannot ride collectives, which are lockstep by construction, so
the async wire is the native coordination service
(``native/coordination/coordination_service.cc``): the variable's owner
publishes versioned parameter blobs (``BPUT``), workers fetch the latest
(``BGET``) and push gradient blobs into a FIFO (``QPUSH``), and the
owner's apply thread drains the queue (``QPOP``), applying each worker's
gradient on its own through the host store's optimizer: one gradient at a
time, no averaging barrier, the reference's async semantics.

Under async PS every process trains at one replica of its own (the
reference's between-graph replication); the only coupling across
processes is this service. Fetches take the latest published version;
the only pacing is the ``ADT_PS_MAX_LAG`` backpressure bound on each
owner queue. Bounded staleness (``staleness=s``) belongs to sync training
(the Runner's step window on the service) and is refused for async
strategies.

The blobs are the JAX package's byte format (:func:`pack_arrays`): a blob
packed by either package unpacks in the other. :class:`LocalPSService` is
the in-process case (one process: the apply thread still decouples the
gradient applies from the steps).
"""
import collections
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from autodist_tpu_torch import const
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

_MAGIC = b"ADPS"


def _host_array(a) -> np.ndarray:
    """A C-contiguous numpy view of a CPU tensor or an array (a tensor
    through ``.numpy()``)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().contiguous().numpy()
    return np.ascontiguousarray(a)


def pack_arrays(arrays: Dict[str, object]) -> bytearray:
    """Self-describing binary packing of a ``{name: ndarray or tensor}``
    dict, the JAX package's byte format.

    Layout: magic, count, then per entry: name_len/name/dtype_len/dtype/
    ndim/shape.../raw bytes. Names are sorted for determinism. The blob is
    written into one buffer (each array's bytes copied once)."""
    entries, total = [], 8
    for name in sorted(arrays):
        arr = _host_array(arrays[name])
        nb = name.encode()
        dt = arr.dtype.str.encode()
        head = b"".join((struct.pack("<H", len(nb)), nb,
                         struct.pack("<H", len(dt)), dt,
                         struct.pack("<B", arr.ndim),
                         struct.pack("<%dq" % arr.ndim, *arr.shape)))
        entries.append((head, arr))
        total += len(head) + arr.nbytes
    out = bytearray(total)
    out[:8] = _MAGIC + struct.pack("<I", len(arrays))
    off = 8
    for head, arr in entries:
        out[off:off + len(head)] = head
        off += len(head)
        if arr.nbytes:
            np.copyto(np.frombuffer(out, arr.dtype, arr.size, off)
                      .reshape(arr.shape), arr)
        off += arr.nbytes
    return out


def unpack_arrays(blob: bytes) -> Dict[str, np.ndarray]:
    if blob[:4] != _MAGIC:
        raise ValueError("not an ADPS blob")
    off = 4
    (count,) = struct.unpack_from("<I", blob, off)
    off += 4
    out = {}
    for _ in range(count):
        (nlen,) = struct.unpack_from("<H", blob, off)
        off += 2
        name = blob[off:off + nlen].decode()
        off += nlen
        (dlen,) = struct.unpack_from("<H", blob, off)
        off += 2
        dtype = np.dtype(blob[off:off + dlen].decode())
        off += dlen
        (ndim,) = struct.unpack_from("<B", blob, off)
        off += 1
        shape = struct.unpack_from("<%dq" % ndim, blob, off)
        off += 8 * ndim
        size = int(np.prod(shape or (1,))) * dtype.itemsize
        out[name] = np.frombuffer(blob, dtype, count=int(np.prod(shape or (1,))),
                                  offset=off).reshape(shape).copy()
        off += size
    return out


class PSServiceBase:
    """The wire the async PS path talks over (publish/fetch values, push/pop
    gradient blobs)."""

    def publish(self, version: int, blob: bytes) -> None:
        raise NotImplementedError

    def fetch(self) -> Optional[Tuple[int, bytes]]:
        raise NotImplementedError

    # optimizer-state side channel: published alongside values but only
    # FETCHED at checkpoint time — per-step pulls read the hot values
    # channel alone, so the wire per step stays ~value bytes instead of
    # value + moments (3x under Adam)
    def publish_opt(self, version: int, blob: bytes) -> None:
        raise NotImplementedError

    def fetch_opt(self) -> Optional[Tuple[int, bytes]]:
        raise NotImplementedError

    def push_grads(self, blob: bytes) -> None:
        raise NotImplementedError

    def pop_grads(self) -> Optional[bytes]:
        raise NotImplementedError

    def pending_grads(self) -> int:
        raise NotImplementedError

    def reconnect(self) -> None:
        """Drop this thread's transport so the next call re-establishes it
        (no-op for in-process services). Called by the owner apply loop
        after a transport error."""

    def close(self) -> None:
        pass


class LocalPSService(PSServiceBase):
    """In-process service (single-process async PS; also the unit-test
    harness for the serving protocol)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._published: Optional[Tuple[int, bytes]] = None
        self._published_opt: Optional[Tuple[int, bytes]] = None
        self._queue = collections.deque()

    def publish(self, version, blob):
        with self._lock:
            self._published = (version, blob)

    def fetch(self):
        with self._lock:
            return self._published

    def publish_opt(self, version, blob):
        with self._lock:
            self._published_opt = (version, blob)

    def fetch_opt(self):
        with self._lock:
            return self._published_opt

    def push_grads(self, blob):
        with self._lock:
            self._queue.append(blob)

    def pop_grads(self):
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def pending_grads(self):
        with self._lock:
            return len(self._queue)


class CoordPSService(PSServiceBase):
    """Serving over the native coordination service. ``prefix`` isolates
    concurrent jobs on one service. Each talking thread needs its own
    socket; clients are created per-thread via the factory."""

    def __init__(self, client_factory: Callable, prefix: str = "ps"):
        self._factory = client_factory
        self._local = threading.local()
        self._prefix = prefix
        self._clients_lock = threading.Lock()
        self._clients = []  # every per-thread client, for close()
        self._closed = False

    def _client(self):
        if self._closed:
            # a thread may still hold a (now closed) client in its TLS;
            # fail with a clear error instead of a bad-fd OSError
            raise RuntimeError("CoordPSService is closed")
        if not hasattr(self._local, "client"):
            self._local.client = self._factory()
            with self._clients_lock:
                self._clients.append(self._local.client)
        return self._local.client

    def close(self):
        self._closed = True
        with self._clients_lock:
            clients, self._clients = self._clients, []
        for c in clients:
            try:
                c.close()
            except OSError:
                pass

    def publish(self, version, blob):
        # epoch-fenced (also enforced inside a resilient client's bput;
        # raw-client factories get the check here): a zombie owner must
        # not overwrite the values its replacement now serves
        elastic.maybe_fence("ps.publish")
        self._client().bput(self._prefix + "/vals", version, blob)

    def fetch(self):
        return self._client().bget(self._prefix + "/vals")

    def publish_opt(self, version, blob):
        elastic.maybe_fence("ps.publish_opt")
        self._client().bput(self._prefix + "/opt", version, blob)

    def fetch_opt(self):
        return self._client().bget(self._prefix + "/opt")

    def push_grads(self, blob):
        elastic.maybe_fence("ps.push")
        self._client().qpush(self._prefix + "/grads", blob)

    def pop_grads(self):
        return self._client().qpop(self._prefix + "/grads")

    def pending_grads(self):
        return self._client().qlen(self._prefix + "/grads")

    def reconnect(self):
        """Refresh the CALLING thread's transport after a service blip.
        A resilient client is asked to drop only its SOCKET (its circuit
        breaker and retry accounting survive — recreating the wrapper
        would re-pay the full retry budget on every probe); a raw client
        is discarded so the next call builds a fresh connection."""
        client = getattr(self._local, "client", None)
        if client is None:
            return
        if hasattr(client, "reconnect"):
            client.reconnect()
            return
        del self._local.client
        with self._clients_lock:
            if client in self._clients:
                self._clients.remove(client)
        try:
            client.close()
        except OSError:
            pass


class AsyncPSWorker:
    """The owner-side apply loop: drain gradient blobs, apply each through
    ``apply_fn``, republish ``values_fn()`` (the reference's per-worker
    accumulator apply, one gradient at a time — no barrier). ``opt_fn``
    (optional) provides the optimizer-state blob for the side channel —
    published with every apply so checkpoint reads stay fresh, but never
    downloaded by the per-step value pulls."""

    def __init__(self, service: PSServiceBase, apply_fn: Callable,
                 values_fn: Callable, poll_s: float = 0.002,
                 opt_fn: Optional[Callable] = None,
                 reconnect_budget_s: Optional[float] = None):
        self._apply_fn = apply_fn
        self._values_fn = values_fn
        self._opt_fn = opt_fn
        self._service = service
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._applied = 0
        self._busy = False  # a blob is popped but not yet applied
        # transport resilience: a service blip must not kill this thread —
        # it reconnects with backoff for up to reconnect_budget_s, then
        # declares itself UNHEALTHY (Runner fails the job loudly; silent
        # stall is the one forbidden outcome)
        if reconnect_budget_s is None:
            reconnect_budget_s = const.ENV.ADT_PS_OWNER_RETRY_S.val
        self._reconnect_budget_s = reconnect_budget_s
        self._last_error: Optional[BaseException] = None
        self._failed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="adt-ps-apply", daemon=True)

    def start(self):
        # initial publish so workers can fetch before the first apply
        self._publish(0)
        self._thread.start()
        return self

    def _publish(self, version: int):
        with tel.span("ps_service.publish", "ps_service", version=version):
            self._service.publish(version, pack_arrays(self._values_fn()))
            if self._opt_fn is not None:
                self._service.publish_opt(version,
                                          pack_arrays(self._opt_fn()))
        tel.counter_add("ps_service.published")

    def _loop(self):
        while not self._stop.is_set():
            # busy is raised BEFORE the pause check AND before the pop:
            # pause() waits on !busy, so it can never return "quiesced"
            # while this thread is past the check and about to pop; and a
            # drain() racing the pop must never observe (queue empty, not
            # busy) while a blob is in hand
            self._busy = True
            if self._pause.is_set():
                self._busy = False
                time.sleep(self._poll_s)
                continue
            try:
                blob = self._service.pop_grads()
            except OSError as e:
                # transport error OUTSIDE the apply guard used to kill
                # this daemon thread silently and stall training forever;
                # now it degrades to reconnect-with-backoff
                self._busy = False
                if not self._recover(e, "pop_grads"):
                    return
                continue
            if blob is None:
                self._busy = False
                time.sleep(self._poll_s)
                continue
            try:
                with tel.span("ps_service.apply", "ps_service"):
                    self._apply_fn(unpack_arrays(blob))
                self._applied += 1
                tel.counter_add("ps_service.applied")
                self._publish(self._applied)
            except OSError as e:
                # the gradient IS applied locally; only the republish hit
                # the wire — reconnect and republish from the last applied
                # version (workers meanwhile serve their last fetch).
                # busy drops BEFORE the (potentially long) recovery:
                # nothing is in flight, and pause()/drain() must not
                # spuriously time out while a blip is being ridden out
                self._busy = False
                if not self._recover(e, "publish"):
                    return
            except elastic.FencedOut as e:
                # this owner was declared dead and superseded: its apply
                # loop must STOP — every further publish would fight the
                # replacement's state (healthy turns False; the Runner
                # fails the job loudly on its next step)
                self._failed = True
                self._last_error = e
                logging.error("async PS owner loop fenced out: %s", e)
                return
            except Exception as e:  # noqa: BLE001 — a poisoned blob must not kill the loop
                logging.error("async PS apply failed: %s", e)
            finally:
                self._busy = False

    def _recover(self, err: OSError, where: str) -> bool:
        """Reconnect after a transport error, republishing the CURRENT
        state (version = last applied) so workers resume from where the
        owner actually is — a restarted service starts blob-less, and
        without the republish every pull would wait on a publish that
        never comes. Returns False (loop exits, ``healthy`` turns False)
        once the retry budget is exhausted."""
        self._last_error = err
        logging.warning("async PS owner loop: transport error in %s (%s); "
                        "reconnecting for up to %.0fs", where, err,
                        self._reconnect_budget_s)
        deadline = time.monotonic() + self._reconnect_budget_s
        delay = 0.05
        while not self._stop.is_set():
            if time.monotonic() > deadline:
                self._failed = True
                logging.error(
                    "async PS owner loop DEAD: could not reach the "
                    "parameter service for %.0fs (last error: %s) — "
                    "training cannot make progress",
                    self._reconnect_budget_s, self._last_error)
                return False
            time.sleep(delay)
            delay = min(1.0, delay * 2)
            try:
                self._service.reconnect()
                self._publish(self._applied)
                logging.info("async PS owner loop: reconnected after %s "
                             "blip; republished version %d", where,
                             self._applied)
                self._last_error = None
                return True
            except OSError as e:
                self._last_error = e
        return False  # stopping: not a failure

    @property
    def applied(self) -> int:
        return self._applied

    @property
    def healthy(self) -> bool:
        """False once the apply loop is dead or past its reconnect budget
        — the owner can no longer apply gradients and the job must fail
        loudly instead of stalling."""
        if self._failed:
            return False
        if (self._thread.ident is not None and not self._thread.is_alive()
                and not self._stop.is_set()):
            return False  # thread died unexpectedly (bug / unhandled exc)
        return True

    @property
    def last_error(self) -> Optional[BaseException]:
        return self._last_error

    def publish_now(self):
        """Republish current values out of band (checkpoint restore) —
        fetch takes the latest publish (pure overwrite), so this replaces
        any pre-restore blob without disturbing the applied count."""
        self._publish(self._applied)

    def pause(self, timeout: float = 30.0):
        """Hold the apply loop and wait out any in-flight apply — state
        swaps (checkpoint restore) must not interleave with an apply.
        Queued blobs stay queued and apply after resume()."""
        self._pause.set()
        deadline = time.monotonic() + timeout
        while self._busy:
            if time.monotonic() > deadline:
                raise TimeoutError("async PS apply did not quiesce")
            time.sleep(self._poll_s)

    def resume(self):
        self._pause.clear()

    def drain(self, timeout: float = 30.0) -> int:
        """Block until the queue is empty and applied (tests/checkpoints)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._service.pending_grads() == 0 and not self._busy:
                return self._applied
            time.sleep(self._poll_s)
        raise TimeoutError("async PS queue did not drain")

    def stop(self) -> bool:
        """Stop the apply loop; True when the thread actually exited."""
        self._stop.set()
        self._thread.join(timeout=5)
        return not self._thread.is_alive()
