"""The serving plane of an engine at N > 1 ranks: one controller, N
executors.

The JAX package serves from one controller driving every device
(``autodist_tpu/kernel/graph_transformer.py``'s sharded forward and
decode programs). The port runs one process a replica, so an engine at
N > 1 is one controller — the chief, rank 0 — and N - 1 followers. The
invariant the plane keeps: **every rank issues the same collectives in
the same order, and the chief alone decides them.** The chief owns the
request queue, the micro-batcher's grouping, the slot scheduler and the
host-PS snapshot-refresh decision; before each dispatch it broadcasts a
header (the op and its host payload: the padded bucket, the admitted
prompts and their slots, the per-slot arrays of a decode step, the
refresh flag, or stop). Each follower runs a loop, on a thread of its
own, that executes the headers it receives on its own shard. A follower
never reads a clock or a request queue.

Each plane has a gloo process group of every rank, made with
``new_group`` when its engine is built (every rank builds its engines in
the same order), so serving's collectives never interleave with a
training step's or the elastic plane's on the default group. Under a
plan's mesh (``parallel/mesh.py``) the plane also holds a copy of that
mesh with gloo groups of its own (each axis's lines and the batch axes'
blocks; an axis or a set over every rank takes the plane's group): the
programs bind its axes while they run and gather their rows over its
batch axes, so a model, pipe, seq or expert axis's collectives stay off
the training step's groups too. The status reduction stays on the
plane's group of every rank, so a failure on any rank raises on all. A header is
one broadcast of a fixed :data:`HEADER_BYTES` buffer (the length and the
pickled message), and a second broadcast when the message is longer.
"""
import pickle
import threading
import weakref
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.utils import logging

HEADER_BYTES = 8192
_LEN = 8  # the message length's bytes at the head of the buffer

# every live plane, so a departing chief can stop its followers' loops
# (``runtime/preemption.drain_serving``)
_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()


def active_planes() -> list:
    return list(_ACTIVE)


class ServingPlane:
    """The header channel and the follower loop of one engine at N > 1.

    The chief calls :meth:`dispatch` (the header, then the work every rank
    does for it, under the plane's lock, so that two threads of the chief
    cannot interleave headers and collectives); a follower's loop thread
    (:meth:`start_follower`) calls the handler registered for each op
    (:meth:`on`) until the chief's :meth:`stop`."""

    def __init__(self, rank: int, world: int, name: str, mesh=None,
                 batch_axes=()):
        self.rank, self.world, self.name = int(rank), int(world), name
        self.chief = self.rank == 0
        self.group = dist.new_group(backend="gloo")
        # the plan's mesh, with the plane's own groups (None without one)
        self.mesh = None
        if mesh is not None:
            from autodist_tpu_torch.parallel.mesh import ProcessMesh
            self.mesh = ProcessMesh(mesh.axes, self.rank)
            self.mesh.build_groups(joint=[batch_axes], backend="gloo",
                                   full_group=self.group)
        self.lock = threading.RLock()
        self.stopped = False
        self.error: Optional[BaseException] = None
        self._handlers = {}
        self._thread: Optional[threading.Thread] = None
        _ACTIVE.add(self)

    def on(self, op: str, handler: Callable) -> None:
        self._handlers[op] = handler

    # ------------------------------------------------------------ chief

    def _send(self, op: str, payload) -> None:
        data = pickle.dumps((op, payload), protocol=pickle.HIGHEST_PROTOCOL)
        head = np.zeros(HEADER_BYTES, np.uint8)
        head[:_LEN] = np.frombuffer(np.int64(len(data)).tobytes(), np.uint8)
        inline = len(data) <= HEADER_BYTES - _LEN
        if inline:
            head[_LEN:_LEN + len(data)] = np.frombuffer(data, np.uint8)
        dist.broadcast(torch.from_numpy(head), src=0, group=self.group)
        if not inline:
            body = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
            dist.broadcast(body, src=0, group=self.group)

    def dispatch(self, op: str, payload, work: Callable):
        """Chief: broadcast ``(op, payload)`` and run ``work(payload)``,
        the part every rank runs (each follower runs its handler for
        ``op`` on the same payload)."""
        with self.lock:
            if self.stopped:
                from autodist_tpu_torch.serving.engine import \
                    ServingUnavailable
                raise ServingUnavailable(
                    "serving plane %s is stopped: its followers left the "
                    "loop" % self.name)
            self._send(op, payload)
            return work(payload)

    # --------------------------------------------------------- follower

    def _recv(self):
        head = torch.zeros(HEADER_BYTES, dtype=torch.uint8)
        dist.broadcast(head, src=0, group=self.group)
        raw = head.numpy()
        n = int(np.frombuffer(raw[:_LEN].tobytes(), np.int64)[0])
        if n <= HEADER_BYTES - _LEN:
            data = raw[_LEN:_LEN + n].tobytes()
        else:
            body = torch.zeros(n, dtype=torch.uint8)
            dist.broadcast(body, src=0, group=self.group)
            data = body.numpy().tobytes()
        return pickle.loads(data)

    def _loop(self):
        try:
            while True:
                op, payload = self._recv()
                if op == "stop":
                    break
                try:
                    self._handlers[op](payload)
                except Exception as e:  # noqa: BLE001 — every rank agreed
                    # the failure in the dispatch's status reduction, so
                    # the chief has it too; the loop serves on
                    logging.warning("serving plane %s: %s on rank %d "
                                    "failed: %s", self.name, op, self.rank,
                                    e)
        except Exception as e:  # noqa: BLE001 — the group broke (the
            # chief died): the loop ends, follow() re-raises it
            self.error = e
            logging.warning("serving plane %s: follower loop ended: %s",
                            self.name, e)
        finally:
            self.stopped = True

    def start_follower(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="adt-serve-follow-%s" % self.name,
            daemon=True)
        self._thread.start()

    def follow(self, timeout: Optional[float] = None) -> bool:
        """Follower: wait until the chief stops this plane's loop (True)
        or ``timeout`` passes (False); re-raises the error that ended the
        loop, if one did."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
        if self.error is not None:
            raise self.error
        return True

    # ------------------------------------------------------------- stop

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Chief: send the stop header (idempotent), which ends every
        follower's loop. Follower: wait up to ``timeout`` for the chief's
        stop."""
        if not self.chief:
            try:
                self.follow(timeout)
            except Exception as e:  # noqa: BLE001 — the loop already
                # ended; a follower's stop only waits
                logging.warning("serving plane %s: %s", self.name, e)
            return
        with self.lock:
            if self.stopped:
                return
            self.stopped = True
            self._send("stop", None)
