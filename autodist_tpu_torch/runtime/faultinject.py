"""Deterministic fault injection for the coordination wire, the
checkpoint plane and the gradients.

PyTorch counterpart of ``autodist_tpu/runtime/faultinject.py`` (its wire
and checkpoint parts import nothing of JAX; the port keeps its own copy
of them, and writes the gradient faults over torch tensors).

:class:`FaultyProxy` is a TCP proxy between coordination clients and the
real ``coordination_service`` process that executes a seeded,
declarative fault plan (``ADT_FAULT_PLAN``, inline JSON, ``@path`` or a
path; or passed directly)::

    {"seed": 1234,
     "faults": [{"op": "delay",     "match": "QPUSHB", "nth": 2,
                 "delay_s": 0.5},
                {"op": "reset",     "match": "*", "nth": 5, "repeat": true},
                {"op": "truncate",  "match": "BGETB", "nth": 1, "bytes": 64},
                {"op": "partition", "match": "INC", "nth": 1,
                 "duration_s": 0.8},
                {"op": "restart",   "at_step": 3},
                {"op": "preempt",   "match": "STEP", "nth": 20,
                 "deadline_s": 5}]}

``delay`` holds the matched request; ``reset`` hard-closes the client
connection (before forwarding, or with ``"when": "after"`` after it — the
ambiguous drop); ``truncate`` relays at most ``bytes`` of the reply;
``partition`` holds every proxied request, on every connection, for
``duration_s`` and then delivers it late (the zombie-revival timing the
elastic epoch fence must beat); ``restart`` calls the proxy's
``restart_fn`` when a ``STEP`` with step >= ``at_step`` passes. ``match``
prefix-matches the command word (``"*"`` any but PING), ``nth`` fires on
the n-th match, ``repeat`` every n-th, ``prob`` with the plan's seeded
probability. ``preempt`` is the advance-notice eviction of a supervised
process: a real SIGTERM to the rule's ``pid`` (or the proxy's
``preempt_pid``) when it fires, then a real SIGKILL ``deadline_s`` later
(:func:`deliver_preemption`, also callable on its own) — the spot or
maintenance timing the preemption plane (``runtime/preemption.py``) must
beat.
"""
import json
import os
import random
import signal
import socket
import struct
import threading
import time
from typing import Callable, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

# commands whose header declares a raw payload length in this 0-based arg
_BINARY_LEN_ARG = {"BPUTB": 3, "QPUSHB": 2}


class FaultRule:
    """One declarative fault. See the module docstring for fields."""

    def __init__(self, spec: dict):
        self.op = spec["op"]
        if self.op not in ("delay", "reset", "truncate", "restart",
                           "partition", "preempt"):
            raise ValueError("unknown fault op %r" % self.op)
        self.match = spec.get("match", "*")
        self.nth = int(spec.get("nth", 1))
        self.repeat = bool(spec.get("repeat", False))
        self.prob = spec.get("prob")
        self.delay_s = float(spec.get("delay_s", 0.0))
        # partition: how long the proxy blackholes ALL traffic once this
        # rule fires (the zombie-revival harness — see FaultyProxy)
        self.duration_s = float(spec.get("duration_s", 0.0))
        self.bytes = int(spec.get("bytes", 0))
        self.when = spec.get("when", "before")
        self.at_step = spec.get("at_step")
        # preempt: a real SIGTERM to the target when the rule fires, then a
        # real SIGKILL deadline_s later (deliver_preemption); pid defaults
        # to the proxy's preempt_pid
        self.deadline_s = spec.get("deadline_s")
        self.pid = spec.get("pid")
        self._matched = 0
        self._spent = False

    def _matches_cmd(self, cmd: str) -> bool:
        if cmd == "PING":
            return False
        return self.match == "*" or cmd.startswith(self.match)

    def should_fire(self, cmd: str, step_arg: Optional[int],
                    rng) -> bool:
        """Called under the plan lock, once per parsed RPC."""
        if self._spent:
            return False
        if self.op == "restart":
            if self.at_step is None or cmd != "STEP" or step_arg is None:
                return False
            if step_arg >= int(self.at_step):
                self._spent = True  # one restart per rule
                return True
            return False
        if not self._matches_cmd(cmd):
            return False
        if self.prob is not None:
            return rng.random() < float(self.prob)
        self._matched += 1
        if self._matched >= self.nth:
            if self.repeat:
                self._matched = 0
            else:
                self._spent = True
            return True
        return False


class FaultPlan:
    """The parsed ``ADT_FAULT_PLAN``: rules + the seeded RNG + counters."""

    def __init__(self, spec: Optional[dict] = None):
        spec = spec or {}
        self.seed = int(spec.get("seed", 0))
        self.rules: List[FaultRule] = [FaultRule(r)
                                       for r in spec.get("faults", ())]
        self.rng = random.Random(self.seed)
        self.lock = threading.Lock()
        self.injected: List[str] = []  # audit log: what fired, in order
        # network-partition window (monotonic deadline): while set, every
        # proxied RPC — on every connection — is HELD until the window
        # heals, then delivered late. This is the zombie-revival fault:
        # the partitioned worker is alive but silent (declared dead,
        # fenced out of the next epoch), and its delayed writes arrive
        # only after its replacement took over — exactly what the
        # epoch fence must reject.
        self.partition_until = 0.0

    @classmethod
    def from_env(cls) -> "FaultPlan":
        raw = const.ENV.ADT_FAULT_PLAN.val
        if not raw:
            return cls()
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        elif os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        return cls(json.loads(raw))

    def decide(self, cmd: str, step_arg: Optional[int]) -> List[FaultRule]:
        """All rules that fire for this RPC (deterministic order)."""
        with self.lock:
            fired = [r for r in self.rules
                     if r.should_fire(cmd, step_arg, self.rng)]
            for r in fired:
                self.injected.append("%s:%s" % (r.op, cmd))
            return fired


class _ConnState:
    """Client->upstream stream parser state for one proxied connection."""

    def __init__(self):
        self.buf = b""
        self.bin_need = 0      # payload bytes still owed to the last header
        self.pending = b""     # complete RPC bytes awaiting forwarding


class FaultyProxy:
    """TCP proxy executing a :class:`FaultPlan` on the real wire path.

    ``restart_fn`` (optional) is invoked for ``restart`` faults — it must
    bounce the REAL service (e.g. ``server.stop(); server.start()``); the
    proxy keeps its own listening port, so clients reconnect through the
    same address and find the fresh service."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 listen_port: int = 0, plan: Optional[FaultPlan] = None,
                 restart_fn: Optional[Callable[[], None]] = None,
                 preempt_pid: Optional[int] = None):
        self._upstream = (upstream_host, upstream_port)
        self._plan = plan if plan is not None else FaultPlan.from_env()
        self._restart_fn = restart_fn
        # the target of "preempt" rules without a pid of their own (the
        # training process a chaos harness supervises)
        self.preempt_pid = preempt_pid
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind(("127.0.0.1", listen_port))
        self._listen.listen(128)
        self.port = self._listen.getsockname()[1]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns_lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="adt-faultproxy", daemon=True)

    @property
    def plan(self) -> FaultPlan:
        return self._plan

    def start(self) -> "FaultyProxy":
        self._accept_thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._listen.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ internals

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                client, _ = self._listen.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(target=self._serve, args=(client,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _track(self, sock: socket.socket):
        with self._conns_lock:
            self._conns.append(sock)

    @staticmethod
    def _hard_reset(sock: socket.socket):
        """Close with SO_LINGER 0: the peer sees a TCP RST (ECONNRESET),
        the rudest real-world failure mode — not a clean FIN."""
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _serve(self, client: socket.socket):
        self._track(client)
        try:
            upstream = socket.create_connection(self._upstream, timeout=5)
        except OSError:
            self._hard_reset(client)
            return
        self._track(upstream)
        # reply pump: upstream -> client, with optional truncation budget.
        # budget[0] is None (no cap) or bytes still allowed through.
        budget = [None]
        budget_lock = threading.Lock()
        done = threading.Event()

        def pump_replies():
            try:
                while True:
                    data = upstream.recv(262144)
                    if not data:
                        break
                    with budget_lock:
                        cap = budget[0]
                        if cap is not None:
                            data = data[:cap]
                            budget[0] = cap - len(data)
                    if data:
                        client.sendall(data)
                    with budget_lock:
                        if budget[0] is not None and budget[0] <= 0:
                            break  # truncation: cut the reply mid-payload
            except OSError:
                pass
            finally:
                done.set()
                with budget_lock:
                    faulted = budget[0] is not None
                if faulted:
                    # a truncate/reset fault engaged: the cut must look
                    # like the violent failure it models (TCP RST)
                    self._hard_reset(client)
                else:
                    # fault-free upstream close (e.g. SHUTDOWN): relay a
                    # clean FIN — the proxy must never inject resets the
                    # plan did not declare
                    try:
                        client.close()
                    except OSError:
                        pass
                try:
                    upstream.close()
                except OSError:
                    pass

        rt = threading.Thread(target=pump_replies, daemon=True)
        rt.start()
        state = _ConnState()
        try:
            while not done.is_set():
                data = client.recv(262144)
                if not data:
                    break
                state.buf += data
                if not self._drain_rpcs(state, client, upstream,
                                        budget, budget_lock):
                    return  # connection was reset by a fault
        except OSError:
            pass
        finally:
            try:
                upstream.shutdown(socket.SHUT_WR)  # EOF propagates upstream
            except OSError:
                pass
            done.wait(timeout=5)
            try:
                client.close()
            except OSError:
                pass

    def _drain_rpcs(self, state: _ConnState, client, upstream,
                    budget, budget_lock) -> bool:
        """Carve complete RPCs out of ``state.buf``, applying faults at
        each boundary. Returns False when a fault reset the connection."""
        while True:
            if state.bin_need > 0:
                take = min(state.bin_need, len(state.buf))
                state.pending += state.buf[:take]
                state.buf = state.buf[take:]
                state.bin_need -= take
                if state.bin_need > 0:
                    return True  # payload incomplete: wait for more bytes
                if not self._dispatch(state, client, upstream,
                                      budget, budget_lock):
                    return False
                continue
            pos = state.buf.find(b"\n")
            if pos < 0:
                return True
            header = state.buf[:pos + 1]
            state.buf = state.buf[pos + 1:]
            parts = header.decode("latin-1").split()
            state.pending += header
            need_arg = _BINARY_LEN_ARG.get(parts[0] if parts else "")
            if need_arg is not None and len(parts) > need_arg:
                try:
                    state.bin_need = max(0, int(parts[need_arg]))
                except ValueError:
                    state.bin_need = 0  # server will reject; just forward
                if state.bin_need > 0:
                    continue  # accumulate the payload first
            if not self._dispatch(state, client, upstream,
                                  budget, budget_lock):
                return False

    def _dispatch(self, state: _ConnState, client, upstream,
                  budget, budget_lock) -> bool:
        """One complete RPC is in ``state.pending``: decide faults, then
        forward (or not). Returns False when the connection was reset."""
        rpc, state.pending = state.pending, b""
        parts = rpc.split(b"\n", 1)[0].decode("latin-1").split()
        cmd = parts[0] if parts else ""
        step_arg = None
        if cmd == "STEP" and len(parts) >= 3:
            try:
                step_arg = int(parts[2])
            except ValueError:
                pass
        fired = self._plan.decide(cmd, step_arg)
        reset_after = False
        for rule in fired:
            if rule.op == "delay":
                logging.info("faultinject: delaying %s by %.3fs",
                             cmd, rule.delay_s)
                time.sleep(rule.delay_s)
            elif rule.op == "reset" and rule.when == "before":
                # drop the request entirely: it never reached the service
                logging.info("faultinject: reset (before) on %s", cmd)
                self._hard_reset(client)
                self._hard_reset(upstream)
                return False
            elif rule.op == "reset":
                # cut the reply path BEFORE forwarding: the request must
                # reach the service, the reply must never reach the client
                # — the ambiguous drop, with no race against the pump
                with budget_lock:
                    budget[0] = 0
                reset_after = True
            elif rule.op == "truncate":
                with budget_lock:
                    budget[0] = rule.bytes
                logging.info("faultinject: truncating reply of %s to %d "
                             "bytes", cmd, rule.bytes)
            elif rule.op == "partition":
                with self._plan.lock:
                    self._plan.partition_until = (time.monotonic()
                                                  + rule.duration_s)
                logging.warning("faultinject: PARTITION for %.1fs starting "
                                "at %s", rule.duration_s, cmd)
            elif rule.op == "preempt":
                pid = rule.pid if rule.pid is not None else self.preempt_pid
                if pid is None:
                    logging.error(
                        "faultinject: preempt rule fired at %s but no "
                        "target pid is configured (rule 'pid' or "
                        "FaultyProxy(preempt_pid=)) — skipping", cmd)
                else:
                    deliver_preemption(int(pid), rule.deadline_s,
                                       reason="faultinject@%s" % cmd)
            elif rule.op == "restart" and self._restart_fn is not None:
                logging.warning("faultinject: restarting service at %s %s",
                                cmd, step_arg)
                self._restart_fn()
        with self._plan.lock:
            hold = self._plan.partition_until - time.monotonic()
        if hold > 0:
            # the partition window: hold (don't drop) — delivery resumes
            # the instant the partition heals, i.e. the zombie's writes
            # arrive LATE rather than never
            logging.info("faultinject: holding %s for %.1fs (partition)",
                         cmd, hold)
            time.sleep(hold)
        try:
            upstream.sendall(rpc)
        except OSError:
            self._hard_reset(client)
            return False
        if reset_after:
            # the AMBIGUOUS drop: request forwarded (the graceful upstream
            # close in _serve's finally lets the service read and apply
            # it), but the client connection dies reply-less
            logging.info("faultinject: reset (after) on %s", cmd)
            self._hard_reset(client)
            return False
        return True


# ====================================================== preemption delivery
#
# A planned eviction is a real SIGTERM followed, one grace window later, by
# a real SIGKILL — what a spot VM or a maintenance event delivers. It is a
# wire-plan op (``{"op": "preempt", "match": "STEP", "nth": 20,
# "deadline_s": 5}`` on a FaultyProxy that supervises a training process)
# and, directly, :func:`deliver_preemption` for harnesses that schedule the
# eviction on wall time. The target's preemption plane must rescue and hand
# off inside the window; the SIGKILL is unconditional.


def deliver_preemption(pid: int, deadline_s: Optional[float] = None,
                       reason: str = "faultinject") -> threading.Thread:
    """SIGTERM ``pid`` now; SIGKILL it ``deadline_s`` seconds later if it
    is still alive (a process that departed gracefully — exit 0 inside the
    window — is never touched). Returns the (daemon) killer thread, so a
    harness can join it."""
    if deadline_s is None:
        deadline_s = const.ENV.ADT_PREEMPT_DEADLINE_S.val
    deadline_s = float(deadline_s)
    logging.warning("faultinject: PREEMPT pid %d — SIGTERM now, SIGKILL "
                    "in %.1fs (%s)", pid, deadline_s, reason)
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        logging.warning("faultinject: preempt target pid %d already gone",
                        pid)

    def kill_at_deadline():
        time.sleep(deadline_s)
        try:
            os.kill(pid, signal.SIGKILL)
            logging.warning("faultinject: preempt deadline hit — SIGKILLed "
                            "pid %d", pid)
        except ProcessLookupError:
            pass  # departed inside the window: the graceful path won

    t = threading.Thread(target=kill_at_deadline,
                         name="adt-preempt-killer", daemon=True)
    t.start()
    return t


# ===================================================== checkpoint lifecycle
#
# Deterministic SIGKILLs at save-lifecycle phase points and post-commit
# file damage (truncation / bit flips), driven by a declarative plan
# through ``ADT_CKPT_FAULT_PLAN`` (the JAX package's grammar)::
#
#     {
#       "kills":  [{"phase": "meta", "nth": 3}],
#       "damage": [{"op": "bitflip",  "phase": "committed",
#                   "file": "shard-p0.npz", "nth": 1, "offset": -4096},
#                  {"op": "truncate", "phase": "committed",
#                   "file": "params.npz",  "nth": 1, "bytes": 64}]
#     }
#
# Phase points the savers call ``checkpoint_fault(phase, ...)`` at:
#
# - ``collect``   — state gathered to host, nothing on disk yet
# - ``write``     — data fully written to ``.tmp`` files, none replaced
# - ``index``     — shard npz replaced into place, index not yet written
#   (the sharded savers only)
# - ``meta``      — all data + index files final, meta (the commit point)
#   not yet written
# - ``committed`` — meta replaced: the checkpoint is durable
#
# A ``kill`` rule delivers a real ``SIGKILL`` to this process at its
# phase's nth firing — no atexit, no flushing, the crash the atomic-write
# protocol must survive. A ``damage`` rule mutates the bytes of a matching
# file at its phase — ``committed`` models post-commit bit rot a restore
# must detect and fall back from; earlier phases model a filesystem that
# tore a write the checksums must catch.
#
# Matching is deterministic (as the JAX wire rules are): per-rule nth
# counters under one lock, no randomness unless ``prob`` is given — a
# probabilistic rule rolls against the plan-level rng (``"seed"`` key,
# default 0) once armed, and stays armed on a failed roll.


def truncate_file(path: str, keep_bytes: int):
    """Truncate ``path`` to its first ``keep_bytes`` bytes — the classic
    torn write (also usable directly from tests)."""
    with open(path, "r+b") as f:
        f.truncate(max(0, int(keep_bytes)))


def flip_bit(path: str, offset: int = -1):
    """XOR one bit at byte ``offset`` (negative = from the end; default
    flips a bit near the middle of the file) — silent single-bit rot."""
    size = os.path.getsize(path)
    if size == 0:
        return
    if offset == -1:
        offset = size // 2
    if offset < 0:
        offset = max(0, size + offset)
    offset = min(offset, size - 1)
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x01]))


def _kill_self():  # separated so tests can intercept the kill
    os.kill(os.getpid(), signal.SIGKILL)


class CkptFaultRule:
    """One checkpoint-lifecycle fault (kill or damage)."""

    def __init__(self, spec: dict, op: Optional[str] = None):
        self.op = op or spec.get("op")
        if self.op not in ("kill", "truncate", "bitflip"):
            raise ValueError("unknown checkpoint fault op %r" % self.op)
        self.phase = spec.get("phase", "committed" if self.op != "kill"
                              else "write")
        self.file = spec.get("file", "")
        self.nth = int(spec.get("nth", 1))
        self.repeat = bool(spec.get("repeat", False))
        self.bytes = int(spec.get("bytes", 0))
        self.offset = int(spec.get("offset", -1))
        self.prob = float(spec.get("prob", 1.0))
        self._matched = 0
        self._spent = False

    def should_fire(self, phase: str, rng: random.Random) -> bool:
        if self._spent or phase != self.phase:
            return False
        self._matched += 1
        if self._matched < self.nth:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            # stayed armed at the threshold: the next matching phase
            # point re-rolls (seeded rng — deterministic per plan)
            self._matched -= 1
            return False
        if self.repeat:
            self._matched = 0
        else:
            self._spent = True
        return True


class CheckpointFaultPlan:
    """Parsed ``ADT_CKPT_FAULT_PLAN`` — see the section comment above."""

    def __init__(self, spec: Optional[dict] = None):
        spec = spec or {}
        self.rules: List[CkptFaultRule] = (
            [CkptFaultRule(r, op="kill") for r in spec.get("kills", ())] +
            [CkptFaultRule(r) for r in spec.get("damage", ())])
        self.rng = random.Random(int(spec.get("seed", 0)))
        self.lock = threading.Lock()
        self.injected: List[str] = []

    @classmethod
    def from_env(cls) -> "CheckpointFaultPlan":
        raw = const.ENV.ADT_CKPT_FAULT_PLAN.val
        if not raw:
            return cls()
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        elif os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        return cls(json.loads(raw))

    def _targets(self, rule: CkptFaultRule, path: Optional[str]) -> List[str]:
        """Files a damage rule applies to at this phase point. ``path`` is
        either one concrete file or a checkpoint base (``.../ckpt-N``)
        whose sibling files are matched by the rule's ``file`` substring."""
        if path is None:
            return []
        if os.path.isfile(path):
            return [path] if rule.file in os.path.basename(path) else []
        directory, base = os.path.dirname(path), os.path.basename(path)
        try:
            names = os.listdir(directory)
        except OSError:
            return []
        return [os.path.join(directory, f) for f in sorted(names)
                if f.startswith(base + ".") and rule.file and rule.file in f]

    def fire(self, phase: str, path: Optional[str] = None,
             step: Optional[int] = None):
        with self.lock:
            fired = [r for r in self.rules if r.should_fire(phase, self.rng)]
        for rule in fired:
            if rule.op == "kill":
                logging.warning(
                    "faultinject: SIGKILL at checkpoint phase %r (step %s)",
                    phase, step)
                for h in logging.get_logger().handlers:
                    h.flush()  # SIGKILL gives no atexit: flush by hand
                self.injected.append("kill:%s" % phase)
                _kill_self()
                continue  # only reached when _kill_self is intercepted
            for target in self._targets(rule, path):
                logging.warning("faultinject: %s on %s at phase %r",
                                rule.op, target, phase)
                if rule.op == "truncate":
                    truncate_file(target, rule.bytes)
                else:
                    flip_bit(target, rule.offset)
                self.injected.append("%s:%s" % (rule.op,
                                                os.path.basename(target)))


_ckpt_plan_lock = threading.Lock()
_ckpt_plan: Optional[CheckpointFaultPlan] = None
_ckpt_plan_raw: Optional[str] = None


def checkpoint_fault(phase: str, path: Optional[str] = None,
                     step: Optional[int] = None):
    """Phase hook the checkpoint savers call at every lifecycle point.
    A no-op (one env read) unless ``ADT_CKPT_FAULT_PLAN`` is set; the
    plan is parsed once and re-parsed only when the env value changes
    (tests swap plans in-process)."""
    global _ckpt_plan, _ckpt_plan_raw
    raw = const.ENV.ADT_CKPT_FAULT_PLAN.val
    if not raw:
        return
    with _ckpt_plan_lock:
        if raw != _ckpt_plan_raw:
            _ckpt_plan = CheckpointFaultPlan.from_env()
            _ckpt_plan_raw = raw
        plan = _ckpt_plan
    plan.fire(phase, path=path, step=step)


# ======================================================== gradient faults
#
# Silent-data-corruption chaos for the training health sentinel
# (``runtime/sentinel.py``): deterministic, step-keyed corruption of a
# named variable's LOCAL gradient, applied inside the step before the
# gradient sync, so NaN spreads through the all-reduce exactly as a real
# on-device fault would. The plan comes from ``ADT_GRAD_FAULT_PLAN``
# (inline JSON, ``@/path``, or a path)::
#
#     {"faults": [
#         {"var": "dense/kernel", "mode": "nan",     "step": 3},
#         {"var": "dense/bias",   "mode": "inf",     "step": 5,
#          "until": 40, "every": 2},
#         {"var": "embed",        "mode": "bitflip", "step": 7,
#          "bit": 30, "index": 0},
#         {"var": "dense/kernel", "mode": "scale",   "step": 9,
#          "factor": 1e6}
#     ]}
#
# The injection reads the step from a tensor on the device (the step
# keeps it, ``DistributedStep._step_t``), so it is the same at every
# step, inside a captured superstep (a CUDA graph) and on replay after a
# rollback, with no read back to the host.
#
# Rule fields: ``var`` (exact variable name, required), ``mode`` in
# ``nan | inf | bitflip | scale``, ``step`` (0-based TrainState step the
# fault arms at), ``until`` (inclusive last step; default = ``step``, so
# a bare rule is a one-step transient), ``every`` (within [step, until]
# fire only when (step - rule.step) % every == 0), ``factor`` (scale
# mode, default 1e6), ``bit``/``index`` (bitflip mode: XOR bit ``bit`` of
# the flat element at ``index``; bit 30 flips a float32 exponent MSB —
# the classic silent-data-corruption blowup).


class GradFaultRule:
    """One declarative gradient fault (see the section comment above).

    Unknown fields are REJECTED, not ignored: the wire/ckpt grammars'
    ``nth``/``repeat``/``prob`` knobs do not exist here (injection is
    keyed on the step counter, with no runtime roll), and a silently
    dropped field would make the chaos run test something other than
    what the plan declares."""

    _MODES = ("nan", "inf", "bitflip", "scale")
    _FIELDS = frozenset(("var", "mode", "step", "until", "every",
                         "factor", "bit", "index"))

    def __init__(self, spec: dict):
        unknown = sorted(set(spec) - self._FIELDS)
        if unknown:
            raise ValueError(
                "unknown gradient fault field(s) %s — the grad plan is "
                "step-keyed (fields: %s); nth/repeat/prob belong to the "
                "wire/checkpoint plans (docs/failure_model.md)"
                % (unknown, ", ".join(sorted(self._FIELDS))))
        self.var = spec["var"]
        self.mode = spec.get("mode", "nan")
        if self.mode not in self._MODES:
            raise ValueError("unknown gradient fault mode %r (one of %s)"
                             % (self.mode, ", ".join(self._MODES)))
        self.step = int(spec.get("step", 0))
        self.until = int(spec.get("until", self.step))
        if self.until < self.step:
            raise ValueError("gradient fault until=%d precedes step=%d"
                             % (self.until, self.step))
        self.every = max(1, int(spec.get("every", 1)))
        self.factor = float(spec.get("factor", 1e6))
        self.bit = int(spec.get("bit", 30))
        self.index = int(spec.get("index", 0))

    def describe(self) -> str:
        window = ("step %d" % self.step if self.until == self.step
                  else "steps %d..%d/%d" % (self.step, self.until,
                                            self.every))
        return "%s(%s @ %s)" % (self.mode, self.var, window)


class GradFaultPlan:
    """Parsed ``ADT_GRAD_FAULT_PLAN``, read by ``GraphTransformer`` when
    it builds the step. A top-level ``seed`` is tolerated for symmetry
    with the other grammars but means nothing: the injection is fully
    deterministic (step-keyed, no rng)."""

    def __init__(self, spec: Optional[dict] = None):
        spec = spec or {}
        self.rules: List[GradFaultRule] = [GradFaultRule(r)
                                           for r in spec.get("faults", ())]

    @classmethod
    def from_env(cls) -> "GradFaultPlan":
        raw = const.ENV.ADT_GRAD_FAULT_PLAN.val
        if not raw:
            return cls()
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        elif os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        return cls(json.loads(raw))

    def describe(self) -> str:
        return ", ".join(r.describe() for r in self.rules)


def _uint_like(dtype):
    """The integer dtype of ``dtype``'s width, for a bitcast (bitflip
    mode). torch's unsigned 16/32/64-bit types lack ``^``, so the signed
    type of the same width carries the bits: the XOR is the same."""
    import torch
    return {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        torch.empty((), dtype=dtype).element_size()]


def apply_grad_faults(plan: GradFaultPlan, step, grads: dict) -> dict:
    """The plan applied to a name->gradient dict, ``step`` being the
    TrainState step as a 0-d integer tensor on the gradients' device:
    every matching rule contributes a data-dependent select, so the step
    injects at exactly the planned steps with no read back to the host
    (a CUDA graph can hold it). Rules naming absent variables are
    skipped (the transformer warns about them once when it builds)."""
    import torch
    out = dict(grads)
    for rule in plan.rules:
        g = out.get(rule.var)
        if g is None or not g.is_floating_point():
            continue
        hit = (step >= rule.step) & (step <= rule.until)
        if rule.every > 1:
            hit = hit & ((step - rule.step) % rule.every == 0)
        if rule.mode in ("nan", "inf"):
            bad = float("nan") if rule.mode == "nan" else float("inf")
            out[rule.var] = g + torch.where(hit, g.new_full((), bad),
                                            g.new_zeros(()))
        elif rule.mode == "scale":
            out[rule.var] = g * torch.where(hit, g.new_full((), rule.factor),
                                            g.new_ones(()))
        else:  # bitflip: XOR one bit of one element — silent corruption
            flat = g.reshape(-1).clone()
            idx = rule.index % int(flat.shape[0])
            idt = _uint_like(g.dtype)
            width = 8 * torch.empty((), dtype=idt).element_size()
            bit = rule.bit % width
            mask = (1 << bit) if bit < width - 1 else -(1 << bit)
            elem = flat[idx:idx + 1]
            flipped = (elem.view(idt) ^ mask).view(g.dtype)
            flat[idx:idx + 1] = torch.where(hit, flipped, elem)
            out[rule.var] = flat.reshape(g.shape)
    return out
