"""Coordinator — the chief launches worker clients and supervises them.

PyTorch counterpart of ``autodist_tpu/runtime/coordinator.py`` (reference
``autodist/coordinator.py:46-110``): on the chief, launch *the same user
script* for every process of the layout but the chief's own, with
``ADT_WORKER=<node>``/``ADT_STRATEGY_ID=<id>`` and the process's place in
the layout; ship the serialized strategy to every worker node; and watch
each launched process. The relaunched command is ``<this interpreter> -u
<script> <argv>``: the interpreter that runs the chief
(``sys.executable``), where the JAX package runs ``python``, which a
machine with only ``python3`` lacks.

Supervision (ROADMAP A item 8.3a). Without ``ADT_ELASTIC`` a worker death
fail-fasts the whole job (exit code 1) — the reference's semantics
(``coordinator.py:98-110``). With a budget ``ADT_ELASTIC=<n>``:

- the heartbeat watchdog (:meth:`Coordinator.start_watchdog`) reads the
  coordination service's dead workers; a silent worker whose process is
  alive is killed so the process watcher recovers it, one with no budget
  left aborts the job;
- async PS (every variable on async host PS, owned by a surviving node):
  the process watcher relaunches the dead worker, up to ``n`` times
  (:meth:`Coordinator._try_restart`); its first pull reads the owners'
  current values;
- sync jobs (``ADT_ELASTIC_SYNC=1``): the chief reaps every worker, stops
  the service and re-execs its own script with ``ADT_AUTO_RESUME=1``, and
  every process restores the newest checkpoint (``Runner.init``); a node
  whose worker dies twice with no checkpoint progress in between is
  excluded and the job resumes without it
  (:meth:`Coordinator._restart_whole_job`).

- in-run shrink and grow (``ADT_ELASTIC_INRUN=1`` with
  ``ADT_ELASTIC_SYNC=1``, ROADMAP A item 8.3b): a sync worker's death
  publishes the survivors' roster at the next cluster epoch
  (:meth:`Coordinator._shrink_to_survivors`); the survivors re-form their
  process group in-run (``runtime/elastic.py``) and the dead worker is
  relaunched, announces itself, and is admitted at the epoch after
  (:meth:`Coordinator._maybe_admit_joiners`, from the watchdog). A
  topology that cannot shrink (ADT430/431, ``analysis/rules.py``), or
  survivors that never ack the epoch within ``ADT_ELASTIC_ACK_TIMEOUT_S``
  (:meth:`Coordinator._watch_acks`), take the whole-job restart instead.

A recovery path that fails is logged and degrades to the fail-fast.

Where the JAX package keys its bookkeeping by node address, the port keys
it by process id: one process runs a device entry, so two processes can
share an address. The heartbeat name stays the node address (async PS
allows one process a node), and the exclusion unit stays the node.

How a worker's death reaches the chief differs by backend. Under NCCL, as
under ``jax.distributed``, the survivors hang in the collective the dead
worker never re-enters, and only the dead worker's process watcher fires.
Under gloo the survivors' collectives raise within milliseconds of the
peer's sockets closing: every surviving worker exits non-zero too, and the
chief's main thread unwinds. The design covers both: a whole-job restart
is claimed once an incarnation (later deaths read as its teardown); it
blames the worker whose exit came first, after a short settle window; and
the chief's main thread hands a failed collective to
:func:`collective_failed`, which waits for the restart (the exec replaces
the process) before any exit handler could read the death as shutdown.
The restart path touches no card and no process-group call (which may be
hung under NCCL): before the exec it marks every inherited descriptor
close-on-exec, so the rendezvous and gloo sockets made in C++ (not all
close-on-exec) are released and the re-exec'd chief binds its ports
again.

Planned departures (``runtime/preemption.py``): a rostered worker's
advance notice (SIGTERM, maintenance file, operator drain) makes the
watchdog publish the survivors' roster at the next epoch while the leaver
is alive (:meth:`Coordinator._maybe_plan_departures`): no reap, no
relaunch, no restart of the budget. The watchdog never declares an
announced leaver dead (:meth:`Coordinator._is_departing`), nor a worker
that marked itself a slow-but-alive straggler
(:meth:`Coordinator._is_straggling`), and the process watcher reads a
shrunk-for leaver's exit as the end of its departure. A departure the
chief could not shrink for (a fail-fast topology, the chief itself)
recovers by the whole-job restart when the leaver exits, whatever its
code.
"""
import atexit
import os
import shlex
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.runtime.cluster import Cluster
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

# the debugging/testing knobs a worker inherits from the chief when they
# are set there (the JAX package's list, reference coordinator.py:70-79)
_PROPAGATED = (const.ENV.ADT_MIN_LOG_LEVEL, const.ENV.ADT_IS_TESTING,
               const.ENV.ADT_PATCH_OPTAX, const.ENV.ADT_ELASTIC,
               const.ENV.ADT_ELASTIC_SYNC, const.ENV.ADT_AUTO_RESUME,
               const.ENV.ADT_CKPT_DIR, const.ENV.ADT_ELASTIC_EXCLUDE,
               const.ENV.ADT_ELASTIC_INRUN, const.ENV.ADT_ELASTIC_POLL_S,
               const.ENV.ADT_ELASTIC_ACK_TIMEOUT_S,
               const.ENV.ADT_HEARTBEAT_TIMEOUT_S,
               const.ENV.ADT_PREEMPT_DEADLINE_S, const.ENV.ADT_PREEMPT_POLL_S,
               const.ENV.ADT_DRAIN_RETRY_AFTER_S)

# a whole-job restart waits this long after the first death it sees, then
# blames the earliest exit: under gloo the survivors exit within
# milliseconds to a few hundred of the death that took their collective
RESTART_SETTLE_S = 1.0
# how long the restart waits for a checkpoint this process is writing
# (the save the dead worker made just before it died) to commit
SAVE_WAIT_S = 120.0
# how long a collective that failed on the chief waits for a worker's
# death before the error propagates
COLLECTIVE_WAIT_S = 30.0
# how long it then waits for the restart's decision (the exec, or the
# watcher's fail-fast exit)
RESTART_DECISION_S = 120.0


def _ere_escape(text: str) -> str:
    """Escape POSIX extended-regex metacharacters only (re.escape also
    backslashes ordinary characters like spaces, which POSIX ERE leaves
    undefined)."""
    return "".join("\\" + c if c in r".[]^$*+?(){}|\\" else c
                   for c in text)


def _reap_pattern(command: str) -> str:
    """pkill -f pattern matching ``command`` as a cmdline substring but
    NOT matching the pkill wrapper's own command line (first character
    wrapped in a regex bracket class, so the pattern text differs from
    the text it matches)."""
    esc = _ere_escape(command)
    return "[%s]%s" % (command[0], esc[len(_ere_escape(command[0])):])


def _reap_command(command: str, strategy_id: str) -> str:
    """Remote kill of a stale worker incarnation, scoped to THIS job.

    ``pkill -f <full command line>`` alone would match any process with
    the same argv — two concurrent jobs launched from the same script on
    a shared worker host would reap each other's live workers. The job's
    identity lives in the worker's environment (``ADT_STRATEGY_ID``, set
    at launch and inherited by children), not its argv (bash
    exec-optimizes the env-prefixed remote command, so assignments never
    appear in /proc cmdline). So: pgrep candidates by command line, then
    keep only pids whose ``/proc/<pid>/environ`` carries this job's
    strategy id. Wrapped in ``sh -c`` so the cluster's env prefix (a
    simple-command prefix) stays legal in front of the ``for`` loop."""
    script = (
        "for p in $(pgrep -f %s); do "
        "tr '\\0' '\\n' < /proc/$p/environ 2>/dev/null | grep -qxF %s "
        "&& kill -9 $p; done; true"
        % (shlex.quote(_reap_pattern(command)),
           shlex.quote("%s=%s" % (const.ENV.ADT_STRATEGY_ID.name_str,
                                  strategy_id))))
    return "sh -c %s" % shlex.quote(script)


def _close_inherited_on_exec():
    """Mark every descriptor but stdin, stdout and stderr close-on-exec,
    so that an ``execv`` leaves none of them open in the new image. Python
    makes its own non-inheritable; C++ code (gloo's pair sockets, its
    event loop) does not always. Flags only: a thread still using a
    descriptor is not disturbed."""
    for fd in map(int, os.listdir("/proc/self/fd")):
        if fd > 2:
            try:
                os.set_inheritable(fd, False)
            except OSError:
                pass  # the listing's own descriptor, closed since


def whole_job_restart_claimed() -> bool:
    """True when this process's Coordinator (the chief's) has claimed the
    whole-job restart: the exec that replaces the process is coming, so a
    step waiting for an in-run shrink epoch stops waiting."""
    from autodist_tpu_torch.autodist import get_default_autodist
    coord = getattr(get_default_autodist(), "_coordinator", None)
    return coord is not None and coord._restart_claimed


def collective_failed(exc: BaseException):
    """The chief's main thread met a failed collective (``Runner`` hands
    it its error): under sync elastic this waits until the process
    watcher has decided the whole-job restart — the exec replaces this
    process — and returns (the caller re-raises) when no worker death
    comes. A no-op in a process with no Coordinator (every worker)."""
    from autodist_tpu_torch.autodist import get_default_autodist
    coord = getattr(get_default_autodist(), "_coordinator", None)
    if coord is not None:
        coord.await_restart(exc)


class Coordinator:
    def __init__(self, strategy, cluster: Cluster,
                 heartbeat_timeout: Optional[float] = None,
                 max_restarts: Optional[int] = None):
        # a Strategy object, or just its id — the chief-launched flow
        # preallocates the id and launches workers BEFORE the strategy is
        # built (the chief's join blocks until every worker connects)
        self._strategy_id = getattr(strategy, "id", strategy)
        self._cluster = cluster
        self._threads: List[threading.Thread] = []
        self._heartbeat_timeout = (
            const.ENV.ADT_HEARTBEAT_TIMEOUT_S.val
            if heartbeat_timeout is None else heartbeat_timeout)
        # the cluster owns the service port (it starts the server)
        self._coordsvc_port = cluster.coordsvc_port
        self._stop_watchdog = threading.Event()
        # the knobs are validated loudly: a typo'd budget must never
        # silently disable elasticity
        env_budget, _, self._inrun = elastic.validate_elastic_knobs()
        self._max_restarts = (env_budget if max_restarts is None
                              else max_restarts)
        # keyed by process id (two processes may share a node address)
        self._restarts: Dict[int, int] = {}       # restarts used
        self._restart_at: Dict[int, float] = {}   # last relaunch (monotonic)
        self._launch_cmds: Dict[int, tuple] = {}  # (address, command, env)
        self._live_procs: Dict[int, object] = {}  # current launcher Popen
        # the preemption plane, keyed by node address: an announced
        # departure's deadline (wall clock) — a node here is LEAVING ON
        # PURPOSE, its silence is expected (filled by the shrink planner
        # and by _is_departing's reads, so it is not the "shrink decided"
        # memory: that is _departures_handled); and the nodes whose
        # survivors' epoch was published, the only ones whose exit the
        # process watcher reads as the end of a departure
        self._planned_departures: Dict[str, float] = {}
        self._departures_handled: set = set()
        self._departures_shrunk: set = set()
        # the preempt/seq cursor: the planner scans the per-worker marks
        # only when a publish moved it (one GET a tick otherwise)
        self._preempt_seq_seen = ""
        # sync-elastic (checkpoint-restore orchestration): a worker death
        # restarts the WHOLE job from the latest checkpoint.
        # ADT_ELASTIC_SYNC at bring-up declares it from construction — a
        # worker dying in the join window (before the chief has built the
        # strategy) must take the whole-job path, not the per-worker
        # soundness gate; the build path re-confirms via
        # enable_sync_elastic()
        self._sync_elastic = (const.ENV.ADT_ELASTIC.val > 0
                              and const.ENV.ADT_ELASTIC_SYNC.val)
        # one whole-job restart an incarnation; the exits it blames among
        self._restart_lock = threading.Lock()
        self._restart_claimed = False
        self._exits: Dict[int, tuple] = {}  # pid -> (monotonic stamp, code)
        self._death_seen = threading.Event()
        self._restart_done = threading.Event()
        atexit.register(self.join)

    def enable_sync_elastic(self):
        self._sync_elastic = True

    # --------------------------------------------------------- bookkeeping

    def _pids_of(self, address: str) -> List[int]:
        return [pid for pid, (a, _c, _e) in self._launch_cmds.items()
                if a == address]

    def _abort(self):
        """Fail fast: ``os._exit`` skips the exit handlers, so stop the
        coordination service and the other workers first — a failed job
        leaves no process behind."""
        self._cluster.stop_coordination_service()
        self._cluster.terminate(grace_s=0.0)
        os._exit(1)

    # ------------------------------------------------------------ watchdog

    def _in_compile_grace(self, client, worker: str) -> bool:
        """True while ``worker`` holds a fresh one-shot ``compiling``
        mark (written by ``Runner._compile_grace_begin`` just before its
        first dispatch, cleared when the dispatch returns): heartbeat
        silence during a first dispatch (kernel builds, the CUDA context,
        a superstep's graph capture) is honest, not a hang. The mark is
        wall-clock (cross-process; minutes of grace make clock skew noise)
        and expires after ``ADT_COMPILE_GRACE_S`` or twice the heartbeat
        window, whichever is larger — a worker that dies mid-dispatch
        still gets declared dead, just later."""
        try:
            mark = client.get("compiling/%s" % worker)
        except OSError:
            return False
        if not mark:
            return False
        try:
            ts = float(mark)
        except ValueError:
            return False
        grace = max(2 * self._heartbeat_timeout,
                    const.ENV.ADT_COMPILE_GRACE_S.val)
        if time.time() - ts < grace:
            logging.info("watchdog: worker %s missed heartbeats but is "
                         "inside its compile grace window — not aging it",
                         worker)
            return True
        return False

    def _is_straggling(self, client, worker: str) -> bool:
        """True while ``worker`` holds a fresh slow-but-alive mark
        (written by ``Runner._observe_straggler`` while its dispatch wall
        time is flagged; "0" once it recovers). Heartbeats ride the step
        clock, so a straggler's beats slow with its steps: the mark tells
        "degraded but progressing" (leave it) from "dead" (recycle it).
        Bounded like the compile mark: a straggler that then dies stops
        refreshing it and is declared dead one window later."""
        try:
            mark = client.get("straggler/%s" % worker)
        except OSError:
            return False
        if not mark:
            return False
        try:
            ts = float(mark)
        except ValueError:
            return False
        if ts <= 0:
            return False  # "0": cleared
        if time.time() - ts < 2 * self._heartbeat_timeout:
            logging.warning(
                "watchdog: worker %s missed heartbeats but marked itself "
                "a straggler (slow-but-alive) — not recycling it", worker)
            return True
        return False

    def _is_departing(self, client, worker: str) -> bool:
        """True while ``worker`` holds a live preemption notice (or its
        announced deadline has not aged out): its silence and its exit are
        an announced departure mid-handoff, and the unplanned-death path
        (a kill, a shrink, the marks' collection) would race it. Read
        before any death is declared."""
        deadline = self._planned_departures.get(worker)
        if deadline is None:
            from autodist_tpu_torch.runtime import preemption
            try:
                notice = preemption.read_notice(client, worker)
            except OSError:
                return False
            if notice is None:
                return False
            deadline = notice.deadline
            self._planned_departures[worker] = deadline
        # a grace past the deadline: the platform's SIGKILL and the exit
        # take a moment; afterwards the next incarnation is supervised
        if time.time() < deadline + 2 * self._heartbeat_timeout:
            logging.info(
                "watchdog: worker %s missed heartbeats but announced its "
                "departure — expected, not escalating", worker)
            return True
        self._planned_departures.pop(worker, None)
        return False

    def _supervised(self, client, dead: List[str]) -> List[str]:
        """The silent workers the watchdog acts on: not the chief, not
        inside a fresh incarnation's bring-up grace (twice the heartbeat
        window after a relaunch: a killed incarnation is deregistered at
        relaunch, so this covers only records the new one wrote), not
        inside a compile grace, not a slow-but-alive straggler and not an
        announced leaver (the planned shrink owns its recovery)."""
        now = time.monotonic()
        dead = [d for d in dead if d != "chief" and now - max(
            (self._restart_at.get(p, float("-inf"))
             for p in self._pids_of(d)), default=float("-inf"))
            > 2 * self._heartbeat_timeout]
        dead = [d for d in dead if not self._in_compile_grace(client, d)]
        dead = [d for d in dead if not self._is_straggling(client, d)]
        return [d for d in dead if not self._is_departing(client, d)]

    def start_watchdog(self):
        """Heartbeat-based failure detection via the coordination service
        (it augments the process watcher): a worker that stops
        heartbeating for ``heartbeat_timeout`` seconds while its process
        is alive is killed for a restart, or fails the job when its
        budget is spent. Only async workers heartbeat (on the step
        clock); for sync workers the watchdog is a no-op, and a wedge
        surfaces as a collective error or timeout -> process death -> the
        whole-job restart."""
        from autodist_tpu_torch.runtime.coordination import \
            CoordinationClient

        def connect_with_backoff():
            """(Re)establish the watchdog's client, retrying with capped
            backoff until connected or the job stops: a single service
            blip must not disable supervision for good."""
            delay = 0.5
            while not self._stop_watchdog.is_set():
                try:
                    # finite RPC deadline: a hung (not just dead) service
                    # must surface as a timeout, not park the watchdog
                    return CoordinationClient(
                        "127.0.0.1", self._coordsvc_port,
                        timeout=max(5.0, self._heartbeat_timeout / 2))
                except OSError as e:
                    logging.warning(
                        "watchdog: coordination service unreachable on "
                        "port %d (%s) — heartbeat supervision DEGRADED; "
                        "retrying in %.1fs", self._coordsvc_port, e, delay)
                    if self._stop_watchdog.wait(delay):
                        return None
                    delay = min(delay * 2, self._heartbeat_timeout / 2)
            return None

        def watch():
            client = connect_with_backoff()
            if client is None:
                return
            # under the in-run plane the loop also admits joiners, so it
            # ticks at least every ADT_ELASTIC_POLL_S
            tick = self._heartbeat_timeout / 4
            if self._inrun:
                tick = min(tick, max(0.05, const.ENV.ADT_ELASTIC_POLL_S.val))
            while not self._stop_watchdog.wait(tick):
                try:
                    dead = client.dead_workers(self._heartbeat_timeout)
                except OSError as e:
                    logging.warning(
                        "watchdog: lost the coordination service (%s) — "
                        "supervision degraded until reconnect", e)
                    try:
                        client.close()
                    except OSError:
                        pass
                    client = connect_with_backoff()
                    if client is None:
                        return
                    logging.info("watchdog: coordination service client "
                                 "re-established; supervision resumed")
                    continue
                # the planned shrink for an announced leaver, and
                # grow-on-join for a relaunched worker that announced
                # itself: each publishes the next epoch
                try:
                    self._maybe_plan_departures(client)
                    self._maybe_admit_joiners(client)
                except OSError:
                    pass  # a service blip: the next tick retries
                dead = self._supervised(client, dead)
                fatal = [d for d in dead if self._max_restarts <= max(
                    (self._restarts.get(p, 0) for p in self._pids_of(d)),
                    default=0)]
                for d in dead:
                    if d in fatal:
                        continue
                    procs = [self._live_procs.get(p)
                             for p in self._pids_of(d)]
                    alive = [p for p in procs
                             if p is not None and p.poll() is None]
                    if not alive:
                        logging.warning(
                            "worker %s missed heartbeats; restart budget "
                            "remains — leaving it to the process watcher", d)
                        continue
                    # only kill when SOME recovery is sound: a per-worker
                    # relaunch (async), or the whole-job restart (killing
                    # the wedged worker routes its death there)
                    if (not self._sync_elastic
                            and self._restart_unsound_reason(d) is not None):
                        logging.warning(
                            "worker %s missed heartbeats but a restart "
                            "would be unsound — not killing it", d)
                        continue
                    logging.warning(
                        "worker %s missed heartbeats but its process is "
                        "alive (deadlock?) — killing it for an elastic "
                        "restart", d)
                    try:
                        for proc in alive:
                            os.killpg(proc.pid, signal.SIGKILL)
                            proc.wait(timeout=5)
                        killed = True
                    except Exception:  # noqa: BLE001
                        killed = False
                        logging.error(
                            "could not kill wedged worker %s; keeping its "
                            "liveness record so this stays visible", d)
                    if killed:
                        # deregister ONLY once the process is confirmed
                        # gone: erasing the record of a still-wedged
                        # worker would hide the hang forever
                        try:
                            client.goodbye(d)
                        except OSError:
                            pass
                if fatal:
                    logging.error("workers %s missed heartbeats — aborting",
                                  fatal)
                    self._abort()
        t = threading.Thread(target=watch, daemon=True)
        t.start()
        self._threads.append(t)

    # -------------------------------------------------------------- launch

    def distribute_strategy(self):
        """Copy the serialized strategy to every worker node (chief-side;
        workers poll for the file by id). The chief's own node needs no
        copy: its workers read the chief's file. In the chief-launched
        flow this runs AFTER the workers are up — they wait in their
        strategy poll until the file lands."""
        strategy_path = os.path.join(const.DEFAULT_SERIALIZATION_DIR,
                                     self._strategy_id)
        for address in self._cluster.node_addresses:
            if not self._cluster.is_chief(address):
                self._cluster.remote_copy(
                    strategy_path, const.DEFAULT_SERIALIZATION_DIR, address)

    def launch_clients(self, copy_strategy: bool = True):
        """Relaunch this script for every process but process 0 (the
        chief)."""
        script = os.path.abspath(sys.argv[0])
        argv_rest = " ".join(shlex.quote(a) for a in sys.argv[1:])
        if copy_strategy:
            self.distribute_strategy()
        addresses = self._cluster.process_addresses
        for pid in range(1, len(addresses)):
            address = addresses[pid]
            env = self._cluster.worker_env(address,
                                           self._cluster.local_rank(pid))
            env[const.ENV.ADT_STRATEGY_ID.name_str] = self._strategy_id
            # propagate the knobs only when explicitly set locally — an
            # empty string would override the worker's default
            for e in _PROPAGATED:
                raw = os.environ.get(e.name_str)
                if raw is not None:
                    env[e.name_str] = raw
            # from the cluster field, not the chief's env: an explicit
            # coordsvc_port constructor arg must reach the workers too
            env[const.ENV.ADT_COORDSVC_PORT.name_str] = str(self._coordsvc_port)
            # where the strategy is copied is where the worker reads it
            env["ADT_WORKING_DIR"] = const.DEFAULT_WORKING_DIR
            command = "%s -u %s %s" % (shlex.quote(sys.executable),
                                       shlex.quote(script), argv_rest)
            self._launch_cmds[pid] = (address, command, env)
            proc = self._cluster.remote_exec(command, address, env=env)
            if proc is not None:
                self._live_procs[pid] = proc
                self._proc_wait_async(proc, pid)
            logging.info("launched worker client on %s (process %d)",
                         address, pid)

    def _proc_wait_async(self, proc, pid: int):
        """The process watcher of launched process ``pid``: on a non-zero
        exit, :meth:`_on_exit` decides between a restart and the
        fail-fast (reference ``coordinator.py:98-110``)."""
        def watch():
            code = proc.wait()
            if not self._on_exit(pid, code, time.monotonic(), proc):
                self._abort()
        t = threading.Thread(target=watch, daemon=True)
        t.start()
        self._threads.append(t)

    def _on_exit(self, pid: int, code, stamp: float, proc=None) -> bool:
        """Process ``pid`` exited with ``code`` at ``stamp``
        (``time.monotonic()`` when its ``wait`` returned); False when the
        job must abort. A worker death after the job finished cleanly
        (``stop_watchdog`` set — the chief's exit-time terminate
        SIGTERMing a trailing worker, or the restart reaping the
        incarnation) is shutdown, not failure. With an elastic budget a
        restartable worker is restarted. An announced leaver's exit ends
        its departure when its survivors' epoch was published, and takes
        the whole-job restart when it was not (whatever its code)."""
        address = self._launch_cmds.get(pid, ("",))[0]
        if address in self._departures_shrunk:
            # an announced leaver whose survivors' epoch was published:
            # its exit ends the departure — even a non-zero code (the
            # platform's deadline SIGKILL) aborts nothing and spends no
            # restart; its liveness records are collected
            logging.warning(
                "preemption: announced leaver %s exited with code %s — "
                "planned departure complete", address, code)
            try:
                c = self._coordsvc_client()
                elastic.gc_worker_marks(c, address)
                c.close()
            except OSError:
                pass
            return True
        if code == 0 and address not in self._departures_handled:
            return True
        # (a departure the chief could not shrink for takes the whole-job
        # restart its log promised when the leaver exits, zero or not)
        self._exits[pid] = (stamp, code)
        self._death_seen.set()
        if self._stop_watchdog.is_set():
            return True
        try:
            if self._try_restart(pid, code, proc):
                return True
        except Exception as e:  # noqa: BLE001 — a broken restart path
            # must degrade to fail-fast, never to a silently dead watcher
            # (the worker IS down at this point)
            logging.error("elastic restart of %s failed: %s", address, e)
        logging.error("worker %s exited with code %s — aborting job",
                      address, code)
        return False

    # ----------------------------------------------------- elastic recovery

    def _try_restart(self, pid: int, code, old_proc=None) -> bool:
        """Relaunch dead process ``pid`` when (a) restart budget remains
        and (b) the job's strategy makes a restart SOUND; returns True when
        a relaunch happened (the new process is supervised like the
        first). A sync-elastic job shrinks in-run under
        ``ADT_ELASTIC_INRUN`` (:meth:`_shrink_to_survivors`), and restarts
        whole when that is off or unsound, or fails."""
        if self._sync_elastic:
            try:
                if self._shrink_to_survivors(pid, code):
                    return True
            except Exception as e:  # noqa: BLE001 — a broken shrink path
                # degrades to the proven whole-job restart
                logging.error("in-run elastic shrink failed (%s); falling "
                              "back to the whole-job restart", e)
            return self._restart_whole_job(pid, code)
        used = self._restarts.get(pid, 0)
        if self._max_restarts <= used or pid not in self._launch_cmds:
            return False
        address, command, env = self._launch_cmds[pid]
        # reap FIRST — right after proc.wait() returned, before the (file
        # IO) soundness gate — to keep the pgid-reuse window minimal and
        # ensure no orphan survivor outlives this decision either way
        self._reap_incarnation(address, command, old_proc)
        reason = self._restart_unsound_reason(address)
        if reason is not None:
            logging.error("worker %s died (code %s) but elastic restart is "
                          "unsound for this job: %s — failing fast",
                          address, code, reason)
            return False
        self._restarts[pid] = used + 1
        self._restart_at[pid] = time.monotonic()
        # scrub the dead incarnation's liveness records (a crashed or
        # SIGKILLed worker never said GOODBYE): its stale heartbeat must
        # not age against the replacement while it starts, and its
        # compiling mark must not cover the next incarnation
        try:
            from autodist_tpu_torch.runtime.coordination import \
                CoordinationClient
            c = CoordinationClient("127.0.0.1", self._coordsvc_port)
            elastic.gc_worker_marks(c, address)
            c.close()
        except OSError:
            pass  # no service (or unreachable): the bring-up grace covers it
        logging.warning("worker %s exited with code %s — relaunching worker "
                        "(restart %d/%d)", address, code,
                        self._restarts[pid], self._max_restarts)
        proc = self._cluster.remote_exec(command, address, env=env)
        if proc is None:  # dry-run mode: nothing to supervise
            return True
        self._live_procs[pid] = proc
        self._proc_wait_async(proc, pid)
        return True

    # -------------------------------------------- in-run elastic (8.3b)

    def _coordsvc_client(self):
        from autodist_tpu_torch.runtime.coordination import \
            CoordinationClient
        return CoordinationClient("127.0.0.1", self._coordsvc_port,
                                  timeout=max(5.0,
                                              self._heartbeat_timeout / 2))

    def _shrink_unsound_reason(self, address: str) -> Optional[str]:
        """None when the survivors can re-form a smaller process group
        in-run after ``address`` dies; otherwise why not (the caller then
        takes the whole-job restart). The analysis plane's ADT430/431
        rules decide (``analysis/rules.py::verify_elastic``), so the
        build-time lint and this decision never disagree."""
        from autodist_tpu_torch.analysis import rules as rules_lib
        from autodist_tpu_torch.strategy.base import Strategy
        try:
            strategy = Strategy.deserialize(self._strategy_id)
        except (OSError, ValueError) as e:
            return "strategy %s unreadable (%s)" % (self._strategy_id, e)
        diags = rules_lib.verify_elastic(strategy, dead_worker=address)
        errors = [d for d in diags if d.code == "ADT430"]
        if errors:
            return errors[0].message
        if any(d.code == "ADT431" for d in diags):
            # the dead worker owned PS state: no survivor holds it, so the
            # shrink is sound only with a committed checkpoint to restore
            from autodist_tpu_torch.checkpoint import latest_checkpoint
            found, _ = latest_checkpoint(const.ENV.ADT_CKPT_DIR.val)
            if found is None:
                return ("worker %s owns PS state (ADT431) and no committed "
                        "checkpoint exists for the fallback restore"
                        % address)
        return None

    def _relaunch(self, pid: int):
        """Start process ``pid``'s launch command again, supervised."""
        address, command, env = self._launch_cmds[pid]
        proc = self._cluster.remote_exec(command, address, env=env)
        if proc is not None:
            self._live_procs[pid] = proc
            self._proc_wait_async(proc, pid)

    def _shrink_to_survivors(self, pid: int, code) -> bool:
        """In-run shrink: publish ``epoch + 1`` with the survivors'
        roster, so that every survivor re-forms the smaller process group
        at its next step boundary (``Runner._maybe_reconfigure``), or at
        once when its step's collective failed. One restart of the budget
        a reconfiguration. Returns False when in-run elasticity is off or
        unsound (the caller restarts the whole job). The dead worker is
        relaunched afterwards, budget permitting, to join again through
        the admission protocol. The roster holds nodes: a death removes
        its node, and a process of that node that survives is fenced out
        at its reconfigure and relaunched in turn."""
        if not self._inrun or pid not in self._launch_cmds:
            return False
        address = self._launch_cmds[pid][0]
        used = self._restarts.get(pid, 0)
        if self._max_restarts <= used:
            logging.error("in-run elastic: worker %s died (code %s) but "
                          "its restart budget (%d) is spent", address,
                          code, self._max_restarts)
            return False
        reason = self._shrink_unsound_reason(address)
        if reason is not None:
            logging.error("in-run elastic: cannot shrink past worker %s: "
                          "%s — falling back to the whole-job restart",
                          address, reason)
            return False
        # the dead incarnation must really be gone before its peers adopt
        # a roster without it: the fence would be the only defense else
        command = self._launch_cmds[pid][1]
        self._reap_incarnation(address, command, self._live_procs.get(pid))
        client = self._coordsvc_client()
        try:
            elastic.gc_worker_marks(client, address)
            info = elastic.read_epoch(client)
            if info is None:
                logging.error("in-run elastic: no epoch was ever published "
                              "(the build did not arm the membership) — "
                              "falling back to the whole-job restart")
                return False
            epoch, roster = info
            if address not in roster:
                # shrunk away already (its relaunch died before admission,
                # or a second process of the node): the roster is right —
                # a restart goes on another relaunch, no epoch
                self._restarts[pid] = used + 1
                self._restart_at[pid] = time.monotonic()
                self._relaunch(pid)
                logging.warning(
                    "in-run elastic: process %d on %s, outside the roster, "
                    "exited (code %s) — relaunching it (restart %d/%d)",
                    pid, address, code, used + 1, self._max_restarts)
                return True
            survivors = [a for a in roster if a != address]
            if not survivors:
                return False
            elastic.publish_epoch(client, epoch + 1, survivors)
        finally:
            try:
                client.close()
            except OSError:
                pass
        self._restarts[pid] = used + 1
        self._restart_at[pid] = time.monotonic()
        tel.counter_add("elastic.shrinks")
        logging.warning(
            "in-run elastic: worker %s died (code %s) — published epoch %d "
            "with %d survivor(s); the job shrinks at the next boundary "
            "(restart %d/%d)", address, code, epoch + 1, len(survivors),
            self._restarts[pid], self._max_restarts)
        # survivors that never ack (wedged in a collective the dead worker
        # will never enter again) escalate to the whole-job restart
        t = threading.Thread(target=self._watch_acks,
                             args=(epoch + 1, survivors, pid, code),
                             daemon=True)
        t.start()
        self._threads.append(t)
        # relaunched, it announces itself and grows the job back
        self._relaunch(pid)
        logging.info("in-run elastic: relaunched %s for grow-on-join",
                     address)
        return True

    def _watch_acks(self, epoch: int, roster, pid: int, code):
        """Wait for every survivor's ``elastic/ack/<epoch>/<worker>``;
        escalate to the whole-job restart when the shrink does not
        complete within ``ADT_ELASTIC_ACK_TIMEOUT_S``."""
        timeout = const.ENV.ADT_ELASTIC_ACK_TIMEOUT_S.val
        deadline = time.monotonic() + timeout
        pending = set(roster)
        client = None
        while not self._stop_watchdog.is_set():
            if client is None:
                try:
                    client = self._coordsvc_client()
                except OSError:
                    if self._stop_watchdog.wait(1.0):
                        return
                    continue
            try:
                for w in sorted(pending):
                    if client.get("elastic/ack/%d/%s" % (epoch, w)):
                        pending.discard(w)
            except OSError:
                try:
                    client.close()
                except OSError:
                    pass
                client = None
            if not pending:
                logging.info("in-run elastic: every survivor acked "
                             "epoch %d", epoch)
                tel.counter_add("elastic.reconfigs_acked")
                if client is not None:
                    client.close()
                return
            if time.monotonic() > deadline:
                logging.error(
                    "in-run elastic: survivors %s never acked epoch %d "
                    "within %.0fs — escalating to the whole-job restart",
                    sorted(pending), epoch, timeout)
                if client is not None:
                    client.close()
                if not self._restart_whole_job(pid, code):
                    self._abort()
                return
            if self._stop_watchdog.wait(0.25):
                return

    def _maybe_plan_departures(self, client):
        """The planned handoff, chief side: a rostered worker published a
        preemption notice — publish the survivors' roster at epoch + 1
        now, while the leaver is alive and in lockstep. The survivors
        reconfigure from their own live state (no checkpoint fallback, no
        detection latency); the leaver, out of the new roster, departs
        gracefully instead of the zombie fence-out. No reap, no relaunch,
        no restart of the budget: the host is being taken away, not
        recovered. One membership change a tick."""
        from autodist_tpu_torch.runtime import preemption
        if not self._inrun:
            return
        # the steady state reads one key; the cursor is consumed only
        # after a scan that published nothing, so a second notice is
        # planned at the next tick
        seq = client.get(preemption.SEQ_KEY) or ""
        if seq == self._preempt_seq_seen:
            return
        info = elastic.read_epoch(client)
        if info is None:
            return
        epoch, roster = info
        for addr in roster:
            if addr in self._departures_handled:
                continue  # this departure's shrink decision is made
            notice = preemption.read_notice(client, addr)
            if notice is None or preemption.has_left(client, addr):
                continue
            self._departures_handled.add(addr)
            self._planned_departures[addr] = notice.deadline
            if addr == "chief" or self._cluster.is_chief(addr):
                logging.error(
                    "preemption: the CHIEF announced departure (%s) — a "
                    "chief handoff needs external re-election; relying on "
                    "the rescue checkpoint + ADT_AUTO_RESUME relaunch",
                    notice.reason)
                continue
            reason = self._shrink_unsound_reason(addr)
            if reason is not None:
                logging.error(
                    "preemption: %s announced departure but the topology "
                    "cannot shrink past it (%s) — it departs with its "
                    "rescue checkpoint and the job takes the whole-job "
                    "restart when it exits", addr, reason)
                continue
            survivors = [a for a in roster if a != addr]
            if not survivors:
                continue  # the last worker standing: nothing to shrink to
            elastic.publish_epoch(client, epoch + 1, survivors)
            self._departures_shrunk.add(addr)
            tel.counter_add("preempt.planned_shrinks")
            tel.instant("preempt.planned_shrink", "preempt", worker=addr,
                        epoch=epoch + 1, world=len(survivors),
                        reason=notice.reason)
            logging.warning(
                "preemption: planned shrink for announced leaver %s (%s, "
                "%.1fs of grace) — published epoch %d with %d "
                "survivor(s); the leaver hands off ALIVE at the rescue "
                "plan's boundary", addr, notice.reason,
                max(notice.remaining_s(), 0.0), epoch + 1, len(survivors))
            # the unplanned shrink's escalation: survivors that never ack
            # get the whole-job restart
            pids = self._pids_of(addr)
            if pids:
                t = threading.Thread(
                    target=self._watch_acks,
                    args=(epoch + 1, survivors, pids[0], "preempted"),
                    daemon=True)
                t.start()
                self._threads.append(t)
            return  # one membership change a tick (cursor unconsumed)
        self._preempt_seq_seen = seq

    def _maybe_admit_joiners(self, client):
        """Grow-on-join: admit the relaunched workers that announced
        themselves (``elastic/join/<worker>``) by publishing the grown
        roster at the next epoch. The candidates are the nodes this chief
        launched that the current roster leaves out; one of them with no
        fresh announcement has its stale liveness marks scrubbed."""
        if not self._inrun:
            return
        info = elastic.read_epoch(client)
        if info is None:
            return
        epoch, roster = info
        outsiders = sorted({a for a, _c, _e in self._launch_cmds.values()
                            if a not in roster})
        joiners = []
        for a in outsiders:
            if elastic.pending_join(client, a):
                joiners.append(a)
            else:
                elastic.gc_worker_marks(client, a)
        if not joiners:
            return
        from autodist_tpu_torch.runtime import preemption
        for a in joiners:
            elastic.clear_join(client, a)
            elastic.gc_worker_marks(client, a)
            # an earlier incarnation's notice must not make the watchdog
            # read the new one as leaving, and a later departure of the
            # address must be planned afresh
            preemption.clear_notice(client, a)
            self._planned_departures.pop(a, None)
            self._departures_handled.discard(a)
            self._departures_shrunk.discard(a)
        grown = roster + joiners
        elastic.publish_epoch(client, epoch + 1, grown)
        tel.counter_add("elastic.grows")
        logging.warning(
            "in-run elastic: admitted %s — published epoch %d with %d "
            "member(s); the job grows at the next boundary",
            ",".join(joiners), epoch + 1, len(grown))

    def _restart_whole_job(self, pid: int, code) -> bool:
        """Sync-elastic recovery: a worker died mid-lockstep, so the other
        processes, this chief included, cannot continue. Reap every worker
        incarnation, stop the service, then re-exec the chief's own script
        with ``ADT_AUTO_RESUME=1``: the fresh run relaunches the workers
        and every process restores the latest checkpoint
        (``Runner.init``). The budget is carried across the exec in
        ``ADT_ELASTIC_RESTARTS``. Returns False (fail-fast) when the budget
        is spent or there is nothing to restore.

        One restart an incarnation: the first death claims it, and every
        later one (the survivors' own exits under gloo) returns True, read
        as the teardown. The restart waits ``RESTART_SETTLE_S`` and for
        any checkpoint this process is still writing (the save the dead
        worker made just before its death), then blames the process whose
        exit came first."""
        with self._restart_lock:
            if self._restart_claimed:
                return True
            self._restart_claimed = True
        time.sleep(RESTART_SETTLE_S)
        from autodist_tpu_torch import checkpoint
        if not checkpoint.saver.wait_for_writes(SAVE_WAIT_S):
            logging.warning("sync-elastic: a checkpoint of this process is "
                            "still being written after %.0f s; restarting "
                            "from the newest committed one", SAVE_WAIT_S)
        if self._exits:  # (a planned departure's escalation has none)
            pid = min(self._exits, key=lambda p: self._exits[p][0])
            code = self._exits[pid][1]
        address = self._launch_cmds[pid][0]
        used = const.ENV.ADT_ELASTIC_RESTARTS.val
        if used >= self._max_restarts or not self._launch_cmds:
            logging.error(
                "sync-elastic: worker %s died (code %s) but the restart "
                "budget (%d) is spent — failing fast", address, code,
                self._max_restarts)
            return False
        # the probe the runner's auto-resume uses — the nothing-to-restore
        # fail-fast here and the actual resume there must agree
        ckpt_dir = const.ENV.ADT_CKPT_DIR.val
        found, _saver = checkpoint.latest_checkpoint(ckpt_dir)
        cur_step = -1 if found is None else found
        if cur_step < 0:
            logging.error(
                "sync-elastic: worker %s died (code %s) before any "
                "checkpoint landed in %s — nothing to restore, failing "
                "fast (save at least once per restart window)", address,
                code, ckpt_dir)
            return False
        # permanently-lost detection: a node whose worker's death triggers
        # two whole-job restarts WITHOUT checkpoint progress in between is
        # excluded, and the restarted job runs at reduced world size. Any
        # committed progress resets the "consecutive" condition, so
        # transient failures hours apart never decommission a healthy host
        last_dead = const.ENV.ADT_ELASTIC_LAST_DEAD.val
        last_step = const.ENV.ADT_ELASTIC_LAST_DEAD_STEP.val
        exclude = [a for a in const.ENV.ADT_ELASTIC_EXCLUDE.val.split(",")
                   if a]
        if (address == last_dead and cur_step <= last_step
                and address not in exclude):
            if self._cluster.is_chief(address):
                logging.error(
                    "sync-elastic: worker %s died twice with no checkpoint "
                    "progress (still at step %d), but it is the chief's "
                    "node, which cannot be excluded — failing fast",
                    address, cur_step)
                return False
            exclude.append(address)
            os.environ[const.ENV.ADT_ELASTIC_EXCLUDE.name_str] = (
                ",".join(exclude))
            logging.error(
                "sync-elastic: worker %s died twice with no checkpoint "
                "progress (still at step %d) — treating it as PERMANENTLY "
                "lost; the job restarts at reduced world size without it "
                "(excluded: %s)", address, cur_step, exclude)
        os.environ[const.ENV.ADT_ELASTIC_LAST_DEAD.name_str] = address
        os.environ[const.ENV.ADT_ELASTIC_LAST_DEAD_STEP.name_str] = str(
            cur_step)
        logging.warning(
            "sync-elastic: worker %s died (code %s) mid-lockstep — "
            "restarting the WHOLE job from the latest checkpoint "
            "(restart %d/%d)", address, code, used + 1, self._max_restarts)
        # silence the other watchers first: the reap below kills their
        # processes, which must read as shutdown, not as fresh failures
        self._stop_watchdog.set()
        for p, (addr, command, _env) in sorted(self._launch_cmds.items()):
            try:
                self._reap_incarnation(addr, command,
                                       self._live_procs.get(p))
            except Exception as e:  # noqa: BLE001 — best-effort teardown
                logging.warning("reap of %s failed: %s", addr, e)
        # stop the coordination-service child: exec skips atexit, and an
        # orphan would hold the port (EADDRINUSE for the resumed job's
        # fresh server) while carrying stale heartbeat/queue/barrier state
        self._cluster.stop_coordination_service()
        os.environ[const.ENV.ADT_ELASTIC_RESTARTS.name_str] = str(used + 1)
        os.environ[const.ENV.ADT_AUTO_RESUME.name_str] = "1"
        # scrub what THIS incarnation's _early_launch exported: the fresh
        # chief must look like a first start (else maybe_init_distributed
        # joins from the inherited process count BEFORE the workers are
        # launched and wedges waiting for them)
        for env in (const.ENV.ADT_NUM_PROCESSES, const.ENV.ADT_STRATEGY_ID,
                    const.ENV.ADT_DEVICE):
            os.environ.pop(env.name_str, None)
        _close_inherited_on_exec()
        logging.warning("sync-elastic: re-exec %s %s", sys.executable,
                        " ".join(sys.argv))
        sys.stdout.flush()
        sys.stderr.flush()
        self._restart_done.set()
        # exec replaces the process image: the main thread (waiting in
        # collective_failed, or hung in a collective under NCCL), the
        # group's state and the atexit chain all go with it
        os.execv(sys.executable, [sys.executable] + sys.argv)
        return True

    def await_restart(self, exc: Optional[BaseException] = None,
                      timeout: float = COLLECTIVE_WAIT_S):
        """Called on the chief's main thread after a collective failed
        (:func:`collective_failed`) or when it exits with an uncaught
        error: under sync elastic, wait up to ``timeout`` s for a worker's
        death, then for the restart's decision (the exec replaces this
        process; a fail-fast exits it). Returns at once without sync
        elastic, and after ``timeout`` when no worker died: the error is
        the caller's, not a worker's."""
        if not self._sync_elastic or (self._stop_watchdog.is_set()
                                      and not self._restart_claimed):
            return
        logging.warning("sync-elastic: the chief's collective failed (%s) "
                        "— waiting up to %.0f s for a worker's death and "
                        "the whole-job restart", exc, timeout)
        if not self._death_seen.wait(timeout):
            logging.error("sync-elastic: no worker died within %.0f s of "
                          "the failed collective — not restarting", timeout)
            return
        self._restart_done.wait(RESTART_DECISION_S)

    def _reap_incarnation(self, address: str, command: str, old_proc):
        """Make sure the PREVIOUS incarnation is really gone before its
        replacement starts: the watcher observes the LOCAL launcher process
        (for ssh transport, the ssh client), which can die — network blip,
        ssh killed — while the remote worker keeps training. Two live
        incarnations under one worker identity would both push gradients.

        Local transport: SIGKILL the old process group (the launch makes
        its own session, so pgid == the launcher pid, valid while ANY
        member survives). Remote transport: kill the exact launched
        command line on the remote host (the reference's stale-server
        cleanup approach, ``utils/server_starter.py:29-46``), scoped to
        this job's strategy id via /proc environ (``_reap_command``)."""
        if old_proc is not None:
            try:
                os.killpg(old_proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                pass
        if not self._cluster._is_local(address):
            self._cluster.remote_exec(
                _reap_command(command, self._strategy_id), address, wait=True)

    def _restart_unsound_reason(self, address: str) -> Optional[str]:
        """None when every variable syncs through async host-PS owned by a
        surviving node; otherwise why a restart would corrupt the job.
        Sync strategies are collective-lockstep (the peers cannot meet a
        relaunched worker at the same program point), and any PS group
        owned by the dead worker took its authoritative state down with
        it — both must fail fast (resume from a checkpoint instead).
        Conservative: it reads the raw serialized strategy, so
        over-strictness degrades to the reference's fail-fast, never to a
        corrupted run."""
        from autodist_tpu_torch.strategy.base import PSSynchronizer, Strategy
        if const.ENV.ADT_ELASTIC.val <= 0:
            # Coordinator(max_restarts=...) without the ADT_ELASTIC
            # bring-up: every process joined the process group, whose
            # pinned process set a relaunched worker cannot re-enter
            return ("ADT_ELASTIC was not set at bring-up, so processes "
                    "joined the process group (pinned process set)")
        try:
            strategy = Strategy.deserialize(self._strategy_id)
        except (OSError, ValueError) as e:
            return "strategy %s unreadable (%s)" % (self._strategy_id, e)
        if strategy.graph_config.mesh_shape:
            return "model-parallel mesh axes are collective-lockstep"
        for node in strategy.node_config:
            for leaf in node.part_configs or [node]:
                sync = leaf.synchronizer or node.synchronizer
                if not isinstance(sync, PSSynchronizer) or sync.sync:
                    return "var %r is not async host-PS" % node.var_name
                dest_host = (sync.reduction_destination or "").split(":")[0]
                if dest_host == address:
                    return ("dead worker %s OWNS the PS group of %r — its "
                            "authoritative state died with it"
                            % (address, node.var_name))
        return None

    # ------------------------------------------------------------ shutdown

    def stop_watchdog(self):
        """Mark the job as finishing cleanly — call BEFORE the workers
        exit, or the watchers read their normal exit as a failure."""
        self._stop_watchdog.set()

    def at_exit(self):
        """The chief's exit hook (registered after ``Cluster.start``'s, so
        it runs first): an interpreter exit that an uncaught error started
        (``sys.last_value``: a collective that failed outside the
        Runner), or that meets a restart in progress, first waits for the
        restart's decision under sync elastic; then the job is marked as
        finishing."""
        err = getattr(sys, "last_value", None)
        if err is not None or self._restart_claimed:
            self.await_restart(err)
        self.stop_watchdog()

    def join(self):
        self.stop_watchdog()
        for t in self._threads:
            if t is not threading.current_thread() and t.is_alive():
                t.join(timeout=5)
