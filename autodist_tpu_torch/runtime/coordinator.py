"""Coordinator — the chief launches worker clients and supervises them.

PyTorch counterpart of ``autodist_tpu/runtime/coordinator.py``'s
non-elastic part (reference ``autodist/coordinator.py:46-110``): on the
chief, launch *the same user script* for every process of the layout but
the chief's own, with ``ADT_WORKER=<node>``/``ADT_STRATEGY_ID=<id>`` and
the process's place in the layout; ship the serialized strategy to every
worker node; and a watcher thread a launched process fail-fasts the whole
job (exit code 1) when any worker dies — the reference's supervision
semantics (``coordinator.py:98-110``).

The relaunched command is ``<this interpreter> -u <script> <argv>``: the
interpreter that runs the chief (``sys.executable``), where the JAX
package runs ``python``, which a machine with only ``python3`` lacks.

The elastic paths (heartbeat watchdog, restarts, shrink and rejoin) are
ROADMAP A item 8.3: ``ADT_ELASTIC > 0`` raises at construction.
"""
import atexit
import os
import shlex
import sys
import threading
from typing import List

from autodist_tpu_torch import const
from autodist_tpu_torch.runtime import server_starter
from autodist_tpu_torch.runtime.cluster import Cluster
from autodist_tpu_torch.utils import logging

# the debugging/testing knobs a worker inherits from the chief when they
# are set there (the JAX package's list, reference coordinator.py:70-79)
_PROPAGATED = (const.ENV.ADT_MIN_LOG_LEVEL, const.ENV.ADT_IS_TESTING,
               const.ENV.ADT_PATCH_OPTAX, const.ENV.ADT_ELASTIC,
               const.ENV.ADT_ELASTIC_SYNC, const.ENV.ADT_AUTO_RESUME,
               const.ENV.ADT_CKPT_DIR, const.ENV.ADT_ELASTIC_EXCLUDE,
               const.ENV.ADT_ELASTIC_INRUN, const.ENV.ADT_ELASTIC_POLL_S,
               const.ENV.ADT_ELASTIC_ACK_TIMEOUT_S,
               const.ENV.ADT_HEARTBEAT_TIMEOUT_S)


class Coordinator:
    def __init__(self, strategy, cluster: Cluster):
        server_starter.refuse_elastic()
        # a Strategy object, or just its id — the chief-launched flow
        # preallocates the id and launches workers BEFORE the strategy is
        # built (the chief's join blocks until every worker connects)
        self._strategy_id = getattr(strategy, "id", strategy)
        self._cluster = cluster
        self._threads: List[threading.Thread] = []
        # the cluster owns the service port (it starts the server)
        self._coordsvc_port = cluster.coordsvc_port
        self._stop_watchdog = threading.Event()
        atexit.register(self.join)

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
            proc = self._cluster.remote_exec(command, address, env=env)
            if proc is not None:
                self._proc_wait_async(proc, address)
            logging.info("launched worker client on %s (process %d)",
                         address, pid)

    def _proc_wait_async(self, proc, address: str):
        """Fail-fast watcher (reference ``coordinator.py:98-110``). A
        worker death after the job finished cleanly (``stop_watchdog``
        set — e.g. the chief's exit-time terminate SIGTERMing a trailing
        worker) is shutdown, not failure, and must not abort a successful
        run with exit code 1. ``os._exit`` skips the exit handlers, so the
        watcher stops the coordination service and the other workers
        first: a failed job leaves no process behind."""
        def watch():
            code = proc.wait()
            if code != 0 and not self._stop_watchdog.is_set():
                logging.error("worker %s exited with code %s — aborting job",
                              address, code)
                self._cluster.stop_coordination_service()
                self._cluster.terminate(grace_s=0.0)
                os._exit(1)
        t = threading.Thread(target=watch, daemon=True)
        t.start()
        self._threads.append(t)

    def stop_watchdog(self):
        """Mark the job as finishing cleanly — call BEFORE the workers
        exit, or the watchers read their normal exit as a failure."""
        self._stop_watchdog.set()

    def join(self):
        self.stop_watchdog()
        for t in self._threads:
            if t is not threading.current_thread() and t.is_alive():
                t.join(timeout=5)
