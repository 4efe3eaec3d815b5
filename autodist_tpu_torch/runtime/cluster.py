"""Cluster — multi-host process management.

PyTorch counterpart of ``autodist_tpu/runtime/cluster.py``
(reference ``autodist/cluster.py:51-374``):

- the deterministic process layout: the chief's node first, then the
  other nodes sorted (the determinism the reference gets from sorted
  ip:port ordering, ``cluster.py:70-82``);
- the deployment plane: SSH/SCP helpers to ship files and launch remote
  commands, honoring ``ADT_DEBUG_REMOTE`` for dry-runs; loopback nodes
  (and ``transport: local``) run through local ``bash``/``cp``;
- teardown: terminating launched process groups at exit;
- in-run elastic reconfiguration (:meth:`Cluster.reconfigure`): the
  layout follows an epoch's roster of nodes.

What differs from the JAX module: there one process per node owns every
device of the node; here one process is one replica. So the layout has
one process per device entry of every node — its ``gpus``, or its
``cpus`` on a CPU node — in node order and, within a node, in list
order. Process 0, the first entry of the chief's node, is the chief; a
second process on the chief's node is a worker. Each process runs on its
own entry's device (``ADT_DEVICE``), and ``LOCAL_RANK`` is its position
within its node, as torchrun sets it.
"""
import atexit
import os
import shlex
import signal
import subprocess
import time
from typing import Dict, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.resource_spec import (DeviceSpec, DeviceType,
                                              ResourceSpec, SSHConfig)
from autodist_tpu_torch.utils import logging, network


class Cluster:
    """Process layout + lifecycle for one training job."""

    def __init__(self, resource_spec: ResourceSpec,
                 coordinator_port=None, coordsvc_port=None):
        self._spec = resource_spec
        # explicit arg > ADT_COORDINATOR_ADDR's port > default — two
        # colocated jobs (or parallel test runs) must not both bind the
        # default port; the env is already honored on the worker side
        if coordinator_port is None:
            addr = const.ENV.ADT_COORDINATOR_ADDR.val
            if addr and ":" in addr:
                coordinator_port = int(addr.rsplit(":", 1)[1])
            else:
                coordinator_port = const.DEFAULT_COORDINATOR_PORT
        self._port = coordinator_port
        # single source of truth for the native coordination-service port
        # (the server it starts, the workers' env)
        self.coordsvc_port = (coordsvc_port if coordsvc_port is not None
                              else const.ENV.ADT_COORDSVC_PORT.val)
        # deterministic: chief first, then remaining addresses sorted
        others = [a for a in resource_spec.node_addresses
                  if a != resource_spec.chief]
        self._nodes: List[str] = [resource_spec.chief] + others
        # one process a device entry, in node order, list order within
        self._entries: List[DeviceSpec] = [
            d for a in self._nodes for d in resource_spec.devices
            if d.host == a]
        self._procs: List[subprocess.Popen] = []
        self._coordsvc = None
        self._started = False

    # ------------------------------------------------------------- layout

    @property
    def num_processes(self) -> int:
        return len(self._entries)

    @property
    def coordinator_address(self) -> str:
        return "%s:%d" % (self._spec.chief, self._port)

    def process_id(self, address: str, local_rank: int = 0) -> int:
        """The id of the ``local_rank``-th process on node ``address``."""
        ids = [i for i, d in enumerate(self._entries) if d.host == address]
        if local_rank >= len(ids):
            raise ValueError("node %s has %d process(es), no local rank %d"
                             % (address, len(ids), local_rank))
        return ids[local_rank]

    def local_rank(self, process_id: int) -> int:
        """Process ``process_id``'s position within its node."""
        host = self._entries[process_id].host
        return sum(1 for d in self._entries[:process_id] if d.host == host)

    def device(self, process_id: int) -> str:
        """Process ``process_id``'s device: ``cuda:<listed index>`` for a
        card entry, ``cpu`` on a CPU node."""
        entry = self._entries[process_id]
        if entry.device_type == DeviceType.GPU:
            return "cuda:%d" % entry.device_index
        return "cpu"

    @property
    def process_addresses(self) -> List[str]:
        """Each process's node address, in process-id order (a node with
        more than one entry appears once a process)."""
        return [d.host for d in self._entries]

    @property
    def node_addresses(self) -> List[str]:
        """The nodes, chief first, then the others sorted."""
        return list(self._nodes)

    def is_chief(self, address: Optional[str] = None) -> bool:
        """Without an address: whether this process is the chief. With
        one: whether it is the chief's node (which may hold workers too;
        process 0 is the chief)."""
        if address is None:
            return const.is_chief()
        return address == self._spec.chief

    @property
    def entries_per_node(self) -> Dict[str, int]:
        """Each node's number of device entries (processes) in the
        launch spec, which the elastic roster expansion reads."""
        from autodist_tpu_torch.runtime import elastic
        return elastic.spec_entries(self._spec)

    def reconfigure(self, roster: List[str], epoch: int):
        """Adopt an elastic epoch's roster as this job's process set (the
        chief's half of ``elastic.rejoin_process_set``): the layout keeps
        the launch spec's entries of the roster's nodes, in the roster's
        order, then this process leaves its group and joins the epoch's
        as the smaller (shrink) or larger (grow) world. Workers hold no
        Cluster; they call ``rejoin_process_set`` with the same rule, so
        every member computes the same ranks."""
        from autodist_tpu_torch.runtime import elastic
        entries = self.entries_per_node
        layout = elastic.roster_layout(roster, self._spec.chief)
        self._nodes = layout
        self._entries = [d for a in layout for d in self._spec.devices
                         if d.host == a]
        self.epoch = epoch
        elastic.rejoin_process_set(layout, epoch, entries,
                                   chief=self._spec.chief)

    def worker_env(self, address: str, local_rank: int = 0) -> Dict[str, str]:
        """Env vars that turn a launched script into the ``local_rank``-th
        process of node ``address``."""
        pid = self.process_id(address, local_rank)
        return {
            const.ENV.ADT_WORKER.name_str: address,
            const.ENV.ADT_COORDINATOR_ADDR.name_str: self.coordinator_address,
            const.ENV.ADT_NUM_PROCESSES.name_str: str(self.num_processes),
            const.ENV.ADT_PROCESS_ID.name_str: str(pid),
            const.ENV.ADT_DEVICE.name_str: self.device(pid),
            const.ENV.ADT_ELASTIC_ENTRIES.name_str: ",".join(
                "%s=%d" % kv for kv in sorted(
                    self.entries_per_node.items())),
            "LOCAL_RANK": str(local_rank),
        }

    # ------------------------------------------------------------ lifecycle

    def start(self, device=None):
        """Bring up the distributed runtime on the chief: the native
        coordination service (barriers, staleness, the async parameter
        service; not under ``ADT_DEBUG_REMOTE``), then the chief's join as
        process 0, which returns once every process has joined. Workers
        join through ``server_starter.maybe_init_distributed`` when their
        relaunched script constructs AutoDist. An async-elastic job joins
        no group: the service alone couples its processes."""
        if self._started:
            return
        from autodist_tpu_torch.runtime import server_starter
        if const.is_chief() and not const.ENV.ADT_DEBUG_REMOTE.val:
            from autodist_tpu_torch.runtime.coordination import \
                CoordinationServer
            try:
                self._coordsvc = CoordinationServer(self.coordsvc_port)
                self._coordsvc.start()
                atexit.register(self.stop_coordination_service)
            except (RuntimeError, TimeoutError, OSError,
                    subprocess.CalledProcessError) as e:
                logging.warning("coordination service unavailable: %s", e)
                self._coordsvc = None
        if server_starter.async_elastic():
            # elastic async-PS jobs keep the process set open (workers may
            # die and be relaunched); a process group would pin it shut.
            # Sync-elastic (ADT_ELASTIC_SYNC) joins: lockstep collectives
            # need every rank, and recovery is a whole-job re-exec with a
            # fresh process set rather than a rejoin.
            logging.info("elastic mode: chief not joining the process group")
            server_starter.mark_elastic_started()
        else:
            server_starter.init_distributed(
                coordinator_address=self.coordinator_address,
                num_processes=self.num_processes,
                process_id=(0 if const.is_chief()
                            else const.ENV.ADT_PROCESS_ID.val),
                device=device)
        atexit.register(self.terminate)
        self._started = True

    def stop_coordination_service(self):
        """Stop the service child this cluster started (also before the
        sync-elastic re-exec: ``os.execv`` skips atexit, and an orphaned
        server would hold the port and carry the dead incarnation's state
        into the resumed job)."""
        svc = self._coordsvc
        if svc is not None:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
            self._coordsvc = None

    def terminate(self, grace_s: float = 10.0):
        """Terminate launched worker process groups (reference
        ``cluster.py:176``), giving a clean-finishing job a grace window
        first: the last collective syncs all processes, but trailing
        local work (writing outputs) is not lockstep — killing on sight
        truncates a worker that is milliseconds from a clean exit."""
        deadline = time.monotonic() + grace_s
        for p in self._procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGTERM)
                except (ProcessLookupError, PermissionError, OSError):
                    p.terminate()
        self._procs.clear()

    # ------------------------------------------------------ remote helpers

    def _is_local(self, address: str) -> bool:
        """Loopback addresses (and nodes whose ssh_config says
        ``transport: local``) execute through local bash/cp instead of
        ssh/scp — the chief->worker launch path runs for real on one
        machine, no sshd required."""
        conf = self._spec.ssh_config_map.for_host(address)
        if conf is not None:
            # an explicit ssh_config wins: a loopback address with ssh
            # config is the port-forward-to-remote-host pattern (ssh -p
            # 2222 127.0.0.1 reaches a DIFFERENT machine) and must keep
            # going through ssh unless the config opts into local
            return conf.transport == "local"
        return network.is_loopback_address(address)

    def _ssh_base(self, address: str) -> List[str]:
        conf: Optional[SSHConfig] = self._spec.ssh_config_map.for_host(address)
        cmd = ["ssh", "-oStrictHostKeyChecking=no", "-oBatchMode=yes",
               "-oConnectTimeout=10"]
        if conf:
            if conf.key_file:
                cmd += ["-i", conf.key_file]
            if conf.port != 22:
                cmd += ["-p", str(conf.port)]
            target = ("%s@%s" % (conf.username, address)) if conf.username else address
        else:
            target = address
        return cmd + [target]

    def remote_exec(self, command: str, address: str,
                    env: Optional[Dict[str, str]] = None,
                    wait: bool = False) -> Optional[subprocess.Popen]:
        """Launch a shell command on a node, in a session of its own.
        ``wait=False`` returns the local Popen (tracked for exit-time
        SIGTERM); ``wait=True`` blocks until completion and tracks
        nothing. Dry-run under ADT_DEBUG_REMOTE."""
        conf = self._spec.ssh_config_map.for_host(address)
        env_prefix = ""
        merged = dict(conf.env) if conf else {}
        merged.update(env or {})
        if merged:
            env_prefix = " ".join("%s=%s" % (k, shlex.quote(str(v)))
                                  for k, v in sorted(merged.items())) + " "
        venv = ("source %s/bin/activate && " % conf.python_venv
                if conf and conf.python_venv else "")
        line = venv + env_prefix + command
        if self._is_local(address):
            full = ["bash", "-c", line]
            logging.info("local_exec[%s]: %s", address, line)
        else:
            full = self._ssh_base(address) + ["bash -c %s" % shlex.quote(line)]
            logging.info("remote_exec[%s]: %s", address, " ".join(full))
        if const.ENV.ADT_DEBUG_REMOTE.val:
            return None
        if wait:
            subprocess.run(full, check=False)
            return None
        proc = subprocess.Popen(full, start_new_session=True)
        self._procs.append(proc)
        return proc

    def remote_copy(self, local_path: str, remote_dir: str, address: str) -> bool:
        """SCP a file to a node (reference ``remote_copy``); plain cp for
        local-transport nodes (self-copy skipped)."""
        if self._is_local(address):
            logging.info("local_copy[%s]: %s -> %s", address, local_path,
                         remote_dir)
            if const.ENV.ADT_DEBUG_REMOTE.val:
                return True
            import shutil
            os.makedirs(remote_dir, exist_ok=True)
            dest = os.path.join(remote_dir, os.path.basename(local_path))
            if os.path.abspath(local_path) != os.path.abspath(dest):
                shutil.copy2(local_path, dest)
            return True
        conf = self._spec.ssh_config_map.for_host(address)
        cmd = ["scp", "-oStrictHostKeyChecking=no", "-oBatchMode=yes"]
        if conf:
            if conf.key_file:
                cmd += ["-i", conf.key_file]
            if conf.port != 22:
                cmd += ["-P", str(conf.port)]
            target = ("%s@%s" % (conf.username, address)) if conf.username else address
        else:
            target = address
        self.remote_exec("mkdir -p %s" % shlex.quote(remote_dir), address,
                         wait=True)
        cmd += [local_path, "%s:%s/" % (target, remote_dir)]
        logging.info("remote_copy[%s]: %s", address, " ".join(cmd))
        if const.ENV.ADT_DEBUG_REMOTE.val:
            return True
        return subprocess.run(cmd, check=False).returncode == 0
