"""Distributed-runtime bring-up for one process.

PyTorch counterpart of ``autodist_tpu/runtime/server_starter.py``. Where
the JAX package joins ``jax.distributed``, a process here joins the
default ``torch.distributed`` process group: a ``TCPStore`` rendezvous at
the chief's coordinator address (process 0 is its master, the
group-leader role), then ``init_process_group`` on that store.

``jax.distributed`` needs no backend choice; ``init_process_group`` does.
Before the group is made, every process publishes its host name and its
card's UUID on the rendezvous store, and :func:`choose_backend` picks
NCCL only when every process has a card of its own (NCCL refuses two
ranks on one card, and two loopback "nodes" can be one machine), else
gloo. The choice and its reason are logged.

Elastic bring-up (``ADT_ELASTIC``, the JAX branches): an async-elastic
process (``ADT_ELASTIC > 0`` without ``ADT_ELASTIC_SYNC``) joins no
group, because a group pins its process set while the chief relaunches
dead workers one at a time; such processes meet only through the
parameter service. A sync-elastic process joins as any other: its
recovery is a whole-job restart with a fresh group
(``runtime/coordinator.py``), or under ``ADT_ELASTIC_INRUN`` an in-run
reconfiguration (``runtime/elastic.py``): :func:`reinit_distributed`
leaves the group and joins the next epoch's, and a relaunched worker
that finds a published epoch without itself in it waits for admission
and joins the epoch that admits it (:func:`maybe_init_distributed`).
"""
import datetime
import json
import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.runtime import elastic
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device

_INITIALIZED = False
# an async-elastic bring-up, which joins no group but counts as started
_ELASTIC_STARTED = False
# how long the rendezvous waits for every process of the job
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)

def choose_backend(placements: Sequence[Tuple[str, Optional[str]]]
                   ) -> Tuple[str, str]:
    """The process group's backend from each rank's ``(host, card UUID)``
    (UUID None for a rank on the CPU): ``("nccl", reason)`` when every rank
    has a card of its own, else ``("gloo", reason)``."""
    for rank, (host, uuid) in enumerate(placements):
        if uuid is None:
            return "gloo", "rank %d runs on the CPU" % rank
    first = {}
    for rank, place in enumerate(placements):
        if place in first:
            return "gloo", ("ranks %d and %d share card %s on %s, and NCCL "
                            "refuses two ranks on one card"
                            % (first[place], rank, place[1], place[0]))
        first[place] = rank
    return "nccl", "each of the %d ranks has a card of its own" % len(
        placements)


def _placement(device: torch.device) -> Tuple[str, Optional[str]]:
    if device.type != "cuda":
        return socket.gethostname(), None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return socket.gethostname(), str(
        torch.cuda.get_device_properties(index).uuid)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device=None):
    """Join the default process group (idempotent; a group the caller
    made counts as joined). ``device`` is this process's device: the
    given one, else its launched entry (``ADT_DEVICE``), else ``cuda``;
    a card that is not visible raises before the rendezvous."""
    global _INITIALIZED
    if initialized() or num_processes <= 1:
        return
    dev = resolve_device(device if device is not None
                         else const.ENV.ADT_DEVICE.val or None)
    host, port = coordinator_address.rsplit(":", 1)
    logging.info("joining the process group at %s (num_processes=%d, "
                 "process_id=%d, %s)", coordinator_address, num_processes,
                 process_id, dev)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=RENDEZVOUS_TIMEOUT)
    store.set("adt/placement/%d" % process_id,
              json.dumps(_placement(dev)))
    keys = ["adt/placement/%d" % r for r in range(num_processes)]
    store.wait(keys)
    placements = [tuple(json.loads(store.get(k))) for k in keys]
    backend, why = choose_backend(placements)
    logging.info("process group backend %s: %s", backend, why)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes,
                            timeout=RENDEZVOUS_TIMEOUT)
    _INITIALIZED = True


def reinit_distributed(coordinator_address: str, num_processes: int,
                       process_id: int, device=None):
    """Leave this process's default group and join a new one: the
    in-run elastic reconfiguration (``elastic.rejoin_process_set``). Every
    group of the old world is invalid afterwards; the caller holds its
    state and rebuilds its step for the new world. A world of one process
    joins no group, as :func:`init_distributed` joins none."""
    global _INITIALIZED
    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception as e:  # noqa: BLE001 — a dead peer may fail the
            # teardown; the local state is what matters
            logging.warning("destroy_process_group during the elastic "
                            "rejoin: %s (continuing)", e)
    _INITIALIZED = False
    if num_processes <= 1:
        logging.warning("elastic rejoin: a single process — no process "
                        "group")
        return
    logging.warning("elastic rejoin: joining the process group at %s "
                    "(num_processes=%d, process_id=%d)",
                    coordinator_address, num_processes, process_id)
    init_distributed(coordinator_address, num_processes, process_id, device)


def initialized() -> bool:
    """True once this process's distributed bring-up has happened: a
    group it joined here, one the caller made (torchrun, ``mp.spawn``),
    or an async-elastic bring-up (which deliberately joins none). Guards
    AutoDist's chief-launched flow against re-entry and against
    relaunching the processes of a job that already has them."""
    return (_INITIALIZED or _ELASTIC_STARTED
            or (dist.is_available() and dist.is_initialized()))


def mark_elastic_started():
    global _ELASTIC_STARTED
    _ELASTIC_STARTED = True


def caller_made_group() -> bool:
    """True when this process is in a group it did not join here: the
    caller made the job's processes and their group."""
    return not _INITIALIZED and dist.is_available() and dist.is_initialized()


def async_elastic() -> bool:
    """True for an async-elastic job: a restart budget without
    ``ADT_ELASTIC_SYNC``."""
    return (const.ENV.ADT_ELASTIC.val > 0
            and not const.ENV.ADT_ELASTIC_SYNC.val)


def maybe_init_distributed(device=None):
    """Worker-side join from the env the Coordinator set (the chief
    passes explicit arguments through ``Cluster.start``), after the
    elastic knobs are validated. Async-elastic processes never join: a
    group pins a fixed process set for the job's lifetime, while elastic
    async PS needs workers to come and go — they couple through the
    coordination service alone."""
    elastic.validate_elastic_knobs()
    if async_elastic():
        if const.ENV.ADT_EXTERNAL_LAUNCH.val:
            # external launchers own process lifecycles (no Coordinator to
            # relaunch anything) AND their strategy handoff is a collective
            # broadcast that requires the group — silently skipping the
            # join here would wedge the handoff confusingly
            raise ValueError(
                "ADT_ELASTIC requires the chief-launched flow; externally-"
                "launched jobs (ADT_EXTERNAL_LAUNCH) restart workers "
                "through their own launcher instead")
        logging.info("elastic mode: skipping the process group join "
                     "(process coupling is via the parameter service)")
        return
    if const.ENV.ADT_ELASTIC_INRUN.val and const.is_worker():
        _join_admitted(device)
        if initialized():
            return
    addr = const.ENV.ADT_COORDINATOR_ADDR.val
    n = const.ENV.ADT_NUM_PROCESSES.val
    if addr and n > 1:
        init_distributed(addr, n, const.ENV.ADT_PROCESS_ID.val, device)


def _join_admitted(device=None):
    """An in-run elastic worker's bring-up: a relaunched worker whose
    roster no longer holds it must not join the launch group (its
    environment is stale); it announces itself, waits until the chief
    admits it, and joins the epoch that does. Its rank comes from the
    roster expanded over the resource spec's entries of each node,
    which the chief passes in ``ADT_ELASTIC_ENTRIES``. Nothing happens
    before any epoch was published (the first launch)."""
    worker = const.ENV.ADT_WORKER.val
    info = elastic.wait_for_admission(worker)
    if info is None:
        return
    epoch, roster = info
    chief = const.ENV.ADT_COORDINATOR_ADDR.val.split(":")[0] or roster[0]
    if chief not in roster:
        chief = roster[0]
    procs = elastic.roster_processes(roster, elastic_entries(), chief)
    # this process is the LOCAL_RANK-th entry of its node
    me = (worker, int(os.environ.get("LOCAL_RANK", "0") or 0))
    if epoch > 1:
        membership = elastic.install(elastic.Membership(worker, epoch,
                                                        roster))
        membership.joined_late = True
        membership.entries = elastic_entries()
        # the members' reconfiguration barrier, which counts the whole
        # new world, this joiner included
        membership.barrier_reconf(epoch, len(procs))
    os.environ[const.ENV.ADT_NUM_PROCESSES.name_str] = str(len(procs))
    os.environ[const.ENV.ADT_PROCESS_ID.name_str] = str(procs.index(me))
    init_distributed(elastic.epoch_coordinator_address(epoch), len(procs),
                     procs.index(me), device)


def elastic_entries() -> dict:
    """Each node's number of device entries in the job's resource spec,
    as the chief wrote them into ``ADT_ELASTIC_ENTRIES``
    (``node=count,...``); empty when it is not set."""
    out = {}
    for part in const.ENV.ADT_ELASTIC_ENTRIES.val.split(","):
        if "=" in part:
            node, n = part.rsplit("=", 1)
            out[node] = int(n)
    return out


def broadcast_bytes(payload: Optional[bytes] = None) -> bytes:
    """Collective broadcast of a byte string from process 0 to every
    process of the default group.

    The strategy handoff for externally-launched jobs (all processes
    started together): unlike a shared filesystem, the job's own
    collective cannot deliver bytes from a *previous* run, so workers can
    never load a stale strategy. Must be called by ALL processes; only
    process 0's ``payload`` is used (others pass None)."""
    import numpy as np
    is_src = dist.get_rank() == 0
    if is_src and payload is None:
        raise ValueError("process 0 must provide the payload")
    # NCCL moves tensors on this process's card, gloo on the host
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    with tel.span("server_starter.broadcast_bytes", "launch"):
        length = torch.tensor([len(payload) if is_src else 0],
                              dtype=torch.int64, device=device)
        dist.broadcast(length, src=0)
        n = int(length.item())
        if n == 0:
            return b""
        buf = (torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
               if is_src else torch.empty(n, dtype=torch.uint8))
        buf = buf.to(device)
        dist.broadcast(buf, src=0)
        return bytes(buf.cpu().numpy())
