"""The elastic membership plane: epoch-fenced rosters for in-run shrink and
grow (PyTorch counterpart of ``autodist_tpu/runtime/elastic.py``).

Supervision without this module fails fast, relaunches a dead async-PS
worker, or restarts a sync job whole from its newest checkpoint
(``runtime/coordinator.py``). With ``ADT_ELASTIC_INRUN=1`` a sync job
reconfigures live instead: when a worker dies, the survivors tear down
their ``torch.distributed`` group, join a smaller one and train on from
their own copy of the state (shrink), then admit the relaunched worker
the same way (grow, its state a broadcast from the chief).

The safety core is the cluster epoch: an integer the chief publishes on
the coordination service with the membership roster, raised by every
membership change. Each process carries the epoch it joined under. A
worker that was declared dead but is only slow wakes up with a stale
epoch, and every mutating write of the control plane, the PS wire and the
savers (they call :func:`maybe_fence`) raises the typed :class:`FencedOut`
before it can touch state its replacement owns:

- the same epoch (or no membership installed): the write proceeds;
- a newer epoch whose roster holds this worker: it proceeds (a lagging
  survivor, which reconfigures at its next boundary);
- a newer epoch whose roster does not: ``FencedOut`` (a zombie).

Protocol keys (on the native coordination service):

====================================  =======================================
``elastic/epoch``                      the authoritative epoch (int as str)
``elastic/roster``                     comma-joined node addresses for it
``elastic/reconf/<epoch>``             the members' reconfiguration barrier
``elastic/ack/<epoch>/<worker>``       a member's "reconfigured" ack
``elastic/join/<worker>``              a joiner's admission announcement
====================================  =======================================

The roster is written before the epoch: readers key on the epoch, so the
pair is consistent once the epoch lands.

Where the port differs from the JAX module. A roster holds node
addresses; a node of the resource spec runs one process a device entry
(``runtime/cluster.py``), so :func:`roster_processes` expands the roster
into ranks in one order on every member. The state snapshot
(:func:`snapshot_runner_state`) stays on the card: a survivor of a
data-parallel plan holds whole replicas there, so a shrink moves nothing
between processes; only a grow's joiner receives the chief's state, by
broadcast (:func:`broadcast_state` and the ``init_state`` it feeds). A
plan whose state lies sharded across processes (ZeRO moments,
partitioned or model-parallel variables) has no whole copy on any
survivor: the snapshot is None and the rebuild restores the newest
checkpoint instead (``AutoDist._elastic_reconfigure``).
"""
import os
import pickle
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging

EPOCH_KEY = "elastic/epoch"
ROSTER_KEY = "elastic/roster"


# --------------------------------------------------------------- typed errors


class ElasticConfigError(ValueError):
    """An elastic knob holds a value that cannot mean anything.

    Raised at bring-up instead of silently disabling elasticity: a typo'd
    ``ADT_ELASTIC=-1`` (or ``ADT_ELASTIC=yes``) that quietly parsed to
    "off" would surface months later as a job that fail-fasts when its
    operator believed it was elastic."""

    def __init__(self, knob: str, raw: str, why: str):
        self.knob = knob
        self.raw = raw
        super().__init__(
            "invalid %s=%r: %s (unset it, or set a valid value)"
            % (knob, raw, why))


class FencedOut(Exception):
    """A stale-epoch write was rejected by the membership fence.

    Deliberately not an ``OSError``/``RuntimeError``: the transport
    handlers (retry loops, best-effort writers) swallow those, and a
    fenced process must stop, since a newer incarnation owns its
    identity."""

    def __init__(self, op: str, mine: int, current: int,
                 worker: str = "", roster: Sequence[str] = ()):
        self.op = op
        self.my_epoch = mine
        self.current_epoch = current
        self.worker = worker
        self.roster = list(roster)
        super().__init__(
            "%s fenced out: this process carries cluster epoch %d but the "
            "membership plane is at epoch %d and its roster %s no longer "
            "includes %r — a newer incarnation owns this identity; refusing "
            "the write" % (op, mine, current, self.roster, worker))


# ------------------------------------------------------------ knob validation

_BOOL_RAW = ("", "0", "1", "False", "false", "True", "true")


def validate_elastic_knobs() -> Tuple[int, bool, bool]:
    """Parse the elastic bring-up knobs loudly; returns ``(budget,
    sync_elastic, inrun)``, with the JAX package's checks and messages.
    ``const.ENV``'s parsers are permissive (any unknown string is a
    truthy bool; ``int()`` raises a bare ``ValueError`` naming no knob),
    and elasticity is a safety feature."""
    raw = os.environ.get(const.ENV.ADT_ELASTIC.name_str)
    if raw is None:
        budget = 0
    else:
        try:
            budget = int(raw)
        except ValueError:
            raise ElasticConfigError(
                const.ENV.ADT_ELASTIC.name_str, raw,
                "must be an integer restart budget (0 disables elasticity)"
            ) from None
        if budget < 0:
            raise ElasticConfigError(
                const.ENV.ADT_ELASTIC.name_str, raw,
                "a negative restart budget is meaningless")
    out = [budget]
    for env in (const.ENV.ADT_ELASTIC_SYNC, const.ENV.ADT_ELASTIC_INRUN):
        raw = os.environ.get(env.name_str)
        if raw is not None and raw not in _BOOL_RAW:
            raise ElasticConfigError(
                env.name_str, raw,
                "must be one of %s" % (_BOOL_RAW,))
        out.append(env.val)
    if out[2] and not out[1]:
        raise ElasticConfigError(
            const.ENV.ADT_ELASTIC_INRUN.name_str, "1",
            "in-run reconfiguration is the sync-elastic upgrade path and "
            "needs ADT_ELASTIC_SYNC=1 at bring-up")
    if out[2] and out[0] <= 0:
        raise ElasticConfigError(
            const.ENV.ADT_ELASTIC_INRUN.name_str, "1",
            "needs a positive ADT_ELASTIC budget (each in-run "
            "reconfiguration spends one restart)")
    return out[0], out[1], out[2]


# ------------------------------------------------------------- epoch protocol


def read_epoch(client) -> Optional[Tuple[int, List[str]]]:
    """The service's ``(epoch, roster)``, or None when no epoch was ever
    published (a job that is not in-run elastic, or a restarted
    service)."""
    raw = client.get(EPOCH_KEY)
    if not raw:
        return None
    try:
        epoch = int(raw)
    except ValueError:
        return None
    roster_raw = client.get(ROSTER_KEY) or ""
    return epoch, [a for a in roster_raw.split(",") if a]


def publish_epoch(client, epoch: int, roster: Sequence[str]):
    """Chief side: commit a membership change, the roster first, then the
    epoch (the commit point readers key on). Refuses to move backwards: a
    lower epoch published again would un-fence every zombie at once."""
    cur = read_epoch(client)
    if cur is not None and epoch <= cur[0]:
        raise ValueError(
            "elastic epoch must increase monotonically: refusing to "
            "publish epoch %d over current %d" % (epoch, cur[0]))
    client.put(ROSTER_KEY, ",".join(roster))
    client.put(EPOCH_KEY, str(epoch))
    tel.gauge_set("elastic.epoch", float(epoch))
    tel.instant("elastic.epoch_published", "elastic", epoch=epoch,
                world=len(roster))
    logging.warning("elastic: published cluster epoch %d (roster: %s)",
                    epoch, ",".join(roster))


def announce_join(client, worker: str):
    """A relaunched worker asks for admission; the chief's watchdog
    answers with a grown roster at the next epoch."""
    client.put("elastic/join/%s" % worker, repr(time.time()))


def pending_join(client, worker: str, freshness_s: float = 600.0) -> bool:
    """True while ``worker`` holds a fresh admission announcement."""
    raw = client.get("elastic/join/%s" % worker)
    if not raw:
        return False
    try:
        ts = float(raw)
    except ValueError:
        return False
    return ts > 0 and time.time() - ts < freshness_s


def clear_join(client, worker: str):
    client.put("elastic/join/%s" % worker, "0")


def admit_worker(client, worker: str) -> int:
    """Chief-side admission as one move: publish the next epoch with
    ``worker`` appended to the current roster and consume its join
    announcement. Returns the new epoch; the current one when the worker
    is already a member. Raises ``RuntimeError`` when no epoch was ever
    published (there is no roster to grow)."""
    info = read_epoch(client)
    if info is None:
        raise RuntimeError(
            "admit_worker(%r): no membership epoch published — "
            "publish_epoch a launch roster first" % worker)
    epoch, roster = info
    if worker in roster:
        return epoch
    publish_epoch(client, epoch + 1, list(roster) + [worker])
    clear_join(client, worker)
    return epoch + 1


def gc_worker_marks(client, worker: str):
    """Watchdog hygiene: scrub every liveness record a dead incarnation of
    ``worker`` may have left — its heartbeat (GOODBYE), its ``compiling``
    grace mark and its ``straggler`` slow-but-alive mark (tombstoned to
    "0", which the readers treat as cleared). Otherwise a dead
    incarnation's fresh-looking marks could satisfy — or poison — the
    watchdog's freshness checks against the next incarnation."""
    for op in (lambda: client.goodbye(worker),
               lambda: client.put("compiling/%s" % worker, "0"),
               lambda: client.put("straggler/%s" % worker, "0")):
        try:
            op()
        except (OSError, RuntimeError):
            pass  # hygiene is best-effort; marks also age out


# ---------------------------------------------------------------- membership


def _service_host() -> str:
    return const.ENV.ADT_COORDINATOR_ADDR.val.split(":")[0] or "127.0.0.1"


class Membership:
    """One process's view of the membership plane: its worker name (its
    node address), the epoch it operates under and that epoch's roster.
    It owns a coordination client of its own, so that a fence check never
    shares a socket with the operation it fences."""

    def __init__(self, worker: str, epoch: int, roster: Sequence[str],
                 client_factory: Optional[Callable] = None,
                 fence_cache_s: float = 0.05):
        self.worker = worker
        self.epoch = epoch
        self.roster = list(roster)
        self._factory = client_factory or self._default_factory
        self._client = None
        self._lock = threading.Lock()
        # a fence check inside the window reuses the last (epoch, roster)
        # instead of two more reads a write; 50 ms is far inside the
        # protocol's own race window (detecting a death takes longer), and
        # 0 makes every check exact
        self._fence_cache_s = fence_cache_s
        self._cached: Optional[Tuple[int, List[str]]] = None
        self._cached_at = float("-inf")
        self.joined_late = False  # admitted by grow-on-join, not launched
        # each node's number of device entries (processes) in the job's
        # resource spec; a node absent from it runs one process
        self.entries: dict = {}
        # the wall-clock deadline of an announced departure of this
        # worker (runtime/preemption.py): until it passes, the fence lets
        # the leaver finish its last boundary
        self._departure_until = 0.0

    @staticmethod
    def _default_factory():
        from autodist_tpu_torch.runtime.coordination import CoordinationClient
        return CoordinationClient(_service_host(),
                                  const.ENV.ADT_COORDSVC_PORT.val,
                                  timeout=const.ENV.ADT_RPC_TIMEOUT_S.val
                                  or None)

    def _with_client(self, fn):
        with self._lock:
            if self._client is None:
                self._client = self._factory()
            try:
                return fn(self._client)
            except OSError:
                try:
                    self._client.close()
                except OSError:
                    pass
                self._client = None
                raise

    def peek(self, fresh: bool = False) -> Optional[Tuple[int, List[str]]]:
        """The service's current (epoch, roster); None when it is
        unreachable or nothing was published. ``fresh`` reads past the
        cache."""
        now = time.monotonic()
        if (not fresh and self._cached is not None
                and now - self._cached_at < self._fence_cache_s):
            return self._cached
        try:
            info = self._with_client(read_epoch)
        except OSError:
            return None
        if info is not None:
            self._cached, self._cached_at = info, now
        return info

    def world(self, roster: Sequence[str]) -> int:
        """The number of processes of ``roster`` (its nodes' entries)."""
        return sum(max(1, int(self.entries.get(a, 1))) for a in roster)

    def expect_departure(self, deadline: float):
        """An announced departure of this worker: the fence stays open for
        it until ``deadline`` even after an epoch excludes it, since the
        leaver runs its last boundary alive while its peers meet it in
        collectives. Past the deadline a late incarnation is fenced
        again."""
        self._departure_until = max(self._departure_until, float(deadline))

    def fence(self, op: str):
        """Raise :class:`FencedOut` when this process's epoch is stale and
        the current roster no longer holds it. With the service out of
        reach the write proceeds: the fence guards against zombies, and a
        control-plane blip must not become a training outage."""
        info = self.peek()
        if info is None:
            return
        epoch, roster = info
        if time.time() < self._departure_until:
            return  # an announced leaver finishing its last boundary
        if epoch > self.epoch and self.worker not in roster:
            from autodist_tpu_torch.telemetry import blackbox
            tel.counter_add("elastic.fenced_writes")
            tel.instant("elastic.fenced_write", "elastic", op=op,
                        mine=self.epoch, current=epoch, worker=self.worker)
            blackbox.record("elastic.fenced_write", op=op, mine=self.epoch,
                            current=epoch, worker=self.worker)
            raise FencedOut(op, self.epoch, epoch, self.worker, roster)

    def adopt(self, epoch: int, roster: Sequence[str]):
        """This process finished reconfiguring under ``epoch``."""
        self.epoch = epoch
        self.roster = list(roster)
        self._cached = (epoch, list(roster))
        self._cached_at = time.monotonic()
        tel.gauge_set("elastic.epoch", float(epoch))

    def barrier_reconf(self, epoch: int, num_workers: int):
        """The members' reconfiguration barrier: every caller sits at a
        step boundary, so nobody tears its group down while a peer is
        still in a collective of it. It blocks by design (members arrive
        up to a step apart), so the per-RPC deadline is lifted for it."""
        def call(c):
            c.set_rpc_timeout(None)
            try:
                return c.barrier("elastic/reconf/%d" % epoch, num_workers)
            finally:
                try:
                    c.set_rpc_timeout(const.ENV.ADT_RPC_TIMEOUT_S.val
                                      or None)
                except OSError:
                    pass
        self._with_client(call)

    def ack(self, epoch: int):
        """Record that this worker finished the ``epoch`` reconfigure (the
        chief's escalation timer waits for these)."""
        self._with_client(
            lambda c: c.put("elastic/ack/%d/%s" % (epoch, self.worker), "1"))

    def close(self):
        with self._lock:
            if self._client is not None:
                try:
                    self._client.close()
                except OSError:
                    pass
                self._client = None


_current: Optional[Membership] = None


def install(membership: Membership) -> Membership:
    """Install the process-ambient membership (one a process: the fence
    hooks of the resilient client, the PS wire and the savers read it)."""
    global _current
    _current = membership
    tel.gauge_set("elastic.epoch", float(membership.epoch))
    return membership


def current() -> Optional[Membership]:
    return _current


def clear():
    global _current
    if _current is not None:
        _current.close()
    _current = None


def maybe_fence(op: str):
    """The fence hook of the write paths: a no-op (one global read) unless
    a membership is installed in this process."""
    m = _current
    if m is not None:
        m.fence(op)


# -------------------------------------------------------- the process layout


def roster_layout(roster: Sequence[str],
                  chief: Optional[str] = None) -> List[str]:
    """The roster's nodes in process order: the chief first, the rest
    sorted — every member computes the same order with no round trip (the
    order ``Cluster`` gives the nodes of a resource spec)."""
    members = list(dict.fromkeys(roster))
    if chief is None:
        chief = members[0] if members else ""
    if chief not in members:
        raise ValueError("roster %s does not contain chief %r"
                         % (members, chief))
    return [chief] + sorted(a for a in members if a != chief)


def spec_entries(spec) -> dict:
    """Each node of a resource spec with its number of device entries
    (one process each), the ``entries`` :func:`roster_processes` reads."""
    out: dict = {}
    for d in spec.devices:
        out[d.host] = out.get(d.host, 0) + 1
    return out


def roster_processes(roster: Sequence[str], entries: dict,
                     chief: Optional[str] = None) -> List[Tuple[str, int]]:
    """The processes of a roster, in rank order: ``(node, local rank)``
    for each device entry of each node, the nodes in
    :func:`roster_layout`'s order and a node's entries in list order.
    ``entries`` maps each node to its number of device entries (the
    resource spec's; a node absent from it runs one process). Every member
    expands the roster with this one rule, so they agree on the ranks."""
    return [(node, i) for node in roster_layout(roster, chief)
            for i in range(max(1, int(entries.get(node, 1))))]


def epoch_coordinator_address(epoch: int) -> str:
    """The rendezvous address of ``epoch``'s process group. Epoch 1 (the
    launch) is the configured ``ADT_COORDINATOR_ADDR``; each later epoch
    binds another port, ``base - ((epoch - 1) mod 89)``, so that a store
    of an earlier epoch that is still draining cannot collide with it,
    and every member derives the same port from the shared epoch."""
    addr = const.ENV.ADT_COORDINATOR_ADDR.val
    if addr and ":" in addr:
        host, port = addr.rsplit(":", 1)
        base = int(port)
    else:
        host, base = "127.0.0.1", const.DEFAULT_COORDINATOR_PORT
    return "%s:%d" % (host, base - ((epoch - 1) % 89))


def rejoin_process_set(roster: Sequence[str], epoch: int, entries: dict,
                       chief: Optional[str] = None):
    """Leave this process's ``torch.distributed`` group and join the
    ``epoch`` group of ``roster`` (the in-run half of what the whole-job
    restart achieves by replacing the process). Call only at a step
    boundary after the reconfiguration barrier: every group of the old
    world is gone afterwards. This process is the ``LOCAL_RANK``-th entry
    of its node (``ADT_WORKER``, else the chief's)."""
    from autodist_tpu_torch.runtime import server_starter
    procs = roster_processes(roster, entries, chief)
    me = (const.ENV.ADT_WORKER.val or procs[0][0],
          int(os.environ.get("LOCAL_RANK", "0") or 0))
    if me not in procs:
        raise FencedOut("rejoin", -1, epoch, me[0], [p[0] for p in procs])
    os.environ[const.ENV.ADT_NUM_PROCESSES.name_str] = str(len(procs))
    os.environ[const.ENV.ADT_PROCESS_ID.name_str] = str(procs.index(me))
    server_starter.reinit_distributed(
        coordinator_address=epoch_coordinator_address(epoch),
        num_processes=len(procs), process_id=procs.index(me))


# ------------------------------------------------- worker-side admission wait


def wait_for_admission(worker: str, timeout_s: float = 600.0
                       ) -> Optional[Tuple[int, List[str]]]:
    """A relaunched worker's bring-up: announce a join and poll until an
    epoch's roster holds it, then return ``(epoch, roster)`` (the caller
    joins that epoch's group). None when no epoch was ever published (the
    first launch: join from the environment instead)."""
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    try:
        client = CoordinationClient(_service_host(),
                                    const.ENV.ADT_COORDSVC_PORT.val)
    except OSError:
        return None
    try:
        info = read_epoch(client)
        if info is None:
            return None  # before any epoch: the normal launch path
        epoch, roster = info
        if worker in roster:
            return epoch, roster  # already a member (a fast relaunch)
        announce_join(client, worker)
        logging.warning("elastic: %s announced itself for admission "
                        "(current epoch %d)", worker, epoch)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            info = read_epoch(client)
            if info is not None and worker in info[1]:
                logging.warning("elastic: %s admitted at epoch %d",
                                worker, info[0])
                return info
            time.sleep(0.2)
        raise TimeoutError(
            "elastic admission: %s was not admitted within %.0fs"
            % (worker, timeout_s))
    finally:
        try:
            client.close()
        except OSError:
            pass


def _skeleton(tree):
    """``tree`` with each tensor replaced by ``(shape, dtype name)``."""
    return pytree.tree_map(
        lambda t: ("__tensor__", tuple(t.shape), str(t.dtype))
        if isinstance(t, torch.Tensor) else t, tree)


def _placeholder(skel, device):
    """The tensors of a :func:`_skeleton`, allocated on ``device``
    (their values come from the broadcast that follows)."""
    def make(leaf):
        if isinstance(leaf, tuple) and len(leaf) == 3 and \
                leaf[0] == "__tensor__":
            return torch.empty(leaf[1], dtype=getattr(
                torch, leaf[2].replace("torch.", "")), device=device)
        return leaf
    return pytree.tree_map(make, skel,
                           is_leaf=lambda x: isinstance(x, tuple)
                           and len(x) == 3 and x[0] == "__tensor__")


def broadcast_state(snapshot: Optional[dict], device) -> dict:
    """The state handoff of a grow: process 0 (the chief, a survivor)
    holds ``snapshot``; every member of the new group calls this and gets
    a snapshot of the same structure. Its description (the trees with
    each tensor's shape and dtype, the step) goes as one byte broadcast,
    and the compressor/sentinel state's tensors as tensor broadcasts; a
    joiner's params and optimizer state come as placeholders on
    ``device``, which :func:`adopt_snapshot`'s ``init_state`` fills from
    rank 0 with its own broadcast — so the bulk of the state crosses the
    processes once, tensor by tensor, with no host pickle of it. None
    for every member when the chief's snapshot is None (they all restore
    the newest checkpoint, whose collectives then match)."""
    import torch.distributed as dist
    from autodist_tpu_torch.runtime import server_starter
    rank0 = dist.get_rank() == 0
    payload = (pickle.dumps(_skeleton(snapshot)) if rank0 else None)
    skel = pickle.loads(server_starter.broadcast_bytes(payload))
    if skel is None:
        return None  # no whole copy on the chief: every member restores
    out = snapshot if rank0 else _placeholder(skel, device)
    for t in pytree.tree_leaves(out.get("sync_state")):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=0)
    return out


# ------------------------------------------- the state snapshot and adoption


def snapshot_runner_state(runner) -> Optional[dict]:
    """The runner's state assembled from this process's own copy, with no
    collective (a peer of the old group may be dead) and no disk: the
    params and the optimizer state whole in their original layout, on the
    card (the step writes its state in place and the old step never runs
    again, so the tensors are kept, not copied); the host-PS variables
    and their state from the store, whose mirror every rank keeps whole
    under sync PS; the compressor and sentinel state with the old world's
    replica count. None when some state has no whole copy on this process
    (ZeRO-sharded moments, partitioned or model-parallel variables at
    more than one replica): the rebuild then restores the newest
    checkpoint."""
    state = runner.state
    if state is None:
        return None
    dstep = runner.distributed_step
    n = dstep.num_replicas
    if n > 1 and (dstep.layouts or dstep.mp_layouts or dstep.zero_syncs):
        logging.warning(
            "elastic: the state is sharded across the processes (%s) — the "
            "in-run rebuild falls back to the newest checkpoint",
            ", ".join(k for k, v in (("partitioned", dstep.layouts),
                                     ("model-parallel", dstep.mp_layouts),
                                     ("ZeRO", dstep.zero_syncs)) if v))
        return None
    store = dstep.ps_store
    if store is not None and store.serving:
        logging.warning("elastic: an async PS store is not a whole local "
                        "copy — the rebuild falls back to the newest "
                        "checkpoint")
        return None
    try:
        params = dstep.gather_params(state)
        opt_state = dstep.gather_opt_state(state)
    except Exception as e:  # noqa: BLE001 — a store that cannot be read
        logging.warning("elastic: the state is not locally whole (%s) — the "
                        "rebuild falls back to the newest checkpoint", e)
        return None
    sync = state.sync_state or {}
    # replica-identical leaves keep their value (the sentinel's scale);
    # per-rank ones (compressor residuals) cannot be whole at N > 1 and
    # reset with the topology; at N = 1 the whole tree is this rank's row
    sync_host = ({k: v for k, v in sync.items() if k == "sentinel"}
                 if n > 1 else sync)
    sync_host = pytree.tree_map(
        lambda t: t.detach()[None].expand((n,) + tuple(t.shape)).clone()
        if isinstance(t, torch.Tensor) else t, sync_host)
    return {"step": int(state.step), "params": params,
            "opt_state": opt_state, "sync_state": sync_host,
            "mesh": {"replicas": n}}


def _align_sync_state(sync_host, saved_mesh, dstep) -> Tuple[dict, list]:
    """Align a snapshot's sync state (each leaf ``[N_old, ...]``, row r
    rank r's, as checkpoints hold it) to the rebuilt step's replica count:
    a leaf of the new shape carries over as it is, a ZeRO-sharded
    optimizer shard is re-laid for the new count
    (``relayout_zero_sync_leaf``, the math of the checkpoints'
    cross-topology restore), a replica-identical scalar (the sentinel's
    scale, an optimizer count) is repeated a row a rank, and any other
    leaf (a compressor residual) resets to a fresh one. Returns the
    aligned ``[N_new, ...]`` tree and the names of the leaves reset or
    absent."""
    from autodist_tpu_torch.kernel.graph_transformer import (_map_named,
                                                             _named_leaves)
    from autodist_tpu_torch.kernel.synchronization.zero_synchronizer \
        import relayout_zero_sync_leaf
    n_new = dstep.num_replicas
    n_old = int((saved_mesh or {}).get("replicas", 1))
    template = dstep._sync_state_init()
    want = _named_leaves(template)
    have = _named_leaves(sync_host or {})
    zero = dstep.zero_syncs
    out, reset = {}, []
    for name, tmpl in want.items():
        shape = (n_new,) + tuple(tmpl.shape)
        got = have.get(name)
        if got is not None:
            got_np = got.detach().cpu().numpy() \
                if isinstance(got, torch.Tensor) else np.asarray(got)
            if got_np.shape == shape:
                out[name] = torch.from_numpy(got_np.copy())
                continue
            var = next((v for v in sorted(zero, key=len, reverse=True)
                        if name.startswith("zero/%s/" % v)), None)
            laid = None
            if var is not None and got_np.ndim >= 1 \
                    and got_np.shape[0] == n_old:
                laid = relayout_zero_sync_leaf(got_np, n_old, zero[var],
                                               n_new)
            elif got_np.ndim == 1 and tmpl.dim() == 0:
                laid = np.broadcast_to(got_np[:1], (n_new,)).copy()
            if laid is not None and tuple(laid.shape) == shape:
                out[name] = torch.from_numpy(np.ascontiguousarray(laid))
                continue
        out[name] = tmpl.detach().cpu()[None].expand(shape).clone()
        reset.append(name)
    dropped = sorted(set(have) - set(want))
    if dropped or [r for r in reset if r in have]:
        logging.warning(
            "elastic: sync-state leaves reset to a fresh init or dropped "
            "across the topology change (topology-bound transients): %s",
            ([r for r in reset if r in have] + dropped)[:4])
    return _map_named(lambda name, _: out[name], template), reset


def adopt_snapshot(runner, snapshot: dict):
    """Place a snapshot onto the runner's (rebuilt) step through
    ``init_state``, the path a checkpoint restore takes, minus the disk:
    with more than one replica it broadcasts rank 0's params and
    optimizer state, so every rank adopts the chief's. The sync state is
    aligned to the new replica count (:func:`_align_sync_state`); a ZeRO
    shard it cannot carry is rebuilt from the snapshot's whole optimizer
    state instead. The step count is the snapshot's."""
    import dataclasses
    dstep = runner.distributed_step
    aligned, reset = _align_sync_state(snapshot.get("sync_state"),
                                       snapshot.get("mesh"), dstep)
    zero_reset = any(r.startswith("zero/") for r in reset)
    state = dstep.init_state(snapshot["params"], snapshot["opt_state"],
                             None if zero_reset else aligned)
    if zero_reset and "sentinel" in aligned and \
            "sentinel" in state.sync_state:
        state.sync_state["sentinel"]["lr_scale"].fill_(
            float(aligned["sentinel"]["lr_scale"].reshape(-1)[0]))
    runner.state = dataclasses.replace(state,
                                       step=int(snapshot.get("step") or 0))
    runner.notify_state_restored()
    return runner.state
