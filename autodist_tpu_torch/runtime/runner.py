"""Runner — owns a DistributedStep and its state, and executes programs.

PyTorch counterpart of ``autodist_tpu/runtime/runner.py``, one runner a
replica (a process of the ``torch.distributed`` group, or the process
alone): :meth:`Runner.init` places the parameters and the optimizer state
on the device, equal in every replica; :meth:`Runner.run` takes one
training step on the host-global batch, of which each replica trains on
its own rows, and returns the metrics averaged over the replicas, the
same on every rank;
:meth:`Runner.fit` and :meth:`Runner.evaluate` loop over batches;
:meth:`Runner.step_stats` reports step wall times; :meth:`Runner.predict`
runs a forward fetch program, and the serving engines (``serving/``)
drive the runner's ``distributed_step`` and ``remapper``. Checkpoints
(``checkpoint/``) are written by ``fit(save_every=...)`` and restored by
``init`` under ``ADT_AUTO_RESUME``. After every dispatch the control
plane runs (:meth:`Runner._after_dispatch`): a stale plan (``staleness``
s > 0) at more than one process reports its step to the coordination
service and waits while it is more than s steps ahead of the slowest
process (the ``runner.barrier`` span); an async job at more than one
process heartbeats, and every step checks this process's async-PS owner
loops. A runner that talks to the service says goodbye when it closes,
or when the interpreter exits. :meth:`Runner.run_superstep` and
``fit(fuse_steps=k, metrics_every=n)`` run fused supersteps of k
microsteps, one dispatch each (on ``cuda``, one replay of a CUDA graph:
``kernel/superstep.py``), with the metrics read back every n supersteps.
For the chief's heartbeat watchdog (``runtime/coordinator.py``), the
first dispatch carries a one-shot ``compiling`` mark: the first use of a
kernel whose build is not cached, the CUDA context and a superstep's
graph capture may keep a worker silent for longer than the heartbeat
window. Under a sync-elastic job a collective that fails on the chief
goes to the Coordinator before it propagates
(``coordinator.collective_failed``).
The training health sentinel (``runtime/sentinel.py``, armed by
``AutoDist.build(sentinel=)`` or ``ADT_SENTINEL``) takes each microstep's
verdict from the metrics as they are read back (the handle's observer)
and acts only at safe points, before a dispatch or at a readback
boundary of ``fit``: a rollback restores the newest healthy checkpoint
and replaces the state; the savers ask :meth:`Runner.sentinel_save_veto`
and :meth:`Runner.sentinel_healthy`; every restore re-syncs the LR scale
(:meth:`Runner.notify_state_restored`).
:class:`WrappedSession` is the session facade
``AutoDist.create_distributed_session`` returns.

The in-run elastic plane (``runtime/elastic.py``, ``ADT_ELASTIC_INRUN``):
with a membership installed, step boundaries poll the cluster epoch
(:meth:`Runner._poll_epoch`); a newer one parks a reconfigure that runs
before the next dispatch (:meth:`Runner._maybe_reconfigure`: the members'
barrier, the state snapshot on the card, the wired handler's rejoin and
rebuild — ``AutoDist._elastic_reconfigure`` — and the ack). Where the
JAX runtime hangs in a collective a dead peer never enters, gloo raises:
a step whose collective fails waits for the chief's shrink epoch,
reconfigures and runs again on the new world (:meth:`Runner.run`), when
the step had not begun to write its state (``writes_begun``); a torn
step restores the newest checkpoint in the rebuild instead.

The preemption plane (``runtime/preemption.py``): every Runner arms a
``PreemptionGuard``. A SIGTERM, a maintenance file or an operator drain
parks a notice that the step boundaries consume — the cluster-agreed,
deadline-budgeted rescue checkpoint, then the planned handoff: the
survivors reconfigure from a snapshot staged before the
``elastic.reconfigure`` span (:meth:`Runner._prestage_snapshot`, the
span's ``planned`` flag) and the leaver departs through
``PlannedDeparture`` instead of the zombie fence-out. At more than one
replica a reconfigure to an epoch without the announced leaver is held
until the plan's step, so the shrink lands at one boundary on every
member. Every Runner also arms the flight recorder
(``telemetry/blackbox.py``) and feeds each dispatch's wall time to the
straggler detector (``telemetry/goodput.py``), whose flag it marks on the
coordination service for the chief's watchdog
(:meth:`Runner._observe_straggler`).

Profiling (``telemetry/cluster.py``): ``Runner(tracing=True)`` (from
``AutoDist(tracing=True)``) runs the first dispatch under
``torch.profiler``, and a fleet window (``ADT_PROFILE_STEPS=N:M``, or the
flag the chief posts on the coordination service, polled at
``ADT_PROFILE_POLL_S``) the dispatches of steps N to M; each profile
stops once the device has finished its last step and is written as
Chrome JSON under ``const.DEFAULT_TRACE_DIR``. With tracing on
(``ADT_TRACE``), :meth:`Runner.goodput_report` decomposes the recorded
wall time into buckets (``telemetry/goodput.py``).
"""
import atexit
import collections
import contextlib
import itertools
import os
import statistics
import time
import weakref
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from autodist_tpu_torch import const
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     job_processes)
from autodist_tpu_torch.runtime.resilience import ResilientCoordinationClient
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.train_state import TrainState
from autodist_tpu_torch.utils import logging

# how long a step whose collective failed at more than one replica waits
# for the chief's shrink epoch before the error goes on (the chief
# publishes it once its process watcher has seen the death, which gloo's
# errors precede by milliseconds)
INRUN_EPOCH_WAIT_S = 30.0


def _structure(tree) -> tuple:
    """Each tensor leaf of ``tree`` by path, shape, dtype and device: all
    of a tree that a recorded program depends on."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    return tuple((pytree.keystr(path), tuple(t.shape), str(t.dtype),
                  str(t.device)) for path, t in flat
                 if isinstance(t, torch.Tensor))


class _Rerun(Exception):
    """Internal: the in-run plane reconfigured this process after its
    step's collective failed; the step runs again on the new world."""


class MetricsHandle:
    """Device-resident step metrics from ``Runner.run(sync=False)`` or
    ``Runner.run_superstep``: the step returned as soon as its work was
    queued, and the device-to-host copy waits until :meth:`result` (or
    any mapping access, such as ``handle["loss"]``), so a loop of steps
    need not wait on the device between them, and one readback at a
    ``metrics_every`` boundary materializes many steps' metrics."""

    __slots__ = ("_device", "_remapper", "_host", "microsteps", "_owner",
                 "_observer")

    def __init__(self, device_metrics, remapper, microsteps: int = 1,
                 owner=None, observer=None):
        self._device = device_metrics
        self._remapper = remapper
        self._host = None
        self.microsteps = microsteps
        # the Runner whose ``readbacks`` count this handle's readback
        self._owner = owner
        # called once a MICROSTEP, in order, when the handle is read back
        # (the sentinel's intake of its verdicts); consumed by the first
        # read, so reading again observes nothing twice
        self._observer = observer

    @property
    def materialized(self) -> bool:
        return self._host is not None

    def result(self):
        """Host metrics (forces the device-to-host copy on first call).
        Superstep handles return stacked ``[k, ...]`` leaves."""
        if self._host is None:
            with tel.span("runner.readback", "runner",
                          microsteps=self.microsteps):
                self._host = self._remapper.remap_fetch(self._device)
            self._device = None
            if self._owner is not None:
                self._owner.readbacks += 1
            tel.counter_add("runner.readbacks")
            tel.counter_add("runner.d2h_bytes", sum(
                getattr(leaf, "nbytes", 0)
                for leaf in pytree.tree_leaves(self._host)))
            if self._observer is not None:
                # consumed BEFORE calling: unstack() reads result() again
                obs, self._observer = self._observer, None
                for m in self.unstack():
                    obs(m)
        return self._host

    @staticmethod
    def concat(handles: list) -> "MetricsHandle":
        """One handle over consecutive unread handles of one runner: their
        device metrics concatenated along the microstep dim, on the
        device, so that reading them back is one device-to-host copy.
        Handles whose metrics cannot be concatenated so (a host value
        among them, another structure) come back as they are, in a
        list."""
        if len(handles) == 1:
            return handles[0]
        if any(h._observer != handles[0]._observer for h in handles):
            return handles  # (bound methods of one sentinel are equal)
        trees, spec = [], None
        for h in handles:
            leaves, sp = pytree.tree_flatten(h._device)
            if h.materialized or (spec is not None and sp != spec) or \
                    not all(isinstance(t, torch.Tensor) for t in leaves):
                return handles
            spec = sp
            trees.append(leaves if h.microsteps > 1
                         else [t[None] for t in leaves])
        cat = [torch.cat(parts) for parts in zip(*trees)]
        return MetricsHandle(pytree.tree_unflatten(cat, spec),
                             handles[0]._remapper,
                             sum(h.microsteps for h in handles),
                             handles[0]._owner, handles[0]._observer)

    def unstack(self) -> list:
        """Per-microstep host metrics: ``microsteps`` dicts of unstacked
        leaves (a length-1 list for a plain step's handle)."""
        host = self.result()
        if self.microsteps == 1:
            return [host]
        return [pytree.tree_map(lambda a, i=i: np.asarray(a)[i], host)
                for i in range(self.microsteps)]

    def __getitem__(self, key):
        return self.result()[key]

    def __iter__(self):
        return iter(self.result())

    def keys(self):
        return self.result().keys()

    def items(self):
        return self.result().items()

    def __repr__(self):
        return "MetricsHandle(microsteps=%d, %s)" % (
            self.microsteps,
            "materialized" if self.materialized else "device-resident")


class Runner:
    """Owns a DistributedStep + TrainState and runs its programs."""

    # recent per-step wall times kept for the steady_* percentiles
    _RECENT_WINDOW = 1024
    # recorded programs kept (lowered_text); a full-width text is ~1 MB
    _PROGRAMS_KEPT = 8

    def __init__(self, distributed_step, sentinel=None,
                 tracing: bool = False,
                 hbm_budget_bytes: Optional[float] = None):
        self._dstep = distributed_step
        # per-device HBM budget of memory_report(): AutoDist passes the
        # resource spec's card capacity; a bare Runner has none, and
        # memory_report only estimates (no ADT501/502 gate)
        self._hbm_budget = hbm_budget_bytes
        # ADT_SNAPSHOT at build: the first step writes the 3-transformed
        # stage (the 0-original stage was written by the transform)
        from autodist_tpu_torch.utils import visualization_util
        self._snapshot_due = visualization_util.enabled()
        # the recorded programs (lowered_text), by what determines them:
        # the arguments and the structure of the state and the feed (a
        # recording runs on fake tensors, so values never enter it)
        self._programs: "collections.OrderedDict[tuple, str]" = \
            collections.OrderedDict()
        # tracing=True: the first dispatch runs under a torch.profiler
        # trace written as Chrome JSON under const.DEFAULT_TRACE_DIR
        # (armed until a dispatch takes it)
        self._tracing = tracing
        # the last profile written (the first-step trace or a fleet
        # window's Chrome JSON), None before one
        self.last_profile_path: Optional[str] = None
        self._remapper = Remapper(distributed_step.device,
                                  distributed_step.replica_info)
        self.state: Optional[TrainState] = None
        # _step_count counts optimizer applies (microsteps), the
        # superstep count dispatches: a run() is one of each, a fused
        # superstep k microsteps in one dispatch
        self._step_count = 0
        self._superstep_count = 0
        # device-to-host metric readbacks of this runner's steps
        self.readbacks = 0
        self._total_step_s = 0.0
        self._first_step_s: Optional[float] = None
        self._recent_step_s: list = []
        # the control plane (the JAX runner's): bounded-staleness pacing
        # is a property across processes, for sync plans only (async PS
        # paces itself through the parameter service)
        meta = distributed_step.metadata
        self._worker = self._worker_name()
        self._staleness = int(meta.get("staleness", 0))
        processes = job_processes()
        self._coord = None
        if (self._staleness > 0 and processes > 1
                and not meta.get("async")):
            self._coord = self._connect_coordination(
                "staleness pacing (window=%d)" % self._staleness)
        # async jobs at more than one process heartbeat on the step clock,
        # so a watchdog can tell a wedged worker from a healthy one
        self._async_hb = None
        self._last_hb = 0.0
        self._hb_enabled = bool(meta.get("async")) and processes > 1
        if self._hb_enabled:
            self._async_hb = self._connect_coordination(
                "async liveness heartbeats")
        # the training health sentinel: None defers to ADT_SENTINEL; an
        # active policy reads the step's verdicts at readback boundaries
        # and drives the skip budget, rollback and save quarantine
        from autodist_tpu_torch.runtime import sentinel as sentinel_lib
        policy = sentinel_lib.resolve_policy(sentinel)
        self._sentinel = (sentinel_lib.Sentinel(policy, self)
                          if policy is not None else None)
        self._sentinel_diags = []
        if self._sentinel is not None:
            from autodist_tpu_torch.analysis import rules as rules_lib
            self._sentinel_diags = rules_lib.verify_sentinel(policy, meta)
            for d in self._sentinel_diags:
                logging.warning("%s", d)
        # the one-shot "compiling" grace around the first dispatch
        self._compile_grace_marked = False
        self._compile_grace_cleared = False
        # the in-run elastic plane: the membership installed at build
        # (None otherwise), the rebuild handler AutoDist wires, and a
        # pending (epoch, roster) awaiting the next safe point
        from autodist_tpu_torch.runtime import elastic as elastic_lib
        self._membership = elastic_lib.current()
        self._reconfigure_fn = None
        self._reconfig_pending = None
        self._reconfig_torn = False
        self._epoch_poll_at = 0.0
        self._last_reconfigure_s = None
        self._reconfigs = 0
        # the preemption plane: a notice (SIGTERM, maintenance file,
        # operator drain) the boundaries consume — rescue checkpoint, then
        # the planned handoff; (step, snapshot) staged for the survivors'
        # reconfigure, outside its span
        from autodist_tpu_torch.runtime import preemption as preemption_lib
        self._preempt = preemption_lib.PreemptionGuard(self)
        self._prestaged = None
        # the flight recorder (its SIGTERM and exit hooks per
        # ADT_BLACKBOX*) and the online straggler detector
        from autodist_tpu_torch.telemetry import blackbox as blackbox_lib
        from autodist_tpu_torch.telemetry import cluster as cluster_lib
        from autodist_tpu_torch.telemetry import goodput as goodput_lib
        blackbox_lib.arm()
        self._straggler = goodput_lib.StragglerEwma()
        self._straggler_mark_at = 0.0
        # the fleet-profiling window: (seq, first_step, last_step) from the
        # coordination-service flag (polled at ADT_PROFILE_POLL_S) or the
        # serviceless ADT_PROFILE_STEPS; seq 0 is the env's window
        env_window = cluster_lib.parse_profile_env(
            const.ENV.ADT_PROFILE_STEPS.val)
        self._profile_window = ((0,) + env_window) if env_window else None
        # the one running profile, the first-step trace's or a window's:
        # (profiler, directory, seq or None for the first-step trace,
        # the last step it covers)
        self._profile_prof = None
        self._profile_done_seq = -1
        self._profile_poll_at = 0.0
        self._atexit_cb = None
        if self._hb_enabled or self._coord is not None:
            # goodbye on exit: a worker whose script just ends must
            # deregister, or its last heartbeat ages into a false death;
            # through a weakref, so a dropped runner is not kept alive
            ref = weakref.ref(self)

            def _close_if_alive(_r=ref):
                runner = _r()
                if runner is not None:
                    runner.close()
            self._atexit_cb = _close_if_alive
            atexit.register(_close_if_alive)

    @staticmethod
    def _worker_name() -> str:
        """This process's name on the coordination service:
        ``ADT_WORKER``, else ``chief`` on rank 0 of the default group (or
        with no group) and ``rank<r>`` on the others (every rank a
        launcher starts reads as the chief in ``const``)."""
        if const.ENV.ADT_WORKER.val:
            return const.ENV.ADT_WORKER.val
        import torch.distributed as dist
        rank = (dist.get_rank()
                if dist.is_available() and dist.is_initialized() else 0)
        return "chief" if rank == 0 else "rank%d" % rank

    @property
    def _heartbeat_every_s(self) -> float:
        # a quarter of the watchdog's window: three missable beats
        return max(0.25, const.ENV.ADT_HEARTBEAT_TIMEOUT_S.val / 4.0)

    def _connect_coordination(self, purpose: str = "staleness pacing"):
        """A resilient client of the coordination service at
        ``ADT_COORDINATOR_ADDR``'s host (127.0.0.1 by default) and
        ``ADT_COORDSVC_PORT``, after one raw connect as the reachability
        probe; None, with a warning, when it is not there."""
        host = (const.ENV.ADT_COORDINATOR_ADDR.val.split(":")[0]
                or "127.0.0.1")
        port = const.ENV.ADT_COORDSVC_PORT.val
        try:
            # the resilient client connects lazily and retries with
            # backoff: too slow a way to learn there is no service
            CoordinationClient(host, port).close()
        except OSError as e:
            logging.warning("coordination service unreachable (%s); "
                            "%s disabled", e, purpose)
            return None
        logging.info("%s active via %s", purpose, host)
        return ResilientCoordinationClient(host, port)

    # ------------------------------------------- torch.profiler traces

    def _profile_client(self):
        """A coordination client to poll the fleet profiling flag with:
        whatever this runner already opened (pacing, liveness); never a
        connection dialled for profiling alone."""
        for client in (self._coord, self._async_hb):
            if client is not None:
                return client
        return None

    def _maybe_start_profile(self):
        """Start the profile the NEXT dispatch runs under, if one is due.

        The fleet-profiling window: the chief posts "profile steps N..M"
        on the coordination service (``telemetry.request_profile`` /
        ``python -m autodist_tpu_torch.telemetry profile N M``), every
        worker polls the flag at ``ADT_PROFILE_POLL_S``, and each
        captures a ``torch.profiler`` trace of the SAME steps into
        ``DEFAULT_TRACE_DIR/fleet-<seq>-<worker>/trace.json``;
        ``ADT_PROFILE_STEPS=N:M`` arms the same window locally without a
        service. ``tracing=True`` is a window over the first dispatch,
        written to ``DEFAULT_TRACE_DIR/<time>/``; a fleet window that
        covers that step goes first and the first-step trace takes the
        next free dispatch.

        Touches local state only: it runs inside the dispatch span; the
        KV poll lives in :meth:`_poll_profile_window`, in
        ``_after_dispatch`` with the other control-plane calls, so a
        retrying poll neither lands in the goodput decomposition's
        compute nor feeds the straggler EWMA a false outlier."""
        if self._profile_prof is not None:
            return
        step = self._step_count  # the step the NEXT dispatch runs
        if self._profile_window is not None:
            seq, first, last = self._profile_window
            if first <= step <= last:
                out = os.path.join(
                    const.DEFAULT_TRACE_DIR,
                    "fleet-%d-%s" % (seq, self._worker.replace(":", "_")))
                self._start_profile(out, seq, last)
                tel.counter_add("profiler.windows")
                tel.instant("profiler.window_start", "runner", seq=seq,
                            step=step, first=first, last=last)
                logging.info("fleet profiling: capturing steps %d..%d "
                             "into %s", first, last, out)
                return
            if step > last:
                # the window is already behind this worker (posted too
                # late, or a rollback rewound past it): it never arms
                self._profile_done_seq = max(self._profile_done_seq, seq)
                self._profile_window = None
        if self._tracing:
            self._tracing = False   # the first step only
            self._start_profile(os.path.join(
                const.DEFAULT_TRACE_DIR, time.strftime("%Y%m%d-%H%M%S")),
                None, step)

    def _start_profile(self, directory: str, seq, last: int):
        """Start ``torch.profiler`` over this runner's device (CPU and CUDA
        activities on ``cuda``, the CPU alone when the caller asked for
        the CPU) for the dispatches up to step ``last``."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(directory, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
        self._profile_prof = (prof, directory, seq, last)

    def _maybe_stop_profile(self):
        """Close the running profile after the dispatch that ran its last
        step, once the device has finished that step
        (``torch.cuda.synchronize``, where the JAX runner blocks on the
        metrics), and write it as Chrome JSON, ``trace.json`` in its
        directory. On ``cuda`` a profile that holds no CUDA kernel event
        is an error: a missing device trace (no CUPTI) must show, not
        pass as a CPU-only one."""
        if self._profile_prof is None \
                or self._step_count <= self._profile_prof[3]:
            return
        import json
        (prof, directory, seq, _last), self._profile_prof = \
            self._profile_prof, None
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        prof.stop()
        path = os.path.join(directory, "trace.json")
        prof.export_chrome_trace(path)
        self.last_profile_path = path
        if seq is not None:
            self._profile_done_seq = max(self._profile_done_seq, seq)
            self._profile_window = None
            tel.instant("profiler.window_stop", "runner", seq=seq,
                        step=self._step_count)
        if cuda:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            if not any(e.get("cat") == "kernel" for e in events):
                raise RuntimeError(
                    "torch.profiler recorded no CUDA kernel event on %s "
                    "(%s): the device trace is missing (is CUPTI "
                    "available?)" % (self.device, path))
        logging.info("profiler trace -> %s", path)

    def _poll_profile_window(self):
        """Poll the coordination-service profiling flag (at most every
        ``ADT_PROFILE_POLL_S``; 0 disables) and arm a fresh window for the
        NEXT dispatch."""
        poll_s = const.ENV.ADT_PROFILE_POLL_S.val
        if (self._profile_window is not None
                or self._profile_prof is not None or poll_s <= 0
                or time.monotonic() < self._profile_poll_at):
            return
        self._profile_poll_at = time.monotonic() + poll_s
        client = self._profile_client()
        if client is None:
            return
        from autodist_tpu_torch.telemetry import cluster as cluster_lib
        with tel.span("runner.profile_poll", "runner"):
            window = cluster_lib.read_profile_window(client)
        if window is not None and window[0] > self._profile_done_seq:
            self._profile_window = window
            logging.info("fleet profiling window #%d armed: steps %d..%d",
                         *window)

    @property
    def distributed_step(self):
        return self._dstep

    @property
    def remapper(self):
        return self._remapper

    @property
    def device(self):
        return self._dstep.device

    def init(self, params, opt_state=None) -> TrainState:
        """Initialize the state on the device from ``params``
        (``{name: tensor or numpy}``). With more than one replica every
        rank calls it, and every replica starts from rank 0's values.

        Under ``ADT_AUTO_RESUME`` the newest valid checkpoint in
        ``ADT_CKPT_DIR`` (one either package wrote) is restored instead:
        torn and damaged steps are skipped (``latest_checkpoint``), and the
        restore falls back further if damage only shows while reading.
        With no valid checkpoint one replica warns and starts fresh; more
        than one raise, since peers restoring different steps would
        diverge. A worker admitted into a running in-run elastic job takes
        the chief's state instead (:meth:`_init_joined_late`)."""
        m = self._membership
        if m is not None and m.joined_late:
            return self._init_joined_late(m)
        if const.ENV.ADT_AUTO_RESUME.val:
            from autodist_tpu_torch.checkpoint import latest_checkpoint
            directory = const.ENV.ADT_CKPT_DIR.val
            _, saver = latest_checkpoint(directory)
            problem = "no valid checkpoint in %s" % directory
            if saver is not None:
                try:
                    with self._collectives():
                        _, step = saver.restore(self)
                except FileNotFoundError as e:
                    # every candidate was skipped as torn/corrupt
                    problem = str(e)
                else:
                    logging.warning("ADT_AUTO_RESUME: restored step %d "
                                    "from %s (%s)", step, directory,
                                    type(saver).__name__)
                    return self.state
            if self._dstep.num_replicas > 1:
                raise RuntimeError(
                    "ADT_AUTO_RESUME: %s on this process — peers restoring "
                    "different steps would diverge, refusing to start "
                    "fresh (`python -m autodist_tpu_torch.checkpoint ls "
                    "--dir %s` inspects it)" % (problem, directory))
            logging.warning("ADT_AUTO_RESUME: %s; starting fresh", problem)
        with self._collectives():
            self.state = self._dstep.init_state(params, opt_state)
        self.notify_state_restored()  # a fresh init resets the LR scale
        return self.state

    def _init_joined_late(self, m):
        """Grow-on-join: this worker was admitted into a running job, so
        it takes the run's state from the chief, whose reconfigure sends
        it (``elastic.broadcast_state``, then ``init_state``'s broadcast),
        or — when the chief has no whole copy — restores the newest
        checkpoint with it; a fresh init would diverge from the run."""
        from autodist_tpu_torch.runtime import elastic as elastic_lib
        with self._collectives(), tel.span("elastic.broadcast", "elastic",
                                           epoch=m.epoch, joiner=True):
            snap = elastic_lib.broadcast_state(None, self.device)
            if snap is None:
                self._restore_newest("grow-on-join")
            else:
                elastic_lib.adopt_snapshot(self, snap)
        m.joined_late = False
        try:
            m.ack(m.epoch)
        except OSError:
            pass
        self._step_count = int(self.state.step)
        logging.warning("elastic: adopted the chief's state at step %d "
                        "(grow-on-join, epoch %d)", self._step_count, m.epoch)
        return self.state

    def _restore_newest(self, why: str):
        """Restore the newest committed checkpoint in ``ADT_CKPT_DIR``
        (the in-run plane's fallback when no whole copy of the state is
        at hand)."""
        from autodist_tpu_torch.checkpoint import latest_checkpoint
        found, saver = latest_checkpoint(const.ENV.ADT_CKPT_DIR.val)
        if saver is None:
            raise RuntimeError(
                "elastic %s: the state is not locally whole and no committed "
                "checkpoint exists in %s" % (why, const.ENV.ADT_CKPT_DIR.val))
        saver.restore(self)
        tel.counter_add("elastic.ckpt_fallbacks")
        logging.warning("elastic %s: restored checkpoint step %s (no whole "
                        "copy of the state)", why, found)

    # ------------------------------------------------ in-run elastic plane

    def set_reconfigure_handler(self, fn):
        """Wire the rebuild half of an in-run reconfiguration:
        ``fn(runner, epoch, roster, snapshot)`` joins the epoch's process
        group, rebuilds the step for it and places the state (from
        ``snapshot``, or from the newest checkpoint when it is None).
        ``AutoDist._elastic_reconfigure`` is the standard handler."""
        self._reconfigure_fn = fn

    def adopt_distributed_step(self, dstep):
        """Swap in a rebuilt DistributedStep (after a reconfigure): the
        remapper and the staleness follow the new world; the step counts
        and telemetry go on, since it is the same run."""
        self._dstep = dstep
        self._remapper = Remapper(dstep.device, dstep.replica_info)
        self._staleness = int(dstep.metadata.get("staleness", 0))
        self._programs.clear()

    def _poll_epoch(self):
        """The boundary's membership poll (at most every
        ``ADT_ELASTIC_POLL_S``): a published epoch newer than ours parks a
        reconfigure for the next safe point."""
        m = self._membership
        if m is None or self._reconfig_pending is not None:
            return
        now = time.monotonic()
        if now < self._epoch_poll_at:
            return
        self._epoch_poll_at = now + max(0.01,
                                        const.ENV.ADT_ELASTIC_POLL_S.val)
        info = m.peek()
        if info is not None and info[0] > m.epoch:
            self._reconfig_pending = info
            logging.warning(
                "elastic: cluster epoch %d published (we are at %d) — "
                "reconfiguring to %d member(s) at the next boundary",
                info[0], m.epoch, len(info[1]))

    def _maybe_preempt_act(self):
        """Drive a pending preemption notice at a SAFE point (beside the
        sentinel and reconfigure hooks): the step-start notice read at
        more than one replica, the cluster-agreed rescue checkpoint, the
        snapshot's staging and — for a leaver with no survivors' epoch to
        wait for — the graceful exit itself."""
        self._preempt.poll(at_start=True)
        if self._preempt.pending:
            with self._collectives():
                self._preempt.maybe_act()

    def _prestage_snapshot(self):
        """Stage the state snapshot for an ANNOUNCED membership change
        (once a boundary step): the leaver is known in advance, so the
        survivors take the flush and snapshot here, outside the
        reconfigure span — the planned handoff's recorded downtime carries
        less work than an unplanned shrink's."""
        if (self._prestaged is not None
                and self._prestaged[0] == self._step_count):
            return
        from autodist_tpu_torch.runtime import elastic as elastic_lib
        self._dstep.flush_ps()
        self._prestaged = (self._step_count,
                           elastic_lib.snapshot_runner_state(self))

    def _maybe_reconfigure(self, hold: bool = True):
        """Carry out a pending membership change at a safe point (no
        dispatch running): the snapshot of this process's state (staged in
        advance for a planned departure, none after a torn step), the
        barrier of the new epoch's members, the handler's rejoin and
        rebuild, and the ack. Its time is the ``elastic.reconfigure``
        span. With ``hold``, an epoch without an announced leaver waits
        for the rescue plan's step (the preemption plane's lockstep
        rule); a failed collective's recovery does not wait."""
        if self._reconfig_pending is None:
            return
        if hold and self._preempt.holds_reconfigure(
                self._reconfig_pending[1]):
            return
        (epoch, roster), self._reconfig_pending = \
            self._reconfig_pending, None
        torn, self._reconfig_torn = self._reconfig_torn, False
        m = self._membership
        from autodist_tpu_torch.runtime import elastic as elastic_lib
        from autodist_tpu_torch.telemetry import blackbox
        if m.worker not in roster:
            # unthrottled notice check: the shrink epoch can outrun the
            # notice poll, and an announced leaver must never take the
            # zombie path — it hands off alive and exits gracefully
            if self._preempt.check_departure_now():
                if hold and self._preempt.defers_departure(roster):
                    # at more than one replica the leaver runs on to the
                    # plan's step, where its peers meet the same epoch
                    self._reconfig_pending = (epoch, roster)
                    return
                self._preempt.depart(epoch, roster)
            # declared dead, yet alive: a zombie. Every write path is
            # fenced already; this is the loud exit
            raise elastic_lib.FencedOut("reconfigure", m.epoch, epoch,
                                        m.worker, roster)
        if self._reconfigure_fn is None:
            raise RuntimeError(
                "elastic epoch %d published but no reconfigure handler is "
                "wired on this Runner (AutoDist.build arms it for in-run "
                "elastic jobs)" % epoch)
        t0 = time.perf_counter()
        planned = (not torn and self._prestaged is not None
                   and self._prestaged[0] == self._step_count)
        with tel.span("elastic.reconfigure", "elastic", epoch=epoch,
                      world=len(roster), from_world=len(m.roster),
                      step=self._step_count, torn=torn, planned=planned):
            snapshot = None
            if planned:
                # an announced departure: the snapshot was staged at this
                # boundary, outside the span
                snapshot = self._prestaged[1]
            elif not torn:
                self._dstep.flush_ps()
                snapshot = elastic_lib.snapshot_runner_state(self)
            self._prestaged = None
            # the new epoch's members meet at a step boundary: nobody
            # leaves its group while a peer is still in a collective
            m.barrier_reconf(epoch, m.world(roster))
            self._reconfigure_fn(self, epoch, roster, snapshot)
            m.adopt(epoch, roster)
            try:
                m.ack(epoch)
            except OSError:
                logging.warning("elastic: ack for epoch %d failed (the "
                                "chief may escalate)", epoch)
        self._last_reconfigure_s = time.perf_counter() - t0
        self._reconfigs += 1
        tel.counter_add("elastic.reconfigs")
        tel.gauge_set("elastic.epoch", float(epoch))
        blackbox.record("elastic.reconfigure", epoch=epoch,
                        world=len(roster), planned=planned,
                        downtime_s=round(self._last_reconfigure_s, 6))
        logging.warning(
            "elastic: reconfigured to epoch %d (%d member(s), %d "
            "replica(s)) in %.3fs", epoch, len(roster),
            self._dstep.num_replicas, self._last_reconfigure_s)

    def _inrun_recover(self, exc) -> bool:
        """A collective of this process's step failed under the in-run
        plane: wait (``INRUN_EPOCH_WAIT_S`` at more than one replica; at
        one, only an epoch already published counts) for a newer epoch
        and reconfigure to it. True when this process reconfigured: the
        caller runs its step again. A step that had begun to write its
        state (``writes_begun``) reconfigures with no snapshot, so the
        rebuild restores the newest checkpoint."""
        m = self._membership
        if m is None or self._reconfigure_fn is None:
            return False
        torn = bool(getattr(self._dstep, "writes_begun", True))
        wait = INRUN_EPOCH_WAIT_S if self._dstep.num_replicas > 1 else 0.0
        logging.warning("elastic: a collective of step %d failed (%s) — "
                        "waiting up to %.0f s for the shrink epoch (state "
                        "%s)", self._step_count, exc, wait,
                        "torn: the rebuild restores a checkpoint" if torn
                        else "intact: the step runs again")
        from autodist_tpu_torch.runtime import coordinator
        deadline = time.monotonic() + wait
        while True:
            info = m.peek(fresh=True)
            if info is not None and info[0] > m.epoch:
                break
            if time.monotonic() >= deadline or \
                    coordinator.whole_job_restart_claimed():
                return False
            time.sleep(0.05)
        self._reconfig_pending = info
        self._reconfig_torn = torn
        tel.counter_add("elastic.step_reruns")
        self._maybe_reconfigure(hold=False)
        return True

    # ------------------------------------------------------------ sentinel

    def _maybe_sentinel_act(self):
        """Perform a pending sentinel rollback (or raise the typed
        ``TrainingDiverged``) at a SAFE point — before a dispatch or after
        a readback boundary, never from inside a metrics readback."""
        if self._sentinel is not None:
            with self._collectives():
                self._sentinel.maybe_act()

    def _sentinel_observer(self):
        return self._sentinel.observe if self._sentinel is not None else None

    def sentinel_save_veto(self) -> bool:
        """Asked by the checkpoint savers: True while the sentinel
        quarantines saves (the last verdict bad, or a rollback pending) —
        a poisoned state must never become the newest committed
        checkpoint."""
        return self._sentinel is not None and self._sentinel.quarantined

    def sentinel_healthy(self) -> bool:
        """The ``healthy`` stamp a checkpoint committed now carries (True
        without a sentinel: an unguarded run has no evidence of ill
        health)."""
        return self._sentinel is None or self._sentinel.healthy()

    @property
    def sentinel(self):
        """The active :class:`~autodist_tpu_torch.runtime.sentinel.
        Sentinel` (None when no policy is armed)."""
        return self._sentinel

    def notify_state_restored(self):
        """Re-sync the process-local halves of the sentinel's LR scale
        with the copy in the (restored or freshly initialized) state's
        ``sync_state["sentinel"]["lr_scale"]``, which checkpoints keep:
        ``PSStore.update_scale`` (the host applies) and
        ``Sentinel.lr_scale`` (the ladder's accounting). Without it an
        auto-resume after an escalation would train host-PS and device
        variables at different learning rates. Called by the savers'
        restores and by :meth:`init` (one read of a device scalar)."""
        scale = 1.0
        sync = getattr(self.state, "sync_state", None)
        if isinstance(sync, dict) and "sentinel" in sync:
            scale = float(sync["sentinel"]["lr_scale"].reshape(-1)[0])
        store = getattr(self._dstep, "ps_store", None)
        if store is not None:
            store.update_scale = scale
        sen = self._sentinel
        if sen is not None and sen.lr_scale != scale:
            logging.info("sentinel: lr_scale re-synced to %.4g from the "
                         "restored state", scale)
            sen.lr_scale = scale

    def gather_params(self) -> dict:
        """The full params in their original names: this replica's, which
        equal every other replica's."""
        if self.state is None:
            raise RuntimeError("Runner.gather_params before init()")
        return self._dstep.gather_params(self.state)

    def predict(self, batch, serve_fn, ps_vals=None) -> dict:
        """One-shot forward-only inference on a host batch: run
        ``serve_fn(params, batch)`` through the fetch program and return
        its outputs on the host as numpy. Sustained traffic wants the
        serving engines (``autodist_tpu_torch/serving/``)."""
        if self.state is None:
            raise RuntimeError("Runner.predict before init()")
        program = self._dstep.predict_program(serve_fn, donate_batch=False,
                                              example_batch=batch)
        if ps_vals is None:
            ps_vals = self._dstep.pull_ps()
        placed = self._remapper.remap_feed(batch)
        return self._remapper.remap_fetch(program(self.state, ps_vals,
                                                  placed))

    def run(self, batch, state: Optional[TrainState] = None,
            sync: bool = True) -> Any:
        """One training step on a host batch, the global one: with N
        replicas each rank trains on its N-th of the rows and every rank
        gets the same metrics. ``sync=True`` (default)
        returns host metrics, paying one device-to-host copy a step.
        ``sync=False`` returns a :class:`MetricsHandle` that copies them
        when read; the step's wall time then measures its dispatch, not
        its execution. With ``state`` given, that state is stepped without
        being modified and ``(new_state, metrics)`` is returned."""
        t_begin = time.perf_counter()
        self._maybe_sentinel_act()  # a pending rollback replaces the state
        self._poll_epoch()
        self._maybe_preempt_act()   # a pending notice rescues / hands off
        self._maybe_reconfigure()   # a pending epoch re-forms the world
        while True:
            st = state if state is not None else self.state
            if st is None:
                raise RuntimeError("Runner.run before init()")
            self._compile_grace_begin()
            try:
                with self._collectives(rerun=state is None), tel.span(
                        "runner.dispatch", "runner", microsteps=1,
                        sync=sync, step=self._step_count):
                    with tel.span("runner.feed", "runner"):
                        placed = self._remapper.remap_feed(batch)
                    self._maybe_snapshot(placed)
                    self._maybe_start_profile()
                    self._check_ps_owner_health()
                    new_state, metrics = self._dstep(st, placed,
                                                     donate=state is None)
                    if state is None:
                        self.state = new_state
                    self._after_dispatch(1)
                    handle = MetricsHandle(
                        metrics, self._remapper, owner=self,
                        observer=self._sentinel_observer())
                    out = handle.result() if sync else handle
                    self._record_step_time(t_begin)
                    return (new_state, out) if state is not None else out
            except _Rerun:
                continue  # the world was re-formed: the step again

    def run_superstep(self, stacked_batch, sync: bool = False):
        """One FUSED superstep: k microsteps (k = the stacked feed's
        leading dim) in a single dispatch (``DistributedStep.run_multi``;
        on ``cuda`` one replay of a CUDA graph), the optimizer applied k
        times on the device; the metrics come back stacked ``[k, ...]`` in
        a lazily materialized :class:`MetricsHandle` (``sync=True`` reads
        them back before returning)."""
        t_begin = time.perf_counter()
        self._maybe_sentinel_act()  # a pending rollback replaces the state
        self._poll_epoch()
        self._maybe_preempt_act()   # a pending notice rescues / hands off
        self._maybe_reconfigure()   # a pending epoch re-forms the world
        if self.state is None:
            raise RuntimeError("Runner.run_superstep before init()")
        while True:
            self._compile_grace_begin()
            # placed by the live world's remapper: a re-formed world
            # takes other rows a rank
            with tel.span("runner.feed", "runner", stacked=True):
                placed = self._remapper.remap_feed_stack(stacked_batch)
            leaves = pytree.tree_leaves(placed)
            k = int(np.shape(leaves[0])[0]) if leaves else 1
            if self._snapshot_due:
                self._maybe_snapshot(pytree.tree_map(lambda t: t[0], placed))
            try:
                with self._collectives(rerun=True), tel.span(
                        "runner.dispatch", "runner", microsteps=k,
                        sync=sync, step=self._step_count):
                    self._maybe_start_profile()
                    self._check_ps_owner_health()
                    self.state, metrics = self._dstep.run_multi(self.state,
                                                                placed)
                    self._after_dispatch(k)
                    handle = MetricsHandle(
                        metrics, self._remapper, microsteps=k, owner=self,
                        observer=self._sentinel_observer())
                    out = handle.result() if sync else handle
                    self._record_step_time(t_begin)
                    return out
            except _Rerun:
                continue  # the world was re-formed: the superstep again

    def _after_dispatch(self, microsteps: int):
        """The control plane after a dispatch, counted in microsteps (a
        fused superstep advances the pacing by its k applies): the step
        counts, the async heartbeat, the bounded-staleness window across
        processes and the mirror check."""
        self._compile_grace_end()
        self._step_count += microsteps
        self._superstep_count += 1
        tel.counter_add("runner.steps", microsteps)
        tel.counter_add("runner.supersteps")
        self._maybe_stop_profile()
        self._poll_profile_window()
        self._poll_epoch()
        self._preempt.poll()
        self._maybe_heartbeat()
        if self._coord is not None:
            # report this step, then wait while more than `staleness`
            # steps ahead of the slowest process (the reference's size-s
            # token queues, ps_synchronizer.py:388-458); the span holds
            # the time a slower peer cost this step
            self._coord.report_step(self._worker, self._step_count)
            self._coord.heartbeat(self._worker)
            with tel.span("runner.barrier", "runner",
                          step=self._step_count, staleness=self._staleness):
                self._coord.wait_staleness(self._step_count,
                                           self._staleness)
        self._maybe_check_mirrors()

    @contextlib.contextmanager
    def _collectives(self, rerun: bool = False):
        """Around the calls that meet the other ranks (a step, the init's
        and the restore's broadcast): at more than one replica, a
        ``RuntimeError`` (gloo raises one within milliseconds of a peer's
        exit) goes to ``coordinator.collective_failed`` first. On a
        sync-elastic chief that waits for the process watcher's restart
        decision, which replaces this process, before the error may
        unwind into interpreter exit, whose hooks would read the worker's
        death as shutdown; elsewhere it returns at once. With ``rerun``
        (a step) under the in-run plane, the error first waits for the
        shrink epoch (:meth:`_inrun_recover`); once this process has
        reconfigured, :class:`_Rerun` tells the step to run again."""
        try:
            yield
        except RuntimeError as e:
            if rerun and self._inrun_recover(e):
                raise _Rerun() from e
            if self._dstep.num_replicas > 1:
                from autodist_tpu_torch.runtime import coordinator
                coordinator.collective_failed(e)
            raise

    def _compile_grace_begin(self):
        """A heartbeat and the one-shot ``compiling`` mark, sent just
        before the FIRST dispatch on the client that already heartbeats:
        its kernel builds, the CUDA context and cuBLAS set-up, or a fused
        superstep's graph capture can outlast ``ADT_HEARTBEAT_TIMEOUT_S``,
        and the chief's watchdog would age this healthy worker into a
        false death. The mark (a wall-clock KV record the watchdog reads,
        ``Coordinator._in_compile_grace``) buys ``ADT_COMPILE_GRACE_S`` of
        silence and is cleared when the first dispatch returns."""
        if self._superstep_count > 0 or self._compile_grace_marked:
            return
        client = self._async_hb or self._coord
        if client is None:
            return
        try:
            client.heartbeat(self._worker)
            # wall clock, not monotonic: the watchdog runs in another
            # process; the grace window is minutes, so clock skew is noise
            client.put("compiling/%s" % self._worker, repr(time.time()))
            self._compile_grace_marked = True
            self._last_hb = time.monotonic()
        except (OSError, RuntimeError) as e:
            # best-effort: a rejected or unreachable mark must never stop
            # training — at worst the watchdog sees the silence
            logging.warning("pre-dispatch heartbeat failed (%s); the "
                            "watchdog may read a long first dispatch as "
                            "silence", e)

    def _compile_grace_end(self):
        """A heartbeat, then clear the one-shot mark: steady-state
        silence ages normally again. The beat goes first: a long first
        dispatch left the last beat older than the window, and between a
        clear and the next beat the watchdog would read the silence as a
        death (``Coordinator._still_silent`` reads the list again after
        the marks)."""
        if not self._compile_grace_marked or self._compile_grace_cleared:
            return
        self._compile_grace_cleared = True
        client = self._async_hb or self._coord
        if client is None:
            return
        try:
            client.heartbeat(self._worker)
            self._last_hb = time.monotonic()
            # "0" = epoch zero: instantly outside any grace window (the
            # line protocol needs a non-empty value token)
            client.put("compiling/%s" % self._worker, "0")
        except (OSError, RuntimeError):
            pass  # the mark ages out through the grace window anyway

    def _check_ps_owner_health(self):
        """Fail loudly when an async-PS owner apply loop of this process
        is dead (its thread died, or its reconnect budget is spent): its
        queue would back up and training would run on applying nothing.
        Two attribute reads a step when healthy."""
        store = getattr(self._dstep, "ps_store", None)
        if store is None or not getattr(store, "serving", False):
            return
        bad = store.owner_health_errors()
        if bad:
            raise RuntimeError(
                "async PS owner apply loop(s) dead — training cannot "
                "apply gradients: %s"
                % "; ".join("%s: %s" % (h, e) for h, e in bad))

    def _maybe_heartbeat(self):
        """The async liveness beat, on the step clock: it means this
        worker made progress recently (a thread would beat on while the
        main thread is wedged). A failed beat reconnects at the next due
        time instead of stopping."""
        if not self._hb_enabled:
            return
        now = time.monotonic()
        if now - self._last_hb <= self._heartbeat_every_s:
            return
        if self._async_hb is None:
            self._async_hb = self._connect_coordination(
                "async liveness heartbeats (reconnect)")
            if self._async_hb is None:
                return  # retry at the next due beat
        try:
            self._async_hb.heartbeat(self._worker)
            self._last_hb = now
        except OSError as e:
            logging.warning("async heartbeat failed (%s); reconnecting at "
                            "the next beat", e)
            try:
                self._async_hb.close()
            except OSError:
                pass
            self._async_hb = None

    def _maybe_check_mirrors(self):
        """Sync host PS keeps every rank's mirror of the store bit-equal
        by determinism; every ``ADT_PS_MIRROR_CHECK_EVERY`` steps (0 =
        off) the ranks compare an md5 of their mirrors (after the
        in-flight push lands) and fail fast on a divergence. The JAX
        runner compares them through the coordination service; the port
        all-gathers them on the default group (16 bytes a rank, on the
        runner's device), a collective every rank reaches at the same
        step."""
        every = const.ENV.ADT_PS_MIRROR_CHECK_EVERY.val
        store = self._dstep.ps_store
        n = self._dstep.num_replicas
        if (every <= 0 or store is None or store.serving or n < 2
                or self._step_count % every != 0):
            return
        import torch.distributed as dist
        self._dstep.flush_ps()
        mine = torch.tensor(list(bytes.fromhex(store.mirror_digest())),
                            dtype=torch.uint8, device=self.device)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine)
        digests = [bytes(p.cpu().tolist()).hex() for p in parts]
        tel.counter_add("ps.mirror_checks")
        if len(set(digests)) != 1:
            raise RuntimeError(
                "PS mirror divergence at step %d: the ranks' digests are %s"
                % (self._step_count, digests))

    def _record_step_time(self, t_begin: float):
        elapsed = time.perf_counter() - t_begin
        self._total_step_s += elapsed
        if self._first_step_s is None:
            self._first_step_s = elapsed   # includes the kernels' builds
        else:
            self._recent_step_s.append(elapsed)
            if len(self._recent_step_s) > self._RECENT_WINDOW:
                del self._recent_step_s[:len(self._recent_step_s) // 2]
            self._observe_straggler(elapsed)

    def _observe_straggler(self, elapsed: float):
        """Online slow-but-alive detection: sustained EWMA z-score
        outliers in this worker's dispatch wall time flip the
        ``telemetry.straggler`` gauge, emit an instant and, with a
        coordination client, mark ``straggler/<worker>`` on the service —
        the chief's watchdog reads the mark to tell a degraded but
        progressing worker from a dead one instead of recycling it
        (``Coordinator._is_straggling``)."""
        from autodist_tpu_torch.telemetry import blackbox
        transition = self._straggler.observe(elapsed)
        if transition is None:
            # refresh the mark while still flagged: the watchdog's
            # freshness window (twice the heartbeat timeout) must see a
            # live mark for as long as the degradation lasts
            if (self._straggler.flagged
                    and time.monotonic() - self._straggler_mark_at
                    > self._heartbeat_every_s):
                self._write_straggler_mark(repr(time.time()))
            return
        if transition == "flag":
            z = self._straggler.last_z
            tel.gauge_set("telemetry.straggler", round(z, 3))
            tel.counter_add("telemetry.straggler_flags")
            tel.instant("telemetry.straggler", "runner", z=round(z, 3),
                        step=self._step_count,
                        dispatch_s=round(elapsed, 6))
            blackbox.record("runner.straggler", z=round(z, 3),
                            step=self._step_count,
                            dispatch_s=round(elapsed, 6))
            logging.warning(
                "straggler: dispatch wall time %.4gs is %.1f sigma over "
                "the EWMA baseline for %d consecutive dispatches — "
                "flagging this worker slow-but-alive",
                elapsed, z, self._straggler.patience)
            self._write_straggler_mark(repr(time.time()))
        else:  # "clear"
            tel.gauge_set("telemetry.straggler", 0.0)
            tel.instant("telemetry.straggler_clear", "runner",
                        step=self._step_count)
            self._write_straggler_mark("0")

    def _write_straggler_mark(self, mark: str):
        self._straggler_mark_at = time.monotonic()
        client = self._async_hb or self._coord
        if client is not None:
            try:  # best-effort: the mark is advisory, never worth a stall
                client.put("straggler/%s" % self._worker, mark)
            except (OSError, RuntimeError):
                pass

    # ------------------------------------------------ the program passes

    def lowered_text(self, batch, state: Optional[TrainState] = None,
                     fuse_steps: int = 1, program: str = "train",
                     donate: bool = False, rank: Optional[int] = None) -> str:
        """The program text of the step for the host ``batch`` (the JAX
        ``Runner.lowered_text``): the step recorded op by op on fake
        tensors (``kernel/lowering.py``), the input of the lint pass
        (``analysis/lowered.py``) and of the memory and schedule
        analyzers (``analysis/memory.py``, ``analysis/program.py``).
        Nothing runs on the device: the host-PS values enter as fakes.
        ``program="eval"`` records the forward-only evaluation;
        ``fuse_steps=k > 1`` the fused k-microstep superstep (the feed
        stacked k times); ``donate=True`` the variant that updates the
        state in place, the one that runs in steady state; ``rank``
        another rank's program (ADT407). A program is recorded once for
        its arguments and the structure of the state and the feed (the
        passes below ask for the same one)."""
        st = state if state is not None else self.state
        if st is None:
            raise RuntimeError("Runner.lowered_text before init()")
        placed = self._remapper.remap_feed(batch)
        key = (fuse_steps, program, donate, rank,
               _structure((st.params, st.opt_state, st.sync_state)),
               _structure(placed))
        text = self._programs.get(key)
        if text is None:
            text = self._dstep.lowered_text(st, placed, fuse_steps=fuse_steps,
                                            program=program, donate=donate,
                                            rank=rank)
            self._programs[key] = text
            while len(self._programs) > self._PROGRAMS_KEPT:
                self._programs.popitem(last=False)
        return text

    def lint_lowered(self, batch, state: Optional[TrainState] = None,
                     fuse_steps: int = 1):
        """The recorded program's communication checks (ADT405-409) and
        its numerics pass (ADT60x) for ``batch``; with ``fuse_steps=k``
        the fused program's, where a host transfer in a microstep is
        ADT408 — found before any CUDA-graph capture."""
        from autodist_tpu_torch.analysis import lowered as lowered_lib
        return lowered_lib.lint_runner(self, batch, state,
                                       fuse_steps=fuse_steps)

    def memory_report(self, batch, state: Optional[TrainState] = None,
                      fuse_steps: int = 1,
                      hbm_budget_bytes: Optional[float] = None,
                      donate: bool = True) -> dict:
        """Static per-device peak-HBM report of the step for ``batch``
        (the JAX ``Runner.memory_report``): the recorded program's entry
        buffers (donation-aware) plus the liveness sweep of its
        temporaries (``analysis/memory.py``), checked against the card's
        HBM budget (``ResourceSpec.chip_hbm_bytes()`` via AutoDist, or
        ``hbm_budget_bytes``). Nothing runs and nothing allocates: an OOM
        surfaces as ``ADT501``. ``donate=True`` (default) reports the
        program that runs in steady state; ``fuse_steps=k`` the fused
        superstep, whose un-donated carry is ``ADT503``."""
        from autodist_tpu_torch.analysis import memory as memory_lib
        from autodist_tpu_torch.analysis import program as program_lib
        text = self.lowered_text(batch, state, fuse_steps=fuse_steps,
                                 donate=donate)
        prog = program_lib.parse_program_text(text)
        est = memory_lib.estimate_from_text(prog)
        schedule = program_lib.collective_schedule(prog)
        budget = (hbm_budget_bytes if hbm_budget_bytes is not None
                  else self._hbm_budget)
        diags = memory_lib.donation_diagnostics(prog, fuse_steps=fuse_steps)
        report = {
            "program": {"fuse_steps": fuse_steps, "donated": donate,
                        "num_partitions": est.num_partitions},
            "estimate": est.to_dict(),
            "peak_hbm_bytes": round(est.peak_hbm_bytes),
            "peak_hbm_gib": round(est.peak_hbm_bytes / memory_lib.GIB, 4),
            "collectives": {
                "count": len(schedule),
                "per_step_count": len(schedule.per_step()),
                "per_class_payload_bytes":
                    schedule.per_step().class_payload_bytes(),
            },
        }
        if budget is not None:
            diags = diags + memory_lib.budget_diagnostics(
                est.peak_hbm_bytes, budget, source="lowered-program")
            report.update(
                budget_bytes=round(budget),
                budget_gib=round(budget / memory_lib.GIB, 4),
                utilization=(round(est.peak_hbm_bytes / budget, 4)
                             if budget else None))
        report["diagnostics"] = diags
        return report

    def collective_schedule(self, batch, state: Optional[TrainState] = None,
                            program: str = "train", fuse_steps: int = 1):
        """The ordered collective schedule (cost class, group, payload,
        microstep) of one of this runner's programs
        (``analysis/program.py``)."""
        from autodist_tpu_torch.analysis import program as program_lib
        text = self.lowered_text(batch, state, fuse_steps=fuse_steps,
                                 program=program)
        return program_lib.collective_schedule(text)

    def static_profile(self, batch, state: Optional[TrainState] = None,
                       fuse_steps: int = 1, topology=None):
        """The per-collective bytes the step really moves, as a
        ``StaticCollectiveProfile`` for a ``Simulator``/``CostModel``
        (``attach_static_profile``) in place of the traced heuristics;
        with the resource spec's ``topology``, each group's ring edges
        attributed to the link level they cross (``level_wire_bytes``)."""
        from autodist_tpu_torch.simulator.cost_model import \
            StaticCollectiveProfile
        schedule = self.collective_schedule(batch, state,
                                            fuse_steps=fuse_steps)
        return StaticCollectiveProfile.from_schedule(
            schedule, default_group_size=max(self._dstep.num_replicas, 1),
            topology=topology)

    def lint_schedules(self, batch, state: Optional[TrainState] = None,
                       fuse_steps: int = 1):
        """Cross-program collective-schedule consistency (ADT510/511):
        the eval program — and, with ``fuse_steps=k > 1``, the fused
        superstep's per-microstep schedule — must embed into the train
        step's, or ranks running different programs on one mesh block in
        different collectives."""
        from autodist_tpu_torch.analysis import program as program_lib
        train = self.collective_schedule(batch, state)
        diags = list(program_lib.compare_schedules(
            train, self.collective_schedule(batch, state, program="eval"),
            "train", "eval"))
        if fuse_steps > 1:
            diags += program_lib.compare_schedules(
                train, self.collective_schedule(batch, state,
                                                fuse_steps=fuse_steps),
                "train", "fused")
        return diags

    def _maybe_snapshot(self, placed):
        """``ADT_SNAPSHOT`` at build: the first step writes snapshot stage
        ``3-transformed-program``, the step recorded as a program on this
        rank's feed ``placed``."""
        if self._snapshot_due and self.state is not None:
            self._snapshot_due = False
            self._dstep.snapshot_lowered(self.state, placed)

    def step_stats(self) -> dict:
        """Wall-time statistics over this runner's steps (each rank times
        its own), with the JAX runner's keys: ``steps`` and
        ``microsteps`` (optimizer applies), ``supersteps`` (dispatches: a
        fused superstep of k microsteps is one), ``first_step_s``
        (first-use kernel builds and a first capture included), the
        ``steady_*`` percentiles over recent dispatches, ``goodput`` (the
        share of total stepping time the dispatches would have needed at
        the steady median), ``telemetry`` counters (with the
        tensor-parallel forward all-reduces and their bytes) and
        ``param_bytes``, the bytes of the params this rank stores (a
        model-parallel variable's slice; None before ``init``),
        ``straggler`` (the online detector's stats) and
        ``goodput_breakdown`` (:meth:`goodput_report`'s buckets in
        seconds, None with tracing off). The shape is stable:
        ``steady_*``/``goodput`` are None before a second dispatch."""
        micro, sup = self._step_count, self._superstep_count
        out = {"steps": micro, "supersteps": sup, "microsteps": micro,
               "total_s": round(self._total_step_s, 6),
               "first_step_s": (round(self._first_step_s, 6)
                                if self._first_step_s is not None else None),
               "steady_median_s": None, "steady_p10_s": None,
               "steady_p90_s": None, "goodput": None}
        recent = self._recent_step_s
        if recent:
            qs = (statistics.quantiles(recent, n=10, method="inclusive")
                  if len(recent) >= 2 else [recent[0]] * 9)
            med = statistics.median(recent)
            out.update(steady_median_s=round(med, 6),
                       steady_p10_s=round(qs[0], 6),
                       steady_p90_s=round(qs[-1], 6),
                       goodput=round(min(1.0, med * sup
                                         / self._total_step_s), 4))
        c = tel.counters()
        out["telemetry"] = {
            "dispatches": c.get("dstep.dispatches", 0.0),
            "readbacks": c.get("runner.readbacks", 0.0),
            "d2h_bytes": c.get("runner.d2h_bytes", 0.0),
            "ps_bytes_pulled": c.get("ps.bytes_pulled", 0.0),
            "ps_bytes_pushed": c.get("ps.bytes_pushed", 0.0),
            "tp_fwd_allreduces": c.get("tp.fwd_allreduces", 0.0),
            "tp_fwd_allreduce_bytes": c.get("tp.fwd_allreduce_bytes", 0.0),
        }
        # the in-run elastic plane (a stable shape): the epoch, the
        # reconfigures and the last one's time, the fenced writes
        m = self._membership
        out["elastic"] = {
            "epoch": m.epoch if m is not None else None,
            "reconfigs": self._reconfigs,
            "last_reconfigure_s": (round(self._last_reconfigure_s, 6)
                                   if self._last_reconfigure_s is not None
                                   else None),
            "fenced_writes": c.get("elastic.fenced_writes", 0.0),
        }
        # the preemption plane (a stable shape): the notice, the rescue
        # saves and skips, the handoffs and the last one's time
        out["preempt"] = self._preempt.stats()
        # the key exists whether or not a sentinel policy is armed
        sen = self._sentinel
        out["sentinel"] = (sen.stats() if sen is not None else
                           {"skips": 0, "rollbacks": 0,
                            "last_grad_norm": None, "quarantined": False})
        # attributed goodput (telemetry/goodput.py): WHERE the wall time
        # went, None with tracing off (the decomposition needs the span
        # tree); the straggler detector's stats are always there (it runs
        # on the dispatch wall times)
        out["straggler"] = self._straggler.stats()
        report = self.goodput_report()
        out["goodput_breakdown"] = (
            {k: round(v, 6) for k, v in report.buckets.items()}
            if report is not None else None)
        out["param_bytes"] = (None if self.state is None else sum(
            t.numel() * t.element_size() for t in pytree.tree_leaves(
                self.state.params) if isinstance(t, torch.Tensor)))
        # the host-PS wire and apply, and the fused carry's write-back,
        # from the spans (recorded while tracing is on, ADT_TRACE): count
        # and total seconds of each
        spans = tel.get_recorder().summary() if tel.tracing_enabled() \
            else {}
        out["ps_spans"] = {
            name: {"count": int(spans.get(name, {}).get("count", 0)),
                   "total_s": round(spans.get(name, {}).get("total_s", 0.0),
                                    6)}
            for name in ("ps.pull", "ps.push", "ps.apply", "ps.absorb")}
        return out

    def goodput_report(self):
        """The attributed wall-time decomposition of this process's
        training thread (:class:`telemetry.goodput.GoodputReport`):
        compute / collective-wait / PS-wire / host-input / readback /
        checkpoint / rollback-replay buckets that sum to the recorded
        wall time by construction. None when tracing is off (the
        decomposition needs the span tree); under ``ADT_TRACE=sampled``
        (or after ring-buffer drops) the report is flagged
        ``approximate``. A ``sync=True`` step waits for the device inside
        ``runner.readback`` (the metrics' copy to the host), so on
        ``cuda`` a synchronous step's device time can land in
        ``readback`` rather than ``compute`` (the JAX rules, kept as they
        are)."""
        if not tel.tracing_enabled():
            return None
        from autodist_tpu_torch.telemetry import goodput as goodput_lib
        report = goodput_lib.build_report()
        if report.wall_s <= 0:
            return None
        return report

    def fit(self, batches, steps: Optional[int] = None,
            callbacks: Optional[list] = None, save_every: int = 0,
            saver=None, fuse_steps: int = 1, metrics_every: int = 1) -> list:
        """Train over an iterable of host batches, one :meth:`run` each;
        ``steps`` bounds an endless iterable without consuming a batch past
        the bound, ``callbacks`` are called as ``cb(step_index, metrics)``.
        ``save_every=N`` checkpoints every N steps, and once at the end
        when the last window was partial, through ``saver`` — by default
        an async :class:`~autodist_tpu_torch.checkpoint.saver.Saver` on
        ``ADT_CKPT_DIR``, which ``ADT_AUTO_RESUME`` resumes from. A pending
        write is joined before ``fit`` returns or raises, and a failed one
        raises. Returns the per-step host metrics.

        ``fuse_steps=k > 1`` runs fused supersteps: k consecutive batches
        stacked into one ``[k, ...]`` feed (or taken pre-stacked from a
        ``DevicePrefetcher(..., stack=k)``) and run as one dispatch
        (:meth:`run_superstep`). ``metrics_every=n`` reads the metrics
        back every n supersteps only, with no device-to-host copy between
        those boundaries. The history stays one entry a microstep;
        callbacks fire a microstep at a time, at the readback boundaries
        only (their values exact, their timing deferred). ``save_every``
        rounds up to the next superstep boundary (a save cannot split a
        superstep). When ``fit`` does the stacking, a trailing group
        smaller than k runs per step, so every batch trains; a
        pre-stacked source cannot be split, and a ``steps`` bound that is
        not a multiple of k stops at the last whole superstep."""
        with tel.span("runner.fit", "runner", fuse_steps=fuse_steps,
                      metrics_every=metrics_every, save_every=save_every):
            return self._fit(batches, steps, callbacks, save_every, saver,
                             fuse_steps, metrics_every)

    def _fit(self, batches, steps, callbacks, save_every, saver,
             fuse_steps, metrics_every) -> list:
        src_k = getattr(batches, "stack_k", 1)
        if src_k != 1 and src_k != max(1, fuse_steps):
            # a stacked source feeding another k would split the [k] dim
            # over the replicas, or stack a stacked feed again
            raise ValueError(
                "fit(fuse_steps=%d) fed a source pre-stacked with stack=%d"
                " — the stacks must match (DevicePrefetcher(stack=k) pairs"
                " with fit(fuse_steps=k))" % (fuse_steps, src_k))
        if fuse_steps > 1:
            # the fused program's refusals (a stale or async host PS; N >
            # 1 on cuda), before any step runs
            self._dstep.multi_step(fuse_steps)
        if save_every > 0 and saver is None:
            from autodist_tpu_torch.checkpoint.saver import Saver
            saver = Saver(directory=const.ENV.ADT_CKPT_DIR.val,
                          async_save=True)
        if self._sentinel is not None and saver is not None:
            # a rollback restores from where fit checkpoints
            self._sentinel.attach_saver(saver)
        if saver is not None:
            # the rescue checkpoint commits where fit checkpoints too
            self._preempt.attach_saver(saver)
        if fuse_steps > 1 or metrics_every > 1:
            return self._fit_pipelined(batches, steps, callbacks, save_every,
                                       saver, max(1, fuse_steps),
                                       max(1, metrics_every))
        history = []
        bounded = batches if steps is None else itertools.islice(batches,
                                                                 steps)
        try:
            for i, batch in enumerate(bounded):
                metrics = self.run(batch)
                history.append(metrics)
                for cb in (callbacks or ()):
                    cb(i, metrics)
                if save_every > 0 and (i + 1) % save_every == 0:
                    saver.save(self)
            # the LAST step's verdict may have pended a rollback: act
            # before the trailing save, so a failure surfaces from fit
            self._maybe_sentinel_act()
            if save_every > 0 and history and \
                    len(history) % save_every != 0:
                saver.save(self)  # the final partial window
        finally:
            # a failed async write must surface, on every exit path
            if saver is not None:
                saver.wait()
        return history

    def _fit_pipelined(self, batches, steps, callbacks, save_every, saver,
                       k: int, metrics_every: int) -> list:
        """The fused / async driver behind ``fit(fuse_steps=k,
        metrics_every=n)``: supersteps dispatch with ``sync=False`` and
        their :class:`MetricsHandle`\\ s wait on the device; one readback
        every n supersteps (and one at the end), of their metrics
        concatenated on the device (:meth:`MetricsHandle.concat`),
        materializes them into the per-microstep history."""
        history: list = []
        pending: list = []   # handles not read back yet, in step order

        def materialize():
            # one readback for the whole window: the pending handles'
            # metrics concatenated on the device
            merged = MetricsHandle.concat(pending) if pending else []
            pending[:] = merged if isinstance(merged, list) else [merged]
            # pop each handle before its callbacks fire: a callback that
            # raises must not leave it queued to fire again
            while pending:
                handle = pending.pop(0)
                for m in handle.unstack():
                    idx = len(history)
                    history.append(m)
                    for cb in (callbacks or ()):
                        cb(idx, m)

        # a DevicePrefetcher in matching stack mode yields stacked,
        # placed [k, ...] feeds, consumed whole; any other source yields
        # plain batches, grouped and stacked here
        pre_stacked = k > 1 and getattr(batches, "stack_k", 1) == k
        it = iter(batches)
        micro_done, last_save, supersteps = 0, 0, 0
        try:
            while steps is None or micro_done < steps:
                if pre_stacked:
                    if steps is not None and micro_done + k > steps:
                        logging.warning(
                            "fit: steps=%d is not a multiple of "
                            "fuse_steps=%d on a pre-stacked source; "
                            "stopping at %d microsteps", steps, k, micro_done)
                        break
                    try:
                        stacked = next(it)
                    except StopIteration:
                        break
                    handles = [self.run_superstep(stacked, sync=False)]
                else:
                    group = []
                    while len(group) < k and (steps is None or micro_done
                                              + len(group) < steps):
                        try:
                            group.append(next(it))
                        except StopIteration:
                            break
                    if not group:
                        break
                    if len(group) == k and k > 1:
                        from autodist_tpu_torch.data.prefetch import \
                            stack_batches
                        handles = [self.run_superstep(stack_batches(group),
                                                      sync=False)]
                    else:
                        # a trailing partial group: per step, still async
                        handles = [self.run(b, sync=False) for b in group]
                pending.extend(handles)
                micro_done += sum(h.microsteps for h in handles)
                supersteps += 1
                if supersteps % metrics_every == 0:
                    materialize()
                    self._maybe_sentinel_act()
                if save_every > 0 and micro_done - last_save >= save_every:
                    # rounded up to the superstep boundary: the save holds
                    # every microstep dispatched so far
                    saver.save(self)
                    last_save = micro_done
            materialize()
            self._maybe_sentinel_act()
            if save_every > 0 and micro_done > last_save:
                saver.save(self)  # the final partial window
        finally:
            # no materialize here: on an exception path the history goes
            # with the raise, and callbacks must not fire after one of
            # them (or the step) failed; pending handles drop their
            # device buffers
            del pending[:]
            if saver is not None:
                saver.wait()
        return history

    def evaluate(self, batches, steps: Optional[int] = None) -> dict:
        """Example-weighted mean of the scalar metrics over an iterable of
        host batches, without updating parameters: the forward-only
        program, no grads, no optimizer. Each batch weighs its example
        count (the leading dim of its first array leaf, 1 if none).
        Non-scalar metrics are skipped (warned once)."""
        if self.state is None:
            raise RuntimeError("Runner.evaluate before init()")
        totals, weight, skipped = {}, 0.0, set()
        # one host-PS pull for the whole loop: no push happens between
        # eval batches, so the values cannot change
        ps_vals = self._dstep.pull_ps()
        bounded = batches if steps is None else itertools.islice(batches,
                                                                 steps)
        for batch in bounded:
            n = self._batch_examples(batch)
            placed = self._remapper.remap_feed(batch)
            host = self._remapper.remap_fetch(
                self._dstep.evaluate(self.state, placed, ps_vals=ps_vals))
            for k, v in host.items():
                if np.ndim(v) == 0:
                    totals[k] = totals.get(k, 0.0) + float(v) * n
                elif k not in skipped:
                    skipped.add(k)
                    logging.warning("evaluate: skipping non-scalar metric "
                                    "%r (shape %s)", k, np.shape(v))
            weight += n
        if weight == 0.0:
            return {}
        return {k: v / weight for k, v in totals.items()}

    @staticmethod
    def _batch_examples(batch) -> int:
        for leaf in pytree.tree_leaves(batch):
            shape = np.shape(leaf)
            if len(shape) >= 1:
                return int(shape[0])
        return 1

    def close(self):
        """Say goodbye to the coordination service and close this runner's
        clients (a finished worker is neither counted dead nor bounds the
        staleness window), drop the device state and the captured
        supersteps, land the in-flight PS push and the fused supersteps'
        PS carry, and stop the store's threads and serving
        (idempotent)."""
        self._hb_enabled = False
        self._preempt.close()
        if self._atexit_cb is not None:
            atexit.unregister(self._atexit_cb)
            self._atexit_cb = None
        for attr in ("_coord", "_async_hb"):
            client = getattr(self, attr)
            if client is None:
                continue
            try:
                client.goodbye(self._worker)
            except OSError:
                pass
            finally:  # a failed goodbye must not leak the socket
                try:
                    client.close()
                except OSError:
                    pass
            setattr(self, attr, None)
        self.state = None
        self._dstep.close()


class WrappedSession:
    """Thin session facade over a :class:`Runner` for reference-style
    ``session.run(feed)`` loops (``AutoDist.create_distributed_session``)."""

    def __init__(self, runner: Runner):
        self._runner = runner

    def run(self, feed_dict=None, **kwargs):
        batch = feed_dict if feed_dict is not None else kwargs
        return self._runner.run(batch)

    def fit(self, batches, steps=None, callbacks=None, save_every=0,
            saver=None, fuse_steps=1, metrics_every=1):
        return self._runner.fit(batches, steps=steps, callbacks=callbacks,
                                save_every=save_every, saver=saver,
                                fuse_steps=fuse_steps,
                                metrics_every=metrics_every)

    def evaluate(self, batches, steps=None):
        return self._runner.evaluate(batches, steps=steps)

    def predict(self, feed_dict, serve_fn, ps_vals=None):
        """Forward-only fetches for one fed batch (``Runner.predict``)."""
        return self._runner.predict(feed_dict, serve_fn, ps_vals=ps_vals)

    @property
    def state(self):
        return self._runner.state

    def gather_params(self):
        return self._runner.gather_params()
