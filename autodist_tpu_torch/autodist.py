"""AutoDist entry point (PyTorch counterpart of ``autodist_tpu/autodist.py``).

    ad = AutoDist(strategy_builder=strategy.Parallax())           # on cuda
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, example_batch)
    runner.init(params)
    metrics = runner.run(batch)            # one training step: {"loss": ...}

or, the JAX package's other entry points:

    step = ad.function(loss_fn, optimizer=..., params=params)
    metrics = step(batch)                  # builds and inits at the first call
    session = ad.create_distributed_session(loss_fn, optimizer, params,
                                            example_batch)
    runner = ad.build_step(step_fn, state, example_batch)   # opaque step

capture -> strategy build -> compile -> lowering, with the JAX package's
one-instance-per-process registry.

Data parallelism is one process a replica, in one default
``torch.distributed`` process group. A multi-node resource spec launches
from one command on the chief (the JAX package's flow): ``AutoDist()``
relaunches the user's script for every other device entry of the spec
(``runtime/coordinator.py``, over ssh, or local ``bash`` for loopback
nodes), starts the coordination service and joins every process into the
group (``runtime/server_starter.py``); the chief builds the strategy and
hands it to the workers (a copied file, or a broadcast under
``ADT_EXTERNAL_LAUNCH``), and a worker's death ends the job with exit code
1 — unless ``ADT_ELASTIC=<budget>`` asks for recovery: a relaunch of the
dead worker under async PS, or with ``ADT_ELASTIC_SYNC=1`` a restart of
the whole job from its newest checkpoint (``runtime/coordinator.py``), or
with ``ADT_ELASTIC_INRUN=1`` as well an in-run shrink to the survivors and
a grow when the relaunched worker is admitted back (``runtime/elastic.py``;
``build`` arms the membership and :meth:`AutoDist._elastic_reconfigure`
rebuilds the step for each new world). A
single-node job's processes come from the caller (``torchrun``, or
``torch.multiprocessing`` with the ``spawn`` start method), who makes the
group; the port runs on the group it finds. With no group there is one
replica. The plan must name one replica a rank (the resource spec; ranks
sharing one card list its index twice). Entry points run on ``cuda`` — a
launched process on its own entry's card, a caller's rank on
``cuda:<local rank>`` (``LOCAL_RANK`` as torchrun sets it, else the rank)
— unless the caller passes a device, and raise when that card is not
visible rather than continue on the CPU or another card.

Async PS (``sync=False`` on every host-PS variable) is the exception to
one replica a rank: each process trains at one replica of its own (the
reference's between-graph replication) and meets its peers only through
the parameter service (``runtime/ps_service.py``). With more than one
process (``ADT_NUM_PROCESSES``, else the default group's world size) that
service is the native coordination service: a chief-launched job's chief
starts it; otherwise the caller starts it once, as for bounded staleness
at N > 1::

    from autodist_tpu_torch.runtime.coordination import CoordinationServer
    srv = CoordinationServer(port).start()    # every process:
                                              # ADT_COORDSVC_PORT=port
    # each process but the chief: ADT_WORKER=<its resource-spec address>
"""
import atexit
import collections
import contextlib
import datetime
import json
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.kernel.replicator import ReplicaInfo
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.parallel import ps as ps_lib
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import ps_service as pss
from autodist_tpu_torch.runtime.coordination import (CoordinationClient,
                                                     job_processes)
from autodist_tpu_torch.runtime.resilience import ResilientCoordinationClient
from autodist_tpu_torch.runtime import server_starter
from autodist_tpu_torch.runtime.runner import Runner, WrappedSession
from autodist_tpu_torch.strategy.base import Strategy, StrategyCompiler
from autodist_tpu_torch.telemetry import spans as tel
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device

_DEFAULT_AUTODIST = {}


def set_default_autodist(obj):
    """One AutoDist instance per process, as in the JAX package."""
    if _DEFAULT_AUTODIST:
        raise NotImplementedError("Only one AutoDist instance per process is "
                                  "supported; call autodist_tpu_torch.reset() "
                                  "in tests")
    _DEFAULT_AUTODIST[0] = obj


def get_default_autodist():
    return _DEFAULT_AUTODIST.get(0)


def reset():
    """Clear process-global state: the AutoDist registry (closing the
    registered instance's runner), live decode engines and the serving
    planes this rank leads (their followers' loops end), the telemetry
    recorder, the flight recorder's events and logs, the installed elastic
    membership (and its socket), and the preemption plane's signal notice
    and armed guards; the SIGTERM handler the plane and the flight
    recorder installed is put back."""
    inst = _DEFAULT_AUTODIST.get(0)
    _DEFAULT_AUTODIST.clear()
    if inst is not None:
        inst.close()
    from autodist_tpu_torch.serving import decode as _decode
    for engine in _decode.active_decoders():
        engine.close()
    from autodist_tpu_torch.serving import plane as _plane
    for plane in _plane.active_planes():
        if plane.chief:
            try:
                plane.stop()
            except Exception as e:  # noqa: BLE001 — the group is gone
                # (destroyed, or a follower died): nothing is left to stop
                logging.warning("serving plane %s: stop failed (%s)",
                                plane.name, e)
    from autodist_tpu_torch.telemetry import spans as _tspans
    _tspans.reset()
    from autodist_tpu_torch.telemetry import blackbox as _bb
    _bb.reset()
    from autodist_tpu_torch.runtime import elastic as _elastic
    _elastic.clear()
    from autodist_tpu_torch.runtime import preemption as _preemption
    _preemption.reset()


def _strategy_for_roster(strategy: Strategy, roster) -> Strategy:
    """The compiled strategy for the processes of an elastic roster: a
    copy whose replicas are the launch plan's on the roster's nodes, in
    the plan's order (the same rule on every member)."""
    import copy
    keep = set(roster)
    out = copy.deepcopy(strategy)
    out.graph_config.replicas = [r for r in strategy.graph_config.replicas
                                 if r.split(":")[0] in keep]
    return out


def _check_pipeline_knobs(compiled: Strategy, mp_meta) -> None:
    """The JAX ``build``'s guard: the pipeline knobs are baked into the
    loss when the model builds it, so a plan that wants other ones than
    ``mp_meta`` declares would train another program than the one it
    describes (or, for the interleaved ``pp_shards``, another logical
    layer order than every unbound trace emulates). Raises with the
    rebuild instruction, in the JAX words."""
    meta = mp_meta or {}
    gc = compiled.graph_config
    picked_checks = [
        ("pp_schedule", gc.pp_schedule, "schedule"),
        ("pp_microbatches", gc.pp_microbatches, "n_microbatches"),
        ("pp_virtual", gc.pp_virtual, "virtual_stages"),
        ("pp_shards",
         (gc.mesh_shape or {}).get(const.PIPELINE_AXIS), "pp_shards"),
    ]
    for key, picked, setup_kw in picked_checks:
        declared = meta.get(key)
        if key == "pp_shards" and meta.get("pp_schedule") != "interleaved":
            # gpipe/1f1b losses read S off the mesh axis at run time; only
            # the interleaved loss bakes the stage count
            continue
        if (declared is not None and picked is not None
                and declared != picked):
            raise ValueError(
                "the strategy wants pipeline %s=%r but the loss was "
                "built with %r — rebuild the model's loss "
                "(make_train_setup(%s=%r)) and declare it via "
                "mp_meta[%r]"
                % (key, picked, declared, setup_kw, picked, key))


def process_group_replicas() -> ReplicaInfo:
    """This process's rank and the world size of the default process
    group; one replica when no group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return ReplicaInfo(dist.get_world_size(), dist.get_rank())
    return ReplicaInfo()


class AutoDist:
    def __init__(self, resource_spec_file: Optional[str] = None,
                 strategy_builder=None,
                 resource_spec: Optional[ResourceSpec] = None,
                 device=None, validate: str = "warn",
                 tracing: bool = False):
        if validate not in ("error", "warn", "off"):
            raise ValueError("validate must be 'error', 'warn' or 'off', "
                             "got %r" % (validate,))
        # the pre-compile strategy verifier's mode (analysis/rules.py):
        # "error" raises StrategyVerificationError before the lowering
        # sees the plan, "warn" logs the diagnostics, "off" skips the pass
        self._validate = validate
        # the runner's first step captures a torch.profiler trace under
        # const.DEFAULT_TRACE_DIR (the JAX AutoDist(tracing=))
        self._tracing = tracing
        const.makedirs()
        # a launched worker joins the process group from the env the
        # Coordinator set, before anything reads the group
        server_starter.maybe_init_distributed(device)
        if resource_spec is not None:
            self._resource_spec = resource_spec
        elif resource_spec_file is not None:
            self._resource_spec = ResourceSpec(resource_spec_file)
        else:
            kind = "cpu" if device is not None and \
                torch.device(device).type == "cpu" else "cuda"
            self._resource_spec = ResourceSpec.from_local(
                kind, replicas=process_group_replicas().num_processes)
        # a multi-node spec launches from the chief, also once exclusions
        # have left it one node (its processes are still the chief's to
        # launch)
        multi_node = not self._resource_spec.is_single_node()
        excluded = [a for a in
                    const.ENV.ADT_ELASTIC_EXCLUDE.val.split(",") if a]
        if excluded:
            # permanently lost nodes (the sync-elastic reduced-world
            # restart): every process sees the same reduced spec, so the
            # chief builds the strategy for — and the workers join — the
            # smaller world
            self._resource_spec = self._resource_spec.without_nodes(excluded)
        if strategy_builder is None:
            # the default, as in the JAX package and reference autodist.py:70
            from autodist_tpu_torch.strategy.ps_lb_strategy import \
                PSLoadBalancing
            strategy_builder = PSLoadBalancing()
        self._strategy_builder = strategy_builder
        self._runner: Optional[Runner] = None
        # the plan-level memory report of the last build (None before one,
        # with validate="off", or when the gate could not price the plan)
        self.last_memory_report: Optional[dict] = None
        self._coordinator = None
        self._early_launch(device, multi_node)
        self._replicas = process_group_replicas()
        if device is None and const.ENV.ADT_DEVICE.val:
            # a launched process runs on its own entry's device
            self._device = resolve_device(const.ENV.ADT_DEVICE.val)
        else:
            local_rank = None
            if self._replicas.num_processes > 1:
                local_rank = int(os.environ.get("LOCAL_RANK",
                                                self._replicas.process_rank))
            self._device = resolve_device(device, local_rank)
        set_default_autodist(self)

    def _early_launch(self, device=None, multi_node: bool = False):
        """Chief-launched multi-node jobs: launch the workers and join the
        process group NOW, at construction, as the JAX package does
        (its ``jax.distributed`` join must precede any device use): the
        order is preallocate the strategy id, launch the workers (they
        relaunch this script; their own ``AutoDist()`` joins from the
        env), join — which returns once every worker has joined — and
        only then let the user build; ``_setup`` ships the serialized
        strategy afterwards (the workers wait in their strategy poll).
        Nothing launches for a single-node spec (``multi_node``: the spec
        before any ``ADT_ELASTIC_EXCLUDE``), on a worker, under an
        external launcher, or in a process that is already in a group
        (the caller made its processes). A dry run (``ADT_DEBUG_REMOTE``)
        logs each worker's launch command and joins nothing. If the
        chief's own start fails, the workers it launched are stopped
        before the error propagates."""
        if (not multi_node or not const.is_chief()
                or const.ENV.ADT_EXTERNAL_LAUNCH.val
                or server_starter.initialized()):
            return
        sid = const.ENV.ADT_STRATEGY_ID.val or datetime.datetime.now(
            datetime.timezone.utc).strftime("%Y%m%dT%H%M%S%f")
        # the build path reads the preset id from env when serializing
        os.environ[const.ENV.ADT_STRATEGY_ID.name_str] = sid
        from autodist_tpu_torch.runtime.cluster import Cluster
        from autodist_tpu_torch.runtime.coordinator import Coordinator
        cluster = Cluster(self._resource_spec)
        self._coordinator = Coordinator(sid, cluster)
        if const.ENV.ADT_DEBUG_REMOTE.val:
            # remote_exec logs each command and starts nothing
            self._coordinator.launch_clients(copy_strategy=False)
            return
        # the chief's own card, checked before anything is launched
        resolve_device(device if device is not None else cluster.device(0))
        # the chief's own process count and device entry: workers get
        # theirs from worker_env; multi-process wiring on the chief
        # (async-PS serving, staleness pacing) reads the same env
        os.environ[const.ENV.ADT_NUM_PROCESSES.name_str] = str(
            cluster.num_processes)
        os.environ[const.ENV.ADT_DEVICE.name_str] = cluster.device(0)
        try:
            self._coordinator.launch_clients(copy_strategy=False)
            # joins as process 0; returns once every worker has joined
            cluster.start(device)
        except BaseException:
            # the watchers must not read the workers' end as a failure
            self._coordinator.stop_watchdog()
            cluster.stop_coordination_service()
            cluster.terminate(grace_s=0.0)
            raise
        if const.ENV.ADT_ELASTIC.val > 0:
            # async workers heartbeat on the step clock; the watchdog turns
            # silence-while-alive (a deadlock) into a kill that the process
            # watcher answers with a relaunch — or, for sync-elastic jobs,
            # with the whole-job restart. Sync workers write no heartbeat
            # records, so for them the watchdog is a no-op
            self._coordinator.start_watchdog()
        # atexit runs LIFO: this must fire BEFORE cluster.terminate (the
        # registration inside start()) so a clean exit flags the watchers
        # before terminate's SIGTERM makes a trailing worker "die", and an
        # exit that meets a sync-elastic restart waits for it
        atexit.register(self._coordinator.at_exit)

    @property
    def resource_spec(self) -> ResourceSpec:
        return self._resource_spec

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def is_chief(self) -> bool:
        return const.is_chief()

    @contextlib.contextmanager
    def scope(self):
        """Capture scope (reference ``autodist.py:309-322``). The port
        records the optimizer through ``optim.capture`` at build, so the
        scope patches nothing."""
        yield self

    def _verify_strategy(self, strategy: Strategy, item: ModelItem,
                         sentinel_policy=None):
        """Static verification before the plan is compiled and lowered
        (the JAX ``AutoDist._verify_strategy``): the rules of
        ``analysis/rules.py`` (malformed partitioners, dangling PS
        destinations, sync/compressor mismatches, the bf16 tier's
        numerics), the sentinel-aware numerics warnings that ``verify``
        did not already give (ADT603/604), and the plan-level memory gate
        of ``analysis/memory.py`` (ADT501/502: a projected per-device OOM
        against the card's memory), each a typed diagnostic. The memory
        gate is best-effort, as in JAX: a failure to price the plan skips
        it (``last_memory_report`` stays None)."""
        self.last_memory_report = None
        if self._validate == "off":
            return
        from autodist_tpu_torch.analysis import memory as memory_lib
        from autodist_tpu_torch.analysis.diagnostics import (
            Severity, StrategyVerificationError)
        from autodist_tpu_torch.analysis.rules import verify, verify_numerics
        diags = list(verify(strategy, item, self._resource_spec))
        seen = {(d.code, d.message) for d in diags}
        diags += [d for d in verify_numerics(
            strategy, item, self._resource_spec,
            sentinel_policy=sentinel_policy)
            if (d.code, d.message) not in seen]
        try:
            report = memory_lib.plan_memory_report(
                strategy, item, self._resource_spec)
        except Exception as e:  # noqa: BLE001 — the memory gate is
            # best-effort: a model the cost heuristics cannot price must
            # not fail an otherwise verifiable build
            logging.debug("plan-level memory gate skipped: %s", e)
        else:
            self.last_memory_report = report
            diags += report["diagnostics"]
        errors = [d for d in diags if d.severity >= Severity.ERROR]
        for d in diags:
            log = (logging.warning if d.severity >= Severity.WARNING
                   else logging.debug)
            log("strategy verifier: %s", d.format())
        if errors and self._validate == "error":
            raise StrategyVerificationError(errors)

    def _build_or_load_strategy(self, item: ModelItem) -> Strategy:
        """Chief builds and serializes; workers load by id (reference
        ``autodist.py:100-109``).

        Two handoff modes:

        - chief-launched (reference behavior): the chief serializes to
          disk, the Coordinator copies the file to each worker node, and
          workers poll for it by ``ADT_STRATEGY_ID``;
        - externally launched (``ADT_EXTERNAL_LAUNCH``, all processes
          started together): the strategy travels over a collective
          broadcast, which by construction cannot deliver a stale file
          from a previous run sharing the same serialization dir. A
          preset ``ADT_STRATEGY_ID`` pins the id.

        A job whose processes and group the caller made (torchrun,
        ``mp.spawn``) hands nothing over: a rank with no
        ``ADT_STRATEGY_ID`` builds the plan itself, as every rank of such
        a job does (the builders are deterministic, and an async job's
        processes must not meet in a collective).
        """
        external = (const.ENV.ADT_EXTERNAL_LAUNCH.val
                    and const.ENV.ADT_NUM_PROCESSES.val > 1)
        if const.is_chief():
            strategy = self._strategy_builder.build(item, self._resource_spec)
            preset_id = const.ENV.ADT_STRATEGY_ID.val
            if preset_id:
                strategy.id = preset_id
            path = strategy.serialize()
            logging.info("built strategy %s -> %s", strategy.id, path)
            if external:
                rank = process_group_replicas().process_rank
                if rank != 0:
                    raise RuntimeError(
                        "externally-launched jobs must start the chief (no "
                        "ADT_WORKER) with ADT_PROCESS_ID=0; this chief is "
                        "process %d" % rank)
                server_starter.broadcast_bytes(
                    json.dumps(strategy.to_dict()).encode())
            return strategy
        with tel.span("autodist.strategy_load", "launch"):
            if external:
                data = server_starter.broadcast_bytes()
                return Strategy.from_dict(json.loads(data.decode()))
            strategy_id = const.ENV.ADT_STRATEGY_ID.val
            if not strategy_id and server_starter.caller_made_group():
                return self._strategy_builder.build(item, self._resource_spec)
            if not strategy_id:
                raise RuntimeError("worker process missing ADT_STRATEGY_ID")
            # chief-launched workers start BEFORE the strategy exists, so
            # this poll bounds the chief's whole build + the file copy
            wait_s = const.ENV.ADT_STRATEGY_WAIT_S.val
            deadline = time.monotonic() + wait_s
            while True:
                try:
                    return Strategy.deserialize(strategy_id)
                except (FileNotFoundError, json.JSONDecodeError):
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            "strategy %s not available after %.0fs; did the "
                            "chief fail before serializing?"
                            % (strategy_id, wait_s))
                    time.sleep(0.2)

    def _setup(self):
        """Chief-only: ship the strategy to the workers launched at
        construction (reference ``autodist.py:120-128``), who wait in
        their strategy poll. Jobs the chief did not launch have nothing
        to ship."""
        if self._coordinator is not None:
            self._coordinator.distribute_strategy()

    def build(self, loss_fn: Callable, optimizer, params, example_batch,
              has_aux: bool = False, apply_fn: Optional[Callable] = None,
              trainable_filter: Optional[Callable] = None,
              mp_rules=None, mp_meta=None, sentinel=None) -> Runner:
        """Capture + strategy build + compile + lowering; returns an
        uninitialized Runner. ``optimizer`` is a ``torch.optim`` factory
        (``functools.partial(torch.optim.Adam, lr=1e-3)``, or None for a
        runner that only serves): the model item records its ``(name,
        kwargs)`` and the lowered step applies it (``optim.py``). Raises
        when the plan's replica count is not the group's world size.
        ``sentinel`` arms the training health sentinel
        (``runtime/sentinel.py``): ``None`` defers to ``ADT_SENTINEL``,
        ``True`` is the default ``SentinelPolicy``, a policy is used as
        it is, ``False`` is off — the health guards are then built into
        the step. ``mp_rules`` (``models.tp_lm.tp_rules()``) records the
        model's model-parallel sharding map; ``mp_meta`` declares the
        pipeline knobs the loss was built with (``pp_schedule``,
        ``pp_microbatches``, ``pp_virtual``, and ``pp_shards`` for the
        interleaved schedule): a plan that wants other ones raises the
        JAX ``ValueError``."""
        from autodist_tpu_torch.runtime.sentinel import resolve_policy
        policy = resolve_policy(sentinel)
        item = ModelItem(loss_fn=loss_fn, optimizer=optimizer, params=params,
                         example_batch=example_batch, has_aux=has_aux,
                         apply_fn=apply_fn,
                         trainable_filter=trainable_filter,
                         mp_rules=mp_rules, mp_meta=mp_meta).prepare()
        strategy = self._build_or_load_strategy(item)
        self._verify_strategy(strategy, item, sentinel_policy=policy)
        compiled = StrategyCompiler(item, self._resource_spec).compile(
            strategy)
        logging.info("compiled %r", compiled)
        _check_pipeline_knobs(compiled, item.mp_meta)
        self._setup()
        is_async = self._validate_async(compiled, item)
        self._check_elastic(is_async)
        # in-run elastic: the epoch-fenced membership is installed before
        # the Runner, which binds to it; a joiner admitted into a running
        # job holds its epoch's membership already, and its plan keeps
        # the roster's replicas
        inrun = const.ENV.ADT_ELASTIC_INRUN.val and not is_async
        plan = compiled
        if inrun:
            self._arm_inrun_elastic(compiled)
            from autodist_tpu_torch.runtime import elastic
            m = elastic.current()
            if m is not None and m.epoch > 1:
                plan = _strategy_for_roster(compiled, m.roster)
        # async PS cannot ride collectives (they are lockstep): each
        # process builds at one replica of its own
        dstep = GraphTransformer(
            plan, item, self._device,
            ReplicaInfo() if is_async else self._replicas,
            sentinel=policy).transform()
        if is_async and dstep.ps_store is not None:
            self._wire_async_ps(dstep)
        self._runner = Runner(
            dstep, sentinel=policy if policy is not None else False,
            tracing=self._tracing,
            hbm_budget_bytes=self._resource_spec.chip_hbm_bytes())
        if inrun:
            # the rebuild's inputs: a new world recompiles nothing, it
            # transforms the launch plan for the roster's processes
            self._last_build = {"strategy": compiled, "item": item,
                                "policy": policy}
            self._runner.set_reconfigure_handler(self._elastic_reconfigure)
        return self._runner

    def _arm_inrun_elastic(self, strategy: Strategy):
        """Install this process's epoch-fenced membership: the chief
        publishes the launch epoch (1, every node of the spec), a worker
        reads it; a joiner admitted by grow-on-join holds one already.
        The topology is linted here (ADT430/431, and ADT432 for the
        preemption plane's handoff, which rides the shrink): a job that
        can never shrink in-run says so at build, not at the first death;
        the preemption knobs are validated here too."""
        from autodist_tpu_torch.analysis import rules as rules_lib
        from autodist_tpu_torch.runtime import elastic, preemption
        # a single-node job constructs no Coordinator: validate here too
        elastic.validate_elastic_knobs()
        preemption.validate_preempt_knobs()
        for d in rules_lib.verify_elastic(strategy):
            logging.warning("elastic: %s", d.format())
        # the planned handoff rides the in-run shrink, so arming it on a
        # fail-fast (model-parallel) family warns at build time
        for d in rules_lib.verify_preemption(strategy):
            logging.warning("preemption: %s", d.format())
        self._orig_spec = getattr(self, "_orig_spec", self._resource_spec)
        if elastic.current() is not None:
            elastic.current().entries = elastic.spec_entries(
                self._orig_spec)
            return  # admitted by grow-on-join: the membership is live
        spec = self._resource_spec
        roster = elastic.roster_layout(list(spec.node_addresses), spec.chief)
        worker = const.ENV.ADT_WORKER.val or spec.chief
        membership = elastic.Membership(worker, 1, roster)
        membership.entries = elastic.spec_entries(spec)
        try:
            if const.is_chief():
                info = membership._with_client(elastic.read_epoch)
                if info is None:
                    membership._with_client(
                        lambda c: elastic.publish_epoch(c, 1, roster))
                else:
                    membership.adopt(*info)
            else:
                info = membership.peek()
                if info is not None:
                    membership.adopt(*info)
        except OSError as e:
            logging.warning("elastic: coordination service unreachable "
                            "(%s); the membership starts at the launch "
                            "epoch", e)
        elastic.install(membership)
        logging.info("elastic: in-run membership armed — %s at epoch %d "
                     "(roster %s)", worker, membership.epoch,
                     ",".join(membership.roster))

    def _elastic_reconfigure(self, runner, epoch, roster, snapshot):
        """The rebuild half of an in-run reconfiguration (the Runner's
        ``_maybe_reconfigure`` drives the protocol half): join the epoch's
        process group as the roster's processes, transform the launch plan
        for that world, and place the state — the snapshot (this
        process's own copy, on the card), or the newest checkpoint when it
        is None. On a grow the chief's snapshot goes to the joiner
        (``elastic.broadcast_state``, then ``init_state``'s broadcast);
        its bytes and time are the ``elastic.broadcast`` span and the
        ``elastic.broadcast_bytes`` counter."""
        from autodist_tpu_torch.analysis import rules as rules_lib
        from autodist_tpu_torch.runtime import elastic
        membership = elastic.current()
        grew = (membership is not None
                and len(roster) > len(membership.roster))
        info = self._last_build
        # the topology gate before any teardown, with verify_elastic's
        # rule: a refusal leaves the old group for the whole-job restart
        axes = rules_lib.fail_fast_model_axes(info["strategy"])
        if axes:
            raise RuntimeError(
                "in-run reconfigure reached a model-parallel strategy "
                "(ADT430 should have refused the shrink): mesh axes %s"
                % axes)
        orig = self._orig_spec
        excluded = [a for a in orig.node_addresses if a not in roster]
        self._resource_spec = (orig.without_nodes(excluded) if excluded
                               else orig)
        if self._coordinator is not None:
            self._coordinator._cluster.reconfigure(roster, epoch)
        else:
            elastic.rejoin_process_set(roster, epoch,
                                       elastic.spec_entries(orig),
                                       chief=orig.chief)
        self._replicas = process_group_replicas()
        old = runner.distributed_step
        dstep = GraphTransformer(
            _strategy_for_roster(info["strategy"], roster), info["item"],
            self._device, self._replicas,
            sentinel=info["policy"]).transform()
        runner.adopt_distributed_step(dstep)
        old.close()
        if grew and self._replicas.num_processes > 1:
            with tel.span("elastic.broadcast", "elastic", epoch=epoch,
                          joiner=False):
                snapshot = elastic.broadcast_state(snapshot, self._device)
                self._place(runner, snapshot)
            if snapshot is not None:
                tel.counter_add("elastic.broadcast_bytes", float(sum(
                    t.numel() * t.element_size() for t in
                    torch.utils._pytree.tree_leaves(
                        (snapshot["params"], snapshot["opt_state"],
                         snapshot["sync_state"]))
                    if isinstance(t, torch.Tensor))))
        else:
            self._place(runner, snapshot)

    @staticmethod
    def _place(runner, snapshot):
        from autodist_tpu_torch.runtime import elastic
        if snapshot is None:
            # no whole copy of some state on this process (sharded across
            # processes, or a torn step): the newest checkpoint
            runner._restore_newest("reconfigure")
        else:
            elastic.adopt_snapshot(runner, snapshot)

    def _validate_async(self, compiled: Strategy, item: ModelItem) -> bool:
        """True when the strategy asks for async PS, which must be pure
        host PS (every trainable variable, no proxy, no model-parallel
        mesh): anything else would need a collective across processes,
        which async training cannot have. The JAX package's errors."""
        plans = ps_lib.plan_host_ps(compiled, item.var_infos)
        if not any(not p.sync for p in plans.values()):
            return False
        missing = set(item.trainable_var_names) - set(plans)
        if missing:
            raise ValueError(
                "async PS (sync=False) requires EVERY trainable var on the "
                "no-proxy PS path; not PS-host-resident: %s" % sorted(missing))
        still_sync = sorted(n for n, p in plans.items() if p.sync)
        if still_sync:
            raise ValueError(
                "async PS is all-or-nothing: these vars request sync=True "
                "but the job is async (their deterministic mirror-apply "
                "semantics cannot be honored): %s" % still_sync)
        stale = sorted(n for n, p in plans.items() if p.staleness > 0)
        if stale:
            raise ValueError(
                "staleness is a SYNC-training window (coordination-service "
                "pacing); async PS always reads the latest published "
                "version — drop staleness on: %s" % stale)
        if compiled.graph_config.mesh_shape:
            raise ValueError("async PS cannot combine with model-parallel "
                             "mesh axes (collectives are lockstep)")
        return True

    def _check_elastic(self, is_async: bool):
        """The elastic knobs against the plan (the JAX package's checks
        and messages). Sync strategies are collective-lockstep, so elastic
        means either checkpoint-restore orchestration — a worker's death
        tears the whole job down and the chief re-execs with auto-resume
        (the Coordinator's ``_restart_whole_job``), which needs periodic
        saves (``Runner.fit(save_every=...)`` or ``Saver.save``) — or,
        with ``ADT_ELASTIC_INRUN=1``, the in-run shrink and grow, which
        falls back to that restart where it cannot shrink."""
        elastic_on = const.ENV.ADT_ELASTIC.val > 0
        if (elastic_on and not is_async
                and const.ENV.ADT_NUM_PROCESSES.val > 1):
            if not const.ENV.ADT_ELASTIC_SYNC.val:
                raise ValueError(
                    "ADT_ELASTIC on a sync strategy needs "
                    "ADT_ELASTIC_SYNC=1 at bring-up (the process group "
                    "join was skipped for the async-elastic flow and "
                    "cannot happen retroactively). Set ADT_ELASTIC_SYNC=1 "
                    "for whole-job checkpoint-restore recovery, or use an "
                    "async host-PS strategy (e.g. PS(sync=False))")
            if self._coordinator is not None:
                self._coordinator.enable_sync_elastic()
            logging.info(
                "ADT_ELASTIC on a sync strategy: %s (resume dir: %s)",
                "in-run shrink and grow, whole-job checkpoint-restore "
                "recovery where it cannot shrink"
                if const.ENV.ADT_ELASTIC_INRUN.val else
                "whole-job checkpoint-restore recovery enabled",
                const.ENV.ADT_CKPT_DIR.val)
        if is_async and elastic_on and const.ENV.ADT_ELASTIC_SYNC.val:
            raise ValueError(
                "ADT_ELASTIC_SYNC is set but the strategy is async PS: "
                "unset it — async elastic restarts workers individually "
                "and must not pin the process set with the process group")

    def _wire_async_ps(self, dstep):
        """Attach the parameter service: one process uses the in-process
        service; more than one talk to the native coordination service
        (which async requires) through resilient clients, after one raw
        ping that says where the service was looked for."""
        my_host = const.ENV.ADT_WORKER.val or self._resource_spec.chief
        n = job_processes()
        if n <= 1:
            services = {}

            def service_for_host(host):
                return services.setdefault(host, pss.LocalPSService())
        else:
            per_node = collections.Counter(
                d.host for d in self._resource_spec.devices)
            crowded = sorted(h for h, c in per_node.items() if c > 1)
            if crowded:
                host, c = crowded[0], per_node[crowded[0]]
                raise ValueError(
                    "async PS with %d processes: node %s lists %d device "
                    "entries, so %d processes would claim its one owner "
                    "group ps:%s (owner groups are per host); list one "
                    "device entry a node" % (n, host, c, c, host))
            if (self._replicas.process_rank > 0
                    and not const.ENV.ADT_WORKER.val):
                raise ValueError(
                    "async PS with %d processes: rank %d has no ADT_WORKER, "
                    "so it would claim the chief's (%s) owner group; set "
                    "ADT_WORKER to its resource-spec address on every "
                    "process but the chief" % (n, self._replicas.process_rank,
                                               my_host))
            coord_host = (const.ENV.ADT_COORDINATOR_ADDR.val.split(":")[0]
                          or self._resource_spec.chief)
            port = const.ENV.ADT_COORDSVC_PORT.val
            try:
                probe = CoordinationClient(coord_host, port)
                probe.ping()
                probe.close()
            except OSError as e:
                raise RuntimeError(
                    "async PS requires the native coordination service at "
                    "%s:%d (%s)" % (coord_host, port, e))

            # per-RPC deadlines, reconnect with backoff and idempotent
            # retries: a service blip neither double-applies a gradient
            # blob nor wedges a serving thread (runtime/resilience.py)
            def service_for_host(host):
                return pss.CoordPSService(
                    lambda: ResilientCoordinationClient(coord_host, port),
                    prefix="ps:" + host)
        dstep.ps_store.enable_serving(service_for_host, my_host)

    def build_step(self, step_fn: Callable, state, example_batch,
                   sentinel=None) -> Runner:
        """Opaque-step capture mode: distribute a hand-written
        ``step_fn(state, batch) -> (new_state, metrics)`` over the user's
        whole training state (params and optimizer state bundled however
        the user likes, a tree of dicts, lists and tuples of tensors); the
        framework never looks inside the step, so it runs as given, and
        ``Runner.fit(fuse_steps=k)`` captures it like any step. The
        strategy names the state's leaves by their paths, as the JAX
        package does. The opaque step hides its gradients, so host-PS is
        refused and compressors are ignored (warned), as in the JAX
        package; with more than one replica the port cannot sync them at
        all and refuses (ROADMAP A item 13). Returns an uninitialized
        Runner: ``runner.init(state)``. ``sentinel`` as in :meth:`build`:
        the opaque step has no guards, so the sentinel watches the loss
        only (ADT420)."""
        from autodist_tpu_torch.runtime.sentinel import resolve_policy
        policy = resolve_policy(sentinel)
        item = ModelItem(step_fn=step_fn, params=state,
                         example_batch=example_batch).prepare()
        strategy = self._build_or_load_strategy(item)
        self._verify_strategy(strategy, item, sentinel_policy=policy)
        compiled = StrategyCompiler(item, self._resource_spec).compile(
            strategy)
        logging.info("compiled %r (step_fn mode)", compiled)
        if self._validate_async(compiled, item):
            raise ValueError("async host-PS strategies cannot lower an "
                             "opaque step_fn — use loss_fn mode")
        self._setup()
        self._check_elastic(False)
        dstep = GraphTransformer(compiled, item, self._device,
                                 self._replicas, sentinel=policy).transform()
        self._runner = Runner(
            dstep, sentinel=policy if policy is not None else False,
            tracing=self._tracing,
            hbm_budget_bytes=self._resource_spec.chip_hbm_bytes())
        return self._runner

    def function(self, loss_fn: Callable, *, optimizer, params,
                 example_batch=None, has_aux: bool = False) -> Callable:
        """TF2-style stepping function: builds and inits at the first call
        (that call's batch is the example, unless ``example_batch`` is
        given), then every call runs one distributed step and returns the
        host metrics. ``stepper.get_runner()`` is the runner (None before
        the first call)."""
        box = {}

        def stepper(batch):
            if "runner" not in box:
                ex = example_batch if example_batch is not None else batch
                runner = self.build(loss_fn, optimizer, params, ex, has_aux)
                runner.init(params)
                box["runner"] = runner
            return box["runner"].run(batch)

        stepper.get_runner = lambda: box.get("runner")
        return stepper

    def create_distributed_session(self, loss_fn=None, optimizer=None,
                                   params=None, example_batch=None,
                                   has_aux: bool = False) -> WrappedSession:
        """Session facade over this instance's runner, built and inited
        from ``loss_fn``/``optimizer``/``params`` when there is none
        yet."""
        if self._runner is None:
            if loss_fn is None:
                raise ValueError("no model built; pass loss_fn/optimizer/"
                                 "params")
            runner = self.build(loss_fn, optimizer, params, example_batch,
                                has_aux)
            runner.init(params)
        return WrappedSession(self._runner)

    @property
    def runner(self) -> Optional[Runner]:
        return self._runner

    def close(self):
        if self._runner is not None:
            self._runner.close()
            self._runner = None
