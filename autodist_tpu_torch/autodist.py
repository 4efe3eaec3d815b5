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

Data parallelism is one process a replica: the caller creates the default
``torch.distributed`` process group (``torchrun``, or
``torch.multiprocessing`` with the ``spawn`` start method and a
``FileStore`` or TCP address), each process builds its ``AutoDist`` and
calls the same entry points, and the port runs on the group it finds —
its rank and world size, its backend (the port never picks one). With no
group there is one replica. The plan must name one replica a rank (the
resource spec; ranks sharing one card list its index twice). Entry
points run on ``cuda`` — ``cuda:<local rank>`` for a rank, the local rank
being ``LOCAL_RANK`` as torchrun sets it, else the rank — unless the
caller passes a device, and raise when that card is not visible rather
than continue on the CPU or another card.

Async PS (``sync=False`` on every host-PS variable) is the exception to
one replica a rank: each process trains at one replica of its own (the
reference's between-graph replication) and meets its peers only through
the parameter service (``runtime/ps_service.py``). With more than one
process (``ADT_NUM_PROCESSES``, else the default group's world size) that
service is the native coordination service, which the caller starts
once, as for bounded staleness at N > 1::

    from autodist_tpu_torch.runtime.coordination import CoordinationServer
    srv = CoordinationServer(port).start()    # every process:
                                              # ADT_COORDSVC_PORT=port
    # each process but the chief: ADT_WORKER=<its resource-spec address>
"""
import os
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
from autodist_tpu_torch.runtime.runner import Runner, WrappedSession
from autodist_tpu_torch.strategy.base import Strategy, StrategyCompiler
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
    registered instance's runner), live decode engines and the telemetry
    recorder."""
    inst = _DEFAULT_AUTODIST.get(0)
    _DEFAULT_AUTODIST.clear()
    if inst is not None:
        inst.close()
    from autodist_tpu_torch.serving import decode as _decode
    for engine in _decode.active_decoders():
        engine.close()
    from autodist_tpu_torch.telemetry import spans as _tspans
    _tspans.reset()


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
                 device=None):
        self._replicas = process_group_replicas()
        local_rank = None
        if self._replicas.num_replicas > 1:
            local_rank = int(os.environ.get("LOCAL_RANK",
                                            self._replicas.rank))
        self._device = resolve_device(device, local_rank)
        if resource_spec is not None:
            self._resource_spec = resource_spec
        elif resource_spec_file is not None:
            self._resource_spec = ResourceSpec(resource_spec_file)
        else:
            self._resource_spec = ResourceSpec.from_local(
                "cpu" if self._device.type == "cpu" else "cuda",
                replicas=self._replicas.num_replicas)
        if strategy_builder is None:
            # the default, as in the JAX package and reference autodist.py:70
            from autodist_tpu_torch.strategy.ps_lb_strategy import \
                PSLoadBalancing
            strategy_builder = PSLoadBalancing()
        self._strategy_builder = strategy_builder
        self._runner: Optional[Runner] = None
        set_default_autodist(self)

    @property
    def resource_spec(self) -> ResourceSpec:
        return self._resource_spec

    @property
    def device(self) -> torch.device:
        return self._device

    def build(self, loss_fn: Callable, optimizer, params, example_batch,
              has_aux: bool = False, apply_fn: Optional[Callable] = None,
              trainable_filter: Optional[Callable] = None) -> Runner:
        """Capture + strategy build + compile + lowering; returns an
        uninitialized Runner. ``optimizer`` is a ``torch.optim`` factory
        (``functools.partial(torch.optim.Adam, lr=1e-3)``, or None for a
        runner that only serves): the model item records its ``(name,
        kwargs)`` and the lowered step applies it (``optim.py``). Raises
        when the plan's replica count is not the group's world size."""
        item = ModelItem(loss_fn=loss_fn, optimizer=optimizer, params=params,
                         example_batch=example_batch, has_aux=has_aux,
                         apply_fn=apply_fn,
                         trainable_filter=trainable_filter).prepare()
        strategy: Strategy = self._strategy_builder.build(
            item, self._resource_spec)
        compiled = StrategyCompiler(item, self._resource_spec).compile(
            strategy)
        logging.info("compiled %r", compiled)
        is_async = self._validate_async(compiled, item)
        # async PS cannot ride collectives (they are lockstep): each
        # process builds at one replica of its own
        dstep = GraphTransformer(
            compiled, item, self._device,
            ReplicaInfo() if is_async else self._replicas).transform()
        if is_async and dstep.ps_store is not None:
            self._wire_async_ps(dstep)
        self._runner = Runner(dstep)
        return self._runner

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
            if self._replicas.rank > 0 and not const.ENV.ADT_WORKER.val:
                raise ValueError(
                    "async PS with %d processes: rank %d has no ADT_WORKER, "
                    "so it would claim the chief's (%s) owner group; set "
                    "ADT_WORKER to its resource-spec address on every "
                    "process but the chief" % (n, self._replicas.rank,
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

    def build_step(self, step_fn: Callable, state, example_batch) -> Runner:
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
        Runner: ``runner.init(state)``."""
        item = ModelItem(step_fn=step_fn, params=state,
                         example_batch=example_batch).prepare()
        strategy: Strategy = self._strategy_builder.build(
            item, self._resource_spec)
        compiled = StrategyCompiler(item, self._resource_spec).compile(
            strategy)
        logging.info("compiled %r (step_fn mode)", compiled)
        if self._validate_async(compiled, item):
            raise ValueError("async host-PS strategies cannot lower an "
                             "opaque step_fn — use loss_fn mode")
        dstep = GraphTransformer(compiled, item, self._device,
                                 self._replicas).transform()
        self._runner = Runner(dstep)
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
