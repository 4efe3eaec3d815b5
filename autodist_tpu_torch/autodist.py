"""AutoDist entry point (PyTorch counterpart of ``autodist_tpu/autodist.py``).

    ad = AutoDist(strategy_builder=strategy.AllReduce())          # on cuda
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
"""
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.kernel.replicator import ReplicaInfo
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
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
            # the JAX package defaults to PSLoadBalancing, which the port
            # has not reached; AllReduce is the builder it has
            from autodist_tpu_torch.strategy.all_reduce_strategy import \
                AllReduce
            strategy_builder = AllReduce()
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
        dstep = GraphTransformer(compiled, item, self._device,
                                 self._replicas).transform()
        self._runner = Runner(dstep)
        return self._runner

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
