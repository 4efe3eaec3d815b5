"""AutoDist entry point (PyTorch counterpart of ``autodist_tpu/autodist.py``).

    ad = AutoDist(strategy_builder=strategy.AllReduce())          # on cuda
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, example_batch)
    runner.init(params)
    metrics = runner.run(batch)            # one training step: {"loss": ...}

capture -> strategy build -> compile -> lowering, with the JAX package's
one-instance-per-process registry. The port runs one process on one
device; entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no card is visible rather than continue
on the CPU.
"""
from typing import Callable, Optional

import torch

from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime.runner import Runner
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


class AutoDist:
    def __init__(self, resource_spec_file: Optional[str] = None,
                 strategy_builder=None,
                 resource_spec: Optional[ResourceSpec] = None,
                 device=None):
        self._device = resolve_device(device)
        if resource_spec is not None:
            self._resource_spec = resource_spec
        elif resource_spec_file is not None:
            self._resource_spec = ResourceSpec(resource_spec_file)
        else:
            self._resource_spec = ResourceSpec.from_local(
                "cpu" if self._device.type == "cpu" else "cuda")
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
        kwargs)`` and the lowered step applies it (``optim.py``)."""
        item = ModelItem(loss_fn=loss_fn, optimizer=optimizer, params=params,
                         example_batch=example_batch, has_aux=has_aux,
                         apply_fn=apply_fn,
                         trainable_filter=trainable_filter).prepare()
        strategy: Strategy = self._strategy_builder.build(
            item, self._resource_spec)
        compiled = StrategyCompiler(item, self._resource_spec).compile(
            strategy)
        logging.info("compiled %r", compiled)
        dstep = GraphTransformer(compiled, item, self._device).transform()
        self._runner = Runner(dstep)
        return self._runner

    def close(self):
        if self._runner is not None:
            self._runner.close()
            self._runner = None
