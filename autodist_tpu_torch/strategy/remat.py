"""WithRemat — gradient rematerialization as a composable strategy wrapper.

PyTorch counterpart of ``autodist_tpu/strategy/remat.py``: wraps ANY
strategy builder and sets ``graph_config.remat``, so the lowering computes
the loss under activation checkpointing — the backward pass recomputes
forward activations instead of storing them, trading FLOPs for device
memory. Policies:

- ``"full"``  — save nothing but each recompute unit's inputs
  (``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
  JAX ``jax.checkpoint``);
- ``"dots"``  — save the outputs of matmuls without batch dims
  (``aten.mm``/``aten.addmm``, not ``bmm``) and recompute everything
  else: selective checkpointing
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``), the
  counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.

The recompute unit. The JAX lowering checkpoints the whole loss and
leaves the schedule of the recomputation to XLA. Eager PyTorch recomputes
a checkpointed region whole at the first use of any of its saved
tensors, so a whole-loss region holds every activation again at the
start of the backward and saves no memory. So the lowering checkpoints
each module of the loss that declares itself a recompute unit (a class
attribute ``recompute_unit = True``: the port's ``TransformerBlock``; a
user's own repeated block may set it too) on its own, with its
parameters as explicit inputs: the backward then holds one unit's
activations at a time beside the units' inputs. The units are found
once, at the first call, by running the loss on fake tensors (no data,
no device work) under a module forward pre-hook; a loss the fake run
cannot trace raises. A loss with no unit is checkpointed whole, as in
the JAX lowering, with a warning that this adds a forward and saves no
memory here. Either way the recomputed forward runs every op of the
unit a second time, custom ``autograd.Function`` forwards included: the
flash attention forward kernel launches twice a layer a step.

The knob rides the serialized strategy like every other field.

    ad = adt.AutoDist(strategy_builder=WithRemat(strategy.AllReduce(),
                                                 policy="dots"))
"""
import contextlib
import functools

import numpy as np

from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder
from autodist_tpu_torch.utils import logging

REMAT_POLICIES = ("full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    import torch
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(policy, fn, *args, **kwargs):
    from torch.utils import checkpoint as ckpt
    kwargs["use_reentrant"] = False
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(fn, *args, **kwargs)


def recompute_units(f, *args) -> list:
    """The modules with ``recompute_unit`` set that ``f(*args)`` calls,
    in call order, from one run on fake CPU tensors of the arguments'
    shapes and dtypes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree

    def fake_leaf(leaf):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else \
                getattr(torch, str(leaf.dtype))
            return torch.empty(tuple(leaf.shape), dtype=dtype)
        return leaf
    units = {}

    def record(module, _inputs):
        if getattr(module, "recompute_unit", False):
            units.setdefault(id(module), module)
    mode = FakeTensorMode()
    with mode:
        fake = pytree.tree_map(fake_leaf, args)
    hook = torch.nn.modules.module.register_module_forward_pre_hook(record)
    try:
        with mode, torch.no_grad():
            f(*fake)
    finally:
        hook.remove()
    return list(units.values())


class _UnitForward:
    """A recompute unit's ``forward`` while the loss runs: the module's
    own forward, checkpointed with the policy, its parameters (the
    tensors ``functional_call`` bound to it) passed as explicit inputs so
    that the recomputation in the backward binds them again."""

    def __init__(self, module, policy):
        self.module = module
        self.policy = policy
        self.inner = False

    def __call__(self, *args, **kwargs):
        import torch
        m = self.module
        if self.inner or not torch.is_grad_enabled():
            return type(m).forward(m, *args, **kwargs)
        params = dict(m.named_parameters())
        k = len(params)

        def run(*flat, **kw):
            self.inner = True
            try:
                return torch.func.functional_call(
                    m, dict(zip(params, flat[:k])), flat[k:], kw)
            finally:
                self.inner = False
        return _checkpoint(self.policy, run, *params.values(), *args,
                           **kwargs)


@contextlib.contextmanager
def _units_checkpointed(units, policy):
    for m in units:
        m.forward = _UnitForward(m, policy)
    try:
        yield
    finally:
        for m in units:
            del m.forward


def remat_transform(policy: str):
    """Policy name -> function wrapper. The single source for the policy
    set — WithRemat validates against it and the lowering applies it, so
    the two can never drift. The wrapped function checkpoints each
    recompute unit it runs, or itself whole when it runs none."""
    if policy not in REMAT_POLICIES:
        raise ValueError("unknown remat policy %r (have %s)"
                         % (policy, list(REMAT_POLICIES)))

    def wrap(f):
        found = []

        @functools.wraps(f)
        def rematerialized(*args):
            if not found:
                found.append(recompute_units(f, *args))
                if not found[0]:
                    logging.warning(
                        "remat %r: the loss calls no module with "
                        "recompute_unit set, so it is checkpointed whole: "
                        "each step runs its forward twice and, in eager "
                        "PyTorch, the backward holds every activation "
                        "again, so this saves no memory", policy)
            if not found[0]:
                return _checkpoint(policy, f, *args)
            with _units_checkpointed(found[0], policy):
                return f(*args)
        return rematerialized
    return wrap


class WithRemat(StrategyBuilder):
    def __init__(self, inner: StrategyBuilder, policy: str = "full"):
        if policy not in REMAT_POLICIES:
            raise ValueError("unknown remat policy %r (have %s)"
                             % (policy, list(REMAT_POLICIES)))
        self._inner = inner
        self._policy = policy

    def build(self, model_item, resource_spec) -> Strategy:
        strategy = self._inner.build(model_item, resource_spec)
        strategy.graph_config.remat = self._policy
        return strategy
