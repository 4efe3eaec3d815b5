"""Optimizer capture and the optimizer apply of the training step.

PyTorch counterpart of ``autodist_tpu/patch.py`` (which records the
``(name, kwargs)`` of each optax constructor so ``ModelItem`` knows what
the user built) and of the optax update the JAX step applies.

A user hands ``AutoDist.build`` a ``torch.optim`` factory, as in
``functools.partial(torch.optim.Adam, lr=1e-3)`` (or the class itself).
:func:`capture` records its ``(name, kwargs)`` in an :class:`OptimizerSpec`
without building the optimizer. The step then applies optax.adam — the
update the JAX package trains with — so the port trains as the JAX
package does on the same numbers: bias-corrected moments, eps outside
the square root, ``eps_root = 0`` (torch.optim.Adam computes the same
update).

Only ``lr``, ``betas`` and ``eps`` are free. Every other option (weight
decay, amsgrad, maximize, and torch's implementation switches such as
``foreach`` or ``fused``, which the port's own update would not honour)
must keep torch's default, or :func:`capture` raises rather than train
differently. The state is optax's: a step ``count`` and the moments
``mu``/``nu`` beside each variable on the device, created by
:meth:`OptimizerSpec.init`. The update runs as ``torch._foreach_*`` ops
over all variables and writes the parameters in place (the JAX step
donates its state and returns new buffers).
"""
import dataclasses
import functools
import inspect
from typing import Any, Dict, Optional

import torch

# the options of torch.optim.Adam the update honours, with their defaults
_DEFAULTS = {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8}


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """A captured optimizer: its name and the keyword arguments the user
    passed."""
    name: str
    kwargs: Dict[str, Any]

    def _hp(self, key):
        return self.kwargs.get(key, _DEFAULTS[key])

    def state_spec(self, shapes: Dict[str, tuple]) -> dict:
        """Shapes of the state :meth:`init` makes for variables of
        ``shapes`` (``ModelItem.opt_state_spec``)."""
        return {"count": (), "mu": dict(shapes), "nu": dict(shapes)}

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """optax ``init``: count 0 and zero moments beside each variable."""
        return {"count": 0,
                "mu": {n: torch.zeros_like(t) for n, t in params.items()},
                "nu": {n: torch.zeros_like(t) for n, t in params.items()}}

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> dict:
        """Apply one step to the variables named in ``grads``, in place on
        ``params`` and ``state``; returns the state (count + 1). Variables
        outside ``grads`` (not trainable) and their moments stay as they
        are, as the JAX step's zero gradients and masked updates leave
        them."""
        names = list(grads)
        count = state["count"] + 1
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        lr = float(self._hp("lr"))
        b1, b2 = (float(x) for x in self._hp("betas"))
        eps = float(self._hp("eps"))
        mus = [state["mu"][n] for n in names]
        nus = [state["nu"][n] for n in names]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, gs, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - b2)
        upd = torch._foreach_div(mus, 1.0 - b1 ** count)    # bias-corrected
        den = torch._foreach_div(nus, 1.0 - b2 ** count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)                       # eps outside
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(ps, upd)
        new = dict(state)
        new["count"] = count
        return new


def capture(optimizer) -> Optional[OptimizerSpec]:
    """The :class:`OptimizerSpec` of a ``torch.optim.Adam`` factory (the
    class, or a ``functools.partial`` of it with keyword arguments);
    ``None`` for ``None``. Raises for anything else, or for an option the
    port cannot apply as optax does."""
    if optimizer is None:
        return None
    fn, kwargs = optimizer, {}
    if isinstance(fn, functools.partial):
        if fn.args:
            raise TypeError("pass the optimizer's options as keywords: "
                            "functools.partial(torch.optim.Adam, lr=1e-3)")
        fn, kwargs = fn.func, dict(fn.keywords)
    if not (isinstance(fn, type) and issubclass(fn, torch.optim.Optimizer)):
        raise TypeError(
            "optimizer must be a torch.optim.Optimizer class or a "
            "functools.partial of one (the port builds its state itself), "
            "got %r" % (optimizer,))
    if fn is not torch.optim.Adam:
        raise ValueError("the port applies optax.adam, the JAX package's "
                         "training optimizer: pass torch.optim.Adam, got "
                         "torch.optim.%s" % fn.__name__)
    sig = inspect.signature(fn)
    sig.bind_partial(None, **kwargs)          # unknown keywords raise
    for key, value in kwargs.items():
        fixed = sig.parameters[key].default
        if key not in _DEFAULTS and value != fixed:
            raise ValueError(
                "torch.optim.Adam(%s=%r) has no optax.adam counterpart the "
                "port applies; leave it at %r" % (key, value, fixed))
    return OptimizerSpec("adam", kwargs)
