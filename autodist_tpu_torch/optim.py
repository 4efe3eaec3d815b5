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
differently. The state is optax's: a step ``count`` (an int32 0-d
tensor) and the moments ``mu``/``nu`` beside each variable on the device,
created by :meth:`OptimizerSpec.init`. The update runs as
``torch._foreach_*`` ops over all variables and writes the parameters,
the moments and the count in place (the JAX step donates its state and
returns new buffers). Nothing in it reads a value back to the host: the
count is incremented on the device and the bias corrections ``1 -
b**count`` are computed there, so one captured CUDA graph of the update
applies the right correction at every replay. They are computed as optax
computes them: ``b**count`` in float32, and the moments divided by the
float32 corrections.

The ZeRO-sharded update (``kernel/synchronization/zero_synchronizer.py``)
applies the same arithmetic to each replica's flat shard of a variable
through :meth:`OptimizerSpec.delta`, on a little ``{"v": shard}`` tree
with its own state, and gets the update back instead of a written
parameter (the JAX lowering's per-variable ``optimizer.update`` whose
delta it all-gathers).
"""
import dataclasses
import functools
import inspect
from typing import Any, Dict, Optional

import torch

# the options of torch.optim.Adam the update honours, with their defaults
_DEFAULTS = {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8}
_INT32_MAX = 2 ** 31 - 1


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
        """optax ``init``: an int32 count of 0 and zero moments beside
        each variable, on the variables' device."""
        device = next(iter(params.values())).device if params else None
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {n: torch.zeros_like(t) for n, t in params.items()},
                "nu": {n: torch.zeros_like(t) for n, t in params.items()}}

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> dict:
        """Apply one step to the variables named in ``grads``, in place on
        ``params`` and ``state``; returns the state (count + 1). Variables
        outside ``grads`` (not trainable) and their moments stay as they
        are, as the JAX step's zero gradients and masked updates leave
        them. The count is incremented in place, saturating at the int32
        maximum as optax's ``safe_increment`` does."""
        names = list(grads)
        upd = self._updates(names, grads, state)
        torch._foreach_add_([params[n] for n in names], upd)
        return dict(state)

    def delta(self, grads: Dict[str, torch.Tensor], state: dict
              ) -> Dict[str, torch.Tensor]:
        """optax ``update`` without ``apply_updates``: the moments and the
        count of ``state`` advance in place, and the updates (the deltas
        to add to the parameters) are returned by name."""
        names = list(grads)
        return dict(zip(names, self._updates(names, grads, state)))

    def _updates(self, names, grads, state):
        count = state["count"]
        count.add_((count < _INT32_MAX).to(count.dtype))
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
        # the bias corrections 1 - b**count in float32 on the device (a
        # replayed CUDA graph reads the count there), divided by, as
        # optax's bias_correction does
        upd = torch._foreach_div(mus, _correction(b1, count))
        den = torch._foreach_div(nus, _correction(b2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)                       # eps outside
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_mul_(upd, -lr)
        return upd


def _correction(beta: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - beta**count`` as a float32 0-d tensor beside
    ``count``."""
    return 1 - torch.full((), beta, dtype=torch.float32,
                          device=count.device).pow(count.to(torch.float32))


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
