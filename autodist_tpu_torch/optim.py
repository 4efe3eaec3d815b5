"""Optimizer capture and the optimizer apply of the training step.

PyTorch counterpart of ``autodist_tpu/patch.py`` (which records the
``(name, kwargs)`` of each optax constructor so ``ModelItem`` knows what
the user built) and of the optax update the JAX step applies.

A user hands ``AutoDist.build`` a ``torch.optim`` factory, as in
``functools.partial(torch.optim.Adam, lr=1e-3)`` (or the class itself).
:func:`capture` records its ``(name, kwargs)`` in an :class:`OptimizerSpec`
without building the optimizer. The step then applies the optax
optimizer the JAX package trains with, with optax's arithmetic and
state, so the port trains as the JAX package does on the same numbers:

- ``torch.optim.Adam`` is ``optax.adam``: bias-corrected moments, eps
  outside the square root, ``eps_root = 0``. Free: ``lr``, ``betas``,
  ``eps``;
- ``torch.optim.AdamW`` is ``optax.adamw``: Adam's update plus
  ``weight_decay * param``, added before the learning rate scales it
  (optax's order, not torch's ``p *= 1 - lr * wd``), on every trainable
  variable (optax's ``mask=None``). The two libraries' default decays
  differ, so ``weight_decay`` must be passed;
- ``torch.optim.SGD`` is ``optax.sgd``: ``momentum`` (given: optax's
  ``trace``, no dampening) and ``nesterov``; with no momentum keyword it
  keeps no state, as ``optax.sgd(lr)`` does;
- :func:`chain` of :func:`clip_by_global_norm` and one of them is
  ``optax.chain(optax.clip_by_global_norm(max_norm), ...)``: the
  gradients scaled by optax's formula ``where(norm < max_norm, g, g /
  norm * max_norm)``, the norm the square root of the sum of squares of
  every gradient the update is given. Where that norm is taken is the
  one place the apply sites differ: over the device tree in the step,
  over one rank's flat shard in ZeRO's :meth:`OptimizerSpec.delta`, over
  one shard in the host store, over one full variable in the fused PS
  carry — each site passes the tree the JAX site passes.

Every other option (Adam's weight decay, amsgrad, maximize, SGD's
dampening and weight decay, and torch's implementation switches such as
``foreach`` or ``fused``, which the port's own update would not honour)
must keep torch's default, or :func:`capture` raises rather than train
differently. The state is optax's, by the field names of optax's tree:
Adam and AdamW a step ``count`` (an int32 0-d tensor) and the moments
``mu``/``nu`` beside each variable; SGD with momentum a ``trace``
beside each variable; plain SGD nothing (:attr:`OptimizerSpec.slots`,
:attr:`OptimizerSpec.has_count`). A chain's state is its optimizer's,
saved under the optimizer's position in the chain
(:attr:`OptimizerSpec.jax_prefix`). The update runs as
``torch._foreach_*`` ops over all variables and writes the parameters
and the state in place (the JAX step donates its state and returns new
buffers). Nothing in it reads a value back to the host: the count is
incremented on the device, the bias corrections ``1 - b**count`` and the
clip's norm and choice are computed there, so one captured CUDA graph of
the update applies the right values at every replay.

The ZeRO-sharded update (``kernel/synchronization/zero_synchronizer.py``)
applies the same arithmetic to each replica's flat shard of a variable
through :meth:`OptimizerSpec.delta`, on a little ``{"v": shard}`` tree
with its own state, and gets the update back instead of a written
parameter (the JAX lowering's per-variable ``optimizer.update`` whose
delta it all-gathers). The host store (``parallel/ps.py``) and the
fused PS carry apply :meth:`OptimizerSpec.update` to such little trees.
"""
import dataclasses
import functools
import inspect
from typing import Any, Dict, Optional, Tuple

import torch

# each optimizer the port applies: its optax name and the options of its
# torch class that the update honours
_FREE = {torch.optim.Adam: ("adam", ("lr", "betas", "eps")),
         torch.optim.AdamW: ("adamw", ("lr", "betas", "eps",
                                       "weight_decay")),
         torch.optim.SGD: ("sgd", ("lr", "momentum", "nesterov"))}
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """A captured optimizer: its optax name (``adam``, ``adamw`` or
    ``sgd``), the keyword arguments the user passed to the torch class,
    the class's defaults for the rest, and, for a :func:`chain`, the
    ``clip_by_global_norm`` bound in front of it."""
    kind: str
    kwargs: Dict[str, Any]
    defaults: Dict[str, Any] = dataclasses.field(default_factory=dict)
    clip: Optional[float] = None

    def _hp(self, key):
        return self.kwargs.get(key, self.defaults.get(key))

    @property
    def name(self) -> Optional[str]:
        """The name the JAX package records for the optax optimizer: the
        constructor's, or None for a chain (``patch.py`` captures no
        ``optax.chain``)."""
        return self.kind if self.clip is None else None

    @property
    def args(self) -> Dict[str, Any]:
        """The recorded arguments: the user's keywords, none for a
        chain."""
        return dict(self.kwargs) if self.clip is None else {}

    @property
    def slots(self) -> Tuple[str, ...]:
        """The state's fields that hold one tensor a variable."""
        if self.kind in ("adam", "adamw"):
            return ("mu", "nu")
        return ("trace",) if "momentum" in self.kwargs else ()

    @property
    def has_count(self) -> bool:
        """Whether the state holds a step ``count`` (shared by the
        variables of one tree)."""
        return self.kind in ("adam", "adamw")

    @property
    def reads_params(self) -> bool:
        """Whether the update reads the parameters (AdamW's decay)."""
        return self.kind == "adamw"

    @property
    def jax_prefix(self) -> str:
        """Where optax keeps this state in the flattened tree: the first
        element of the optimizer's own chain, behind the clip's empty
        state in a :func:`chain`."""
        return "0/" if self.clip is None else "1/0/"

    def state_spec(self, shapes: Dict[str, tuple]) -> dict:
        """Shapes of the state :meth:`init` makes for variables of
        ``shapes`` (``ModelItem.opt_state_spec``)."""
        out = {"count": ()} if self.has_count else {}
        out.update({slot: dict(shapes) for slot in self.slots})
        return out

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """optax ``init``: an int32 count of 0 (where the optimizer keeps
        one) and zero slots beside each variable, on the variables'
        device."""
        device = next(iter(params.values())).device if params else None
        out = ({"count": torch.zeros((), dtype=torch.int32, device=device)}
               if self.has_count else {})
        for slot in self.slots:
            out[slot] = {n: torch.zeros_like(t) for n, t in params.items()}
        return out

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor], scale=None) -> dict:
        """Apply one step to the variables named in ``grads``, in place on
        ``params`` and ``state``; returns the state. Variables outside
        ``grads`` (not trainable) and their slots stay as they are, as the
        JAX step's zero gradients and masked updates leave them (a zero
        slot and a zero gradient keep the slot zero). The count is
        incremented in place, saturating at the int32 maximum as optax's
        ``safe_increment`` does. ``scale`` (a float32 0-d tensor: the
        health sentinel's LR scale) multiplies the updates before they
        are added, as the JAX step scales optax's updates."""
        names = list(grads)
        upd = self._updates(names, grads, state, params)
        if names and scale is not None:
            torch._foreach_mul_(upd, scale)
        if names:
            torch._foreach_add_([params[n] for n in names], upd)
        return dict(state)

    def delta(self, grads: Dict[str, torch.Tensor], state: dict,
              params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """optax ``update`` without ``apply_updates``: the state of
        ``state`` advances in place, and the updates (the deltas to add to
        ``params``, which AdamW's decay reads) are returned by name."""
        names = list(grads)
        return dict(zip(names, self._updates(names, grads, state, params)))

    def _updates(self, names, grads, state, params):
        if self.has_count:
            count = state["count"]
            count.add_((count < _INT32_MAX).to(count.dtype))
        if not names:
            # every variable rests elsewhere (the host PS): the count
            # still advances, as optax's does on an empty tree
            return []
        gs = [grads[n] for n in names]
        if self.clip is not None:
            gs = clip_global_norm(gs, self.clip)
        lr = float(self._hp("lr"))
        if self.kind == "sgd":
            upd = gs
            if "trace" in self.slots:
                m = float(self._hp("momentum"))
                trace = [state["trace"][n] for n in names]
                torch._foreach_mul_(trace, m)          # g + m * t
                torch._foreach_add_(trace, gs)
                upd = trace
                if self._hp("nesterov"):
                    upd = torch._foreach_mul(trace, m)
                    torch._foreach_add_(upd, gs)
            return torch._foreach_mul(upd, -lr)
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
        count = state["count"]
        upd = torch._foreach_div(mus, _correction(b1, count))
        den = torch._foreach_div(nus, _correction(b2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)                       # eps outside
        torch._foreach_div_(upd, den)
        del den
        if self.kind == "adamw":
            # optax's add_decayed_weights, before the learning rate
            torch._foreach_add_(upd, torch._foreach_mul(
                [params[n] for n in names], float(self._hp("weight_decay"))))
        torch._foreach_mul_(upd, -lr)
        return upd


def _correction(beta: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - beta**count`` as a float32 0-d tensor beside
    ``count``."""
    return 1 - torch.full((), beta, dtype=torch.float32,
                          device=count.device).pow(count.to(torch.float32))


def clip_global_norm(gs, max_norm: float):
    """optax's ``clip_by_global_norm`` on the list ``gs``: each gradient
    as it is when the global norm is below ``max_norm``, else ``g / norm
    * max_norm``; new tensors, all on the device. The norm is optax's
    ``sqrt(sum(sum(g ** 2)))``, each sum a ``torch.sum`` (a cascade on
    the CPU, a tree on the card): ``torch._foreach_norm`` and
    ``linalg.vector_norm`` accumulate float32 on the CPU with a relative
    error of 3e-5 at 2 M elements."""
    norm = torch.stack([g.square().sum() for g in gs]).sum().sqrt()
    keep = norm < max_norm
    scaled = torch._foreach_div(gs, norm)
    torch._foreach_mul_(scaled, float(max_norm))
    return [torch.where(keep, g, s) for g, s in zip(gs, scaled)]


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    """``optax.clip_by_global_norm(max_norm)`` as a member of
    :func:`chain`."""
    max_norm: float


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    """The counterpart of ``optax.clip_by_global_norm``, to put in front of
    an optimizer with :func:`chain`."""
    if not max_norm > 0:
        raise ValueError("clip_by_global_norm needs max_norm > 0, got %r"
                         % (max_norm,))
    return ClipByGlobalNorm(float(max_norm))


def chain(*members) -> OptimizerSpec:
    """The counterpart of ``optax.chain(optax.clip_by_global_norm(m),
    opt)``: ``chain(clip_by_global_norm(m), factory)``, where ``factory``
    is one :func:`capture` accepts. The JAX package records no name for a
    chain, and neither does this one (:attr:`OptimizerSpec.name`)."""
    if (len(members) != 2 or not isinstance(members[0], ClipByGlobalNorm)
            or isinstance(members[1], (ClipByGlobalNorm, OptimizerSpec))):
        raise ValueError(
            "optim.chain takes clip_by_global_norm(max_norm) and then one "
            "torch.optim factory (optax.chain(clip_by_global_norm, opt)); "
            "got %r" % (members,))
    inner = capture(members[1])
    return dataclasses.replace(inner, clip=members[0].max_norm)


def capture(optimizer) -> Optional[OptimizerSpec]:
    """The :class:`OptimizerSpec` of a ``torch.optim.Adam``, ``AdamW`` or
    ``SGD`` factory (the class, or a ``functools.partial`` of it with
    keyword arguments), or of a :func:`chain`; ``None`` for ``None``.
    Raises for anything else, or for an option the port cannot apply as
    optax does."""
    if optimizer is None:
        return None
    if isinstance(optimizer, OptimizerSpec):
        return optimizer
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
    if fn not in _FREE:
        raise ValueError(
            "the port applies the optax optimizers the JAX package trains "
            "with: pass torch.optim.Adam (optax.adam), torch.optim.AdamW "
            "(optax.adamw) or torch.optim.SGD (optax.sgd), optionally "
            "behind optim.chain(optim.clip_by_global_norm(m), ...); got "
            "torch.optim.%s" % fn.__name__)
    kind, free = _FREE[fn]
    sig = inspect.signature(fn)
    sig.bind_partial(None, **kwargs)          # unknown keywords raise
    for key, value in kwargs.items():
        fixed = sig.parameters[key].default
        if key not in free and value != fixed:
            raise ValueError(
                "torch.optim.%s(%s=%r) has no optax.%s counterpart the port "
                "applies; leave it at %r" % (fn.__name__, key, value, kind,
                                             fixed))
    if kind == "adamw" and "weight_decay" not in kwargs:
        raise ValueError(
            "torch.optim.AdamW: pass weight_decay explicitly — optax.adamw "
            "defaults to 1e-4 and torch.optim.AdamW to 1e-2, so the port "
            "does not pick one for you")
    if kind == "sgd" and kwargs.get("nesterov") and \
            not kwargs.get("momentum"):
        raise ValueError("torch.optim.SGD(nesterov=True) needs a momentum "
                         "(optax.sgd's trace)")
    return OptimizerSpec(kind, kwargs,
                         {k: sig.parameters[k].default for k in free})
