"""ModelItem — the captured program and its variable metadata.

PyTorch counterpart of ``autodist_tpu/model_item.py``. The JAX module
flattens a params pytree and mines a jaxpr for gather-indexed (sparse)
variables; here params arrive as a flat mapping of names to tensors (a
``state_dict``), and the sparse variables are found by a traced forward
(:func:`trace_lookups`); the same one run, at ``prepare``, also takes the
cost model's trace inputs (:func:`trace_forward`, :class:`TraceCosts`:
the forward's FLOPs, activation bytes and model-parallel collectives).
Each variable also carries its name in the JAX
package's spelling (``VarInfo.collective_name``, ``convert.jax_name``):
the variables are listed in the JAX item's order (sorted-pytree order of
those names), and collectives are keyed on them, so the two packages'
plans bucket the same variables in the same order.
"""
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from autodist_tpu_torch import optim
from autodist_tpu_torch.utils import logging

# flax's ``batch_stats`` collection (BatchNorm running statistics) in the
# port's ``.``-joined names: ``batch_stats.<module path>.mean`` / ``.var``
# (``convert.params_from_jax`` writes them so, ``models/resnet.py`` makes
# them so)
BATCH_STATS_PREFIX = "batch_stats."


def default_trainable(name: str) -> bool:
    """The default ``trainable_filter``: every variable trains except the
    ``batch_stats`` collection, whose statistics are not weights (the JAX
    item's default, ``autodist_tpu/model_item.py``)."""
    return not (name.startswith(BATCH_STATS_PREFIX)
                or "." + BATCH_STATS_PREFIX in name)


def step_fn_trainable(name: str) -> bool:
    """The default ``trainable_filter`` in step_fn mode, over the state's
    ``/``-joined paths: the JAX item's default, which leaves a
    ``batch_stats`` collection out."""
    return not (name.startswith("batch_stats/") or "/batch_stats/" in name)


def flatten_state(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """``(path, leaf)`` pairs of a state tree of dicts, lists and tuples,
    named and ordered as the JAX package's ``flatten_with_names`` names a
    pytree: ``/``-joined keys (list and tuple items by index), the keys
    of each dict sorted."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, value in items:
        out.extend(flatten_state(value, prefix + "/" + key if prefix
                                 else key))
    return out


def unflatten_state(template, leaves: Dict[str, object], prefix: str = ""):
    """The tree of ``template``'s structure holding ``leaves[path]`` at
    each path (:func:`flatten_state`'s names), built of plain dicts,
    lists and tuples (a dict subclass in the template, such as a
    ``convert.FlaxParams``, becomes a dict: ``torch.utils._pytree`` takes
    an unregistered subclass for a leaf)."""
    def sub(key):
        return prefix + "/" + key if prefix else key
    if isinstance(template, dict):
        return {k: unflatten_state(v, leaves, sub(str(k)))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [unflatten_state(v, leaves, sub(str(i)))
                 for i, v in enumerate(template)]
        return items if isinstance(template, list) else tuple(items)
    return leaves[prefix]


def dtype_name(dtype) -> str:
    """numpy-style dtype name of a torch or numpy dtype (``"float32"``,
    ``"bfloat16"``, ``"int32"``) — the spelling ``VarInfo.dtype`` uses in
    both packages."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


@dataclasses.dataclass
class VarInfo:
    """Metadata for one trainable variable."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    trainable: bool = True
    sparse: bool = False  # embedding-like (lookup-indexed) variable
    # the JAX item's name for this variable (``convert.jax_name``); the
    # collective keys and the variable order follow it. "" = ``name``
    collective_name: str = ""
    # the JAX item's shape for it (``convert.flax_shape``: a Dense
    # ``weight [out, in]`` is ``[in, out]``), which the partitioned PS
    # builders size their shards from, as the JAX builders do. () =
    # ``shape``
    flax_shape: Tuple[int, ...] = ()

    def __post_init__(self):
        self.collective_name = self.collective_name or self.name
        self.flax_shape = tuple(self.flax_shape) or tuple(self.shape)

    @property
    def byte_size(self) -> int:
        itemsize = torch.empty((), dtype=getattr(torch, self.dtype)
                               ).element_size()
        return int(np.prod(self.shape or (1,))) * itemsize

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape or (1,)))


# ---------------------------------------------------------- sparse detection

# the port's table lookups: ``models/layers.py::SparseEmbed`` and any other
# ``F.embedding``; their ``weight`` argument is the table
_LOOKUPS = frozenset({F.embedding, torch.embedding})
# shape- and value-preserving ops a table may pass through on its way to a
# lookup (casts, views) — the JAX walker's transparent primitives
_TRANSPARENT = frozenset({
    torch.Tensor.to, torch.Tensor.float, torch.Tensor.bfloat16,
    torch.Tensor.half, torch.Tensor.double, torch.Tensor.type,
    torch.Tensor.view, torch.Tensor.reshape, torch.reshape,
    torch.Tensor.contiguous, torch.Tensor.detach})


class _LookupTap(TorchFunctionMode):
    """Records, for each traced params tensor (``roots``: id -> name),
    the ids count of every lookup it is the table of, and whether it had
    another tensor-producing use (a tied head, weight sharing)."""

    def __init__(self, roots: Dict[int, str]):
        super().__init__()
        self.roots = {k: {v} for k, v in roots.items()}
        self.lookups: Dict[str, List[int]] = {}
        self.dense_uses: set = set()
        self._keep = []   # aliases stay alive, so their ids stay unique

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _LOOKUPS:
            ids = args[0] if args else kwargs["input"]
            table = args[1] if len(args) > 1 else kwargs["weight"]
            for name in self.roots.get(id(table), ()):
                self.lookups.setdefault(name, []).append(int(ids.numel()))
            return out
        used = set()
        for leaf in pytree.tree_leaves((args, kwargs)):
            if isinstance(leaf, torch.Tensor):
                used |= self.roots.get(id(leaf), set())
        if used and isinstance(out, torch.Tensor):
            if func in _TRANSPARENT:
                self.roots.setdefault(id(out), set()).update(used)
                self._keep.append(out)
            else:
                self.dense_uses |= used
        return out


# ------------------------------------------------------------ trace costs


@dataclasses.dataclass
class TraceCosts:
    """What one forward of the loss costs, from the fake-tensor run of
    :func:`trace_forward` — the inputs the JAX cost model reads off its
    loss jaxpr (``simulator/cost_model.py``):

    - ``flops``: the forward's matmul and convolution FLOPs, exact (2 x M
      x N x K a product, 2 x outputs x kernel taps x C_in / groups a
      convolution; the JAX ``count_flops_estimate`` approximates);
    - ``act_bytes``: the bytes of every op's outputs, views and
      shape-only ops left out (the JAX ``_FUSED_OPS`` rule), and
      ``dot_bytes`` the products' and convolutions' share of them;
    - ``batch_bytes``: the example batch's bytes;
    - ``collectives``: ``{axis: {cost class: output bytes}}`` of the
      model-parallel collectives (``parallel/mesh.py::recording``)."""
    flops: float = 0.0
    act_bytes: float = 0.0
    dot_bytes: float = 0.0
    batch_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # the run's aten ops, one line each (``trace_forward(listing=True)``,
    # under ``ADT_SNAPSHOT``: the snapshot of the user's loss)
    listing: Optional[str] = None


_aten = torch.ops.aten
_PRODUCTS = frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
                       _aten.mv, _aten.dot, _aten.convolution})
_ATTENTION = frozenset(
    getattr(_aten, n) for n in (
        "_scaled_dot_product_flash_attention",
        "_scaled_dot_product_flash_attention_for_cpu",
        "_scaled_dot_product_efficient_attention",
        "_scaled_dot_product_cudnn_attention") if hasattr(_aten, n))
# shape-only ops, which hold no value of their own (views aside): the
# JAX cost model's _FUSED_OPS (convert_element_type, copy, broadcast,
# rev) and the factories of constants
_SHAPE_ONLY = frozenset(
    getattr(_aten, n) for n in (
        "_to_copy", "clone", "copy_", "contiguous", "expand_copy",
        "flip", "lift_fresh", "lift_fresh_copy", "empty", "empty_like",
        "new_empty", "new_empty_strided", "empty_strided", "zeros",
        "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
        "full", "full_like", "new_full", "scalar_tensor", "fill_",
        "zero_", "detach", "alias", "_unsafe_view")
    if hasattr(_aten, n))


def _product_flops(packet, args, out) -> float:
    """FLOPs of one product or convolution dispatched as ``packet``."""
    if packet in (_aten.mm, _aten.bmm, _aten.mv, _aten.dot):
        a = args[0]
    elif packet in (_aten.addmm, _aten.baddbmm):
        a = args[1]
    else:   # convolution(input, weight, bias, stride, padding, dilation,
        # transposed, output_padding, groups)
        weight, transposed = args[1], bool(args[6])
        taps = math.prod(weight.shape[2:])
        if transposed:   # each input element meets C_out/groups x taps
            return 2.0 * args[0].numel() * weight.shape[1] * taps
        return 2.0 * out.numel() * weight.shape[1] * taps
    # a product: 2 x outputs x the contraction length
    return 2.0 * out.numel() * a.shape[-1]


class _CostTap(TorchDispatchMode):
    """Counts a fake-tensor forward's :class:`TraceCosts` at the aten ops
    it dispatches (after the composite ops decompose: a ``linear``
    arrives as ``addmm``, an ``einsum`` as ``bmm``)."""

    def __init__(self, listing: bool = False):
        super().__init__()
        self.costs = TraceCosts()
        self.lines = [] if listing else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.lines is not None and func.namespace == "aten":
            self.lines.append("%s(%s) -> %s" % (
                func, ", ".join(_describe(a) for a in args),
                ", ".join(_describe(o) for o in pytree.tree_leaves(out))))
        packet = func.overloadpacket
        if packet in _PRODUCTS:
            self.costs.flops += _product_flops(packet, args, out)
        elif packet in _ATTENTION:   # q [B, H, Sq, D], k [B, H, Sk, D]
            q, k = args[0], args[1]
            self.costs.flops += 4.0 * q.numel() * k.shape[-2]
        if func.is_view or packet in _SHAPE_ONLY:
            return out
        nbytes = sum(leaf.numel() * leaf.element_size()
                     for leaf in pytree.tree_leaves(out)
                     if isinstance(leaf, torch.Tensor))
        self.costs.act_bytes += nbytes
        if packet in _PRODUCTS or packet in _ATTENTION:
            self.costs.dot_bytes += nbytes
        return out


def _describe(value) -> str:
    """One argument or output of an op in the snapshot listing: a tensor
    as its dtype and shape, anything else as its repr."""
    if isinstance(value, torch.Tensor):
        return "%s%s" % (dtype_name(value.dtype), list(value.shape))
    if isinstance(value, (list, tuple)):
        return "[%s]" % ", ".join(_describe(v) for v in value)
    return repr(value)


def _fake_inputs(params, example_batch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake_leaf(leaf):
        if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
            return torch.empty(tuple(leaf.shape),
                               dtype=_torch_dtype(leaf.dtype))
        return leaf
    mode = FakeTensorMode()
    with mode:
        fake = {n: fake_leaf(t) for n, t in params.items()}
        batch = pytree.tree_map(fake_leaf, example_batch)
    return mode, fake, batch


def trace_lookups(loss_fn: Callable, params, example_batch
                  ) -> Tuple[Dict[str, List[int]], set]:
    """Trace ``loss_fn(params, example_batch)`` once on fake tensors (no
    data, no device work, no kernel launch: every tensor reports the CPU,
    so the ops' plain versions run as shape functions) and return
    ``(lookups, dense_uses)``: for each variable that is the table of a
    lookup, the ids count of each lookup; and the variables with any
    other tensor-producing use. The counterpart of the JAX package's
    ``detect_sparse_vars`` jaxpr walk and its sparse-wire tap shapes."""
    mode, fake, batch = _fake_inputs(params, example_batch)
    tap = _LookupTap({id(t): n for n, t in fake.items()})
    with mode, tap, torch.no_grad():
        loss_fn(fake, batch)
    return tap.lookups, tap.dense_uses


def trace_forward(loss_fn: Callable, params, example_batch,
                  listing: bool = False
                  ) -> Tuple[Dict[str, List[int]], set, TraceCosts]:
    """:func:`trace_lookups`'s run, costed: ``(lookups, dense_uses,
    costs)``. The model-parallel axes are bound at size 1 for it
    (``parallel/mesh.py::recording``, as the JAX package traces its loss
    under ``bound_axes``), so the collectives of the bound code paths
    are recorded in ``costs.collectives``; the same run counts the
    FLOPs and the activation bytes (:class:`_CostTap`) and, with
    ``listing``, lists the ops it dispatched (``costs.listing``). The one
    trace ``ModelItem.prepare`` runs."""
    from autodist_tpu_torch.parallel import mesh
    mode, fake, batch = _fake_inputs(params, example_batch)
    tap = _LookupTap({id(t): n for n, t in fake.items()})
    with mode, tap, _CostTap(listing) as cost, \
            mesh.recording() as record, torch.no_grad():
        loss_fn(fake, batch)
    costs = cost.costs
    if cost.lines is not None:
        costs.listing = "\n".join(cost.lines) + "\n"
    costs.collectives = record.profile
    costs.batch_bytes = float(sum(
        leaf.numel() * leaf.element_size()
        if isinstance(leaf, torch.Tensor) else np.asarray(leaf).nbytes
        for leaf in pytree.tree_leaves(example_batch)))
    return tap.lookups, tap.dense_uses, costs


def trace_step_fn(step_fn: Callable, state, example_batch):
    """``step_fn(state, example_batch)`` run once on fake tensors (no data,
    no device work: every tensor reports the CPU), for the structure of
    what it returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake_leaf(leaf):
        if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
            return torch.empty(tuple(leaf.shape),
                               dtype=_torch_dtype(leaf.dtype))
        return leaf
    mode = FakeTensorMode()
    with mode:
        fake_state = unflatten_state(state, {
            n: fake_leaf(v) for n, v in flatten_state(state)})
        batch = pytree.tree_map(fake_leaf, example_batch)
        return step_fn(fake_state, batch)


def _leaf_dtype(leaf):
    if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
        return leaf.dtype
    return np.asarray(leaf).dtype


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(np.dtype(dtype)))


def detect_sparse_vars(loss_fn: Callable, params, example_batch) -> set:
    """Names of params that are the table of a lookup in the forward pass.
    Best-effort, as in the JAX package: a loss that cannot be traced on
    fake tensors leaves every variable dense, with a warning."""
    return _sparse_and_costs(loss_fn, params, example_batch)[0]


def _sparse_and_costs(loss_fn: Callable, params, example_batch
                      ) -> Tuple[set, Optional[TraceCosts]]:
    """:func:`trace_forward`'s tables and costs; a loss that cannot be
    traced on fake tensors gives no tables and no costs (the cost model
    then falls back to its params-based bounds, as JAX's does when its
    trace fails), with a warning."""
    from autodist_tpu_torch.utils import visualization_util
    try:
        lookups, _, costs = trace_forward(
            loss_fn, params, example_batch,
            listing=visualization_util.enabled())
    except Exception as e:  # noqa: BLE001 — detection is best-effort
        logging.warning(
            "sparse-var detection failed (%s: %s); treating ALL vars dense "
            "— embedding tables then take the int8 wire when it is asked "
            "for; fix the trace failure or mark them via VarInfo.sparse",
            type(e).__name__, e)
        return set(), None
    return set(lookups), costs


def _jax_order_key(info: "VarInfo"):
    """Sorted-pytree order of the JAX item: by the path of the JAX name."""
    return tuple(info.collective_name.split("/"))


class ModelItem:
    """The captured program + metadata handed to strategy builders.

    Two capture modes, as in the JAX package:

    * ``loss_fn`` mode: ``loss_fn(params, batch) -> scalar`` (or
      ``(scalar, aux)`` with ``has_aux``) over a flat ``{name: tensor}``
      params mapping. ``optimizer`` is a ``torch.optim`` factory or an
      ``optim.chain``; its ``(name, kwargs)`` are recorded
      (``optimizer_name``/``optimizer_args``, as ``patch.py`` records
      optax constructors, and nothing for a chain, which ``patch.py``
      does not capture) in ``optimizer_spec``, which the step applies.
    * ``step_fn`` mode: an opaque ``step_fn(state, batch) -> (new_state,
      metrics)`` over the user's whole training state (``params``: a tree
      of dicts, lists and tuples of tensors, params and optimizer state
      bundled however the user likes). Its variables are the state's
      leaves, named by their paths as the JAX item names them
      (:func:`flatten_state`), so a builder emits the JAX plan for the
      same tree. Lowered by ``GraphTransformer`` (entry:
      ``AutoDist.build_step``)."""

    def __init__(self,
                 loss_fn: Optional[Callable] = None,
                 optimizer=None,
                 params=None,
                 example_batch=None,
                 has_aux: bool = False,
                 apply_fn: Optional[Callable] = None,
                 trainable_filter: Optional[Callable[[str], bool]] = None,
                 step_fn: Optional[Callable] = None,
                 mp_rules=None, mp_meta=None):
        if loss_fn is None and step_fn is None:
            raise ValueError("ModelItem needs loss_fn or step_fn")
        self.loss_fn = loss_fn
        self.step_fn = step_fn
        self.apply_fn = apply_fn
        self.optimizer = optimizer
        self.optimizer_spec = optim.capture(optimizer)
        self.params = params
        self.example_batch = example_batch
        self.has_aux = has_aux
        # the model family's model-parallel sharding rules
        # (``models.tp_lm.tp_rules()``), recorded for the strategy search
        # (AutoStrategy, ROADMAP A item 11), and the knobs the loss was
        # built with (``pp_schedule``, ``pp_microbatches``,
        # ``pp_virtual``, ``pp_shards``), which ``AutoDist.build`` holds
        # the plan to
        self.mp_rules = list(mp_rules) if mp_rules else None
        self.mp_meta = dict(mp_meta) if mp_meta else None
        self.trainable_filter = trainable_filter or (
            default_trainable if step_fn is None else step_fn_trainable)
        # flax's shapes of the leaves the port flattens (DenseGeneral),
        # from a ``convert.FlaxParams``: checkpoints and exports write them
        self.flax_shapes = dict(getattr(params, "flax_shapes", None) or {})
        # and the JAX names of a model written over a plain JAX pytree
        # (``convert.jax_named``)
        self.jax_names = dict(getattr(params, "jax_names", None) or {})
        self._var_infos: Optional[Dict[str, VarInfo]] = None
        # the costs of the forward's one fake-tensor run at prepare (None
        # when nothing was traced): the cost model's trace inputs
        self.trace_costs: Optional[TraceCosts] = None

    def prepare(self) -> "ModelItem":
        """Collect variable metadata from the params mapping, in the JAX
        item's order, with the sparse flags of a traced forward (when
        there is an example batch to trace with)."""
        from autodist_tpu_torch.convert import flax_shape, jax_name
        if self.params is None:
            raise ValueError("ModelItem.prepare() requires params")
        if self.step_fn is not None:
            infos = [VarInfo(name=name, shape=tuple(np.shape(leaf)),
                             dtype=dtype_name(_leaf_dtype(leaf)),
                             trainable=bool(self.trainable_filter(name)))
                     for name, leaf in flatten_state(self.params)]
            self._var_infos = {i.name: i for i in infos}
            return self
        if not isinstance(self.params, dict):
            raise TypeError("params must be a flat {name: tensor} mapping "
                            "(a state_dict), got %s"
                            % type(self.params).__name__)
        sparse = set()
        if self.example_batch is not None:
            loss = self.loss_fn
            if self.has_aux:
                loss = lambda p, b: self.loss_fn(p, b)[0]  # noqa: E731
            sparse, self.trace_costs = _sparse_and_costs(
                loss, self.params, self.example_batch)
        infos = [VarInfo(name=name,
                         shape=tuple(leaf.shape),
                         dtype=dtype_name(leaf.dtype),
                         trainable=bool(self.trainable_filter(name)),
                         sparse=name in sparse,
                         collective_name=jax_name(name, tuple(leaf.shape),
                                                  self.jax_names),
                         flax_shape=flax_shape(name, tuple(leaf.shape),
                                               self.flax_shapes))
                 for name, leaf in self.params.items()]
        self._var_infos = {i.name: i for i in sorted(infos,
                                                     key=_jax_order_key)}
        logging.debug("ModelItem.prepare: %d vars (%d sparse)", len(infos),
                      len(sparse))
        return self

    @property
    def var_infos(self) -> Dict[str, VarInfo]:
        if self._var_infos is None:
            self.prepare()
        return self._var_infos

    @property
    def optimizer_name(self) -> Optional[str]:
        return self.optimizer_spec.name if self.optimizer_spec else None

    @property
    def optimizer_args(self) -> Dict:
        return self.optimizer_spec.args if self.optimizer_spec else {}

    @property
    def opt_state_spec(self) -> Optional[dict]:
        """Shapes of the optimizer state for these variables (None without
        an optimizer) — the JAX item's ``eval_shape(optimizer.init)``."""
        if self.optimizer_spec is None:
            return None
        return self.optimizer_spec.state_spec(
            {n: v.shape for n, v in self.var_infos.items()})

    @property
    def trainable_var_names(self) -> List[str]:
        return [n for n, v in self.var_infos.items() if v.trainable]

    @property
    def sparse_var_names(self) -> List[str]:
        return [n for n, v in self.var_infos.items() if v.sparse]

    def total_bytes(self) -> int:
        return sum(v.byte_size for v in self.var_infos.values())

    def to_spec_dict(self) -> dict:
        """The JAX item's spec-level serialization, spelled as the JAX
        package spells it: variables under their JAX names in flax's
        shapes, the optimizer under optax's name and argument names
        (``lr`` -> ``learning_rate``, ``betas`` -> ``b1``/``b2``). A
        step_fn item's variables are its state's leaves, named and shaped
        as they are."""
        from autodist_tpu_torch.convert import flax_shape

        def shape(v):
            if self.step_fn is not None:
                return list(v.shape)
            return list(flax_shape(v.name, v.shape, self.flax_shapes))
        args = {}
        for key, value in self.optimizer_args.items():
            if key == "betas":
                args.update(b1=repr(value[0]), b2=repr(value[1]))
            else:
                args["learning_rate" if key == "lr" else key] = repr(value)
        return {
            "vars": [{"name": v.collective_name,
                      "shape": shape(v),
                      "dtype": v.dtype, "trainable": v.trainable,
                      "sparse": v.sparse} for v in self.var_infos.values()],
            "optimizer_name": self.optimizer_name,
            "optimizer_args": args,
            "has_aux": self.has_aux,
            "mode": "loss_fn" if self.step_fn is None else "step_fn",
        }

