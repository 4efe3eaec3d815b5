"""Convert the JAX package's parameters into the port's.

``params_from_jax(np_tree)`` takes a flax variables tree as numpy arrays
(``{"params": {...}}``, ``{"params": {...}, "batch_stats": {...}}`` or
the ``params`` subtree itself) and returns the port's ``{name: float32
tensor}`` mapping (a ``state_dict``), with names joined by ``.`` and
these layouts:

- flax ``Dense`` kernel ``[in, out]`` -> ``weight [out, in]``;
- ``DenseGeneral`` q/k/v kernels ``[d, H, D]`` -> ``weight [H*D, d]``,
  biases ``[H, D]`` -> ``[H*D]``; the ``out`` kernel ``[H, D, d]`` ->
  ``weight [d, H*D]``;
- ``Conv`` kernel HWIO ``[kh, kw, in, out]`` -> OIHW ``weight [out, in,
  kh, kw]``;
- LayerNorm and BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
- embedding tables as they are;
- the ``batch_stats`` collection (BatchNorm ``mean``/``var``) under the
  prefix ``batch_stats.`` (``model_item.BATCH_STATS_PREFIX``), which
  ``ModelItem``'s default filter keeps from training.

Any other leaf or collection raises.

``jax_name(name, shape)`` inverts the naming half of these rules: the
JAX item's name for a port variable (``ModelItem`` keys collectives and
the variable order on it).

The other direction writes checkpoints in the JAX package's layout
(``checkpoint/saver.py``): :func:`params_to_jax`,
:func:`opt_state_to_jax` and :func:`sync_state_to_jax` give flat
``{JAX name: numpy}`` mappings in flax's names, shapes and element order,
and the ``*_from_jax`` functions read them back. A flat port tensor does
not say how flax shaped it (``[H*D, d]`` is a ``[d, H, D]`` DenseGeneral
kernel only with the head count), so the params the port's models make
and :func:`params_from_jax` returns are a :class:`FlaxParams`, which
remembers those shapes (``flax_shapes``); ``ModelItem`` keeps them.

A model written over a plain JAX pytree rather than flax modules
(``models/tp_lm.py``) keeps the JAX item's names and shapes as they are:
its params are a :func:`jax_named` mapping, whose ``jax_names`` map each
name to itself, and every conversion here takes them as given
(:func:`tp_lm_params_from_jax` and :func:`pipe_lm_params_from_jax` read
the JAX models' trees so).
"""
from typing import Dict, Optional

import numpy as np
import torch

from autodist_tpu_torch.model_item import BATCH_STATS_PREFIX


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _param_leaf(path, arr):
    """(port leaf name, value) of one leaf of the ``params`` collection."""
    *mod, leaf = path
    parent = mod[-1] if mod else ""
    if leaf == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3 and parent == "out":
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        if arr.ndim == 3:
            return "weight", arr.reshape(arr.shape[0], -1).T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError("unexpected kernel rank %d at %s"
                         % (arr.ndim, "/".join(path)))
    if leaf == "bias":
        return "bias", arr.reshape(-1)
    if leaf == "scale":
        return "weight", arr
    if leaf == "embedding":
        return "embedding", arr
    raise ValueError("no conversion rule for %s" % "/".join(path))


def _stats_leaf(path, arr):
    """(port leaf name, value) of one leaf of ``batch_stats``."""
    if path[-1] in ("mean", "var"):
        return path[-1], arr
    raise ValueError("no conversion rule for batch_stats/%s"
                     % "/".join(path))


class FlaxParams(dict):
    """A port params mapping (``{name: tensor}``) that remembers
    ``flax_shapes``: the flax shape of each leaf whose shape the generic
    rule of :func:`flax_shape` does not give back (DenseGeneral kernels
    and biases), and ``jax_names``: the JAX item's name of each leaf whose
    name the rule of :func:`jax_name` does not give. ``dict(params)``
    drops them."""

    def __init__(self, *args, flax_shapes: Optional[dict] = None,
                 jax_names: Optional[dict] = None, **kw):
        super().__init__(*args, **kw)
        self.flax_shapes = {n: tuple(s) for n, s in (flax_shapes or {}
                                                     ).items()}
        self.jax_names = dict(jax_names or {})


def jax_named(params: dict) -> FlaxParams:
    """``params`` already named and shaped as the JAX item names and
    shapes them (a plain pytree's ``/``-joined paths)."""
    return FlaxParams(params, jax_names={n: n for n in params})


def _pytree_params_from_jax(np_tree) -> FlaxParams:
    """A plain-pytree model's params from the JAX model's numpy tree: the
    JAX item's names, float32 tensors."""
    return jax_named({"/".join(path): torch.from_numpy(np.array(
        arr, np.float32)) for path, arr in _flatten(np_tree)})


def tp_lm_params_from_jax(np_tree) -> FlaxParams:
    """``models/tp_lm.py``'s params from the JAX ``tp_lm``'s numpy tree."""
    return _pytree_params_from_jax(np_tree)


def pipe_lm_params_from_jax(np_tree) -> FlaxParams:
    """``models/pipe_lm.py``'s params from the JAX ``pipe_lm``'s numpy
    tree (the blocks stacked ``[L, ...]`` under ``blocks/``)."""
    return _pytree_params_from_jax(np_tree)


def moe_lm_params_from_jax(np_tree) -> FlaxParams:
    """``models/moe_lm.py``'s params from the JAX ``moe_lm``'s numpy tree
    (the experts stacked ``[E, ...]`` under ``layer_<i>/moe/``)."""
    return _pytree_params_from_jax(np_tree)


def params_from_jax(np_tree) -> FlaxParams:
    if hasattr(np_tree, "get") and "params" in np_tree:
        collections = dict(np_tree)
    else:
        collections = {"params": np_tree}
    out = FlaxParams()
    for collection, tree in collections.items():
        if collection == "params":
            rule, prefix = _param_leaf, ""
        elif collection == "batch_stats":
            rule, prefix = _stats_leaf, BATCH_STATS_PREFIX
        else:
            raise ValueError("no conversion rule for the collection %r"
                             % (collection,))
        for path, arr in _flatten(tree):
            name, value = rule(path, arr)
            name = prefix + ".".join(path[:-1] + (name,))
            out[name] = torch.from_numpy(
                np.array(value, dtype=np.float32, order="C", copy=True))
            if flax_shape(name, value.shape) != arr.shape:
                out.flax_shapes[name] = arr.shape
    return out


def jax_name(name: str, shape, jax_names: Optional[dict] = None) -> str:
    """The JAX package's variable name for the port's ``name`` (of a
    variable of ``shape``): its entry in ``jax_names``, else as the JAX
    ``ModelItem`` spells it over a flax variables tree: ``.`` becomes
    ``/`` under the collection (``params/``, or ``batch_stats/`` for
    names under ``BATCH_STATS_PREFIX``), and a ``weight`` leaf becomes
    ``scale`` when it is 1-D (LayerNorm, BatchNorm) and ``kernel``
    otherwise (Dense, DenseGeneral, Conv) — the inverse of
    :func:`_param_leaf`'s names."""
    if jax_names and name in jax_names:
        return jax_names[name]
    collection = "params"
    if name.startswith(BATCH_STATS_PREFIX):
        collection, name = "batch_stats", name[len(BATCH_STATS_PREFIX):]
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "scale" if len(tuple(shape)) == 1 else "kernel"
    return "/".join([collection] + parts)


def to_jax_layout(t: torch.Tensor, name: str) -> torch.Tensor:
    """The port's tensor ``t`` of the variable the JAX package calls
    ``name`` (:func:`jax_name`), as a view in the flax leaf's element
    order: a kernel's ``weight [out, in]`` as ``[in, out]`` (which also
    flattens as the DenseGeneral ``[d, H, D]`` and ``[H, D, d]`` kernels
    do) and a conv's OIHW as HWIO; every other leaf as it is. Gradient
    buckets concatenate in this order, so the int8 wire's scale blocks
    hold the same elements in both packages."""
    if name.endswith("/kernel"):
        if t.dim() == 2:
            return t.t()
        if t.dim() == 4:
            return t.permute(2, 3, 1, 0)
    return t


def from_jax_layout(flat: torch.Tensor, shape, name: str) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout`: the flat vector in the flax
    leaf's element order, as the port's contiguous tensor of ``shape``."""
    shape = tuple(shape)
    if name.endswith("/kernel") and len(shape) == 2:
        return flat.reshape(shape[1], shape[0]).t().contiguous()
    if name.endswith("/kernel") and len(shape) == 4:
        o, i, h, w = shape
        return flat.reshape(h, w, i, o).permute(3, 2, 0, 1).contiguous()
    return flat.reshape(shape)


def to_flax(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    """The port's tensor ``t`` of the variable ``name`` as the flax leaf
    of ``shape`` (its flax shape), in flax's element order."""
    return to_jax_layout(t, name).reshape(tuple(shape))


def from_flax(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    """Inverse of :func:`to_flax`: the port's contiguous tensor of
    ``shape``."""
    return from_jax_layout(t.reshape(-1), shape, name)


def flax_shape(name: str, shape, flax_shapes: Optional[dict] = None):
    """The flax shape of the port's variable ``name`` of ``shape``: its
    entry in ``flax_shapes``, else a kernel's ``[out, in]`` as ``[in,
    out]`` and OIHW as HWIO, else ``shape``."""
    if flax_shapes and name in flax_shapes:
        return tuple(flax_shapes[name])
    shape = tuple(shape)
    if jax_name(name, shape).endswith("/kernel"):
        if len(shape) == 2:
            return shape[::-1]
        if len(shape) == 4:
            o, i, h, w = shape
            return (h, w, i, o)
    return shape


def leaf_to_jax(t: torch.Tensor, name: str,
                flax_shapes: Optional[dict] = None) -> np.ndarray:
    """A host copy of the port's variable ``name`` (or a state leaf of its
    shape) in flax's shape and element order. The layout is changed where
    ``t`` lives, then copied to the host, so the copy owns its memory."""
    t = t.detach()
    host = to_jax_layout(t, jax_name(name, t.shape)).contiguous().to(
        "cpu", copy=True)
    return host.numpy().reshape(flax_shape(name, t.shape, flax_shapes))


def leaf_from_jax(arr: np.ndarray, name: str, shape,
                  device=None) -> torch.Tensor:
    """Inverse of :func:`leaf_to_jax`: the flax-laid-out ``arr`` as the
    port's float32 tensor of ``shape`` on ``device`` (default: the CPU,
    sharing ``arr``'s memory where no layout change is needed). The
    layout is changed on ``device``, after the copy there."""
    shape = tuple(shape)
    if arr.size != int(np.prod(shape)):
        raise ValueError("%s: %s elements in the checkpoint, the model's %s "
                         "has %d" % (name, arr.shape, shape,
                                     int(np.prod(shape))))
    flat = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).reshape(-1)
    if device is not None:
        flat = flat.to(device)
    return from_jax_layout(flat, shape, jax_name(name, shape))


def params_to_jax(params: dict, flax_shapes: Optional[dict] = None,
                  jax_names: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """The port's params as the flat ``{JAX name: numpy}`` mapping the JAX
    package's saver writes (``params/...``, ``batch_stats/...``), in
    flax's shapes: Dense kernels ``[in, out]``, DenseGeneral kernels 3-D,
    convs HWIO, LayerNorm/BatchNorm ``scale``. ``flax_shapes`` and
    ``jax_names`` default to the mapping's own (:class:`FlaxParams`)."""
    if flax_shapes is None:
        flax_shapes = getattr(params, "flax_shapes", {})
    if jax_names is None:
        jax_names = getattr(params, "jax_names", {})
    return {jax_name(n, t.shape, jax_names): leaf_to_jax(t, n, flax_shapes)
            for n, t in params.items()}


def jax_shapes(shapes: Dict[str, tuple], flax_shapes: Optional[dict] = None,
               jax_names: Optional[dict] = None) -> Dict[str, tuple]:
    """``{JAX name: flax shape}`` of the port's ``{name: shape}``."""
    return {jax_name(n, s, jax_names): flax_shape(n, s, flax_shapes)
            for n, s in shapes.items()}


def _layout(optimizer):
    """The optimizer whose state a conversion reads or writes
    (``optim.OptimizerSpec``): optax.adam's when none is given."""
    if optimizer is None:
        from autodist_tpu_torch import optim
        optimizer = optim.capture(torch.optim.Adam)
    return optimizer


def opt_state_to_jax(opt_state: dict, flax_shapes: Optional[dict] = None,
                     optimizer=None, jax_names: Optional[dict] = None
                     ) -> Dict[str, np.ndarray]:
    """The port's optimizer state as the optax state the JAX saver
    flattens, for ``optimizer`` (an ``optim.OptimizerSpec``; Adam's by
    default): ``<prefix>count`` (int32) where the optimizer keeps one and
    ``<prefix><slot>/<JAX name>`` for each slot (Adam's ``mu`` and
    ``nu``, SGD momentum's ``trace``) in the params' flax shapes, where
    ``<prefix>`` is the optimizer's place in optax's chain (``0/``, or
    ``1/0/`` behind a clip)."""
    opt = _layout(optimizer)
    pre = opt.jax_prefix
    out = {}
    if opt.has_count:
        out[pre + "count"] = np.asarray(int(opt_state["count"]), np.int32)
    for slot in opt.slots:
        for n, t in opt_state[slot].items():
            key = jax_name(n, t.shape, jax_names)
            out["%s%s/%s" % (pre, slot, key)] = leaf_to_jax(t, n,
                                                            flax_shapes)
    return out


def opt_state_template(shapes: Dict[str, tuple],
                       flax_shapes: Optional[dict] = None,
                       optimizer=None, jax_names: Optional[dict] = None
                       ) -> Dict[str, tuple]:
    """``{name: shape}`` of :func:`opt_state_to_jax` for variables of
    ``shapes``."""
    opt = _layout(optimizer)
    pre = opt.jax_prefix
    out = {pre + "count": ()} if opt.has_count else {}
    for slot in opt.slots:
        out.update({"%s%s/%s" % (pre, slot, k): v
                    for k, v in jax_shapes(shapes, flax_shapes,
                                           jax_names).items()})
    return out


def opt_state_from_jax(flat: Dict[str, np.ndarray],
                       shapes: Dict[str, tuple], device=None,
                       optimizer=None, jax_names: Optional[dict] = None
                       ) -> dict:
    """Inverse of :func:`opt_state_to_jax`: the port's state (``count``,
    and each slot's ``{name: tensor}``) for variables of ``shapes``, its
    tensors on ``device`` (:func:`leaf_from_jax`; the count an int32 0-d
    tensor)."""
    opt = _layout(optimizer)
    pre = opt.jax_prefix
    out = {}
    if opt.has_count:
        count = torch.tensor(int(flat[pre + "count"]), dtype=torch.int32)
        out["count"] = count if device is None else count.to(device)
    for slot in opt.slots:
        out[slot] = {n: leaf_from_jax(
            flat["%s%s/%s" % (pre, slot, jax_name(n, s, jax_names))], n, s,
            device)
            for n, s in shapes.items()}
    return out


def sync_state_to_jax(sync_state: dict, var_infos: dict,
                      flax_shapes: Optional[dict] = None, optimizer=None
                      ) -> Dict[str, np.ndarray]:
    """The gathered compressor states (every leaf ``[N, ...]``, row r
    rank r's) as the JAX package's flattened sync state: ``bucket/<key>``
    (buckets are already in the flax element order), ``zero/...`` (the
    ZeRO shards), ``sentinel/lr_scale`` (the health sentinel's LR scale)
    and ``var/<JAX name>[/<field>]``, whose leaves of the variable's
    shape are laid out as flax lays the variable out."""
    out = {"bucket/" + k: t.detach().to("cpu", copy=True).numpy()
           for k, t in sync_state.get("bucket", {}).items()}
    # the ZeRO shards: the optimizer's state of each little {"v": shard}
    # tree (already in flax's element order, zero_synchronizer.py)
    opt = _layout(optimizer)
    for n, little in sync_state.get("zero", {}).items():
        base = "zero/%s/%s" % (var_infos[n].collective_name, opt.jax_prefix)
        if opt.has_count:
            out[base + "count"] = little["count"].detach().to(
                "cpu", copy=True).numpy()
        for slot in opt.slots:
            out["%s%s/v" % (base, slot)] = little[slot]["v"].detach().to(
                "cpu", copy=True).numpy()
    for k, t in sync_state.get("sentinel", {}).items():
        # the health sentinel's LR scale, one a rank
        out["sentinel/" + k] = t.detach().to("cpu", copy=True).numpy()
    for n, leaf in sync_state.get("var", {}).items():
        info = var_infos[n]
        fields = leaf.items() if isinstance(leaf, dict) else (("", leaf),)
        for field, t in fields:
            if tuple(t.shape[1:]) == tuple(info.shape):
                rows = [leaf_to_jax(row, n, flax_shapes) for row in t]
            else:
                rows = [row.detach().to("cpu", copy=True).numpy()
                        for row in t]
            key = "var/" + info.collective_name + ("/" + field if field
                                                   else "")
            out[key] = np.stack(rows)
    return out


def sync_state_from_jax(flat: Dict[str, np.ndarray], var_infos: dict,
                        flax_shapes: Optional[dict] = None,
                        optimizer=None) -> dict:
    """Inverse of :func:`sync_state_to_jax`: the port's tree of ``[N,
    ...]`` CPU tensors. Raises ``KeyError`` on a name that is neither a
    bucket nor a variable of ``var_infos``."""
    by_jax = {i.collective_name: n for n, i in var_infos.items()}
    opt = _layout(optimizer)
    fields = (("count",) if opt.has_count else ()) + tuple(
        "%s/v" % slot for slot in opt.slots)
    out: dict = {}
    for key, arr in sorted(flat.items()):
        top, _, rest = key.partition("/")
        if top in ("bucket", "sentinel") and rest:
            out.setdefault(top, {})[rest] = torch.from_numpy(
                np.array(arr, copy=True))
            continue
        if top == "zero":
            jname, _, field = rest.rpartition("/" + opt.jax_prefix)
            if jname not in by_jax or field not in fields:
                raise KeyError("sync state entry %r names no ZeRO shard of "
                               "this model" % key)
            little = out.setdefault("zero", {}).setdefault(by_jax[jname], {})
            t = torch.from_numpy(np.array(arr, copy=True))
            if field == "count":
                little["count"] = t
            else:
                little[field[:-2]] = {"v": t}
            continue
        jname = max((j for j in by_jax if rest == j
                     or rest.startswith(j + "/")), key=len, default=None)
        if top != "var" or jname is None:
            raise KeyError("sync state entry %r names no bucket or variable "
                           "of this model" % key)
        name, field = by_jax[jname], rest[len(jname) + 1:]
        shape = tuple(var_infos[name].shape)
        if tuple(arr.shape[1:]) == flax_shape(name, shape, flax_shapes):
            t = torch.stack([leaf_from_jax(row, name, shape) for row in arr])
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        var = out.setdefault("var", {})
        if field:
            var.setdefault(name, {})[field] = t
        else:
            var[name] = t
    return out
