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
"""
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


def params_from_jax(np_tree) -> dict:
    if hasattr(np_tree, "get") and "params" in np_tree:
        collections = dict(np_tree)
    else:
        collections = {"params": np_tree}
    out = {}
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
            out[prefix + ".".join(path[:-1] + (name,))] = torch.from_numpy(
                np.array(value, dtype=np.float32, order="C", copy=True))
    return out


def jax_name(name: str, shape) -> str:
    """The JAX package's variable name for the port's ``name`` (of a
    variable of ``shape``), as its ``ModelItem`` spells it over a flax
    variables tree: ``.`` becomes ``/`` under the collection
    (``params/``, or ``batch_stats/`` for names under
    ``BATCH_STATS_PREFIX``), and a ``weight`` leaf becomes ``scale`` when
    it is 1-D (LayerNorm, BatchNorm) and ``kernel`` otherwise (Dense,
    DenseGeneral, Conv) — the inverse of :func:`_param_leaf`'s names."""
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
