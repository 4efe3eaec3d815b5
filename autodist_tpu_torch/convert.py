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
