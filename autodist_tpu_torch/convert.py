"""Convert the JAX package's parameters into the port's.

``params_from_jax(np_tree)`` takes a flax variables tree as numpy arrays
(``{"params": {...}}`` or the ``params`` subtree itself) and returns the
port's ``{name: float32 tensor}`` mapping (a ``state_dict``), with names
joined by ``.`` and these layouts:

- flax ``Dense`` kernel ``[in, out]`` -> ``weight [out, in]``;
- ``DenseGeneral`` q/k/v kernels ``[d, H, D]`` -> ``weight [H*D, d]``,
  biases ``[H, D]`` -> ``[H*D]``; the ``out`` kernel ``[H, D, d]`` ->
  ``weight [d, H*D]``;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
- embedding tables as they are.
"""
import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def params_from_jax(np_tree) -> dict:
    tree = np_tree.get("params", np_tree) if hasattr(np_tree, "get") \
        else np_tree
    out = {}
    for path, arr in _flatten(tree):
        *mod, leaf = path
        parent = mod[-1] if mod else ""
        if leaf == "kernel":
            if arr.ndim == 2:
                w = arr.T
            elif arr.ndim == 3 and parent == "out":
                w = arr.reshape(-1, arr.shape[-1]).T
            elif arr.ndim == 3:
                w = arr.reshape(arr.shape[0], -1).T
            else:
                raise ValueError("unexpected kernel rank %d at %s"
                                 % (arr.ndim, "/".join(path)))
            name, value = "weight", w
        elif leaf == "bias":
            name, value = "bias", arr.reshape(-1)
        elif leaf == "scale":
            name, value = "weight", arr
        elif leaf == "embedding":
            name, value = "embedding", arr
        else:
            raise ValueError("no conversion rule for %s" % "/".join(path))
        out[".".join(tuple(mod) + (name,))] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C", copy=True))
    return out
