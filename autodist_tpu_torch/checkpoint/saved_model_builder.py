"""Serving export (PyTorch counterpart of
``autodist_tpu/checkpoint/saved_model_builder.py``).

Writes the params in the JAX package's original layout (``params.npz``,
keyed by the JAX names in flax's shapes, as ``Saver`` writes them) and a
JSON model spec (``model_spec.json``: ``ModelItem.to_spec_dict()``, the
JAX item's spelling) — a consumer reloads with ``numpy.load`` and its own
apply function, in either package, with no framework import.
"""
import json
import os
from typing import Callable, Optional

import numpy as np

from autodist_tpu_torch import convert
from autodist_tpu_torch.utils import logging


class SavedModelBuilder:
    def __init__(self, export_dir: str):
        self.export_dir = export_dir
        os.makedirs(export_dir, exist_ok=True)

    def save(self, runner, signature: Optional[dict] = None,
             apply_fn: Optional[Callable] = None) -> str:
        dstep = runner.distributed_step
        item = dstep.model_item
        np.savez(os.path.join(self.export_dir, "params.npz"),
                 **convert.params_to_jax(dstep.gather_params(runner.state),
                                         item.flax_shapes, item.jax_names))
        spec = item.to_spec_dict()
        spec["signature"] = signature or {}
        fn = apply_fn or item.apply_fn
        if fn is not None:
            spec["apply_fn"] = "%s.%s" % (getattr(fn, "__module__", "?"),
                                          getattr(fn, "__qualname__",
                                                  repr(fn)))
        with open(os.path.join(self.export_dir, "model_spec.json"), "w") as f:
            json.dump(spec, f, indent=1, sort_keys=True)
        logging.info("exported model to %s", self.export_dir)
        return self.export_dir


def export_for_serving(runner, export_dir: str,
                       apply_fn: Optional[Callable] = None) -> str:
    """Convenience wrapper mirroring the JAX package's usage pattern."""
    return SavedModelBuilder(export_dir).save(runner, apply_fn=apply_fn)
