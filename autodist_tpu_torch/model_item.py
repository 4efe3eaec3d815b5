"""ModelItem — the captured program and its variable metadata.

PyTorch counterpart of ``autodist_tpu/model_item.py``. The JAX module
flattens a params pytree and mines a jaxpr for gather-indexed (sparse)
variables; here params arrive as a flat mapping of names to tensors (a
``state_dict``) and every variable is dense — the sparse (ids, values)
wire belongs to a later slice of the port.
"""
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

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
    sparse: bool = False

    @property
    def byte_size(self) -> int:
        itemsize = torch.empty((), dtype=getattr(torch, self.dtype)
                               ).element_size()
        return int(np.prod(self.shape or (1,))) * itemsize

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape or (1,)))


class ModelItem:
    """The captured program + metadata handed to strategy builders.

    ``loss_fn(params, batch) -> scalar`` (or ``(scalar, aux)`` with
    ``has_aux``) over a flat ``{name: tensor}`` params mapping.
    ``optimizer`` is a ``torch.optim`` factory; its ``(name, kwargs)`` are
    recorded (``optimizer_name``/``optimizer_args``, as ``patch.py``
    records optax constructors) in ``optimizer_spec``, which the step
    applies."""

    def __init__(self,
                 loss_fn: Optional[Callable] = None,
                 optimizer=None,
                 params=None,
                 example_batch=None,
                 has_aux: bool = False,
                 apply_fn: Optional[Callable] = None,
                 trainable_filter: Optional[Callable[[str], bool]] = None):
        if loss_fn is None:
            raise ValueError("ModelItem needs loss_fn")
        self.loss_fn = loss_fn
        self.apply_fn = apply_fn
        self.optimizer = optimizer
        self.optimizer_spec = optim.capture(optimizer)
        self.params = params
        self.example_batch = example_batch
        self.has_aux = has_aux
        self.trainable_filter = trainable_filter or default_trainable
        self._var_infos: Optional[Dict[str, VarInfo]] = None

    def prepare(self) -> "ModelItem":
        """Collect variable metadata from the params mapping."""
        if self.params is None:
            raise ValueError("ModelItem.prepare() requires params")
        if not isinstance(self.params, dict):
            raise TypeError("params must be a flat {name: tensor} mapping "
                            "(a state_dict), got %s"
                            % type(self.params).__name__)
        infos: Dict[str, VarInfo] = {}
        for name, leaf in self.params.items():
            infos[name] = VarInfo(
                name=name,
                shape=tuple(leaf.shape),
                dtype=dtype_name(leaf.dtype),
                trainable=bool(self.trainable_filter(name)),
            )
        self._var_infos = infos
        logging.debug("ModelItem.prepare: %d vars", len(infos))
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
        return dict(self.optimizer_spec.kwargs) if self.optimizer_spec else {}

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

    def total_bytes(self) -> int:
        return sum(v.byte_size for v in self.var_infos.values())

